"""Param-tree checkpointing on npz, in the reference's format
(``repro.checkpoint``), so each package reads the other's files.

A tree is nested dicts, lists and tuples whose leaves are torch tensors or
numpy arrays (``None`` is an empty subtree, as in ``jax.tree_util``). Keys
are the '/'-joined paths: a dict key, or a list index as a string, dicts
walked in sorted key order. ``__step__`` holds the step. npz cannot hold
bfloat16 or float8, so such a leaf is stored as its uint16 / uint8 bit view
beside a ``__dtype__/<key>`` tag naming the dtype; the views are made and
read through torch, so no extra dtype package is needed.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Any

# dtype tag -> (its torch dtype, the stored numpy dtype, and the
# same-width integer dtype the bits cross between torch and numpy as)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, (torch.int16, np.int16)),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8,
                             (torch.uint8, np.uint8)),
           "float8_e5m2": (torch.float8_e5m2, np.uint8,
                           (torch.uint8, np.uint8))}
_TORCH_NAME = {v[0]: k for k, v in _EXOTIC.items()}


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and naming."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(like: Tree, values: Dict[str, Any],
             prefix: Tuple[str, ...] = ()) -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, values, prefix + (str(i),))
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return values["/".join(prefix)]


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str | None]:
    """A leaf as the array npz stores, and its dtype tag (None for dtypes
    numpy holds itself)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_NAME.get(t.dtype)
        if name is not None:
            _, store, bits = _EXOTIC[name]
            return t.contiguous().view(bits[0]).numpy().view(store), name
        return t.numpy(), None
    return np.asarray(leaf), None


def save_checkpoint(path: str, tree: Tree, step: int = 0) -> None:
    arrays: Dict[str, Any] = {}
    for key, leaf in _leaves(tree):
        arr, tag = _to_numpy(leaf)
        if tag is not None:
            arrays["__dtype__/" + key] = np.str_(tag)
        arrays[key] = arr
    arrays["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)          # atomic
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _restore(arr: np.ndarray, tag: str | None, like: Any) -> Any:
    """The stored array as ``like``'s kind of leaf: a tensor of its dtype
    on its device, or a numpy array of its dtype."""
    src = None
    if tag is not None:
        dtype, _, bits = _EXOTIC[tag]
        raw = np.ascontiguousarray(arr).view(bits[1])
        src = torch.from_numpy(raw).view(dtype)
    if isinstance(like, torch.Tensor):
        if src is None:
            src = torch.from_numpy(np.ascontiguousarray(arr))
        return src.to(device=like.device, dtype=like.dtype)
    want = np.asarray(like).dtype
    if src is not None:
        return src.float().numpy().astype(want)
    return np.asarray(arr).astype(want)


def load_checkpoint(path: str, like: Tree):
    """Restore into the structure of ``like``, each leaf cast to the dtype
    of (and, for tensors, placed on the device of) ``like``'s leaf. Returns
    (tree, step)."""
    with np.load(path) as data:
        step = int(data["__step__"])
        values = {}
        for key, leaf in _leaves(like):
            arr = data[key]
            tag_key = "__dtype__/" + key
            tag = str(data[tag_key]) if tag_key in data else None
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            values[key] = _restore(arr, tag, leaf)
    return _rebuild(like, values), step
