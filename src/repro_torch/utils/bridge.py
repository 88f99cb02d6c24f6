"""Weights carried across: the reference's param pytrees <-> the port's flat
parameter buffers (the CNN) or tensor trees (the language models).

The port holds a client's parameters as ONE flat buffer, ``(P,)`` for one
client or ``(N, P)`` for a client stack, with a view for each leaf
(:meth:`ParamLayout.views`). One buffer per client stack makes the Eq-1 mix
a single kernel launch over ``P`` and lets SGD update every leaf at once.

**Leaf order** is the reference's ``jax.tree.leaves`` order: dict keys
sorted, list entries in index order. For the CNN that is::

    blocks[0].bias, blocks[0].conv, ..., blocks[L-1].bias, blocks[L-1].conv,
    fc1.b, fc1.w, fc2.b, fc2.w

Leaves keep the reference shapes and memory layouts, with no transposes:
HWIO convs ``(k, k, C_in, C_out)`` and ``(in, out)`` fc weights, each
flattened row-major. So a reference tree flattened with
``concatenate([leaf.reshape(-1) for leaf in jax.tree.leaves(tree)])`` is
exactly the port's buffer.

The language models keep the reference's tree itself, leaf for leaf, as
tensors: ``(in, out)`` dense weights, ``(V, D)`` embedding, ``(D, V)``
lm_head, every ``layers`` leaf stacked over L, again with no transposes
(:func:`from_jax_lm_params`, :func:`lm_params_to_numpy`). A bf16 leaf
(the reference's default dtype; numpy holds it as ``ml_dtypes.bfloat16``)
crosses bit for bit through its 16-bit integer view, in both directions,
as ``checkpoint/ckpt.py`` stores it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree) -> Tuple[List[Any], Tree]:
    """(leaves in the reference's order, template with leaf indices)."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        leaves.append(t)
        return len(leaves) - 1

    template = walk(tree)
    return leaves, template


def _fill(template: Tree, leaves: List[Any]) -> Tree:
    if isinstance(template, dict):
        return {k: _fill(v, leaves) for k, v in template.items()}
    if isinstance(template, list):
        return [_fill(v, leaves) for v in template]
    return leaves[template]


@dataclass(frozen=True)
class ParamLayout:
    """Where each leaf of a param tree lives in the flat buffer."""
    template: Tree                       # tree structure, leaves = indices
    shapes: Tuple[Tuple[int, ...], ...]  # per-leaf shape, reference order

    @classmethod
    def from_shapes(cls, spec: Tree) -> "ParamLayout":
        """Layout of a tree whose leaves are shape tuples."""
        leaves, template = _flatten(spec)
        return cls(template, tuple(tuple(int(d) for d in s) for s in leaves))

    @classmethod
    def of(cls, tree: Tree) -> "ParamLayout":
        """Layout of a tree of tensors or arrays, from their shapes."""
        leaves, template = _flatten(tree)
        return cls(template, tuple(tuple(int(d) for d in x.shape)
                                   for x in leaves))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def size(self) -> int:
        """P, the length of one client's flat buffer."""
        return sum(self.sizes)

    def views(self, flat: torch.Tensor) -> Tree:
        """The param tree as views into ``flat`` (``(..., P)``): writes
        through a view write the buffer, and autograd through the views
        accumulates into one gradient of the buffer's shape."""
        if flat.shape[-1] != self.size:
            raise ValueError(f"flat buffer has {flat.shape[-1]} params, "
                             f"layout needs {self.size}")
        lead = tuple(flat.shape[:-1])
        leaves, off = [], 0
        for shape, n in zip(self.shapes, self.sizes):
            leaves.append(flat[..., off:off + n].view(lead + shape))
            off += n
        return _fill(self.template, leaves)


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of a tree of dicts and lists in the reference's order
    (``jax.tree.leaves``: dict keys sorted), the flat buffer's order."""
    return _flatten(tree)[0]


def _is_stacked(tree: Tree) -> bool:
    # the CNN's fc2 bias is (n_classes,), or (N, n_classes) with a client axis
    return np.ndim(tree["fc2"]["b"]) == 2


def from_jax_params(tree: Tree, device: str | torch.device) -> torch.Tensor:
    """The reference's CNN param tree (numpy leaves, ``{"blocks": [{conv,
    bias}], "fc1": {w, b}, "fc2": {w, b}}``, optionally with a leading N
    axis) as the port's flat buffer: ``(P,)``, or ``(N, P)`` when stacked."""
    leaves, _ = _flatten(tree)
    lead = (np.shape(leaves[0])[0],) if _is_stacked(tree) else ()
    flat = np.concatenate([np.asarray(x).reshape(lead + (-1,))
                           for x in leaves], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(flat)).to(device)


def to_numpy(flat: torch.Tensor, layout: ParamLayout) -> Tree:
    """The flat buffer as the reference's param tree of numpy arrays."""
    host = flat.detach().cpu()
    return _fill(layout.template,
                 [np.array(v) for v in _flatten(layout.views(host))[0]])


def from_jax_lm_params(tree: Tree, cfg, device: str | torch.device) -> Tree:
    """The reference's ``init_params`` tree for a dense, vlm, audio, MoE,
    ssm or hybrid LM config (numpy leaves; ``layers`` and an MoE config's
    ``dense_layers`` stacked ``(L, ...)``; ``mtp`` and ``mtp_ln`` when the
    config has an MTP head; a hybrid config's one unstacked
    ``shared_attn`` block) as the port's params."""
    if (cfg.family not in ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
            or "layers" not in tree
            or ("shared_attn" in tree) != (cfg.family == "hybrid")):
        raise ValueError(f"{cfg.name}: not a {cfg.family} LM tree")
    n = sum(np.shape(_flatten(tree[g])[0][0])[0]
            for g in ("dense_layers", "layers") if g in tree)
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, {cfg.name} {cfg.n_layers}")
    leaves, template = _flatten(tree)
    return _fill(template, [_leaf_to_torch(x).to(device) for x in leaves])


def lm_params_to_numpy(params: Tree) -> Tree:
    """The port's LM params as the reference's tree of numpy arrays (bf16
    leaves as ``ml_dtypes.bfloat16``)."""
    leaves, template = _flatten(params)
    return _fill(template, [_leaf_to_numpy(x) for x in leaves])


def _leaf_to_torch(x) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor of its dtype; a bf16
    leaf, which torch cannot take from numpy, through its int16 view
    (told by the dtype's name, so no dtype package is imported)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor leaf as a numpy array of its dtype; bf16, which torch
    cannot hand numpy, through its int16 view as ``ml_dtypes.bfloat16``
    (imported here only: the reference's numpy dtype for bf16)."""
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()
