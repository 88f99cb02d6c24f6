"""Where each rank's clients live: the client half of the reference's
``sharding/rules.py`` (``client_axis_spec``, ``client_stack_shardings``,
``client_tap_spec``) as plain functions.

The reference partitions the leading client axis of every stacked tensor
over a ``("clients",)`` mesh axis. Here each of the D ranks of a
``torch.distributed`` group holds the contiguous slab of S = N / D clients
that starts at ``rank · S``: of the (N, ...) client stacks (params, the
padded train and test stacks) along axis 0, and of a (rounds, N, ...) tap
buffer along axis 1.

The language-model half (``spec_for_param``, ``param_shardings``,
``batch_spec``, ``cache_shardings``) gives each leaf the layout the
reference's rules give it on a mesh (``launch/mesh.py::MeshSpec``). A
spec is a tuple with one entry a dim, an axis name or None (an entry of
the reference's ``PartitionSpec``; ``("pod", "data")`` nests), and a leaf
is named by its tree keys, stringified as the reference's
``_path_names`` does. Within a pod, ``sharding/place.py`` gives each
rank of a ``("data", "model")`` mesh its block of every leaf by these
specs (the params, the batch, the cache), and ``sharding/
tensor_parallel.py`` runs the dense and MoE families' steps on the
blocks; the
``"pod"`` entries are what ``launch/steps.py::make_pfedwn_round_step``
runs, one client a rank.

Strategy (single pod, mesh ("data", "model")):
  - 2-D weight matrices (D_in, D_out): FSDP over "data" on the input dim,
    tensor-parallel over "model" on the output dim, except down/out
    projections, which are ("model", "data") so the TP axis contracts;
  - expert tensors (E, D, F): E over "model", D over "data";
  - embeddings (V, D): vocab over "model", d_model over "data";
  - vectors (norm scales, biases): replicated;
  - scan-stacked params carry a leading layer axis: the rules apply to
    the suffix, and the L axis is never sharded.
Batch: tokens/labels (B, S) -> ("data", None). Multi-pod ("pod", "data",
"model"): in training "pod" is the FL-client axis (a leading client dim,
``param_shardings(..., client_axis=True)``); serving replicas shard the
batch over ("pod", "data") (``pod_batch=True``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def client_slab(n: int, d: int, rank: int) -> Tuple[int, int]:
    """(offset, S): the first client of ``rank``'s slab and the slab's
    size, for N = ``n`` clients over ``d`` ranks (``d`` must divide
    ``n``)."""
    if d < 1 or n % d:
        raise ValueError(f"client count N={n} must be divisible by the "
                         f"client-group size D={d}")
    if not 0 <= rank < d:
        raise ValueError(f"rank {rank} is outside a client group of {d}")
    s = n // d
    return rank * s, s


def take_slab(x, offset: int, size: int, client_axis: int = 0):
    """The slab ``[offset, offset + size)`` of ``x`` along its client axis:
    0 for an (N, ...) stack, 1 for a (rounds, N, ...) tap buffer. A view
    for tensors and numpy arrays alike."""
    index = (slice(None),) * client_axis + (slice(offset, offset + size),)
    return x[index]


def join_slabs(slabs: Sequence[torch.Tensor],
               client_axis: int = 0) -> torch.Tensor:
    """The full client stack from the ranks' slabs, given in rank order."""
    return torch.cat(list(slabs), dim=client_axis)


# ------------------------------------------------- language-model rules

Spec = Tuple[Any, ...]

_MATRIX_RULES: Dict[str, Spec] = {
    # attention
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "wo": ("model", "data"),
    "wq_a": ("data", "model"), "wq_b": ("data", "model"),
    "wkv_a": ("data", "model"), "wkv_b": ("data", "model"),
    # mlp
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # ssm
    "w_in": ("data", "model"), "w_out": ("model", "data"),
    "w_x": ("model", None), "w_dt": (None, "model"),
    "A_log": ("model", None), "conv": (None, "model"),
    # router
    "router": ("data", None),
    # embeddings / head
    "embed": ("model", "data"), "lm_head": ("data", "model"),
}

_EXPERT_RULES: Dict[str, Spec] = {
    # (E, D, F) / (E, F, D): expert parallel over model, fsdp over data
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", "data", None),
}

# tree keys whose leaves carry a leading stack axis in a cache
_CACHE_STACKS = ("layers", "dense_layers", "shared_attn", "ssm")


def spec_for_param(path: Tuple[str, ...], shape: Tuple[int, ...],
                   mesh_axis_sizes: Dict[str, int]) -> Spec:
    """The leaf's spec by its last key: an expert stack's rule under a
    ``moe`` key, else the matrix rule, else replicated (``()``). Leading
    dims past the rule (stacked layers) stay unsharded; a rule longer than
    the leaf keeps its first dims; an axis the mesh lacks, or whose size
    does not divide the dim, is dropped."""
    name = path[-1]
    base: Optional[Spec] = None
    if len(shape) >= 3 and name in _EXPERT_RULES and "moe" in path:
        base = _EXPERT_RULES[name]
    elif name in _MATRIX_RULES:
        base = _MATRIX_RULES[name]
    if base is None:
        return ()
    n_stack = len(shape) - len(base)
    if n_stack < 0:
        base, n_stack = base[:len(shape)], 0
    spec = [None] * n_stack + list(base)
    for i, ax in enumerate(spec):
        if ax is not None and (ax not in mesh_axis_sizes
                               or shape[i] % mesh_axis_sizes[ax] != 0):
            spec[i] = None
    return tuple(spec)


def _map_with_path(fn, tree, path=()):
    """``fn(names, leaf)`` over a tree of dicts and lists, each leaf named
    by its keys and list indices as strings (the reference's
    ``_path_names``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(mesh, params, *, client_axis: bool = False):
    """Each leaf's spec on ``mesh`` (a ``MeshSpec``) for a tree of tensors
    (meta or not). ``client_axis``: every leaf has a leading FL-client
    dim over ``"pod"``, the rules applying to the rest, and the
    embedding is replicated within the client (``("pod",)``), as the
    reference keeps it to avoid a sharded gather XLA cannot partition."""
    sizes = mesh.axis_sizes()

    def leaf(names, x):
        shape = tuple(x.shape)
        if not client_axis:
            return spec_for_param(names, shape, sizes)
        if names[-1] == "embed":
            return ("pod",)
        return ("pod",) + spec_for_param(names, shape[1:], sizes)

    return _map_with_path(leaf, params)


def batch_spec(name: str, ndim: int, *, client_axis: bool = False,
               pod_batch: bool = False) -> Spec:
    """A model input's spec: ``client_axis``, a leading FL-client dim over
    ``"pod"``; ``pod_batch``, the batch dim over ``("pod", "data")``
    (serving replicas), else over ``"data"``. ``positions`` and scalars
    stay replicated."""
    batch_axis = ("pod", "data") if pod_batch else "data"
    lead = ("pod",) if client_axis else ()
    rest = ndim - len(lead)
    if name == "positions" or rest < 1:
        return lead + (None,) * rest
    return lead + (batch_axis,) + (None,) * (rest - 1)


def cache_shardings(mesh, cache, *, pod_batch: bool = False):
    """Each cache leaf's spec on ``mesh``: the batch dim over ``"data"``
    (``("pod", "data")`` for serving replicas), the head or feature dim
    over ``"model"``; an axis whose size does not divide its dim is
    dropped. Layouts, after an optional leading stack axis:
      k/v:          (B, S, KH, Dh) -> (data, None, model, None), or Dh
                    over model when KH does not divide
      c_kv/k_rope:  (B, S, r)      -> (data, None, model)
      ssm h:        (B, ..., N)    -> (data, model, ...)
      conv:         (B, K-1, C)    -> (data, None, model)"""
    sizes = mesh.axis_sizes()
    batch_axis = ("pod", "data") if pod_batch else "data"

    def div_ok(ax, dim):
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes for a in axes):
            return False
        total = 1
        for a in axes:
            total *= sizes[a]
        return dim % total == 0

    def leaf(names, x):
        shape = tuple(x.shape)
        name = names[-1]
        stack = int(any(n in _CACHE_STACKS for n in names[:-1]))
        spec = [None] * len(shape)
        spec[stack] = batch_axis
        if name in ("k", "v") and len(shape) >= stack + 4:
            tp = sizes.get("model", 1)
            if tp > 1 and shape[stack + 2] % tp == 0:
                spec[stack + 2] = "model"       # KV heads
            else:
                spec[stack + 3] = "model"       # head_dim fallback
        elif name in ("c_kv", "k_rope"):
            spec[len(shape) - 1] = "model"      # latent feature dim
        elif name == "h":
            spec[stack + 1] = "model"
        elif name == "conv":
            spec[stack + 2] = "model"
        return tuple(None if ax is not None and not div_ok(ax, shape[i])
                     else ax for i, ax in enumerate(spec))

    return _map_with_path(leaf, cache)
