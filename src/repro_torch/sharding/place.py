"""Placement within a client: each rank of a ``("data", "model")`` mesh holds
its block of every leaf, the port's counterpart of applying a
``NamedSharding`` to a tree.

The reference jits its step builders with ``in_shardings`` from
``sharding/rules.py`` (``launch/dryrun.py``): one device holds, of every
leaf, the block ``NamedSharding(mesh, spec).shard_shape(global_shape)`` at
the offset its mesh position gives. Here the D·T ranks of a started
``torch.distributed`` group play the devices, rank ``r`` at the mesh
position of ``r`` in row-major order over the mesh's axes (the reference's
``mesh.devices`` reshape), and each holds the same block:
  - params by :func:`~repro_torch.sharding.rules.param_shardings`
    (:func:`param_blocks`);
  - the batch by :func:`~repro_torch.sharding.rules.batch_spec`, an entry
    dropped where its axis does not divide the dim, as the reference's
    dry run drops it (``_safe_spec``: a batch of 1 stays whole)
    (:func:`batch_blocks`);
  - the KV cache by :func:`~repro_torch.sharding.rules.cache_shardings`,
    its head-dim fallback included (:func:`cache_blocks`,
    :func:`cache_zeros`).
A spec entry names one axis, a tuple of axes (row-major over them, as a
``PartitionSpec``'s nested entry) or None. Entries the rules' divisibility
checks dropped to None leave the dim whole; a dim an entry does not
divide raises.

:func:`make_placement` binds a mesh to the started group: the ranks'
coordinates and the ``"data"`` and ``"model"`` subgroups, which every rank
makes with ``new_group`` in the same order (a group of one rank is
None: nothing to exchange). The group's backend is the caller's
(``sharding.spawn`` with ``sharding.group.default_backend``: gloo when
the ranks share one card, since NCCL refuses two ranks on one device).
:func:`gather_leaf` rebuilds a leaf, or its block along some axes, by one
all-gather an axis; :func:`unshard_tree` rebuilds a whole tree (the
tests' check). Every collective goes through
``core/aggregation.py``'s counted ``all_gather`` and ``all_reduce`` and
adds its host seconds to :data:`comm` (with a device sync around it while
:func:`timed` is on).

What the compute does with the blocks is
:mod:`repro_torch.sharding.tensor_parallel`'s; this module reads only the
rules, so it places the leaves of every registered architecture.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import aggregation
from repro_torch.sharding.rules import (Spec, _map_with_path, batch_spec,
                                        cache_shardings, param_shardings)

if TYPE_CHECKING:                 # launch/mesh.py imports this package
    from repro_torch.launch.mesh import MeshSpec

AXES = ("data", "model")

# host seconds and calls of the placement's collectives since the last
# reset_comm(); with timed() on, each is bracketed by device syncs, so the
# seconds are the collectives' own
comm: Dict[str, float] = {"seconds": 0.0, "calls": 0}
_TIMED = {"on": False}


def reset_comm() -> None:
    comm["seconds"], comm["calls"] = 0.0, 0


@contextlib.contextmanager
def timed():
    """Within it, each collective syncs the device before and after, so
    that :data:`comm` holds the collectives' own time, not the compute they
    wait for."""
    _TIMED["on"] = True
    try:
        yield
    finally:
        _TIMED["on"] = False


def _sync(x: torch.Tensor) -> None:
    if _TIMED["on"] and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks in place (timed, counted)."""
    _sync(x)
    t0 = time.perf_counter()
    aggregation.all_reduce(x, group)
    _sync(x)
    comm["seconds"] += time.perf_counter() - t0
    comm["calls"] += 1
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ranks' ``x`` concatenated along ``dim`` in group-rank
    order (timed, counted)."""
    _sync(x)
    t0 = time.perf_counter()
    out = aggregation.all_gather(x[None], group)
    out = torch.cat(out.unbind(0), dim=dim)
    _sync(out)
    comm["seconds"] += time.perf_counter() - t0
    comm["calls"] += 1
    return out


def rank_coords(mesh: MeshSpec, rank: int) -> Dict[str, int]:
    """{axis: index} of ``rank``'s mesh position, row-major over the mesh's
    axes (the last axis fastest), as the reference lays its devices."""
    n = math.prod(mesh.shape)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is outside a mesh of {n} devices")
    coords = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.shape))):
        coords[name] = rank % size
        rank //= size
    return {name: coords[name] for name in mesh.axis_names}


def _check_mesh(mesh: MeshSpec) -> None:
    names = set(mesh.axis_names)
    if "pod" in names:
        raise NotImplementedError(
            f"mesh {mesh.axis_names}: a client placed over data x model "
            "within each pod is the multi-pod round step's (ROADMAP D1d)")
    if names != set(AXES) or len(mesh.axis_names) != 2:
        raise ValueError(f"placement within a client takes a mesh of the "
                         f"axes {AXES}, not {mesh.axis_names}")


@dataclass(frozen=True)
class Placement:
    """One rank's place on a ``("data", "model")`` mesh: its coordinates and
    the process groups of its row along each axis (None where the axis has
    one rank, or for a layout-only placement, :func:`layout`)."""
    mesh: MeshSpec
    rank: int
    groups: Dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def sizes(self) -> Dict[str, int]:
        return self.mesh.axis_sizes()

    @property
    def coords(self) -> Dict[str, int]:
        return rank_coords(self.mesh, self.rank)

    def shards(self, entry) -> Tuple[int, int]:
        """(number of blocks, this rank's block) along a spec entry: an axis,
        a tuple of axes (row-major) or None (1, 0). An axis the mesh lacks
        counts as one block."""
        if entry is None:
            return 1, 0
        n, i = 1, 0
        coords = self.coords
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            size = self.sizes.get(ax, 1)
            n, i = n * size, i * size + coords.get(ax, 0)
        return n, i

    def group(self, axis: str):
        return self.groups.get(axis)


def layout(mesh: MeshSpec, rank: int) -> Placement:
    """A placement with no process groups: the blocks' shapes and offsets
    of ``rank`` (shape arithmetic and slicing only; no collective)."""
    _check_mesh(mesh)
    rank_coords(mesh, rank)
    return Placement(mesh, rank)


def make_placement(mesh: MeshSpec) -> Placement:
    """This rank's placement on ``mesh`` over the started default group,
    with its ``"data"`` and ``"model"`` subgroups. Every rank must call it
    (each group is made by ``new_group`` on every rank, in one order).
    Raises RuntimeError with no started group, ValueError when the world
    size is not D·T or the mesh lacks either axis."""
    _check_mesh(mesh)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("placement within a client needs a started "
                           "process group of D x T ranks (sharding.spawn "
                           "starts one)")
    world, n = dist.get_world_size(), math.prod(mesh.shape)
    if world != n:
        raise ValueError(f"mesh {dict(mesh.axis_sizes())} has {n} devices, "
                         f"the process group {world} ranks")
    rank = dist.get_rank()
    groups: Dict[str, Any] = {}
    for axis in AXES:
        size = mesh.axis_sizes()[axis]
        others = [a for a in mesh.axis_names if a != axis]
        for r in range(world):          # every row, in one order on all
            c = rank_coords(mesh, r)
            if c[axis]:
                continue
            members = [q for q in range(world)
                       if all(rank_coords(mesh, q)[o] == c[o]
                              for o in others)]
            g = dist.new_group(members) if size > 1 else None
            if rank in members:
                groups[axis] = g
    return Placement(mesh, rank, groups)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_range(entry, dim: int, pl: Placement) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a dim of size ``dim`` under a
    spec entry; raises when the entry's axes do not divide it."""
    n, i = pl.shards(entry)
    if dim % n:
        raise ValueError(f"spec entry {entry!r} splits a dim of {dim} into "
                         f"{n} blocks")
    size = dim // n
    return i * size, (i + 1) * size


def block_slices(spec: Spec, shape: Sequence[int],
                 pl: Placement) -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``spec`` (a spec
    shorter than the leaf leaves its trailing dims whole)."""
    out = []
    for i, dim in enumerate(shape):
        lo, hi = block_range(spec[i] if i < len(spec) else None, dim, pl)
        out.append(slice(lo, hi))
    return tuple(out)


def shard_shape(spec: Spec, shape: Sequence[int],
                pl: Placement) -> Tuple[int, ...]:
    """``NamedSharding(mesh, spec).shard_shape(shape)``."""
    return tuple(s.stop - s.start for s in block_slices(spec, shape, pl))


def shard_leaf(x: torch.Tensor, spec: Spec, pl: Placement) -> torch.Tensor:
    """This rank's block of ``x``, in storage of its own (a meta tensor
    stays meta)."""
    block = x[block_slices(spec, x.shape, pl)]
    return block if block.device.type == "meta" else block.clone()


def spec_items(specs, path: Tuple[str, ...] = ()) -> Dict[Tuple, Spec]:
    """{leaf path: spec} of a tree of specs (dicts and lists; a spec is a
    tuple, so it is a leaf here), paths as ``_map_with_path`` names them."""
    if isinstance(specs, dict):
        items = [(str(k), v) for k, v in specs.items()]
    elif isinstance(specs, list):
        items = [(str(i), v) for i, v in enumerate(specs)]
    else:
        return {path: specs}
    out = {}
    for k, v in items:
        out.update(spec_items(v, path + (k,)))
    return out


def shard_tree(tree, specs, pl: Placement):
    """Every leaf's block: ``specs`` is the tree of specs (the rules'
    output for ``tree``)."""
    flat = spec_items(specs)
    return _map_with_path(lambda names, x: shard_leaf(x, flat[names], pl),
                          tree)


def _safe(spec: Spec, shape: Sequence[int], pl: Placement) -> Spec:
    """``spec`` with each entry whose axes do not divide its dim dropped
    (the reference dry run's ``_safe_spec``)."""
    return tuple(e if e is None or i >= len(shape)
                 or shape[i] % pl.shards(e)[0] == 0 else None
                 for i, e in enumerate(spec))


def batch_specs(batch: Dict[str, Any], pl: Placement) -> Dict[str, Spec]:
    """Each model input's spec (:func:`batch_spec`, safe on its shape);
    scalars (decode's ``pos``) are replicated."""
    out = {}
    for name, x in batch.items():
        shape = tuple(getattr(x, "shape", ()))
        out[name] = _safe(batch_spec(name, len(shape)), shape, pl)
    return out


def batch_blocks(batch: Dict[str, Any], pl: Placement) -> Dict[str, Any]:
    """This rank's rows of every model input; a scalar passes as it is."""
    specs = batch_specs(batch, pl)
    return {k: shard_leaf(v, specs[k], pl) if torch.is_tensor(v)
            and v.dim() else v for k, v in batch.items()}


def param_blocks(params, pl: Placement):
    """This rank's block of every param (:func:`param_shardings`)."""
    return shard_tree(params, param_shardings(pl.mesh, params), pl)


def cache_blocks(cache, pl: Placement):
    """This rank's block of every cache leaf (:func:`cache_shardings`)."""
    return shard_tree(cache, cache_shardings(pl.mesh, cache), pl)


def cache_zeros(meta_cache, pl: Placement, device):
    """This rank's blocks of a zero cache, from the global cache's tree on
    the meta device (``model.init_cache(..., device="meta")``), without
    allocating the global cache."""
    flat = spec_items(cache_shardings(pl.mesh, meta_cache))
    return _map_with_path(
        lambda names, x: torch.zeros(shard_shape(flat[names], x.shape, pl),
                                     dtype=x.dtype, device=device),
        meta_cache)


def gather_leaf(block: torch.Tensor, spec: Spec, pl: Placement,
                axes: Sequence[str] = AXES) -> torch.Tensor:
    """The leaf rebuilt from the ranks' blocks along ``axes``: each dim
    whose entry names only axes among them is gathered whole (one
    all-gather an axis over that axis's group); the other dims stay this
    rank's block. A tuple entry is gathered over its axes last to first,
    the order its row-major blocks nest in."""
    out = block
    for i, entry in enumerate(spec):
        names = _axes(entry)
        if not names or not set(names) <= set(axes):
            continue
        for ax in reversed(names):
            if pl.sizes.get(ax, 1) > 1:
                g = pl.group(ax)
                if g is None:
                    raise RuntimeError(f"no process group for axis {ax!r}: "
                                       "use make_placement, not layout")
                # one gather a sharded axis of the leaf (at most two)
                out = all_gather(out.contiguous(), g, i)  # repro-lint: disable=collective-in-inner-loop
    return out


def unshard_tree(blocks, specs, pl: Placement):
    """Every leaf rebuilt whole on every rank (the tests' check)."""
    flat = spec_items(specs)
    return _map_with_path(lambda names, x: gather_leaf(x, flat[names], pl),
                          blocks)


def tree_shard_bytes(tree, specs, pl: Placement) -> int:
    """Bytes of this rank's blocks of ``tree`` (meta or not), by the
    specs' shard shapes."""
    flat = spec_items(specs)
    total = [0]

    def leaf(names, x):
        if torch.is_tensor(x):
            total[0] += (math.prod(shard_shape(flat[names], x.shape, pl))
                         * x.element_size())
        return x

    _map_with_path(leaf, tree)
    return total[0]
