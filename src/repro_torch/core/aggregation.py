"""Model aggregation (paper Eq 1) at two scales, and the sharded engine's
client collectives.

Simulation scale: α·ω_n + (1−α)·Σ_m π_m·ω_m over stacked neighbour models,
optionally gated by the round's link-success mask: an erased packet never
arrives, so π is renormalised over the surviving links, and a target whose
links all failed keeps its own model. Every form here runs through the
Eq-1 kernel (:func:`repro_torch.kernels.weighted_agg.weighted_agg`): the
flat form in one launch over the stacked client buffer, the tree forms
once per leaf.

Client collectives: under the sharded engine each rank of a
``torch.distributed`` group holds a contiguous (S, P) slab of the (N, P)
client buffer, and every exchange across clients goes through one of these
wrappers: :func:`client_weighted_mean` (one all-reduce, the FedAvg-family
mean), :func:`gather_clients` (one all-gather of the peer models) and
:func:`exchange_block` (one small all-gather of a block's packed metrics).
With no process group started they reduce over the one process. Each
counts its calls in :data:`calls`, and :data:`collectives` counts the
collectives they made, as the kernels count their launches.

Production scale: :func:`pod_mix`, the same equation as a collective in
which every rank is one client: one all-gather of the rank's models, then
one Eq-1 launch over the gathered rows with the rank's row of π. The
multi-pod round step (``launch/steps.py::make_pfedwn_round_step``) inlines
its own mix and makes its collectives through :func:`all_gather` and
:func:`all_reduce`, counted here under ``calls["round_step"]``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels.weighted_agg import weighted_agg
from repro_torch.roofline import collectives as collective_bytes

Tree = Any

# calls of each client-collective wrapper, and the collectives they made,
# since the last reset
calls: Dict[str, int] = {"client_weighted_mean": 0, "gather_clients": 0,
                         "exchange_block": 0, "pod_mix": 0, "round_step": 0}
collectives = 0


def _map(fn, own: Tree, nbs: Tree) -> Tree:
    if isinstance(own, dict):
        return {k: _map(fn, own[k], nbs[k]) for k in own}
    if isinstance(own, list):
        return [_map(fn, o, n) for o, n in zip(own, nbs)]
    return fn(own, nbs)


def _mix_tree(own: Tree, neighbors_stacked: Tree, w: torch.Tensor, alpha,
              any_ok) -> Tree:
    def mix(o, ns):
        out = weighted_agg(o.reshape(-1), ns.reshape(ns.shape[0], -1),
                           w.float(), alpha, any_ok=any_ok)
        return out.reshape(o.shape)

    return _map(mix, own, neighbors_stacked)


def mix_params(own: Tree, neighbors_stacked: Tree, pi: torch.Tensor,
               alpha: float) -> Tree:
    """Eq (1). neighbors_stacked: leading M axis; pi: (M,) on the simplex."""
    return _mix_tree(own, neighbors_stacked, pi, alpha, None)


def masked_pi(pi: torch.Tensor, link_ok: torch.Tensor) -> torch.Tensor:
    """Zero out erased links and renormalize; if every link failed, the row
    is all zeros (the caller keeps its own model)."""
    w = pi * link_ok.to(pi.dtype)
    total = torch.sum(w)
    return torch.where(total > 0, w / torch.clamp(total, min=1e-30), w)


def mix_params_with_erasures(own: Tree, neighbors_stacked: Tree,
                             pi: torch.Tensor, alpha,
                             link_ok: torch.Tensor) -> Tree:
    """Eq (1) under per-round Bernoulli link erasures."""
    return _mix_tree(own, neighbors_stacked, masked_pi(pi, link_ok), alpha,
                     torch.any(link_ok))


def mix_flat_with_erasures(stack: torch.Tensor, own_row: int,
                           neighbor_rows: torch.Tensor, pi: torch.Tensor,
                           alpha: float, link_ok: torch.Tensor
                           ) -> torch.Tensor:
    """Eq (1) under erasures on the stacked flat client buffer (N, P): mixes
    row ``own_row`` with rows ``neighbor_rows`` (M,) read in place, in one
    kernel launch and with no host sync. Returns the new (P,) row."""
    return weighted_agg(stack[own_row], stack,
                        masked_pi(pi, link_ok).float(), alpha,
                        index=neighbor_rows, any_ok=torch.any(link_ok))


# ------------------------------------------------- client collectives


def reset_counts() -> None:
    """Set :data:`calls` and :data:`collectives` to 0."""
    global collectives
    for k in calls:
        calls[k] = 0
    collectives = 0


def _started(group) -> bool:
    """Whether a collective runs: with no process group started there is
    one rank, and it is the whole exchange."""
    return group is not None or (dist.is_available() and dist.is_initialized())


def all_gather(local: torch.Tensor, group=None) -> torch.Tensor:
    """(D·K, ...) from every rank's (K, ...) ``local``, in rank order: one
    collective, in ``local``'s dtype (gloo takes fp32, bf16 and int8). On
    ``meta`` tensors (the dry run's, which hold no data) it returns the
    result's shape and moves nothing. Each collective is reported to
    :mod:`repro_torch.roofline.collectives` by its result's bytes."""
    global collectives
    if not _started(group):
        return local
    local = local.contiguous()
    out = local.new_empty((dist.get_world_size(group) * local.shape[0],)
                          + tuple(local.shape[1:]))
    if local.device.type != "meta":
        with warnings.catch_warnings():
            # newer torch renames it all_gather_single; older has no new name
            warnings.filterwarnings("ignore", category=FutureWarning,
                                    message=".*all_gather_into_tensor")
            dist.all_gather_into_tensor(out, local, group=group)
    collectives += 1
    collective_bytes.record("all-gather", out)
    return out



def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the group's ranks, in place: one collective (on
    ``meta`` tensors none moves, as for :func:`all_gather`)."""
    global collectives
    if _started(group):
        if x.device.type != "meta":
            dist.all_reduce(x, group=group)
        collectives += 1
        collective_bytes.record("all-reduce", x)
    return x


def client_weighted_mean(params_local: torch.Tensor, w_local: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Σ_n w_n·ω_n over all N clients: this rank contracts its (S, P) slab
    with its (S,) slice of the *globally normalised* weights, and one
    all-reduce of the (P,) partial sums completes it. Matches
    ``baselines.fedavg_aggregate`` up to float summation order."""
    calls["client_weighted_mean"] += 1
    part = all_reduce(w_local.float() @ params_local.float(), group)
    return part.to(params_local.dtype)


def gather_clients(params_local: torch.Tensor, group=None) -> torch.Tensor:
    """The full (N, P) client stack, replicated, from every rank's (S, P)
    slab: one all-gather, the slabs in rank order (the contiguous client
    partition's order)."""
    calls["gather_clients"] += 1
    return all_gather(params_local, group)


def exchange_block(packed: torch.Tensor, group=None) -> torch.Tensor:
    """(D, K) from every rank's (K,) ``packed`` block metrics: the one small
    exchange of a sharded block."""
    calls["exchange_block"] += 1
    return all_gather(packed[None], group)


def pod_mix(params: Tree, pi_matrix, alpha: float,
            link_ok: Optional[torch.Tensor] = None, group=None) -> Tree:
    """Eq (1) across the ranks of ``group`` (the default group when None),
    each rank one client: the reference's pod-axis ``pod_mix``.

    ``params``: this rank's model, a tensor or a tree (dict, list, tuple)
    of tensors on one device. ``pi_matrix``: (C, C), row n client n's
    weights over all C clients, its diagonal ignored (the self term is the
    α blend). ``link_ok``: (C, C) bool, the round's link successes, or None.
    The leaves are flattened into one fp32 buffer, so a tree costs one
    all-gather; the mix is one Eq-1 launch over the C gathered rows with
    this rank's row of π, erased links zeroed and renormalised over the
    rest. When that row's total is 0 (every link erased, or every surviving
    link of zero weight) the rank keeps its own model. Each leaf comes back
    in its own shape and dtype."""
    calls["pod_mix"] += 1
    leaves, spec = tree_flatten(params)
    own = torch.cat([x.reshape(-1).float() for x in leaves])
    dev = own.device
    started = _started(group)
    rank = dist.get_rank(group) if started else 0
    pi_matrix = torch.as_tensor(pi_matrix, dtype=torch.float32, device=dev)
    row = pi_matrix[rank].clone()
    row[rank] = 0.0                                   # no self term
    if link_ok is not None:
        row = row * torch.as_tensor(link_ok, device=dev)[rank].float()
    total = torch.sum(row)
    row = torch.where(total > 0, row / torch.clamp(total, min=1e-30), row)
    allp = all_gather(own[None], group)               # (C, P)
    out = weighted_agg(own, allp, row, alpha, any_ok=total > 0)
    parts = torch.split(out, [x.numel() for x in leaves])
    return tree_unflatten([p.reshape(x.shape).to(x.dtype)
                           for p, x in zip(parts, leaves)], spec)
