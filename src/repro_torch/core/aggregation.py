"""Model aggregation (paper Eq 1), simulation scale.

α·ω_n + (1−α)·Σ_m π_m·ω_m over stacked neighbour models, optionally gated
by the round's link-success mask: an erased packet never arrives, so π is
renormalised over the surviving links, and a target whose links all failed
keeps its own model. Every form here runs through the Eq-1 kernel
(:func:`repro_torch.kernels.weighted_agg.weighted_agg`): the flat form in
one launch over the stacked client buffer, the tree forms once per leaf.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.weighted_agg import weighted_agg

Tree = Any


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
