"""Channel-aware PFL neighbor selection (Algorithm 1, top half) and the
per-round link erasures.

For a target client with candidate neighbors at known positions, compute
each link's transmission error probability (the other candidates act as
the interferer set for that session) and select neighbors with
P_err < ε.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import WirelessConfig
from repro_torch.core import wireless
from repro_torch.device import resolve_device


class SelectionResult(NamedTuple):
    p_err: torch.Tensor       # (G,) per-neighbor error probability
    selected: torch.Tensor    # (G,) bool mask  (P_err < eps)


def neighbor_error_probabilities(cfg: WirelessConfig,
                                 target_pos: torch.Tensor,
                                 neighbor_pos: torch.Tensor,
                                 valid: Optional[torch.Tensor] = None,
                                 sinr_threshold: float | None = None
                                 ) -> torch.Tensor:
    """neighbor_pos: (G, 2). For session s (neighbor s -> target), all other
    valid neighbors are interferers. Returns (G,) P_err (1.0 for invalid)."""
    G = neighbor_pos.shape[0]
    if valid is None:
        valid = torch.ones((G,), dtype=torch.bool, device=neighbor_pos.device)
    dists = torch.sqrt(torch.sum((neighbor_pos - target_pos[None]) ** 2,
                                 dim=-1) + 1e-12)
    others = ~torch.eye(G, dtype=torch.bool, device=neighbor_pos.device)
    interferer_d = torch.where(others & valid[None, :], dists[None, :],
                               torch.full_like(dists[None, :], -1.0))
    p = wireless.error_probability(cfg, dists, interferer_d, sinr_threshold)
    return torch.where(valid, p, torch.ones_like(p))


def select_neighbors(cfg: WirelessConfig, target_pos, neighbor_pos,
                     valid=None, *, eps: float | None = None,
                     sinr_threshold: float | None = None,
                     device: str | torch.device = "cuda") -> SelectionResult:
    """Positions (array-likes, metres) go to ``device`` as fp32."""
    dev = resolve_device(device)
    eps = cfg.error_threshold if eps is None else eps
    tpos = torch.as_tensor(target_pos, dtype=torch.float32, device=dev)
    npos = torch.as_tensor(neighbor_pos, dtype=torch.float32, device=dev)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    p = neighbor_error_probabilities(cfg, tpos, npos, valid, sinr_threshold)
    return SelectionResult(p_err=p, selected=p < eps)


def link_success_mask(p_err: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """Per-round Bernoulli erasures: a selected neighbor's model update is
    lost with probability P_err. ``generator`` must live on ``p_err``'s
    device."""
    return torch.rand(p_err.shape, generator=generator,
                      device=p_err.device) >= p_err


def link_success_rate(link_ok: torch.Tensor) -> torch.Tensor:
    """Fraction of this round's D2D links that survived erasure; an empty
    neighbor set reports 1.0 (no link failed)."""
    if link_ok.numel() == 0:
        return torch.ones((), device=link_ok.device)
    return torch.mean(link_ok.float())
