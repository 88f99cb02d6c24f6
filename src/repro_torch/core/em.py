"""EM-based PFL weight assignment (Sec IV-B, Appendix B; Eq 9-11).

  E-step:  λ_im ∝ π_m · exp(-ℓ(h_{ω_m}(x_i), y_i))          (Eq 9)
  M-step:  π_m = (1/k_n) Σ_i λ_im                            (Eq 10)
           ω_m ← argmin Σ_i λ_im ℓ(h_ω(x_i), y_i)            (Eq 11)

All numerics run in log-space (no exp underflow for large losses).
"""
from __future__ import annotations

from typing import Tuple

import torch


def floor_posterior(lam: torch.Tensor, min_weight: float) -> torch.Tensor:
    """Affine map of simplex rows onto the {λ_m >= min_weight} sub-simplex:
    rows of (1 − M·w)·λ + w still sum to 1, and every entry is a true lower
    bound (clamp-then-renormalise is not: the renormalise can push entries
    back below the floor)."""
    if not min_weight:
        return lam
    m = lam.shape[-1]
    scale = max(1.0 - m * min_weight, 0.0)   # m·w >= 1 => uniform row
    return lam * scale + (1.0 - scale) / m


def posterior(pi: torch.Tensor, losses: torch.Tensor,
              min_weight: float = 0.0) -> torch.Tensor:
    """E-step. pi: (M,); losses: (n, M) per-sample per-component loss.
    Returns λ: (n, M), rows on the simplex."""
    logit = torch.log(torch.clamp(pi, min=1e-30))[None, :] - losses
    return floor_posterior(torch.softmax(logit, dim=-1), min_weight)


def update_pi(lam: torch.Tensor) -> torch.Tensor:
    """M-step for the mixture weights (Eq 10)."""
    pi = torch.mean(lam, dim=0)
    return pi / torch.clamp(torch.sum(pi), min=1e-30)


def em_weights(pi0: torch.Tensor, losses: torch.Tensor, *, iters: int = 10,
               min_weight: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterate E/M for fixed per-component losses. Returns (π*, λ*)."""
    pi = pi0
    for _ in range(iters):
        pi = update_pi(posterior(pi, losses, min_weight))
    return pi, posterior(pi, losses, min_weight)


def mixture_log_likelihood(pi: torch.Tensor,
                           losses: torch.Tensor) -> torch.Tensor:
    """Σ_i log Σ_m π_m exp(-ℓ_im), the EM objective (monotone under E/M)."""
    logit = torch.log(torch.clamp(pi, min=1e-30))[None, :] - losses
    return torch.sum(torch.logsumexp(logit, dim=-1))


def weighted_loss(per_sample_losses: torch.Tensor,
                  lam_m: torch.Tensor) -> torch.Tensor:
    """Eq (11) objective for one component: Σ_i λ_im ℓ_i (normalized)."""
    return (torch.sum(lam_m * per_sample_losses)
            / torch.clamp(torch.sum(lam_m), min=1e-30))
