"""Plain PyTorch versions of the port's kernels: what the wrappers run on CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card. Counterparts of the reference's ``em_posterior_ref`` and
``weighted_agg_ref``; ragged shapes are allowed."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def em_posterior_ref(pi: torch.Tensor, logits: torch.Tensor,
                     labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused E-step (Eq 9). pi: (M,); logits: (M, T, V); labels: (T,).

    Returns ``(λ, ℓ)``, both (T, M) fp32: λ = softmax_m(log π_m − ℓ_m(x_t))
    and the per-sample cross-entropy ℓ = logsumexp_V(logits) − label logit,
    all computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = labels.long()[None, :, None].expand(logp.shape[0], -1, 1)
    ll = torch.gather(logp, 2, idx)[..., 0]                     # (M, T)
    score = torch.log(torch.clamp(pi.float(), min=1e-30))[:, None] + ll
    return torch.softmax(score.T, dim=-1), -ll.T


def weighted_agg_ref(own: torch.Tensor, neighbors: torch.Tensor,
                     w: torch.Tensor, alpha: float, *,
                     index: Optional[torch.Tensor] = None,
                     any_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq (1): α·own + (1−α)·Σ_m w_m·nb_m in fp32, cast to own's dtype.
    own: (P,); neighbors: (R, P); nb_m = neighbors[index[m]] (every row
    when ``index`` is None); w: (M,). Where ``any_ok`` (0-d bool) is False
    the result is ``own``."""
    nb = neighbors if index is None else neighbors[index]
    mixed = torch.matmul(w.float(), nb.float())
    out = alpha * own.float() + (1 - alpha) * mixed
    if any_ok is not None:
        out = torch.where(any_ok, out, own.float())
    return out.to(own.dtype)
