"""Plain PyTorch versions of the port's kernels: what the wrappers run on CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card. Counterparts of the reference's ``flash_attention_ref``,
``em_posterior_ref`` and ``weighted_agg_ref``; ragged shapes are allowed."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KH, Dh), H % KH == 0; query head
    h = kh·G + g reads KV head kh. Full-matrix attention in fp32 with the
    masks taken from positions counted from 0 on both sides (causal:
    k_pos <= q_pos; window: k_pos > q_pos − window); a fully masked row
    gives 0. Returns (B, Sq, H, Dh) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask[None, :, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1).nan_to_num_(nan=0.0)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


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
