"""Plain PyTorch versions of the port's kernels: what the wrappers run on CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card. Counterparts of the reference's ``flash_attention_ref``,
``em_posterior_ref`` and ``weighted_agg_ref``; ragged shapes are allowed.
``flash_attention_bwd_ref``, ``flash_attention_bwd_bf16_ref`` and
``attention_lse_ref`` are the plain versions of K3's backward (fp32, and
bf16 with its kernels' rounding of P and dS) and of the row log-sum-exp its
training forward saves; only the tests and ``chip_smoke.py`` call them (on
a CPU tensor the plain forward is differentiated by autograd)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KH, Dh), H % KH == 0; query head
    h = kh·G + g reads KV head kh. Full-matrix attention in fp32 (float64
    for float64 inputs) with the masks of :func:`_attention_mask`; a fully
    masked row gives 0. For bf16 inputs as the reference's
    ``chunked_attention`` computes it: Q·Kᵀ and the softmax's max and sum
    in fp32, the unnormalised P rounded to bf16 before P·V (summed in
    fp32), then divided by the sum. Returns (B, Sq, H, Dh) in q's dtype.
    Differentiable by autograd."""
    B, Sq, H, Dh = q.shape
    s = _scores(q, k)
    mask = _attention_mask(Sq, k.shape[1], causal, window, q.device,
                           q_positions, kv_positions)
    s.masked_fill_(~mask[None, :, None, None, :], -math.inf)
    if q.dtype == torch.bfloat16:
        # a fully masked row's max is -inf: from -1e30 its P is exp(-inf)
        m = torch.clamp(s.detach().amax(dim=-1, keepdim=True), min=-1e30)
        p = torch.exp(s - m)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.bfloat16().float(),
                          v.float())
        out = pv / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        return out.reshape(B, Sq, H, Dh).to(q.dtype)
    # out of place: autograd's softmax backward reads the softmax's output
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(p.dtype))
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _attention_mask(Sq: int, Skv: int, causal: bool, window: int,
                    device, q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(Sq, Skv) bool: True where query i sees key j. Positions are
    ``q_positions`` (Sq,) and ``kv_positions`` (Skv,), or the indices when
    they are None. As the reference's ``chunked_attention`` takes them: a
    key at a negative position is invalid, causal keeps k_pos <= q_pos and
    a window keeps k_pos > q_pos − window."""
    if q_positions is None:
        qpos = torch.arange(Sq, device=device)[:, None]
        kpos = torch.arange(Skv, device=device)[None, :]
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    else:
        qpos = q_positions.to(device=device, dtype=torch.long)[:, None]
        kpos = kv_positions.to(device=device, dtype=torch.long)[None, :]
        mask = (kpos >= 0).expand(Sq, Skv).clone()
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor,
            ct: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, Sq, KH, G, Skv) scaled scores, in ``ct``: by default float64 for
    float64 inputs and fp32 otherwise."""
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    if ct is None:
        ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, KH, H // KH, Dh).to(ct)
    return torch.einsum("bqhgd,bkhd->bqhgk", qg, k.to(ct)) / math.sqrt(Dh)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The row log-sum-exp of the scaled, masked scores, (B, H, Sq), with
    +inf for a fully masked row: what K3's training forward saves."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k)
    mask = _attention_mask(Sq, k.shape[1], causal, window, q.device,
                           q_positions, kv_positions)
    s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
    lse = torch.logsumexp(s, dim=-1)                       # (B, Sq, KH, G)
    lse = torch.where(torch.isneginf(lse), math.inf, lse)
    return lse.reshape(B, Sq, H).transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_positions: Optional[torch.Tensor] = None,
                            kv_positions: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K3's backward written out: P = exp(S − LSE) where unmasked (else 0),
    D = rowsum(dO∘O), dS = P∘(dO·Vᵀ − D), dQ = dS·K·scale, dK = dSᵀ·Q·scale
    and dV = Pᵀ·dO, with dK and dV summed over the G query heads of each KV
    head. q, out, dout: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh); lse (B, H,
    Sq) as :func:`attention_lse_ref` gives it; the masks of
    :func:`_attention_mask`. Computes in float64 for float64 and bf16
    inputs (the bf16 values widened: the oracle of K3's bf16 backward) and
    fp32 otherwise; returns (dq, dk, dv) in q's dtype."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    ct = torch.float32 if q.dtype == torch.float32 else torch.float64
    scale = 1.0 / math.sqrt(Dh)
    s = _scores(q, k, ct)
    mask = _attention_mask(Sq, Skv, causal, window, q.device, q_positions,
                           kv_positions)
    row_lse = lse.to(ct).transpose(1, 2).reshape(B, Sq, KH, G)[..., None]
    p = torch.where(mask[None, :, None, None, :], torch.exp(s - row_lse),
                    torch.zeros((), dtype=ct, device=q.device))
    qg = q.reshape(B, Sq, KH, G, Dh).to(ct)
    dog = dout.reshape(B, Sq, KH, G, Dh).to(ct)
    d = torch.sum(dog * out.reshape(B, Sq, KH, G, Dh).to(ct), dim=-1,
                  keepdim=True)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v.to(ct))
    ds = p * (dp - d)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dog)
    return (dq.reshape(B, Sq, H, Dh).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def flash_attention_bwd_bf16_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 q_positions: Optional[torch.Tensor] = None,
                                 kv_positions: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """K3's bf16 backward as its kernels compute it
    (``csrc/flash_attention_bwd_bf16.cu``): :func:`flash_attention_bwd_ref`
    in fp32 on the bf16 values, with P rounded to bf16 before dV = Pᵀ·dO
    and dS = P∘(dP − D) (from the fp32 P) rounded to bf16 before dQ = dS·K
    and dK = dSᵀ·Q, as the forward rounds P before P·V (the reference's
    ``chunked_attention`` rounds it there). Every sum is fp32; ``out`` and
    ``lse`` are the training forward's fp32 output and row LSE; the masks
    of :func:`_attention_mask`. Returns (dq, dk, dv) in bf16."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    ct = torch.float32
    s = _scores(q, k, ct)
    mask = _attention_mask(Sq, Skv, causal, window, q.device, q_positions,
                           kv_positions)
    row_lse = lse.to(ct).transpose(1, 2).reshape(B, Sq, KH, G)[..., None]
    p = torch.where(mask[None, :, None, None, :], torch.exp(s - row_lse),
                    torch.zeros((), dtype=ct, device=q.device))
    del s
    qg = q.reshape(B, Sq, KH, G, Dh).to(ct)
    dog = dout.reshape(B, Sq, KH, G, Dh).to(ct)
    d = torch.sum(dog * out.reshape(B, Sq, KH, G, Dh).to(ct), dim=-1,
                  keepdim=True)
    ds = p * (torch.einsum("bqhgd,bkhd->bqhgk", dog, v.to(ct)) - d)
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p.bfloat16().to(ct), dog)
    del p
    ds = ds.bfloat16().to(ct)
    scale = 1.0 / math.sqrt(Dh)
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, k.to(ct)) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, Dh).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


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
