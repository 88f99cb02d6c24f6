"""Grouped-query attention (full and sliding-window) for prefill and decode.

Prefill (``gqa_apply``, ``gqa_prefill``) runs its attention through K3,
:func:`repro_torch.kernels.flash_attention.flash_attention`, where the
reference runs its pure-JAX twin ``chunked_attention``. Training runs the
same call under autograd: on a card, K3's forward (saving its row
log-sum-exp) and its hand-written backward, where the reference
differentiates ``chunked_attention`` under ``jax.checkpoint``. Decode
attends one query token to a cache in plain PyTorch, as the reference
does:
  - full cache:     (B, S, KH, Dh) K/V, valid-prefix mask;
  - sliding window: ring buffer (B, W, KH, Dh), slot = position % W, masked
    by the position each slot holds.
MLA (deepseek, minicpm3) waits for its own port.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import dense_init, linear
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One-token attention in fp32. q: (B, 1, H, Dh); k/v: (B, S, KH, Dh);
    mask: (B, S) or (S,) bool."""
    B, _, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KH, G, Dh), k) * scale
    if mask.dim() == 1:
        mask = mask[None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v).reshape(B, 1, H, Dh)


def ring_slot_positions(pos: int, window: int, device) -> torch.Tensor:
    """Absolute position held by each ring-buffer slot after writing at
    ``pos`` (slot = pos % window); negative => never written."""
    slots = torch.arange(window, device=device)
    return pos - torch.remainder(pos - slots, window)


def gqa_init(gen: torch.Generator, cfg: ModelConfig,
             device) -> Dict[str, torch.Tensor]:
    dh = cfg.resolved_head_dim
    p = {"wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, device),
         "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device),
         "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, device),
         "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * dh,), device=device)
    return p


def _gqa_qkv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    B = x.shape[0]
    dh = cfg.resolved_head_dim
    q = linear(params["wq"], x, params.get("bq")).reshape(B, -1, cfg.n_heads,
                                                          dh)
    k = linear(params["wk"], x, params.get("bk")).reshape(B, -1,
                                                          cfg.n_kv_heads, dh)
    v = linear(params["wv"], x, params.get("bv")).reshape(B, -1,
                                                          cfg.n_kv_heads, dh)
    fraction = cfg.rope_fraction if cfg.rope == "rope2d" else 1.0
    q = apply_rope(q, positions, variant=cfg.rope, theta=cfg.rope_theta,
                   fraction=fraction)
    k = apply_rope(k, positions, variant=cfg.rope, theta=cfg.rope_theta,
                   fraction=fraction)
    return q, k, v


def _attend(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, window: int):
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window)
    return linear(params["wo"], out.reshape(x.shape[0], x.shape[1], -1)), k, v


def gqa_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int) -> torch.Tensor:
    """Full-sequence self attention (causal, optionally windowed).
    positions: (S,) consecutive, as K3 takes its masks from the row and
    column indices."""
    return _attend(params, cfg, x, positions, window)[0]


def gqa_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, window: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like ``gqa_apply`` but also returns this layer's KV cache: (B, S,
    KH, Dh), or with a window the last min(W, S) positions rolled so that
    slot = position % W (the ring-buffer invariant)."""
    out, k, v = _attend(params, cfg, x, positions, window)
    if window:
        S = k.shape[1]
        W = min(window, S)
        k, v = k[:, S - W:], v[:, S - W:]
        if W == window:
            shift = (S - W) % window
            k = torch.roll(k, shift, dims=1)
            v = torch.roll(v, shift, dims=1)
    return out, {"k": k, "v": v}


def gqa_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
               cache: Dict[str, torch.Tensor], pos: int,
               positions: torch.Tensor, window: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode at absolute position ``pos``. cache k/v: (B, S,
    KH, Dh) (S = the window if windowed). The new K/V are written into the
    cache tensors in place (the reference returns updated copies); the
    same tensors are returned."""
    B = x.shape[0]
    q, k_new, v_new = _gqa_qkv(params, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    slot = (pos % window) if window else pos
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    if window:
        slot_pos = ring_slot_positions(pos, S, x.device)
        mask = (slot_pos >= 0) & (slot_pos > pos - window)
    else:
        mask = torch.arange(S, device=x.device) <= pos
    out = decode_attention(q, k, v, mask)
    out = linear(params["wo"], out.reshape(B, 1, -1))
    return out, {"k": k, "v": v}
