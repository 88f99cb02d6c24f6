"""Attention for prefill and decode: grouped-query attention (full and
sliding-window) and multi-head latent attention (MLA: deepseek, minicpm3).

Prefill (``gqa_apply``, ``gqa_prefill``) runs its attention through K3,
:func:`repro_torch.kernels.flash_attention.flash_attention`, where the
reference runs its pure-JAX twin ``chunked_attention``. Both mask by the
positions they are given, (S,) or mrope's (S, 3) (its temporal
component), shared by the batch: an M-RoPE image's patches share one
temporal position and see each other both ways. The model's default
positions are 0..S-1, and it says so (``consecutive=True``): K3 then
masks by index, its path without position reads, with the same mask.
Training runs the
same call under autograd: on a card, K3's forward (saving its row
log-sum-exp) and its hand-written backward, where the reference
differentiates ``chunked_attention`` under ``jax.checkpoint``. Every
tensor keeps the params' dtype (fp32, or bf16 as the reference defaults
to), with scores and the softmax in fp32 and each output cast to q's
dtype. Decode attends one query token to a cache in plain PyTorch, as
the reference does:
  - full cache:     (B, S, KH, Dh) K/V, valid-prefix mask;
  - sliding window: ring buffer (B, W, KH, Dh), slot = position % W, masked
    by the position each slot holds.

MLA keeps a compressed cache, the normed latent c_kv (B, S, kv_lora) and
the roped k_rope (B, S, qk_rope) shared by every head. Prefill
(``mla_apply``, ``mla_prefill``) expands each position's K and V per head
and runs K3 at head dim qk_nope + qk_rope with v zero-padded to that
width, where the reference runs ``chunked_attention``. Decode
(``mla_decode``) absorbs ``wkv_b`` into the query and attends in latent
space, in plain einsums as the reference does. Off a mesh the reference
pads no heads (``_padded_heads``) and its sharding hints do nothing, so
the port has neither.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (dense_init, linear, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One-token attention. q: (B, 1, H, Dh); k/v: (B, S, KH, Dh);
    mask: (B, S) or (S,) bool. As the reference's: the scores and softmax
    in fp32, P rounded to v's dtype and P·V summed in fp32, the output in
    q's dtype (for fp32 every cast is a no-op)."""
    B, _, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KH, G, Dh).float(),
                     k.float()) * scale
    if mask.dim() == 1:
        mask = mask[None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def ring_slot_positions(pos: int, window: int, device) -> torch.Tensor:
    """Absolute position held by each ring-buffer slot after writing at
    ``pos`` (slot = pos % window); negative => never written."""
    slots = torch.arange(window, device=device)
    return pos - torch.remainder(pos - slots, window)


def gqa_init(gen: torch.Generator, cfg: ModelConfig, device,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    dh = cfg.resolved_head_dim
    d, hq, hkv = cfg.d_model, cfg.n_heads * dh, cfg.n_kv_heads * dh
    p = {"wq": dense_init(gen, d, hq, device, dtype),
         "wk": dense_init(gen, d, hkv, device, dtype),
         "wv": dense_init(gen, d, hkv, device, dtype),
         "wo": dense_init(gen, hq, d, device, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((n,), device=device, dtype=dtype)
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


def _mask_positions(positions: torch.Tensor,
                    consecutive: bool) -> Optional[torch.Tensor]:
    """The positions K3 masks by: the (S,) positions, or the temporal
    component of mrope's (S, 3); None, masking by index, when they are
    known to be 0..S-1."""
    if consecutive:
        return None
    return positions[..., 0] if positions.dim() == 2 else positions


def _attend(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor, window: int, consecutive: bool):
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    pos = _mask_positions(positions, consecutive)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window, q_positions=pos,
                          kv_positions=pos)
    return linear(params["wo"], out.reshape(x.shape[0], x.shape[1], -1)), k, v


def gqa_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int,
              consecutive: bool = False) -> torch.Tensor:
    """Full-sequence self attention (causal, optionally windowed).
    positions: (S,), or (S, 3) for mrope, shared by the batch; the rope
    takes them and K3 masks by them (mrope's by the temporal component),
    as the reference's ``chunked_attention`` does. ``consecutive`` says
    they are 0..S-1 (in mrope's form, each component), so K3 may mask by
    index."""
    return _attend(params, cfg, x, positions, window, consecutive)[0]


def gqa_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, window: int,
                consecutive: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like ``gqa_apply`` but also returns this layer's KV cache: (B, S,
    KH, Dh), or with a window the last min(W, S) positions rolled so that
    slot = position % W (the ring-buffer invariant)."""
    out, k, v = _attend(params, cfg, x, positions, window, consecutive)
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


def mla_init(gen: torch.Generator, cfg: ModelConfig, device,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's MLA params: a q LoRA (``wq_a``, ``q_norm``,
    ``wq_b``) or a full ``wq``; ``wkv_a`` to the latent and k_rope,
    ``kv_norm``, ``wkv_b`` from the latent to each head's k_nope and v;
    ``wo``."""
    m = cfg.mla
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    p: Dict[str, torch.Tensor] = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_init(gen, cfg.d_model, m.q_lora_rank, device,
                               dtype)
        p["q_norm"] = rmsnorm_init(m.q_lora_rank, device, dtype)
        p["wq_b"] = dense_init(gen, m.q_lora_rank, cfg.n_heads * qk_dim,
                               device, dtype)
    else:
        p["wq"] = dense_init(gen, cfg.d_model, cfg.n_heads * qk_dim, device,
                             dtype)
    p["wkv_a"] = dense_init(gen, cfg.d_model,
                            m.kv_lora_rank + m.qk_rope_head_dim, device,
                            dtype)
    p["kv_norm"] = rmsnorm_init(m.kv_lora_rank, device, dtype)
    p["wkv_b"] = dense_init(
        gen, m.kv_lora_rank,
        cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim), device, dtype)
    p["wo"] = dense_init(gen, cfg.n_heads * m.v_head_dim, cfg.d_model,
                         device, dtype)
    return p


def _mla_q(params: Dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """(q_nope, q_rope), each (B, S, H, ·), q_rope roped."""
    m = cfg.mla
    B, S = x.shape[:2]
    if m.q_lora_rank:
        q = rmsnorm(params["q_norm"], linear(params["wq_a"], x), cfg.norm_eps)
        q = linear(params["wq_b"], q)
    else:
        q = linear(params["wq"], x)
    q = q.reshape(B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, variant="rope",
                              theta=cfg.rope_theta)


def _mla_latent_kv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor):
    """The compressed KV: c_kv (B, S, kv_lora), normed, and k_rope (B, S,
    qk_rope), roped."""
    m = cfg.mla
    ckv = linear(params["wkv_a"], x)
    c_kv = rmsnorm(params["kv_norm"], ckv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], positions,
                        variant="rope", theta=cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_attend(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, window: int, consecutive: bool):
    """MLA over the full sequence: (output, c_kv, k_rope). Each position's
    k_nope and v are expanded per head from the latent, k_rope is
    broadcast to every head, v is zero-padded to the q/k width so that one
    K3 call at head dim qk_nope + qk_rope (G = 1) serves, and the padding
    is sliced off before ``wo``."""
    m = cfg.mla
    B, S = x.shape[:2]
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_latent_kv(params, cfg, x, positions)
    kv = linear(params["wkv_b"], c_kv).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
    pos = _mask_positions(positions, consecutive)
    out = flash_attention(q, k, v, causal=True, window=window,
                          q_positions=pos,
                          kv_positions=pos)[..., :m.v_head_dim]
    return linear(params["wo"], out.reshape(B, S, -1)), c_kv, k_rope


def mla_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor, window: int,
              consecutive: bool = False) -> torch.Tensor:
    """Full-sequence MLA self attention (causal, optionally windowed);
    positions (S,), for the rope and K3's masks, and ``consecutive`` as
    for ``gqa_apply``."""
    return _mla_attend(params, cfg, x, positions, window, consecutive)[0]


def mla_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, window: int,
                consecutive: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like ``mla_apply`` but also returns this layer's cache ``{"c_kv",
    "k_rope"}`` at full length, windowed or not, as the reference does
    (it computes the latents twice; here the attention's are kept)."""
    out, c_kv, k_rope = _mla_attend(params, cfg, x, positions, window,
                                    consecutive)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
               cache: Dict[str, torch.Tensor], pos: int,
               positions: torch.Tensor, window: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed one-token MLA decode at absolute position ``pos``:
    q_nope is taken into latent space through ``wkv_b``'s k part, scored
    against c_kv (plus q_rope against k_rope) at 1/sqrt(qk_nope +
    qk_rope), and the latent context leaves through ``wkv_b``'s v part.
    cache c_kv (B, S, kv_lora), k_rope (B, S, qk_rope); with a window it is
    a ring of S slots (slot = pos % S). The new latents are written into
    the cache tensors in place; the same tensors are returned."""
    m = cfg.mla
    B = x.shape[0]
    q_nope, q_rope = _mla_q(params, cfg, x, positions)          # (B,1,H,·)
    c_new, kr_new = _mla_latent_kv(params, cfg, x, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    slot = (pos % S) if window else pos
    c_kv[:, slot] = c_new[:, 0]
    k_rope[:, slot] = kr_new[:, 0]
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, cfg.n_heads,
                                    m.qk_nope_head_dim + m.v_head_dim)
    w_k = wkv_b[..., :m.qk_nope_head_dim]                       # (r, H, dn)
    w_v = wkv_b[..., m.qk_nope_head_dim:]                       # (r, H, dv)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)
    # the scores summed in fp32 whatever the cache's dtype, and P rounded
    # to it before P·c_kv, as the reference's preferred_element_type and
    # cast (ROADMAP Queue C, C8)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
         + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), k_rope.float()))
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if window:
        slot_pos = ring_slot_positions(pos, S, x.device)
        mask = (slot_pos >= 0) & (slot_pos > pos - window)
    else:
        mask = torch.arange(S, device=x.device) <= pos
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", p.to(c_kv.dtype), c_kv)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v)              # (B,1,H,dv)
    out = linear(params["wo"], out.reshape(B, 1, -1))
    return out, {"c_kv": c_kv, "k_rope": k_rope}
