"""Mixture-of-Experts: a top-k router and a sort-based dispatch into
(E, C, D) expert buffers, the reference's ``models/moe.py`` off a mesh.

Tokens are sorted by expert id (a stable sort, so each expert keeps the
first ``C`` of its (token, rank) pairs in token-major order and drops the
rest), packed into the buffers by row indexing, run through the experts as
batched products and combined back with the gates. A dropped pair adds
zero; nothing is renormalised (the reference's code, whose module docstring
says otherwise). Every index map is a fixed-shape scatter or gather, so the
dispatch never syncs the host.

Off a mesh the reference routes in one group and pads no expert, so its
group axis, ``logical_shard``, the expert padding and ``REPRO_MOE_MODE``
have no counterpart here. Its ``routed_gather`` custom VJP (a dual gather
that keeps XLA's partitioner feature-sharded) is plain row indexing into a
buffer with a zero pad row: autograd's scatter-add is its exact dual, as
every index map is a bijection plus the pad.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, device,
             dtype: torch.dtype = torch.float32) -> Dict:
    """Router (D, E) N(0, 1/D), fp32 whatever ``dtype`` is, as the
    reference's; ``w_gate``, ``w_up`` (E, D, F) N(0, 1/D); ``w_down`` (E,
    F, D) N(0, 1/F); ``shared`` an MLP of width F · n_shared when the
    config has shared experts; drawn in fp32 and scaled in place (an
    expert leaf is 14 GiB in fp32 at deepseek-v3's width), then cast to
    ``dtype``."""
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.expert_d_ff

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    p = {"router": dense_init(gen, d, e, device),
         "w_gate": normal((e, d, f), d),
         "w_up": normal((e, d, f), d),
         "w_down": normal((e, f, d), f)}
    if m.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * m.n_shared_experts, device, dtype)
    return p


def router_probs(router_w: torch.Tensor, x: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D) -> (gates (T, k) fp32 summing to 1, ids (T, k) int64 in
    descending probability, probs (T, E) fp32)."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def _expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Pairs routed to each expert, (E,) int64, without a host sync (a
    scatter-add: ``bincount`` reads the max id on the host)."""
    flat = ids.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=ids.device).index_add_(
        0, flat, torch.ones_like(flat))


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e (fraction of pairs routed to e) ·
    (mean probability of e). The fractions carry no gradient."""
    frac = _expert_counts(ids, n_experts).float() / max(ids.numel(), 1)
    return n_experts * torch.sum(frac * probs.mean(dim=0))


def capacity(m: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens``: ceil(k·T / E) times the
    capacity factor, truncated, then at least 8 and a multiple of 8 (the
    reference's integer arithmetic; shapes only, so no sync)."""
    cap = int(-(-m.top_k * n_tokens // m.n_experts) * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def routing_stats(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig
                  ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Diagnostics of one MoE call on x (..., D): (pairs dropped past
    capacity, pairs routed, the smallest gap over tokens between the k-th
    and (k+1)-th router probability, inf with one expert a token at most).
    A top-k choice flips when rounding moves a gap that small. Device
    tensors, no sync."""
    xt = x.reshape(-1, x.shape[-1])
    _, ids, probs = router_probs(router_w, xt, m.top_k)
    over = _expert_counts(ids, m.n_experts) - capacity(m, xt.shape[0])
    dropped = torch.clamp(over, min=0).sum()
    if m.top_k >= m.n_experts:
        return dropped, ids.numel(), torch.full((), math.inf,
                                                device=x.device)
    top = torch.topk(probs, m.top_k + 1, dim=-1).values
    return dropped, ids.numel(), (top[:, -2] - top[:, -1]).min()


def moe_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), load-balance loss ·
    ``router_aux_weight``)."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xt = x.reshape(T, D)
    gates, ids, probs = router_probs(params["router"], xt, k)
    aux = load_balance_loss(probs, ids, E) * m.router_aux_weight

    # index plan: the pairs sorted by expert, each one's position within
    # its expert, and its slot e·cap + pos, or the pad slot E·cap if past
    # capacity
    cap = capacity(m, T)
    Tk, pad = T * k, E * cap
    flat_ids = ids.reshape(Tk)
    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    counts = _expert_counts(flat_ids, E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tk, device=x.device) - starts[s_ids]
    slot = torch.where(pos < cap, s_ids * cap + pos,
                       torch.full_like(pos, pad))
    # slot -> token (T = the zero pad row), written one past the end so
    # the dropped pairs' writes land on a row that is cut off
    token_table = torch.full((pad + 1,), T, dtype=torch.int64,
                             device=x.device)
    token_table.scatter_(0, slot, order // k)
    # pair -> slot, in the pairs' own (token-major) order
    slot_of_pair = torch.empty_like(slot).scatter_(0, order, slot)

    zero = x.new_zeros((1, D))
    packed = torch.cat([xt, zero])[token_table[:pad]].view(E, cap, D)
    h = F.silu(torch.bmm(packed, params["w_gate"])) * torch.bmm(
        packed, params["w_up"])
    y = torch.bmm(h, params["w_down"]).view(pad, D)
    parts = torch.cat([y, zero])[slot_of_pair].view(T, k, D)
    out = torch.einsum("tkd,tk->td", parts, gates.to(parts.dtype))
    if m.n_shared_experts:
        out = out + mlp_apply(params["shared"], xt)
    return out.view(B, S, D), aux
