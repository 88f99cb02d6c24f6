"""Mixture-of-Experts: a top-k router and a sort-based dispatch into
(E, G·C, D) expert buffers, the reference's ``models/moe.py``.

Tokens are sorted by expert id (a stable sort, so each expert keeps the
first ``C`` of its (token, rank) pairs in token-major order and drops the
rest), packed into the buffers by row indexing, run through the experts as
batched products and combined back with the gates. A dropped pair adds
zero; nothing is renormalised (the reference's code, whose module docstring
says otherwise). Every index map is a fixed-shape scatter or gather, so the
dispatch never syncs the host.

Routing is group-local, as the reference's under a mesh: with G groups
(G dividing the T tokens; one group otherwise) each run of T/G
consecutive tokens is routed on its own, with its own capacity
``capacity(m, T/G)``, its own stable sort and its own drops; the aux loss
stays over all T tokens. The reference takes G from the active mesh's
"data" axis; here a caller passes ``groups`` or sets
:func:`route_groups`, so the one-rank model routes as the reference does
under a mesh of G data ranks (``sharding/tensor_parallel.py`` routes a
data rank's own rows, which are exactly one of those groups). A buffer
holds each expert's G·C slots, expert-major and group within, so the
slots of a range of experts are contiguous: :func:`route_plan` is the
index plan, and :func:`expert_mix` packs, runs and combines only the
experts [lo, lo + n) (the placed model's experts over "model"; a pair
routed elsewhere adds zero). The reference pads the expert axis to a
multiple of "model"'s size; a padded expert never gets a slot, so the
padding has no counterpart here but the ranges. Its ``logical_shard``
and ``REPRO_MOE_MODE`` are XLA's and a debugging switch. Its
``routed_gather`` custom VJP (a dual gather that keeps XLA's partitioner
feature-sharded) is plain row indexing into a buffer with a zero pad
row: autograd's scatter-add is its exact dual, as every index map is a
bijection plus the pad.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

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


def expert_counts(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
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
    frac = expert_counts(ids, n_experts).float() / max(ids.numel(), 1)
    return n_experts * torch.sum(frac * probs.mean(dim=0))


def capacity(m: MoEConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens``: ceil(k·T / E) times the
    capacity factor, truncated, then at least 8 and a multiple of 8 (the
    reference's integer arithmetic; shapes only, so no sync)."""
    cap = int(-(-m.top_k * n_tokens // m.n_experts) * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


_ROUTE = {"groups": 1}


@contextlib.contextmanager
def route_groups(n: int):
    """Within it, :func:`moe_apply` and :func:`routing_stats` called
    without ``groups`` route in ``n`` groups (where ``n`` divides the
    tokens), as the reference does under a mesh of ``n`` data ranks."""
    if n < 1:
        raise ValueError(f"route_groups({n}): a group count is at least 1")
    before = _ROUTE["groups"]
    _ROUTE["groups"] = n
    try:
        yield
    finally:
        _ROUTE["groups"] = before


def n_groups(n_tokens: int, groups: Optional[int] = None) -> int:
    """The groups a call of ``n_tokens`` routes in: ``groups`` (by default
    :func:`route_groups`') when it divides them, else one."""
    g = _ROUTE["groups"] if groups is None else groups
    return g if g > 1 and n_tokens % g == 0 else 1


def _pair_keys(ids: torch.Tensor, groups: int) -> torch.Tensor:
    """Each (token, rank) pair's sort key, token-major: its expert, or
    with G groups expert · G + its group."""
    flat = ids.reshape(-1)
    if groups == 1:
        return flat
    per = flat.numel() // groups
    return flat * groups + torch.arange(flat.numel(),
                                        device=ids.device) // per


class RoutePlan(NamedTuple):
    """Where each pair goes: ``token_table`` (E·G·C,), the token of each
    slot (T, the zero pad row, for an empty one); ``slot_of_pair``
    (T·k,), each pair's slot (E·G·C when it was dropped), in the pairs'
    own order; ``per_expert`` = G·C, an expert's slots."""
    token_table: torch.Tensor
    slot_of_pair: torch.Tensor
    per_expert: int


def route_plan(ids: torch.Tensor, n_experts: int, cap: int,
               groups: int = 1) -> RoutePlan:
    """The index plan of ids (T, k) routed in ``groups`` runs of
    consecutive tokens, ``cap`` slots an expert a group: the pairs sorted
    by (expert, group), each one's position within its (expert, group)
    and its slot (e·G + g)·cap + pos, or the pad slot E·G·cap if past
    capacity."""
    T, k = ids.shape
    Tk = T * k
    key = _pair_keys(ids, groups)
    pad = n_experts * groups * cap
    order = torch.argsort(key, stable=True)
    s_key = key[order]
    counts = expert_counts(key, n_experts * groups)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tk, device=ids.device) - starts[s_key]
    slot = torch.where(pos < cap, s_key * cap + pos,
                       torch.full_like(pos, pad))
    # slot -> token (T = the zero pad row), written one past the end so
    # the dropped pairs' writes land on a row that is cut off
    token_table = torch.full((pad + 1,), T, dtype=torch.int64,
                             device=ids.device)
    token_table.scatter_(0, slot, order // k)
    # pair -> slot, in the pairs' own (token-major) order
    slot_of_pair = torch.empty_like(slot).scatter_(0, order, slot)
    return RoutePlan(token_table[:pad], slot_of_pair, groups * cap)


def expert_mix(experts: Dict, plan: RoutePlan, xt: torch.Tensor,
               gates: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Σ over each token's kept pairs routed to experts [lo, lo + n) of
    gate · expert(token), (T, D); ``experts`` holds those n experts'
    ``w_gate``, ``w_up`` (n, D, F) and ``w_down`` (n, F, D). A pair routed
    elsewhere, or dropped, adds zero."""
    n = experts["w_gate"].shape[0]
    c = plan.per_expert
    T, D = xt.shape
    zero = xt.new_zeros((1, D))
    rows = plan.token_table[lo * c:(lo + n) * c]
    packed = torch.cat([xt, zero])[rows].view(n, c, D)
    h = F.silu(torch.bmm(packed, experts["w_gate"])) * torch.bmm(
        packed, experts["w_up"])
    y = torch.bmm(h, experts["w_down"]).view(n * c, D)
    local = plan.slot_of_pair - lo * c
    local = torch.where((local >= 0) & (local < n * c), local, n * c)
    parts = torch.cat([y, zero])[local].view(T, gates.shape[1], D)
    return torch.einsum("tkd,tk->td", parts, gates.to(parts.dtype))


@torch.no_grad()
def routing_stats(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig,
                  groups: Optional[int] = None
                  ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Diagnostics of one MoE call on x (..., D) routed in ``groups``
    (:func:`n_groups`): (pairs dropped past capacity, pairs routed, the
    smallest gap over tokens between the k-th and (k+1)-th router
    probability, inf with one expert a token at most). A top-k choice
    flips when rounding moves a gap that small. Device tensors, no
    sync."""
    xt = x.reshape(-1, x.shape[-1])
    _, ids, probs = router_probs(router_w, xt, m.top_k)
    G = n_groups(xt.shape[0], groups)
    over = (expert_counts(_pair_keys(ids, G), m.n_experts * G)
            - capacity(m, xt.shape[0] // G))
    dropped = torch.clamp(over, min=0).sum()
    if m.top_k >= m.n_experts:
        return dropped, ids.numel(), torch.full((), math.inf,
                                                device=x.device)
    top = torch.topk(probs, m.top_k + 1, dim=-1).values
    return dropped, ids.numel(), (top[:, -2] - top[:, -1]).min()


def moe_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
              groups: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), load-balance loss over all B·S
    tokens · ``router_aux_weight``), routed in ``groups``
    (:func:`n_groups`: by default :func:`route_groups`', one outside it)."""
    m = cfg.moe
    B, S, D = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xt = x.reshape(T, D)
    gates, ids, probs = router_probs(params["router"], xt, k)
    aux = load_balance_loss(probs, ids, E) * m.router_aux_weight
    G = n_groups(T, groups)
    out = expert_mix(params, route_plan(ids, E, capacity(m, T // G), G),
                     xt, gates)
    if m.n_shared_experts:
        out = out + mlp_apply(params["shared"], xt)
    return out.view(B, S, D), aux
