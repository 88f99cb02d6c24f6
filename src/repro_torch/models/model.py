"""The dense language model, with GQA or MLA attention: params, full
forward, prefill and decode.

Params are the reference's tree, as tensors: ``{"embed" (V, D), "ln_f"
(D,), "lm_head" (D, V) unless tied, "layers": {"ln1", "ln2", "attn",
"mlp": {"w_gate", "w_up", "w_down"}}}`` with every ``layers`` leaf stacked
over a leading L axis; ``attn`` is ``{"wq", "wk", "wv", "wo"[, "bq", "bk",
"bv"]}`` for GQA and ``{"wq_a", "q_norm", "wq_b" (or "wq"), "wkv_a",
"kv_norm", "wkv_b", "wo"}`` for MLA (``cfg.mla``). The layer loop is a
Python loop over that axis.

Entry points:
  init_params(cfg, gen, device)                          -> params
  forward_hidden(params, cfg, tokens, *, window, remat)  -> (hidden, aux)
  logits_from_hidden(params, cfg, h)                     -> fp32 logits
  softmax_xent(logits, labels)                           -> mean xent
  loss_fn(params, cfg, batch, *, window, remat)          -> (loss, metrics)
  prefill(params, cfg, tokens, *, window)                -> (logits, cache)
  decode(params, cfg, token, cache, pos, *, window)      -> (logits, cache)
  init_cache(cfg, batch, max_len, *, window, device)     -> cache

Weights and cache are fp32, as the reference's ``launch/serve.py`` and
``launch/train.py`` run. Training differentiates ``loss_fn`` with autograd;
on a card every layer's attention runs K3's forward and its hand-written
backward, which takes GQA's head dims; MLA's (qk_nope + qk_rope: 96 for
minicpm3-4b, 48 at ``reduced()``) wait for it (ROADMAP Queue B, B1), so
on a card an MLA forward that needs gradients raises. MLA serves.
Decode cache: ``{"layers": {"k", "v"}}``, each (L, B, S, KH, Dh), for GQA,
and ``{"layers": {"c_kv", "k_rope"}}``, (L, B, S, kv_lora) and (L, B, S,
qk_rope), for MLA; a ring buffer of S = min(window, max_len) slots when
windowed. ``decode`` writes the new token's entries into it in place (the
reference returns an updated copy) and returns the same tensors.

The moe, ssm, hybrid, vlm/audio (stub embeddings) and mrope branches
raise until their families are ported (ROADMAP Queue A items 2-4).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed_apply)

Params = Dict


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for configs whose family this port does not run yet."""
    if cfg.family != "dense" or cfg.moe or cfg.ssm or cfg.hybrid_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the LM "
            "port runs dense GQA and MLA only (ROADMAP Queue A items 2-3)")
    if cfg.rope == "mrope" or cfg.n_stub_tokens or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: mrope, stub embeddings and MTP are not ported yet "
            "(ROADMAP Queue A items 2 and 4)")


def unstack(stacked: Params) -> list:
    """The stacked ``layers`` tree as a list of per-layer trees of views,
    one ``unbind`` per leaf: autograd's backward then stacks the layers'
    grads in one op, where indexing each layer would give each a
    zero-filled gradient of the whole stack to add up."""
    if isinstance(stacked, dict):
        parts = {k: unstack(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stacked))


def _block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "attn": (attn.mla_init if cfg.mla else attn.gqa_init)(gen, cfg,
                                                                  device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, device)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cuda") -> Params:
    """Random fp32 weights from ``gen`` (on ``device``) with the
    reference's distributions: N(0, 1/in) dense, N(0, 0.02²) embedding,
    ones for the norms, zeros for biases."""
    _check_supported(cfg)
    params: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model,
                                          device),
                      "ln_f": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device)
    params["layers"] = _stack([_block_init(gen, cfg, device)
                               for _ in range(cfg.n_layers)])
    return params


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[1], dtype=torch.int32,
                        device=tokens.device)


def _block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 positions: torch.Tensor, window: int):
    """One pre-norm block; returns (h, this layer's cache)."""
    pre = attn.mla_prefill if cfg.mla else attn.gqa_prefill
    y, kv = pre(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                positions=positions, window=window)
    h = x + y
    return h + mlp_apply(p["mlp"], rmsnorm(p["ln2"], h, cfg.norm_eps)), kv


def _train_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor, window: int) -> torch.Tensor:
    apply = attn.mla_apply if cfg.mla else attn.gqa_apply
    x = x + apply(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                  positions=pos, window=window)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   positions: Optional[torch.Tensor] = None,
                   window: int = 0, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward to the final normed hidden states (B, S, D),
    and the aux loss (0 for dense). ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of the layer body."""
    _check_supported(cfg)
    if positions is not None:
        raise NotImplementedError("custom positions are not ported yet "
                                  "(ROADMAP Queue A item 4)")
    window = window or cfg.sliding_window
    x = embed_apply(params["embed"], tokens)
    pos = _positions(tokens)
    for p in unstack(params["layers"]):
        if remat:
            x = checkpoint(_train_block, p, cfg, x, pos, window,
                           use_reentrant=False)
        else:
            x = _train_block(p, cfg, x, pos, window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed_apply(params["embed"], h, transpose=True)
    return unembed_apply(params["lm_head"], h, transpose=False)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of fp32 ``logits`` (..., V) at integer ``labels``
    (...); a negative label is masked, and the mean runs over the unmasked
    ones (at least 1)."""
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    loss = (lse - ll) * mask
    return torch.sum(loss) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict, *,
            window: int = 0, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S), labels (B, S). Returns (xent + aux, {"xent",
    "aux", "mtp"}); MTP, stub embeddings and custom positions raise until
    their families are ported."""
    h, aux = forward_hidden(params, cfg, batch["tokens"],
                            positions=batch.get("positions"), window=window,
                            remat=remat)
    logits = logits_from_hidden(params, cfg, h)
    loss = softmax_xent(logits, batch["labels"])
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"xent": loss, "aux": aux, "mtp": zero}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               window: int = 0, device: str | torch.device = "cuda") -> Dict:
    _check_supported(cfg)
    window = window or cfg.sliding_window
    S = min(window, max_len) if window else max_len
    L = cfg.n_layers
    if cfg.mla:
        m = cfg.mla
        return {"layers": {
            "c_kv": torch.zeros((L, batch_size, S, m.kv_lora_rank),
                                device=device),
            "k_rope": torch.zeros((L, batch_size, S, m.qk_rope_head_dim),
                                  device=device)}}
    shape = (L, batch_size, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, device=device),
                       "v": torch.zeros(shape, device=device)}}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, window: int = 0
            ) -> Tuple[torch.Tensor, Dict]:
    """Run a full prompt (B, S); returns (last-token logits (B, V) fp32,
    cache ``{"layers": {"k", "v"}}`` of (L, B, S_c, KH, Dh)), where S_c is S,
    or min(window, S) ring-packed when windowed; for MLA ``{"layers":
    {"c_kv", "k_rope"}}`` of (L, B, S, ·), full length even when windowed,
    as the reference's. Every layer's attention is one launch of K3 on a
    card."""
    _check_supported(cfg)
    if positions is not None:
        raise NotImplementedError("custom positions are not ported yet "
                                  "(ROADMAP Queue A item 4)")
    window = window or cfg.sliding_window
    x = embed_apply(params["embed"], tokens)
    pos = _positions(tokens)
    caches = []
    for p in unstack(params["layers"]):
        x, kv = _block_apply(p, cfg, x, positions=pos, window=window)
        caches.append(kv)
    h = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h)[:, 0]
    return logits, {"layers": {name: torch.stack([c[name] for c in caches])
                               for name in caches[0]}}


def decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
           cache: Dict, pos: int, *, window: int = 0
           ) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1); pos: the new token's absolute position. Returns
    (logits (B, V) fp32, cache), the cache updated in place."""
    _check_supported(cfg)
    window = window or cfg.sliding_window
    x = embed_apply(params["embed"], token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    dec = attn.mla_decode if cfg.mla else attn.gqa_decode
    kc = cache["layers"]
    for i, p in enumerate(unstack(params["layers"])):
        y, _ = dec(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                   cache={name: c[i] for name, c in kc.items()}, pos=pos,
                   positions=positions, window=window)
        x = x + y
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, h)[:, 0], cache
