"""The language model, dense, MoE, state-space (ssm) or hybrid, with GQA
or MLA attention: params, full forward, prefill and decode.

Params are the reference's tree, as tensors: ``{"embed" (V, D), "ln_f"
(D,), "lm_head" (D, V) unless tied, "layers": {"ln1", "ln2", "attn",
"mlp": {"w_gate", "w_up", "w_down"}}}`` with every ``layers`` leaf stacked
over a leading L axis; ``attn`` is ``{"wq", "wk", "wv", "wo"[, "bq", "bk",
"bv"]}`` for GQA and ``{"wq_a", "q_norm", "wq_b" (or "wq"), "wkv_a",
"kv_norm", "wkv_b", "wo"}`` for MLA (``cfg.mla``). The layer loop is a
Python loop over that axis. An MoE config (``family="moe"``) keeps its
first ``first_k_dense`` layers as such blocks in ``dense_layers`` and its
other layers in ``layers``, each with ``"moe": {"router", "w_gate",
"w_up", "w_down"[, "shared"]}`` (``models/moe.py``) for ``"mlp"``; with
``mtp_depth`` it also has ``"mtp"``, one dense block, and ``"mtp_ln"``,
which train a loss term on the token after next and never serve. An ssm
config (falcon-mamba) has ``layers`` of ``{"ln", "mamba"}`` (Mamba1 or
Mamba2, ``models/ssm.py``) and no attention; a hybrid config (zamba2)
adds one unstacked ``shared_attn`` block (attention and MLP, as a dense
layer) that runs after every ``hybrid_attn_every``-th layer, the same
weights each time.

A vlm or audio config (qwen2-vl, musicgen) is a dense one whose inputs
may start with ``n_stub_tokens`` precomputed frontend embeddings
(``stub_embeds`` (B, n_stub, D): image patches, text-conditioning
frames), which take positions like tokens and produce no logits in
``loss_fn``. qwen2-vl rotates by M-RoPE, whose positions are (S, 3).

Entry points (``positions``: (S,), or (S, 3) for mrope, shared by the
batch; by default 0..S-1 over the stub prefix and the tokens):
  init_params(cfg, gen, device, dtype)                   -> params
  forward_hidden(params, cfg, tokens, *, stub_embeds, positions, window,
                 remat)                                  -> (hidden, aux)
  logits_from_hidden(params, cfg, h)                     -> fp32 logits
  softmax_xent(logits, labels)                           -> mean xent
  loss_fn(params, cfg, batch, *, window, remat)          -> (loss, metrics)
  prefill(params, cfg, tokens, *, stub_embeds, positions, window)
                                                         -> (logits, cache)
  decode(params, cfg, token, cache, pos, *, window)      -> (logits, cache)
  init_cache(cfg, batch, max_len, *, window, device, dtype) -> cache

Every attention layer masks by the positions (K3's position path); with
the default positions it masks by index (K3's index path), the same mask.

Weights and cache take ``init_params``'s and ``init_cache``'s ``dtype``:
fp32 by default, as the reference's ``launch/serve.py`` and
``launch/train.py`` run, or bf16, the reference's own default
(``launch/steps.py``). Activations keep the params' dtype from end to end
as the reference's do (norm statistics, attention scores and softmax in
fp32, each output cast back); the logits, the loss and its logsumexp are
fp32. Some leaves stay fp32 whatever the dtype, as the reference's do: an
MoE router, the Mamba layers' ``A_log``, ``dt_bias`` and ``D``, and the
ssm cache's ``h``. Training differentiates ``loss_fn`` with autograd; on
a card every layer's attention runs K3's forward and its hand-written
backward (fp32 at Dh 48 to 128; bf16 at the dense configs' 64 and 128).
Decode cache: ``{"layers": {"k", "v"}}``, each (L, B, S, KH, Dh), for GQA,
and ``{"layers": {"c_kv", "k_rope"}}``, (L, B, S, kv_lora) and (L, B, S,
qk_rope), for MLA; a ring buffer of S = min(window, max_len) slots when
windowed; an MoE config's ``dense_layers`` have a ``"dense_layers"`` entry
of the same form. An ssm config's cache is ``{"ssm": {"h", "conv"}}``,
the states stacked over L: h (L, B, Di, N) for Mamba1 and (L, B, H, P, N)
for Mamba2, conv (L, B, K − 1, C); a hybrid config's also has
``"shared_attn": {"k", "v"}``, (A, B, S, KH, Dh) with one entry for each
of the A = L // ``hybrid_attn_every`` applications of the shared block
(a window applies to it only). ``decode`` writes the new token's entries
(and the new states) into it in place (the reference returns an updated
copy) and returns the same tensors.

zamba2's shared block attends at head dim 112 (d_model / heads).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed_apply)

Params = Dict


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for configs of a family this port does not run."""
    ssm = cfg.family in ("ssm", "hybrid")
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
            or (cfg.family == "moe") != bool(cfg.moe)
            or ssm != bool(cfg.ssm)
            or (cfg.family == "hybrid") != bool(cfg.hybrid_attn_every)
            or (ssm and cfg.mla)):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the LM port "
            "runs dense, vlm, audio and MoE (GQA or MLA), ssm and hybrid "
            "(GQA)")


def unstack(stacked: Params) -> list:
    """The stacked ``layers`` tree as a list of per-layer trees of views,
    one ``unbind`` per leaf: autograd's backward then stacks the layers'
    grads in one op, where indexing each layer would give each a
    zero-filled gradient of the whole stack to add up. A list (the
    trainer's per-layer leaves, ``launch/train.py::value_and_grad``)
    passes through."""
    if isinstance(stacked, list):
        return stacked
    if isinstance(stacked, dict):
        parts = {k: unstack(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stacked))


def _block_init(gen: torch.Generator, cfg: ModelConfig, device,
                dtype: torch.dtype, *, moe: bool = False) -> Params:
    """One block: attention, then an MLP of width ``d_ff``, or the MoE
    when ``moe``."""
    p = {"ln1": rmsnorm_init(cfg.d_model, device, dtype),
         "ln2": rmsnorm_init(cfg.d_model, device, dtype),
         "attn": (attn.mla_init if cfg.mla else attn.gqa_init)(
             gen, cfg, device, dtype)}
    if moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, device, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, device, dtype)
    return p


def _stacked_init(n: int, init) -> Params:
    """``n`` layers of ``init()``, drawn in order and stacked over a leading
    axis. One layer is the stack itself, a view with the leading axis and
    no copy; more are each copied into the stack as drawn and released
    before the next draw, so at most one layer is held beside the stack (a
    7B model's fp32 weights fit a card once, not twice; starcoder2-15b's
    bf16 ones likewise; deepseek-v3's 43 GiB MoE layer in fp32 likewise).
    An empty group draws one layer for its shapes, as the stack of n > 0
    does."""
    layer = init()
    if n == 1:
        return _map(lambda t: t.unsqueeze(0), layer)
    stack = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
    for i in range(n):
        if i:
            layer = init()
        _map(lambda dst, src: dst[i].copy_(src), stack, layer)
        layer = None
    return stack


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), as a tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _ssm_block_init(gen: torch.Generator, cfg: ModelConfig, device,
                    dtype: torch.dtype) -> Params:
    init = (ssm_mod.mamba2_init if cfg.ssm.version == 2
            else ssm_mod.mamba1_init)
    return {"ln": rmsnorm_init(cfg.d_model, device, dtype),
            "mamba": init(gen, cfg, device, dtype)}


def _n_shared_apps(cfg: ModelConfig) -> int:
    """Applications of a hybrid config's shared block (0 otherwise)."""
    if not cfg.hybrid_attn_every:
        return 0
    return cfg.n_layers // cfg.hybrid_attn_every


def _shared_app_index(cfg: ModelConfig, layer_idx: int):
    """(does the shared block run after layer ``layer_idx``?, which
    application it is); never for a config without one."""
    k = cfg.hybrid_attn_every
    if not k:
        return False, -1
    return (layer_idx + 1) % k == 0, (layer_idx + 1) // k - 1


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights from ``gen`` (on ``device``) with the reference's
    distributions: N(0, 1/in) dense, N(0, 0.02²) embedding, ones for the
    norms, zeros for biases, and ``models/ssm.py``'s for the Mamba
    layers; drawn in fp32 and cast to ``dtype`` leaf by leaf (the leaves
    the reference keeps in fp32 stay so), so that a seed gives the same
    draws in every dtype. The reference defaults to bf16; the port's
    drivers pass their dtype, fp32 unless asked, as the reference's own
    ``launch/serve.py`` and ``launch/train.py`` pass fp32. On the ``meta``
    device it allocates nothing (``launch/steps.py::abstract_params``)."""
    _check_supported(cfg)
    params: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model,
                                          device, dtype),
                      "ln_f": rmsnorm_init(cfg.d_model, device, dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device,
                                       dtype)
    if cfg.ssm:
        params["layers"] = _stacked_init(
            cfg.n_layers, lambda: _ssm_block_init(gen, cfg, device, dtype))
        if cfg.hybrid_attn_every:
            params["shared_attn"] = _block_init(gen, cfg, device, dtype)
        return params
    fk = _n_dense(cfg)
    if fk:
        params["dense_layers"] = _stacked_init(
            fk, lambda: _block_init(gen, cfg, device, dtype))
    params["layers"] = _stacked_init(
        cfg.n_layers - fk,
        lambda: _block_init(gen, cfg, device, dtype,
                            moe=cfg.family == "moe"))
    if cfg.mtp_depth:
        params["mtp"] = _block_init(gen, cfg, device, dtype)
        params["mtp_ln"] = rmsnorm_init(cfg.d_model, device, dtype)
    return params


def _n_dense(cfg: ModelConfig) -> int:
    """The leading dense layers an MoE config keeps in ``dense_layers``."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def _groups(params: Params):
    """The stacked layer groups in order: ``dense_layers`` (MoE configs
    with leading dense layers), then ``layers``."""
    return [g for g in ("dense_layers", "layers") if g in params]


def _ffn(p: Params, cfg: ModelConfig, h: torch.Tensor):
    """The block's second half on the residual ``h``: (h + MLP or MoE of
    its norm, the MoE's aux loss or None)."""
    hn = rmsnorm(p["ln2"], h, cfg.norm_eps)
    if "mlp" in p:
        return h + mlp_apply(p["mlp"], hn), None
    y, aux = moe_mod.moe_apply(p["moe"], cfg, hn)
    return h + y, aux


def _positions_default(cfg: ModelConfig, s_eff: int,
                       device) -> torch.Tensor:
    """0..s_eff-1 as int32 (S,), or (S, 3) with each component so for
    mrope."""
    pos = torch.arange(s_eff, dtype=torch.int32, device=device)
    if cfg.rope == "mrope":
        return torch.stack([pos, pos, pos], dim=-1)
    return pos


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  stub_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The tokens' embeddings (B, S, D), after the stub prefix (B,
    n_stub, D) when the config has one and it is given (the reference's
    federated trainer gives none)."""
    x = embed_apply(params["embed"], tokens)
    if cfg.n_stub_tokens and stub_embeds is not None:
        x = torch.cat([stub_embeds.to(x.dtype), x], dim=1)
    return x


def _inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            stub_embeds: Optional[torch.Tensor],
            positions: Optional[torch.Tensor]):
    """(embedded inputs, positions, whether they are the default
    0..S-1, which K3 may take by index)."""
    x = _embed_inputs(params, cfg, tokens, stub_embeds)
    if positions is None:
        return x, _positions_default(cfg, x.shape[1], x.device), True
    return x, positions, False


def _block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 positions: torch.Tensor, window: int, consecutive: bool):
    """One pre-norm block; returns (h, this layer's cache)."""
    pre = attn.mla_prefill if cfg.mla else attn.gqa_prefill
    y, kv = pre(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                positions=positions, window=window, consecutive=consecutive)
    return _ffn(p, cfg, x + y)[0], kv


def _train_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor, window: int, consecutive: bool):
    """One block of the training forward: (h, MoE aux loss or None)."""
    apply = attn.mla_apply if cfg.mla else attn.gqa_apply
    x = x + apply(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                  positions=pos, window=window, consecutive=consecutive)
    return _ffn(p, cfg, x)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   stub_embeds: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   window: int = 0, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward to the final normed hidden states (B,
    S_eff, D), S_eff = the stub prefix's length (when given) + S, and the
    MoE layers' aux losses summed (0 for dense). ``remat`` recomputes each
    layer in the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of the layer body."""
    _check_supported(cfg)
    window = window or cfg.sliding_window
    x, pos, consecutive = _inputs(params, cfg, tokens, stub_embeds,
                                  positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ssm:
        for i, p in enumerate(unstack(params["layers"])):
            x = _remat(_ssm_block, remat, p, cfg, x)
            if _shared_app_index(cfg, i)[0]:
                x, _ = _train_layer(params["shared_attn"], cfg, x, pos,
                                    window, consecutive, remat)
        return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux
    for group in _groups(params):
        for p in unstack(params[group]):
            x, a = _train_layer(p, cfg, x, pos, window, consecutive, remat)
            if a is not None:
                aux = aux + a
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def _remat(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_layer(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor, window: int, consecutive: bool,
                 remat: bool):
    return _remat(_train_block, remat, p, cfg, x, pos, window, consecutive)


def _ssm_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One pre-norm Mamba layer of the training forward."""
    apply = (ssm_mod.mamba2_apply if cfg.ssm.version == 2
             else ssm_mod.mamba1_apply)
    return x + apply(p["mamba"], cfg, rmsnorm(p["ln"], x, cfg.norm_eps))


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
    """batch: tokens (B, S), labels (B, S), optionally stub_embeds (B,
    n_stub, D) and positions (over the S_eff inputs, as for
    ``forward_hidden``). Returns (xent + 0.3 · mtp + aux, {"xent", "aux",
    "mtp"}): the stub positions give no logits; ``mtp`` is 0 without an
    MTP head, else the cross-entropy of the head (one block on the final
    hidden states at the same positions, then ``mtp_ln``) at the token
    after next."""
    S = batch["tokens"].shape[1]
    positions = batch.get("positions")
    h, aux = forward_hidden(params, cfg, batch["tokens"],
                            stub_embeds=batch.get("stub_embeds"),
                            positions=positions, window=window, remat=remat)
    logits = logits_from_hidden(params, cfg, h[:, -S:])
    xent = softmax_xent(logits, batch["labels"])
    loss = xent
    mtp = torch.zeros((), dtype=torch.float32, device=xent.device)
    if cfg.mtp_depth:
        consecutive = positions is None
        if consecutive:
            positions = _positions_default(cfg, h.shape[1], h.device)
        # the reference passes loss_fn's own window here, unresolved
        h2, _ = _train_layer(params["mtp"], cfg, h, positions, window,
                             consecutive, remat)
        h2 = rmsnorm(params["mtp_ln"], h2, cfg.norm_eps)[:, -S:]
        mtp = softmax_xent(logits_from_hidden(params, cfg, h2[:, :-1]),
                           batch["labels"][:, 1:])
        loss = loss + 0.3 * mtp
    return loss + aux, {"xent": xent, "aux": aux, "mtp": mtp}


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               window: int = 0, device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.float32) -> Dict:
    """A zero decode cache of ``max_len`` positions (a ring of min(window,
    max_len) slots when windowed) in the layout above, in ``dtype`` (the
    params'), except the ssm states ``h``, which are fp32 as the
    reference's."""
    _check_supported(cfg)
    window = window or cfg.sliding_window
    S = min(window, max_len) if window else max_len

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, device=device, dtype=dtype)

    def kv(L):
        if cfg.mla:
            m = cfg.mla
            return {"c_kv": zeros(L, batch_size, S, m.kv_lora_rank),
                    "k_rope": zeros(L, batch_size, S, m.qk_rope_head_dim)}
        shape = (L, batch_size, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    if cfg.ssm:
        s, L = cfg.ssm, cfg.n_layers
        di = s.expand * cfg.d_model
        f32 = torch.float32
        if s.version == 2:
            h = zeros(L, batch_size, di // s.head_dim, s.head_dim,
                      s.state_dim, dtype=f32)
            channels = di + 2 * s.n_groups * s.state_dim
        else:
            h = zeros(L, batch_size, di, s.state_dim, dtype=f32)
            channels = di
        cache = {"ssm": {"h": h, "conv": zeros(L, batch_size,
                                               s.conv_dim - 1, channels)}}
        if cfg.hybrid_attn_every:
            cache["shared_attn"] = kv(_n_shared_apps(cfg))
        return cache
    fk = _n_dense(cfg)
    cache = {"dense_layers": kv(fk)} if fk else {}
    cache["layers"] = kv(cfg.n_layers - fk)
    return cache


def _stack_caches(caches: list) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([c[name] for c in caches])
            for name in caches[0]}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            stub_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, window: int = 0
            ) -> Tuple[torch.Tensor, Dict]:
    """Run a full prompt (B, S), after the stub prefix when one is given
    (S_eff positions in all, as for ``forward_hidden``); returns
    (last-token logits (B, V) fp32, cache ``{"layers": {"k", "v"}}`` of
    (L, B, S_c, KH, Dh)), where S_c is S_eff, or min(window, S_eff)
    ring-packed when windowed; for MLA ``{"layers":
    {"c_kv", "k_rope"}}`` of (L, B, S, ·), full length even when windowed,
    as the reference's; an MoE config's ``dense_layers`` under their own
    key; for ssm and hybrid ``{"ssm": {"h", "conv"}}`` (the states after
    the prompt) and a hybrid's ``{"shared_attn": {"k", "v"}}`` (A, B, S_c,
    KH, Dh). Every attention layer (every application of the shared block)
    is one launch of K3 on a card."""
    _check_supported(cfg)
    window = window or cfg.sliding_window
    x, pos, consecutive = _inputs(params, cfg, tokens, stub_embeds,
                                  positions)
    cache = {}
    if cfg.ssm:
        pre = (ssm_mod.mamba2_prefill if cfg.ssm.version == 2
               else ssm_mod.mamba1_prefill)
        states, kvs = [], []
        for i, p in enumerate(unstack(params["layers"])):
            y, state = pre(p["mamba"], cfg,
                           rmsnorm(p["ln"], x, cfg.norm_eps))
            x = x + y
            states.append(state)
            if _shared_app_index(cfg, i)[0]:
                x, kv = _block_apply(params["shared_attn"], cfg, x,
                                     positions=pos, window=window,
                                     consecutive=consecutive)
                kvs.append(kv)
        cache["ssm"] = _stack_caches(states)
        if kvs:
            cache["shared_attn"] = _stack_caches(kvs)
    else:
        for group in _groups(params):
            caches = []
            for p in unstack(params[group]):
                x, kv = _block_apply(p, cfg, x, positions=pos,
                                     window=window, consecutive=consecutive)
                caches.append(kv)
            cache[group] = _stack_caches(caches)
    h = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    return logits_from_hidden(params, cfg, h)[:, 0], cache


def _decode_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  layer_cache: Dict[str, torch.Tensor], pos: int,
                  positions: torch.Tensor, window: int) -> torch.Tensor:
    """One attention block's decode step; writes ``layer_cache`` in
    place."""
    dec = attn.mla_decode if cfg.mla else attn.gqa_decode
    y, _ = dec(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
               cache=layer_cache, pos=pos, positions=positions,
               window=window)
    return _ffn(p, cfg, x + y)[0]


def _layer(cache: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Entry ``i`` of a stacked cache, as views."""
    return {name: c[i] for name, c in cache.items()}


def decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
           cache: Dict, pos: int, *, window: int = 0
           ) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1); pos: the new token's absolute position (its cache
    slot and, in each component for mrope, its rope position). Returns
    (logits (B, V) fp32, cache), the cache updated in place."""
    _check_supported(cfg)
    window = window or cfg.sliding_window
    x = embed_apply(params["embed"], token)
    shape = (1, 3) if cfg.rope == "mrope" else (1,)
    positions = torch.full(shape, pos, dtype=torch.int32, device=x.device)
    if cfg.ssm:
        dec = (ssm_mod.mamba2_decode if cfg.ssm.version == 2
               else ssm_mod.mamba1_decode)
        for i, p in enumerate(unstack(params["layers"])):
            y, _ = dec(p["mamba"], cfg, rmsnorm(p["ln"], x, cfg.norm_eps),
                       _layer(cache["ssm"], i))
            x = x + y
            applied, app = _shared_app_index(cfg, i)
            if applied:
                x = _decode_block(params["shared_attn"], cfg, x,
                                  _layer(cache["shared_attn"], app), pos,
                                  positions, window)
    else:
        for group in _groups(params):
            for i, p in enumerate(unstack(params[group])):
                x = _decode_block(p, cfg, x, _layer(cache[group], i), pos,
                                  positions, window)
    h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, h)[:, 0], cache
