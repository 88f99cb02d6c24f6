"""Step functions and abstract input specs, the reference's
``launch/steps.py`` on one device:

  - ``make_train_step``: one local SGD step (forward, backward, update),
    the update in the params' dtype, as the reference's;
  - ``make_prefill_step`` / ``make_decode_step``: the serving paths;
  - ``input_specs``: every model input of an (arch × shape) combination as
    a tensor on the ``meta`` device (shape and dtype, no storage), the
    port's ``jax.ShapeDtypeStruct``; ``abstract_params`` and
    ``abstract_cache`` build the param and cache trees there, the port's
    ``jax.eval_shape``;
  - ``_per_sequence_loss``: the (B,) mean cross-entropy a sequence, the EM
    per-sample loss at LM scale.

Off a mesh the reference's sharding hints and gradient layouts do
nothing, and ``unroll`` only changes how XLA counts a scanned layer, so
the port has neither. The multi-pod round (``make_pfedwn_round_step``)
is not ported yet (ROADMAP Queue A, A3).

The reference's defaults are bf16 (``input_specs``, ``abstract_params``,
``abstract_cache``); so are these. A step runs in the params' dtype: on a
card K3's forward and backward take fp32 and bf16 (bf16 at the dense
configs' head dims, 64 and 128).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.train import (_layered, _sgd_in_param_dtype_,
                                      value_and_grad)
from repro_torch.models import model as model_lib

Params = Any


def effective_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The config's window, or the shape's forced one for an attention
    config that has none: long-context decode's sliding-window
    substitution (the reference's DESIGN.md §Arch-applicability)."""
    if shape.force_sliding_window and cfg.family != "ssm":
        return cfg.sliding_window or shape.force_sliding_window
    return cfg.sliding_window


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input: tokens (and labels
    for training) (B, S) int32, a stub frontend's embeddings (B, n_stub,
    D) in ``dtype``, M-RoPE's positions (S_eff, 3) int32; for decode ONE
    new token (B, 1) against a seq_len cache and its position, a 0-d
    int32."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        specs = {"tokens": _meta((B, S), i32)}
        if shape.mode == "train":
            specs["labels"] = _meta((B, S), i32)
        if cfg.n_stub_tokens:
            specs["stub_embeds"] = _meta((B, cfg.n_stub_tokens, cfg.d_model),
                                         dtype)
        if cfg.rope == "mrope":
            specs["positions"] = _meta((S + cfg.n_stub_tokens, 3), i32)
        return specs
    return {"token": _meta((B, 1), i32), "pos": _meta((), i32)}


def abstract_params(cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16) -> Params:
    """``init_params``'s tree in ``dtype`` on the meta device."""
    return model_lib.init_params(cfg, torch.Generator(), device="meta",
                                 dtype=dtype)


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
    """``init_cache``'s tree for ``shape`` (global_batch sequences of
    seq_len positions, under the effective window) on the meta device."""
    return model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                window=effective_window(cfg, shape),
                                device="meta", dtype=dtype)


def make_train_step(cfg: ModelConfig, train: TrainConfig,
                    shape: ShapeConfig) -> Callable:
    """``train_step(params, batch) -> (params, metrics)``: ``loss_fn`` at
    the shape's effective window (recomputing each layer in the backward
    when ``train.remat``), its gradients layer by layer
    (``value_and_grad(by_layer=True)``), and SGD at ``train.lr`` in the
    params' dtype (:func:`_sgd_in_param_dtype_`). The params are updated
    in place, each stacked layer's slice from that layer's gradient, so a
    step holds one copy of the weights (the reference returns a new tree;
    the returned params are the given ones). ``metrics``: the reference's
    keys, ``xent``, ``aux``, ``mtp`` and ``loss``."""
    window = effective_window(cfg, shape)

    def train_step(params: Params, batch: Dict) -> Tuple[Params, Dict]:
        loss, metrics, grads = value_and_grad(params, cfg, batch,
                                              window=window,
                                              remat=train.remat,
                                              by_layer=True)
        _sgd_in_param_dtype_(_layered(params), grads, train.lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``prefill_step(params, batch) -> (last-token logits, cache)`` at the
    shape's effective window; batch: tokens, optionally stub_embeds and
    positions."""
    window = effective_window(cfg, shape)

    @torch.no_grad()
    def prefill_step(params: Params, batch: Dict):
        return model_lib.prefill(params, cfg, batch["tokens"],
                                 stub_embeds=batch.get("stub_embeds"),
                                 positions=batch.get("positions"),
                                 window=window)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``decode_step(params, cache, batch) -> (logits, cache)`` at the
    shape's effective window; batch: token (B, 1) and pos (its absolute
    position, an int or a 0-d tensor). The new token's entries are written
    into ``cache`` in place (the reference returns an updated copy)."""
    window = effective_window(cfg, shape)

    @torch.no_grad()
    def decode_step(params: Params, cache: Dict, batch: Dict):
        return model_lib.decode(params, cfg, batch["token"], cache,
                                int(batch["pos"]), window=window)

    return decode_step


def _per_sequence_loss(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, labels: torch.Tensor,
                       window: int) -> torch.Tensor:
    """(B,) mean cross-entropy a sequence over its unmasked labels (at
    least 1): the EM per-sample loss at LM scale, a sample being one
    sequence (Eq 8's ℓ)."""
    h, _ = model_lib.forward_hidden(params, cfg, tokens, window=window)
    logits = model_lib.logits_from_hidden(params, cfg, h)
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    return torch.sum(per_tok, dim=1) / torch.clamp(torch.sum(mask, dim=1),
                                                   min=1.0)
