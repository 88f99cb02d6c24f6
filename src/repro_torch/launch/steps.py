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
    per-sample loss at LM scale;
  - ``make_pfedwn_round_step``: the multi-pod production round, one FL
    client a rank of the mesh's ``"pod"`` group: local step, model
    exchange (one all-gather, the D2D over-the-air hop, optionally int8),
    EM weights on a probe slice (Eq 9-10), and the Eq-1 mix gated by the
    wireless link mask, through K2.

The train, prefill and decode steps take an optional ``placement``: one
client of the dense or MoE family sharded over a ``("data", "model")``
mesh of ranks, the batch over "data", heads, d_ff and experts over
"model", the MoE routing group-local over "data"
(``sharding/tensor_parallel.py``), each rank holding its blocks of the
params, batch and cache by the reference's specs (``sharding/place.py``),
where the reference jits the same builders with ``in_shardings`` under
its mesh and pins the gradients to the params' layouts
(``grad_shardings``). Without one a step runs on one device as
before. ``unroll`` only changes how XLA counts a scanned layer, so the
port has none.

The reference's defaults are bf16 (``input_specs``, ``abstract_params``,
``abstract_cache``); so are these. A step runs in the params' dtype: on a
card K3's forward and backward take fp32 and bf16 (bf16 at the dense
configs' head dims, 64 and 128).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import aggregation, em
from repro_torch.kernels.weighted_agg import weighted_agg
from repro_torch.launch.mesh import MeshSpec, pod_group
from repro_torch.launch.train import (_layered, _sgd_in_param_dtype_,
                                      value_and_grad)
from repro_torch.models import model as model_lib
from repro_torch.sharding import tensor_parallel
from repro_torch.sharding.place import Placement
from repro_torch.utils.bridge import ParamLayout, tree_leaves

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
                    shape: ShapeConfig, *,
                    placement: Optional[Placement] = None) -> Callable:
    """``train_step(params, batch) -> (params, metrics)``: ``loss_fn`` at
    the shape's effective window (recomputing each layer in the backward
    when ``train.remat``), its gradients layer by layer
    (``value_and_grad(by_layer=True)``), and SGD at ``train.lr`` in the
    params' dtype (:func:`_sgd_in_param_dtype_`). The params are updated
    in place, each stacked layer's slice from that layer's gradient, so a
    step holds one copy of the weights (the reference returns a new tree;
    the returned params are the given ones). ``metrics``: the reference's
    keys, ``xent``, ``aux``, ``mtp`` and ``loss``.

    With ``placement`` (``sharding/place.py::make_placement``) the step is
    one rank's of a client sharded over its ``("data", "model")`` mesh
    (:func:`repro_torch.sharding.tensor_parallel.make_train_step`): it
    takes this rank's blocks of the params and the batch
    (``place.param_blocks``, ``place.batch_blocks``), updates the param
    blocks in place, and every rank returns the whole client's metrics;
    the dense and MoE families with GQA attention (others raise
    NotImplementedError naming ROADMAP D1c)."""
    window = effective_window(cfg, shape)
    if placement is not None:
        return tensor_parallel.make_train_step(cfg, train, shape, placement,
                                               window)

    def train_step(params: Params, batch: Dict) -> Tuple[Params, Dict]:
        loss, metrics, grads = value_and_grad(params, cfg, batch,
                                              window=window,
                                              remat=train.remat,
                                              by_layer=True)
        _sgd_in_param_dtype_(_layered(params), grads, train.lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *,
                      placement: Optional[Placement] = None) -> Callable:
    """``prefill_step(params, batch) -> (last-token logits, cache)`` at the
    shape's effective window; batch: tokens, optionally stub_embeds and
    positions. With ``placement``, one rank's of a sharded client: it takes
    this rank's blocks and returns the logits whole (every data rank's
    rows) and this rank's blocks of the cache, in ``cache_shardings``'
    layout."""
    window = effective_window(cfg, shape)
    if placement is not None:
        return tensor_parallel.make_prefill_step(cfg, shape, placement,
                                                 window)

    @torch.no_grad()
    def prefill_step(params: Params, batch: Dict):
        return model_lib.prefill(params, cfg, batch["tokens"],
                                 stub_embeds=batch.get("stub_embeds"),
                                 positions=batch.get("positions"),
                                 window=window)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig, *,
                     placement: Optional[Placement] = None) -> Callable:
    """``decode_step(params, cache, batch) -> (logits, cache)`` at the
    shape's effective window; batch: token (B, 1) and pos (its absolute
    position, an int or a 0-d tensor). The new token's entries are written
    into ``cache`` in place (the reference returns an updated copy). With
    ``placement``, one rank's of a sharded client: it takes this rank's
    blocks of the params, the cache (``place.cache_blocks`` or
    ``place.cache_zeros``) and the token, writes the new entries into its
    cache blocks and returns the logits whole."""
    window = effective_window(cfg, shape)
    if placement is not None:
        return tensor_parallel.make_decode_step(cfg, shape, placement,
                                                window)

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


# the round's metrics, in the order they are packed for the one all-reduce
ROUND_METRICS = ("loss", "xent", "aux", "mtp")


def exchange_models(flat: torch.Tensor, layout: ParamLayout,
                    exchange_bits: int, group=None) -> torch.Tensor:
    """The D2D exchange: every rank's (P,) model as a (C, P) stack in the
    params' dtype, rows in rank order. Full precision by one all-gather;
    with ``exchange_bits == 8`` each leaf is quantized symmetrically per
    tensor as the reference does (steps.py:202-211): scale = max(max|p|,
    1e-12) / 127 in fp32, q = clip(round(p / scale), -127, 127) as int8
    (rounding half to even), one all-gather of the int8 buffer and one of
    the (n_leaves,) fp32 scales, then q · scale in the params' dtype. Each
    of these is one pass over the whole buffer, the scales repeated over
    their leaves' elements. The divisions are IEEE divisions on both
    devices (a CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead, an ulp off the reference's scale)."""
    if exchange_bits != 8:
        return aggregation.all_gather(flat[None], group)
    dev, sizes = flat.device, layout.sizes

    def per_element(s: torch.Tensor) -> torch.Tensor:
        # (n_leaves,) -> (P,): each leaf's entry over its elements
        return torch.cat([v.expand(n) for v, n in zip(s, sizes)])

    # max|p| of every leaf at once (exact in the params' dtype)
    amax = torch.stack(torch._foreach_norm(
        [x.reshape(-1) for x in tree_leaves(layout.views(flat))],
        float("inf")))
    scales = (torch.clamp(amax.float(), min=1e-12)
              / torch.full((), 127.0, device=dev))
    q = torch.div(flat, per_element(scales))    # in fp32, as p.f32 / scale
    q = torch.clamp_(torch.round_(q), -127, 127).to(torch.int8)
    qg = aggregation.all_gather(q[None], group)                 # (C, P)
    sg = aggregation.all_gather(scales[None], group)            # (C, n)
    del q
    out = torch.empty(qg.shape, dtype=flat.dtype, device=dev)
    for row, q_row, s_row in zip(out, qg, sg.to(flat.dtype)):
        torch.mul(q_row, per_element(s_row), out=row)
    return out


def make_pfedwn_round_step(cfg: ModelConfig, train: TrainConfig,
                           shape: ShapeConfig, mesh: MeshSpec, *,
                           n_clients: int, alpha: float = 0.5,
                           em_iters: int = 3, probe_sequences: int = 4,
                           probe_tokens: int = 512, exchange_bits: int = 16,
                           group=None) -> Callable:
    """The multi-pod production round (the reference's steps.py:165-273),
    rank-local: ``round_step(params, batch, pi_matrix, link_ok) ->
    (params, new_pi, metrics)``, run by every rank of the ``"pod"`` group
    (``group``, else the first ``n_clients`` ranks of the started default
    group; ``launch/mesh.py::pod_group``), rank c being client c.

    ``params`` and ``batch`` are this rank's client, with no client axis;
    every leaf of ``params`` in one dtype, updated in place and returned.
    ``pi_matrix`` (C, C) fp32 and ``link_ok`` (C, C) bool are the same on
    every rank. A round:
      1. the local step, ``make_train_step(cfg, train, shape)``;
      2. the exchange (:func:`exchange_models`) of a copy of the rank's
         leaves as one (P,) buffer;
      3. EM (Eq 9-10): the (n, C) per-sequence losses of the C exchanged
         models on the probe ``batch[:probe_sequences, :probe_tokens]``,
         each read through views of its row under ``no_grad``, 1e30 added
         to the rank's own column; π from the rank's row of
         ``pi_matrix``, entries <= 0 replaced by 1/C, normalised;
         ``em.em_weights`` for ``em_iters`` iterations (its floor leaves
         the own weight near 1e-8);
      4. the Eq-1 mix: w = π*·link_ok[rank] renormalised where its total
         is > 0, then one K2 launch of the exact own buffer with the C
         exchanged rows (the rank's own among them, dequantized in int8
         mode, at its ~1e-8 weight); a rank whose links are all erased
         keeps its post-step model bit for bit; the result is copied
         back into the leaves;
      5. ``new_pi`` (C, C): one all-gather of π*; ``metrics``: one
         all-reduce of the packed ``ROUND_METRICS`` over C.
    That is 3 collectives a round (4 with int8: the scales), counted in
    ``core.aggregation.collectives`` under ``calls["round_step"]``, and no
    host sync. ``mark(stage)``, when given, is called after each of the
    stages ``"local_step"``, ``"exchange"``, ``"em"``, ``"mix"`` and
    ``"outputs"`` (a timer's hook).

    Raises ValueError unless the mesh's ``"pod"`` axis, ``n_clients`` and
    the group's size agree."""
    pod = mesh.axis_sizes().get("pod")
    if pod != n_clients:
        raise ValueError(f"the mesh's 'pod' axis has {pod} clients, "
                         f"n_clients is {n_clients}")
    clients = pod_group(mesh, group)
    C, rank, grp = n_clients, clients.rank, clients.group
    window = effective_window(cfg, shape)
    local_step = make_train_step(cfg, train, shape)

    def round_step(params: Params, batch: Dict, pi_matrix: torch.Tensor,
                   link_ok: torch.Tensor, *,
                   mark: Optional[Callable[[str], None]] = None):
        aggregation.calls["round_step"] += 1
        mark = mark or (lambda stage: None)
        layout, leaves = ParamLayout.of(params), tree_leaves(params)
        if len({x.dtype for x in leaves}) != 1:
            raise ValueError("the round step exchanges one flat buffer: "
                             "every param must have one dtype")
        params, metrics = local_step(params, batch)
        mark("local_step")
        with torch.no_grad():
            own = torch.cat([x.reshape(-1) for x in leaves])
            stack = exchange_models(own, layout, exchange_bits, grp)
            mark("exchange")

            tok = batch["tokens"][:probe_sequences, :probe_tokens]
            lbl = batch["labels"][:probe_sequences, :probe_tokens]
            losses = torch.stack(
                [_per_sequence_loss(layout.views(stack[m]), cfg, tok, lbl,
                                    window) for m in range(C)], dim=1)
            self_mask = torch.zeros(C, dtype=losses.dtype,
                                    device=losses.device)
            self_mask[rank] = 1e30          # exclude own model (Sec IV-B)
            losses = losses + self_mask[None, :]
            pi_row = pi_matrix[rank]
            pi_row = torch.where(pi_row > 0, pi_row, 1.0 / C)
            pi_star, _ = em.em_weights(pi_row / torch.sum(pi_row), losses,
                                       iters=em_iters)
            mark("em")

            w = pi_star * link_ok[rank].to(pi_star.dtype)
            total = torch.sum(w)
            w = torch.where(total > 0, w / torch.clamp(total, min=1e-30), w)
            mixed = weighted_agg(own, stack, w.float().contiguous(), alpha,
                                 any_ok=total > 0)
            for x, v in zip(leaves, tree_leaves(layout.views(mixed))):
                x.copy_(v)
            mark("mix")

            new_pi = aggregation.all_gather(pi_star.float()[None], grp)
            packed = torch.stack([torch.as_tensor(metrics[k]).float()
                                  .to(own.device) for k in ROUND_METRICS])
            packed = aggregation.all_reduce(packed, grp) / C
            mark("outputs")
        return params, new_pi, dict(zip(ROUND_METRICS, packed.unbind()))

    return round_step
