"""Training entry point, the reference's ``repro.launch.train``. Two modes:
  - single-client LM training (the substrate any FL client runs):
    ``--arch smollm-135m --steps 200``;
  - the pFedWN LM rounds (``--clients N``): N clients with stacked
    params, E local SGD steps each, then the target's (client 0's) EM
    weights over its neighbours' losses on a probe batch and the Eq-1 mix
    under link erasures (K2, once per param leaf).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 50 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --clients 4 --rounds 5 --local-steps 10 --batch 4 --seq 256

Runs on the card unless ``--device cpu`` is given; ``--full`` takes the
published widths and depth (else ``reduced()``). On a card every layer's
attention runs K3's forward and its hand-written backward. Weights are
random, fp32 (single-client ``--dtype bfloat16`` for bf16, the
reference's default dtype), from a ``torch.Generator`` (seed 0) unless
injected; the batches are the reference's ``token_batch_stream`` draws, and
``single_client`` puts a stub prefix of zero embeddings before them for a
config with a stub frontend (qwen2-vl, musicgen), as the reference does;
``federated`` puts none, as the reference does not. The clients are
a Python loop: ``torch.func.vmap`` cannot pass through the ctypes
kernels. :func:`single_client` and :func:`federated` are what the CLI,
the tests and ``chip_smoke.py`` call.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ModelConfig, TrainConfig, get_config
from repro_torch.core import aggregation, em
from repro_torch.data import token_batch_stream
from repro_torch.device import disable_tf32, resolve_device
from repro_torch.launch.serve import DTYPES, stub_prefix
from repro_torch.models.model import init_params, loss_fn, unstack
from repro_torch.optim import make_optimizer, sgd_update

Params = Dict


def reduced_or_full(arch: str, full: bool) -> ModelConfig:
    cfg = get_config(arch)
    return cfg if full else cfg.reduced()


def _to_device(raw: Dict[str, np.ndarray], dev: torch.device) -> Dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_STACKED = ("dense_layers", "layers")   # (L, ...) layer groups


def _layered(params: Params) -> Params:
    """``params`` with each stacked layer group as a list of per-layer
    trees of views (``models.model.unstack``)."""
    return {k: unstack(v) if k in _STACKED else v for k, v in params.items()}


def value_and_grad(params: Params, cfg: ModelConfig, batch: Dict, *,
                   window: int = 0, remat: bool = False,
                   by_layer: bool = False, objective: Callable = loss_fn):
    """(loss, metrics, grads) of :func:`loss_fn` at ``params``; the grads
    are a tree of ``params``' structure, or with ``by_layer`` of
    ``_layered(params)``'s: each stacked layer group's grads as a list of
    per-layer trees, as autograd makes them layer by layer. Through the
    stack's ``unbind`` autograd holds every layer's gradient to the end of
    the backward and then stacks them into a second copy (16 GiB more for
    falcon-mamba-7b's stacked in_proj, past 80 GB at full width). The
    values are the same. A leaf the loss does not reach (an empty layer
    group's ``(0, ...)`` leaves: a MoE config with ``n_layers ==
    first_k_dense``) gets zeros of its shape and dtype, as
    ``jax.value_and_grad`` gives them. ``objective`` takes ``loss_fn``'s
    arguments and returns what it returns (the sharded steps pass a rank's
    share of the loss, ``sharding/tensor_parallel.py``)."""
    leaves, spec = tree_flatten(_layered(params) if by_layer else params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, metrics = objective(tree_unflatten(leaves, spec), cfg, batch,
                              window=window, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, tree_unflatten(list(grads), spec)


_SGD_CHUNK = 1 << 27          # elements of one slice of an SGD update


@torch.no_grad()
def _sgd_in_param_dtype_(params: Params, grads: Params, lr: float) -> None:
    """p ← p − lr·g leaf by leaf, in place, computed as the reference's
    ``make_train_step`` computes it (steps.py:112-115): lr rounded to the
    param's dtype, g cast to it, their product rounded, then subtracted
    and rounded. In fp32 these are the bits of ``optim.sgd_update`` (the
    reference's ``optim/sgd.py``: lr·g in fp32, subtracted, rounded once);
    in bf16 lr 3e-3 rounds to 0.0029907 and the two rules part. A leaf of
    more than ``_SGD_CHUNK`` elements is updated in slices along its first
    axis, the same bits (the rule is elementwise) with a bounded lr·g
    temporary: deepseek-v3's expert leaves are 7 GiB in bf16, and a 7 GiB
    temporary beside 58 GiB of weights and gradients need not find room."""
    lrs: Dict[tuple, torch.Tensor] = {}
    for p, g in zip(tree_flatten(params)[0], tree_flatten(grads)[0]):
        key = (p.dtype, p.device)
        if key not in lrs:
            lrs[key] = torch.tensor(lr, dtype=p.dtype, device=p.device)
        rows = (max(1, _SGD_CHUNK * p.shape[0] // p.numel())
                if p.dim() and p.numel() > _SGD_CHUNK else None)
        for pc, gc in (zip(p.split(rows), g.split(rows)) if rows
                       else ((p, g),)):
            pc.sub_(lrs[key] * gc.to(p.dtype))


def single_client(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
                  lr: float = 3e-3, optimizer: str = "sgd",
                  ckpt: Optional[str] = None,
                  params: Optional[Params] = None,
                  stub_embeds: Optional[torch.Tensor] = None,
                  remat: bool = False,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda",
                  log: Callable[[str], None] = print) -> Dict:
    """``steps`` optimizer steps on ``token_batch_stream(0)``, printing the
    reference's schedule (every ``steps // 10`` and the last). ``params``
    (on the device) default to ``init_params`` in ``dtype`` from seed 0;
    given ones are copied first and left as they are. SGD updates its own
    params in place, each stacked layer's slice from that layer's
    gradient (:func:`_sgd_in_param_dtype_` over
    ``value_and_grad(by_layer=True)``, the rule of ``launch.steps``'
    ``make_train_step``: in fp32 the bits of ``sgd_update`` on the stacked
    gradients), so a step holds the weights, one set of gradients
    and the activations, and neither a second set of weights nor a
    stacked copy of the gradients.
    ``remat`` recomputes each layer in the backward (the reference's
    ``loss_fn(remat=)``; its trainer passes False): a full-width 7 B
    model's B 8 × S 256 step fits one 80 GB card only with it. Returns
    ``{"losses": [float] a step, "params", "timings"}``: ms per step and
    tokens/s over the steps after the first (host clock, ending in a
    sync), and the first step's ms. A config with a stub frontend gets
    ``stub_embeds`` (batch, n_stub, D) before every batch, by default
    :func:`~repro_torch.launch.serve.stub_prefix`'s zeros, as the
    reference's trainer feeds; at depth a zero prefix overflows the
    backward (each layer's RMSNorm of a zero row scales its gradient by
    1/sqrt(eps): ROADMAP Queue C, C6), so a caller that wants a finite
    run at full depth passes nonzero embeddings."""
    dev = resolve_device(device)
    train = TrainConfig(lr=lr, optimizer=optimizer)
    if params is None:
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(train.seed), dev,
            dtype)
    else:
        params = tree_map(torch.clone, params)
    opt_init, opt_update = make_optimizer(train.optimizer)
    opt_state = opt_init(params)
    stream = token_batch_stream(0, batch=batch, seq_len=seq, vocab=cfg.vocab)
    stub = stub_prefix(cfg, batch, dev) if stub_embeds is None \
        else stub_embeds
    losses: List[torch.Tensor] = []
    _sync(dev)
    t0 = time.perf_counter()
    t_first = t0
    for i, raw in zip(range(steps), stream):
        inputs = _to_device(raw, dev)
        if stub is not None:
            inputs["stub_embeds"] = stub
        if train.optimizer == "sgd":  # in place, a layer's slice at a time
            loss, _, grads = value_and_grad(params, cfg, inputs, remat=remat,
                                            by_layer=True)
            _sgd_in_param_dtype_(_layered(params), grads, train.lr)
        else:
            loss, _, grads = value_and_grad(params, cfg, inputs, remat=remat)
            params, opt_state = opt_update(params, grads, opt_state,
                                           train.lr)
        del grads                     # before the next step's backward
        losses.append(loss)
        if i == 0:
            _sync(dev)
            t_first = time.perf_counter()
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            log(f"step {i:5d} loss {float(loss):.4f} "
                f"({(time.perf_counter() - t0):.1f}s)")
    _sync(dev)
    t_end = time.perf_counter()
    if ckpt:
        save_checkpoint(ckpt, params, steps)
        log(f"saved {ckpt}")
    rest = max(steps - 1, 1)
    ms = (t_end - t_first) * 1e3 / rest
    return {"losses": torch.stack(losses).cpu().tolist() if losses else [],
            "params": params,
            "timings": {"first_step_ms": (t_first - t0) * 1e3,
                        "ms_per_step": ms,
                        "tokens_per_s": batch * seq / (ms / 1e3)}}


def _client(params: Params, c: int) -> Params:
    return tree_map(lambda p: p[c], params)


def federated(cfg: ModelConfig, *, clients: int, rounds: int,
              local_steps: int, batch: int, seq: int, lr: float = 3e-3,
              alpha: float = 0.5, p_err: Optional[Sequence[float]] = None,
              params: Optional[Params] = None,
              link_masks: Optional[np.ndarray] = None,
              gen: Optional[torch.Generator] = None,
              device: str | torch.device = "cuda",
              log: Callable[[str], None] = print) -> Dict:
    """pFedWN rounds over ``clients`` simulated LM clients, client c on
    ``token_batch_stream(100 + 31c)``. Each round: ``local_steps`` plain
    SGD steps (w − lr·g) a client; client 0's π* = ``em_weights`` (3
    iterations) from uniform π over its C − 1 neighbours' mean losses on a
    probe batch; links ``uniform >= p_err[1:]`` (default p_err 0.05 each);
    the Eq-1 mix of client 0 with the neighbours, written into row 0; the
    mixed model's loss on the next batch of stream 0. π starts uniform
    every round, as in the reference.

    ``params``: a stacked tree with a leading C axis (default: C draws of
    ``init_params`` from ``gen``); it is updated in place. ``link_masks``:
    (rounds, C − 1) bool to replay, else drawn from ``gen`` (seed 0 when
    None). Returns ``{"target_loss", "pi", "links"}`` a round (floats,
    (C − 1,) numpy arrays), ``"params"`` and ``"round_ms"`` (host clock,
    ending in a sync)."""
    dev = resolve_device(device)
    C = clients
    if C < 2:
        raise ValueError(f"federated training needs >= 2 clients, got {C}")
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        inits = [init_params(cfg, gen, dev) for _ in range(C)]
        params = tree_map(lambda *xs: torch.stack(xs), *inits)
    streams = [token_batch_stream(100 + 31 * c, batch=batch, seq_len=seq,
                                  vocab=cfg.vocab) for c in range(C)]
    pi = torch.full((C - 1,), 1.0 / (C - 1), device=dev)
    p_err = (torch.tensor(list(p_err)[:C], dtype=torch.float32, device=dev)
             if p_err else torch.full((C,), 0.05, device=dev))
    hist: Dict[str, List] = {"target_loss": [], "pi": [], "links": [],
                             "round_ms": []}
    for rnd in range(rounds):
        _sync(dev)
        t0 = time.perf_counter()
        batches = [[next(streams[c]) for _ in range(local_steps)]
                   for c in range(C)]
        for c in range(C):
            p = _client(params, c)
            for raw in batches[c]:
                _, _, g = value_and_grad(p, cfg, _to_device(raw, dev))
                p = sgd_update(p, g, lr)
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src),
                         _client(params, c), p)

        # target client 0: EM weights over its neighbours, Eq (1) mix
        probe = _to_device(next(streams[0]), dev)
        with torch.no_grad():
            losses = torch.stack([loss_fn(_client(params, m), cfg, probe)[0]
                                  for m in range(1, C)])[None, :]
            pi_star, _ = em.em_weights(pi / torch.sum(pi), losses, iters=3)
            if link_masks is not None:
                link_ok = torch.as_tensor(np.asarray(link_masks[rnd]),
                                          device=dev)
            else:
                link_ok = torch.rand((C - 1,), generator=gen,
                                     device=dev) >= p_err[1:]
            neighbors = tree_map(lambda x: x[1:], params)
            mixed = aggregation.mix_params_with_erasures(
                _client(params, 0), neighbors, pi_star, alpha, link_ok)
            tree_map(lambda dst, src: dst.copy_(src), _client(params, 0),
                     mixed)
            l0, _ = loss_fn(mixed, cfg, _to_device(next(streams[0]), dev))
        _sync(dev)
        hist["round_ms"].append((time.perf_counter() - t0) * 1e3)
        pi_np = pi_star.cpu().numpy()
        links = link_ok.cpu().numpy().astype(bool)
        hist["target_loss"].append(float(l0))
        hist["pi"].append(pi_np)
        hist["links"].append(links)
        log(f"round {rnd}: target loss {float(l0):.4f} "
            f"pi={np.round(pi_np, 3)} links={links.astype(int)}")
    hist["params"] = params
    return hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced smoke size)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward")
    # federated mode
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--p-err", type=float, nargs="*", default=None)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the params' dtype in single-client training (the "
                    "reference's launch/train.py runs fp32; its init_params "
                    "defaults to bf16); the federated rounds are fp32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.clients and args.dtype != "float32":
        ap.error("--clients runs fp32 rounds only; drop --dtype")

    dev = resolve_device(args.device)
    disable_tf32()
    cfg = reduced_or_full(args.arch, args.full)
    dtype = DTYPES[args.dtype]
    if args.clients:
        federated(cfg, clients=args.clients, rounds=args.rounds,
                  local_steps=args.local_steps, batch=args.batch,
                  seq=args.seq, lr=args.lr, alpha=args.alpha,
                  p_err=args.p_err, device=dev)
    else:
        single_client(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      lr=args.lr, optimizer=args.optimizer, ckpt=args.ckpt,
                      remat=args.remat, dtype=dtype, device=dev)


if __name__ == "__main__":
    main()
