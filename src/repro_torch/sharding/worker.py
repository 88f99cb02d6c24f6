"""Rank bodies for :func:`repro_torch.sharding.spawn`.

    spawn(run_methods, D, backend, device, build, build_kw, methods)
    spawn(run_pod_mix, C, backend, device, cases, device)
    spawn(run_round_step, C, backend, device, cases, device)
    spawn(run_placed, D * T, backend, device, cases, device)

:func:`run_methods` builds a simulation, runs methods on it and reports
what each run did. ``build(**build_kw)`` makes the rank's
:class:`~repro_torch.core.fedsim.FederatedSimulation` (the class itself
serves, with its constructor's arguments), so a test, a bench or
``chip_smoke.py`` sends its datasets or its scenario builder, and every
rank runs the same methods in the same order, as the sharded engine needs.
:func:`run_pod_mix` runs :func:`repro_torch.core.aggregation.pod_mix` with
each rank one client; :func:`run_round_step` runs rounds of
``launch/steps.py::make_pfedwn_round_step`` likewise; :func:`run_placed`
serves and trains one client sharded over a ``("data", "model")`` mesh of
all the ranks (``sharding/place.py``, ``sharding/tensor_parallel.py``).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import aggregation
from repro_torch.kernels import em_posterior, flash_attention, weighted_agg
from repro_torch.roofline.collectives import CollectiveCounter


def count_syncs(fn: Callable[[], Any]):
    """(``fn()``, the host syncs it made on the current card, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``'s warnings)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def run_methods(build: Callable, build_kw: Dict[str, Any],
                methods: Sequence[str],
                run_kw: Optional[Dict[str, Any]] = None, repeat: int = 1,
                syncs: bool = False,
                flops: bool = False) -> List[Dict[str, Any]]:
    """Run each of ``methods`` ``repeat`` times on ``build(**build_kw)``
    (``run_kw`` passed to every run) and report the last run of each: its
    history, the rank's final params slab and π, ``last_run_stats``, the
    slab's offset, the recorder's events, the K1 and K2 launches, the
    aggregation wrappers' calls and collectives, with ``syncs`` on a card
    its host syncs, and with ``flops`` the FLOPs ``FlopCounterMode`` counts
    over it (each None when not asked for)."""
    sim = build(**build_kw)
    out = []
    for method in methods:
        for i in range(repeat):
            aggregation.reset_counts()
            em_posterior.launches = weighted_agg.launches = 0
            n_events = len(sim.recorder.events)
            last = i == repeat - 1
            counter = FlopCounterMode(display=False) if flops and last \
                else None
            with counter or contextlib.nullcontext():
                if syncs and last and sim.device.type == "cuda":
                    hist, n_syncs = count_syncs(
                        lambda: sim.run(method, **(run_kw or {})))
                else:
                    hist, n_syncs = sim.run(method, **(run_kw or {})), None
        out.append({
            "method": method, "history": hist,
            "params": sim.last_state["params"].cpu(),
            "pi": sim.last_state["pi"].cpu(),
            "stats": dict(sim.last_run_stats),
            "offset": sim._shard.offset if sim._shard is not None else 0,
            "events": list(sim.recorder.events[n_events:]),
            "k1": em_posterior.launches, "k2": weighted_agg.launches,
            "calls": dict(aggregation.calls),
            "collectives": aggregation.collectives, "syncs": n_syncs,
            "flops": counter.get_total_flops() if counter else None})
    return out


def run_pod_mix(cases, device: str) -> List[Dict[str, Any]]:
    """Rank body: for each case ``(params, pi_matrix, alpha, link_ok)``,
    whose ``params`` is a tree of numpy arrays with a leading client axis
    of size C, :func:`~repro_torch.core.aggregation.pod_mix` this rank's
    client (its rows, the axis kept at size 1, as the reference's pod
    holds them) on ``device``. Returns each case's mixed tree (numpy), the
    collectives it made and its K2 launches."""
    rank = torch.distributed.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for params, pi_matrix, alpha, link_ok in cases:
        mine = {k: torch.as_tensor(v[rank:rank + 1], device=dev)
                for k, v in params.items()}
        aggregation.reset_counts()
        weighted_agg.launches = 0
        mixed = aggregation.pod_mix(
            mine, torch.as_tensor(pi_matrix, device=dev), alpha,
            None if link_ok is None else torch.as_tensor(link_ok,
                                                         device=dev))
        out.append({"mixed": {k: v.cpu().numpy() for k, v in mixed.items()},
                    "collectives": aggregation.collectives,
                    "k2": weighted_agg.launches})
    return out


def _rank_params(case, rank: int, dev: torch.device):
    """This rank's client params as one flat buffer on ``dev`` and its
    layout: row ``rank`` of the case's stacked numpy tree (bf16 through
    the bridge), cast to ``dtype`` when the case gives one; or, with
    ``seed``, the ``rank``-th of C ``init_params`` draws in ``dtype`` from
    one generator seeded with it, on ``dev``."""
    from torch.utils._pytree import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.utils.bridge import (ParamLayout, from_jax_lm_params,
                                          tree_leaves)
    cfg = case["cfg"]
    if case.get("params") is not None:
        mine = from_jax_lm_params(tree_map(lambda v: v[rank],
                                           case["params"]), cfg, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(case["seed"])
        for c in range(case["kw"]["n_clients"]):
            drawn = init_params(cfg, gen, dev, case["dtype"])
            if c == rank:
                mine = drawn
            del drawn
    layout = ParamLayout.of(mine)
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(mine)])
    flat = flat.to(case.get("dtype", flat.dtype))
    del mine
    return flat, layout


def _stamp(cuda: bool):
    """A point in time: a recorded CUDA event on a card, else the host
    clock."""
    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3


def _k3_counts() -> Dict[str, Any]:
    return {"forward": flash_attention.launches,
            "positions": flash_attention.position_launches,
            "backward_positions": flash_attention.position_backward_launches,
            "bf16_forward": flash_attention.bf16_launches,
            "backward": dict(flash_attention.backward_launches),
            "bf16_backward": dict(flash_attention.bf16_backward_launches)}


def run_round_step(cases, device: str) -> List[Dict[str, Any]]:
    """Rank body: for each case, rounds of
    :func:`~repro_torch.launch.steps.make_pfedwn_round_step` with this rank
    client ``rank`` on ``device``.

    A case is a dict: ``cfg``, ``train``, ``shape``, ``mesh``, ``kw``
    (``make_pfedwn_round_step``'s keyword arguments, ``n_clients`` among
    them, without ``exchange_bits``); ``params`` (a stacked numpy tree
    (C, ...)) or ``seed`` and ``dtype`` (:func:`_rank_params`); ``batch``
    ({name: (C, B, S) numpy}); ``pi_matrix`` (C, C), the first round's
    (each later round takes the last ``new_pi``), and ``link_ok`` (C, C);
    ``rounds``, the exchange bits of each round; ``keep`` (return the
    final params); ``check`` (return each round's post-step params and
    the stack :func:`~repro_torch.launch.steps.exchange_models` makes of
    them).
    Params and stacks come back as CPU tensors in their dtype.

    Returns a dict a case: ``rounds``, one dict a round (``new_pi``,
    ``metrics``, ``collectives``, ``collective_bytes`` (its bytes by
    kind, :mod:`repro_torch.roofline.collectives`), ``calls``, ``k2``,
    ``k2_bf16``, ``k3``
    (the forward's and each backward kernel's launches, all and bf16),
    ``ms`` (host clock around the round, ending in a sync) and ``stage_ms``
    (the stages' device time between CUDA events on a card, host clock on
    the CPU), with ``check`` also ``post_step`` and ``stack``); ``params``
    (with ``keep``) and ``peak_gib`` (the rank's peak device
    memory on a card, else None)."""
    from repro_torch.launch.mesh import pod_group
    from repro_torch.launch.steps import exchange_models, \
        make_pfedwn_round_step
    from repro_torch.device import disable_tf32
    rank = torch.distributed.get_rank()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
        disable_tf32()
    out = []
    for case in cases:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        flat, layout = _rank_params(case, rank, dev)
        params = layout.views(flat)
        batch = {k: torch.as_tensor(v[rank]).to(dev)
                 for k, v in case["batch"].items()}
        pi = torch.as_tensor(case["pi_matrix"], dtype=torch.float32,
                             device=dev)
        ok = torch.as_tensor(case["link_ok"], device=dev)
        steps = {bits: make_pfedwn_round_step(
            case["cfg"], case["train"], case["shape"], case["mesh"],
            exchange_bits=bits, **case["kw"])
            for bits in sorted(set(case["rounds"]))}
        rounds = []
        for bits in case["rounds"]:
            marks, snap = [], {}

            def mark(stage):
                if stage == "local_step" and case.get("check"):
                    snap["post"] = flat.clone()
                marks.append((stage, _stamp(cuda)))

            aggregation.reset_counts()
            flash_attention.reset_counts()
            weighted_agg.launches = weighted_agg.bf16_launches = 0
            if cuda:
                torch.cuda.synchronize(dev)
            marks.append(("start", _stamp(cuda)))
            t0 = time.perf_counter()
            with CollectiveCounter() as coll:
                params, new_pi, metrics = steps[bits](params, batch, pi, ok,
                                                      mark=mark)
            if cuda:
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            stage_ms = {b[0]: _ms(a[1], b[1], cuda)
                        for a, b in zip(marks, marks[1:])}
            pi = new_pi
            r = {"exchange_bits": bits, "new_pi": new_pi.cpu().numpy(),
                 "metrics": {k: float(v) for k, v in metrics.items()},
                 "collectives": aggregation.collectives,
                 "collective_bytes": coll.summary(),
                 "calls": dict(aggregation.calls),
                 "k2": weighted_agg.launches,
                 "k2_bf16": weighted_agg.bf16_launches, "k3": _k3_counts(),
                 "ms": ms, "stage_ms": stage_ms}
            if case.get("check"):
                r["post_step"] = layout.views(snap["post"].cpu())
                r["stack"] = exchange_models(
                    snap["post"], layout, bits,
                    pod_group(case["mesh"]).group).cpu()
            rounds.append(r)
        out.append({
            "rounds": rounds,
            "params": layout.views(flat.cpu()) if case.get("keep") else None,
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if cuda else None)})
        del flat, params, batch, steps
    return out


def _tree_bytes(tree) -> int:
    from repro_torch.utils.bridge import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def serve_placed(cfg, blocks, prompts: torch.Tensor, gen: int, pl,
                 window: int = 0, timed: bool = False,
                 routing: Optional[list] = None,
                 stub_embeds: Optional[torch.Tensor] = None
                 ) -> Dict[str, Any]:
    """``launch/serve.py::serve`` over placement ``pl``: the sharded prefill
    of ``prompts`` (B, P), whole on every rank, after ``stub_embeds`` (B,
    n_stub, D), whole too (default ``launch/serve.py::stub_prefix``'s
    zeros; n_stub = 0 for a config without a stub frontend), into this
    rank's blocks of a zero cache of n_stub + P + gen positions, then
    greedy decode from position n_stub + P (ROADMAP C5: the reference's
    P + gen drops the prefill's cache): ``gen`` tokens, the first from the
    prefill's logits. Returns ``tokens``
    (B, gen), ``logits`` (gen, B, V), ``cache`` (this rank's blocks after
    the last step) and ``ms``: the host ms of the prefill and of each
    decode step (each ending in a sync), and of their collectives'
    (:data:`~repro_torch.sharding.place.comm`). ``timed``: the
    collectives between device syncs (:func:`~repro_torch.sharding.place.
    timed`), so that their seconds are their own. ``routing``: a list to
    which an MoE config's calls append their ``routing_stats`` (the
    plans' ``routing``)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.serve import stub_prefix
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import place
    B, P = prompts.shape
    dev = prompts.device
    if stub_embeds is None:
        stub_embeds = stub_prefix(cfg, B, dev)
    inputs = {"tokens": prompts}
    if cfg.n_stub_tokens:
        inputs["stub_embeds"] = stub_embeds
    start = P + (stub_embeds.shape[1] if cfg.n_stub_tokens
                 else 0)                  # the first decode position
    shape = ShapeConfig("serve", start + gen, B, "decode")
    prefill = steps.make_prefill_step(cfg, shape, placement=pl)
    decode = steps.make_decode_step(cfg, shape, placement=pl)
    if routing is not None and cfg.moe:
        prefill.plan.routing = decode.plan.routing = routing
    dtype = blocks["embed"].dtype
    t0, comm0 = time.perf_counter(), place.comm["seconds"]
    with place.timed() if timed else contextlib.nullcontext():
        logits, pcache = prefill(blocks, place.batch_blocks(inputs, pl))
    _sync_dev(dev)
    ms = {"prefill": (time.perf_counter() - t0) * 1e3,
          "prefill_comm": (place.comm["seconds"] - comm0) * 1e3,
          "decode": []}
    cache = place.cache_zeros(model_lib.init_cache(
        cfg, B, start + gen, window=window, device="meta", dtype=dtype), pl,
        dev)
    for group, entries in cache.items():
        for name, c in entries.items():
            pc = pcache[group][name]
            if pc.shape[2] > c.shape[2]:
                raise NotImplementedError(
                    f"{cfg.name}: the prefill holds {pc.shape[2]} positions, "
                    f"the decode cache {c.shape[2]}")
            c[:, :, :pc.shape[2]] = pc
    del pcache
    tok = torch.argmax(logits, dim=-1)
    tokens, all_logits = [tok], [logits]
    ms["decode_comm"] = []
    with place.timed() if timed else contextlib.nullcontext():
        for i in range(gen - 1):
            t0, comm0 = time.perf_counter(), place.comm["seconds"]
            logits, cache = decode(blocks, cache, place.batch_blocks(
                {"token": tok[:, None], "pos": start + i}, pl))
            tok = torch.argmax(logits, dim=-1)
            _sync_dev(dev)
            ms["decode"].append((time.perf_counter() - t0) * 1e3)
            ms["decode_comm"].append((place.comm["seconds"] - comm0) * 1e3)
            tokens.append(tok)
            all_logits.append(logits)
    return {"tokens": torch.stack(tokens, dim=1),
            "logits": torch.stack(all_logits), "ms": ms, "cache": cache}


def _sync_dev(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _routing_summary(calls) -> Dict[str, float]:
    """``routing_stats`` of a list of MoE calls summed: dropped pairs,
    pairs, the smallest top-k gap."""
    return {"dropped": int(sum(int(c[0]) for c in calls)),
            "pairs": int(sum(c[1] for c in calls)),
            "min_gap": min((float(c[2]) for c in calls),
                           default=float("inf"))}


def placed_moe_layer(case, pl, dev: torch.device) -> Dict[str, Any]:
    """One MoE layer of ``case["cfg"]`` on placement ``pl``, forward and
    backward, as :class:`~repro_torch.sharding.tensor_parallel.MoEPlan`
    runs it in a train step: ``case["moe_layer"]`` holds the layer's
    numpy params in the reference's layout (``router``, ``w_gate``,
    ``w_up``, ``w_down``[, ``shared``]), ``x`` (B, S, D) its normed input
    and ``dy``, ``daux`` the cotangents of its output and aux loss. This
    rank takes its blocks and its rows, and its gradient is that of
    Σ dy·out + daux·aux share. Returns the output, the input's gradient
    (every data rank's rows, in order), the aux share and each param's
    gradient gathered whole."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.sharding import place
    from repro_torch.sharding.tensor_parallel import MoEPlan, _zip_map
    x = torch.as_tensor(case["x"]).to(dev)
    B, S, _ = x.shape
    plan = MoEPlan(case["cfg"], pl, ShapeConfig("t", S, B, "train"))
    uses = plan.layer_uses["moe"]
    forms = _zip_map(lambda w, u: plan._form(place.shard_leaf(
        torch.as_tensor(w).to(dev), u.spec, pl), u).detach()
        .requires_grad_(), case["moe_layer"], uses)
    pairs: List = []
    _zip_map(lambda f, u: pairs.append((u, f)), forms, uses)
    rows, dy = (place.batch_blocks({"tokens": torch.as_tensor(t).to(dev)},
                                   pl)["tokens"] for t in (x, case["dy"]))
    rows = rows.detach().requires_grad_()
    plan.routing = []
    out, aux = plan._moe(forms, rows, aux=True)
    grads = torch.autograd.grad((out * dy).sum() + case["daux"] * aux,
                                [rows] + [f for _, f in pairs])
    reduced = iter(plan.reduce_pairs([(u, g) for (u, _), g in
                                      zip(pairs, grads[1:])]))
    return {"out": plan.rows_whole(out.detach()).cpu(),
            "dx": plan.rows_whole(grads[0]).cpu(),
            "aux": float(aux.detach()),
            "routing": _routing_summary(plan.routing),
            "grads": _zip_map(lambda f, u: place.gather_leaf(
                next(reduced), u.spec, pl).cpu(), forms, uses),
            "e_range": plan.e_range}


def run_placed(cases, device: str) -> List[Dict[str, Any]]:
    """Rank body: for each case, one client of a dense or MoE config
    sharded over ``make_placement(case["mesh"])`` (every rank of the
    started group): this rank's blocks of the params, a greedy serve on
    them (:func:`serve_placed`), then ``steps`` SGD steps of
    ``make_train_step(..., placement=...)``; a case with ``moe_layer``
    runs that one MoE layer instead (:func:`placed_moe_layer`).

    A case is a dict: ``cfg``, ``mesh``; ``params`` (a numpy tree in the
    reference's layout) or ``seed`` (``init_params`` in fp32 from a
    generator on ``device`` seeded with it); ``batch`` ({"tokens",
    "labels"}: (B, S) numpy; a stub frontend's ``stub_embeds`` (B, n_stub,
    D) and explicit ``positions`` (S_eff,) or (S_eff, 3) pass through to
    the steps), ``steps``, ``lr``; ``prompts`` ((B, P) numpy), ``gen`` and
    ``stub_embeds`` (the prompts' prefix, (B, n_stub, D) numpy; default
    the zeros of :func:`serve_placed`); ``keep`` (rank 0 returns the
    params gathered whole after the steps); ``blocks`` (return this rank's
    blocks); ``timed`` (bracket each collective of the prefill and the
    steps by device syncs, so that the collectives' seconds are their
    own).

    Returns a dict a case: ``serve`` (:func:`serve_placed`'s, on the CPU),
    ``metrics`` (a dict a step), ``params`` and ``blocks`` (when asked
    for, after the steps; with ``blocks`` also ``cache``, the serve's
    cache blocks after its last step), ``plan`` (the rank's heads, KV
    heads, the split half-blocks and, for MoE, its ``experts`` range),
    ``routing`` (MoE: the serve's and the steps' dropped pairs, pairs and
    smallest top-k gap on this rank), ``k3`` and ``k3_shapes`` (the train
    steps' launches, those by explicit positions among them, and their
    shapes; ``k3_prefill`` the prefill's shapes and
    ``k3_prefill_positions`` its launches by positions),
    ``param_bytes`` (the rank's blocks) and ``model_bytes`` (the whole
    client's), ``ms`` (each step's host ms ending in a sync, and the
    serve's), ``comm_s`` (the steps' and the prefill's collective seconds),
    ``peak_gib`` (the rank's peak device memory on a card, else None),
    ``clock`` (``time.time()`` at the body's start, after the placement,
    the serve and the steps)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.device import disable_tf32
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    from repro_torch.sharding import place
    from repro_torch.utils.bridge import from_jax_lm_params
    clock = {"start": time.time()}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
        disable_tf32()
    out = []
    for case in cases:
        cfg = case["cfg"]
        pl = place.make_placement(case["mesh"])
        if case.get("moe_layer") is not None:
            out.append(placed_moe_layer(case, pl, dev))
            continue
        clock["placed"] = time.time()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        if case.get("params") is not None:
            whole = from_jax_lm_params(case["params"], cfg, dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(case["seed"])
            whole = init_params(cfg, gen, dev, torch.float32)
        model_bytes = _tree_bytes(whole)
        blocks = place.param_blocks(whole, pl)
        del whole
        res: Dict[str, Any] = {"model_bytes": model_bytes,
                               "param_bytes": _tree_bytes(blocks)}
        prompts = torch.as_tensor(case["prompts"]).to(dev)
        flash_attention.reset_counts()
        place.reset_comm()
        routing: Dict[str, list] = {"serve": [], "steps": []}
        stub = case.get("stub_embeds")
        served = serve_placed(cfg, blocks, prompts, case["gen"], pl,
                              timed=case.get("timed", False),
                              routing=routing["serve"],
                              stub_embeds=None if stub is None else
                              torch.as_tensor(stub).to(dev))
        res["comm_s"] = {"serve": place.comm["seconds"]}
        clock["served"] = time.time()
        res["k3_prefill"] = dict(flash_attention.launch_shapes)
        res["k3_prefill_positions"] = flash_attention.position_launches
        cache = served.pop("cache")
        res["serve"] = {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in served.items()}
        if case.get("blocks"):
            res["cache"] = _cpu(cache)
        del cache
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in case["batch"].items()}
        B, S = batch["tokens"].shape
        step = steps.make_train_step(
            cfg, TrainConfig(lr=case["lr"], remat=False),
            ShapeConfig("train", S, B, "train"), placement=pl)
        res["plan"] = {"heads": step.plan.heads,
                       "kv_heads": step.plan.kv_heads,
                       "attn_split": step.plan.attn_split,
                       "mlp_split": step.plan.mlp_split,
                       "coords": pl.coords}
        if cfg.moe:
            res["plan"]["experts"] = step.plan.e_range
            step.plan.routing = routing["steps"]
        mine = place.batch_blocks(batch, pl)
        flash_attention.reset_counts()
        place.reset_comm()
        res["metrics"], res["ms"] = [], {"steps": [], "serve": served["ms"]}
        with place.timed() if case.get("timed") else \
                contextlib.nullcontext():
            for _ in range(case["steps"]):
                _sync_dev(dev)
                t0 = time.perf_counter()
                blocks, metrics = step(blocks, mine)
                _sync_dev(dev)
                res["ms"]["steps"].append((time.perf_counter() - t0) * 1e3)
                res["metrics"].append({k: float(v)
                                       for k, v in metrics.items()})
        res["comm_s"]["steps"] = place.comm["seconds"]
        if cfg.moe:
            res["routing"] = {k: _routing_summary(v)
                              for k, v in routing.items()}
        clock["trained"] = time.time()
        res["clock"] = dict(clock)
        res["k3"] = _k3_counts()
        res["k3_shapes"] = {"forward": dict(flash_attention.launch_shapes),
                            "backward": dict(flash_attention.backward_shapes)}
        if case.get("blocks"):
            res["blocks"] = _cpu(blocks)
        if case.get("keep"):              # gathered on every rank
            whole = place.unshard_tree(blocks, step.plan.specs, pl)
            res["params"] = _cpu(whole) if pl.rank == 0 else None
            del whole
        res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if cuda else None)
        out.append(res)
        del blocks, mine, batch, step
    return out


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.cpu()
