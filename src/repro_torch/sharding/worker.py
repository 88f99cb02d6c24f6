"""Rank bodies for :func:`repro_torch.sharding.spawn`.

    spawn(run_methods, D, backend, device, build, build_kw, methods)
    spawn(run_pod_mix, C, backend, device, cases, device)

:func:`run_methods` builds a simulation, runs methods on it and reports
what each run did. ``build(**build_kw)`` makes the rank's
:class:`~repro_torch.core.fedsim.FederatedSimulation` (the class itself
serves, with its constructor's arguments), so a test, a bench or
``chip_smoke.py`` sends its datasets or its scenario builder, and every
rank runs the same methods in the same order, as the sharded engine needs.
:func:`run_pod_mix` runs :func:`repro_torch.core.aggregation.pod_mix` with
each rank one client.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import aggregation
from repro_torch.kernels import em_posterior, weighted_agg


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
