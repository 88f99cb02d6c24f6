"""Round-block invariants of the port's fused and sharded engines, checked
by running them: the port, by intent, of the reference's
``repro.lint.hlo``.

    python -m repro_torch.lint.blocks [--engine fused|sharded|both]
        [--devices D] [--device cpu|cuda] [--methods a,b]
        [--sim MODULE:FUNCTION]

It builds the reference's tiny simulation (``repro.lint.hlo._build_sim``:
4 clients, the last not taking part, 3 rounds in blocks of 1 and 2) and
runs each method once to warm up and once under watch, on the fused engine
in this process and on the sharded engine in D ranks started by
:func:`repro_torch.sharding.spawn` (gloo on the CPU; on a card nccl when
every rank has one, else gloo). Each watched run must hold:

- model-sized collectives a round (``client_weighted_mean`` and
  ``gather_clients``): local 0, fedavg 1, fedprox 2, perfedavg 1,
  fedamp 1, pfedwn 1 on the sharded engine, none on the fused one;
- none of them inside the SGD loop (``FederatedSimulation._sgd``) or the
  EM loop (``em_refine_loop``): collectives ride the round, never an inner
  loop;
- one small exchange (``exchange_block``) a block on the sharded engine;
- on a card: K1 ``em_iters`` and K2 1 launches a round a rank on pfedwn,
  0 elsewhere, and one host sync a block
  (``torch.cuda.set_sync_debug_mode("warn")``) where the collectives run
  on the card (fused, or nccl; gloo's stage through the host, so its
  count is printed, not checked);
- no float64 tensor made (a ``TorchDispatchMode`` sees every op);
- nonzero FLOPs (``torch.utils.flop_counter.FlopCounterMode``).

``--sim MODULE:FUNCTION`` checks the simulation ``FUNCTION(engine,
devices, device)`` builds instead of the tiny one. The reference's
"donated carry" and "rounds scanned inside one executable" checks have no
eager counterpart: the port's block is a Python loop of device work, so
there is no executable to inspect. Exit codes: 0 clean, 1 violations, 2
usage.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import aggregation, fedsim
from repro_torch.kernels import em_posterior, weighted_agg
from repro_torch.sharding import default_backend, spawn
from repro_torch.sharding.worker import count_syncs

# model-sized collectives a round of each method on the sharded engine
PER_ROUND = {"local": 0, "fedavg": 1, "fedprox": 2, "perfedavg": 1,
             "fedamp": 1, "pfedwn": 1}
_MODEL_SIZED = ("client_weighted_mean", "gather_clients")
N_CLIENTS = 4


def build_sim(engine: str, devices: int, device: str,
              cls=fedsim.FederatedSimulation):
    """The reference's tiny lint simulation on ``engine``, as ``cls``."""
    from repro_torch.configs import CNNConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)
    n = N_CLIENTS
    base = synthetic_image_dataset(0, 600, image_size=8, n_classes=4)
    parts = dirichlet_partition(base.y, n, alpha=0.3, seed=0)
    train = make_client_datasets(
        base, [train_test_split(p, seed=1)[0] for p in parts])
    test = make_client_datasets(
        base, [train_test_split(p, seed=1)[1] for p in parts])
    pm = np.array([True] * (n - 1) + [False])
    p_err = np.linspace(0.0, 0.2, n).astype(np.float32)
    sharded = engine == "sharded"
    cfg = fedsim.FedSimConfig(
        rounds=3, batch_size=16, em_iters=2, em_subset=64, adapt_subset=32,
        eval_every=2, taps=True, sharded=sharded,
        shard_devices=devices if sharded else None)
    return cls(CNNConfig(image_size=8, widths=(4,), hidden=16, n_classes=4),
               train, test, pm, p_err, cfg, device=device)


class _Float64Probe(TorchDispatchMode):
    """Counts the ops that make a float64 tensor."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in tree_leaves(out)):
            self.ops.append(str(func))
        return out


class _LoopProbe:
    """Counts the aggregation wrappers' calls made inside the SGD and EM
    loops, by wrapping ``FederatedSimulation._sgd`` and ``fedsim``'s
    ``em_refine_loop`` for as long as it is entered."""

    def __init__(self):
        self.inside = {"sgd": 0, "em": 0}

    def _wrap(self, fn, where):
        def wrapped(*args, **kwargs):
            before = sum(aggregation.calls.values())
            try:
                return fn(*args, **kwargs)
            finally:
                self.inside[where] += sum(aggregation.calls.values()) - before
        return wrapped

    def __enter__(self):
        self._saved = (fedsim.FederatedSimulation._sgd, fedsim.em_refine_loop)
        fedsim.FederatedSimulation._sgd = self._wrap(self._saved[0], "sgd")
        fedsim.em_refine_loop = self._wrap(self._saved[1], "em")
        return self

    def __exit__(self, *exc):
        fedsim.FederatedSimulation._sgd, fedsim.em_refine_loop = self._saved


def _factory(spec: Optional[str]) -> Callable:
    if not spec:
        return build_sim
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def check_rank(spec: Optional[str], engine: str, devices: int, device: str,
               methods: Sequence[str], gate_syncs: bool) -> Dict[str, list]:
    """Run each method on this rank's simulation and return, a method, the
    violations found."""
    sim = _factory(spec)(engine, devices, device)
    on_card = sim.device.type == "cuda"
    rounds, iters = sim.sim.rounds, sim.sim.em_iters
    report = {}
    for method in methods:
        sim.run(method)                                 # warm-up
        aggregation.reset_counts()
        em_posterior.launches = weighted_agg.launches = 0
        with _LoopProbe() as loops, _Float64Probe() as f64, \
                FlopCounterMode(display=False) as flops:
            if on_card:
                _, syncs = count_syncs(lambda: sim.run(method))
            else:
                sim.run(method)
                syncs = None
        blocks = len(sim.last_run_stats["blocks"])
        calls = aggregation.calls
        model = sum(calls[k] for k in _MODEL_SIZED)
        sharded = engine == "sharded"
        want = PER_ROUND[method] * rounds if sharded else 0
        v = []
        if model != want:
            v.append(f"{model} model-sized collectives in {rounds} rounds, "
                     f"expected {want}")
        for where, n in loops.inside.items():
            if n:
                v.append(f"{n} collective(s) inside the {where.upper()} "
                         f"loop: hoist them to the round")
        if calls["exchange_block"] != (blocks if sharded else 0):
            v.append(f"{calls['exchange_block']} block exchanges in "
                     f"{blocks} blocks")
        if on_card:
            k = ((iters * rounds, rounds) if method == "pfedwn" else (0, 0))
            got = (em_posterior.launches, weighted_agg.launches)
            if got != k:
                v.append(f"K1, K2 launched {got}, expected {k}")
            if gate_syncs and syncs != blocks:
                v.append(f"{syncs} host syncs in {blocks} blocks")
        if f64.ops:
            v.append(f"{len(f64.ops)} op(s) made float64: "
                     f"{sorted(set(f64.ops))[:3]}")
        if not flops.get_total_flops() > 0:
            v.append("the block counted no FLOPs")
        summary = (f"collectives a round {model / rounds:g}, exchanges "
                   f"{calls['exchange_block']} in {blocks} blocks, in loops "
                   f"{sum(loops.inside.values())}, K1 "
                   f"{em_posterior.launches} K2 {weighted_agg.launches}, "
                   f"syncs {syncs}, flops {flops.get_total_flops():.3g}")
        report[method] = [summary, v]
    return report


def check_engine(engine: str, methods: Sequence[str], devices: int,
                 device: str, spec: Optional[str] = None) -> List[str]:
    """Check every method on ``engine``; print one line each and return
    the methods that failed."""
    if engine == "fused":
        ranks = [check_rank(spec, engine, devices, device, methods, True)]
    else:
        backend = default_backend(devices, device)
        ranks = spawn(check_rank, devices, backend, device, spec, engine,
                      devices, device, methods, backend == "nccl")
    failures = []
    for method in methods:
        tag = f"{engine}/{method}"
        violations = [(f"rank {r}: " if len(ranks) > 1 else "") + item
                      for r, rep in enumerate(ranks)
                      for item in rep[method][1]]
        if violations:
            failures.append(tag)
            for item in violations:
                print(f"FAIL {tag}: {item}")
        else:
            print(f"ok   {tag}: {ranks[0][method][0]}"
                  + (f" (each of {len(ranks)} ranks)" if len(ranks) > 1
                     else ""))
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint.blocks",
        description="Check the round-block invariants of every method on "
                    "the fused and sharded engines.")
    parser.add_argument("--engine", choices=("fused", "sharded", "both"),
                        default="both")
    parser.add_argument("--methods", default=None,
                        help="comma-separated subset (default: all six)")
    parser.add_argument("--devices", type=int, default=4,
                        help="ranks of the sharded engine (must divide "
                             f"{N_CLIENTS} clients; default 4)")
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    parser.add_argument("--sim", default=None, metavar="MODULE:FUNCTION",
                        help="check FUNCTION(engine, devices, device)'s "
                             "simulation instead of the tiny one")
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        return int(exc.code or 0)
    methods = fedsim.METHODS if not args.methods else tuple(
        m.strip() for m in args.methods.split(",") if m.strip())
    unknown = [m for m in methods if m not in fedsim.METHODS]
    if unknown:
        print(f"unknown method(s): {', '.join(unknown)}")
        return 2
    if args.devices < 1 or N_CLIENTS % args.devices:
        print(f"--devices must divide {N_CLIENTS}, got {args.devices}")
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda but torch.cuda.is_available() is False; pass "
              "--device cpu")
        return 2
    engines = (("fused", "sharded") if args.engine == "both"
               else (args.engine,))
    failures: List[str] = []
    for engine in engines:
        failures.extend(check_engine(engine, methods, args.devices,
                                     args.device, args.sim))
    if failures:
        print(f"{len(failures)} block(s) violate the round-block "
              f"invariants: " + ", ".join(failures))
        return 1
    print("all round-block invariants hold")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
