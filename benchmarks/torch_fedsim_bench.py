"""The port's round loop timed: the fused engine against the legacy
host-driven loop (``FedSimConfig(fused=False)``), for all six methods at
N = 8 and N = 32 clients; the port of ``benchmarks/fedsim_bench.py``'s
base sweep.

    python3 benchmarks/torch_fedsim_bench.py [--device cpu]
        [--smoke | --obs-overhead | --obs-smoke | --sharded
         | --sharded-smoke | --hoist]

It prints the card's name and power limit and one CSV line a method and
client count, and writes ``BENCH_torch.json`` at the repo root: each
engine's rounds per second and ms per round (a warm-up run first, then one
timed run of every round, evals included, on the host clock), and legacy ÷
fused. The file is read, updated and written back, so top-level sections
that other runs add survive (``_merge_write``). ``--smoke`` instead runs
both engines at a seconds-scale shape, asserts that they agree, and writes
nothing. ``--obs-overhead`` adds the ``obs_overhead`` section (fused
pFedWN at N = 8 with the metric taps on against off) to an existing file,
and ``--obs-smoke`` runs a tiny recorded run and checks its RunRecord.
``--sharded`` adds the ``sharded`` section: the client-sharded engine at N
= 32 over D = 1, 2 and 4 ranks (one process a rank; on one card every rank
shares it, so this measures the exchange's overhead, not scaling).
``--sharded-smoke`` checks the sharded engine at D = 4 against the fused
one for every method at a tiny shape, and ``--hoist`` re-times fused
pFedWN at N = 32 against the stored base-sweep row (``pfedwn_hoist``).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmarks.torch_common import emit, parser, setup_device  # noqa: E402
from repro_torch.configs import CNNConfig  # noqa: E402
from repro_torch.core.fedsim import (METHODS,  # noqa: E402
                                     FederatedSimulation, FedSimConfig)
from repro_torch.data import (make_client_datasets,  # noqa: E402
                              synthetic_image_dataset, train_test_split)
from repro_torch.obs import report, validate_jsonl_lines  # noqa: E402
from repro_torch.sharding import default_backend, spawn  # noqa: E402
from repro_torch.sharding.worker import run_methods  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parents[1]
OUT_PATH = REPO_ROOT / "BENCH_torch.json"
ROUNDS, EVAL_EVERY = 8, 1


def build_sim(n_clients: int, *, fused: bool, rounds: int, eval_every: int,
              samples: int = 0, batch: int = 32, taps: bool = True,
              record_dir: str | None = None, run_name: str | None = None,
              sharded: bool = False, shard_devices: int | None = None,
              device: str = "cuda") -> FederatedSimulation:
    """Every client participates, over links with a mild random error: the
    learning loop is what is timed, not the channel layer. Each client gets
    an even random shard (64 samples by default), not a Dirichlet split,
    so that every method runs a fixed number of steps a round."""
    samples = samples or 64 * n_clients
    base = synthetic_image_dataset(0, samples, image_size=8, n_classes=10)
    rng = np.random.default_rng(0)
    parts = np.array_split(rng.permutation(samples), n_clients)
    train_sets = make_client_datasets(
        base, [train_test_split(p, seed=1)[0] for p in parts])
    test_sets = make_client_datasets(
        base, [train_test_split(p, seed=1)[1] for p in parts])
    pm = np.ones(n_clients, bool)
    rng = np.random.default_rng(2)
    p_err = np.concatenate(
        [[0.0], rng.uniform(0.0, 0.1, n_clients - 1)]).astype(np.float32)
    model_cfg = CNNConfig(image_size=8, widths=(4, 8), hidden=16,
                          n_classes=10)
    cfg = FedSimConfig(rounds=rounds, batch_size=batch, lr=0.05, alpha=0.7,
                       em_iters=2, em_subset=32, adapt_subset=32,
                       eval_every=eval_every, seed=0, fused=fused,
                       taps=taps, record_dir=record_dir, run_name=run_name,
                       sharded=sharded, shard_devices=shard_devices)
    return FederatedSimulation(model_cfg, train_sets, test_sets, pm, p_err,
                               cfg, device=device)


def time_method(sim: FederatedSimulation, method: str) -> Dict[str, float]:
    """Rounds per second and ms per round of one run of ``method``, after
    a warm-up run. Every run ends in a host sync (its last eval), so the
    host clock covers the device's work."""
    sim.run(method)
    t0 = time.perf_counter()
    sim.run(method)
    dt = time.perf_counter() - t0
    rounds = sim.sim.rounds
    return {"rounds_per_sec": rounds / dt,
            "round_latency_ms": dt / rounds * 1e3, "total_s": dt}


def run(device: str = "cuda", card: str = "",
        path: Path = OUT_PATH) -> Dict:
    results: Dict[str, Dict] = {}
    for n in (8, 32):
        sims = {engine: build_sim(n, fused=(engine == "fused"),
                                  rounds=ROUNDS, eval_every=EVAL_EVERY,
                                  device=device)
                for engine in ("legacy", "fused")}
        results[f"N={n}"] = {}
        for method in METHODS:
            row: Dict[str, float] = {}
            for engine, sim in sims.items():
                t = time_method(sim, method)
                row[f"{engine}_rounds_per_sec"] = t["rounds_per_sec"]
                row[f"{engine}_round_latency_ms"] = t["round_latency_ms"]
            row["legacy_over_fused"] = (row["legacy_round_latency_ms"]
                                        / row["fused_round_latency_ms"])
            results[f"N={n}"][method] = row
            emit(f"torch_fedsim_{method}_N{n}",
                 row["fused_round_latency_ms"] * 1e3,
                 f"fused_rps={row['fused_rounds_per_sec']:.2f};"
                 f"legacy_rps={row['legacy_rounds_per_sec']:.2f};"
                 f"legacy/fused={row['legacy_over_fused']:.2f}x")
    report = {
        "bench": "torch_fedsim_round_loop",
        "device": card or str(device),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "config": {"rounds": ROUNDS, "eval_every": EVAL_EVERY,
                   "batch_size": 32, "image_size": 8, "em_iters": 2,
                   "em_subset": 32, "model": "cnn(4,8)/h16",
                   "samples_per_client": 64, "partition": "even"},
        "note": "legacy = host-driven per-round loop (fused=False); fused = "
                "the device-resident engine with a host sync per eval "
                "block; ms per round on the host clock, one warm-up run "
                "first, evals included",
        "results": results,
    }
    return _merge_write(report, path)


def _merge_write(updates: Dict, path: Path = OUT_PATH) -> Dict:
    """Read-update-write ``path``: only the top-level keys in ``updates``
    are replaced; keys it does not own pass through unchanged. Returns
    the merged report."""
    report: Dict = {}
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
    report.update(updates)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    return report


def smoke(device: str = "cuda") -> None:
    """Seconds-scale guard: both engines run pFedWN on a tiny shape and
    agree (accuracies within 5e-3, π within 1e-4); the fused engine syncs
    once per eval block. Writes nothing."""
    t0 = time.perf_counter()
    sims = {engine: build_sim(4, fused=(engine == "fused"), rounds=3,
                              eval_every=2, samples=400, batch=16,
                              device=device)
            for engine in ("legacy", "fused")}
    hist = {engine: sim.run("pfedwn") for engine, sim in sims.items()}
    gap = max(abs(a - b) for a, b in zip(hist["fused"]["target_acc"],
                                         hist["legacy"]["target_acc"]))
    pi_gap = float(np.abs(np.stack(hist["fused"]["pi"])
                          - np.stack(hist["legacy"]["pi"])).max())
    if gap > 5e-3 or pi_gap > 1e-4:
        raise AssertionError(f"fused and legacy disagree on the smoke "
                             f"shape: |Δacc|={gap:.4f} |Δπ|={pi_gap:.2e}")
    if sims["fused"].last_run_stats["device_calls"] != 2:
        raise AssertionError("the fused engine synced more than once a "
                             "block")
    emit("torch_fedsim_smoke", (time.perf_counter() - t0) * 1e6,
         f"parity_gap={gap:.1e};ok")


def obs_overhead(device: str = "cuda", card: str = "",
                 path: Path = OUT_PATH, rounds: int = ROUNDS,
                 repeats: int = 5) -> Dict:
    """The metric taps' cost: fused pFedWN at the base sweep's N = 8 shape
    with ``taps`` on against off, each timed as in ``time_method`` (a
    warm-up run first), the two interleaved ``repeats`` times; the medians
    give the overhead. Adds an ``obs_overhead`` section to the existing
    report at ``path`` (the base sweep is not re-measured) and asserts the
    taps cost under 5 % of fused throughput, as the reference's bench
    does."""
    if not os.path.exists(path):
        raise RuntimeError(f"{path} missing: run the base sweep first "
                           "(obs_overhead extends it, it does not "
                           "re-measure it)")
    sims = {taps: build_sim(8, fused=True, rounds=rounds, eval_every=1,
                            taps=taps, device=device)
            for taps in (False, True)}
    for sim in sims.values():
        sim.run("pfedwn")
    ms: Dict[bool, list] = {False: [], True: []}
    for _ in range(repeats):
        for taps, sim in sims.items():
            t0 = time.perf_counter()
            sim.run("pfedwn")
            ms[taps].append((time.perf_counter() - t0) / rounds * 1e3)
    med = {taps: float(np.median(v)) for taps, v in ms.items()}
    rps = {taps: 1e3 / v for taps, v in med.items()}
    overhead_pct = (rps[False] - rps[True]) / rps[False] * 100.0
    entry = {
        "note": "fused pfedwn N=8, per-round metric taps on vs off (one "
                "packed host copy a block); medians of interleaved runs, "
                "each after a warm-up run, ms per round on the host clock",
        "device": card or str(device),
        "rounds": rounds, "repeats": repeats,
        "taps_off_ms_per_round": ms[False],
        "taps_on_ms_per_round": ms[True],
        "taps_off_rounds_per_sec": rps[False],
        "taps_on_rounds_per_sec": rps[True],
        "overhead_pct": overhead_pct,
    }
    _merge_write({"obs_overhead": entry}, path)
    emit("torch_fedsim_obs_overhead", med[True] * 1e3,
         f"taps_on_rps={rps[True]:.2f};taps_off_rps={rps[False]:.2f};"
         f"overhead={overhead_pct:.2f}%")
    assert overhead_pct < 5.0, (
        f"metric-tap overhead {overhead_pct:.2f}% exceeds the 5% budget")
    return entry


def obs_smoke(device: str = "cuda") -> None:
    """Seconds-scale guard of the recorder: a tiny recorded fused pFedWN
    run writes ``obs_smoke.jsonl`` and its Chrome trace, the record passes
    the schema check and the report, holds every event type, and the run
    synced once a block. The files land in ``$OBS_SMOKE_DIR`` when set,
    else in a fresh temporary directory."""
    t0 = time.perf_counter()
    out_dir = os.environ.get("OBS_SMOKE_DIR") or tempfile.mkdtemp(
        prefix="torch_obs_smoke_")
    sim = build_sim(4, fused=True, rounds=3, eval_every=2, samples=400,
                    batch=16, record_dir=out_dir, run_name="obs_smoke",
                    device=device)
    sim.run("pfedwn")
    jsonl = os.path.join(out_dir, "obs_smoke.jsonl")
    if not os.path.exists(os.path.join(out_dir, "obs_smoke.trace.json")):
        raise AssertionError("Chrome trace not written")
    with open(jsonl) as f:
        lines = f.readlines()
    errors = validate_jsonl_lines(lines)
    if errors:
        raise AssertionError(f"RunRecord schema violations: {errors[:5]}")
    types = [json.loads(ln)["type"] for ln in lines]
    for expected in ("meta", "compile", "round", "eval", "summary"):
        if expected not in types:
            raise AssertionError(f"missing {expected!r} event")
    if sim.last_run_stats["device_calls"] != 2:
        raise AssertionError("the recorded run synced more than once a "
                             "block")
    if report.main([jsonl]) != 0:
        raise AssertionError("the report rejected the record")
    compile_s = sum(e["seconds"] for e in sim.recorder.events
                    if e["type"] == "compile")
    emit("torch_obs_smoke", (time.perf_counter() - t0) * 1e6,
         f"events={len(types)};rounds={types.count('round')};"
         f"compile_s={compile_s:.6f};ok")


def _spawn_runs(devices: int, device: str, methods, repeat: int = 1,
                **build_kw):
    """Rank 0's results of ``methods`` on the sharded engine over
    ``devices`` ranks (nccl when each rank has a card, else gloo)."""
    backend = default_backend(devices, device)
    kw = dict(build_kw, fused=True, sharded=True, shard_devices=devices,
              device=device)
    ranks = spawn(run_methods, devices, backend, device, build_sim, kw,
                  list(methods), None, repeat)
    return backend, ranks[0]


def sharded_bench(device: str = "cuda", card: str = "",
                  path: Path = OUT_PATH, n: int = 32, rounds: int = ROUNDS,
                  devices=(1, 2, 4)) -> Dict:
    """Add a ``sharded`` section to the report at ``path``: the client-
    sharded engine at N = ``n`` over each of ``devices`` ranks, fedavg (the
    all-reduce) and pfedwn (the all-gather and the replicated target
    math), ms per round (rank 0's blocks, each ending in the block's
    exchange and one host copy, after a warm-up run) and rounds per
    second. The base sweep is not re-measured."""
    results: Dict[str, Dict] = {}
    for d in devices:
        backend, runs = _spawn_runs(d, device, ("fedavg", "pfedwn"), 2,
                                    n_clients=n, rounds=rounds,
                                    eval_every=EVAL_EVERY)
        row: Dict = {"backend": backend}
        for res in runs:
            ms = float(np.mean(res["history"]["round_ms"]))
            row[f"{res['method']}_round_latency_ms"] = ms
            row[f"{res['method']}_rounds_per_sec"] = 1e3 / ms
        results[f"devices={d}"] = row
        emit(f"torch_fedsim_sharded_devices{d}",
             row["pfedwn_round_latency_ms"] * 1e3,
             f"backend={backend};"
             f"pfedwn_rps={row['pfedwn_rounds_per_sec']:.2f};"
             f"fedavg_rps={row['fedavg_rounds_per_sec']:.2f}")
    section = {
        "note": f"client-sharded engine, N={n}, one process a rank; every "
                "rank of a one-card machine shares that card (D = 1 on "
                "nccl, more ranks on gloo, which stages through the host), "
                "so this measures the exchange's overhead, not scaling; ms "
                "per round on rank 0's host clock after a warm-up run, "
                "evals included; the base sweep is not re-measured",
        "device": card or str(device), "n_clients": n, "rounds": rounds,
        "results": results,
    }
    _merge_write({"sharded": section}, path)
    return section


def sharded_smoke(device: str = "cuda") -> None:
    """Seconds-scale guard of the sharded engine: every method at a tiny
    shape on D = 4 ranks against the fused engine, same seed; fails past
    |Δacc| 5e-3. Writes nothing."""
    t0 = time.perf_counter()
    common = dict(rounds=2, eval_every=2, samples=400, batch=16)
    fused = build_sim(4, fused=True, device=device, **common)
    _, runs = _spawn_runs(4, device, METHODS, n_clients=4, **common)
    worst = 0.0
    for res in runs:
        hf = fused.run(res["method"])
        gap = max(abs(a - b) for a, b in zip(hf["target_acc"],
                                             res["history"]["target_acc"]))
        worst = max(worst, gap)
        if gap > 5e-3 or res["stats"]["engine"] != "sharded":
            raise AssertionError(f"sharded and fused disagree on "
                                 f"{res['method']}: |Δacc|={gap:.4f}")
    emit("torch_fedsim_sharded_smoke", (time.perf_counter() - t0) * 1e6,
         f"devices=4;methods={len(METHODS)};worst_gap={worst:.1e};ok")


def hoist_bench(device: str = "cuda", card: str = "", path: Path = OUT_PATH,
                n: int = 32, rounds: int = ROUNDS) -> Dict:
    """Add a ``pfedwn_hoist`` section: fused pfedwn at N = ``n`` re-timed
    against the stored base-sweep row (not re-measured). The port's EM
    loop has carried the reference's hoists (one backward through the
    component stack an iteration, the last refinement dropped) since it
    was first ported, so the ratio is the spread between two runs of the
    same code."""
    if not os.path.exists(path):
        raise RuntimeError(f"{path} missing: run the base sweep first")
    with open(path) as f:
        before = json.load(f)["results"][f"N={n}"]["pfedwn"]
    sim = build_sim(n, fused=True, rounds=rounds, eval_every=EVAL_EVERY,
                    device=device)
    t = time_method(sim, "pfedwn")
    section = {
        "note": f"fused pfedwn N={n} re-timed against the stored base-sweep "
                "row; the port's EM loop had the reference's hoists from "
                "its first version, so this is the same code measured "
                "twice (run-to-run spread, not a gain)",
        "device": card or str(device), "rounds": rounds,
        "before_round_latency_ms": before["fused_round_latency_ms"],
        "after_round_latency_ms": t["round_latency_ms"],
        "after_rounds_per_sec": t["rounds_per_sec"],
        "before_over_after": (before["fused_round_latency_ms"]
                              / t["round_latency_ms"]),
    }
    _merge_write({"pfedwn_hoist": section}, path)
    emit("torch_fedsim_pfedwn_hoist", t["round_latency_ms"] * 1e3,
         f"before_ms={section['before_round_latency_ms']:.2f};"
         f"after_ms={section['after_round_latency_ms']:.2f};"
         f"before/after={section['before_over_after']:.2f}x")
    return section


def main() -> None:
    p = parser(__doc__.split("\n")[0], str(OUT_PATH))
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="run both engines at a tiny shape, check that "
                      "they agree, write nothing")
    mode.add_argument("--obs-overhead", action="store_true",
                      help="add the taps-on/off section to an existing "
                      "report")
    mode.add_argument("--obs-smoke", action="store_true",
                      help="run a tiny recorded run and check its record")
    mode.add_argument("--sharded", action="store_true",
                      help="add the sharded engine's section (D = 1, 2, 4)")
    mode.add_argument("--sharded-smoke", action="store_true",
                      help="check the sharded engine against the fused one "
                      "at a tiny shape, write nothing")
    mode.add_argument("--hoist", action="store_true",
                      help="re-time fused pfedwn at N = 32 against the "
                      "stored row")
    args = p.parse_args()
    info = setup_device(args.device)
    if args.smoke:
        smoke(args.device)
        return
    if args.obs_smoke:
        obs_smoke(args.device)
        return
    if args.sharded_smoke:
        sharded_smoke(args.device)
        return
    out = Path(args.out)
    if args.obs_overhead:
        obs_overhead(args.device, info.get("card", ""), out)
        return
    if args.sharded:
        sharded_bench(args.device, info.get("card", ""), out)
        return
    if args.hoist:
        hoist_bench(args.device, info.get("card", ""), out)
        return
    report = run(device=args.device, card=info.get("card", ""), path=out)
    n32 = report["results"]["N=32"]["pfedwn"]
    emit("torch_fedsim_bench", 0.0,
         f"wrote {out.name};pfedwn_N32_legacy/fused="
         f"{n32['legacy_over_fused']:.2f}x")


if __name__ == "__main__":
    main()
