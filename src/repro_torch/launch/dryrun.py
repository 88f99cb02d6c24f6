"""The dry run: every (architecture × input shape) step built on the
``meta`` device, its work counted, one JSON record each; the port's
``launch/dryrun.py``. ``benchmarks/torch_roofline.py`` reads the records.

The reference lowers and compiles each step on 256 or 512 fake TPU
devices and reads XLA's cost and memory analysis. The port has no
compiler: each step runs on ``meta`` tensors (shapes and dtypes, no data,
no device), in bf16 as the reference's (``abstract_params``,
``abstract_cache``, ``input_specs``), with the step builders of
``launch/steps.py``, under :class:`~repro_torch.roofline.counter.
CostCounter`, which counts every op's FLOPs and bytes and the kernels'
own work (K3 by its visible pairs, K2 by its mix), and under
:class:`~repro_torch.roofline.collectives.CollectiveCounter`. A step that
runs on meta tensors is a step whose shapes fit together: a shape error
fails here, as a sharding mismatch fails the reference's compile.

Protocol, as the reference's: the counts are taken on the 1-period and
2-period depth variants (``_depth_variant``; a period is one layer, or
``hybrid_attn_every`` layers for the hybrid, after the MoE's
``first_k_dense`` dense layers) and extrapolated to full depth,
``cost(L) = cost(d1) + (trips − 1)·(cost(d2) − cost(d1))`` with ``trips``
= (L − first_k_dense) / period. Each record keeps both probes.

  - Bytes accessed: every op's tensor arguments and results, views 0, and
    each kernel's inputs and outputs (the counter's docstring): an eager
    step's traffic with no fusion.
  - Memory: ``argument_bytes``, the whole client's params + batch +
    cache in bf16, which ``--run`` weighs against one card's 80 GB; and
    ``argument_bytes_per_card``, the bytes of them one card holds under
    the reference's specs on the production ``("data", "model")`` mesh
    (``sharding/place.py``: params by ``param_shardings``, the batch by
    ``batch_spec`` with entries that do not divide dropped, the cache by
    ``cache_shardings``), the counterpart of XLA's argument size a device.
    ``--multi-pod`` records count one pod's client (its share of a serving
    batch) on that mesh.
  - ``--multi-pod``: the training shapes run the pFedWN round step
    (``make_pfedwn_round_step``) on the mesh's C = 2 pod clients, one a
    rank of a fake process group (no data moves; each collective's result
    is counted by its bytes); the serving shapes serve each pod's share of
    the batch on its own card, with no collective.
  - ``--run``: where the argument bytes of the shape with ``global_batch``
    cut as ``chip_smoke.py`` phase 7g cuts it fit 80 GB, the step also
    runs on the card with random bf16 weights from seed 0: its ms after a
    warm-up, its peak memory, and K3's and K2's FLOPs counted on the card
    beside the meta count at the same cut. deepseek-v3 at full width (1.3
    TB of bf16 params) is meta only, and its record says so.
  - ``--all``: each combination in a subprocess of its own, as the
    reference's.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--run] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs import (ShapeConfig, TrainConfig, get_config,
                                 get_shape, list_archs)
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.collectives import CollectiveCounter
from repro_torch.roofline.counter import CostCounter
from repro_torch.sharding import place
from repro_torch.sharding.rules import cache_shardings, param_shardings

DEFAULT_OUT = "experiments/torch_dryrun"
CARD_BYTES = 80e9           # one H100's memory
# global_batch on the card (--run), as chip_smoke.py phase 7g cuts it
RUN_BATCH = {"train_4k": 2, "prefill_32k": 1, "decode_32k": 8,
             "long_500k": 1}
BYTES_METHOD = ("each aten op's tensor arguments and results (views 0) "
                "under a TorchDispatchMode, plus each kernel's inputs read "
                "and outputs written once; no fusion")
COSTS = ("flops", "bytes_accessed", "collective_bytes")


def _depth_period(cfg) -> int:
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        return cfg.hybrid_attn_every
    return 1


def _depth_variant(cfg, periods: int):
    """Config with first_k_dense + periods·period layers."""
    fk = cfg.moe.first_k_dense if cfg.moe else 0
    p = _depth_period(cfg)
    return dataclasses.replace(cfg, n_layers=fk + periods * p)


def _layer_trips(cfg) -> float:
    fk = cfg.moe.first_k_dense if cfg.moe else 0
    return (cfg.n_layers - fk) / _depth_period(cfg)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) \
        else 0


def _materialize(specs: Dict[str, torch.Tensor], cfg, device,
                 seed: int = 0) -> Dict:
    """Concrete inputs of ``input_specs``' shapes and dtypes on
    ``device``: tokens (and labels, the tokens shifted, the last -1)
    uniform over the vocab, stub embeddings N(0, 0.02²), M-RoPE positions
    the model's default (each component the index), explicit."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, spec in specs.items():
        if name in ("tokens", "token"):
            out[name] = torch.randint(0, cfg.vocab, spec.shape,
                                      generator=gen, dtype=torch.int32)
        elif name == "stub_embeds":
            out[name] = (0.02 * torch.randn(spec.shape, generator=gen)
                         ).to(spec.dtype)
        elif name == "positions":
            pos = torch.arange(spec.shape[0], dtype=torch.int32)
            out[name] = pos[:, None].expand(spec.shape).contiguous()
    if "labels" in specs:
        labels = torch.roll(out["tokens"], -1, dims=1)
        labels[:, -1] = -1
        out["labels"] = labels
    return {k: v.to(device) for k, v in out.items()}


def argument_bytes_per_card(cfg, shape: ShapeConfig, mesh) -> int:
    """The bytes of the bf16 params, the batch and (decode) the cache that
    one card of ``mesh`` (a ``("data", "model")`` ``MeshSpec``) holds under
    the reference's specs: the sum of the leaves' shard shapes
    (``NamedSharding(mesh, spec).shard_shape``), the same on every card
    since every split is even."""
    pl = place.layout(mesh, 0)
    params = steps_lib.abstract_params(cfg)
    batch = steps_lib.input_specs(cfg, shape)
    n = (place.tree_shard_bytes(params, param_shardings(mesh, params), pl)
         + place.tree_shard_bytes(batch, place.batch_specs(batch, pl), pl))
    if shape.mode == "decode":
        cache = steps_lib.abstract_cache(cfg, shape)
        n += place.tree_shard_bytes(cache, cache_shardings(mesh, cache), pl)
    return n


def _cut(shape: ShapeConfig, batch: int) -> ShapeConfig:
    return dataclasses.replace(shape, global_batch=batch)


def _step(cfg, shape: ShapeConfig, device: str, *, multi_pod: bool,
          seed: int = 0):
    """(a function that runs the step once, its argument bytes)."""
    if device == "meta":
        params = steps_lib.abstract_params(cfg)
        batch = steps_lib.input_specs(cfg, shape)
    else:
        from repro_torch.models import model as model_lib
        gen = torch.Generator(device=device).manual_seed(seed)
        params = model_lib.init_params(cfg, gen, device=device,
                                       dtype=torch.bfloat16)
        batch = _materialize(steps_lib.input_specs(cfg, shape), cfg, device,
                             seed)
    args = _tree_bytes(params) + _tree_bytes(batch)
    if shape.mode == "train":
        if multi_pod:
            mesh = make_production_mesh(multi_pod=True)
            C = mesh.axis_sizes()["pod"]
            step = steps_lib.make_pfedwn_round_step(
                cfg, TrainConfig(), shape, mesh, n_clients=C)
            pi = torch.full((C, C), 1.0 / C, device=device)
            ok = torch.ones((C, C), dtype=torch.bool, device=device)
            return (lambda: step(params, batch, pi, ok)), args
        step = steps_lib.make_train_step(cfg, TrainConfig(), shape)
        return (lambda: step(params, batch)), args
    if shape.mode == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape)
        return (lambda: step(params, batch)), args
    if device == "meta":
        cache = steps_lib.abstract_cache(cfg, shape)
    else:
        from repro_torch.models import model as model_lib
        cache = model_lib.init_cache(
            cfg, shape.global_batch, shape.seq_len,
            window=steps_lib.effective_window(cfg, shape), device=device,
            dtype=torch.bfloat16)
    step = steps_lib.make_decode_step(cfg, shape)
    # the new token at the cache's last position
    dbatch = dict(batch, pos=shape.seq_len - 1)
    return (lambda: step(params, cache, dbatch)), args + _tree_bytes(cache)


def _count(run: Callable) -> Dict:
    """One run under a cost and a collective counter."""
    with CostCounter() as cost, CollectiveCounter() as coll:
        run()
    c = coll.summary()
    return dict(cost.summary(), collective_bytes=c["total"],
                collectives=c["by_kind"], collective_count=c["count"])


def _extrapolate(d1: Dict, d2: Dict, trips: float) -> Dict:
    """cost(L) = cost(d1) + (trips − 1)·(cost(d2) − cost(d1)), for the
    totals, each collective kind and each kernel's counts."""
    def ext(a, b):
        return a + max(trips - 1.0, 0.0) * (b - a)
    out = {k: ext(d1[k], d2[k]) for k in COSTS + ("kernel_flops",)}
    kinds = set(d1["collectives"]) | set(d2["collectives"])
    out["collectives"] = {k: ext(d1["collectives"].get(k, 0.0),
                                 d2["collectives"].get(k, 0.0))
                          for k in kinds}
    out["kernels"] = {
        name: {f: ext(d1["kernels"].get(name, {}).get(f, 0),
                      d2["kernels"].get(name, {}).get(f, 0))
               for f in ("flops", "bytes", "calls")}
        for name in set(d1["kernels"]) | set(d2["kernels"])}
    return out


def _fake_group(multi_pod: bool, train: bool):
    """A fake process group of the mesh's C pod ranks for the meta round
    step (collectives counted, none run), or None."""
    if not (multi_pod and train):
        return None
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    C = make_production_mesh(multi_pod=True).axis_sizes()["pod"]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=C)
    return dist


def meta_costs(cfg, shape: ShapeConfig, *, multi_pod: bool = False
               ) -> Dict:
    """The counted costs of ``cfg`` at ``shape`` on the meta device: the
    two depth probes and their extrapolation to full depth."""
    t0 = time.perf_counter()
    d1 = _count(_step(_depth_variant(cfg, 1), shape, "meta",
                      multi_pod=multi_pod)[0])
    d2 = _count(_step(_depth_variant(cfg, 2), shape, "meta",
                      multi_pod=multi_pod)[0])
    trips = _layer_trips(cfg)
    return {"extrapolated": _extrapolate(d1, d2, trips),
            "depth_probe": {"d1": d1, "d2": d2, "trips": trips,
                            "seconds": time.perf_counter() - t0}}


def run_on_card(cfg, shape: ShapeConfig, cut: ShapeConfig) -> Dict:
    """The step at ``cut`` on the card: a warm-up, then one timed step
    (host clock, ending in a sync) and its peak memory, then one counted
    step (K3's and K2's FLOPs on the card) beside the meta count of the
    same cut at full depth."""
    from repro_torch import disable_tf32
    disable_tf32()
    torch.cuda.reset_peak_memory_stats()
    run, args = _step(cfg, cut, "cuda", multi_pod=False)
    run()                                            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    card = _count(run)
    meta = _count(_step(cfg, cut, "meta", multi_pod=False)[0])
    return {"global_batch": cut.global_batch,
            "cut": f"global_batch {shape.global_batch} -> "
                   f"{cut.global_batch}",
            "argument_bytes": args, "ms": ms, "peak_bytes": peak,
            "card": torch.cuda.get_device_name(0),
            "kernel_flops_card": card["kernel_flops"],
            "kernel_flops_meta": meta["kernel_flops"],
            "kernels_card": card["kernels"],
            "kernels_meta": meta["kernels"]}


def run_combo(arch: str, shape_name: str, out_dir: Optional[str], *,
              multi_pod: bool = False, run: bool = False) -> dict:
    """One (arch × shape) record, written to ``out_dir`` (when given) as
    ``{arch}__{shape}__{pod|multipod}.json``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    tag = "multipod" if multi_pod else "pod"
    train = shape.mode == "train"
    C = make_production_mesh(multi_pod=True).axis_sizes()["pod"]
    if multi_pod and not train:        # each pod serves its share
        shape = _cut(shape, max(1, shape.global_batch // C))
    rec = {"arch": arch, "shape": shape_name,
           "mesh": (f"{C} pod clients x 1 card" if multi_pod else "1 card"),
           "devices": C if multi_pod else 1, "per_device_costs": True,
           "dtype": "bfloat16", "bytes_accessed_method": BYTES_METHOD}
    dist = None
    try:
        dist = _fake_group(multi_pod, train)
        t0 = time.perf_counter()
        args = _step(cfg, shape, "meta", multi_pod=False)[1]
        rec.update(meta_costs(cfg, shape, multi_pod=multi_pod))
        ext = rec["extrapolated"]
        rec.update({k: ext[k] for k in COSTS})
        rec["collectives"] = ext["collectives"]
        rec["kernels"] = ext["kernels"]
        rec["kernel_flops"] = ext["kernel_flops"]
        rec["memory"] = {"argument_bytes": args,
                         "argument_bytes_per_card": argument_bytes_per_card(
                             cfg, shape, make_production_mesh())}
        rec["build_seconds"] = time.perf_counter() - t0
        cut = _cut(shape, min(shape.global_batch,
                              RUN_BATCH.get(shape_name, 1)))
        cut_args = _step(cfg, cut, "meta", multi_pod=False)[1]
        rec["meta_only"] = cut_args > CARD_BYTES
        if rec["meta_only"]:
            rec["meta_only_reason"] = (
                f"{cut_args / 1e9:.1f} GB of arguments at global_batch "
                f"{cut.global_batch} exceed one card's 80 GB")
        if run and not rec["meta_only"]:
            rec["run"] = run_on_card(cfg, shape, cut)
        rec["status"] = "ok"
        print(f"[ok]   {arch} x {shape_name} ({rec['mesh']}) "
              f"build={rec['build_seconds']:.1f}s flops/dev="
              f"{rec['flops']:.3e} args={args / 2**30:.2f}GiB"
              + (" meta-only" if rec["meta_only"] else ""), flush=True)
    except Exception as e:
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        print(f"[FAIL] {arch} x {shape_name} ({rec['mesh']}): "
              f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    finally:
        if dist is not None:
            dist.destroy_process_group()
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="also run each step that fits on the card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --all or both --arch and --shape")
    archs = list_archs() if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    tag = "multipod" if args.multi_pod else "pod"
    n_ok = total = 0
    for a in archs:
        for s in shapes:
            total += 1
            if not args.all:
                rec = run_combo(a, s, args.out, multi_pod=args.multi_pod,
                                run=args.run)
                n_ok += rec["status"] == "ok"
                continue
            # subprocess isolation: a crash in one combo must not end the
            # sweep
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--out", args.out]
            cmd += ["--multi-pod"] * args.multi_pod + ["--run"] * args.run
            r = subprocess.run(cmd, timeout=3600)
            path = os.path.join(args.out, f"{a}__{s}__{tag}.json")
            ok = False
            if os.path.exists(path):
                with open(path) as f:
                    ok = json.load(f).get("status") == "ok"
            if not ok:
                rec = {"arch": a, "shape": s, "status": "fail",
                       "error": f"subprocess exit {r.returncode}"}
                os.makedirs(args.out, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[FAIL] {a} x {s}: subprocess exit {r.returncode}",
                      flush=True)
            n_ok += ok
    print(f"== {n_ok}/{total} combos built on the meta device ({tag}) ==")
    if n_ok != total:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
