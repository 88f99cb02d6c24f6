"""Roofline report of the port: reads the dry-run records that
``python -m repro_torch.launch.dryrun`` writes and prints, for each arch ×
shape, the three roofline terms of one H100 SXM (``repro_torch.roofline.
analysis``: compute at 989 TFLOP/s bf16, memory at 3.35 TB/s, collectives
at 450 GB/s NVLink), the dominant one and the useful-compute ratio (the
model FLOPs, 6·N_active·D or 2·N_active·D, over the counted FLOPs). The
port's counterpart of ``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 benchmarks/torch_roofline.py [--dir experiments/torch_dryrun]
        [--multi-pod] [--json OUT]

The records are counts, not timings: each term is the time the card would
take if that resource alone bound the step.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch.dryrun import DEFAULT_OUT  # noqa: E402
from repro_torch.roofline.analysis import roofline_terms  # noqa: E402


def run(dryrun_dir: str, multi_pod: bool = False) -> list:
    tag = "multipod" if multi_pod else "pod"
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir,
                                              f"*__{tag}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": "fail"})
            continue
        cfg = get_config(rec["arch"])
        shape = get_shape(rec["shape"])
        src = dict(rec)
        if "extrapolated" in rec:
            src.update(rec["extrapolated"])
        rows.append({"arch": rec["arch"], "shape": rec["shape"],
                     "status": "ok", "meta_only": rec.get("meta_only"),
                     **roofline_terms(src, cfg, shape)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None,
                    help="also write the rows to this file")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = run(args.dir, args.multi_pod)
    us = (time.perf_counter() - t0) * 1e6
    ok = [r for r in rows if r["status"] == "ok"]
    if not ok:
        print(f"roofline,{us:.1f},no_dryrun_artifacts")
        return 1
    dominant = {}
    for r in ok:
        dominant[r["dominant"]] = dominant.get(r["dominant"], 0) + 1
    print(f"roofline,{us:.1f},combos={len(ok)};failed="
          f"{len(rows) - len(ok)};dominant={dominant};worst_useful_ratio="
          f"{min(r.get('useful_compute_ratio', 1) for r in ok):.3f}")
    for r in rows:
        if r["status"] != "ok":
            print(f"#   {r['arch']:24s} {r['shape']:12s} FAILED")
            continue
        print(f"#   {r['arch']:24s} {r['shape']:12s} "
              f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s dom={r['dominant']} "
              f"useful={r.get('useful_compute_ratio', 0):.2f}"
              + (" (meta only)" if r.get("meta_only") else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
