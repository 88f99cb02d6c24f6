"""Memory probe of one (arch × shape) step on the card: the largest blocks
live at the step's peak, the peak itself, and the collective bytes by
kind; the port's counterpart of ``scripts/memprobe.py``, which reads them
out of the compiled HLO.

    python3 scripts/torch_memprobe.py --arch smollm-135m --shape train_4k
        [--batch N] [--multi-pod] [--top 15] [--min-mib 64]

The step is the dry run's (``repro_torch.launch.dryrun``): random bf16
weights from seed 0, ``global_batch`` cut as ``chip_smoke.py`` phase 7g
cuts it (or to ``--batch``). After a warm-up, one step runs under
``torch.cuda.memory._record_memory_history``; the snapshot's trace of
allocations and frees is replayed to find the peak of the bytes
allocated and the blocks live there, each printed with its size and the
innermost frames of the port that allocated it. The collective bytes
come from the meta count of the multi-pod round step (the dry run's
``--multi-pod``) at full depth; one card runs no collective.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def _frames(entry, n: int = 3) -> str:
    """The innermost ``n`` Python frames of the port (or the script) that
    made an allocation, else its innermost Python frames (an allocation
    in autograd's backward has none)."""
    frames = [f for f in entry.get("frames", ())
              if f["filename"].endswith(".py")]
    own = [f for f in frames
           if "repro_torch" in f["filename"] or "scripts" in f["filename"]]
    return " < ".join(f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                      for f in (own or frames)[:n]) or \
        "(no Python frame: autograd's backward)"


def peak_blocks(snapshot) -> tuple:
    """Replays the snapshot's allocation trace (device 0): (peak bytes
    over the trace, the blocks live at the peak as trace entries). Blocks
    allocated before recording started are counted in the peak by the
    caller's baseline, not listed."""
    live, cur, best, best_live = {}, 0, -1, {}
    for e in snapshot["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
        elif e["action"] in ("free_completed",) and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
        if cur > best:
            best, best_live = cur, dict(live)
    return best, list(best_live.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--batch", type=int, default=None,
                    help="global_batch on the card (default: phase 7g's)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="print the round step's collectives (train shapes)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--min-mib", type=float, default=64.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_memprobe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import disable_tf32
    disable_tf32()
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    batch = args.batch or min(shape.global_batch,
                              dryrun.RUN_BATCH.get(args.shape, 1))
    cut = dataclasses.replace(shape, global_batch=batch)
    run, arg_bytes = dryrun._step(cfg, cut, "cuda", multi_pod=False)
    run()                                              # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    run()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    traced, blocks = peak_blocks(snap)
    print(f"== {args.arch} x {args.shape} (global_batch {shape.global_batch}"
          f" -> {batch}) on {torch.cuda.get_device_name(0)} ==")
    print(f"arguments {arg_bytes / 2**30:.2f} GiB, allocated before the "
          f"step {base / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB "
          f"(the trace's peak {(base + traced) / 2**30:.2f} GiB)")
    big = sorted((b for b in blocks if b["size"] >= args.min_mib * 2**20),
                 key=lambda b: -b["size"])
    for b in big[:args.top]:
        print(f"{b['size'] / 2**30:9.3f} GiB  {_frames(b)}")
    if args.multi_pod and shape.mode == "train":
        rec = dryrun.run_combo(args.arch, args.shape, None, multi_pod=True)
        coll = rec.get("collectives", {})
        print("collectives:", {k: f"{v / 2**30:.3f}GiB"
                               for k, v in coll.items()},
              f"total={rec.get('collective_bytes', 0) / 2**30:.3f} GiB "
              f"(a round a rank, {rec['mesh']})")
    else:
        print("collectives: none (one card holds the whole step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
