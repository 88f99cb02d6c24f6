"""RunRecord report CLI.

    PYTHONPATH=src python -m repro_torch.obs.report runs/fedsim.jsonl [--json]

Validates every line against the RunRecord schema (exit code 2 on any
violation — CI's obs smoke relies on this), then summarizes each run:
per-method accuracy table, round-latency percentiles, channel stats (link
success rate / effective neighbors), and compile events with FLOP
counts.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs.record import validate_jsonl_lines


def load_runs(lines: List[str]) -> List[Dict[str, Any]]:
    """Group decoded events by run_id (in first-seen order). Each run dict
    holds the meta/summary events plus the round/eval/compile lists."""
    runs: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        ev = json.loads(line)
        rid = ev.get("run_id") or "<none>"
        if rid not in runs:
            runs[rid] = {"run_id": rid, "meta": None, "summary": None,
                         "rounds": [], "evals": [], "compiles": []}
            order.append(rid)
        run = runs[rid]
        etype = ev.get("type")
        if etype == "meta":
            run["meta"] = ev
        elif etype == "summary":
            run["summary"] = ev
        elif etype == "round":
            run["rounds"].append(ev)
        elif etype == "eval":
            run["evals"].append(ev)
        elif etype == "compile":
            run["compiles"].append(ev)
    return [runs[rid] for rid in order]


def _mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def summarize_run(run: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one run into the row the table / --json output prints."""
    meta = run["meta"] or {}
    summary = run["summary"] or {}
    evals = run["evals"]
    rounds = run["rounds"]
    target_accs = [e["target_acc"] for e in evals]
    hist = (summary.get("metrics", {}).get("histograms", {})
            .get("round_latency_ms", {}))
    row = {
        "run_id": run["run_id"],
        "method": meta.get("method") or summary.get("method"),
        "engine": meta.get("engine") or summary.get("engine"),
        "rounds": summary.get("rounds", len(rounds) or None),
        "tap_rounds": len(rounds),
        "evals": len(evals),
        "final_target_acc": target_accs[-1] if target_accs else
        summary.get("final_target_acc"),
        "max_target_acc": max(target_accs) if target_accs else
        summary.get("max_target_acc"),
        "final_mean_participant_acc":
            evals[-1]["mean_participant_acc"] if evals else None,
        "latency_p50_ms": hist.get("p50"),
        "latency_p90_ms": hist.get("p90"),
        "latency_p99_ms": hist.get("p99"),
        "mean_link_success_rate":
            _mean([r["link_success_rate"] for r in rounds]),
        "mean_effective_neighbors":
            _mean([r["effective_neighbors"] for r in rounds]),
        "final_target_train_loss":
            rounds[-1]["train_loss"][0] if rounds and
            rounds[-1]["train_loss"] else None,
        "compiles": len(run["compiles"]),
        "compile_seconds": sum(c["seconds"] for c in run["compiles"]),
        "compile_gflops": sum(c["flops"] for c in run["compiles"]) / 1e9,
        "incomplete": run["summary"] is None,
    }
    return row


def _fmt(v: Any, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_table(rows: List[Dict[str, Any]]) -> str:
    cols = [("method", "method"), ("engine", "engine"),
            ("rounds", "rounds"), ("final_acc", "final_target_acc"),
            ("max_acc", "max_target_acc"),
            ("part_acc", "final_mean_participant_acc"),
            ("loss", "final_target_train_loss"),
            ("p50_ms", "latency_p50_ms"), ("p90_ms", "latency_p90_ms"),
            ("link_ok", "mean_link_success_rate"),
            ("eff_nbr", "mean_effective_neighbors"),
            ("compiles", "compiles")]
    table = [[h for h, _ in cols]]
    for row in rows:
        table.append([_fmt(row[key], 2 if "ms" in key else 3)
                      for _, key in cols])
    widths = [max(len(r[i]) for r in table) for i in range(len(cols))]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Validate and summarize a RunRecord JSONL file.")
    ap.add_argument("path", help="RunRecord .jsonl file")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    args = ap.parse_args(argv)

    try:
        with open(args.path) as f:
            lines = f.readlines()
    except OSError as e:
        print(f"error: cannot read {args.path}: {e}", file=sys.stderr)
        return 1

    errors = validate_jsonl_lines(lines)
    if errors:
        print(f"SCHEMA VIOLATIONS in {args.path}:", file=sys.stderr)
        for err in errors[:50]:
            print(f"  {err}", file=sys.stderr)
        if len(errors) > 50:
            print(f"  ... and {len(errors) - 50} more", file=sys.stderr)
        return 2

    runs = load_runs(lines)
    rows = [summarize_run(r) for r in runs]
    if args.json:
        print(json.dumps({"path": args.path, "runs": rows}, indent=1,
                         sort_keys=True))
        return 0

    n_events = sum(1 for ln in lines if ln.strip())
    print(f"RunRecord {args.path}: {len(runs)} run(s), {n_events} event(s)")
    print()
    print(render_table(rows))
    incomplete = [r["run_id"] for r in rows if r["incomplete"]]
    if incomplete:
        print()
        print(f"warning: {len(incomplete)} run(s) without a summary event "
              f"(aborted?): {', '.join(incomplete)}")
    total_compile = sum(r["compile_seconds"] for r in rows)
    if total_compile:
        print()
        print(f"compile time total: {total_compile:.2f}s across "
              f"{sum(r['compiles'] for r in rows)} executable(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
