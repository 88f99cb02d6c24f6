"""Table III on the port: a 20-neighbour network at γ_th = 10, the same
protocol as Table II at double density (fewer samples a client, so
collaboration matters more); the port of
``benchmarks/table3_accuracy.py``.

    python3 benchmarks/torch_table3_accuracy.py [--device cpu]

It prints the card's name and power limit, one CSV line with pFedWN's
accuracy and rank, and writes the table, with each run's ms per round, to
``experiments/torch_table3.json``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (build_scenario,  # noqa: E402
                                     build_simulation, emit, parser,
                                     run_method, setup_device, timed,
                                     write_json)
from repro_torch.core.fedsim import METHODS  # noqa: E402


def run(rounds: int = 10, device: str = "cuda") -> dict:
    sc = build_scenario(20, 20, gamma_th=10.0, eps=0.1, device=device)
    sim = build_simulation(20, sc, rounds=rounds, samples=8000,
                           device=device)
    table = {"n_selected": int(sc.selected.sum()), "ms_per_round": {}}
    for m in METHODS:
        r = run_method(sim, m)
        table[m] = round(r["max_target_acc"], 4)
        table["ms_per_round"][m] = r["ms_per_round"]
    return table


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_table3.json").parse_args()
    info = setup_device(args.device)
    us, table = timed(run, device=args.device)
    write_json({**info, "table": table}, args.out)
    rank = sorted(METHODS, key=lambda m: -table[m])
    emit("torch_table3_accuracy", us,
         f"pfedwn={table['pfedwn']:.3f};rank={rank.index('pfedwn') + 1}/6;"
         f"best={rank[0]}")


if __name__ == "__main__":
    main()
