"""Table II on the port: max test accuracy of the target client in a
10-neighbour network, all six methods, across the three wireless cases
(γ_th ∈ {5, 10, 15}); the port of ``benchmarks/table2_accuracy.py``.

    python3 benchmarks/torch_table2_accuracy.py [--device cpu]

The paper's claims it checks, as the reference's script does: pFedWN ≥
FedAvg in each case, and pFedWN within 0.02 of Local or above it. It
prints the card's name and power limit, one CSV line (``name,us,derived``)
and writes the table, with each run's ms per round, to
``experiments/torch_table2.json``.
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

CASES = {"case1": 5.0, "case2": 10.0, "case3": 15.0}


def run(rounds: int = 10, device: str = "cuda") -> dict:
    table = {}
    for case, gamma in CASES.items():
        sc = build_scenario(int(gamma), 10, gamma_th=gamma, eps=0.1,
                            device=device)
        sim = build_simulation(int(gamma), sc, rounds=rounds, device=device)
        table[case] = {"n_selected": int(sc.selected.sum()),
                       "ms_per_round": {}}
        for m in METHODS:
            r = run_method(sim, m)
            table[case][m] = round(r["max_target_acc"], 4)
            table[case]["ms_per_round"][m] = r["ms_per_round"]
    return table


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_table2.json").parse_args()
    info = setup_device(args.device)
    us, table = timed(run, device=args.device)
    wins = sum(table[c]["pfedwn"] >= table[c]["fedavg"] for c in CASES)
    beats_local = sum(table[c]["pfedwn"] >= table[c]["local"] - 0.02
                      for c in CASES)
    write_json({**info, "table": table}, args.out)
    c1 = table["case1"]
    emit("torch_table2_accuracy", us,
         f"pfedwn>=fedavg:{wins}/3;pfedwn~>=local:{beats_local}/3;"
         f"case1:pfedwn={c1['pfedwn']:.3f},local={c1['local']:.3f},"
         f"fedavg={c1['fedavg']:.3f}")


if __name__ == "__main__":
    main()
