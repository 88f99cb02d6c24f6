"""Fig 1 on the port: the target client's accuracy under the FedAvg global
model against local training, on non-IID Dirichlet(0.1) splits (11 clients
in the paper); the port of ``benchmarks/fig1_gap.py``.

    python3 benchmarks/torch_fig1_gap.py [--device cpu]

It prints the card's name and power limit, one CSV line with the two
accuracies and their gap, and writes them, with each run's ms per round,
to ``experiments/torch_fig1.json``.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (build_scenario,  # noqa: E402
                                     build_simulation, emit, parser,
                                     setup_device, timed, write_json)


def run(rounds: int = 8, device: str = "cuda") -> dict:
    sc = build_scenario(0, 10, gamma_th=5.0, eps=0.2,   # wide ε: most join
                        device=device)
    sim = build_simulation(0, sc, rounds=rounds, device=device)
    local = sim.run("local")
    fedavg = sim.run("fedavg")
    return {
        "local_max": local["max_target_acc"],
        "fedavg_max": fedavg["max_target_acc"],
        "gap": local["max_target_acc"] - fedavg["max_target_acc"],
        "fedavg_mean_participants": fedavg["mean_participant_acc"][-1],
        "ms_per_round": {"local": local["round_ms"],
                         "fedavg": fedavg["round_ms"]},
    }


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_fig1.json").parse_args()
    info = setup_device(args.device)
    us, res = timed(run, device=args.device)
    write_json({**info, "fig1": res}, args.out)
    emit("torch_fig1_gap", us,
         f"local={res['local_max']:.3f};fedavg={res['fedavg_max']:.3f};"
         f"gap={res['gap']:.3f}")


if __name__ == "__main__":
    main()
