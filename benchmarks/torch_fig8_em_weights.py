"""Fig 8 on the port: the EM weights π settle, and the neighbour with the
data most like the target's gets the largest weight; the port of
``benchmarks/fig8_em_weights.py``.

    python3 benchmarks/torch_fig8_em_weights.py [--device cpu]

It prints the card's name and power limit and one CSV line (late movement
of π below early movement, the top weight, and where the top-weighted
neighbour ranks by label overlap with the target), and writes the result,
with π at each eval point, to ``experiments/torch_fig8.json``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (build_scenario,  # noqa: E402
                                     build_simulation, emit, parser,
                                     setup_device, timed, write_json)
from repro_torch.core.fedsim import FederatedSimulation  # noqa: E402


def em_summary(sim: FederatedSimulation, pis: List[np.ndarray]) -> Dict:
    """From π at each eval point: the movement of π over the first and the
    last step (convergence), the top weight at the end, and the rank of its
    neighbour when the neighbours are sorted by the overlap of their label
    histogram with the target's (0: the most similar data)."""
    pis = np.stack(pis)                          # (evals, M)
    early = float(np.abs(pis[1] - pis[0]).sum()) if len(pis) > 1 else 0.0
    late = float(np.abs(pis[-1] - pis[-2]).sum()) if len(pis) > 2 else 0.0
    n_classes = sim.model_cfg.n_classes
    t_hist = np.bincount(sim.train_sets[0].y,
                         minlength=n_classes).astype(float)
    t_hist /= t_hist.sum()
    overlaps = []
    for nid in sim.neighbor_idx:
        h_n = np.bincount(sim.train_sets[nid].y,
                          minlength=n_classes).astype(float)
        h_n /= h_n.sum()
        overlaps.append(float(np.minimum(t_hist, h_n).sum()))
    top_pi = int(np.argmax(pis[-1]))
    rank_of_top = (int(np.argsort(overlaps)[::-1].tolist().index(top_pi))
                   if overlaps else -1)
    return {"early_move": early, "late_move": late,
            "top_pi_weight": float(pis[-1].max()),
            "top_pi_overlap_rank": rank_of_top,
            "n_neighbors": len(overlaps)}


def run(rounds: int = 8, device: str = "cuda") -> dict:
    sc = build_scenario(3, 10, gamma_th=5.0, eps=0.2, device=device)
    sim = build_simulation(3, sc, rounds=rounds, device=device)
    h = sim.run("pfedwn")
    return {**em_summary(sim, h["pi"]),
            "pi": [p.tolist() for p in h["pi"]],
            "ms_per_round": h["round_ms"]}


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_fig8.json").parse_args()
    info = setup_device(args.device)
    us, res = timed(run, device=args.device)
    write_json({**info, "fig8": res}, args.out)
    settled = res["late_move"] <= res["early_move"] + 1e-6
    emit("torch_fig8_em_weights", us,
         f"late<{'early' if settled else 'EARLY!'};"
         f"top_pi={res['top_pi_weight']:.2f};"
         f"overlap_rank={res['top_pi_overlap_rank']}/{res['n_neighbors']}")


if __name__ == "__main__":
    main()
