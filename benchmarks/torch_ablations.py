"""Beyond-paper ablations on the port, each isolating one pFedWN mechanism;
the port of ``benchmarks/ablations.py``:

  A1  EM weights against uniform weights over the same selected neighbours
      (``FedSimConfig.em_uniform``);
  A2  channel-aware selection against a random selection of the same count,
      erasures following the true P_err;
  A3  robustness as every link's failure probability is swept;
  A4  the α sweep of Eq (1).

Each runs on a data-poor target (``restrict_target_train``) on a harder
task (noise 0.8), where collaboration is what local training lacks.

    python3 benchmarks/torch_ablations.py [--device cpu]

It prints the card's name and power limit, one CSV line an ablation, and
writes the results to ``experiments/torch_ablations.json``.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (build_scenario,  # noqa: E402
                                     build_simulation, emit, parser,
                                     setup_device, timed, write_json)

ROUNDS = 8


def _scenario(device, seed):
    return build_scenario(seed, 10, gamma_th=5.0, eps=0.15, device=device)


def _sim(device, seed=11, sc=None):
    """The harder task in ``seed``'s scenario (or in ``sc``), the target
    kept to the first 48 samples of its train set (its test set whole)."""
    sc = _scenario(device, seed) if sc is None else sc
    sim = build_simulation(seed, sc, rounds=ROUNDS, noise=0.8, device=device)
    sim.restrict_target_train(48)
    return sc, sim


def a1_em_vs_uniform(device) -> dict:
    """pFedWN, then the same data and seed with uniform π (still
    erasure-masked): 'FedAvg over the selected neighbours with an
    α-blend'."""
    _, sim = _sim(device)
    em_acc = sim.run("pfedwn")["max_target_acc"]
    _, sim_u = _sim(device)
    sim_u.sim.em_uniform = True
    uni_acc = sim_u.run("pfedwn")["max_target_acc"]
    return {"em": em_acc, "uniform": uni_acc, "delta": em_acc - uni_acc}


def a2_selection_vs_random(device) -> dict:
    """The same neighbour count, picked at random instead of by P_err;
    erasures follow the true P_err, so random picks take unreliable
    links."""
    sc, sim = _sim(device, seed=13)
    chan_acc = sim.run("pfedwn")["max_target_acc"]
    rng = np.random.default_rng(0)
    n_sel = max(int(sc.selected.sum()), 1)
    rand_sel = np.zeros_like(sc.selected)
    rand_sel[rng.choice(len(sc.selected), n_sel, replace=False)] = True
    _, sim2 = _sim(device, 13,
                   dataclasses.replace(sc, selected=rand_sel))
    rand_acc = sim2.run("pfedwn")["max_target_acc"]
    return {"channel_aware": chan_acc, "random": rand_acc,
            "delta": chan_acc - rand_acc, "n_selected": n_sel}


def a3_erasure_robustness(device) -> dict:
    """A uniform per-link failure probability f, swept."""
    sc = _scenario(device, 17)
    out = {}
    for f in (0.0, 0.3, 0.6, 0.9):
        scf = dataclasses.replace(sc, p_err=np.full_like(sc.p_err, f))
        _, sim = _sim(device, 17, scf)
        out[f] = sim.run("pfedwn")["max_target_acc"]
    return out


def a4_alpha_sweep(device) -> dict:
    out = {}
    for alpha in (0.3, 0.5, 0.7, 0.9):
        _, sim = _sim(device, seed=19)
        sim.sim.alpha = alpha
        out[alpha] = sim.run("pfedwn")["max_target_acc"]
    return out


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_ablations.json").parse_args()
    info = setup_device(args.device)
    us1, r1 = timed(a1_em_vs_uniform, args.device)
    emit("torch_ablation_em_vs_uniform", us1,
         f"em={r1['em']:.3f};uniform={r1['uniform']:.3f};"
         f"delta={r1['delta']:+.3f}")
    us2, r2 = timed(a2_selection_vs_random, args.device)
    emit("torch_ablation_selection", us2,
         f"channel={r2['channel_aware']:.3f};random={r2['random']:.3f};"
         f"delta={r2['delta']:+.3f}")
    us3, r3 = timed(a3_erasure_robustness, args.device)
    emit("torch_ablation_erasures", us3,
         ";".join(f"f{k}={v:.3f}" for k, v in r3.items()))
    us4, r4 = timed(a4_alpha_sweep, args.device)
    emit("torch_ablation_alpha", us4,
         ";".join(f"a{k}={v:.3f}" for k, v in r4.items()))
    write_json({**info, "a1_em_vs_uniform": r1,
                "a2_selection_vs_random": r2,
                "a3_erasure_robustness": {str(k): v for k, v in r3.items()},
                "a4_alpha_sweep": {str(k): v for k, v in r4.items()}},
               args.out)


if __name__ == "__main__":
    main()
