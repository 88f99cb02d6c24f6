"""Fig 5 on the port: the mean number of selected neighbours against the
number of sub-channels |F|, the SINR threshold γ_th and the density of the
Poisson point process that places the nodes; the port of
``benchmarks/fig5_neighbors.py``.

    python3 benchmarks/torch_fig5_neighbors.py [--device cpu]

The reference draws draw i's positions from ``jax.random.PRNGKey(i)``; the
port draws them from a ``torch.Generator`` seeded with i, whose bits
differ. So the counts here agree with the reference's only qualitatively:
the same process, other samples of it. What must hold is the trends that
:func:`check_trends` scores, as in the reference. Given the same positions,
the selection is the reference's (``tests/test_torch_figures.py``).

It prints the card's name and power limit and one CSV line with the share
of settings where each trend holds, and writes the mean counts to
``experiments/torch_fig5.json``.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmarks.torch_common import (emit, parser, setup_device,  # noqa: E402
                                     timed, write_json)
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import WirelessConfig  # noqa: E402
from repro_torch.core import selection, wireless  # noqa: E402


def avg_selected(cfg: WirelessConfig, density: float, gamma_th: float,
                 iters: int = 20, max_nodes: int = 40,
                 device: str = "cuda") -> float:
    """The mean count of valid nodes selected (P_err < 0.05) around a
    target at the area's centre, over ``iters`` PPP draws."""
    dev = resolve_device(device)
    counts = []
    for i in range(iters):
        gen = torch.Generator(device=dev).manual_seed(i)
        pos, valid = wireless.ppp_positions(gen, cfg, density, max_nodes)
        target = [cfg.area_m / 2, cfg.area_m / 2]
        res = selection.select_neighbors(cfg, target, pos, valid, eps=0.05,
                                         sinr_threshold=gamma_th, device=dev)
        counts.append(int(torch.sum(res.selected & valid)))
    return float(np.mean(counts))


def run(device: str = "cuda") -> dict:
    out = {}
    for gamma_th in (5.0, 10.0, 15.0):
        for F in (8, 14, 20):
            cfg = dataclasses.replace(WirelessConfig(), n_subchannels=F)
            for density in (1e-3, 4e-3, 7.5e-3):
                out[(gamma_th, F, density)] = avg_selected(
                    cfg, density, gamma_th, iters=8, device=device)
    return out


def check_trends(res: dict) -> dict:
    """The paper's claims: more sub-channels select more; a higher γ_th
    selects fewer. The share of settings where each holds."""
    f_up, g_down, n = 0, 0, 0
    for g in (5.0, 10.0, 15.0):
        for d in (1e-3, 4e-3, 7.5e-3):
            if res[(g, 20, d)] >= res[(g, 8, d)]:
                f_up += 1
            n += 1
    for F in (8, 14, 20):
        for d in (1e-3, 4e-3, 7.5e-3):
            if res[(15.0, F, d)] <= res[(5.0, F, d)]:
                g_down += 1
    return {"F_monotone_frac": f_up / n, "gamma_monotone_frac": g_down / 9}


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_fig5.json").parse_args()
    info = setup_device(args.device)
    us, res = timed(run, device=args.device)
    tr = check_trends(res)
    write_json({**info, "trends": tr,
                "mean_selected": {f"g{k[0]}_F{k[1]}_d{k[2]}": v
                                  for k, v in res.items()}}, args.out)
    emit("torch_fig5_neighbors", us,
         f"F_up={tr['F_monotone_frac']:.2f};"
         f"gdown={tr['gamma_monotone_frac']:.2f};"
         f"sel(g5,F14,d4e-3)={res[(5.0, 14, 4e-3)]:.1f}")


if __name__ == "__main__":
    main()
