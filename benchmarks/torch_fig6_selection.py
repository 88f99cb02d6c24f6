"""Fig 6 on the port: selected neighbours |M_n| against candidate
neighbours |G_n| for error thresholds ε (a) and SINR thresholds γ_th (b);
the port of ``benchmarks/fig6_selection.py``. The positions come from
numpy seeds, as in the reference, so the counts are the reference's.

    python3 benchmarks/torch_fig6_selection.py [--device cpu]

It prints the card's name and power limit and one CSV line with the share
of network sizes where each trend holds, and writes the mean counts to
``experiments/torch_fig6.json``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.torch_common import (build_scenario, emit,  # noqa: E402
                                     parser, setup_device, timed,
                                     write_json)


def run(device: str = "cuda") -> dict:
    out = {}
    for G in (5, 10, 15, 20):
        for eps in (0.01, 0.05, 0.1):
            sel = [int(build_scenario(s, G, gamma_th=10.0, eps=eps,
                                      device=device).selected.sum())
                   for s in range(6)]
            out[("eps", G, eps)] = float(np.mean(sel))
        for gth in (5.0, 10.0, 15.0):
            sel = [int(build_scenario(s, G, gamma_th=gth, eps=0.05,
                                      device=device).selected.sum())
                   for s in range(6)]
            out[("gth", G, gth)] = float(np.mean(sel))
    return out


def check_trends(res: dict) -> dict:
    """The paper's claims: a looser ε selects more; a higher γ_th selects
    fewer. The share of network sizes where each holds."""
    eps_ok = sum(res[("eps", G, 0.1)] >= res[("eps", G, 0.01)]
                 for G in (5, 10, 15, 20)) / 4
    gth_ok = sum(res[("gth", G, 5.0)] >= res[("gth", G, 15.0)]
                 for G in (5, 10, 15, 20)) / 4
    return {"eps_monotone": eps_ok, "gth_monotone": gth_ok}


def main() -> None:
    args = parser(__doc__.split("\n")[0],
                  "experiments/torch_fig6.json").parse_args()
    info = setup_device(args.device)
    us, res = timed(run, device=args.device)
    tr = check_trends(res)
    write_json({**info, "trends": tr,
                "mean_selected": {f"{k[0]}_G{k[1]}_{k[2]}": v
                                  for k, v in res.items()}}, args.out)
    emit("torch_fig6_selection", us,
         f"eps_mono={tr['eps_monotone']:.2f};"
         f"gth_mono={tr['gth_monotone']:.2f};"
         f"sel(G10,eps.05,g10)={res[('gth', 10, 10.0)]:.1f}")


if __name__ == "__main__":
    main()
