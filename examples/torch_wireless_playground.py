"""Fig 4 analogue on the port: P_err of each neighbour's link for three
SINR thresholds, with an ASCII map of the area (T the target, S a selected
neighbour, x one left out); the port of ``examples/wireless_playground.py``.
It runs the channel model and the selection only.

    python3 examples/torch_wireless_playground.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import WirelessConfig  # noqa: E402
from repro_torch.core import selection  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(p.parse_args().device)
    cfg = WirelessConfig()
    rng = np.random.default_rng(7)
    target = np.array([25.0, 25.0])
    neighbors = rng.uniform(0, 50, (10, 2))

    for gamma_th in (5.0, 10.0, 15.0):
        res = selection.select_neighbors(cfg, target, neighbors, eps=0.05,
                                         sinr_threshold=gamma_th, device=dev)
        p_err = res.p_err.cpu().numpy()
        sel = res.selected.cpu().numpy()
        print(f"\n== gamma_th = {gamma_th}:  {sel.sum()} selected ==")
        grid = [["." for _ in range(25)] for _ in range(25)]
        tx, ty = int(target[0] // 2), int(target[1] // 2)
        grid[ty][tx] = "T"
        for i, (x, y) in enumerate(neighbors):
            gx, gy = int(x // 2), int(y // 2)
            grid[gy][gx] = "S" if sel[i] else "x"
        for row in grid[::-1]:
            print("".join(row))
        for i, (pe, s) in enumerate(zip(p_err, sel)):
            print(f"  n{i}: P_err={pe:.3f} {'<- selected' if s else ''}")


if __name__ == "__main__":
    main()
