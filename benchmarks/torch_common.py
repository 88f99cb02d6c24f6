"""Shared plumbing of the port's paper-table scripts
(``benchmarks/torch_*``), ported from ``benchmarks/common.py``: the wireless
scenario and the simulation every table builds, the card set-up, and the
CSV and JSON helpers. It imports nothing of JAX and nothing of ``repro``.

Every script takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions of the kernels) and writes its table under ``experiments/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import disable_tf32, resolve_device  # noqa: E402
from repro_torch.configs import CNNConfig, WirelessConfig  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.fedsim import (FederatedSimulation,  # noqa: E402
                                     FedSimConfig)
from repro_torch.data import (dirichlet_partition,  # noqa: E402
                              make_client_datasets, synthetic_image_dataset,
                              train_test_split)


@dataclass
class Scenario:
    """One paper 'Case': a target client and its candidate neighbours with
    their channel state."""
    target_pos: np.ndarray
    neighbor_pos: np.ndarray          # (G, 2)
    p_err: np.ndarray                 # (G,)
    selected: np.ndarray              # (G,) bool


def build_scenario(seed: int, n_neighbors: int, *, gamma_th: float,
                   eps: float = 0.05, cfg: WirelessConfig = WirelessConfig(),
                   device: str | torch.device = "cuda") -> Scenario:
    """Positions from ``seed`` (numpy), neighbours selected on ``device``
    by P_err < ``eps`` at SINR threshold ``gamma_th``."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(5, cfg.area_m - 5, 2)
    neighbors = rng.uniform(0, cfg.area_m, (n_neighbors, 2))
    res = selection.select_neighbors(cfg, target, neighbors, eps=eps,
                                     sinr_threshold=gamma_th, device=device)
    return Scenario(target, neighbors, res.p_err.cpu().numpy(),
                    res.selected.cpu().numpy())


def build_simulation(seed: int, scenario: Scenario, *, rounds: int,
                     n_classes: int = 10, image_size: int = 16,
                     samples: int = 8000, alpha_d: float = 0.1,
                     lr: float = 0.05, batch: int = 32,
                     model_widths=(8, 16), hidden: int = 32,
                     noise: float = 0.35,
                     device: str | torch.device = "cuda"
                     ) -> FederatedSimulation:
    """The paper's Sec V-A setup at the reference benchmarks' scale:
    Dirichlet(0.1) non-IID synthetic data, a 75/25 split, CNN clients;
    client 0 is the target, the participants are it and the selected
    neighbours."""
    n_clients = len(scenario.neighbor_pos) + 1
    base = synthetic_image_dataset(seed, samples, image_size=image_size,
                                   n_classes=n_classes, noise=noise)
    parts = dirichlet_partition(base.y, n_clients, alpha=alpha_d, seed=seed)
    train_sets = make_client_datasets(
        base, [train_test_split(p, seed=seed + 1)[0] for p in parts])
    test_sets = make_client_datasets(
        base, [train_test_split(p, seed=seed + 1)[1] for p in parts])
    pm = np.concatenate([[True], scenario.selected])
    p_err = np.concatenate([[0.0], scenario.p_err]).astype(np.float32)
    model_cfg = CNNConfig(image_size=image_size, widths=model_widths,
                          hidden=hidden, n_classes=n_classes)
    sim = FedSimConfig(rounds=rounds, batch_size=batch, lr=lr, alpha=0.7,
                       em_iters=5, seed=seed)
    return FederatedSimulation(model_cfg, train_sets, test_sets, pm, p_err,
                               sim, device=device)


def run_method(sim: FederatedSimulation, method: str) -> dict:
    """One run: its max target accuracy and its ms per round after the
    first block (host clock, eval included; None for a single block)."""
    h = sim.run(method)
    steady = h["round_ms"][1:]
    return {"max_target_acc": h["max_target_acc"],
            "ms_per_round": float(np.mean(steady)) if steady else None}


def timed(fn, *args, **kw) -> Tuple[float, object]:
    """(µs of one call, its result). The reference's ``timed`` runs a
    warm-up call first for ``jit``; the port compiles nothing, so the
    call that gives the result is the timed one."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return (time.perf_counter() - t0) * 1e6, out


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")


def parser(description: str, out: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--out", default=out, help="where the JSON table goes")
    return p


def setup_device(device: str) -> dict:
    """Resolve ``device`` (raises for cuda without a card), keep fp32
    products in fp32 on the card, and name the card: ``nvidia-smi``'s
    name and power limit, printed and returned."""
    dev = resolve_device(device)
    info = {"device": str(dev)}
    if dev.type == "cuda":
        disable_tf32()
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(line)
        info["card"] = line
    return info


def write_json(obj: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
