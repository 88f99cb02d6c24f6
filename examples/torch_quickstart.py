"""Quickstart on the PyTorch + CUDA port: the pFedWN pipeline at toy scale.

1. place a target and 10 candidate neighbours in a 50×50 m ISM-band area,
2. compute each link's transmission error probability (Sec III-B),
3. ε-select the PFL neighbours (Algorithm 1),
4. run pFedWN rounds against Local and FedAvg on non-IID synthetic data,
5. print the EM collaboration weights π*.

    python3 examples/torch_quickstart.py               # on the card
    python3 examples/torch_quickstart.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import disable_tf32, resolve_device  # noqa: E402
from repro_torch.configs import CNNConfig, WirelessConfig  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.fedsim import (FederatedSimulation,  # noqa: E402
                                     FedSimConfig)
from repro_torch.data import (dirichlet_partition,  # noqa: E402
                              make_client_datasets, synthetic_image_dataset,
                              train_test_split)

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)
if dev.type == "cuda":
    disable_tf32()

# --- 1-3: wireless layer ---------------------------------------------------
rng = np.random.default_rng(0)
target = rng.uniform(10, 40, 2)
neighbors = rng.uniform(0, 50, (10, 2))
res = selection.select_neighbors(WirelessConfig(), target, neighbors,
                                 eps=0.1, sinr_threshold=10.0, device=dev)
p_err_nb, selected = res.p_err.cpu().numpy(), res.selected.cpu().numpy()
print("P_err per neighbor:", np.round(p_err_nb, 3))
print("selected neighbors:", np.where(selected)[0].tolist())

# --- 4: learning layer -----------------------------------------------------
base = synthetic_image_dataset(0, 5000, image_size=16, n_classes=10)
parts = dirichlet_partition(base.y, 11, alpha=0.1, seed=0)
train_sets = make_client_datasets(
    base, [train_test_split(p, seed=1)[0] for p in parts])
test_sets = make_client_datasets(
    base, [train_test_split(p, seed=1)[1] for p in parts])
pm = np.concatenate([[True], selected])
p_err = np.concatenate([[0.0], p_err_nb]).astype(np.float32)

sim = FederatedSimulation(
    CNNConfig(image_size=16, widths=(8, 16), hidden=32),
    train_sets, test_sets, pm, p_err,
    FedSimConfig(rounds=6, batch_size=32, lr=0.05, alpha=0.7), device=dev)

for method in ["local", "fedavg", "pfedwn"]:
    h = sim.run(method)
    extra = f"  pi*={np.round(h['pi'][-1], 2)}" if method == "pfedwn" else ""
    print(f"{method:8s} target max acc: {h['max_target_acc']:.3f}{extra}")
