"""End to end on the PyTorch port: train a ~100M-class LM
(smollm-135m's reduced profile at CI scale; pass --full for the real 135M
config) for a few hundred steps, then run pFedWN rounds between simulated
LM clients. The counterpart of ``examples/federated_lm.py``; its
checkpoint goes to ``experiments/torch_smollm_ckpt.npz``, so the
reference's file is never overwritten.

PYTHONPATH=src python examples/torch_federated_lm.py [--steps 200] [--full]
    [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--full", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

src = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")
env = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
common = ["--arch", "smollm-135m", "--device", args.device]
if args.full:
    common.append("--full")
base = [sys.executable, "-m", "repro_torch.launch.train", *common,
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--lr", "3e-3", "--ckpt", "experiments/torch_smollm_ckpt.npz"]
print(">>> single-client LM training", flush=True)
subprocess.run(base, check=True, env=env)

print(">>> pFedWN federated rounds (4 clients)", flush=True)
subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common,
                "--clients", "4", "--rounds", "5", "--local-steps", "10",
                "--batch", "4", "--seq", "128"], check=True, env=env)
