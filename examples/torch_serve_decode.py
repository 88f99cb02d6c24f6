"""Serving example on the PyTorch port: batched prefill + greedy decode
with a KV cache (a latent cache for MLA, per-layer states for Mamba) on a
selectable architecture.

    python3 examples/torch_serve_decode.py --arch starcoder2-15b
    python3 examples/torch_serve_decode.py --arch minicpm3-4b --full
    python3 examples/torch_serve_decode.py --arch falcon-mamba-7b

Reduced widths by default; ``--full`` for the published config. Runs on
the card unless given ``--device cpu``.
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="starcoder2-15b")
ap.add_argument("--full", action="store_true")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

src = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")
env = dict(os.environ, PYTHONPATH=os.pathsep.join(
    p for p in (src, os.environ.get("PYTHONPATH")) if p))
cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", args.arch,
       "--batch", "4", "--prompt-len", "64", "--gen", "32",
       "--device", args.device]
if args.full:
    cmd.append("--full")
subprocess.run(cmd, check=True, env=env)
