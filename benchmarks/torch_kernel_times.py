"""K1 (the port's fused EM E-step) and K2 (the Eq-1 mix) timed on the
card, taken from the port under a given ``src/`` directory: this
checkout's by default, or another checkout's (say an older commit unpacked
with ``git archive``), so that two versions can be set side by side in one
run on one card.

    python3 benchmarks/torch_kernel_times.py [--src OTHER/src]

It builds that port's ``em_posterior.cu`` and ``weighted_agg.cu`` (into
that port's own build directory) and times, with ``chip_smoke.py``'s
``k1_times`` and ``k2_times`` (steady and cold ms, the plain version's ms,
the bound, the error against the plain version; K2 also ``torch.addmv``'s
ms), K1 at the pFedWN round's shape and at smollm-135m's vocabulary, fp32
and bf16, and K2 on a random cifar10-cnn stack (P = 188,810, fp32) at the
round's M = 10; then K1 and K2 at M = 39, which a port that caps M at 32
refuses (recorded as refused). It prints the card's name and power limit,
then one JSON line with the card's floor, a 1-element ``zero_()`` in the
same bracket. It needs a CUDA card and checks nothing else.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402

P_CIFAR = 188_810


def _k2(dev, M):
    g = torch.Generator(device=dev).manual_seed(M)
    stack = torch.randn((M + 1, P_CIFAR), generator=g, device=dev)
    pi = torch.softmax(torch.randn(M, generator=g, device=dev), 0)
    return chip_smoke.k2_times(dev, stack, pi, 0.7)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src/ directory whose repro_torch to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build
    if src not in Path(_build.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {_build.__file__}, not "
                           f"{src}")
    secs = _build.build(("em_posterior", "weighted_agg"))
    disable_tf32()
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    floor = chip_smoke.floor_ms(dev)
    k1 = [chip_smoke.k1_times(dev, shape, dtype)
          for shape in (chip_smoke.EM_MAIN, chip_smoke.EM_VOCAB)
          for dtype in (torch.float32, torch.bfloat16)]
    k2 = [_k2(dev, 10)]
    try:
        k1 += [chip_smoke.k1_times(dev, chip_smoke.EM_WIDE, dtype)
               for dtype in (torch.float32, torch.bfloat16)]
        k2.append(_k2(dev, 39))
    except ValueError as e:          # a port that caps the components
        k1.append({"shape": chip_smoke.EM_WIDE, "refused": str(e)})
        k2.append({"shape": {"M": 39, "P": P_CIFAR}, "refused": str(e)})
    print(card_line)
    print(json.dumps({"src": str(src), "build_s": secs, "floor_ms": floor,
                      "k1": k1, "k2": k2}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
