"""K1 (the port's fused EM E-step) timed on the card, taken from the port
under a given ``src/`` directory: this checkout's by default, or another
checkout's (say an older commit unpacked with ``git archive``), so that two
versions of K1 can be set side by side in one run on one card.

    python3 benchmarks/torch_k1_times.py [--src OTHER/src]

It builds that port's ``em_posterior.cu`` (into that port's own build
directory), times K1 at the pFedWN round's shape and at smollm-135m's
vocabulary, fp32 and bf16, with ``chip_smoke.py``'s ``k1_times`` (steady
and cold ms, the plain version's ms, the bound and the share of it, the
error against the plain version), and the card's floor, a 1-element
``zero_()`` in the same bracket. It prints the card's name and power limit,
then one JSON line. It needs a CUDA card and checks nothing else.
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src/ directory whose repro_torch to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_times: no CUDA device", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    if src not in Path(_build.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {_build.__file__}, not "
                           f"{src}")
    secs = _build.build(("em_posterior",))
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    floor = chip_smoke.floor_ms(dev)
    rows = [chip_smoke.k1_times(dev, shape, dtype)
            for shape in (chip_smoke.EM_MAIN, chip_smoke.EM_VOCAB)
            for dtype in (torch.float32, torch.bfloat16)]
    print(card_line)
    print(json.dumps({"src": str(src), "build_s": secs, "floor_ms": floor,
                      "k1": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
