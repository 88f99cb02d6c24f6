"""Registers, spills and shared memory of CUDA kernels, as ``nvcc -Xptxas
-v`` reports them when a source is compiled with the flags the port builds
its kernels with (``repro_torch.kernels._build.NVCC_FLAGS``).

    python3 benchmarks/torch_kernel_resources.py [--match TEXT] [SRC.cu ...]

Without sources it reports every ``src/repro_torch/kernels/csrc/*.cu``;
given sources (for example an older checkout's), it reports those. One
JSON line per kernel instantiation, with its demangled name; ``--match``
keeps the names that contain TEXT. It needs ``nvcc`` (the machine with the
card) and launches nothing. The port's own build keeps the same report
(``_build.resources``); this script compiles any source, and
:func:`resources` can keep the built libraries in a directory
(``benchmarks/torch_k3_wide_probe.py`` builds and loads variants so).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402


def resources(sources, keep=None):
    """Compile each source (all at once, one nvcc each, with the port's
    flags) and return one dict per kernel: source, demangled kernel name,
    registers, barriers, smem bytes (static), stack frame and spill bytes.
    With ``keep`` (a directory) source i's library stays there as
    ``k<i>.so``."""
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(keep or tmp)
        procs = [(src, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out_dir / f"k{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, src in enumerate(sources)]
        rows = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{out}")
            rows += [{"source": str(src), **row}
                     for row in _build.parse_ptxas(out)]
    for row, name in zip(rows, _build.demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--match", default="",
                        help="keep kernels whose demangled name has this")
    args = parser.parse_args()
    sources = args.sources or [_build.CSRC / f"{n}.cu"
                               for n in _build.KERNELS]
    for row in resources(sources):
        if args.match in row["kernel"]:
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
