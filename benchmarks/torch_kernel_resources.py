"""Registers, spills and shared memory of CUDA kernels, as ``nvcc -Xptxas
-v`` reports them when a source is compiled with the flags the port builds
its kernels with (``repro_torch.kernels._build.NVCC_FLAGS``).

    python3 benchmarks/torch_kernel_resources.py [--match TEXT] [SRC.cu ...]

Without sources it reports every ``src/repro_torch/kernels/csrc/*.cu``;
given sources (for example an older checkout's), it reports those. One
JSON line per kernel instantiation, with its demangled name; ``--match``
keeps the names that contain TEXT. It needs ``nvcc`` (the machine with the
card) and launches nothing.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?"
                   r"(?:, \d+ bytes cumulative stack size)?"
                   r"(?:, (\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


def _demangle(names):
    tool = Path(_build._nvcc()).with_name("cu++filt")
    tool = str(tool) if tool.exists() else shutil.which("c++filt")
    if not tool:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def resources(sources):
    """Compile each source (all at once, one nvcc each) and return one dict
    per kernel: source, kernel, registers, barriers, smem bytes (static),
    stack frame and spill bytes."""
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"k{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, src in enumerate(sources)]
        rows = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{out}")
            row = None
            for line in out.splitlines():
                if m := _ENTRY.search(line):
                    row = {"source": str(src), "kernel": m.group(1)}
                    rows.append(row)
                elif row is not None and (m := _SPILL.search(line)):
                    row.update(stack_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
                elif row is not None and (m := _USED.search(line)):
                    row.update(registers=int(m.group(1)),
                               barriers=int(m.group(2) or 0),
                               smem_bytes=int(m.group(3) or 0))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
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
