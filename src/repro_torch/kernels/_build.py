"""Builds the CUDA kernels from ``csrc/`` at first use and loads them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into ``build/lib<name>-<hash>.so`` beside this file,
where ``<hash>`` covers the source, every header of the package
(``csrc/*.cuh``, which the sources include) and the flags, so an edited
source or header rebuilds and an unchanged one loads from the cache. Only
the package's own sources are built. :func:`build` starts one ``nvcc`` per
source, all together, and waits for them; each build also keeps ptxas's
report (``-Xptxas -v``) beside its library, which :func:`resources` reads:
every kernel's registers, spills and shared memory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("em_posterior", "weighted_agg", "flash_attention",
           "flash_attention_bwd", "flash_attention_bf16",
           "flash_attention_bwd_bf16")

_loaded: Dict[str, ctypes.CDLL] = {}

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?"
                   r"(?:, \d+ bytes cumulative stack size)?"
                   r"(?:, (\d+) bytes smem)?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed on its source, the
    package's headers and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def report_path(name: str) -> Path:
    """ptxas's report of the build of ``csrc/<name>.cu``, beside its
    library."""
    return library_path(name).with_suffix(".ptxas")


def build(names: List[str] | tuple = KERNELS) -> float:
    """Compile every named kernel that is not cached yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent; raises
    with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names
            if not (library_path(n).exists() and report_path(n).exists())]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            report_path(name).write_text(out)
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def parse_ptxas(text: str) -> List[dict]:
    """The kernels in ``nvcc -Xptxas -v`` output ``text``, in order: each
    one's (mangled) name, registers, barriers, static shared memory bytes,
    and stack frame and spill bytes."""
    rows, row = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            row = {"kernel": m.group(1)}
            rows.append(row)
        elif row is not None and (m := _SPILL.search(line)):
            row.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif row is not None and (m := _USED.search(line)):
            row.update(registers=int(m.group(1)),
                       barriers=int(m.group(2) or 0),
                       smem_bytes=int(m.group(3) or 0))
    return rows


def demangle(names: List[str]) -> List[str]:
    """``names`` demangled by ``cu++filt`` beside ``nvcc`` (or
    ``c++filt``); as they are if neither is there."""
    tool = Path(_nvcc()).with_name("cu++filt")
    tool = str(tool) if tool.exists() else shutil.which("c++filt")
    if not tool:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def resources(name: str) -> List[dict]:
    """Every kernel of ``csrc/<name>.cu`` as ptxas reported it when the
    source was built (building it if needed): :func:`parse_ptxas`'s rows,
    with demangled names."""
    build([name])
    rows = parse_ptxas(report_path(name).read_text())
    for row, kernel in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = kernel
    return rows
