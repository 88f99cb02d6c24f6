"""Whether two versions of a CUDA source compile to the same machine code,
kernel by kernel.

    python3 benchmarks/torch_sass_diff.py OLD.cu NEW.cu [OLD2.cu NEW2.cu ...]

Each source is compiled to a cubin with the port's flags
(``repro_torch.kernels._build.NVCC_FLAGS``, ``-cubin`` in place of
``-shared``) and its SASS dumped with ``cuobjdump -sass``. Kernels are
matched by demangled name with ``float`` template arguments dropped (so a
kernel that lost an element-type parameter fixed at ``float`` matches its
old self), and each instruction is compared with its addresses and symbol
notes stripped. Prints one line a pair: the kernels in each build, how many
match instruction for instruction, how many differ, and the new build's
kernels with no counterpart, then their names. It needs ``nvcc`` and
``cuobjdump`` (the machine with the card) and launches nothing. Exits 1 if
any matched kernel differs or a new kernel has no counterpart.
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);")


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).with_name(name))


def sass(source: Path) -> dict:
    """{mangled kernel name: [instruction, ...]} of ``source``'s cubin."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(source)], check=True)
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        if m := _FUNCTION.match(line):
            current = kernels.setdefault(m.group(1), [])
        elif current is not None and (m := _INSTRUCTION.match(line)):
            current.append(re.sub(r'\(\*"[^"]*"\*\)', "", m.group(1)).strip())
    return kernels


def key(mangled: str) -> str:
    """The demangled name without its return type, parameter list,
    ``float`` template arguments and ``(int)``/``(bool)`` casts."""
    name = subprocess.run([_tool("cu++filt"), mangled], capture_output=True,
                          text=True, check=True).stdout.strip()
    for drop in ("float, ", "<float>", "(int)", "(bool)"):
        name = name.replace(drop, "")
    return re.sub(r"\(.*\)$", "", name).removeprefix("void ")


def main() -> int:
    paths = [Path(p) for p in sys.argv[1:]]
    if not paths or len(paths) % 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    ok = True
    for old_src, new_src in zip(paths[::2], paths[1::2]):
        old = {key(k): v for k, v in sass(old_src).items()}
        new = {key(k): v for k, v in sass(new_src).items()}
        same = [k for k in new if old.get(k) == new[k]]
        differ = [k for k in new if k in old and old[k] != new[k]]
        unmatched = [k for k in new if k not in old]
        print(f"{old_src} -> {new_src}: {len(old)} kernels before, "
              f"{len(new)} after; identical {len(same)}, different "
              f"{len(differ)}, no counterpart {len(unmatched)}")
        for k in differ + unmatched:
            print(f"  {'differs' if k in differ else 'new'}: {k}")
        ok = ok and not differ and not unmatched
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
