"""The port's kernel build cache (``repro_torch/kernels/_build.py``): a
library's path is keyed on its source, the package's shared headers
(``csrc/*.cuh``) and the flags, so an edited header rebuilds every source
instead of loading a stale library; and the split-TF32 helpers live in
one header that K3's fp32 forward and backward both include, the bf16
helpers in another that its bf16 kernels include; ptxas's report, which
each build keeps, parses into every kernel's registers and spills; and
the Dh 192 probe's source rewrites still find their text. CPU only:
nothing is compiled."""
import re

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text("// first\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_library_path_follows_the_source(csrc):
    first = _build.library_path("k")
    assert _build.library_path("k") == first          # unchanged: cached
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k2;\n')
    assert _build.library_path("k") != first


@pytest.mark.parametrize("edit", ["change", "add", "remove"])
def test_library_path_follows_every_header(csrc, edit):
    first = _build.library_path("k")
    if edit == "change":
        (csrc / "h.cuh").write_text("// second\n")
    elif edit == "add":
        (csrc / "g.cuh").write_text("")
    else:
        (csrc / "h.cuh").unlink()
    assert _build.library_path("k") != first
    assert _build.library_path("k").parent == _build.BUILD_DIR


def test_k3_sources_share_the_split_tf32_helpers():
    header = _build.CSRC / "wgmma_tf32.cuh"
    helpers = ("kmajor", "desc", "split", "split4", "wgmma_ss_n32",
               "wgmma_ss_n64", "wgmma_rs_n64", "mbar_wait", "tma_load_3d")
    defined = re.compile(r"__device__ __forceinline__ \w+ (\w+)\(")
    assert set(helpers) <= set(defined.findall(header.read_text()))
    for name in ("flash_attention", "flash_attention_bwd"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "wgmma_tf32.cuh"' in src
        assert not set(helpers) & set(defined.findall(src))


def test_k3_bf16_sources_share_the_bf16_helpers():
    """K3's bf16 forward and backward take the swizzled layout, its
    descriptors and the bf16 ``wgmma`` wrappers from one header, which
    takes the mbarrier and TMA helpers from the split-TF32 one."""
    header = _build.CSRC / "wgmma_bf16.cuh"
    helpers = ("swizzled", "kstep", "desc_k", "desc_mn", "pack_bf16",
               "tma_tile", "load_folded", "wgmma_ss_bf16_n128",
               "wgmma_rs_bf16_n128", "wgmma_rs_bf16_n112")
    shared = ("sees", "visible", "all_visible", "block_min", "mbar_wait",
              "tma_load_3d")
    defined = re.compile(r"__device__ __forceinline__ \w+ (\w+)\(")
    text = header.read_text()
    assert set(helpers) <= set(defined.findall(text))
    assert '#include "wgmma_tf32.cuh"' in text
    tf32 = set(defined.findall((_build.CSRC / "wgmma_tf32.cuh").read_text()))
    assert set(shared) <= tf32
    # store2 is overloaded for bf16 there, not defined twice
    assert tf32 & set(defined.findall(text)) == {"store2"}
    for name in ("flash_attention_bf16", "flash_attention_bwd_bf16"):
        assert name in _build.KERNELS
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "wgmma_bf16.cuh"' in src
        assert not (set(helpers) | tf32) & set(defined.findall(src))


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1ai' for 'sm_90a'
ptxas info    : Function properties for _Z1ai
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    56 bytes stack frame, 52 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 240 registers, 56 bytes cumulative stack size, \
1024 bytes smem, 400 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_kernels_report(csrc):
    """The build keeps ptxas's report beside each library; its parser
    gives every kernel's registers, barriers, static shared memory and
    spills, in the report's order."""
    assert _build.parse_ptxas(PTXAS) == [
        {"kernel": "_Z1ai", "stack_bytes": 0, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "registers": 168, "barriers": 1,
         "smem_bytes": 0},
        {"kernel": "_Z1bv", "stack_bytes": 56, "spill_store_bytes": 52,
         "spill_load_bytes": 48, "registers": 240, "barriers": 0,
         "smem_bytes": 1024}]
    assert _build.report_path("k").parent == _build.BUILD_DIR
    assert _build.report_path("k").stem == _build.library_path("k").stem


@pytest.mark.parametrize("variant", ["row tile slowest", "no ping-pong"])
def test_k3_wide_probe_patches_find_their_text_once(variant):
    """``benchmarks/torch_k3_wide_probe.py`` builds its variants of K3's
    bf16 kernels at Dh 192 by rewriting copies of the sources; each
    rewrite's text stands exactly once in the sources as they are, so the
    variant builds and differs only where it says."""
    import importlib
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "benchmarks"))
    probe = importlib.import_module("torch_k3_wide_probe")
    patches = probe.PATCHES[variant]
    assert patches
    for name, old, new in patches:
        assert (_build.CSRC / name).read_text().count(old) == 1
        assert old != new


@pytest.mark.parametrize("variant", ["other block order",
                                     "one product in flight"])
def test_k3_wide_probe_fp32_patches_find_their_text_once(variant):
    """The probe's variants of K3's fp32 kernels at Dh 192 likewise: each
    rewrite's text stands exactly once in the sources as they are."""
    import importlib
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "benchmarks"))
    probe = importlib.import_module("torch_k3_wide_probe")
    patches = probe.FP32_PATCHES[variant]
    assert patches
    for name, old, new in patches:
        assert (_build.CSRC / name).read_text().count(old) == 1
        assert old != new
