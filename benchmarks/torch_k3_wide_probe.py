"""K3's kernels at head dim 192 (deepseek-v3's MLA), fp32 and bf16, built
in variants and timed against each other on one card.

    python3 benchmarks/torch_k3_wide_probe.py [--parent OTHER/src]
        [--dtype fp32|bf16|both] [--only NAME,...] [--longer] [--out FILE]

For each dtype, the variants: this checkout's two sources of that dtype
(``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` in fp32,
``csrc/flash_attention_bf16.cu`` and ``csrc/flash_attention_bwd_bf16.cu``
in bf16) as they are ("as built"); copies of them rewritten by
``PATCHES`` (bf16) and ``FP32_PATCHES``: the Dh 192 kernels' blocks in
the other order (in bf16 the tile the grid's slowest axis, "row tile
slowest": the forward's, dK/dV's and dQ's block decode and dQ's grid; in
fp32, "other block order", the forward and dQ head-major and dK/dV the
tile slowest); in fp32 one product of S (S^T, dP^T) and of P.V (dV, dK,
dQ) in flight at a time ("one product in flight", where the kernels keep
two); in bf16 the forward's consumer warpgroups not taking turns at the
tensor cores ("no ping-pong"); and with ``--parent``, another checkout's
two sources as they are. A variant is named "<dtype>: <name>". A patch
whose text is not found once in the source fails the variant's build. For each variant it reports the Dh 192
kernels' registers and spills (``-Xptxas -v``,
``torch_kernel_resources.py``), loads the two libraries under this
checkout's wrapper, checks the forward and backward against their plain
versions at a few ragged shapes (fp32: the forward within 2e-6 atol and
rtol of the plain version, its training instantiation's output bitwise
the serving one's, the backward within 1e-5 of float64; bf16: 2e-2 of
the plain bf16 values; the backward twice, bitwise), and times the
serving and training forward at deepseek-v3's prefill (``chip_smoke.
ATTN_DS``) and each backward kernel at its training step
(``chip_smoke.BWD_DS``) with ``chip_smoke.time_ms``; with ``--longer``
also at the same token counts with more tiles a block (``LONGER_FWD``,
``LONGER_BWD``). The variants are timed in turn, then again in the
reverse order. It prints the card's name and power limit, then one JSON
line (also written to ``--out``). It needs ``nvcc`` and a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402
from torch_kernel_resources import resources  # noqa: E402

SOURCES = {"bf16": ("flash_attention_bf16", "flash_attention_bwd_bf16"),
           "fp32": ("flash_attention", "flash_attention_bwd")}
FWD, BWD = (f"{n}.cu" for n in SOURCES["bf16"])
FWD32, BWD32 = (f"{n}.cu" for n in SOURCES["fp32"])
# the block decode that makes a head's blocks neighbours, and its
# replacement with the tile as the grid's slowest axis (bf16 dK/dV and
# fp32 dK/dV share it; the forwards share theirs)
_FWD_HEAD_MAJOR = ("""  const int head = blockIdx.x / tiles;
  const int rt = tiles - 1 - static_cast<int>(blockIdx.x % tiles);
""", """  const int heads = gridDim.x / tiles;
  const int head = blockIdx.x % heads;
  const int rt = tiles - 1 - static_cast<int>(blockIdx.x / heads);
""")
_DKDV_HEAD_MAJOR = ("""  const int kt = id % n_kt, head = id / n_kt;
""", """  const int kt = id / (B * KH), head = id % (B * KH);
""")
# (source, text, its replacement) a variant makes in a copy of csrc/: the
# bf16 variants, then the fp32 ones
PATCHES = {
    "as built": [],
    "row tile slowest": [
        (FWD, *_FWD_HEAD_MAJOR),
        (BWD, *_DKDV_HEAD_MAJOR),
        (BWD, """  const int b = (kWide ? blockIdx.y : blockIdx.x) / KH;
  const int kh = (kWide ? blockIdx.y : blockIdx.x) % KH;
  const int n_rows = Sq * G;
  const int row0 = (kWide ? gridDim.x - 1 - blockIdx.x
                          : gridDim.y - 1 - blockIdx.y) * kRowTile;
""", """  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int n_rows = Sq * G;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRowTile;
"""),
        (BWD, """  const dim3 grid = kWide ? dim3(static_cast<unsigned>(tiles), B * KH)
                         : dim3(B * KH, static_cast<unsigned>(tiles));
""", """  const dim3 grid(B * KH, static_cast<unsigned>(tiles));
""")],
    "no ping-pong": [
        (FWD, """  const auto turn = [&] { named_sync<kCons>(2 + wg); };
  const auto pass = [&](bool last) {
    if (wg == 0 || !last) named_arrive<kCons>(3 - wg);
  };
  if (wg == 1 && n > 0) named_arrive<kCons>(2);
""", """  const auto turn = [] {};
  const auto pass = [](bool) {};
""")]}
FP32_PATCHES = {
    "as built": [],
    # the forward and dQ launch the row tile slowest and dK/dV head-major:
    # each in the other order
    "other block order": [
        (FWD32, _FWD_HEAD_MAJOR[1], _FWD_HEAD_MAJOR[0]),
        (BWD32, *_DKDV_HEAD_MAJOR),
        (BWD32, """  const int b = (blockIdx.x % (B * H)) / H, h = blockIdx.x % H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / (B * H))) *
                 kRowTile;
""", """  const int b = (blockIdx.x / n_qt) / H, h = (blockIdx.x / n_qt) % H;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * kRowTile;
""")],
    # every part of S (S^T, dP^T) and every column product waited for
    # before the next is issued
    "one product in flight": [
        (FWD32, """    issue(p);
    wgmma_wait<1>();  // part p - 1
""", """    wgmma_wait<0>();
    issue(p);
"""),
        (FWD32, """      issue_pv(c);
      wgmma_wait<1>();  // product c - 1
""", """      wgmma_wait<0>();
      issue_pv(c);
"""),
        (BWD32, """    issue(p);
    wgmma_wait<1>();  // part p - 1
""", """    wgmma_wait<0>();
    issue(p);
"""),
        (BWD32, """    issue(c);
    wgmma_wait<1>();  // chunk c - 1
""", """    wgmma_wait<0>();
    issue(c);
""")]}
VARIANTS = {"bf16": PATCHES, "fp32": FP32_PATCHES}
# ragged shapes at Dh 192: G 1 and 3, keys off the 64- and 112-key tiles, a
# window, fully masked rows
CHECKS = [(2, 300, 300, 4, 4, 192, True, 0),
          (1, 113, 111, 6, 2, 192, True, 0),
          (1, 130, 97, 3, 1, 192, False, 40),
          (1, 77, 50, 16, 1, 192, False, 20)]


def build(csrc: Path, patches, out: Path, dtype: str) -> tuple:
    """``dtype``'s two sources of ``csrc`` (a copy with ``patches`` made,
    if any) built into ``out``: (the libraries' paths, the Dh 192 kernels'
    resources)."""
    out.mkdir(parents=True, exist_ok=True)
    if patches:
        copy = out / "csrc"
        shutil.copytree(csrc, copy)
        for name, old, new in patches:
            text = (copy / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"patch not found once in {name}:\n{old}")
            (copy / name).write_text(text.replace(old, new))
        csrc = copy
    rows = resources([csrc / f"{n}.cu" for n in SOURCES[dtype]], keep=out)
    wide = [r for r in rows if "192" in r["kernel"] or "wide" in r["kernel"]]
    return [out / f"k{i}.so" for i in range(len(SOURCES[dtype]))], wide


def use(paths, dtype: str) -> None:
    """Load ``paths`` (``dtype``'s forward and backward libraries) under
    this checkout's wrapper."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k3
    for name, path in zip(SOURCES[dtype], paths):
        _build._loaded[name] = ctypes.CDLL(str(path))
        k3._libs.pop(name, None)


def _within(got, want, tol) -> bool:
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def check(dev, dtype: str) -> dict:
    """max |d| of the loaded kernels against the plain versions (fp32: the
    forward against the plain fp32 version, the backward against the
    float64 plain backward; bf16: both against the plain bf16 versions),
    whether every gate held, and whether two backward runs gave the same
    bits."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import ref
    bf16 = dtype == "bf16"
    fwd_tol, bwd_tol = (2e-2, 2e-2) if bf16 else (
        chip_smoke.ATTN_TOL[torch.float32], chip_smoke.BWD_TOL)
    worst = {"fwd": 0.0, "bwd": 0.0, "bitwise": True, "ok": True}
    for shape in CHECKS:
        causal, window = shape[6], shape[7]
        q, k, v, dout = chip_smoke._bwd_inputs(
            shape, dev, dtype=torch.bfloat16 if bf16 else torch.float32)
        out = k3._launch(q, k, v, causal, window)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window).float()
        worst["fwd"] = max(worst["fwd"],
                           float((out.float() - want).abs().max()))
        worst["ok"] &= _within(out.float(), want, fwd_tol)
        out32, lse = k3._launch(q, k, v, causal, window, with_lse=True)
        if not bf16:   # the training instantiation's output is the serving
            worst["ok"] &= torch.equal(out32, out)
        first = k3._launch_backward(q, k, v, out32, lse, dout, causal,
                                    window)
        second = k3._launch_backward(q, k, v, out32, lse, dout, causal,
                                     window)
        if bf16:
            plain = ref.flash_attention_bwd_bf16_ref(
                q, k, v, out32, lse, dout, causal=causal, window=window)
        else:
            q64, k64, v64 = q.double(), k.double(), v.double()
            plain = ref.flash_attention_bwd_ref(
                q64, k64, v64, ref.flash_attention_ref(
                    q64, k64, v64, causal=causal, window=window),
                ref.attention_lse_ref(q64, k64, causal=causal,
                                      window=window),
                dout.double(), causal=causal, window=window)
        for got, again, mine in zip(first, second, plain):
            mine = mine.double()
            worst["bwd"] = max(worst["bwd"], float(
                (got.double() - mine).abs().max()))
            worst["ok"] &= _within(got.double(), mine, bwd_tol)
            worst["bitwise"] &= torch.equal(got, again)
    torch.cuda.synchronize()
    return worst


# the same tokens as ATTN_DS and BWD_DS with more tiles a block: the
# prefill without the causal mask and at S 2048 (B 4), the training step
# at S 1024 (B 2); they split a block's time into a fixed part and a part
# a tile
LONGER_FWD = [(8, 1024, 1024, 128, 128, 192, False, 0),
              (4, 2048, 2048, 128, 128, 192, True, 0)]
LONGER_BWD = [(2, 1024, 1024, 128, 128, 192, True, 0)]


def _backward_ms(dev, shape, dtype) -> dict:
    from repro_torch.kernels import flash_attention as k3
    q, k, v, dout = chip_smoke._bwd_inputs(shape, dev, dtype=dtype)
    out, lse = k3._launch(q, k, v, shape[6], shape[7], with_lse=True)
    _, launches = k3._backward_launches(q, k, v, out, lse, dout, shape[6],
                                        shape[7])
    row = {"kernel_ms": {n: chip_smoke.time_ms(f, iters=10)
                         for n, f in launches}}

    def bwd():
        for _, launch in launches:
            launch()
    row["ms"] = chip_smoke.time_ms(bwd, iters=10)
    return row


def times(dev, dtype: str, longer=False) -> dict:
    """The loaded kernels' steady ms at ``ATTN_DS`` (serving and training
    forward) and ``BWD_DS`` (each backward kernel, and all of them); with
    ``longer`` also at ``LONGER_FWD`` and ``LONGER_BWD``."""
    from repro_torch.kernels import flash_attention as k3
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    iters = 5 if dtype == "bf16" else 3
    shape = chip_smoke.ATTN_DS
    causal, window = shape[6], shape[7]
    q, k, v = chip_smoke._attn_inputs(shape, tdtype, dev)
    row = {"forward_ms": chip_smoke.time_ms(
        lambda: k3._launch(q, k, v, causal, window), iters=iters),
        "training_forward_ms": chip_smoke.time_ms(
        lambda: k3._launch(q, k, v, causal, window, with_lse=True),
        iters=iters)}
    del q, k, v
    bwd = _backward_ms(dev, chip_smoke.BWD_DS, tdtype)
    row["backward_kernel_ms"], row["backward_ms"] = bwd["kernel_ms"], bwd["ms"]
    if longer:
        for shape in LONGER_FWD:
            q, k, v = chip_smoke._attn_inputs(shape, tdtype, dev)
            row[f"forward_ms {shape}"] = chip_smoke.time_ms(
                lambda: k3._launch(q, k, v, shape[6], shape[7]),
                iters=iters)
            del q, k, v
        for shape in LONGER_BWD:
            row[f"backward {shape}"] = _backward_ms(dev, shape, tdtype)
    torch.cuda.empty_cache()
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout's src/ whose sources to "
                        "build as they are and time beside")
    parser.add_argument("--dtype", choices=("fp32", "bf16", "both"),
                        default="both")
    parser.add_argument("--only", default="",
                        help="comma-separated variant names to run, "
                        "without the dtype (all by default)")
    parser.add_argument("--longer", action="store_true",
                        help="also time the shapes with more tiles a block")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import disable_tf32
    disable_tf32()
    dev = torch.device("cuda")
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    dtypes = ("fp32", "bf16") if args.dtype == "both" else (args.dtype,)
    keep = args.only.split(",") if args.only else None
    variants = {}   # "<dtype>: <name>" -> (dtype, csrc, patches)
    for dtype in dtypes:
        if args.parent is not None:
            variants[f"{dtype}: parent"] = (
                dtype, args.parent.resolve() / "repro_torch" / "kernels"
                / "csrc", [])
        for name, patches in VARIANTS[dtype].items():
            variants[f"{dtype}: {name}"] = (dtype, csrc, patches)
    if keep is not None:
        variants = {n: v for n, v in variants.items()
                    if n.split(": ", 1)[1] in keep}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    report, libs = {}, {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        builds = {name: pool.submit(build, src, patches,
                                    Path(tmp) / f"v{i}", dtype)
                  for i, (name, (dtype, src, patches)) in enumerate(
                      variants.items())}
        for name, (dtype, _, _) in variants.items():
            try:                          # every variant builds at once
                paths, wide = builds[name].result()
            except RuntimeError as e:     # keep the compiler's word
                report[name] = {"build_error": str(e)[-4000:]}
                print(name, "build failed", str(e)[-4000:], flush=True)
                continue
            use(paths, dtype)
            libs[name] = (paths, dtype)
            report[name] = {"resources": wide,
                            "check": check(dev, dtype), "times": []}
            print(name, json.dumps(report[name]["check"]), flush=True)
        order = list(libs)
        for name in order + order[::-1]:
            paths, dtype = libs[name]
            use(paths, dtype)
            report[name]["times"].append(times(dev, dtype, args.longer))
            print(name, json.dumps(report[name]["times"][-1]), flush=True)
    print(card)
    line = json.dumps({"card": card, "variants": report})
    print(line)
    if args.out is not None:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
