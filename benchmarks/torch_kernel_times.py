"""K1 (the port's fused EM E-step), K2 (the Eq-1 mix), K3's forward and
its backward timed on the card, taken from the port under a given
``src/`` directory: this checkout's by default, or another checkout's
(say an older commit unpacked with ``git archive``), so that two versions
can be set side by side in one run on one card.

    python3 benchmarks/torch_kernel_times.py [--src OTHER/src]
        [--bwd-splits 1,2,3,4,6]

It builds that port's kernels (into that port's own build directory) and
times, with ``chip_smoke.py``'s ``k1_times`` and ``k2_times`` (steady and
cold ms, the plain version's ms, the bound, the error against the plain
version; K2 also ``torch.addmv``'s ms), K1 at the pFedWN round's shape and
at smollm-135m's vocabulary, fp32 and bf16, and K2 on a random
cifar10-cnn stack (P = 188,810, fp32) at the round's M = 10; then K1 and
K2 at M = 39, which a port that caps M at 32 refuses (recorded as
refused). Then K3's backward with ``k3_bwd_times`` (steady, cold and
per-kernel ms, the bounds, SDPA's fp32 backward on the same inputs) at
smollm-135m's training shape (B 8 x S 256) and the federated run's (B 4 x
S 128), and with ``--bwd-splits 1,2,...`` at the training shape with
those dK/dV split counts; a port without a backward is recorded as
absent, and the three-kernel backward that preceded the split-TF32 one
is driven through its own C entry points. K3's forward is timed at
smollm-135m's prefill (Dh 64), minicpm3-4b's (Dh 96), granite-moe's
(H 24 over KH 8, Dh 64) and zamba2-7b's (H 32, Dh 112), fp32 and bf16 (a
port that refuses a head dim is
recorded as refusing it), and at granite-moe's shape also with
``chip_smoke.attention_report`` (cold ms, the bounds, the plain version,
SDPA under each backend, the error against the plain version). It prints
the card's name and power limit, then one JSON line with the card's
floor, a 1-element ``zero_()`` in the same bracket. It needs a CUDA card
and checks nothing else.
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


def _three_kernel_calls(k3):
    """The backward launches of a port whose ``flash_attention_bwd.cu`` has
    the three CUDA-core kernels (D, dK/dV, dQ) and no
    ``_backward_launches``, as ``k3_bwd_times`` takes them."""
    def calls(q, k, v, out, lse, dout, causal, window):
        lib = k3._bwd_library()
        B, Sq, H, Dh = q.shape
        Skv, KH = k.shape[1], k.shape[2]
        d = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        masks = (int(causal), int(window))
        args = {"dot": (lib.attn_bwd_dot_launch, (dout, out, d),
                        (B, Sq, H, Dh)),
                "dkdv": (lib.attn_bwd_dkdv_launch,
                         (q, k, v, dout, lse, d, dk, dv),
                         (B, Sq, Skv, H, KH, Dh) + masks),
                "dq": (lib.attn_bwd_dq_launch, (q, k, v, dout, lse, d, dq),
                       (B, Sq, Skv, H, KH, Dh) + masks)}

        def launcher(fn, tensors, ints):
            def launch():
                stream = torch.cuda.current_stream().cuda_stream
                if fn(*(t.data_ptr() for t in tensors), *ints, stream):
                    raise RuntimeError("backward launch failed")
            return launch
        return [(name, launcher(*a)) for name, a in args.items()]
    return calls


def k3_backward(dev, splits=()) -> list:
    """K3's backward at the training and federated shapes, or why not; then
    at the training shape with each dK/dV split count of ``splits`` in
    place of the plan's (a port with the split only)."""
    from repro_torch.kernels import flash_attention as k3
    if not hasattr(k3, "_bwd_library"):
        return [{"absent": "this port has no K3 backward"}]
    calls = None if hasattr(k3, "_backward_launches") else \
        _three_kernel_calls(k3)
    rows = [chip_smoke.k3_bwd_times(dev, shape, k3, calls)
            for shape in (chip_smoke.BWD_MAIN, chip_smoke.BWD_FED)]
    for n in splits if calls is None else ():
        row = chip_smoke.k3_bwd_times(
            dev, chip_smoke.BWD_MAIN, k3,
            lambda *a, n=n: k3._backward_launches(*a, splits=n)[1])
        rows.append({"splits": n, **row})
    return rows


def k3_forward(dev) -> list:
    """K3's forward (serving instantiation) at smollm-135m's,
    minicpm3-4b's, granite-moe's and zamba2-7b's prefill shapes, fp32 and
    bf16: steady ms (and in fp32 the max error against the plain
    version), or why the port refuses the shape."""
    from repro_torch.kernels import flash_attention as k3
    rows = []
    for shape in (chip_smoke.ATTN_MAIN, chip_smoke.ATTN_MLA,
                  chip_smoke.ATTN_GRANITE, chip_smoke.ATTN_SSM):
        causal, window = shape[6], shape[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = chip_smoke._attn_inputs(shape, dtype, dev)
            row = {"shape": shape, "dtype": str(dtype)[6:]}
            try:
                row["ms"] = chip_smoke.time_ms(
                    lambda: k3._launch(q, k, v, causal, window))
            except RuntimeError as e:     # the library refuses the head dim
                row["refused"] = str(e)
            else:
                if dtype == torch.float32:
                    row["max_abs_err"] = _attention_error(dev, shape)
            rows.append(row)
    return rows


def _attention_error(dev, shape) -> float:
    """max |K3 − plain| in fp32 at ``shape``."""
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = chip_smoke._attn_inputs(shape, torch.float32, dev)
    out = k3._launch(q, k, v, shape[6], shape[7])
    ref = flash_attention_ref(q, k, v, causal=shape[6], window=shape[7])
    return float((out - ref).abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the src/ directory whose repro_torch to time")
    parser.add_argument("--bwd-splits", default="",
                        help="comma-separated dK/dV split counts to time K3's "
                        "backward with at the training shape, beside the "
                        "plan's")
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
    secs = _build.build(_build.KERNELS)
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
    k3_fwd = k3_forward(dev)
    granite = chip_smoke.attention_report(
        dev, chip_smoke.ATTN_GRANITE, None, None, floor,
        "granite-moe-3b-a800m prefill, timed alone")
    granite["max_abs_err"] = _attention_error(dev, chip_smoke.ATTN_GRANITE)
    k3_bwd = k3_backward(dev, [int(n) for n in args.bwd_splits.split(",")
                               if n])
    print(card_line)
    print(json.dumps({"src": str(src), "build_s": secs, "floor_ms": floor,
                      "k1": k1, "k2": k2, "k3_forward": k3_fwd,
                      "k3_granite": granite,
                      "k3_backward": k3_bwd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
