"""GQA attention forward with an online softmax: K3.

:func:`flash_attention` takes q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh)
in the reference's layout, with query head h = kh·G + g reading KV head
kh (G = H / KH), and returns (B, Sq, H, Dh) in q's dtype. Masks come from
positions counted from 0 on both sides: causal keeps k_pos <= q_pos, a
window keeps k_pos > q_pos − window; a fully masked row gives 0. On a CUDA
tensor it launches the hand-written kernel ``csrc/flash_attention.cu``; on
a CPU tensor it runs the plain version :func:`~repro_torch.kernels.ref.
flash_attention_ref`. Ragged Sq and Skv are masked in the kernel, where
the reference's Pallas kernel refuses them. Forward only: the reference
has no backward kernel either.

The kernel multiplies on the tensor cores (``wgmma`` in TF32 with every
operand split into a big and a small TF32 part, so fp32 keeps fp32's
accuracy) and reads K and V through TMA, which needs 16-byte-aligned
bases; the wrapper raises on anything less.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128)
ALIGN = 16                   # bytes; TMA reads k and v from 16-byte bases
launches = 0                 # kernel launches since the last reset

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, Dh) and k, v (B, Skv, KH, "
                         f"Dh); got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    KH = k.shape[2]
    if min(B, Sq, k.shape[1], H, KH) < 1 or H % KH:
        raise ValueError(f"H = {H} query heads over KH = {KH} KV heads: "
                         "need 1 <= KH, H % KH == 0 and non-empty sequences")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh}; the kernel takes {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int) -> torch.Tensor:
    global launches
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned (TMA)")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, KH, Dh, int(causal), int(window), int(q.dtype == torch.bfloat16),
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q over k, v (layouts above): the kernel for CUDA
    tensors, the plain version for CPU tensors, an error for anything
    else. No autograd."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _launch(q, k, v, causal, window)
