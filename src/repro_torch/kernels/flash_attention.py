"""GQA attention with an online softmax: K3, forward and backward.

:func:`flash_attention` takes q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh)
in the reference's layout, with query head h = kh·G + g reading KV head
kh (G = H / KH), and returns (B, Sq, H, Dh) in q's dtype. Masks come from
positions counted from 0 on both sides: causal keeps k_pos <= q_pos, a
window keeps k_pos > q_pos − window; a fully masked row gives 0. On a CUDA
tensor it launches the hand-written kernel ``csrc/flash_attention.cu``; on
a CPU tensor it runs the plain version :func:`~repro_torch.kernels.ref.
flash_attention_ref`, which autograd differentiates. Ragged Sq and Skv are
masked in the kernel, where the reference's Pallas kernel refuses them.

On a CUDA tensor that needs a gradient, the call goes through
:class:`_FlashAttention`: its forward launches the kernel's training
instantiation, which also writes each row's log-sum-exp (B, H, Sq) fp32
(+inf for a fully masked row), and saves q, k, v, the output and that LSE;
its backward launches the three kernels of ``csrc/flash_attention_bwd.cu``
(D = rowsum(dO∘O), then dK and dV, then dQ), which recompute P from the
LSE as the reference's ``chunked_attention`` recomputes each chunk under
``jax.checkpoint``. The backward is fp32 only (the reference trains in
fp32) and raises for bf16. Nothing falls back to the plain version on a
card.

The forward multiplies on the tensor cores (``wgmma`` in TF32 with every
operand split into a big and a small TF32 part, so fp32 keeps fp32's
accuracy) and reads K and V through TMA, which needs 16-byte-aligned
bases; the wrapper raises on anything less. The backward runs fp32 FMAs
on the CUDA cores and reads plain pointers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128)
ALIGN = 16                   # bytes; TMA reads k and v from 16-byte bases
launches = 0                 # forward kernel launches since the last reset
# backward kernel launches since the last reset, by kernel
backward_launches = {"dot": 0, "dkdv": 0, "dq": 0}

_lib = None
_bwd_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_bwd_dot_launch.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.attn_bwd_dkdv_launch.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.attn_bwd_dq_launch.argtypes = [p] * 7 + [i] * 8 + [p]
        for fn in (lib.attn_bwd_dot_launch, lib.attn_bwd_dkdv_launch,
                   lib.attn_bwd_dq_launch):
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def reset_counts() -> None:
    """Set :data:`launches` and every :data:`backward_launches` to 0."""
    global launches
    launches = 0
    for name in backward_launches:
        backward_launches[name] = 0


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
            causal: bool, window: int, with_lse: bool = False):
    """One forward launch. Returns the output, or (output, LSE) with
    ``with_lse`` (the fp32 training instantiation)."""
    global launches
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned (TMA)")
    if with_lse and q.dtype != torch.float32:
        raise TypeError(f"the training forward is fp32 only, got {q.dtype}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, H, KH, Dh,
        int(causal), int(window), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return (out, lse) if with_lse else out


def _launch_backward(q, k, v, out, lse, dout, causal: bool, window: int):
    """The three backward launches; returns (dq, dk, dv)."""
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    d = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    calls = (
        ("dot", lib.attn_bwd_dot_launch,
         (dout.data_ptr(), out.data_ptr(), d.data_ptr(), B, Sq, H, Dh)),
        ("dkdv", lib.attn_bwd_dkdv_launch,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), d.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq,
          Skv, H, KH, Dh, int(causal), int(window))),
        ("dq", lib.attn_bwd_dq_launch,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), d.data_ptr(), dq.data_ptr(), B, Sq, Skv, H, KH,
          Dh, int(causal), int(window))))
    for name, fn, args in calls:
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention backward kernel {name} "
                               f"launch failed: CUDA error {rc}")
        backward_launches[name] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K3 on CUDA tensors with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.causal, ctx.window = causal, window
        if q.dtype != torch.float32:       # the backward raises for it
            ctx.save_for_backward(q)
            return _launch(q, k, v, causal, window)
        out, lse = _launch(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if saved[0].dtype != torch.float32:
            raise TypeError(f"the flash_attention backward is fp32 only, "
                            f"got {saved[0].dtype}")
        q, k, v, out, lse = saved
        dq, dk, dv = _launch_backward(q, k, v, out, lse,
                                      dout.float().contiguous(), ctx.causal,
                                      ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q over k, v (layouts above): the kernel for CUDA
    tensors, differentiable through the hand-written backward when any
    input needs a gradient; the plain version (autograd's own backward)
    for CPU tensors; an error for anything else."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)
