"""The EM E-step with cross-entropy fused in (paper Eq 9): K1.

:func:`em_posterior` returns λ (T, M), the posterior over components, and
ℓ (T, M), the per-sample cross-entropy ℓ = logsumexp_V(logits) − label
logit, from π (M,), component logits (M, T, V) and labels (T,). On a CUDA
tensor it launches the hand-written kernel ``csrc/em_posterior.cu``; on a
CPU tensor it runs the plain version :func:`~repro_torch.kernels.ref.
em_posterior_ref`. Ragged T and V are fine. :func:`plan` picks the
kernel's team of lanes a row, its vector width and its token tile from the
shape, the logits' alignment and the kernel's tuning (its vectors a lane
and threads a block, which the built library reports). Any number of
components M ≥ 1 is taken, as the reference takes it.

It is differentiable in the logits through ℓ only: λ is marked
non-differentiable, and ℓ's backward is ct·(softmax_V(logits) − onehot(y)),
in plain PyTorch (the reference has no backward kernel either). The EM
``min_weight`` floor is applied by the caller, after the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import em_posterior_ref
from repro_torch.kernels.weighted_agg import vector_bytes

launches = 0                 # kernel launches since the last reset

_lib = None
_limits = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("em_posterior")
        lib.em_posterior_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.em_posterior_launch.restype = ctypes.c_int
        lib.em_posterior_limits.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.em_posterior_limits.restype = None
        _lib = lib
    return _lib


def kernel_limits() -> Tuple[int, int]:
    """The built kernel's tuning: (vectors a lane holds a chunk, a
    block's threads at most)."""
    global _limits
    if _limits is None:
        vectors, threads = ctypes.c_int(), ctypes.c_int()
        _library().em_posterior_limits(ctypes.byref(vectors),
                                       ctypes.byref(threads))
        _limits = (vectors.value, threads.value)
    return _limits


def _check(pi: torch.Tensor, logits: torch.Tensor,
           labels: torch.Tensor) -> None:
    if logits.dim() != 3:
        raise ValueError(f"logits must be (M, T, V), got {tuple(logits.shape)}")
    M, T, V = logits.shape
    if M < 1 or T < 1 or V < 1:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if pi.shape != (M,) or pi.dtype != torch.float32:
        raise ValueError(f"pi must be ({M},) float32, got {tuple(pi.shape)} "
                         f"{pi.dtype}")
    if labels.shape != (T,) or labels.dtype != torch.int64:
        raise ValueError(f"labels must be ({T},) int64, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    for name, t in (("pi", pi), ("logits", logits), ("labels", labels)):
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class Plan(NamedTuple):
    team: int           # lanes a (t, m) row, a power of two up to 32
    vector_bytes: int   # bytes a load moves
    tile: int           # tokens a block (times M rows)
    threads: int        # threads a block


def plan(M: int, T: int, V: int, dtype: torch.dtype, address: int,
         n_sms: int, lane_vectors: int, max_threads: int) -> Plan:
    """How a kernel that holds ``lane_vectors`` vectors a lane a chunk in
    blocks of at most ``max_threads`` threads splits (M, T, V) logits at
    ``address`` on a card with ``n_sms`` SMs: the widest vector that the
    address and a row's bytes share (so every row starts on one); the
    fewest lanes a row (a power of two, at most a warp) whose vectors
    cover the row in one chunk; and the fewest tokens a block that keep the
    grid of ceil(T / tile) blocks within one block per SM, as long as the
    tile's rows fit ``max_threads``. Past M = ``max_threads`` the tile is
    one token, whose M rows the kernel stages in its outputs rather than
    in shared memory."""
    elem = torch.finfo(dtype).bits // 8
    vb = vector_bytes((address,), V * elem, dtype)
    per_lane = lane_vectors * vb // elem         # elements a lane a chunk
    team = min(32, 1 << max(0, math.ceil(V / per_lane) - 1).bit_length())
    tile = max(1, min(-(-T // n_sms), max_threads // (M * team)))
    threads = min(max_threads, -(-tile * M * team // 32) * 32)
    return Plan(team, vb, tile, threads)


def _launch(pi: torch.Tensor, logits: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    M, T, V = logits.shape
    p = plan(M, T, V, logits.dtype, logits.data_ptr(),
             torch.cuda.get_device_properties(
                 logits.device).multi_processor_count, *kernel_limits())
    lam = torch.empty((T, M), dtype=torch.float32, device=logits.device)
    ell = torch.empty((T, M), dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = _library().em_posterior_launch(
        pi.data_ptr(), logits.data_ptr(), labels.data_ptr(), lam.data_ptr(),
        ell.data_ptr(), M, T, V, int(logits.dtype == torch.bfloat16),
        p.team, p.vector_bytes, p.tile, p.threads, stream)
    if rc != 0:
        raise RuntimeError(f"em_posterior kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return lam, ell


def em_posterior_forward(pi: torch.Tensor, logits: torch.Tensor,
                         labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ, ℓ) without autograd: the kernel for CUDA tensors, the plain
    version for CPU tensors, and an error for anything else."""
    _check(pi, logits, labels)
    if logits.device.type == "cpu":
        return em_posterior_ref(pi, logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(f"no em_posterior for device {logits.device}")
    return _launch(pi, logits, labels)


class _EMPosterior(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pi, logits, labels):
        lam, ell = em_posterior_forward(pi, logits, labels)
        ctx.save_for_backward(logits, labels)
        ctx.mark_non_differentiable(lam)
        return lam, ell

    @staticmethod
    def backward(ctx, _g_lam, g_ell):
        logits, labels = ctx.saved_tensors
        g = torch.softmax(logits.float(), dim=-1)              # (M, T, V)
        idx = labels[None, :, None].expand(g.shape[0], -1, 1)
        g = g.scatter_add(2, idx, torch.full_like(idx, -1, dtype=g.dtype))
        g = g * g_ell.T[:, :, None]
        return None, g.to(logits.dtype), None


def em_posterior(pi: torch.Tensor, logits: torch.Tensor,
                 labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ, ℓ), both (T, M) fp32; differentiable in ``logits`` through ℓ."""
    return _EMPosterior.apply(pi, logits, labels)
