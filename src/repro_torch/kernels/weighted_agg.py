"""The erasure-gated Eq-1 mix over flat parameter buffers: K2.

:func:`weighted_agg` returns α·own + (1−α)·Σ_m w_m·nb_m, accumulated in
fp32 and cast to own's dtype (fp32 or bf16), where nb_m is row
``index[m]`` of ``neighbors`` (every row in order when ``index`` is None).
Where ``any_ok`` is False it returns ``own``. Both ``w`` and ``any_ok`` are
device tensors, so the round decides the all-links-failed case without a
host sync, and the neighbour rows are read in place from the stacked client
buffer without materialising an (M, P) gather.

On a CUDA tensor it launches the hand-written kernel
``csrc/weighted_agg.cu``; on a CPU tensor it runs the plain version
:func:`~repro_torch.kernels.ref.weighted_agg_ref`; on a ``meta`` tensor
(the dry run's) it returns the result's shape and dtype only. On every
device a :class:`~repro_torch.roofline.counter.CostCounter` counts the
mix by :func:`cost`. Row numbers in
``index`` are not read on the host (that would sync); callers build them
from host-validated client indices. Any number of neighbours M ≥ 0 is taken,
in one launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weighted_agg_ref
from repro_torch.roofline import counter

# vector widths in bytes the kernel is instantiated for, widest first
VECTOR_BYTES = {torch.float32: (16, 8, 4), torch.bfloat16: (16, 8, 4, 2)}
launches = 0                 # kernel launches since the last reset
bf16_launches = 0            # of those, launches on bf16 buffers
last_grid = 0                # blocks in the last launch

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("weighted_agg")
        lib.weighted_agg_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.weighted_agg_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(own, neighbors, w, index, any_ok) -> int:
    if own.dim() != 1 or neighbors.dim() != 2:
        raise ValueError(f"own must be (P,) and neighbors (R, P), got "
                         f"{tuple(own.shape)} and {tuple(neighbors.shape)}")
    if own.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"own must be float32 or bfloat16, got {own.dtype}")
    if neighbors.dtype != own.dtype:
        raise TypeError(f"neighbors are {neighbors.dtype}, own {own.dtype}")
    if neighbors.shape[1] != own.shape[0]:
        raise ValueError(f"neighbors have {neighbors.shape[1]} params, own "
                         f"{own.shape[0]}")
    if not own.is_contiguous() or neighbors.stride(1) != 1:
        raise ValueError("own and each neighbor row must be contiguous")
    M = neighbors.shape[0] if index is None else index.shape[0]
    if w.shape != (M,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w must be contiguous ({M},) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if index is not None and (index.dim() != 1 or index.dtype != torch.int64
                              or not index.is_contiguous()):
        raise ValueError("index must be a contiguous (M,) int64 tensor")
    if any_ok is not None and (any_ok.shape != () or
                               any_ok.dtype != torch.bool):
        raise ValueError("any_ok must be a 0-d bool tensor")
    for name, t in (("neighbors", neighbors), ("w", w), ("index", index),
                    ("any_ok", any_ok)):
        if t is not None and t.device != own.device:
            raise ValueError(f"{name} is on {t.device}, own on {own.device}")
    return M


def vector_bytes(addresses, row_stride_bytes: int,
                 dtype: torch.dtype) -> int:
    """The widest vector, in bytes, that the kernel can move for ``dtype``
    when every address in ``addresses`` (own, out and the neighbour stack's
    base) and the row stride in bytes are multiples of it: then every
    neighbour row starts on a vector too, whichever rows ``index`` picks."""
    for vb in VECTOR_BYTES[dtype]:
        if row_stride_bytes % vb == 0 and all(a % vb == 0 for a in addresses):
            return vb
    raise ValueError(f"{dtype} buffers must be aligned to their element "
                     f"size; got addresses {list(addresses)} and a row "
                     f"stride of {row_stride_bytes} bytes")


def _launch(own, neighbors, w, alpha, index, any_ok, M) -> torch.Tensor:
    global launches, bf16_launches, last_grid
    P = own.shape[0]
    out = torch.empty_like(own)
    vb = vector_bytes((own.data_ptr(), out.data_ptr(), neighbors.data_ptr()),
                      neighbors.stride(0) * own.element_size(), own.dtype)
    stream = torch.cuda.current_stream(own.device).cuda_stream
    grid = ctypes.c_int(0)
    rc = _library().weighted_agg_launch(
        own.data_ptr(), neighbors.data_ptr(), neighbors.stride(0),
        None if index is None else index.data_ptr(), w.data_ptr(),
        None if any_ok is None else any_ok.data_ptr(), out.data_ptr(), M, P,
        float(alpha), float(1 - alpha), int(own.dtype == torch.bfloat16), vb,
        ctypes.byref(grid), stream)
    if rc != 0:
        raise RuntimeError(f"weighted_agg kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    bf16_launches += own.dtype == torch.bfloat16
    last_grid = grid.value
    return out


def _route(device: torch.device) -> str:
    """The route for tensors on ``device``: "cuda" (the kernel), "cpu"
    (the plain version) or "meta" (shapes only); raises for any other."""
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no weighted_agg for device {device}")
    return device.type


def weighted_agg(own: torch.Tensor, neighbors: torch.Tensor, w: torch.Tensor,
                 alpha: float, *, index: Optional[torch.Tensor] = None,
                 any_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq (1). own: (P,); neighbors: (R, P) with contiguous rows; w: (M,)
    fp32; index: (M,) int64 row numbers or None (M = R); any_ok: 0-d bool
    or None (treated as True). Returns a new (P,) tensor."""
    M = _check(own, neighbors, w, index, any_ok)
    dev = _route(own.device)
    with counter.kernel("k2", lambda: cost(M, own.shape[0], own.dtype)):
        if dev == "cpu":
            return weighted_agg_ref(own, neighbors, w, alpha, index=index,
                                    any_ok=any_ok)
        if dev == "meta":
            return torch.empty_like(own)
        return _launch(own, neighbors, w, alpha, index, any_ok, M)


def cost(M: int, P: int, dtype: torch.dtype) -> tuple:
    """(FLOPs, bytes) of one mix, the kernel's own work whatever runs it:
    Σ_m w_m·nb_m (2·M·P) and the α blend (3·P); own and M rows read once,
    the result written once, w read."""
    size = torch.empty((), dtype=dtype).element_size()
    return 2 * M * P + 3 * P, size * (M + 2) * P + 4 * M
