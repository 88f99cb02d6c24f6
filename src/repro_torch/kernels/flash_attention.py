"""GQA attention with an online softmax: K3, forward and backward.

:func:`flash_attention` takes q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh)
in the reference's layout, with query head h = kh·G + g reading KV head
kh (G = H / KH), and returns (B, Sq, H, Dh) in q's dtype. Masks come from
positions: by default the indices, counted from 0 on both sides; or
explicit ``q_positions`` (Sq,) and ``kv_positions`` (Skv,), shared by the
batch, as the reference's model path hands its positions to
``chunked_attention`` (an M-RoPE prompt's image patches share one
temporal position, so they see each other both ways). Causal keeps k_pos
<= q_pos, a window keeps k_pos > q_pos − window, a key at a negative
position is invalid, and a row with no visible key gives 0 (and a zero
gradient). On a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention.cu``
(head dims :data:`FWD_HEAD_DIMS`); on a CPU tensor it runs the plain
version :func:`~repro_torch.kernels.ref.flash_attention_ref` at any head
dim, as the reference does, and autograd differentiates it. Ragged Sq and
Skv are masked in the kernel, where the reference's Pallas kernel refuses
them. With explicit positions it launches the kernels' position
instantiations, which read each tile's positions and bound the tiles a
block visits by the positions it holds, sorted or not; without them, the
index instantiations, which read no positions.

On a CUDA tensor that needs a gradient, the call goes through
:class:`_FlashAttention`: its forward launches the kernel's training
instantiation (fp32 or bf16), which writes the output in fp32 and each
row's log-sum-exp (B, H, Sq) fp32 (+inf for a fully masked row), saves q,
k, v, that output and the LSE, and returns the output in q's dtype;
its backward launches the kernels of ``csrc/flash_attention_bwd.cu`` (D =
rowsum(dO∘O); dK and dV, in ``splits`` partials when one block per key
tile would leave the card idle; their fixed-order sum; dQ), which
recompute P from the LSE as the reference's ``chunked_attention``
recomputes each chunk under ``jax.checkpoint``. :func:`backward_plan`
picks the split. The reference trains in its params' dtype
(``launch/steps.py::make_train_step``, bf16 by default), so the backward
takes fp32 at the head dims :data:`BWD_HEAD_DIMS` (explicit positions at
:data:`BWD_POSITION_HEAD_DIMS` only) and bf16 at
:data:`BWD_BF16_HEAD_DIMS` (without explicit positions), reading bf16 dO
and returning bf16 gradients (every sum in fp32). A call that needs a
gradient outside these raises in the forward, before any launch. Nothing
falls back to the plain version on a card.

Both directions multiply on the tensor cores (``wgmma`` in TF32 with
every operand split into a big and a small TF32 part, so fp32 keeps fp32's
accuracy). The forward reads K and V through TMA and the backward its
tiles through ``cp.async``; both need 16-byte-aligned bases, and the
wrapper raises on anything less (an unaligned dO is copied).
"""
from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

FWD_HEAD_DIMS = (48, 64, 96, 112, 128)  # the forward kernel's head sizes
BWD_HEAD_DIMS = (48, 64, 96, 112, 128)  # the backward's (192: ROADMAP B1)
# the head dims at which the backward takes explicit positions (M-RoPE
# trains at qwen2-vl's 128; no training path gives positions at the others)
BWD_POSITION_HEAD_DIMS = (64, 128)
# the head dims at which the backward takes bf16: the dense configs' (64 at
# reduced(), 128 for chatglm3-6b and starcoder2-15b); MLA's, zamba2's and
# positions in bf16 wait (ROADMAP Queue A, A5)
BWD_BF16_HEAD_DIMS = (64, 128)
ALIGN = 16                   # bytes; TMA and cp.async read 16-byte chunks
launches = 0                 # forward kernel launches since the last reset
position_launches = 0        # of those, launches with explicit positions
# backward kernel launches since the last reset, by kernel ("reduce" runs
# only when the plan splits dK/dV)
backward_launches = {"dot": 0, "dkdv": 0, "reduce": 0, "dq": 0}
# the backward's tiles (csrc/flash_attention_bwd.cu, checked against the
# library when it loads): keys a dK/dV block owns and the query tile of its
# steps, by head size; query rows a dQ block owns and the key tile of its
# steps; warpgroups a block, which share its steps
BWD_KEY_TILE = 64
BWD_QUERY_TILE = {48: 32, 64: 32, 96: 16, 112: 16, 128: 16}
BWD_ROW_TILE = 64
BWD_KEY_STEP = {48: 32, 64: 32, 96: 16, 112: 32, 128: 16}
BWD_GROUPS = {48: 2, 64: 2, 96: 2, 112: 1, 128: 1}

_lib = None
_bwd_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.argtypes = [
            ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_bwd_tiles.argtypes = [i] + [ctypes.POINTER(i)] * 5
        lib.attn_bwd_positions_built.argtypes = [i]
        lib.attn_bwd_bf16_built.argtypes = [i]
        # each launch ends (..., is_bf16, stream)
        lib.attn_bwd_dot_launch.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.attn_bwd_dkdv_launch.argtypes = [p] * 10 + [i] * 10 + [p]
        lib.attn_bwd_reduce_launch.argtypes = [p] * 3 + [ctypes.c_longlong,
                                                         i, i, p]
        lib.attn_bwd_dq_launch.argtypes = [p] * 9 + [i] * 9 + [p]
        for fn in (lib.attn_bwd_tiles, lib.attn_bwd_positions_built,
                   lib.attn_bwd_bf16_built, lib.attn_bwd_dot_launch,
                   lib.attn_bwd_dkdv_launch, lib.attn_bwd_reduce_launch,
                   lib.attn_bwd_dq_launch):
            fn.restype = ctypes.c_int
        for dh in BWD_HEAD_DIMS:
            got = [ctypes.c_int() for _ in range(5)]
            lib.attn_bwd_tiles(dh, *(ctypes.byref(x) for x in got))
            want = [BWD_KEY_TILE, BWD_QUERY_TILE[dh], BWD_ROW_TILE,
                    BWD_KEY_STEP[dh], BWD_GROUPS[dh]]
            if [x.value for x in got] != want:
                raise RuntimeError(f"flash_attention_bwd's tiles at Dh {dh} "
                                   f"are {[x.value for x in got]}, the "
                                   f"wrapper's {want}")
            if bool(lib.attn_bwd_positions_built(dh)) != (
                    dh in BWD_POSITION_HEAD_DIMS):
                raise RuntimeError(f"flash_attention_bwd's position "
                                   f"instantiations at Dh {dh} do not match "
                                   f"BWD_POSITION_HEAD_DIMS")
            if bool(lib.attn_bwd_bf16_built(dh)) != (
                    dh in BWD_BF16_HEAD_DIMS):
                raise RuntimeError(f"flash_attention_bwd's bf16 "
                                   f"instantiations at Dh {dh} do not match "
                                   f"BWD_BF16_HEAD_DIMS")
        _bwd_lib = lib
    return _bwd_lib


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _tiles(lo: int, hi: int, size: int):
    """(first, count) of the tiles of ``size`` that hold [lo, hi)."""
    return lo // size, (-(-hi // size) - lo // size if hi > lo else 0)


def dkdv_query_tiles(t, Sq, Skv, Dh, causal, window):
    """(first, count) of the query tiles that can see key tile ``t``."""
    k0 = t * BWD_KEY_TILE
    k_last = min(k0 + BWD_KEY_TILE, Skv) - 1
    q_end = min(Sq, k_last + window) if window > 0 else Sq
    return _tiles(k0 if causal else 0, q_end, BWD_QUERY_TILE[Dh])


@functools.lru_cache(maxsize=256)
def backward_plan(B, Sq, Skv, H, KH, Dh, causal, window,
                  sms) -> MappingProxyType:
    """The backward's work split on a card of ``sms`` SMs. dK/dV has one
    block per (key tile, batch, KV head) times ``splits``: 1 when that
    gives at least one block a SM, else the smallest count that does,
    capped so that the busiest key tile's (head, query tile) steps still
    give each split one step a warpgroup (at smollm-135m's training shape
    2 splits ran 0.083 ms on an H100, 1 split 0.102, 3 0.085, 4 0.088, 6
    0.098: ``benchmarks/torch_kernel_times.py --bwd-splits``). Returns
    ``splits``, both grids' block counts and the kernels launched, in
    order ("reduce" only when splits > 1). With explicit positions the
    kernels find each block's tiles on the card from the positions; the
    split is then sized from these index bounds, a guess at the work
    (every split is correct), which equals the index path's for an
    arange."""
    G = H // KH
    n_kt = -(-Skv // BWD_KEY_TILE)
    steps = max(G * dkdv_query_tiles(t, Sq, Skv, Dh, causal, window)[1]
                 for t in range(n_kt))
    base = n_kt * B * KH
    cap = -(-steps // BWD_GROUPS[Dh])
    splits = 1 if base >= sms else max(1, min(-(-sms // base), cap))
    kernels = ("dot", "dkdv") + (("reduce",) if splits > 1 else ()) + ("dq",)
    return MappingProxyType({   # cached: one read-only plan a shape
        "splits": splits, "dkdv_blocks": base * splits,
        "dq_blocks": -(-Sq // BWD_ROW_TILE) * B * H, "kernels": kernels})


def reset_counts() -> None:
    """Set :data:`launches`, :data:`position_launches` and every
    :data:`backward_launches` to 0."""
    global launches, position_launches
    launches = position_launches = 0
    for name in backward_launches:
        backward_launches[name] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, q_positions=None, kv_positions=None) -> None:
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
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("give both q_positions and kv_positions, or "
                         "neither")
    if q_positions is None:
        return
    for name, t, n in (("q_positions", q_positions, Sq),
                       ("kv_positions", kv_positions, k.shape[1])):
        if t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"{name} must be integer, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, with_lse: bool = False, *,
            q_positions: Optional[torch.Tensor] = None,
            kv_positions: Optional[torch.Tensor] = None):
    """One forward launch. Returns the output in q's dtype, or with
    ``with_lse`` (the training instantiation) (output, LSE), both fp32
    whatever q's dtype: the backward's D reads the output unrounded, and
    the output rounded to bf16 is the serving instantiation's, bit for
    bit. Explicit positions are contiguous int32 (:func:`_int32`)."""
    global launches, position_launches
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be {ALIGN}-byte aligned (TMA)")
    out = torch.empty(q.shape, dtype=torch.float32 if with_lse else q.dtype,
                      device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *_pointers(q_positions,
                                                           kv_positions),
        B, Sq, Skv, H, KH, Dh, int(causal), int(window),
        int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    position_launches += q_positions is not None
    return (out, lse) if with_lse else out


def _int32(positions: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Positions as the kernels read them: contiguous int32."""
    if positions is None:
        return None
    return positions.to(torch.int32).contiguous()


def _pointers(q_positions, kv_positions):
    """The positions' device pointers, or two nulls (the index path)."""
    if q_positions is None:
        return None, None
    return q_positions.data_ptr(), kv_positions.data_ptr()


def _backward_launches(q, k, v, out, lse, dout, causal: bool, window: int,
                       splits: int | None = None, *, q_positions=None,
                       kv_positions=None):
    """Allocates the backward's outputs (q's dtype) and scratch (fp32) and
    returns ((dq, dk, dv), launches): the launches in order as (name,
    launch) pairs, each of which enqueues its kernel on the current stream,
    adds one to its count in :data:`backward_launches` and raises if the
    launch fails. ``out`` and ``lse`` are the training forward's, both
    fp32 (:func:`_launch` with ``with_lse``). ``splits`` overrides the
    plan's dK/dV split (to measure the rule). Explicit positions are
    contiguous int32 (:func:`_int32`)."""
    if out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"the backward reads the training forward's fp32 "
                        f"output and LSE, got {out.dtype}, {lse.dtype}")
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    lib = _bwd_library()
    dev = q.device
    if splits is None:
        splits = backward_plan(B, Sq, Skv, H, KH, Dh, bool(causal),
                               int(window), _sm_count(dev))["splits"]
    d = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    masks = (int(causal), int(window))
    pos = _pointers(q_positions, kv_positions)
    bf16 = int(q.dtype == torch.bfloat16)
    calls = {
        "dot": (lib.attn_bwd_dot_launch, (dout, out, d),
                (B, Sq, H, Dh, bf16)),
        "dq": (lib.attn_bwd_dq_launch, (q, k, v, dout, lse, d, dq),
               pos + (B, Sq, Skv, H, KH, Dh) + masks + (bf16,))}
    if splits > 1:
        part = torch.empty((2, splits) + tuple(dk.shape), dtype=torch.float32,
                           device=dev)
        partials = (part[0], part[1])
        calls["reduce"] = (lib.attn_bwd_reduce_launch, (part, dk, dv),
                           (dk.numel(), splits, bf16))
    else:
        partials = (dk, dv)
    calls["dkdv"] = (lib.attn_bwd_dkdv_launch,
                     (q, k, v, dout, lse, d) + partials,
                     pos + (B, Sq, Skv, H, KH, Dh) + masks + (splits, bf16))

    def launcher(name):
        fn, tensors, ints = calls[name]

        def launch():
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in tensors), *ints, stream)
            if rc != 0:
                raise RuntimeError(f"flash_attention backward kernel {name} "
                                   f"launch failed: CUDA error {rc}")
            backward_launches[name] += 1
        return launch

    order = ("dot", "dkdv") + (("reduce",) if splits > 1 else ()) + ("dq",)
    return (dq, dk, dv), [(n, launcher(n)) for n in order]


def _launch_backward(q, k, v, out, lse, dout, causal: bool, window: int, *,
                     q_positions=None, kv_positions=None):
    """The backward's launches; returns (dq, dk, dv)."""
    grads, launches_ = _backward_launches(q, k, v, out, lse, dout, causal,
                                          window, q_positions=q_positions,
                                          kv_positions=kv_positions)
    for _, launch in launches_:
        launch()
    return grads


class _FlashAttention(torch.autograd.Function):
    """K3 on CUDA tensors with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_positions=None,
                kv_positions=None):
        _check_backward(q.shape[3], q.dtype, q_positions is not None)
        ctx.causal, ctx.window = causal, window
        ctx.positions = dict(q_positions=q_positions,
                             kv_positions=kv_positions)
        out, lse = _launch(q, k, v, causal, window, with_lse=True,
                           **ctx.positions)
        ctx.save_for_backward(q, k, v, out, lse)
        return out.to(q.dtype)            # fp32: the same tensor

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()   # bf16 dO stays bf16
        if dout.data_ptr() % ALIGN:      # cp.async reads 16-byte chunks
            dout = dout.clone()
        dq, dk, dv = _launch_backward(q, k, v, out, lse, dout, ctx.causal,
                                      ctx.window, **ctx.positions)
        return dq, dk, dv, None, None, None, None


def _check_backward(Dh: int, dtype: torch.dtype, positions: bool) -> None:
    """Raise, before any launch, for a call that needs a gradient the
    backward does not take: a head dim outside :data:`BWD_HEAD_DIMS`,
    explicit positions outside :data:`BWD_POSITION_HEAD_DIMS`, bf16
    outside :data:`BWD_BF16_HEAD_DIMS` or with explicit positions."""
    hint = "call it without gradients to serve"
    if Dh not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {Dh}: the flash_attention backward "
                         f"takes {BWD_HEAD_DIMS} (ROADMAP Queue B, B1); "
                         f"{hint}")
    if positions and Dh not in BWD_POSITION_HEAD_DIMS:
        raise ValueError(f"head dim {Dh}: the flash_attention backward "
                         f"takes explicit positions at "
                         f"{BWD_POSITION_HEAD_DIMS} (ROADMAP Queue B, B1); "
                         f"{hint}")
    if dtype == torch.bfloat16 and (Dh not in BWD_BF16_HEAD_DIMS
                                    or positions):
        raise ValueError(f"head dim {Dh}: the flash_attention backward "
                         f"takes bf16 at {BWD_BF16_HEAD_DIMS} without "
                         f"explicit positions (ROADMAP Queue A, A5); {hint}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention of q over k, v (layouts and masks above; explicit
    positions are integer (Sq,) and (Skv,) on q's device, both or
    neither): the kernel for CUDA tensors at a head dim of
    :data:`FWD_HEAD_DIMS`, differentiable through the hand-written
    backward when any input needs a gradient (head dims
    :data:`BWD_HEAD_DIMS`); the plain version (autograd's own backward)
    for CPU tensors at any head dim; an error for anything else. The
    bf16 plain version rounds P to bf16 before P·V, as the reference's
    ``chunked_attention`` does."""
    _check(q, k, v, window, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_positions=q_positions,
                                   kv_positions=kv_positions)
    if q.shape[3] not in FWD_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]}; the CUDA kernel takes "
                         f"{FWD_HEAD_DIMS} (ROADMAP Queue B, B1)")
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    q_positions, kv_positions = _int32(q_positions), _int32(kv_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_positions,
                                     kv_positions)
    return _launch(q, k, v, causal, window, q_positions=q_positions,
                   kv_positions=kv_positions)
