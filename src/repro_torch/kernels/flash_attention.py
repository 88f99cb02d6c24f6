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
gradient). On a CUDA tensor it launches the hand-written kernel,
``csrc/flash_attention.cu`` in fp32 and ``csrc/flash_attention_bf16.cu``
in bf16 (head dims :data:`FWD_HEAD_DIMS`); on a CPU tensor it runs the
plain version :func:`~repro_torch.kernels.ref.flash_attention_ref` at any head
dim, as the reference does, its gradient autograd's through the plain
version, recomputed in the backward; on a ``meta`` tensor (the dry run's)
it returns the output's shape and dtype only, at any head dim. Ragged Sq and
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
its backward launches the kernels of ``csrc/flash_attention_bwd.cu``
(fp32) or ``csrc/flash_attention_bwd_bf16.cu`` (bf16): D = rowsum(dO∘O);
dK and dV, in ``splits`` partials when one block per key tile would leave
the card idle; their fixed-order sum; dQ. They recompute P from the LSE
as the reference's ``chunked_attention`` recomputes each chunk under
``jax.checkpoint``. :func:`backward_plan` picks the split, from each
dtype's tiles (:func:`bwd_tiles`). The reference trains in its params'
dtype (``launch/steps.py::make_train_step``, bf16 by default), so the
backward takes fp32 at the head dims :data:`BWD_HEAD_DIMS` and bf16 at
:data:`BWD_BF16_HEAD_DIMS` (each every forward head dim, deepseek-v3's 192
included), explicit positions at each of them, reading bf16 dO
and returning bf16 gradients (every sum in fp32; P and dS rounded to bf16
where they enter a product, as
:func:`~repro_torch.kernels.ref.flash_attention_bwd_bf16_ref` writes out).
A call that needs a gradient outside these raises in the forward, before
any launch. Nothing falls back to the plain version on a card.

K3 is one autograd node on every device, so that a
:class:`~repro_torch.roofline.counter.CostCounter` counts its work the
same wherever it runs: the forward and the backward by
:func:`forward_cost` and :func:`backward_cost`, from the (query, key)
pairs the masks leave (:func:`visible_pairs`), and not the plain
version's own ops.

Both directions multiply on the tensor cores: in fp32 ``wgmma`` in TF32
with every operand split into a big and a small TF32 part, so fp32 keeps
fp32's accuracy; in bf16 one bf16 ``wgmma`` a product, on tiles that TMA
lands swizzled. The kernels read their tiles through TMA or ``cp.async``
and need 16-byte-aligned bases; the wrapper raises on anything less (an
unaligned dO is copied).
"""
from __future__ import annotations

import ctypes
import functools
from types import MappingProxyType
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.roofline import counter

# the forward kernels' head sizes, fp32 and bf16: MLA's 48 (reduced()), 96
# (minicpm3-4b) and 192 (deepseek-v3: qk_nope 128 + qk_rope 64), the dense
# configs' 64 and 128, zamba2's shared block's 112
FWD_HEAD_DIMS = (48, 64, 96, 112, 128, 192)
# the fp32 and bf16 backwards' head sizes, and those at which they take
# explicit positions (the reference's loss_fn takes positions for every
# arch): every forward head size
BWD_HEAD_DIMS = BWD_BF16_HEAD_DIMS = FWD_HEAD_DIMS
BWD_POSITION_HEAD_DIMS = FWD_HEAD_DIMS
ALIGN = 16                   # bytes; TMA and cp.async read 16-byte chunks
launches = 0                 # forward kernel launches since the last reset
position_launches = 0        # of those, launches with explicit positions
bf16_launches = 0            # of those, launches of the bf16 kernel
# backward kernel launches since the last reset, by kernel ("reduce" runs
# only when the plan splits dK/dV), and of those the bf16 kernels'
backward_launches = {"dot": 0, "dkdv": 0, "reduce": 0, "dq": 0}
bf16_backward_launches = {"dot": 0, "dkdv": 0, "reduce": 0, "dq": 0}
# the fp32 backward's tiles (csrc/flash_attention_bwd.cu, checked against
# the library when it loads): keys a dK/dV block owns and the query tile of
# its steps, by head size; query rows a dQ block owns and the key tile of
# its steps; warpgroups a block, which share its steps (at Dh 192 both of
# a block's warpgroups take every step, split between them by product: 1)
BWD_KEY_TILE = 64
BWD_QUERY_TILE = {48: 32, 64: 32, 96: 16, 112: 16, 128: 16, 192: 16}
BWD_ROW_TILE = 64
BWD_KEY_STEP = {48: 32, 64: 32, 96: 16, 112: 32, 128: 16, 192: 16}
BWD_GROUPS = {48: 2, 64: 2, 96: 2, 112: 1, 128: 1, 192: 1}
# the bf16 backward's (csrc/flash_attention_bwd_bf16.cu, checked likewise),
# the same at every head size of BWD_BF16_HEAD_DIMS: 64 keys a dK/dV block
# in steps of 64 queries; 128 folded (query, head) rows a dQ block (row =
# i*G + g, 64 a warpgroup) in steps of 64 keys. A dK/dV block's two
# warpgroups take its steps in turn, or at Dh 192 (where each sums half the
# head dim) both take every step: the groups that share out the steps
BWD_BF16_KEY_TILE = 64
BWD_BF16_QUERY_TILE = 64
BWD_BF16_ROW_TILE = 128
BWD_BF16_KEY_STEP = 64
BWD_BF16_GROUPS = {48: 2, 64: 2, 96: 2, 112: 2, 128: 2, 192: 1}


class BwdTiles(NamedTuple):
    """One backward's tiles at one head size: ``key_tile`` keys a dK/dV
    block, ``query_tile`` queries a step, ``row_tile`` rows a dQ block
    (query rows of one head in fp32, folded (query, head) rows of one KV
    head in bf16: ``folded_rows``), ``key_step`` keys a dQ step,
    ``groups`` warpgroups that share out a dK/dV block's steps."""
    key_tile: int
    query_tile: int
    row_tile: int
    key_step: int
    groups: int
    folded_rows: bool


def bwd_tiles(Dh: int, dtype: torch.dtype = torch.float32) -> BwdTiles:
    """The tiles of the backward that takes ``dtype`` at head dim ``Dh``."""
    if dtype == torch.bfloat16:
        return BwdTiles(BWD_BF16_KEY_TILE, BWD_BF16_QUERY_TILE,
                        BWD_BF16_ROW_TILE, BWD_BF16_KEY_STEP,
                        BWD_BF16_GROUPS[Dh], True)
    return BwdTiles(BWD_KEY_TILE, BWD_QUERY_TILE[Dh], BWD_ROW_TILE,
                    BWD_KEY_STEP[Dh], BWD_GROUPS[Dh], False)


_libs: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _load(name: str, signatures: dict, check=None) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library with its functions' argument types set
    (each returns an int), kept once ``check(lib)`` (if given) passes."""
    if name not in _libs:
        lib = _build.load(name)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if check is not None:
            check(lib)
        _libs[name] = lib
    return _libs[name]


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The forward's library for ``dtype``."""
    if dtype == torch.bfloat16:
        return _load("flash_attention_bf16", {
            "flash_attention_bf16_launch": [_P] * 7 + [_I] * 8 + [_P]})
    return _load("flash_attention", {
        "flash_attention_launch": [_P] * 7 + [_I] * 8 + [_P]})


def _check_tiles(name, tiles_fn, dtype, head_dims) -> None:
    """Hold the library's tiles (``tiles_fn``) to :func:`bwd_tiles` at each
    head dim it should take (``head_dims``), and its refusal at the other
    forward head dims."""
    for dh in FWD_HEAD_DIMS:
        got = [ctypes.c_int() for _ in range(5)]
        rc = tiles_fn(dh, *(ctypes.byref(x) for x in got))
        if (rc == 0) != (dh in head_dims):
            raise RuntimeError(f"{name} takes Dh {dh}: {rc == 0}, the "
                               f"wrapper's {dh in head_dims}")
        if rc == 0 and [x.value for x in got] != (
                want := list(bwd_tiles(dh, dtype))[:5]):
            raise RuntimeError(f"{name}'s tiles at Dh {dh} are "
                               f"{[x.value for x in got]}, the wrapper's "
                               f"{want}")


def _bwd_library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The backward's library for ``dtype``, its tiles and position
    instantiations checked against the wrapper's on first load."""
    bf16 = dtype == torch.bfloat16
    name = "flash_attention_bwd" + ("_bf16" if bf16 else "")
    fn = "attn_bwd_" + ("bf16_" if bf16 else "")

    dims = BWD_BF16_HEAD_DIMS if bf16 else BWD_HEAD_DIMS

    def check(lib):
        _check_tiles(name, getattr(lib, fn + "tiles"), dtype, dims)
        for dh in dims:
            if bool(getattr(lib, fn + "positions_built")(dh)) != (
                    dh in BWD_POSITION_HEAD_DIMS):
                raise RuntimeError(f"{name}'s position instantiations at Dh "
                                   f"{dh} do not match BWD_POSITION_HEAD_DIMS")
    # each launch ends (..., stream); dK/dV's and dQ's take the positions
    return _load(name, {
        fn + "tiles": [_I] + [ctypes.POINTER(_I)] * 5,
        fn + "positions_built": [_I],
        fn + "dot_launch": [_P] * 3 + [_I] * 4 + [_P],
        fn + "dkdv_launch": [_P] * 10 + [_I] * 9 + [_P],
        fn + "reduce_launch": [_P] * 3 + [ctypes.c_longlong, _I, _P],
        fn + "dq_launch": [_P] * 9 + [_I] * 8 + [_P]}, check)


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


def dkdv_query_tiles(t, Sq, Skv, Dh, causal, window,
                     dtype=torch.float32):
    """(first, count) of the query tiles that can see key tile ``t`` (the
    tiles of ``dtype``'s backward)."""
    tiles = bwd_tiles(Dh, dtype)
    k0 = t * tiles.key_tile
    k_last = min(k0 + tiles.key_tile, Skv) - 1
    q_end = min(Sq, k_last + window) if window > 0 else Sq
    return _tiles(k0 if causal else 0, q_end, tiles.query_tile)


@functools.lru_cache(maxsize=256)
def backward_plan(B, Sq, Skv, H, KH, Dh, causal, window, sms,
                  dtype=torch.float32) -> MappingProxyType:
    """The backward's work split on a card of ``sms`` SMs, with the tiles
    of ``dtype``'s kernels. dK/dV has one block per (key tile, batch, KV
    head) times ``splits``: 1 when that gives at least one block a SM,
    else the smallest count that does, capped so that the busiest key
    tile's (head, query tile) steps still give each split one step a
    warpgroup (at smollm-135m's training shape 2 splits ran 0.083 ms on an
    H100, 1 split 0.102, 3 0.085, 4 0.088, 6 0.098: ``benchmarks/
    torch_kernel_times.py --bwd-splits``). dQ has one block per (query
    tile, batch, head) in fp32 and per (folded row tile, batch, KV head)
    in bf16. Returns ``splits``, both grids' block counts and the kernels
    launched, in order ("reduce" only when splits > 1). With explicit
    positions the kernels find each block's tiles on the card from the
    positions; the split is then sized from these index bounds, a guess at
    the work (every split is correct), which equals the index path's for
    an arange."""
    G = H // KH
    tiles = bwd_tiles(Dh, dtype)
    n_kt = -(-Skv // tiles.key_tile)
    steps = max(G * dkdv_query_tiles(t, Sq, Skv, Dh, causal, window,
                                     dtype)[1] for t in range(n_kt))
    base = n_kt * B * KH
    cap = -(-steps // tiles.groups)
    splits = 1 if base >= sms else max(1, min(-(-sms // base), cap))
    kernels = ("dot", "dkdv") + (("reduce",) if splits > 1 else ()) + ("dq",)
    dq_blocks = (-(-Sq * G // tiles.row_tile) * B * KH if tiles.folded_rows
                 else -(-Sq // tiles.row_tile) * B * H)
    return MappingProxyType({   # cached: one read-only plan a shape
        "splits": splits, "dkdv_blocks": base * splits,
        "dq_blocks": dq_blocks, "kernels": kernels})


def reset_counts() -> None:
    """Set :data:`launches`, :data:`position_launches`,
    :data:`bf16_launches` and every :data:`backward_launches` and
    :data:`bf16_backward_launches` to 0."""
    global launches, position_launches, bf16_launches
    launches = position_launches = bf16_launches = 0
    for name in backward_launches:
        backward_launches[name] = bf16_backward_launches[name] = 0


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
    global launches, position_launches, bf16_launches
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
    bf16 = q.dtype == torch.bfloat16
    lib = _library(q.dtype)
    launch = (lib.flash_attention_bf16_launch if bf16
              else lib.flash_attention_launch)
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                *_pointers(q_positions, kv_positions), B, Sq, Skv, H, KH, Dh,
                int(causal), int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    position_launches += q_positions is not None
    bf16_launches += bf16
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
    launch) pairs, each of which enqueues its kernel (of q's dtype's
    library) on the current stream, adds one to its count in
    :data:`backward_launches` (and in bf16 :data:`bf16_backward_launches`)
    and raises if the launch fails. ``out`` and ``lse`` are the training
    forward's, both fp32 (:func:`_launch` with ``with_lse``). ``splits``
    overrides the plan's dK/dV split (to measure the rule). Explicit
    positions are contiguous int32 (:func:`_int32`)."""
    if out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"the backward reads the training forward's fp32 "
                        f"output and LSE, got {out.dtype}, {lse.dtype}")
    B, Sq, H, Dh = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    lib = _bwd_library(q.dtype)
    dev = q.device
    if splits is None:
        splits = backward_plan(B, Sq, Skv, H, KH, Dh, bool(causal),
                               int(window), _sm_count(dev),
                               q.dtype)["splits"]
    d = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    masks = (int(causal), int(window))
    pos = _pointers(q_positions, kv_positions)
    fns = {name: getattr(lib, f"attn_bwd_{'bf16_' if bf16 else ''}{name}"
                         f"_launch") for name in backward_launches}
    calls = {
        "dot": (fns["dot"], (dout, out, d), (B, Sq, H, Dh)),
        "dq": (fns["dq"], (q, k, v, dout, lse, d, dq),
               pos + (B, Sq, Skv, H, KH, Dh) + masks)}
    if splits > 1:
        part = torch.empty((2, splits) + tuple(dk.shape), dtype=torch.float32,
                           device=dev)
        partials = (part[0], part[1])
        calls["reduce"] = (fns["reduce"], (part, dk, dv),
                           (dk.numel(), splits))
    else:
        partials = (dk, dv)
    calls["dkdv"] = (fns["dkdv"], (q, k, v, dout, lse, d) + partials,
                     pos + (B, Sq, Skv, H, KH, Dh) + masks + (splits,))

    def launcher(name):
        fn, tensors, ints = calls[name]

        def launch():
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(t.data_ptr() for t in tensors), *ints, stream)
            if rc != 0:
                raise RuntimeError(f"flash_attention backward kernel {name} "
                                   f"launch failed: CUDA error {rc}")
            backward_launches[name] += 1
            bf16_backward_launches[name] += bf16
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


def visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None) -> int:
    """The (query, key) pairs of one head that the masks leave: from the
    positions' values where they have some, else (none given, or on the
    ``meta`` device, which holds none) from the indices. Reading positions
    on a card syncs it."""
    if q_positions is not None and q_positions.device.type != "meta":
        keys = torch.sort(kv_positions[kv_positions >= 0].long()).values
        qp = q_positions.long()
        hi = (torch.searchsorted(keys, qp, right=True) if causal
              else torch.full_like(qp, keys.numel()))
        lo = (torch.searchsorted(keys, qp - window, right=True) if window
              else torch.zeros_like(qp))
        return int(torch.clamp(hi - lo, min=0).sum())
    i = torch.arange(Sq, dtype=torch.long)
    hi = torch.clamp(i, max=Skv - 1) if causal else torch.full_like(i, Skv - 1)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def forward_cost(q, k, v, causal, window, q_positions=None,
                 kv_positions=None, training=False) -> tuple:
    """(FLOPs, bytes) of one forward: 4·Dh FLOPs a visible (query, key)
    pair a head (S = Q·Kᵀ and P·V); q, k, v (and the positions) read, the
    output written in q's dtype, or in training the fp32 output and LSE."""
    B, Sq, H, Dh = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window, q_positions,
                          kv_positions)
    out = (4 * (q.numel() + B * H * Sq) if training
           else q.numel() * q.element_size())
    return (4 * Dh * pairs * B * H,
            _nbytes(q, k, v, q_positions, kv_positions) + out)


def backward_cost(q, k, v, causal, window, q_positions=None,
                  kv_positions=None) -> tuple:
    """(FLOPs, bytes) of one backward: five products of 2·Dh FLOPs a
    visible pair a head (S, dP, dV, dK, dQ); q, k, v, dO, the fp32 output
    and LSE (and the positions) read, dq, dk, dv written."""
    B, Sq, H, Dh = q.shape
    pairs = visible_pairs(Sq, k.shape[1], causal, window, q_positions,
                          kv_positions)
    return (10 * Dh * pairs * B * H,
            2 * _nbytes(q, k, v) + q.numel() * q.element_size()
            + 4 * (q.numel() + B * H * Sq)
            + _nbytes(q_positions, kv_positions))


class _FlashAttention(torch.autograd.Function):
    """K3 with a gradient: on a card the training forward and the
    hand-written backward; on the CPU the plain version, its gradient
    autograd's through the plain version recomputed in the backward (the
    gradient autograd gives through the plain forward); on the ``meta``
    device shapes only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_positions=None,
                kv_positions=None):
        dev = q.device.type
        if dev == "cuda":
            _check_backward(q.shape[3], q.dtype, q_positions is not None)
        ctx.causal, ctx.window = causal, window
        ctx.positions = dict(q_positions=q_positions,
                             kv_positions=kv_positions)
        with counter.kernel("k3_forward", lambda: forward_cost(
                q, k, v, causal, window, training=True, **ctx.positions)):
            if dev == "cuda":
                out, lse = _launch(q, k, v, causal, window, with_lse=True,
                                   **ctx.positions)
                ctx.save_for_backward(q, k, v, out, lse)
                return out.to(q.dtype)        # fp32: the same tensor
            ctx.save_for_backward(q, k, v)
            if dev == "meta":
                return torch.empty_like(q)
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       **ctx.positions)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors     # once: remat's unpack hooks allow one
        q, k, v = saved[:3]
        with counter.kernel("k3_backward", lambda: backward_cost(
                q, k, v, ctx.causal, ctx.window, **ctx.positions)):
            if q.device.type == "cuda":
                out, lse = saved[3:]
                dout = dout.to(q.dtype).contiguous()   # bf16 dO stays bf16
                if dout.data_ptr() % ALIGN:   # TMA, cp.async: 16-byte chunks
                    dout = dout.clone()
                grads = _launch_backward(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.window,
                                         **ctx.positions)
            elif q.device.type == "meta":
                grads = tuple(torch.empty_like(t) for t in (q, k, v))
            else:
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    out = flash_attention_ref(*leaves, causal=ctx.causal,
                                              window=ctx.window,
                                              **ctx.positions)
                    grads = torch.autograd.grad(out, leaves, dout)
        return (*grads, None, None, None, None)


def _check_backward(Dh: int, dtype: torch.dtype, positions: bool) -> None:
    """Raise, before any launch, for a call that needs a gradient the
    backward does not take: fp32 outside :data:`BWD_HEAD_DIMS`, bf16
    outside :data:`BWD_BF16_HEAD_DIMS`, explicit positions outside
    :data:`BWD_POSITION_HEAD_DIMS`."""
    hint = "call it without gradients to serve"
    if dtype == torch.bfloat16:
        if Dh not in BWD_BF16_HEAD_DIMS:
            raise ValueError(f"head dim {Dh}: the flash_attention backward "
                             f"takes bf16 at {BWD_BF16_HEAD_DIMS}; {hint}")
    elif Dh not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {Dh}: the flash_attention backward "
                         f"takes fp32 at {BWD_HEAD_DIMS}; {hint}")
    if positions and Dh not in BWD_POSITION_HEAD_DIMS:
        raise ValueError(f"head dim {Dh}: the flash_attention backward "
                         f"takes explicit positions at "
                         f"{BWD_POSITION_HEAD_DIMS}; {hint}")


def _route(device: torch.device, Dh: int) -> str:
    """The route for tensors on ``device``: "cuda" (the kernels, at the
    head dims of :data:`FWD_HEAD_DIMS`), "cpu" or "meta"; raises for a
    head dim the card's kernels do not take and for any other device."""
    if device.type == "cuda":
        if Dh not in FWD_HEAD_DIMS:
            raise ValueError(f"head dim {Dh}; the CUDA kernel takes "
                             f"{FWD_HEAD_DIMS}")
    elif device.type not in ("cpu", "meta"):
        raise ValueError(f"no flash_attention for device {device}")
    return device.type


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
    :data:`BWD_HEAD_DIMS` in fp32, :data:`BWD_BF16_HEAD_DIMS` in bf16);
    the plain version for CPU tensors at any head
    dim; shapes only for ``meta`` tensors; an error for anything else. The
    bf16 plain version rounds P to bf16 before P·V, as the reference's
    ``chunked_attention`` does."""
    _check(q, k, v, window, q_positions, kv_positions)
    dev = _route(q.device, q.shape[3])
    if dev == "cuda":
        q_positions, kv_positions = _int32(q_positions), _int32(kv_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_positions,
                                     kv_positions)
    pos = dict(q_positions=q_positions, kv_positions=kv_positions)
    with counter.kernel("k3_forward", lambda: forward_cost(
            q, k, v, causal, window, **pos)):
        if dev == "cuda":
            return _launch(q, k, v, causal, window, **pos)
        if dev == "meta":
            return torch.empty_like(q)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   **pos)
