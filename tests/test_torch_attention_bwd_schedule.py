"""K3's backward schedule (``repro_torch/kernels/flash_attention.py``):
the dK/dV and dQ grids that ``backward_plan`` sizes, walked block by block
with the rule ``csrc/flash_attention_bwd.cu`` (fp32) and
``csrc/flash_attention_bwd_bf16.cu`` (bf16, with its own tiles) follow
(``_dkdv_steps``, ``_dq_steps``, ``_dq_folded_steps`` below), cover every
(key tile, query tile, head) that holds an unmasked pair once and only
once (in bf16's dQ, every (row tile, KV head, key tile), its rows folded
as the forward folds them); at Dh 192 the bf16 kernels, forward and
backward, launch a head's blocks next to each other, the heaviest first,
and split each dK/dV step over their two warpgroups by queries (S^T and
dP^T) and by columns (dV and dK); the fp32 dK/dV kernel at Dh 192 launches
head-major too, its forward and dQ the row tile slowest, the heaviest
first over the grid. Over ``chip_smoke.py``'s backward sweeps
(``BWD_SHAPES``; ``BWD_BF16_SHAPES`` in bf16) and shapes at the tiles'
edges, on cards of several sizes (so both the split and the unsplit dK/dV
grids are walked). Also: the two dtypes' plans are cached apart, and
each backward library is held to its dtype's tiles when it loads (with a
stand-in library). CPU only: the plan is host arithmetic; the card-only
tests hold the kernels' gradients to the plain backward at the same
shapes."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels.ref import _attention_mask  # noqa: E402

# (B, Sq, Skv, H, KH, Dh, causal, window): G 1, 3, 4, 9; key and query
# tiles just off 64 (and off Dh 128's 16) under causal and a window; Sq
# much smaller and much larger than Skv
EXTRA = [
    (2, 65, 65, 3, 3, 64, True, 0),
    (1, 129, 127, 4, 1, 64, True, 0),
    (2, 63, 127, 9, 1, 64, True, 33),
    (1, 129, 65, 9, 3, 64, False, 64),
    (1, 17, 300, 4, 1, 64, True, 0),
    (1, 8, 500, 3, 1, 128, False, 0),
    (1, 300, 17, 9, 3, 64, True, 0),
    (1, 500, 8, 4, 2, 128, False, 5),
    (1, 33, 47, 4, 4, 128, True, 17),
]
SHAPES = chip_smoke.BWD_SHAPES + EXTRA
# the bf16 backward's: its sweep and the edge shapes at its head dims; and
# in both dtypes Dh 192, whose dK/dV warpgroups take every step together:
# a split plan (8 splits in bf16, 32 in fp32), a window across tiles,
# folded rows (bf16) and rows and keys (fp32) off the tiles
DS_SHAPES = [(1, 256, 256, 2, 1, 192, True, 0),
             (1, 130, 130, 6, 2, 192, True, 70),
             (2, 42, 43, 3, 1, 192, True, 0)]
BF16_SHAPES = chip_smoke.BWD_BF16_SHAPES + [
    s for s in EXTRA if s[5] in k3.BWD_BF16_HEAD_DIMS] + DS_SHAPES
CASES = ([(torch.float32, s) for s in SHAPES + DS_SHAPES]
         + [(torch.bfloat16, s) for s in BF16_SHAPES])
SMS = (132, 1, 16, 1000)


def _head_major(Dh, dtype, kernel="dkdv"):
    """Whether ``kernel`` ("dkdv", "dq" or "forward") launches a head's
    blocks next to each other: dK/dV at Dh 192 in both dtypes
    (``csrc/flash_attention_bwd.cu``'s and ``csrc/flash_attention_bwd_
    bf16.cu``'s wide kernels), and bf16's forward and dQ at Dh 192; the
    others put the tile slowest in the grid (at Dh 192 in fp32 the
    forward and dQ were faster so on the card, ``benchmarks/
    torch_k3_wide_probe.py``)."""
    return Dh == 192 and (kernel == "dkdv" or dtype == torch.bfloat16)


def _dkdv_block(block, B, Skv, KH, Dh, splits, dtype=torch.float32):
    """(batch, KV head, key tile, split) of dK/dV block ``block``: split
    fastest; then head-major (key tile 0 first within a head) or the key
    tile slowest."""
    c, rest = block % splits, block // splits
    if _head_major(Dh, dtype):
        n_kt = -(-Skv // k3.bwd_tiles(Dh, dtype).key_tile)
        t, head = rest % n_kt, rest // n_kt
        return head // KH, head % KH, t, c
    kh, rest = rest % KH, rest // KH
    return rest % B, kh, rest // B, c


def _dkdv_steps(block, B, Sq, Skv, H, KH, Dh, causal, window, splits,
                dtype=torch.float32):
    """The steps dK/dV block ``block`` walks, in order, as (batch, key
    tile, head, query tile): split c of a key tile taking steps
    [n·c/splits, n·(c+1)/splits) of its n (head slowest); ``dtype``'s
    tiles."""
    b, kh, t, c = _dkdv_block(block, B, Skv, KH, Dh, splits, dtype)
    G = H // KH
    qt0, nq = k3.dkdv_query_tiles(t, Sq, Skv, Dh, causal, window, dtype)
    n = G * nq
    return [(b, t, kh * G + s // nq, qt0 + s % nq)
            for s in range(n * c // splits, n * (c + 1) // splits)]


def _dq_block(block, B, Sq, H):
    """(batch, head, query tile) of fp32 dQ block ``block``: the head
    fastest, then the batch, the query tile slowest, the last first."""
    h, rest = block % H, block // H
    return rest % B, h, -(-Sq // k3.BWD_ROW_TILE) - 1 - rest // B


def _dq_steps(block, B, Sq, Skv, H, KH, Dh, causal, window):
    """The steps dQ block ``block`` walks, in order, as (batch, query tile,
    head, key tile): the last query tiles first, each seeing the key tiles
    from its first row's window start to its last row's causal end."""
    b, h, qt = _dq_block(block, B, Sq, H)
    q0 = qt * k3.BWD_ROW_TILE
    q_last = min(q0 + k3.BWD_ROW_TILE, Sq) - 1
    k_begin = max(0, q0 - window + 1) if window > 0 else 0
    kt0, nk = k3._tiles(k_begin, min(Skv, q_last + 1) if causal else Skv,
                        k3.BWD_KEY_STEP[Dh])
    return [(b, qt, h, kt0 + i) for i in range(nk)]


def _folded_block(block, B, Sq, H, KH, rows, head_major):
    """(batch, KV head, row tile) of a block over folded rows (bf16 dQ's,
    the bf16 forward's): the last row tiles first; head-major (a head's
    row tiles next to each other) or the row tile slowest (batch and KV
    head fastest)."""
    n_rt = -(-Sq * (H // KH) // rows)
    if head_major:
        head, y = block // n_rt, block % n_rt
    else:
        head, y = block % (B * KH), block // (B * KH)
    return head // KH, head % KH, n_rt - 1 - y


def _dq_folded_steps(block, B, Sq, Skv, H, KH, Dh, causal, window):
    """The steps bf16 dQ block ``block`` walks, as (batch, KV head, row
    tile, key tile): its rows i*G + g (``_folded_block``), and the key
    tiles from the first row's window start to the last row's causal
    end."""
    tiles = k3.bwd_tiles(Dh, torch.bfloat16)
    b, kh, rt = _folded_block(block, B, Sq, H, KH, tiles.row_tile,
                              _head_major(Dh, torch.bfloat16, "dq"))
    q_lo, q_hi = _folded_queries(rt, Sq, H // KH, tiles.row_tile)
    k_begin = max(0, q_lo - window + 1) if window > 0 else 0
    kt0, nk = k3._tiles(k_begin, min(Skv, q_hi + 1) if causal else Skv,
                        tiles.key_step)
    return [(b, kh, rt, kt0 + i) for i in range(nk)]


def _folded_queries(rt, Sq, G, rows):
    """The first and last query of folded row tile ``rt`` (row i*G + g)."""
    return rt * rows // G, (min((rt + 1) * rows, Sq * G) - 1) // G


def _visible_folded(Sq, Skv, G, causal, window, rows, cols):
    """The (folded row tile, key tile) pairs in which some query of the
    row tile sees some key of the key tile."""
    mask = _attention_mask(Sq, Skv, causal, window, "cpu")
    nc = -(-Skv // cols)
    padded = torch.zeros((Sq, nc * cols), dtype=torch.bool)
    padded[:, :Skv] = mask
    by_tile = padded.view(Sq, nc, cols).any(dim=2)          # (Sq, nc)
    out = []
    for rt in range(-(-Sq * G // rows)):
        q_lo, q_hi = _folded_queries(rt, Sq, G, rows)
        out += [(rt, int(j)) for j in
                by_tile[q_lo:q_hi + 1].any(dim=0).nonzero()[:, 0]]
    return out


def _visible(Sq, Skv, causal, window, rows, cols):
    """The (row tile, column tile) pairs of the (Sq, Skv) mask that hold an
    unmasked (query, key) pair, query tiles of ``rows``, key tiles of
    ``cols``."""
    mask = _attention_mask(Sq, Skv, causal, window, "cpu")
    nr, nc = -(-Sq // rows), -(-Skv // cols)
    padded = torch.zeros((nr * rows, nc * cols), dtype=torch.bool)
    padded[:Sq, :Skv] = mask
    hit = padded.view(nr, rows, nc, cols).any(dim=3).any(dim=1)
    return [(int(i), int(j)) for i, j in hit.nonzero()]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype,shape", CASES)
def test_dkdv_blocks_cover_every_visible_tile_once(dtype, shape, sms):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    tiles = k3.bwd_tiles(Dh, dtype)
    plan = k3.backward_plan(*shape, sms, dtype)
    splits = plan["splits"]
    n_kt = -(-Skv // tiles.key_tile)
    assert plan["dkdv_blocks"] == n_kt * B * KH * splits
    assert ("reduce" in plan["kernels"]) == (splits > 1)
    steps = [s for blk in range(plan["dkdv_blocks"])
             for s in _dkdv_steps(blk, *shape, splits, dtype)]
    want = {(b, kt, h, qt) for b in range(B) for h in range(H)
            for qt, kt in _visible(Sq, Skv, causal, window,
                                   tiles.query_tile, tiles.key_tile)}
    assert len(steps) == len(set(steps))
    assert set(steps) == want
    # each block's heads read its own KV head
    G = H // KH
    for blk in range(plan["dkdv_blocks"]):
        kh = _dkdv_block(blk, B, Skv, KH, Dh, splits, dtype)[1]
        assert all(h // G == kh for _, _, h, _ in
                   _dkdv_steps(blk, *shape, splits, dtype))


@pytest.mark.parametrize("dtype,shape", CASES)
def test_dq_blocks_cover_every_visible_tile_once(dtype, shape):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    tiles = k3.bwd_tiles(Dh, dtype)
    plan = k3.backward_plan(*shape, 132, dtype)
    if dtype == torch.float32:
        assert plan["dq_blocks"] == -(-Sq // tiles.row_tile) * B * H
        steps = [s for blk in range(plan["dq_blocks"])
                 for s in _dq_steps(blk, *shape)]
        want = {(b, qt, h, kt) for b in range(B) for h in range(H)
                for qt, kt in _visible(Sq, Skv, causal, window,
                                       tiles.row_tile, tiles.key_step)}
    else:   # folded rows: (batch, KV head, row tile, key tile)
        assert plan["dq_blocks"] == (-(-Sq * (H // KH) // tiles.row_tile)
                                     * B * KH)
        steps = [s for blk in range(plan["dq_blocks"])
                 for s in _dq_folded_steps(blk, *shape)]
        want = {(b, kh, rt, kt) for b in range(B) for kh in range(KH)
                for rt, kt in _visible_folded(Sq, Skv, H // KH, causal,
                                              window, tiles.row_tile,
                                              tiles.key_step)}
    assert len(steps) == len(set(steps))
    assert set(steps) == want


# (shape, fp32's (splits, dK/dV blocks, most steps a block), bf16's): the
# fp32 tiles' 32-query steps at Dh 64 and 16-query ones at 128 and 192,
# bf16's 64-query steps
FILL = [(chip_smoke.BWD_MAIN, (2, 192, 12), (2, 192, 6)),
        (chip_smoke.BWD_FED, (6, 144, 2), (3, 72, 2)),
        ((8, 1024, 1024, 9, 3, 64, True, 0), (1, 384, 96), (1, 384, 48)),
        (chip_smoke.BWD_CHATGLM, (3, 192, 86), (3, 192, 22)),
        (chip_smoke.BWD_TRAIN_4K, (1, 256, 4096), (1, 256, 1024)),
        (chip_smoke.BWD_DS, (1, 4096, 16), (1, 4096, 4))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_and_federated_shapes_fill_the_card(dtype):
    """The source notes' arithmetic. fp32: at smollm-135m's training shape
    one dK/dV block per (key tile, KV head, batch) would be 96 blocks on
    132 SMs, the busiest walking 24 steps of 32 queries (12 a warpgroup);
    2 splits give 192 blocks of at most 12 (6 a warpgroup); at the
    federated shape 24 blocks become 144 of at most 2 (one a warpgroup).
    bf16 (64-query steps): 192 blocks of at most 6 there, 72 of at most 2
    at the federated shape; chatglm3-6b's training shape (B 8, S 256, G 16,
    Dh 128) has 64 blocks of 64 keys, split 3 ways; train_4k's (B 2, S
    4096) 256 blocks and no split; deepseek-v3's (B 8, S 256, 128 heads
    of Dh 192) 4096 blocks and no split in both dtypes, the busiest walking
    16 steps of 16 queries in fp32. The serving shape has 384 blocks and no
    split; the dQ grids start with the last query tiles (the most keys
    under the causal mask)."""
    for shape, *want in FILL:
        plan = k3.backward_plan(*shape, 132, dtype)
        splits, blocks, most = want[dtype == torch.bfloat16]
        assert (plan["splits"], plan["dkdv_blocks"]) == (splits, blocks)
        assert plan["kernels"] == ("dot", "dkdv") + (
            ("reduce",) if splits > 1 else ()) + ("dq",)
        lengths = [len(_dkdv_steps(blk, *shape, splits, dtype))
                   for blk in range(blocks)]
        assert max(lengths) == most
        # key tiles in the grid's order, the most steps first: over the
        # grid, or within each head where a head's blocks are contiguous
        B, Sq, Skv, H, KH, Dh = shape[:6]
        major = _head_major(Dh, dtype)
        where = [_dkdv_block(blk, B, Skv, KH, Dh, splits, dtype)
                 for blk in range(blocks)]
        for run in _runs([(b, kh) if major else 0 for b, kh, _, _ in where]):
            tiles = [where[i][2] for i in run]
            assert tiles == sorted(tiles)
            totals = [sum(lengths[i] for i in run if where[i][2] == t)
                      for t in dict.fromkeys(tiles)]
            assert totals == sorted(totals, reverse=True)
        walk = _dq_steps if dtype == torch.float32 else _dq_folded_steps
        dq = [len(walk(blk, *shape)) for blk in range(plan["dq_blocks"])]
        if dtype == torch.float32:
            assert dq == sorted(dq, reverse=True)
        elif _head_major(Dh, dtype, "dq"):   # a head's row tiles next to
            # each other, the last first
            heads = [_folded_block(blk, B, Sq, H, KH, k3.BWD_BF16_ROW_TILE,
                                   True)[:2] for blk in range(len(dq))]
            for run in _runs(heads):
                assert [dq[i] for i in run] == sorted(
                    (dq[i] for i in run), reverse=True)
        else:   # B x KH blocks a row tile, the last row tiles first
            per_row_tile = shape[0] * shape[4]
            firsts = dq[::per_row_tile]
            assert firsts == sorted(firsts, reverse=True)


def _runs(keys):
    """The runs of equal neighbours in ``keys`` (lists of indices), checked
    to be one run a key: a key's items are contiguous."""
    runs, seen = [], set()
    for i, key in enumerate(keys):
        if runs and keys[runs[-1][0]] == key:
            runs[-1].append(i)
        else:
            assert key not in seen, f"{key} is not contiguous"
            seen.add(key)
            runs.append([i])
    return runs


def test_dh192_dkdv_warpgroups_share_every_step():
    """At Dh 192 the dK/dV kernels' two warpgroups (bf16's and fp32's)
    take every step together, so the plan's cap counts one step a split,
    not one a warpgroup: in bf16 4 key tiles of one (batch, KV head) with 8
    steps each split 8 ways on 132 SMs, where the alternate-step dims (2
    groups) split 4 ways; the tiles are otherwise the other dims'. In bf16
    the block's warpgroups (the alternate-step dims' groups) compute S^T
    and dP^T once a step between them, each for an equal share of the
    step's queries, and then each sums an equal share of dV's and dK's 192
    columns over all the step's queries: each share a wgmma N (a multiple
    of 8) and whole 64-byte swizzle boxes of columns. In fp32 the tiles
    are Dh 128's (one group, 16-query steps), and the 32 steps of key tile
    0 split 32 ways."""
    shape = (1, 256, 256, 2, 1, 192, True, 0)
    tiles = k3.bwd_tiles(192, torch.bfloat16)
    assert tiles.groups == 1
    assert tiles._replace(groups=2) == k3.bwd_tiles(128, torch.bfloat16)
    assert k3.backward_plan(*shape, 132, torch.bfloat16)["splits"] == 8
    assert k3.backward_plan(*shape[:5], 128, *shape[6:], 132,
                            torch.bfloat16)["splits"] == 4
    assert 192 in k3.BWD_HEAD_DIMS
    assert k3.bwd_tiles(192) == k3.bwd_tiles(128)
    assert k3.bwd_tiles(192).groups == 1
    assert k3.backward_plan(*shape, 132)["splits"] == 32
    warpgroups = k3.bwd_tiles(128, torch.bfloat16).groups
    queries, rem_q = divmod(tiles.query_tile, warpgroups)
    columns, rem_c = divmod(192, warpgroups)
    assert warpgroups == 2 and rem_q == rem_c == 0
    assert queries % 8 == 0 and columns % 8 == 0 and columns * 2 % 64 == 0


# the bf16 forward's folded rows a block (csrc/flash_attention_bf16.cu: two
# consumer warpgroups of 64), at every head dim
FWD_BF16_ROWS = 128
# every Dh 192 shape chip_smoke.py checks, forward and backward: deepseek-
# v3's prefill and training shapes, B x KH below and above 132, splits,
# G > 1, ragged, windows, fully masked rows, the tiles' edges
WIDE_SHAPES = list(dict.fromkeys(chip_smoke.ATTN_DS_SHAPES
                                 + chip_smoke.BWD_DS_SHAPES + DS_SHAPES))


@pytest.mark.parametrize("kind", ["forward", "dkdv", "dq"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_dh192_blocks_cover_each_tile_once_head_major(shape, kind):
    """The bf16 kernels at Dh 192 launch head-major: every (batch, KV head,
    tile) block (and every split of a dK/dV key tile) exactly once, a
    head's blocks next to each other (so its tiles read the same K and V,
    or Q and dO, while they are in L2), and within a head the heaviest
    first: the forward's and dQ's last row tiles, dK/dV's key tile 0 (each
    the most work under the causal mask, where the test checks that
    too)."""
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    G = H // KH
    if kind == "dkdv":
        plan = k3.backward_plan(*shape, 132, torch.bfloat16)
        splits, n = plan["splits"], plan["dkdv_blocks"]
        where = [_dkdv_block(blk, B, Skv, KH, Dh, splits, torch.bfloat16)
                 for blk in range(n)]
        want = {(b, kh, t, c) for b in range(B) for kh in range(KH)
                for t in range(-(-Skv // k3.BWD_BF16_KEY_TILE))
                for c in range(splits)}
        work = [len(_dkdv_steps(blk, *shape, splits, torch.bfloat16))
                for blk in range(n)]
    else:
        rows = k3.BWD_BF16_ROW_TILE if kind == "dq" else FWD_BF16_ROWS
        n = -(-Sq * G // rows) * B * KH
        if kind == "dq":
            assert n == k3.backward_plan(*shape, 132,
                                         torch.bfloat16)["dq_blocks"]
        where = [_folded_block(blk, B, Sq, H, KH, rows, True)
                 for blk in range(n)]
        want = {(b, kh, rt) for b in range(B) for kh in range(KH)
                for rt in range(-(-Sq * G // rows))}
        # the queries a block's rows reach: the keys it walks under causal
        work = [_folded_queries(rt, Sq, G, rows)[1] + 1
                for _, _, rt in where]
    assert len(where) == len(set(where)) and set(where) == want
    for run in _runs([w[:2] for w in where]):
        tiles = [where[i][2] for i in run]
        assert tiles == sorted(tiles, reverse=kind != "dkdv")
        if causal and not window:
            totals = [sum(work[i] for i in run if where[i][2] == t)
                      for t in dict.fromkeys(tiles)]
            assert totals == sorted(totals, reverse=True)


@pytest.mark.parametrize("kind", ["forward", "dkdv", "dq"])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_dh192_fp32_blocks_cover_each_tile_once(shape, kind):
    """The fp32 kernels at Dh 192 launch every block once: dK/dV
    head-major (a head's key tiles, and each one's splits, next to each
    other, key tile 0 first: they read the same Q and dO while it is in
    L2), the forward (128 folded rows a block) and dQ (64 query rows) with
    the row tile the grid's slowest axis, the last rows first, so that
    under the causal mask the blocks come heaviest first over the whole
    grid."""
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    G = H // KH
    plan = k3.backward_plan(*shape, 132)
    if kind == "dkdv":
        splits, n = plan["splits"], plan["dkdv_blocks"]
        where = [_dkdv_block(blk, B, Skv, KH, Dh, splits) for blk in range(n)]
        want = {(b, kh, t, c) for b in range(B) for kh in range(KH)
                for t in range(-(-Skv // k3.BWD_KEY_TILE))
                for c in range(splits)}
        assert len(where) == len(set(where)) and set(where) == want
        for run in _runs([w[:2] for w in where]):
            tiles = [where[i][2] for i in run]
            assert tiles == sorted(tiles)
        return
    if kind == "dq":
        n = plan["dq_blocks"]
        blocks = [_dq_block(blk, B, Sq, H) for blk in range(n)]
        assert len(set(blocks)) == n == len(blocks)
        assert set(blocks) == {(b, h, qt) for b in range(B) for h in range(H)
                               for qt in range(-(-Sq // k3.BWD_ROW_TILE))}
        work = [len(_dq_steps(blk, *shape)) for blk in range(n)]
    else:
        rows = FWD_TILES[Dh][0]
        n = -(-Sq * G // rows) * B * KH
        blocks = [_folded_block(blk, B, Sq, H, KH, rows, False)
                  for blk in range(n)]
        assert len(set(blocks)) == n == len(blocks)
        assert set(blocks) == {(b, kh, rt) for b in range(B)
                               for kh in range(KH)
                               for rt in range(-(-Sq * G // rows))}
        work = [len(_forward_tiles(rt * rows, *shape[1:6], causal, window))
                for _, _, rt in blocks]
    if causal and not window:
        assert work == sorted(work, reverse=True)


def test_bf16_and_fp32_plans_are_keyed_apart():
    """``backward_plan`` caches one plan a (shape, card, dtype): the bf16
    plan at the federated shape (64-query steps: 3 splits) is not the fp32
    one (32-query steps: 6), whichever is asked first, and ``bwd_tiles``
    gives each dtype its own tiles."""
    shape = chip_smoke.BWD_FED
    for first, second in ((torch.bfloat16, torch.float32),
                          (torch.float32, torch.bfloat16)):
        k3.backward_plan.cache_clear()
        a = k3.backward_plan(*shape, 132, first)
        b = k3.backward_plan(*shape, 132, second)
        plans = {first: a, second: b}
        assert plans[torch.float32]["splits"] == 6
        assert plans[torch.bfloat16]["splits"] == 3
        assert k3.backward_plan(*shape, 132) == plans[torch.float32]
    assert k3.bwd_tiles(64, torch.bfloat16) != k3.bwd_tiles(64)
    assert k3.bwd_tiles(128, torch.bfloat16).folded_rows
    assert not k3.bwd_tiles(128).folded_rows


# ---------------------------------------------------- explicit positions
#
# With explicit positions (the kernels' kPos instantiations) no index band
# bounds a block's tiles: a dK/dV block walks the query tiles from the
# first to the last that holds a query that may see one of its keys (by
# its keys' least and greatest valid position), a dQ block the key tiles
# from the first to the last that holds a key one of its rows may see (by
# its rows' least and greatest position), and a forward block likewise
# the key tiles of its folded rows. The split and the grids are the
# plan's. Positions tie, carry -1 and need not be sorted.

# the forward's (rows a block, keys a tile) by head dim
# (csrc/flash_attention.cu: Cfg, and at Dh 192 its own kernel's two
# consumer warpgroups of 64 rows and 16-key tiles)
FWD_TILES = {48: (128, 64), 64: (128, 64), 96: (128, 32), 112: (128, 32),
             128: (64, 32), 192: (128, 16)}
POSITION_SHAPES = EXTRA + [chip_smoke.BWD_MAIN, chip_smoke.BWD_FED,
                           (2, 200, 200, 9, 3, 64, True, 0),
                           (1, 77, 50, 16, 1, 64, False, 20),
                           (1, 200, 130, 6, 2, 64, True, 70)]
PATTERNS = ["mrope", "pad", "unsorted", "shifted"]


def _pattern(name, n, seed=0):
    """Positions of ``n`` tokens: ``mrope`` ties the first 16 at 0 (a 4 x
    4 image) and counts on from 4; ``pad`` ends in ten -1s; ``unsorted``
    permutes ``mrope``; ``shifted`` is the indices + 20 (keys past every
    query); else the indices."""
    ar = torch.arange(n, dtype=torch.int32)
    if name in ("mrope", "unsorted"):
        pos = torch.where(ar < 16, 0, ar - 12).to(torch.int32)
        if name == "unsorted":
            g = torch.Generator().manual_seed(seed)
            pos = pos[torch.randperm(n, generator=g)]
        return pos
    if name == "pad":
        return torch.where(ar < n - 10, ar, -1).to(torch.int32)
    if name == "shifted":
        return ar + 20
    return ar


def _may_see_range(pos, may):
    """(first, count) of the tiles, in units of ``tile``, between the
    first and the last index whose position passes ``may``."""
    hits = may(pos).nonzero()
    if not len(hits):
        return None
    return int(hits[0]), int(hits[-1])


def _tile_span(first_last, tile):
    if first_last is None:
        return 0, 0
    first, last = first_last
    return first // tile, last // tile + 1 - first // tile


def _position_dkdv_steps(block, B, Sq, Skv, H, KH, Dh, causal, window,
                         splits, qpos, kpos):
    b, kh, t, c = _dkdv_block(block, B, Skv, KH, Dh, splits)
    G, QT = H // KH, k3.BWD_QUERY_TILE[Dh]
    keys = kpos[t * k3.BWD_KEY_TILE:(t + 1) * k3.BWD_KEY_TILE]
    valid = keys[keys >= 0]
    span = None
    if len(valid):
        lo, hi = int(valid.min()), int(valid.max())
        span = _may_see_range(qpos, lambda p: (~torch.tensor(causal)
                                               | (lo <= p))
                              & ((window <= 0) | (hi > p - window)))
    qt0, nq = _tile_span(span, QT)
    n = G * nq
    return [(b, t, kh * G + s // nq, qt0 + s % nq)
            for s in range(n * c // splits, n * (c + 1) // splits)]


def _position_dq_steps(block, B, Sq, Skv, H, KH, Dh, causal, window, qpos,
                       kpos):
    b, h, qt = _dq_block(block, B, Sq, H)
    rows = qpos[qt * k3.BWD_ROW_TILE:(qt + 1) * k3.BWD_ROW_TILE]
    lo, hi = int(rows.min()), int(rows.max())
    span = _may_see_range(kpos, lambda p: (p >= 0)
                          & (~torch.tensor(causal) | (p <= hi))
                          & ((window <= 0) | (p > lo - window)))
    kt0, nk = _tile_span(span, k3.BWD_KEY_STEP[Dh])
    return [(b, qt, h, kt0 + i) for i in range(nk)]


def _forward_tiles(row0, Sq, Skv, H, KH, Dh, causal, window, qpos=None,
                   kpos=None):
    """The key tiles a forward block whose folded rows start at ``row0``
    walks: from the index band, or from the positions."""
    rows, keys = FWD_TILES[Dh]
    G = H // KH
    q_lo, q_hi = row0 // G, (min(row0 + rows, Sq * G) - 1) // G
    if qpos is None:
        k_begin = max(0, q_lo - window + 1) if window > 0 else 0
        k_end = min(Skv, q_hi + 1) if causal else Skv
        t0 = k_begin // keys
        return range(t0, -(-k_end // keys) if k_end > k_begin else t0)
    lo, hi = int(qpos[q_lo:q_hi + 1].min()), int(qpos[q_lo:q_hi + 1].max())
    span = _may_see_range(kpos, lambda p: (p >= 0)
                          & (~torch.tensor(causal) | (p <= hi))
                          & ((window <= 0) | (p > lo - window)))
    t0, n = _tile_span(span, keys)
    return range(t0, t0 + n)


def _positions(shape, name):
    Sq, Skv = shape[1], shape[2]
    return _pattern(name, Sq), _pattern(name, Skv)


def _visible_at(Sq, Skv, causal, window, rows, cols, qpos, kpos):
    mask = _attention_mask(Sq, Skv, causal, window, "cpu", qpos, kpos)
    nr, nc = -(-Sq // rows), -(-Skv // cols)
    padded = torch.zeros((nr * rows, nc * cols), dtype=torch.bool)
    padded[:Sq, :Skv] = mask
    hit = padded.view(nr, rows, nc, cols).any(dim=3).any(dim=1)
    return [(int(i), int(j)) for i, j in hit.nonzero()]


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("shape", POSITION_SHAPES)
def test_position_dkdv_blocks_cover_every_visible_tile_once(shape, name):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    qpos, kpos = _positions(shape, name)
    plan = k3.backward_plan(*shape, 132)
    steps = [s for blk in range(plan["dkdv_blocks"])
             for s in _position_dkdv_steps(blk, *shape, plan["splits"],
                                           qpos, kpos)]
    want = {(b, kt, h, qt) for b in range(B) for h in range(H)
            for qt, kt in _visible_at(Sq, Skv, causal, window,
                                      k3.BWD_QUERY_TILE[Dh],
                                      k3.BWD_KEY_TILE, qpos, kpos)}
    assert len(steps) == len(set(steps))
    assert want <= set(steps)


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("shape", POSITION_SHAPES)
def test_position_dq_and_forward_blocks_cover_every_visible_tile(shape,
                                                                 name):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    qpos, kpos = _positions(shape, name)
    plan = k3.backward_plan(*shape, 132)
    steps = [s for blk in range(plan["dq_blocks"])
             for s in _position_dq_steps(blk, *shape, qpos, kpos)]
    want = {(b, qt, h, kt) for b in range(B) for h in range(H)
            for qt, kt in _visible_at(Sq, Skv, causal, window,
                                      k3.BWD_ROW_TILE, k3.BWD_KEY_STEP[Dh],
                                      qpos, kpos)}
    assert len(steps) == len(set(steps))
    assert want <= set(steps)
    rows, keys = FWD_TILES[Dh]
    G = H // KH
    mask = _attention_mask(Sq, Skv, causal, window, "cpu", qpos, kpos)
    for row0 in range(0, Sq * G, rows):
        q_lo, q_hi = row0 // G, (min(row0 + rows, Sq * G) - 1) // G
        seen = mask[q_lo:q_hi + 1].any(0).nonzero()
        walked = _forward_tiles(row0, Sq, Skv, H, KH, Dh, causal, window,
                                qpos, kpos)
        assert {int(j) // keys for j in seen} <= set(walked)


@pytest.mark.parametrize("shape", POSITION_SHAPES + [
    (1, 300, 300, 6, 2, 112, True, 0), (2, 129, 97, 40, 40, 96, True, 16),
    (1, 77, 50, 16, 1, 48, False, 20), (1, 130, 130, 6, 2, 192, True, 70)])
def test_arange_positions_walk_the_index_tiles(shape):
    """For an arange the position rules give every block the index band's
    tiles, in the same order: the position instantiations then sum the
    same products in the same order, bit for bit the index ones."""
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    qpos, kpos = _positions(shape, "arange")
    G = H // KH
    for row0 in range(0, Sq * G, FWD_TILES[Dh][0]):
        assert list(_forward_tiles(row0, *shape[1:6], causal, window, qpos,
                                   kpos)) == list(_forward_tiles(
                                       row0, *shape[1:6], causal, window))
    if Dh not in k3.BWD_HEAD_DIMS:
        return
    plan = k3.backward_plan(*shape, 132)
    for blk in range(plan["dkdv_blocks"]):
        assert _position_dkdv_steps(blk, *shape, plan["splits"], qpos,
                                    kpos) == _dkdv_steps(blk, *shape,
                                                         plan["splits"])
    for blk in range(plan["dq_blocks"]):
        assert _position_dq_steps(blk, *shape, qpos, kpos) == _dq_steps(
            blk, *shape)


class _FakeFn:
    def __init__(self, impl):
        self.impl, self.argtypes, self.restype = impl, None, None

    def __call__(self, *args):
        return self.impl(*args)


def _fake_library(prefix, tiles):
    """A stand-in for a backward library: its tiles function reports
    ``tiles(dh)`` (None: refuses the head dim), every launch returns 0."""
    def report(dh, *refs):
        got = tiles(dh)
        if got is None:
            return 1
        for ref, value in zip(refs, got):
            ref._obj.value = value
        return 0
    fns = {f"{prefix}tiles": report, f"{prefix}positions_built":
           lambda dh: int(dh in k3.BWD_POSITION_HEAD_DIMS)}
    fns.update({f"{prefix}{name}_launch": lambda *a: 0
                for name in k3.backward_launches})
    return type("Lib", (), {n: _FakeFn(f) for n, f in fns.items()})()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_library_is_held_to_the_wrapper_tiles(monkeypatch, dtype):
    """Each dtype's backward library is loaded once its tiles match
    ``bwd_tiles`` at the head dims it takes (and it refuses the others);
    one whose tiles differ raises on every load and is never kept."""
    bf16 = dtype == torch.bfloat16
    dims = k3.BWD_BF16_HEAD_DIMS if bf16 else k3.BWD_HEAD_DIMS
    prefix = "attn_bwd_bf16_" if bf16 else "attn_bwd_"
    good = _fake_library(prefix, lambda dh: list(
        k3.bwd_tiles(dh, dtype))[:5] if dh in dims else None)
    bad = _fake_library(prefix, lambda dh: [32] * 5 if dh in dims else None)
    monkeypatch.setattr(k3, "_libs", {})
    monkeypatch.setattr(k3._build, "load", lambda name: bad)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="tiles"):
            k3._bwd_library(dtype)
    assert k3._libs == {}
    monkeypatch.setattr(k3._build, "load", lambda name: good)
    assert k3._bwd_library(dtype) is good
    assert k3._bwd_library(dtype) is good
