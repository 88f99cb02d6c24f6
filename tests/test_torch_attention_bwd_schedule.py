"""K3's backward schedule (``repro_torch/kernels/flash_attention.py``):
the dK/dV and dQ grids that ``backward_plan`` sizes, walked block by block
with the rule ``csrc/flash_attention_bwd.cu`` follows (``_dkdv_steps``,
``_dq_steps`` below), cover every (key tile, query tile, head) that holds
an unmasked pair once and only once. Over ``chip_smoke.py``'s backward
sweep and shapes at the tiles' edges, on cards of several sizes (so both
the split and the unsplit dK/dV grids are walked). CPU only: the plan is
host arithmetic; the card-only tests hold the kernels' gradients to the
plain backward at the same shapes."""
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
SMS = (132, 1, 16, 1000)


def _dkdv_steps(block, B, Sq, Skv, H, KH, Dh, causal, window, splits):
    """The steps dK/dV block ``block`` walks, in order, as (batch, key
    tile, head, query tile): key tile slowest in the grid and split
    fastest, and split c taking steps [n·c/splits, n·(c+1)/splits) of its
    key tile's n (head slowest)."""
    c, rest = block % splits, block // splits
    kh, rest = rest % KH, rest // KH
    b, t = rest % B, rest // B
    G = H // KH
    qt0, nq = k3.dkdv_query_tiles(t, Sq, Skv, Dh, causal, window)
    n = G * nq
    return [(b, t, kh * G + s // nq, qt0 + s % nq)
            for s in range(n * c // splits, n * (c + 1) // splits)]


def _dq_steps(block, B, Sq, Skv, H, KH, Dh, causal, window):
    """The steps dQ block ``block`` walks, in order, as (batch, query tile,
    head, key tile): the last query tiles first, each seeing the key tiles
    from its first row's window start to its last row's causal end."""
    h, rest = block % H, block // H
    b = rest % B
    qt = -(-Sq // k3.BWD_ROW_TILE) - 1 - rest // B
    q0 = qt * k3.BWD_ROW_TILE
    q_last = min(q0 + k3.BWD_ROW_TILE, Sq) - 1
    k_begin = max(0, q0 - window + 1) if window > 0 else 0
    kt0, nk = k3._tiles(k_begin, min(Skv, q_last + 1) if causal else Skv,
                        k3.BWD_KEY_STEP[Dh])
    return [(b, qt, h, kt0 + i) for i in range(nk)]


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
@pytest.mark.parametrize("shape", SHAPES)
def test_dkdv_blocks_cover_every_visible_tile_once(shape, sms):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    plan = k3.backward_plan(*shape, sms)
    splits = plan["splits"]
    n_kt = -(-Skv // k3.BWD_KEY_TILE)
    assert plan["dkdv_blocks"] == n_kt * B * KH * splits
    assert ("reduce" in plan["kernels"]) == (splits > 1)
    steps = [s for blk in range(plan["dkdv_blocks"])
             for s in _dkdv_steps(blk, *shape, splits)]
    want = {(b, kt, h, qt) for b in range(B) for h in range(H)
            for qt, kt in _visible(Sq, Skv, causal, window,
                                   k3.BWD_QUERY_TILE[Dh], k3.BWD_KEY_TILE)}
    assert len(steps) == len(set(steps))
    assert set(steps) == want
    # each block's heads read its own KV head
    G = H // KH
    for blk in range(plan["dkdv_blocks"]):
        kh = blk // splits % KH
        assert all(h // G == kh for _, _, h, _ in
                   _dkdv_steps(blk, *shape, splits))


@pytest.mark.parametrize("shape", SHAPES)
def test_dq_blocks_cover_every_visible_tile_once(shape):
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    plan = k3.backward_plan(*shape, 132)
    assert plan["dq_blocks"] == -(-Sq // k3.BWD_ROW_TILE) * B * H
    steps = [s for blk in range(plan["dq_blocks"])
             for s in _dq_steps(blk, *shape)]
    want = {(b, qt, h, kt) for b in range(B) for h in range(H)
            for qt, kt in _visible(Sq, Skv, causal, window,
                                   k3.BWD_ROW_TILE, k3.BWD_KEY_STEP[Dh])}
    assert len(steps) == len(set(steps))
    assert set(steps) == want


def test_training_and_federated_shapes_fill_the_card():
    """The source note's arithmetic: at smollm-135m's training shape one
    dK/dV block per (key tile, KV head, batch) would be 96 blocks on 132
    SMs, the busiest walking 24 steps of 32 queries (12 a warpgroup); 2
    splits give 192 blocks of at most 12 (6 a warpgroup). At the federated
    shape 24 blocks become 144 of at most 2 (one a warpgroup). The serving
    shape has 384 blocks and no split; the dQ grids start with the last
    query tiles (the most keys under the causal mask)."""
    train = k3.backward_plan(*chip_smoke.BWD_MAIN, 132)
    assert (train["splits"], train["dkdv_blocks"]) == (2, 192)
    fed = k3.backward_plan(4, 128, 128, 9, 3, 64, True, 0, 132)
    assert (fed["splits"], fed["dkdv_blocks"]) == (6, 144)
    serve = k3.backward_plan(8, 1024, 1024, 9, 3, 64, True, 0, 132)
    assert (serve["splits"], serve["dkdv_blocks"]) == (1, 384)
    assert serve["kernels"] == ("dot", "dkdv", "dq")
    for shape, plan, most in ((chip_smoke.BWD_MAIN, train, 12),
                              ((4, 128, 128, 9, 3, 64, True, 0), fed, 2)):
        lengths = [len(_dkdv_steps(blk, *shape, plan["splits"]))
                   for blk in range(plan["dkdv_blocks"])]
        assert max(lengths) == most
        # key tiles in the grid's order, the most steps first
        per_tile = plan["dkdv_blocks"] // -(-shape[2] // k3.BWD_KEY_TILE)
        totals = [sum(lengths[i:i + per_tile])
                  for i in range(0, len(lengths), per_tile)]
        assert totals == sorted(totals, reverse=True)
        dq = [len(_dq_steps(blk, *shape))
              for blk in range(plan["dq_blocks"])]
        assert dq == sorted(dq, reverse=True)
