"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the reference's sweep shapes, the pFedWN round's shapes and the LM
prefill's (granite-moe's H 24 over KH 8 among them), K3 also at MLA's head
dims (48, 96, deepseek-v3's 192) and zamba2's (112), K3's backward against
its plain version in float64 (fp32, and bf16 through its own kernels,
beside the plain version of their bf16 arithmetic; Dh 192 in both),
K3 with explicit positions (forward and backward at every head dim, and
the arange bitwise the index path); every federated method, the serving path
(GQA, MLA, MoE with and without capacity drops, Mamba1 and Mamba2 with
zamba2's shared block, qwen2-vl and musicgen after their stub prefix; the
dense configs also in bf16) and LM training (also under M-RoPE positions,
and a bf16 ``make_train_step``) and the multi-pod round step on the
card against the CPU, with the kernel launches each path makes; K2 at
the round step's full-width mix. Every test
here needs a CUDA card and skips without one; the file imports nothing of
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import chip_smoke  # noqa: E402
from repro_torch.core.fedsim import METHODS  # noqa: E402
from repro_torch.kernels import em_posterior as k1  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import weighted_agg as k2  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _em_inputs(M, T, V, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=M)
    pi = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    logits = (rng.normal(size=(M, T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int64)
    return pi, logits, labels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _em_check(args, dtype, equal_nan=False):
    """One K1 launch on ``args`` against the plain version at the
    reference's tolerances (λ atol; ℓ atol and rtol 1e-5 in fp32)."""
    before = k1.launches
    lam, ell = k1.em_posterior_forward(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    plam, pell = tref.em_posterior_ref(*args)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(lam, plam, atol=tol, rtol=0,
                               equal_nan=equal_nan)
    torch.testing.assert_close(ell, pell, atol=tol, rtol=1e-5,
                               equal_nan=equal_nan)


def _em_card(pi, logits, labels, cuda, dtype):
    return (torch.from_numpy(pi).to(cuda),
            torch.from_numpy(logits).to(device=cuda, dtype=DTYPES[dtype]),
            torch.from_numpy(labels).to(cuda))


# (M, T, V): the reference's sweep, the round's shape, then both sides of
# each team-size switch (V 1, 2, 16, 17, 31, 32, 33, 512, 520, 1024, 1025,
# 49,152), M 1, 16, 17 and 32, and T off the token tile (515 and 700
# tokens leave 3 and 4 in the last tile; 4099 leaves 3 of 32)
EM_SHAPES = [(2, 128, 512), (3, 384, 1536), (10, 512, 10), (3, 37, 10),
             (32, 9, 33), (1, 16, 1), (16, 37, 2), (4, 33, 16), (4, 33, 17),
             (17, 53, 31), (32, 9, 32), (1, 100, 33), (5, 20, 512),
             (3, 24, 520), (16, 33, 1024), (17, 20, 1025), (32, 16, 1025),
             (8, 16, 49_152), (10, 515, 10), (2, 700, 33), (1, 4099, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,V", EM_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_kernel_matches_plain_on_card(cuda, M, T, V, dtype):
    _em_check(_em_card(*_em_inputs(M, T, V), cuda, dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,V", [(10, 515, 10), (3, 40, 33),
                                   (2, 16, 1025), (8, 16, 49_152)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_kernel_labels_at_row_ends_on_card(cuda, M, T, V,
                                                        dtype):
    """Labels on a row's first and last logit: the first and last lane of a
    team, the first and last vector of a chunk."""
    pi, logits, _ = _em_inputs(M, T, V)
    labels = np.where(np.arange(T) % 2 == 0, 0, V - 1).astype(np.int64)
    _em_check(_em_card(pi, logits, labels, cuda, dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,V", [(10, 512, 10), (3, 64, 1024),
                                   (4, 16, 49_152)])
def test_em_posterior_kernel_large_logits_on_card(cuda, M, T, V):
    """Logits 100x the sweep's (ℓ reaches ~10^3): ℓ is summed as (max −
    label logit) + log Σexp, so the components near the top of λ keep the
    plain version's absolute error."""
    pi, logits, labels = _em_inputs(M, T, V)
    _em_check(_em_card(pi, logits * 100, labels, cuda, "float32"),
              "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,offset", [("float32", 1), ("bfloat16", 2)])
@pytest.mark.parametrize("M,T,V", [(10, 512, 10), (3, 37, 1024)])
def test_em_posterior_kernel_reads_an_offset_view_on_card(cuda, dtype,
                                                          offset, M, T, V):
    """Logits that are a contiguous view 4 bytes past an 8-byte boundary:
    the plan drops to 4-byte vectors and the rows still line up."""
    pi, logits, labels = _em_inputs(M, T, V)
    flat = torch.zeros(M * T * V + offset, device=cuda, dtype=DTYPES[dtype])
    view = flat[offset:].view(M, T, V)
    view.copy_(torch.from_numpy(logits))
    assert view.data_ptr() % 8 == 4 and view.is_contiguous()
    p = k1.plan(M, T, V, view.dtype, view.data_ptr(), 132,
                *k1.kernel_limits())
    assert p.vector_bytes == 4
    args = (torch.from_numpy(pi).to(cuda), view,
            torch.from_numpy(labels).to(cuda))
    _em_check(args, dtype)


@pytest.mark.gpu
def test_em_posterior_kernel_limits_on_card(cuda):
    """The built kernel's tuning is the one the CPU tests of
    ``em_posterior.plan`` assume: 4 vectors a lane, 256 threads a block."""
    assert k1.kernel_limits() == (4, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [10, 33, 1025])
def test_em_posterior_kernel_infinite_rows_on_card(cuda, V):
    """A row of all −∞ gives NaN in ℓ and in that token's λ, and a label
    logit of −∞ gives ℓ = +∞ and λ = 0, as the plain version does."""
    pi, logits, labels = _em_inputs(4, 37, V)
    logits[1, 5, :] = -np.inf
    logits[2, 9, labels[9]] = -np.inf
    logits[0, 11, :] = -np.inf
    logits[0, 11, labels[11]] = 0.0          # only the label is finite
    args = _em_card(pi, logits, labels, cuda, "float32")
    _em_check(args, "float32", equal_nan=True)
    lam, ell = k1.em_posterior_forward(*args)
    assert torch.isnan(ell[5, 1]) and torch.isnan(lam[5]).all()
    assert ell[9, 2] == float("inf") and lam[9, 2] == 0
    assert ell[11, 0] == 0


# past 32 components: M on both sides of 32, 64 and 256 (where a tile of
# one token outgrows the kernel's shared-memory stage, which it then keeps
# in its outputs) and 1000; T small at the vocabulary's width
WIDE_M = [33, 39, 63, 64, 65, 256, 257, 1000]


@pytest.mark.gpu
@pytest.mark.parametrize("M", WIDE_M)
@pytest.mark.parametrize("V,T", [(10, 512), (1025, 37), (49_152, 2)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_kernel_past_32_components_on_card(cuda, M, V, T,
                                                        dtype):
    g = torch.Generator(device=cuda).manual_seed(M)
    pi = torch.softmax(torch.randn(M, generator=g, device=cuda), 0)
    logits = (torch.randn((M, T, V), generator=g, device=cuda) * 3).to(
        DTYPES[dtype])
    labels = torch.randint(0, V, (T,), generator=g, device=cuda)
    _em_check((pi, logits, labels), dtype)


@pytest.mark.gpu
def test_em_posterior_staged_kernel_infinite_rows_on_card(cuda):
    """The output-staged path (M = 257) keeps the plain version's NaN and
    +∞ rows."""
    pi, logits, labels = _em_inputs(257, 37, 10)
    logits[1, 5, :] = -np.inf
    logits[200, 9, labels[9]] = -np.inf
    args = _em_card(pi, logits, labels, cuda, "float32")
    _em_check(args, "float32", equal_nan=True)
    lam, ell = k1.em_posterior_forward(*args)
    assert torch.isnan(ell[5, 1]) and torch.isnan(lam[5]).all()
    assert ell[9, 200] == float("inf") and lam[9, 200] == 0


@pytest.mark.gpu
def test_em_posterior_counts_one_launch_per_call_on_card(cuda):
    """Each forward is one launch whatever the plan (teams of 2, 8 and 32
    lanes); the ℓ backward is plain PyTorch and launches nothing."""
    for M, T, V in [(10, 512, 10), (17, 53, 31), (2, 16, 1025)]:
        pi, logits, labels = _em_card(*_em_inputs(M, T, V), cuda, "float32")
        logits.requires_grad_(True)
        before = k1.launches
        lam, ell = k1.em_posterior(pi, logits, labels)
        assert k1.launches == before + 1
        (ell * lam.detach()).sum().backward()
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        assert logits.grad.shape == logits.shape


@pytest.mark.gpu
@pytest.mark.parametrize("M,P", [(2, 4096), (3, 8191), (10, 188_810)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("any_ok", [True, False])
def test_weighted_agg_kernel_matches_plain_on_card(cuda, M, P, dtype, any_ok):
    tdtype = DTYPES[dtype]
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(rng.normal(size=(M + 1, P)).astype(np.float32))
    stack = stack.to(device=cuda, dtype=tdtype)
    rows = torch.arange(M, 0, -1, device=cuda)
    w = torch.softmax(torch.from_numpy(rng.normal(size=M)).float(), 0).to(cuda)
    ok = torch.tensor(any_ok, device=cuda)
    before = k2.launches
    out = k2.weighted_agg(stack[0], stack, w, 0.7, index=rows, any_ok=ok)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    expect = tref.weighted_agg_ref(stack[0], stack, w, 0.7, index=rows,
                                   any_ok=ok)
    tol = 1e-6 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [188_810, 188_811, 188_812])
@pytest.mark.parametrize("M", [1, 10, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("any_ok", [True, False])
def test_weighted_agg_kernel_alignment_sweep_on_card(cuda, stride, M, dtype,
                                                     any_ok):
    """Row strides that give the kernel 8-, 4- and 16-byte vectors in fp32
    (4-, 2- and 8-byte in bf16), with the ragged tail that P = 188,810
    leaves, at the extremes of M and the round's M."""
    tdtype = DTYPES[dtype]
    P = 188_810
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.normal(size=(M + 1, stride)).astype(
        np.float32)).to(device=cuda, dtype=tdtype)
    stack = buf[:, :P]                      # rows of P, `stride` apart
    rows = torch.arange(M, 0, -1, device=cuda)
    w = torch.softmax(torch.from_numpy(rng.normal(size=M)).float(), 0).to(cuda)
    ok = torch.tensor(any_ok, device=cuda)
    before = k2.launches
    out = k2.weighted_agg(stack[0], stack, w, 0.7, index=rows, any_ok=ok)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    expect = tref.weighted_agg_ref(stack[0], stack, w, 0.7, index=rows,
                                   any_ok=ok)
    tol = 1e-6 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [188_810, 188_811, 188_812])
@pytest.mark.parametrize("M", WIDE_M)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("any_ok", [True, False])
def test_weighted_agg_kernel_past_32_neighbors_on_card(cuda, stride, M,
                                                       dtype, any_ok):
    """M = 32q + r past 32: q chunks of 32 rows and the instantiation for
    r in one launch, at row strides giving 8-, 4- and 16-byte vectors in
    fp32, the rows read in reverse; every link erased returns own."""
    P = 188_810
    g = torch.Generator(device=cuda).manual_seed(M)
    stack = torch.randn((M + 1, stride), generator=g, device=cuda).to(
        DTYPES[dtype])[:, :P]
    w = torch.softmax(torch.randn(M, generator=g, device=cuda), 0)
    rows = torch.arange(M, 0, -1, device=cuda)
    ok = torch.tensor(any_ok, device=cuda)
    before = k2.launches
    out = k2.weighted_agg(stack[0], stack, w, 0.7, index=rows, any_ok=ok)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    expect = tref.weighted_agg_ref(stack[0], stack, w, 0.7, index=rows,
                                   any_ok=ok)
    tol = 1e-6 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                               rtol=tol)
    if not any_ok:
        assert torch.equal(out, stack[0])


# the reference's sweep (tests/test_kernels.py) and ragged shapes:
# (B, Sq, Skv, H, KH, Dh, causal, window)
ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 64, False, 0),
    (1, 384, 384, 6, 2, 128, True, 96),
    (1, 128, 128, 2, 2, 128, True, 0),
    (2, 200, 200, 9, 3, 64, True, 0),
    (3, 1, 77, 12, 4, 128, True, 0),
    (1, 77, 50, 16, 1, 64, False, 20),
]
# tile edges: folded rows Sq*G just below, at and just above 64 and 128
# (a consumer warpgroup's rows, and a block's at Dh 64), and Skv just off
# the key tile (64 keys at Dh 64, 32 at Dh 128)
EDGE_SHAPES = [
    (1, 63, 65, 1, 1, 64, False, 0),
    (1, 64, 63, 1, 1, 64, True, 0),
    (1, 65, 129, 1, 1, 64, False, 0),
    (2, 42, 43, 3, 1, 64, True, 0),      # 126 rows
    (1, 64, 127, 2, 1, 64, False, 0),    # 128 rows
    (1, 43, 65, 3, 1, 64, True, 0),      # 129 rows
    (1, 63, 31, 1, 1, 128, False, 0),
    (1, 32, 33, 2, 1, 128, True, 0),     # 64 rows
    (1, 65, 97, 1, 1, 128, False, 0),
    (1, 127, 95, 1, 1, 128, False, 0),
    (1, 64, 64, 2, 1, 128, True, 0),     # 128 rows
    (1, 43, 33, 3, 1, 128, True, 16),    # 129 rows, a window
]


# MLA's head dims (qk_nope + qk_rope): 48 (minicpm3-4b at reduced()) and 96
# (minicpm3-4b) over the sweep's shapes, ragged shapes, the tile edges of
# those dims (rows off 64 and 128; keys off 64 at Dh 48 and 32 at Dh 96)
# and minicpm3-4b's prefill shape (G = 1)
MLA_ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 48, True, 0),
    (1, 256, 256, 8, 8, 96, True, 0),
    (2, 128, 128, 4, 1, 48, False, 0),
    (1, 384, 384, 6, 2, 96, True, 96),
    (2, 37, 37, 4, 4, 48, True, 0),
    (2, 200, 200, 4, 4, 96, True, 0),
    (3, 1, 77, 12, 4, 96, True, 0),
    (1, 77, 50, 16, 1, 48, False, 20),
    (1, 63, 65, 1, 1, 48, False, 0),
    (1, 43, 65, 3, 1, 48, True, 0),
    (1, 65, 129, 1, 1, 48, True, 16),
    (1, 63, 31, 1, 1, 96, False, 0),
    (1, 32, 33, 2, 1, 96, True, 0),
    (1, 43, 33, 3, 1, 96, True, 16),
    (1, 129, 97, 1, 1, 96, False, 0),
    (8, 1024, 1024, 40, 40, 96, True, 0),
]
# granite-moe-3b-a800m's prefill: 8 x 1024 tokens, 24 heads over 8 KV heads
GRANITE_PREFILL = (8, 1024, 1024, 24, 8, 64, True, 0)
# zamba2-7b's shared attention at head dim 112 (d_model 3584 / 32 heads):
# the sweep's shapes, ragged shapes, the tile edges (rows off 64 and 128,
# keys off the 32-key tile), zamba2's prefill (8 x 1024 tokens, 32 heads
# over 32 KV heads), causal and with a window
SSM_ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 112, True, 0),
    (1, 256, 256, 8, 8, 112, True, 0),
    (2, 128, 128, 4, 1, 112, False, 0),
    (1, 384, 384, 6, 2, 112, True, 96),
    (1, 128, 128, 2, 2, 112, True, 0),
    (2, 200, 200, 4, 4, 112, True, 0),
    (3, 1, 77, 12, 4, 112, True, 0),
    (1, 77, 50, 16, 1, 112, False, 20),
    (1, 63, 31, 1, 1, 112, False, 0),
    (1, 32, 33, 2, 1, 112, True, 0),
    (2, 42, 43, 3, 1, 112, True, 0),
    (1, 64, 127, 2, 1, 112, False, 0),
    (1, 43, 33, 3, 1, 112, True, 16),
    (1, 65, 129, 1, 1, 112, True, 16),
    (1, 129, 97, 1, 1, 112, False, 0),
    (8, 1024, 1024, 32, 32, 112, True, 0),
    (8, 1024, 1024, 32, 32, 112, True, 256),
]
# deepseek-v3's MLA head dim 192 (qk_nope 128 + qk_rope 64, v padded): the
# sweep's shapes, ragged, windows, fully masked rows, the tile edges (rows
# off 64 and 128; keys off the bf16 forward's 64-key tile and the fp32
# one's 16)
DS_ATTN_SHAPES = [
    (2, 256, 256, 4, 2, 192, True, 0),
    (1, 384, 384, 6, 2, 192, True, 96),
    (2, 200, 200, 4, 4, 192, True, 0),
    (3, 1, 77, 12, 4, 192, True, 0),
    (1, 77, 50, 16, 1, 192, False, 20),
    (1, 63, 65, 1, 1, 192, False, 0),
    (1, 17, 15, 3, 1, 192, True, 0),
    (2, 42, 43, 3, 1, 192, True, 0),
    (1, 65, 129, 1, 1, 192, True, 16),
    (1, 129, 97, 1, 1, 192, False, 0),
]


def _attn_inputs(B, Sq, Skv, H, KH, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dh)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KH,Dh,causal,window",
                         ATTN_SHAPES + EDGE_SHAPES + MLA_ATTN_SHAPES
                         + [GRANITE_PREFILL] + SSM_ATTN_SHAPES
                         + DS_ATTN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain_on_card(cuda, B, Sq, Skv, H, KH,
                                                      Dh, causal, window,
                                                      dtype):
    tdtype = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(device=cuda, dtype=tdtype)
               for a in _attn_inputs(B, Sq, Skv, H, KH, Dh))
    before = k3.launches
    out = k3.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    assert out.dtype == tdtype and out.shape == q.shape
    expect = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-6 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [48, 96, 112, 192])
def test_flash_attention_gradient_at_mla_and_zamba2_dims_on_card(cuda, Dh):
    """MLA's head dims (48 at reduced(), minicpm3-4b's 96, deepseek-v3's
    192) and zamba2's 112 train: the forward and each backward kernel of
    the plan launch
    once, the gradients match the float64 plain backward, and the training
    forward's output is the serving one's bit for bit."""
    shape = (2, 70, 70, 4, 2, Dh, True, 0)
    q, k, v, dout = _bwd_case(cuda, *shape)
    n, bwd = k3.launches, dict(k3.backward_launches)
    out, *grads = _kernel_grads(q, k, v, dout, True, 0)
    kernels = _bwd_kernels(cuda, *shape)
    assert k3.launches == n + 1
    assert k3.backward_launches == {name: c + (name in kernels)
                                    for name, c in bwd.items()}
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    expect = tref.flash_attention_bwd_ref(
        q64, k64, v64, tref.flash_attention_ref(q64, k64, v64),
        tref.attention_lse_ref(q64, k64), dout.double())
    for got, want in zip(grads, expect):
        torch.testing.assert_close(got.double(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)
    with torch.no_grad():
        assert torch.equal(out.detach(), k3.flash_attention(q, k, v))


@pytest.mark.gpu
def test_flash_attention_refuses_a_gradient_at_dh192_on_card(cuda):
    """deepseek-v3's full-width MLA dim 192 in fp32 no longer refuses a
    gradient: with positions or without, one forward and each fp32
    backward kernel of the plan once, no bf16 kernel; a head dim no kernel
    takes (80) still raises before any launch, with positions or without."""
    pos = torch.arange(64, device=cuda)
    for positions in ({}, dict(q_positions=pos, kv_positions=pos)):
        q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_()
                   for a in _attn_inputs(1, 64, 64, 2, 2, 192))
        n, bwd = k3.launches, dict(k3.backward_launches)
        bf16 = (k3.bf16_launches, dict(k3.bf16_backward_launches))
        k3.flash_attention(q, k, v, **positions).sum().backward()
        torch.cuda.synchronize()
        kernels = _bwd_kernels(cuda, 1, 64, 64, 2, 2, 192, True, 0)
        assert k3.launches == n + 1
        assert k3.backward_launches == {name: c + (name in kernels)
                                        for name, c in bwd.items()}
        assert (k3.bf16_launches, k3.bf16_backward_launches) == bf16
        assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
        q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_()
                   for a in _attn_inputs(1, 64, 64, 2, 2, 80))
        n, bwd = k3.launches, dict(k3.backward_launches)
        with pytest.raises(ValueError, match="head dim 80"):
            k3.flash_attention(q, k, v, **positions)
        torch.cuda.synchronize()
        assert (k3.launches, k3.backward_launches) == (n, bwd)


@pytest.mark.gpu
def test_init_params_draws_a_one_layer_group_without_a_copy_on_card(cuda):
    """``init_params`` in fp32 on the card for a MoE config whose
    ``layers`` group has one layer (reduced deepseek-v3 widened to 64
    experts of 1024 x 1024, 256 MiB an expert leaf): the group is a view
    of the drawn layer and each leaf is scaled in place, so the peak is the
    weights and no more than 32 MiB beside them (a second copy of the
    group, or of one leaf, would add 768 or 256 MiB)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config("deepseek-v3-671b").reduced()
    cfg = dataclasses.replace(cfg, d_model=1024, moe=dataclasses.replace(
        cfg.moe, n_experts=64, expert_d_ff=1024))
    assert cfg.n_layers - cfg.moe.first_k_dense == 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda, torch.float32)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated(cuda) - base
    peak = torch.cuda.max_memory_allocated(cuda) - base
    moe = params["layers"]["moe"]
    assert moe["w_gate"].shape == (1, 64, 1024, 1024)
    assert all(t._base is not None for t in moe.values()
               if torch.is_tensor(t))
    assert peak <= weights + 32 * 2**20, (peak, weights)


# the position backward at MLA's 48 and 96, zamba2's 112 and
# deepseek-v3's 192: M-RoPE's tied pattern, a -1 tail, a window, rows that
# see no key, unsorted positions, over rows and keys off the tiles
POS_BWD_PATTERNS = ["mrope", "pad", "window", "masked_rows", "unsorted"]


@pytest.mark.gpu
@pytest.mark.parametrize("Dh,dtype", [(48, "float32"), (96, "float32"),
                                      (112, "float32"), (192, "float32"),
                                      (48, "bfloat16"), (96, "bfloat16"),
                                      (112, "bfloat16"), (192, "bfloat16")])
@pytest.mark.parametrize("name", POS_BWD_PATTERNS)
def test_flash_attention_positions_backward_at_mla_and_zamba2_dims_on_card(
        cuda, Dh, dtype, name):
    """The backward's position instantiations at Dh 48, 96, 112 and 192
    in both dtypes, through the autograd path: fp32 within
    ``BWD_TOL`` (atol and rtol) of the float64 plain backward; bf16 within
    2e-2 of the float64 backward of the same bf16 values and each max
    error within twice the plain bf16 version's + 1e-4
    (``chip_smoke.BWD_BF16_PLAIN_*``); fully masked rows' dq 0; one
    position launch forward and one backward, and each backward kernel of
    the plan once."""
    shape = (2, 97, 97, 4, 2, Dh, True, 0)
    qp, kp, causal, window = (t.to(cuda) if torch.is_tensor(t) else t
                              for t in _position_case(name, shape[1]))
    pos = dict(q_positions=qp, kv_positions=kp)
    tdtype = DTYPES[dtype]
    q, k, v, dout = (t.detach().to(tdtype) for t in _bwd_case(
        cuda, *shape[:6], causal, window))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n, n_pos, bwd = (k3.launches, k3.position_launches,
                     dict(k3.backward_launches))
    n_pos_bwd = k3.position_backward_launches
    out, *grads = _kernel_grads(q, k, v, dout, causal, window, **pos)
    kernels = _bwd_kernels(cuda, *shape[:6], causal, window, dtype=tdtype)
    assert (k3.launches, k3.position_launches) == (n + 1, n_pos + 1)
    assert k3.position_backward_launches == n_pos_bwd + 1
    assert k3.backward_launches == {name_: c + (name_ in kernels)
                                    for name_, c in bwd.items()}
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    lse64 = tref.attention_lse_ref(q64, k64, causal=causal, window=window,
                                   **pos)
    expect = tref.flash_attention_bwd_ref(
        q64, k64, v64, tref.flash_attention_ref(
            q64, k64, v64, causal=causal, window=window, **pos),
        lse64, dout.double(), causal=causal, window=window, **pos)
    if dtype == "float32":
        plain = expect
    else:
        out32, lse = k3._launch(q.detach(), k.detach(), v.detach(), causal,
                                window, with_lse=True, **pos)
        plain = tref.flash_attention_bwd_bf16_ref(
            q.detach(), k.detach(), v.detach(), out32, lse, dout,
            causal=causal, window=window, **pos)
    for got, want, mine in zip(grads, expect, plain):
        assert got.dtype == tdtype and torch.isfinite(got).all()
        if dtype == "float32":
            torch.testing.assert_close(got.double(), want, atol=BWD_TOL,
                                       rtol=BWD_TOL)
            continue
        torch.testing.assert_close(got.double(), want, atol=2e-2, rtol=2e-2)
        err = float((got.double() - want).abs().max())
        plain_err = float((mine.double() - want).abs().max())
        assert err <= (chip_smoke.BWD_BF16_PLAIN_FACTOR * plain_err
                       + chip_smoke.BWD_BF16_PLAIN_ATOL), (err, plain_err)
    rows = torch.isinf(lse64).transpose(1, 2)
    assert not grads[0][rows].any() and not out.detach()[rows].any()


# K3's backward: the forward's sweep and tile edges, and shapes of its own:
# G = 4, keys past the queries under causal (blocks with no visible query),
# a window that crosses tiles, and the training shape (smollm-135m, B 8,
# S 256). (1, 77, 50, 16, 1, 64, False, 20) has fully masked rows. Then
# the dK/dV work split (``backward_plan``): G 1, 3, 4 and 9; key and query
# tiles just off 64 (and off the 32- and 16-wide steps) under causal and a
# window; Sq much smaller and much larger than Skv; the federated run's
# shape (B 4, S 128)
BWD_SHAPES = ATTN_SHAPES + EDGE_SHAPES + [
    (1, 100, 100, 8, 2, 128, True, 0),
    (2, 70, 200, 4, 1, 64, True, 0),
    (1, 200, 130, 6, 2, 64, True, 70),
    (8, 256, 256, 9, 3, 64, True, 0),
    (2, 65, 65, 3, 3, 64, True, 0),
    (1, 129, 127, 4, 1, 64, True, 0),
    (2, 63, 127, 9, 1, 64, True, 33),
    (1, 129, 65, 9, 3, 64, False, 64),
    (1, 97, 161, 4, 2, 128, True, 0),
    (1, 33, 47, 4, 4, 128, True, 17),
    (1, 17, 300, 4, 1, 64, True, 0),
    (1, 8, 500, 3, 1, 128, False, 0),
    (1, 300, 17, 9, 3, 64, True, 0),
    (1, 500, 8, 4, 2, 128, False, 5),
    (4, 128, 128, 9, 3, 64, True, 0),
    # MLA's head dims 48 and 96 and zamba2's 112: G 1 to 4, ragged,
    # windows, fully masked rows, keys off the 64-key tile, queries off
    # the 32- and 16-wide steps and keys off the dQ kernel's 32- and
    # 16-wide steps, minicpm3-4b's and zamba2-7b's training shapes
    (2, 64, 64, 4, 4, 48, True, 0),
    (1, 100, 100, 8, 2, 48, True, 0),
    (1, 77, 50, 16, 1, 48, False, 20),
    (1, 63, 65, 1, 1, 48, False, 0),
    (1, 33, 47, 4, 4, 48, True, 17),
    (2, 200, 200, 4, 4, 96, True, 0),
    (2, 96, 96, 6, 2, 96, True, 0),
    (1, 384, 384, 6, 2, 96, True, 96),
    (1, 17, 33, 2, 1, 96, True, 0),
    (1, 65, 129, 1, 1, 96, False, 0),
    (3, 1, 77, 12, 4, 112, True, 0),
    (1, 100, 100, 8, 2, 112, True, 0),
    (1, 200, 130, 6, 2, 112, True, 70),
    (1, 64, 127, 2, 1, 112, False, 0),
    (1, 17, 300, 4, 1, 112, True, 0),
    (1, 47, 33, 3, 1, 112, True, 0),
    (8, 256, 256, 40, 40, 96, True, 0),
    (8, 256, 256, 32, 32, 112, True, 0),
    # deepseek-v3's 192 (its own dK/dV and dQ kernels): G 1 to 9, a split
    # plan (32 splits), a window across tiles, fully masked rows, keys off
    # the 64-key tile and the 16-key step, queries off the 16-query step
    (2, 70, 70, 4, 4, 192, True, 0),
    (1, 256, 256, 2, 1, 192, True, 0),
    (1, 130, 130, 6, 2, 192, True, 70),
    (2, 200, 200, 9, 3, 192, True, 0),
    (1, 77, 50, 16, 1, 192, False, 20),
    (2, 42, 43, 3, 1, 192, True, 0),
    (1, 17, 300, 4, 1, 192, True, 0),
]
# |d| <= tol + tol·|ref| against the float64 plain backward: fp32 sums of
# at most a few thousand terms, from an LSE the split-TF32 forward gives to
# ~1e-6
BWD_TOL = 1e-5


def _bwd_case(cuda, B, Sq, Skv, H, KH, Dh, causal, window, seed=0):
    """(q, k, v, dO) on the card, fp32, the inputs needing grads."""
    q, k, v = (torch.from_numpy(a).to(cuda).requires_grad_()
               for a in _attn_inputs(B, Sq, Skv, H, KH, Dh, seed))
    dout = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        size=(B, Sq, H, Dh)).astype(np.float32)).to(cuda)
    return q, k, v, dout


def _kernel_grads(q, k, v, dout, causal, window, **positions):
    for t in (q, k, v):
        t.grad = None
    out = k3.flash_attention(q, k, v, causal=causal, window=window,
                             **positions)
    out.backward(dout)
    torch.cuda.synchronize()
    return out, q.grad.clone(), k.grad.clone(), v.grad.clone()


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KH,Dh,causal,window", BWD_SHAPES)
def test_flash_attention_backward_matches_plain_on_card(cuda, B, Sq, Skv, H,
                                                        KH, Dh, causal,
                                                        window):
    q, k, v, dout = _bwd_case(cuda, B, Sq, Skv, H, KH, Dh, causal, window)
    out, *grads = _kernel_grads(q, k, v, dout, causal, window)
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    out64 = tref.flash_attention_ref(q64, k64, v64, causal=causal,
                                     window=window)
    lse64 = tref.attention_lse_ref(q64, k64, causal=causal, window=window)
    expect = tref.flash_attention_bwd_ref(q64, k64, v64, out64, lse64,
                                          dout.double(), causal=causal,
                                          window=window)
    for got, want in zip(grads, expect):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)


@pytest.mark.gpu
def test_flash_attention_backward_zero_on_fully_masked_rows_on_card(cuda):
    # rows 69.. see no key: Skv 50, window 20, not causal
    q, k, v, dout = _bwd_case(cuda, 1, 77, 50, 4, 2, 64, False, 20)
    out, dq, dk, dv = _kernel_grads(q, k, v, dout, False, 20)
    assert torch.equal(out[:, 69:], torch.zeros_like(out[:, 69:]))
    assert torch.equal(dq[:, 69:], torch.zeros_like(dq[:, 69:]))
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 200, 200, 9, 3, 64, True, 0),
                                   (1, 130, 97, 4, 1, 128, True, 40)])
def test_flash_attention_backward_is_bitwise_repeatable_on_card(cuda, shape):
    q, k, v, dout = _bwd_case(cuda, *shape)
    causal, window = shape[6], shape[7]
    first = _kernel_grads(q, k, v, dout, causal, window)
    second = _kernel_grads(q, k, v, dout, causal, window)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _bwd_kernels(cuda, *shape, dtype=torch.float32):
    """The backward kernels ``backward_plan`` launches at ``shape`` in
    ``dtype``."""
    return k3.backward_plan(*shape, k3._sm_count(cuda), dtype)["kernels"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 96, 96, 6, 2, 64, True, 0),
                                   (8, 1024, 1024, 9, 3, 64, True, 0)])
def test_flash_attention_backward_counts_its_launches_on_card(cuda, shape):
    # the first shape splits dK/dV (a reduce follows), the second does not
    q, k, v, dout = _bwd_case(cuda, *shape)
    kernels = _bwd_kernels(cuda, *shape)
    assert ("reduce" in kernels) == (shape[0] == 2)
    n, bwd = k3.launches, dict(k3.backward_launches)
    out = k3.flash_attention(q, k, v)
    assert k3.launches == n + 1 and k3.backward_launches == bwd
    out.backward(dout)
    torch.cuda.synchronize()
    assert k3.launches == n + 1
    assert k3.backward_launches == {name: c + (name in kernels)
                                    for name, c in bwd.items()}
    # the training instantiation's output is the serving one's, bit for bit
    with torch.no_grad():
        served = k3.flash_attention(q, k, v)
    assert torch.equal(out.detach(), served)
    k3.reset_counts()
    assert k3.launches == 0 and set(k3.backward_launches.values()) == {0}


# the fp32 kernels at deepseek-v3's 192 (``flash_attention_wide_kernel``,
# ``attn_bwd_dkdv_wide_kernel`` and ``attn_bwd_dq_wide_kernel``): B x KH
# below and above the card's 132 SMs (chip_smoke.py's (1, 512, 512, 128,
# 128) and (2, 384, 384, 68, 68)), a window across tiles, rows 69.. fully
# masked, ragged rows and keys at G 3, and rows folded over a 128-row
# forward tile at G 16
DS_FP32_SHAPES = [(1, 512, 512, 128, 128, 192, True, 0),
                  (2, 384, 384, 68, 68, 192, True, 0),
                  (1, 130, 130, 6, 2, 192, True, 70),
                  (1, 77, 50, 16, 1, 192, False, 20),
                  (2, 113, 97, 9, 3, 192, True, 0),
                  (1, 40, 60, 16, 1, 192, True, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("positions", [False, True])
@pytest.mark.parametrize("shape", DS_FP32_SHAPES)
def test_flash_attention_fp32_dh192_kernels_match_plain_on_card(
        cuda, shape, positions):
    """The fp32 Dh 192 kernels, by index or by explicit positions (the
    indices + 3 on both sides: the same masks): the forward within 2e-6
    (atol and rtol) of the plain version in float64 (at Dh 192 the plain
    version in fp32 is itself about as far from float64 as that gate, and
    farther than the kernel), the training instantiation's output
    bitwise the serving one's, fully masked rows 0 with an LSE of +inf;
    the backward within 1e-5 of the float64 plain backward, fully masked
    rows' dq exactly 0, and a second run bitwise the first."""
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    pos = {}
    if positions:
        pos = dict(q_positions=torch.arange(3, Sq + 3, device=cuda),
                   kv_positions=torch.arange(3, Skv + 3, device=cuda))
    q, k, v, dout = _bwd_case(cuda, *shape)
    with torch.no_grad():
        served = k3.flash_attention(q, k, v, causal=causal, window=window,
                                    **pos)
    first = _kernel_grads(q, k, v, dout, causal, window, **pos)
    second = _kernel_grads(q, k, v, dout, causal, window, **pos)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(first[0].detach(), served)
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    out64 = tref.flash_attention_ref(q64, k64, v64, causal=causal,
                                     window=window, **pos)
    torch.testing.assert_close(served.double(), out64, atol=2e-6, rtol=2e-6)
    lse64 = tref.attention_lse_ref(q64, k64, causal=causal, window=window,
                                   **pos)
    expect = tref.flash_attention_bwd_ref(q64, k64, v64, out64, lse64,
                                          dout.double(), causal=causal,
                                          window=window, **pos)
    for got, want in zip(first[1:], expect):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)
    rows = torch.isinf(lse64).transpose(1, 2)            # (B, Sq, H)
    assert torch.equal(served[rows], torch.zeros_like(served[rows]))
    assert torch.equal(first[1][rows], torch.zeros_like(first[1][rows]))
    _, lse = k3._launch(q.detach(), k.detach(), v.detach(), causal, window,
                        with_lse=True, **{n: t.to(torch.int32).contiguous()
                                         for n, t in pos.items()})
    assert torch.equal(torch.isinf(lse), torch.isinf(lse64))


@pytest.mark.gpu
def test_flash_attention_backward_refuses_bf16_on_card(cuda):
    """bf16 with a gradient where no bf16 kernel exists raises before any
    launch: a head dim outside ``FWD_HEAD_DIMS`` (80), with positions or
    without. (The bf16 backward takes positions at every head
    dim and Dh 192: ``test_flash_attention_positions_backward_at_mla_and_
    zamba2_dims_on_card`` and ``BF16_BWD_SHAPES`` hold them.)"""
    n, bwd = k3.launches, dict(k3.backward_launches)
    q, k, v, _ = _bwd_case(cuda, 1, 64, 64, 2, 1, 80, True, 0)
    qb, kb, vb = (t.detach().bfloat16().requires_grad_() for t in (q, k, v))
    pos = torch.arange(64, device=cuda)
    for positions in ({}, dict(q_positions=pos, kv_positions=pos)):
        with pytest.raises(ValueError, match="head dim 80"):
            k3.flash_attention(qb, kb, vb, **positions)
    torch.cuda.synchronize()
    assert (k3.launches, k3.backward_launches) == (n, bwd)


BF16_BWD_SHAPES = [(2, 64, 64, 4, 4, 48, True, 0),
                   (2, 200, 200, 9, 3, 96, True, 0),
                   (1, 130, 130, 6, 2, 112, True, 70),
                   (2, 200, 200, 9, 3, 64, True, 0),
                   (1, 77, 50, 16, 1, 64, False, 20),
                   (1, 384, 384, 6, 2, 128, True, 96),
                   (4, 128, 128, 9, 3, 64, True, 0),
                   (8, 256, 256, 32, 2, 128, True, 0),
                   (3, 1, 77, 12, 4, 128, True, 0),
                   # Dh 192: keys off the 64-key tile, a window, a split
                   # plan (8 splits), G 3, fully masked rows
                   (2, 70, 70, 4, 4, 192, True, 0),
                   (1, 130, 130, 6, 2, 192, True, 70),
                   (1, 256, 256, 2, 1, 192, True, 0),
                   (2, 200, 200, 9, 3, 192, True, 0),
                   (1, 77, 50, 16, 1, 192, False, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BF16_BWD_SHAPES)
def test_flash_attention_bf16_backward_matches_float64_on_card(cuda, shape):
    """K3's bf16 training forward and backward (the bf16 kernels): dq, dk,
    dv (bf16) within 2e-2 (atol and rtol) of the float64 plain backward of
    the same bf16 values, and each max error within twice that of the
    plain version of the kernels' bf16 arithmetic
    (``ref.flash_attention_bwd_bf16_ref``, from the training forward's
    output and LSE) + 1e-4 (``chip_smoke.BWD_BF16_PLAIN_*``), the LSE
    within ``BWD_TOL``, the output the serving forward's bit for bit,
    fully masked rows 0, two runs bitwise equal, each bf16 kernel of the
    plan launched once."""
    causal, window = shape[6], shape[7]
    q, k, v, dout = (t.detach().bfloat16() for t in _bwd_case(cuda, *shape))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    bwd, bf16_bwd = dict(k3.backward_launches), dict(
        k3.bf16_backward_launches)
    n_bf16 = k3.bf16_launches
    first = _kernel_grads(q, k, v, dout, causal, window)
    kernels = _bwd_kernels(cuda, *shape, dtype=torch.bfloat16)
    assert k3.bf16_launches == n_bf16 + 1
    assert k3.backward_launches == {name: c + (name in kernels)
                                    for name, c in bwd.items()}
    assert k3.bf16_backward_launches == {name: c + (name in kernels)
                                         for name, c in bf16_bwd.items()}
    second = _kernel_grads(q, k, v, dout, causal, window)
    for a, b in zip(first, second):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    with torch.no_grad():
        served = k3.flash_attention(q, k, v, causal=causal, window=window)
        out32, lse = k3._launch(q.detach(), k.detach(), v.detach(), causal,
                                window, with_lse=True)
    assert torch.equal(first[0], served) and out32.dtype == torch.float32
    assert torch.equal(out32.bfloat16(), served)
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    lse64 = tref.attention_lse_ref(q64, k64, causal=causal, window=window)
    fin = ~torch.isinf(lse64)
    assert torch.equal(torch.isinf(lse), ~fin)
    torch.testing.assert_close(lse.double()[fin], lse64[fin], atol=BWD_TOL,
                               rtol=BWD_TOL)
    out64 = tref.flash_attention_ref(q64, k64, v64, causal=causal,
                                     window=window)
    expect = tref.flash_attention_bwd_ref(q64, k64, v64, out64, lse64,
                                          dout.double(), causal=causal,
                                          window=window)
    plain = tref.flash_attention_bwd_bf16_ref(
        q.detach(), k.detach(), v.detach(), out32, lse, dout, causal=causal,
        window=window)
    for got, want, mine in zip(first[1:], expect, plain):
        torch.testing.assert_close(got.double(), want, atol=2e-2, rtol=2e-2)
        err = float((got.double() - want).abs().max())
        plain_err = float((mine.double() - want).abs().max())
        assert err <= (chip_smoke.BWD_BF16_PLAIN_FACTOR * plain_err
                       + chip_smoke.BWD_BF16_PLAIN_ATOL), (err, plain_err)
    rows = (~fin).transpose(1, 2)
    assert bool((first[1][rows] == 0).all() and (first[0][rows] == 0).all())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)

# K3 with explicit positions (the position instantiations): qwen2-vl's
# heads (12 over 2, Dh 128) and musicgen's (G 1, Dh 64) over a 64-patch
# "image" and text; tile edges at both head dims
POS_SHAPES = [(2, 160, 160, 12, 2, 128, True, 0),
              (2, 160, 160, 8, 8, 64, True, 0),
              (1, 65, 65, 3, 1, 64, True, 0),
              (1, 97, 97, 4, 2, 128, True, 0)]
POS_PATTERNS = ["arange", "mrope", "pad", "window", "masked_rows",
                "unsorted", "bidirectional"]


def _position_case(name, n):
    """(q_positions, kv_positions, causal, window) for self attention over
    ``n`` tokens (int32, CPU): the indices; ``n // 2`` tied at 0 and text
    counting on (M-RoPE's temporal component); a -1 tail; that under a
    window; keys past the first 20 queries; the tied pattern permuted;
    the -1 tail without the causal mask."""
    ar = torch.arange(n, dtype=torch.int32)
    tied = torch.where(ar < n // 2, 0, ar - n // 2 + 8).to(torch.int32)
    pad = torch.where(ar < n - 12, ar, -1).to(torch.int32)
    if name == "arange":
        return ar, ar, True, 0
    if name == "mrope":
        return tied, tied, True, 0
    if name == "pad":
        return pad, pad, True, 0
    if name == "window":
        return tied, tied, True, 24
    if name == "masked_rows":
        return ar, ar + 20, True, 0
    if name == "unsorted":
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(n))
        return tied[perm], tied[perm], True, 30
    if name == "bidirectional":
        return pad, pad, False, 16
    raise ValueError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", POS_SHAPES)
@pytest.mark.parametrize("name", POS_PATTERNS)
def test_flash_attention_positions_match_plain_on_card(cuda, shape, name):
    """The position instantiations against the plain versions: the serving
    forward in fp32 and bf16 (2e-6, 2e-2), the training forward's output
    (the serving one's, bit for bit) and LSE (+inf exactly on the fully
    masked rows), the backward against float64 (``BWD_TOL``), fully masked
    rows 0; one position launch a forward."""
    B, Sq, Skv, H, KH, Dh = shape[:6]
    qp, kp, causal, window = (t.to(cuda) if torch.is_tensor(t) else t
                              for t in _position_case(name, Sq))
    pos = dict(q_positions=qp, kv_positions=kp)
    q, k, v, dout = _bwd_case(cuda, B, Sq, Skv, H, KH, Dh, causal, window)
    for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        qd, kd, vd = (t.detach().to(dtype) for t in (q, k, v))
        n = k3.position_launches
        with torch.no_grad():
            out = k3.flash_attention(qd, kd, vd, causal=causal,
                                     window=window, **pos)
        torch.cuda.synchronize()
        assert k3.position_launches == n + 1
        expect = tref.flash_attention_ref(qd, kd, vd, causal=causal,
                                          window=window, **pos)
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.float32:
            served = out
    out, lse = k3._launch(q.detach(), k.detach(), v.detach(), causal,
                          window, with_lse=True, **pos)
    assert torch.equal(out, served)
    q64, k64, v64 = (t.detach().double() for t in (q, k, v))
    lse64 = tref.attention_lse_ref(q64, k64, causal=causal, window=window,
                                   **pos)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse64))
    fin = ~torch.isinf(lse64)
    torch.testing.assert_close(lse.double()[fin], lse64[fin], atol=BWD_TOL,
                               rtol=BWD_TOL)
    out, *grads = _kernel_grads(q, k, v, dout, causal, window, **pos)
    expect = tref.flash_attention_bwd_ref(
        q64, k64, v64, tref.flash_attention_ref(
            q64, k64, v64, causal=causal, window=window, **pos),
        lse64, dout.double(), causal=causal, window=window, **pos)
    for got, want in zip(grads, expect):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.double(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)
    rows = (~fin).transpose(1, 2)
    assert not out.detach()[rows].any() and not grads[0][rows].any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 97, 97, 4, 4, 48, True, 0),
                                   (2, 160, 160, 4, 2, 96, True, 0),
                                   (1, 97, 97, 8, 8, 112, True, 0),
                                   (1, 97, 97, 4, 4, 192, True, 0)])
@pytest.mark.parametrize("name", POS_PATTERNS)
def test_flash_attention_positions_forward_at_serving_head_dims_on_card(
        cuda, shape, name):
    """The forward's position instantiations at MLA's 48, 96 and 192 and
    zamba2's 112 (their backward: the test above): serving output in fp32
    and bf16 against the plain version, the training instantiation's
    output (bitwise) and LSE, fully masked rows 0; the arange bitwise the
    index path."""
    B, Sq, Skv, H, KH, Dh = shape[:6]
    qp, kp, causal, window = (t.to(cuda) if torch.is_tensor(t) else t
                              for t in _position_case(name, Sq))
    pos = dict(q_positions=qp, kv_positions=kp)
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _attn_inputs(B, Sq, Skv, H, KH, Dh))
    for dtype, tol in ((torch.float32, 2e-6), (torch.bfloat16, 2e-2)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        out = k3.flash_attention(qd, kd, vd, causal=causal, window=window,
                                 **pos)
        expect = tref.flash_attention_ref(qd, kd, vd, causal=causal,
                                          window=window, **pos)
        torch.testing.assert_close(out.float(), expect.float(), atol=tol,
                                   rtol=tol)
        if dtype == torch.float32:
            served = out
    out, lse = k3._launch(q, k, v, causal, window, with_lse=True, **pos)
    assert torch.equal(out, served)
    lse64 = tref.attention_lse_ref(q.double(), k.double(), causal=causal,
                                   window=window, **pos)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse64))
    fin = ~torch.isinf(lse64)
    torch.testing.assert_close(lse.double()[fin], lse64[fin], atol=BWD_TOL,
                               rtol=BWD_TOL)
    assert not served[(~fin).transpose(1, 2)].any()
    if name == "arange":
        for a, b in zip((out, lse), k3._launch(q, k, v, causal, window,
                                               with_lse=True)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", POS_SHAPES + [
    (2, 200, 200, 9, 3, 64, True, 0), (1, 77, 50, 16, 1, 64, False, 20),
    (1, 130, 97, 4, 1, 128, True, 40), (8, 256, 256, 9, 3, 64, True, 0)])
def test_flash_attention_arange_positions_are_the_index_path_on_card(
        cuda, shape):
    """Positions 0..S-1 give the index instantiations' output, LSE and
    gradients bit for bit: the position rules walk the same tiles in the
    same order, and the plan's split is the index one's."""
    B, Sq, Skv, H, KH, Dh, causal, window = shape
    pos = dict(q_positions=torch.arange(Sq, device=cuda),
               kv_positions=torch.arange(Skv, device=cuda))
    q, k, v, dout = _bwd_case(cuda, *shape)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.detach().to(dtype) for t in (q, k, v))
            assert torch.equal(
                k3.flash_attention(qd, kd, vd, causal=causal, window=window,
                                   **pos),
                k3.flash_attention(qd, kd, vd, causal=causal, window=window))
        qd, kd, vd = (t.detach() for t in (q, k, v))
        for a, b in zip(k3._launch(qd, kd, vd, causal, window, with_lse=True,
                                   q_positions=pos["q_positions"].int(),
                                   kv_positions=pos["kv_positions"].int()),
                        k3._launch(qd, kd, vd, causal, window,
                                   with_lse=True)):
            assert torch.equal(a, b)
    got = _kernel_grads(q, k, v, dout, causal, window, **pos)
    want = _kernel_grads(q, k, v, dout, causal, window)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_stub_serve_on_card_matches_cpu(cuda, arch):
    """Reduced qwen2-vl (M-RoPE, G 2 at reduced(), qkv biases) and musicgen
    (no rope, G 1) served after their zero stub prefix on the card against
    the CPU: same weights and ragged prompts, logits within 1e-4, the same
    greedy tokens, K3 once a layer by index; the first decode step within
    1e-4 of a prefill of the P + 1 tokens, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (make_prompts, prefill_to_cache,
                                          serve, stub_prefix)
    from repro_torch.models.model import decode, init_params, prefill
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    ref = serve(cfg, params, prompts, 5, device="cpu")
    card = _to(params, cuda)
    before, pos_before = k3.launches, k3.position_launches
    got = serve(cfg, card, prompts.to(cuda), 5, device=cuda)
    assert k3.launches == before + cfg.n_layers
    assert k3.position_launches == pos_before
    torch.testing.assert_close(got.logits.cpu(), ref.logits, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.tokens.cpu(), ref.tokens)
    toks, stub = prompts.to(cuda), stub_prefix(cfg, 2, cuda)
    start = cfg.n_stub_tokens + 36
    with torch.no_grad():
        full, _ = prefill(card, cfg, toks, stub_embeds=stub)
        _, cache = prefill_to_cache(card, cfg, toks[:, :-1], start + 4,
                                    stub_embeds=stub)
        step, _ = decode(card, cfg, toks[:, -1:], cache, start)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_stub_loss_under_positions_on_card_matches_cpu(cuda, arch):
    """``loss_fn`` and its gradients with random stub embeddings under
    custom positions (an M-RoPE prompt: the prefix as a 2 x 4 image, then
    text; musicgen takes the temporal component) on the card against the
    CPU, 1e-4: K3's position path forward and backward once a layer."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 21), generator=g)
    n = cfg.n_stub_tokens
    i = torch.arange(n)
    image = torch.stack([torch.zeros_like(i), i // 4, i % 4], -1)
    text = torch.arange(21)[:, None].expand(21, 3) + 4
    positions = torch.cat([image, text]).int()
    if cfg.rope != "mrope":
        positions = positions[:, 0].contiguous()
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "stub_embeds": torch.randn((2, n, cfg.d_model), generator=g),
             "positions": positions}
    loss, _, grads = value_and_grad(params, cfg, batch)
    n_pos = k3.position_launches
    bwd = dict(k3.backward_launches)
    got_loss, _, got = value_and_grad(
        _to(params, cuda), cfg, {k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert k3.position_launches == n_pos + cfg.n_layers
    assert k3.backward_launches["dq"] == bwd["dq"] + cfg.n_layers
    torch.testing.assert_close(got_loss.cpu(), loss, atol=1e-4, rtol=1e-4)
    for a, b in zip(tree_leaves(got), tree_leaves(grads)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-15b",
                                  "chatglm3-6b"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_on_card_matches_cpu(cuda, arch, window, dtype):
    """The reduced serving run on the card (K3) against the CPU (plain
    version): same weights and ragged prompts. fp32: logits within 1e-4
    and the same greedy tokens. bf16: the CPU fed the card's tokens,
    logits within max(2e-2, g), g the CPU's own bf16-vs-fp32 gap
    (``tests/test_torch_bf16.py``'s gate, the port's fp32 for the
    reference's), and the card's tokens the CPU's argmax wherever its
    top-2 gap exceeds twice that."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    cpu = tree_map(lambda t: t.to(DTYPES[dtype]), params)
    before = k3.launches
    got = serve(cfg, _to(cpu, cuda), prompts.to(cuda), 5, window=window,
                device=cuda)
    assert k3.launches == before + cfg.n_layers
    if dtype == "float32":
        ref = serve(cfg, params, prompts, 5, window=window, device="cpu")
        torch.testing.assert_close(got.logits.cpu(), ref.logits, atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(got.tokens.cpu(), ref.tokens)
        return
    tokens = got.tokens.cpu()
    ref = chip_smoke._teacher_forced(cfg, cpu, prompts, tokens, window)
    ref32 = chip_smoke._teacher_forced(cfg, params, prompts, tokens, window)
    gate = max(2e-2, float((ref - ref32).abs().max()))
    assert float((got.logits.cpu() - ref).abs().max()) <= gate
    top2 = torch.topk(ref, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gate
    assert torch.equal(tokens.T[clear], ref.argmax(-1)[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["chatglm3-6b", "starcoder2-15b"])
def test_bf16_train_step_on_card_matches_cpu(cuda, arch):
    """One bf16 ``make_train_step`` (remat) of reduced ``arch`` on the card
    (K3's bf16 forward and backward) against the CPU: loss and params
    within max(2e-2, g), g the CPU's own bf16-vs-fp32 gap, and the bf16
    gradients and the update Δ in relative norm within their gates
    (``chip_smoke.bf16_step_against_cpu``); K3's forward twice a layer
    (remat) and each backward kernel once."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    p32 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    r = chip_smoke.bf16_step_against_cpu(cfg, p32, batch, cuda)
    kernels = _bwd_kernels(cuda, 2, 32, 32, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, True, cfg.sliding_window,
                           dtype=torch.bfloat16)
    assert r["k3_forward"] == 2 * cfg.n_layers
    assert r["k3_backward"] == {name: cfg.n_layers * (name in kernels)
                                for name in k3.backward_launches}
    for name in chip_smoke.BF16_STEP_GAPS:
        gap, gate = r[name]
        assert gap <= gate, (name, gap, gate)


@pytest.mark.gpu
def test_mla_serve_on_card_matches_cpu(cuda):
    """Reduced minicpm3-4b (MLA, K3 at Dh 48) served on the card against
    the CPU: same weights and ragged prompts, logits within 1e-4 and the
    same greedy tokens; the first absorbed decode step within 1e-4 of a
    prefill of the P + 1 tokens, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (make_prompts, prefill_to_cache,
                                          serve)
    from repro_torch.models.model import decode, init_params, prefill
    cfg = get_config("minicpm3-4b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    ref = serve(cfg, params, prompts, 5, device="cpu")
    card = _to(params, cuda)
    before = k3.launches
    got = serve(cfg, card, prompts.to(cuda), 5, device=cuda)
    assert k3.launches == before + cfg.n_layers
    torch.testing.assert_close(got.logits.cpu(), ref.logits, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.tokens.cpu(), ref.tokens)
    toks = prompts.to(cuda)
    with torch.no_grad():
        full, _ = prefill(card, cfg, toks)
        _, cache = prefill_to_cache(card, cfg, toks[:, :-1], 40)
        step, _ = decode(card, cfg, toks[:, -1:], cache, 36)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("S", [2, 300])
def test_mamba_layers_on_card_match_cpu(cuda, arch, S):
    """Layer 0's Mamba prefill (the chunked scan, or the SSD past a chunk)
    and one decode step on the card against the CPU: outputs and states
    within 1e-5, the CPU tests' tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import init_params, unstack
    cfg = get_config(arch).reduced()
    layer = unstack(init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")["layers"])[0]["mamba"]
    pre, dec = ((ssm.mamba2_prefill, ssm.mamba2_decode) if arch ==
                "zamba2-7b" else (ssm.mamba1_prefill, ssm.mamba1_decode))
    x = torch.from_numpy((np.random.default_rng(S).normal(
        size=(2, S + 1, cfg.d_model)) * 0.5).astype(np.float32))
    card = _to(layer, cuda)
    with torch.no_grad():
        ref = pre(layer, cfg, x[:, :S])
        got = pre(card, cfg, x[:, :S].to(cuda))
        ref_step = dec(layer, cfg, x[:, S:], ref[1])
        got_step = dec(card, cfg, x[:, S:].to(cuda), got[1])
    for g, r in ((got[0], ref[0]), (got_step[0], ref_step[0])):
        torch.testing.assert_close(g.cpu(), r, atol=1e-5, rtol=1e-5)
    for name in ("h", "conv"):
        torch.testing.assert_close(got_step[1][name].cpu(),
                                   ref_step[1][name], atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,window", [("falcon-mamba-7b", 0),
                                         ("zamba2-7b", 0), ("zamba2-7b", 8)])
def test_ssm_serve_on_card_matches_cpu(cuda, arch, window):
    """Reduced falcon-mamba (no attention: K3 never launches) and zamba2
    (its shared block once: K3 at Dh 64), with a window of 8 that the
    prompt wraps, served on the card against the CPU: same weights and
    ragged prompts, logits within 1e-4 and the same greedy tokens; the
    first decode step within 1e-4 of a prefill of the P + 1 tokens, on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (make_prompts, prefill_to_cache,
                                          serve)
    from repro_torch.models.model import (_n_shared_apps, decode,
                                          init_params, prefill)
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    ref = serve(cfg, params, prompts, 5, window=window, device="cpu")
    card = _to(params, cuda)
    before = k3.launches
    got = serve(cfg, card, prompts.to(cuda), 5, window=window, device=cuda)
    assert k3.launches == before + _n_shared_apps(cfg)
    torch.testing.assert_close(got.logits.cpu(), ref.logits, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.tokens.cpu(), ref.tokens)
    toks = prompts.to(cuda)
    with torch.no_grad():
        full, _ = prefill(card, cfg, toks, window=window)
        _, cache = prefill_to_cache(card, cfg, toks[:, :-1], 40,
                                    window=window)
        step, _ = decode(card, cfg, toks[:, -1:], cache, 36, window=window)
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)


def _moe_cfg(arch, factor):
    """``arch`` reduced, at capacity ``factor`` (reduced()'s 4.0 never
    drops; 0.25 drops pairs in a prefill of 2 x 37 tokens)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [4.0, 0.25])
def test_moe_apply_on_card_matches_cpu(cuda, arch, factor):
    """The MoE layer (router, stable-sort dispatch, expert products,
    combine) on the card against the CPU, with and without drops, with no
    host sync in the dispatch; 1e-5, the CPU tests' tolerance."""
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, unstack
    cfg = _moe_cfg(arch, factor)
    layer = unstack(init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")["layers"])[0]["moe"]
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 37, cfg.d_model)).astype(np.float32))
    ref, ref_aux = moe.moe_apply(layer, cfg, x)
    card, xc = _to(layer, cuda), x.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = moe.moe_apply(card, cfg, xc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    dropped, _, gap = moe.routing_stats(card["router"], xc, cfg.moe)
    assert (int(dropped) > 0) == (factor < 1), float(gap)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux.cpu(), ref_aux, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [4.0, 0.25])
def test_moe_serve_on_card_matches_cpu(cuda, arch, factor):
    """Reduced granite-moe (K3 at Dh 64) and deepseek-v3 (MLA, K3 at Dh
    48; a dense layer and a shared expert) served on the card against the
    CPU: same weights and ragged prompts, logits within 1e-4 and the same
    greedy tokens, K3 once a layer."""
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import init_params
    cfg = _moe_cfg(arch, factor)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = make_prompts(cfg, 2, 37, seed=1, device="cpu")
    ref = serve(cfg, params, prompts, 5, device="cpu")
    before = k3.launches
    got = serve(cfg, _to(params, cuda), prompts.to(cuda), 5, device=cuda)
    assert k3.launches == before + cfg.n_layers
    torch.testing.assert_close(got.logits.cpu(), ref.logits, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got.tokens.cpu(), ref.tokens)


@pytest.mark.gpu
def test_train_steps_on_card_match_cpu(cuda):
    """Two SGD steps of reduced smollm-135m on the card (K3's forward and
    backward in every layer) against the CPU (plain versions): same
    weights and batches, losses and params within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(steps=2, batch=2, seq=70, lr=3e-3, log=lambda s: None)
    ref = train.single_client(cfg, params=params, device="cpu", **kw)
    n, bwd = k3.launches, dict(k3.backward_launches)
    got = train.single_client(cfg, params=_to(params, cuda), device=cuda,
                              **kw)
    assert k3.launches == n + 2 * cfg.n_layers
    kernels = _bwd_kernels(cuda, 2, 70, 70, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, True, 0)
    assert k3.backward_launches == {
        name: c + 2 * cfg.n_layers * (name in kernels)
        for name, c in bwd.items()}
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-4,
                               rtol=1e-4)
    from torch.utils._pytree import tree_flatten
    for a, b in zip(tree_flatten(got["params"])[0],
                    tree_flatten(ref["params"])[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", chip_smoke.FAMILY_ARCHS)
def test_family_train_steps_on_card_match_cpu(cuda, arch):
    """Two SGD steps of each reduced MoE, MLA, SSM and hybrid config on
    the card (K3's forward and backward in every attention layer: Dh 64,
    or 48 under MLA) against the CPU: same weights and batches, losses and
    params within 1e-4."""
    from torch.utils._pytree import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(steps=2, batch=2, seq=70, lr=3e-3, log=lambda s: None)
    ref = train.single_client(cfg, params=params, device="cpu", **kw)
    n, bwd = k3.launches, dict(k3.backward_launches)
    got = train.single_client(cfg, params=_to(params, cuda), device=cuda,
                              **kw)
    want = 2 * chip_smoke._attention_layers(cfg)
    assert k3.launches == n + want
    kernels = _bwd_kernels(cuda, 2, 70, 70, cfg.n_heads, cfg.n_kv_heads,
                           chip_smoke._attn_head_dim(cfg), True,
                           0) if want else ()
    assert k3.backward_launches == {
        name: c + want * (name in kernels) for name, c in bwd.items()}
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-4,
                               rtol=1e-4)
    for a, b in zip(tree_flatten(got["params"])[0],
                    tree_flatten(ref["params"])[0]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def _tiny_sim(device, params0=None, **switches):
    """``tests/test_torch_fedsim.py``'s small setup: 4 clients, one of
    them not participating, a 1-block CNN on 8×8 images."""
    from repro_torch.configs import CNNConfig
    from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)
    base = synthetic_image_dataset(0, 600, image_size=8, n_classes=4)
    parts = dirichlet_partition(base.y, 4, alpha=0.3, seed=0)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])
    return FederatedSimulation(
        CNNConfig(image_size=8, widths=(4,), hidden=16, n_classes=4), train,
        test, np.array([True, True, True, False]),
        np.linspace(0.0, 0.2, 4).astype(np.float32),
        FedSimConfig(rounds=3, batch_size=16, em_iters=2, em_subset=64,
                     adapt_subset=32, eval_every=2, **switches),
        params0=params0, device=device)


def _card_vs_cpu(cuda, method, **switches):
    """One run of ``method`` on the card and on the CPU from the same
    params and injected draws, held to the engine's tolerances; returns the
    (K1, K2) launches of the card's run."""
    gpu = _tiny_sim(cuda, **switches)
    cpu = _tiny_sim("cpu", params0=gpu.params0.cpu(), **switches)
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, n, (3, gpu.steps_per_round, 16))
                    for n in gpu._train_len], axis=1)
    masks = rng.random((3, gpu.m)) > 0.3
    n1, n2 = k1.launches, k2.launches
    hg = gpu.run(method, idx_stream=idx, link_masks=masks)
    launches = (k1.launches - n1, k2.launches - n2)
    hc = cpu.run(method, idx_stream=idx, link_masks=masks)
    np.testing.assert_allclose(hg["target_acc"], hc["target_acc"], atol=5e-3)
    np.testing.assert_allclose(hg["mean_participant_acc"],
                               hc["mean_participant_acc"], atol=5e-3)
    torch.testing.assert_close(gpu.last_state["params"].cpu(),
                               cpu.last_state["params"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(hg["taps"]["train_loss"],
                               hc["taps"]["train_loss"], atol=1e-4)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(hg["pi"]), np.stack(hc["pi"]),
                                   atol=1e-4)
    return launches


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_method_on_card_matches_cpu(cuda, method):
    """pFedWN launches K1 once an EM iteration and K2 once a round; local
    and the four baselines launch neither."""
    n1, n2 = _card_vs_cpu(cuda, method)
    if method == "pfedwn":
        assert (n1, n2) == (3 * 2, 3)
    else:
        assert (n1, n2) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("method", METHODS)
def test_legacy_engine_on_card_matches_fused(cuda, method):
    """The legacy host-driven engine against the fused one on the card,
    same seed, so the same draws; pFedWN's legacy rounds launch K1 and K2
    as the fused ones do."""
    fused = _tiny_sim(cuda)
    legacy = _tiny_sim(cuda, params0=fused.params0, fused=False)
    hf = fused.run(method)
    n1, n2 = k1.launches, k2.launches
    hl = legacy.run(method)
    launches = (k1.launches - n1, k2.launches - n2)
    np.testing.assert_allclose(hl["target_acc"], hf["target_acc"], atol=5e-3)
    np.testing.assert_allclose(hl["mean_participant_acc"],
                               hf["mean_participant_acc"], atol=5e-3)
    torch.testing.assert_close(legacy.last_state["params"],
                               fused.last_state["params"], atol=1e-4,
                               rtol=0)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(hl["pi"]), np.stack(hf["pi"]),
                                   atol=1e-4)
    assert launches == ((3 * 2, 3) if method == "pfedwn" else (0, 0))
    assert legacy.last_run_stats["engine"] == "legacy"
    assert fused.last_run_stats["engine"] == "fused"


@pytest.mark.gpu
def test_pfedwn_past_32_neighbors_on_card_matches_cpu(cuda):
    """40 clients, all taking part (M = 39): the card's pFedWN run against
    the CPU's from the same params and draws, K1 once an EM iteration and
    K2 once a round."""
    from repro_torch.configs import CNNConfig
    from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_dataset, train_test_split)
    base = synthetic_image_dataset(0, 4000, image_size=8, n_classes=4)
    parts = dirichlet_partition(base.y, 40, alpha=1.0, seed=0)
    train = make_client_datasets(base, [train_test_split(p, seed=1)[0]
                                        for p in parts])
    test = make_client_datasets(base, [train_test_split(p, seed=1)[1]
                                       for p in parts])

    def sim(device, params0=None):
        return FederatedSimulation(
            CNNConfig(image_size=8, widths=(4,), hidden=16, n_classes=4),
            train, test, np.ones(40, bool),
            np.linspace(0.0, 0.2, 40).astype(np.float32),
            FedSimConfig(rounds=2, batch_size=16, em_iters=1, em_subset=64,
                         eval_every=2), params0=params0, device=device)

    gpu = sim(cuda)
    cpu = sim("cpu", gpu.params0.cpu())
    assert gpu.m == 39
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, n, (2, gpu.steps_per_round, 16))
                    for n in gpu._train_len], axis=1)
    masks = rng.random((2, 39)) > 0.1
    n1, n2 = k1.launches, k2.launches
    hg = gpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    assert (k1.launches - n1, k2.launches - n2) == (2, 2)
    hc = cpu.run("pfedwn", idx_stream=idx, link_masks=masks)
    np.testing.assert_allclose(np.stack(hg["pi"]), np.stack(hc["pi"]),
                               atol=1e-4)
    np.testing.assert_allclose(hg["target_acc"], hc["target_acc"], atol=5e-3)
    torch.testing.assert_close(gpu.last_state["params"].cpu(),
                               cpu.last_state["params"], atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("em_uniform,erasures", [(True, True),
                                                 (True, False),
                                                 (False, False)])
def test_ablation_switches_on_card_match_cpu(cuda, em_uniform, erasures):
    """Uniform π skips EM, so K1 stays idle while K2 still mixes."""
    n1, n2 = _card_vs_cpu(cuda, "pfedwn", em_uniform=em_uniform,
                          erasures=erasures)
    assert n1 == (0 if em_uniform else 3 * 2) and n2 == 3


@pytest.mark.gpu
@pytest.mark.parametrize("devices,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_engine_on_card_matches_fused(cuda, devices, backend):
    """Every method on the client-sharded engine (one process a rank, all
    on this card) against the fused engine on the card, same seed, so the
    same draws; each rank's pFedWN launches K1 once an EM iteration and K2
    once a round, and a block syncs once with the host on nccl."""
    from repro_torch.lint.blocks import build_sim
    from repro_torch.sharding import join_slabs, spawn
    from repro_torch.sharding.worker import run_methods
    fused = build_sim("fused", 1, "cuda")
    torch.cuda.empty_cache()
    ranks = spawn(run_methods, devices, backend, "cuda", build_sim,
                  dict(engine="sharded", devices=devices, device="cuda"),
                  list(METHODS), None, 2, True)
    for i, method in enumerate(METHODS):
        hf = fused.run(method)
        hs = ranks[0][i]["history"]
        np.testing.assert_allclose(hs["target_acc"], hf["target_acc"],
                                   atol=5e-3)
        np.testing.assert_allclose(hs["mean_participant_acc"],
                                   hf["mean_participant_acc"], atol=5e-3)
        torch.testing.assert_close(
            join_slabs([r[i]["params"] for r in ranks]),
            fused.last_state["params"].cpu(), atol=1e-4, rtol=0)
        if method == "pfedwn":
            np.testing.assert_allclose(np.stack(hs["pi"]),
                                       np.stack(hf["pi"]), atol=1e-4)
        want = (3 * 2, 3) if method == "pfedwn" else (0, 0)
        assert [(r[i]["k1"], r[i]["k2"]) for r in ranks] == [want] * devices
        if backend == "nccl":
            assert ranks[0][i]["syncs"] == 2            # blocks [1, 2]


@pytest.mark.gpu
def test_pod_mix_on_card_is_one_gather_and_one_k2_launch(cuda):
    from repro_torch.sharding import spawn
    from repro_torch.sharding.worker import run_pod_mix
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((2, 1000)).astype(np.float32),
            "b": rng.standard_normal((2, 7)).astype(np.float32)}
    pi = np.array([[0.0, 1.0], [0.5, 0.5]], np.float32)
    ok = np.array([[True, True], [False, True]])
    ranks = spawn(run_pod_mix, 2, "gloo", "cuda",
                  [(tree, pi, 0.6, ok)], "cuda")
    for rank, (res,) in enumerate(ranks):
        assert (res["collectives"], res["k2"]) == (1, 1)
        for k, v in tree.items():
            # rank 1's one link is erased: it keeps its own model
            want = (0.6 * v[0] + 0.4 * v[1]) if rank == 0 else v[1]
            np.testing.assert_allclose(res["mixed"][k][0], want, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("engine,devices", [("both", 2), ("sharded", 1)])
def test_lint_blocks_on_card(cuda, engine, devices):
    """The round-block lint on the card: launches, and one host sync a
    block on the fused engine and on nccl (D = 1)."""
    from repro_torch.lint import blocks
    torch.cuda.empty_cache()
    assert blocks.main(["--engine", engine, "--devices", str(devices),
                        "--device", "cuda"]) == 0


@pytest.mark.gpu
def test_round_step_on_card_matches_cpu(cuda):
    """The multi-pod round step at reduced smollm-135m on 2 gloo ranks on
    the card against 2 on the CPU, exchange 16 and 8, fp32 within 1e-4 and
    bf16 within max(2e-2, the CPU's own bf16-vs-fp32 gap), the local
    step's update in relative norm; K2 once a rank, K3's forward once a
    layer a model (chip_smoke phase 7h's check, which runs C = 4)."""
    worst = chip_smoke.check_round_step_against_cpu(cuda, clients=(2,))
    assert max(worst[torch.float32].values()) <= chip_smoke.TRAIN_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("any_ok", [True, False])
def test_weighted_agg_at_the_round_step_mix_on_card(cuda, any_ok):
    """K2 at the round step's full-width mix: bf16, P = smollm-135m's
    162,826,560 params, M = 4 rows (the own model among them), against
    the plain version within one bf16 ulp (``ROUND_MIX_TOL``: each rounds
    an fp32 sum once); with every link erased own comes back bitwise."""
    P, M = 162_826_560, 4
    g = torch.Generator(device=cuda).manual_seed(5)
    stack = (torch.randn((M, P), generator=g, device=cuda) * 0.02).bfloat16()
    own = (torch.randn(P, generator=g, device=cuda) * 0.02).bfloat16()
    w = torch.softmax(torch.randn(M, generator=g, device=cuda), 0)
    ok = torch.tensor(any_ok, device=cuda)
    before = (k2.launches, k2.bf16_launches)
    out = k2.weighted_agg(own, stack, w, 0.5, any_ok=ok)
    torch.cuda.synchronize()
    assert (k2.launches, k2.bf16_launches) == (before[0] + 1, before[1] + 1)
    expect = tref.weighted_agg_ref(own, stack, w, 0.5, any_ok=ok)
    diff = (out.float() - expect.float()).abs()
    ulps, floor_abs = chip_smoke.ROUND_MIX_TOL
    assert float((diff - ulps * expect.float().abs()).max()) <= floor_abs
    if not any_ok:
        assert torch.equal(out, own)
