"""K3's gradients on the CPU against the reference: ``jax.vjp`` of
``chunked_attention`` (the function the reference trains through, with
``jax.checkpoint`` per KV chunk) on the same numpy inputs and output
cotangent, over a sweep of G, causal and window, Dh 48, 64, 96, 112, 128
and 192, ragged Sq ≠ Skv, fully masked rows and several KV chunks. Two things are held to
it at 1e-5 (atol and rtol, fp32 against fp32):
  - the port's attention gradients on its plain path (``flash_attention``
    on CPU tensors: autograd through ``flash_attention_ref``);
  - ``flash_attention_bwd_ref``, the plain version of the card's backward
    kernels, fed ``flash_attention_ref``'s output and
    ``attention_lse_ref``'s row log-sum-exp.
``tests/test_torch_gpu.py`` holds the CUDA backward against
``flash_attention_bwd_ref`` in float64 on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

TOL = 1e-5
# (B, Sq, Skv, H, KH, Dh, causal, window, chunk)
CASES = [
    (2, 64, 64, 4, 2, 64, True, 0, 512),      # G 2
    (1, 48, 48, 3, 1, 64, True, 0, 16),       # G 3, three KV chunks
    (1, 40, 40, 4, 1, 128, True, 16, 512),    # G 4, window, Dh 128
    (2, 37, 37, 6, 3, 64, False, 0, 512),     # ragged S, not causal
    (1, 50, 30, 4, 4, 64, False, 12, 512),    # rows 41.. fully masked
    (1, 20, 45, 2, 1, 128, True, 0, 16),      # keys past the queries
    (1, 70, 70, 3, 1, 64, True, 20, 32),      # window across chunks
    # MLA's head dims (48 at reduced(), minicpm3-4b's 96), zamba2-7b's 112
    # and deepseek-v3's 192 (qk_nope 128 + qk_rope 64; its own card kernels)
    (2, 40, 40, 4, 2, 48, True, 0, 512),      # G 2, Dh 48
    (1, 50, 30, 4, 1, 48, False, 12, 16),     # G 4, rows 41.. masked
    (1, 37, 45, 3, 1, 96, True, 16, 16),      # G 3, ragged, window
    (2, 33, 33, 4, 4, 96, False, 0, 512),     # G 1, Dh 96
    (1, 45, 37, 4, 2, 112, True, 0, 16),      # G 2, ragged, Dh 112
    (1, 60, 60, 2, 2, 112, True, 20, 32),     # window across chunks
    (1, 24, 24, 2, 1, 192, True, 0, 512),     # G 2, Dh 192
    (1, 30, 41, 4, 4, 192, True, 8, 16),      # ragged, window, Dh 192
]
_CACHE = {}


def _inputs(B, Sq, Skv, H, KH, Dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, Sq, H, Dh), f(B, Skv, KH, Dh), f(B, Skv, KH, Dh), \
        f(B, Sq, H, Dh)


def _reference(case):
    """(inputs, reference output, reference (dq, dk, dv)) for a case."""
    if case not in _CACHE:
        B, Sq, Skv, H, KH, Dh, causal, window, chunk = case
        q, k, v, dout = _inputs(B, Sq, Skv, H, KH, Dh)

        def attend(q_, k_, v_):
            return chunked_attention(
                q_, k_, v_, q_positions=jnp.arange(Sq),
                kv_positions=jnp.arange(Skv), causal=causal, window=window,
                chunk=chunk)

        out, vjp = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
        grads = vjp(jnp.asarray(dout))
        _CACHE[case] = ((q, k, v, dout), np.asarray(out),
                        tuple(np.asarray(g) for g in grads))
    return _CACHE[case]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_attention_grads_match_chunked_attention(case):
    (q, k, v, dout), out_ref, grads_ref = _reference(case)
    causal, window = case[6], case[7]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n, bwd = k3.launches, dict(k3.backward_launches)
    out = k3.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(dout))
    assert k3.launches == n and k3.backward_launches == bwd   # plain path
    _close(out, out_ref)
    for t, g in zip((tq, tk, tv), grads_ref):
        _close(t.grad, g)


@pytest.mark.parametrize("case", CASES)
def test_backward_ref_matches_chunked_attention(case):
    (q, k, v, dout), _, grads_ref = _reference(case)
    causal, window = case[6], case[7]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = tref.attention_lse_ref(tq, tk, causal=causal, window=window)
    assert lse.shape == (case[0], case[3], case[1])
    grads = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window)
    for got, want in zip(grads, grads_ref):
        assert got.dtype == torch.float32
        _close(got, want)


def test_lse_is_inf_on_fully_masked_rows_and_logsumexp_elsewhere():
    B, Sq, Skv, H, KH, Dh = 1, 50, 30, 4, 2, 64
    q, k, _, _ = _inputs(B, Sq, Skv, H, KH, Dh, seed=1)
    lse = tref.attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 causal=False, window=12).numpy()
    # row i sees keys (i - 12, Skv): rows 41.. see none
    assert np.all(np.isinf(lse[..., 41:]) & (lse[..., 41:] > 0))
    qg = q.reshape(B, Sq, KH, H // KH, Dh)
    s = np.einsum("bqhgd,bkhd->bqhgk", qg.astype(np.float64), k) / 8.0
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    s = np.where((j > i - 12)[None, :, None, None, :], s, -np.inf)
    s = s[:, :41]
    m = s.max(-1)
    want = m + np.log(np.exp(s - m[..., None]).sum(-1))
    np.testing.assert_allclose(
        lse[..., :41], want.reshape(B, 41, H).transpose(0, 2, 1),
        atol=TOL, rtol=TOL)
