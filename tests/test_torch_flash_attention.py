"""The port's K3 wrapper (``repro_torch.kernels.flash_attention``) on CPU
tensors, where it runs its plain version, against the reference: its jnp
oracle over the sweep of ``tests/test_kernels.py`` (fp32 2e-6, bf16 2e-2),
its Pallas kernel in interpret mode on two of those shapes, and
``chunked_attention`` on the ragged cases (2e-5). Also the ragged Sq and
Skv the Pallas kernel refuses, and what the wrapper refuses.
``test_torch_gpu.py`` holds the CUDA kernel against the plain version on
the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.models.attention import chunked_attention
from repro_torch.kernels import flash_attention as k3

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SWEEP = [(2, 256, 4, 2, 64, True, 0),
         (1, 256, 8, 8, 64, True, 0),      # MHA
         (2, 128, 4, 1, 64, False, 0),     # MQA, non-causal
         (1, 384, 6, 2, 128, True, 96),    # GQA + sliding window
         (1, 128, 2, 2, 128, True, 0)]


def _inputs(B, Sq, Skv, H, KH, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dh)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dh)).astype(np.float32))


def _port(q, k, v, tdtype=torch.float32, **kw):
    out = k3.flash_attention(*(torch.from_numpy(a).to(tdtype)
                               for a in (q, k, v)), **kw)
    assert out.dtype == tdtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_matches_reference(B, S, H, KH, Dh, causal,
                                                 window, dtype):
    tdtype, jdtype = DTYPES[dtype]
    q, k, v = _inputs(B, S, S, H, KH, Dh)
    before = k3.launches
    got = _port(q, k, v, tdtype, causal=causal, window=window)
    assert k3.launches == before      # CPU tensors never reach the kernel
    jq, jk, jv = (jnp.asarray(a).astype(jdtype) for a in (q, k, v))
    expect = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window",
                         [SWEEP[2], SWEEP[4]])
def test_flash_attention_plain_matches_pallas_kernel(B, S, H, KH, Dh, causal,
                                                     window):
    q, k, v = _inputs(B, S, S, H, KH, Dh, seed=1)
    got = _port(q, k, v, causal=causal, window=window)
    expect = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(expect), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,S,H,KH,Dh,window,chunk", [
    (2, 200, 6, 2, 64, 0, 64),
    # the reference's window case at Dh 32, which K3 does not take, at 64
    (1, 160, 4, 4, 64, 48, 32)])
def test_flash_attention_matches_chunked_attention(B, S, H, KH, Dh, window,
                                                   chunk):
    q, k, v = _inputs(B, S, S, H, KH, Dh, seed=2)
    got = _port(q, k, v, causal=True, window=window)
    pos = jnp.arange(S)
    expect = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_positions=pos, kv_positions=pos, causal=True,
                               window=window, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(expect), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Skv,H,KH,Dh,causal,window", [
    (1, 100, 100, 4, 4, 64, True, 0),  # what the Pallas kernel refuses
    (2, 200, 200, 9, 3, 64, True, 0),
    (3, 1, 77, 12, 4, 128, True, 0),
    (1, 77, 50, 16, 1, 64, False, 20),  # rows past the keys: fully masked
])
def test_flash_attention_takes_ragged_lengths(B, Sq, Skv, H, KH, Dh, causal,
                                              window):
    q, k, v = _inputs(B, Sq, Skv, H, KH, Dh, seed=3)
    got = _port(q, k, v, causal=causal, window=window)
    expect = np.asarray(jref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    np.testing.assert_allclose(got, expect, atol=2e-6, rtol=2e-6)
    if window and Skv + window - 1 < Sq:
        assert np.all(got[:, Skv + window - 1:] == 0)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 4, 2, 64))
    with pytest.raises(ValueError):                    # head dim
        k3.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):                    # H % KH
        k3.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError):                    # k and v differ
        k3.flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError):                    # empty sequence
        k3.flash_attention(q[:, :0], k, v)
    with pytest.raises(ValueError):
        k3.flash_attention(q, k, v, window=-1)
    with pytest.raises(TypeError):
        k3.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        k3.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):                    # mixed devices
        k3.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError):                    # non-contiguous
        k3.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):   # no CPU fallback for other devices
        k3.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
