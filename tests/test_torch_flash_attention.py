"""The port's K3 wrapper (``repro_torch.kernels.flash_attention``) on CPU
tensors, where it runs its plain version, against the reference: its jnp
oracle over the sweep of ``tests/test_kernels.py`` (fp32 2e-6, bf16 2e-2),
its Pallas kernel in interpret mode on two of those shapes, and
``chunked_attention`` on the ragged cases (2e-5). The CPU route takes
any head dim, as the reference does: held to the Pallas kernel at 48, 96,
112 and 192 (2e-6). Also the ragged Sq and Skv the Pallas kernel refuses,
and what the wrapper refuses.
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


@pytest.mark.parametrize("Dh", [48, 96, 112, 192])
def test_flash_attention_plain_takes_any_head_dim(Dh):
    """The head dims the reference's kernel takes and the CUDA kernel does
    not (or not yet: 112, 192): the CPU route against the Pallas kernel in
    interpret mode, B 1, S 128, H 4, KH 2, causal, seed 0."""
    q, k, v = _inputs(1, 128, 128, 4, 2, Dh, seed=0)
    got = _port(q, k, v, causal=True)
    expect = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    np.testing.assert_allclose(got, np.asarray(expect), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,S,H,KH,Dh,window,chunk", [
    (2, 200, 6, 2, 64, 0, 64),
    (1, 160, 4, 4, 32, 48, 32)])          # the reference's window case
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
    q32, k32, v32 = (t[..., :32].contiguous() for t in (q, k, v))
    k3._check(q32, k32, v32, 0)           # the CPU route takes any head dim
    with pytest.raises(ValueError, match="head dim"):  # the card's does not
        k3._route(torch.device("cuda"), 32)
    # the meta route (the dry run's) takes any head dim: shapes only
    out = k3.flash_attention(q32.to("meta"), k32.to("meta"), v32.to("meta"))
    assert out.device.type == "meta" and out.shape == q32.shape
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
        k3._route(torch.device("xpu"), 64)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, keeping 10
    of the 23 mantissa bits (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from split TF32 operands, small terms first, in fp32: each
    product of two TF32 numbers is exact in fp32, as in the tensor core."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _emulate_k3_fp32(q, k, v, causal, window, keys,
                     product=_split_product):
    """K3's fp32 arithmetic on the CPU: unscaled Q, split-TF32 products for
    Q.K^T and P.V, the scale applied to the scores, and an fp32 online
    softmax over tiles of ``keys`` keys, each tile's P.V joining the sum in
    fp32. q (Sq, Dh), k and v (Skv, Dh). It rounds the operands as the
    kernel does; the tensor core's own order of summation is not
    modelled."""
    Sq, Dh = q.shape
    Skv = k.shape[0]
    scale = torch.tensor(1.0 / np.sqrt(Dh), dtype=torch.float32)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((Sq, 1), -1e30)
    l = torch.zeros((Sq, 1))
    acc = torch.zeros((Sq, Dh))
    for k0 in range(0, Skv, keys):
        kt, vt = k[k0:k0 + keys], v[k0:k0 + keys]
        kpos = torch.arange(k0, k0 + kt.shape[0])[None, :]
        keep = torch.ones((Sq, kt.shape[0]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window:
            keep &= kpos > qpos - window
        s = torch.where(keep, product(q, kt.T) * scale,
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        corr = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new), torch.tensor(0.0))
        l = l * corr + p.sum(1, keepdim=True)
        acc = acc * corr + product(p, vt)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("S,Dh,causal,window,keys", [
    (256, 64, True, 0, 64),       # the main path's Dh and key tile
    (200, 64, False, 0, 64),      # ragged, non-causal
    (160, 128, True, 0, 32),      # Dh 128 runs 32-key tiles
    (384, 128, True, 96, 32)])    # the reference's window case
def test_split_tf32_arithmetic_meets_the_fp32_gate(S, Dh, causal, window,
                                                   keys):
    """K3's fp32 route multiplies on the tensor cores in split TF32. Its
    arithmetic, emulated in torch, stays within the fp32 gate (2e-6, atol
    and rtol) of an fp64 reference, and one TF32 product would not."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(S, Dh)).astype(np.float32))
               for _ in range(3))
    got = _emulate_k3_fp32(q, k, v, causal, window, keys)
    pos = np.arange(S)
    keep = np.ones((S, S), bool)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    s = q.double().numpy() @ k.double().numpy().T / np.sqrt(Dh)
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(1, keepdims=True))
    expect = (p / p.sum(1, keepdims=True)) @ v.double().numpy()
    np.testing.assert_allclose(got.numpy(), expect, atol=2e-6, rtol=2e-6)
    plain_tf32 = _emulate_k3_fp32(q, k, v, causal, window, keys,
                                  product=_tf32_product).double().numpy()
    assert not np.allclose(plain_tf32, expect, atol=2e-6, rtol=2e-6)
