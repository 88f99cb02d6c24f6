"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the reference's sweep shapes and the pFedWN round's shapes. Every test
here needs a CUDA card and skips without one; the file imports nothing of
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import em_posterior as k1
from repro_torch.kernels import ref as tref
from repro_torch.kernels import weighted_agg as k2

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


@pytest.mark.gpu
@pytest.mark.parametrize("M,T,V", [(2, 128, 512), (3, 384, 1536),
                                   (10, 512, 10), (3, 37, 10), (32, 9, 33)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_kernel_matches_plain_on_card(cuda, M, T, V, dtype):
    tdtype = DTYPES[dtype]
    pi, logits, labels = _em_inputs(M, T, V)
    args = (torch.from_numpy(pi).to(cuda),
            torch.from_numpy(logits).to(device=cuda, dtype=tdtype),
            torch.from_numpy(labels).to(cuda))
    before = k1.launches
    lam, ell = k1.em_posterior_forward(*args)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    plam, pell = tref.em_posterior_ref(*args)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(lam, plam, atol=tol, rtol=0)
    torch.testing.assert_close(ell, pell, atol=tol, rtol=1e-5)


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
