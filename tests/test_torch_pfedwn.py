"""The port's EM refinement loop (Algorithm 1, bottom half) against
``repro.core.pfedwn.em_refine_loop`` on a tiny CNN, plus the tap metrics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import pfedwn as ref_pfedwn
from repro.models import cnn as ref_cnn
from repro_torch.configs import CNNConfig
from repro_torch.core import pfedwn
from repro_torch.core.fedsim import cnn_fns
from repro_torch.kernels import em_posterior as k1
from repro_torch.models import cnn
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)

KW = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
M, T = 3, 48

REF_FNS = ref_pfedwn.ModelFns(
    per_sample_loss=ref_cnn.per_sample_nll, loss=ref_cnn.loss,
    accuracy=ref_cnn.accuracy)


@pytest.fixture(scope="module")
def components():
    tree = jax.tree.map(np.asarray, jax.vmap(
        lambda k: ref_cnn.init_params(k, RefCNNConfig(**KW)))(
            jax.random.split(jax.random.PRNGKey(1), M)))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (T, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, T).astype(np.int32)
    return tree, x, y


@pytest.mark.parametrize("component_steps", [0, 1, 2])
def test_em_refine_loop_matches_reference(components, component_steps):
    tree, x, y = components
    pi0 = np.array([0.2, 0.5, 0.3], np.float32)
    kw = dict(iters=4, lr=0.5, min_weight=1e-6,
              component_steps=component_steps)
    r_comps, r_pi, r_hist = ref_pfedwn.em_refine_loop(
        REF_FNS, tree, jnp.asarray(pi0), x, y, **kw)

    layout = cnn.param_layout(CNNConfig(**KW))
    flat = from_jax_params(tree, "cpu")
    before = flat.clone()
    launches = k1.launches
    comps, pi, hist = pfedwn.em_refine_loop(
        cnn_fns(layout), flat, torch.from_numpy(pi0), torch.from_numpy(x),
        torch.from_numpy(y).long(), **kw)
    torch.testing.assert_close(flat, before, rtol=0, atol=0)  # not written
    assert k1.launches == launches    # CPU tensors take the plain version
    np.testing.assert_allclose(pi.numpy(), np.asarray(r_pi), atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(r_hist), atol=1e-4)
    assert hist.shape == (4, M)
    for a, b in zip(jax.tree.leaves(to_numpy(comps, layout)),
                    jax.tree.leaves(r_comps)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_em_refine_loop_zero_iters_returns_inputs(components):
    tree, x, y = components
    flat = from_jax_params(tree, "cpu")
    pi0 = torch.full((M,), 1 / M)
    comps, pi, hist = pfedwn.em_refine_loop(
        cnn_fns(cnn.param_layout(CNNConfig(**KW))), flat, pi0,
        torch.from_numpy(x), torch.from_numpy(y).long(), iters=0, lr=0.1)
    assert comps is flat and pi is pi0 and hist.shape == (0, M)


def test_component_losses_match_reference(components):
    tree, x, y = components
    layout = cnn.param_layout(CNNConfig(**KW))
    got = pfedwn.component_losses(cnn_fns(layout),
                                  from_jax_params(tree, "cpu"),
                                  torch.from_numpy(x),
                                  torch.from_numpy(y).long())
    expect = ref_pfedwn.component_losses(REF_FNS, tree, x, y)
    assert got.shape == (T, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5)


@pytest.mark.parametrize("pi,ok", [
    ([0.2, 0.3, 0.5], None), ([0.2, 0.3, 0.5], [True, False, True]),
    ([0.2, 0.3, 0.5], [False, False, False]), ([1.0, 0.0, 0.0], None),
    ([1e-6, 1 - 2e-6, 1e-6], [True, True, True])])
def test_tap_metrics_match_reference(pi, ok):
    pi = np.array(pi, np.float32)
    tok = None if ok is None else torch.tensor(ok)
    jok = None if ok is None else jnp.asarray(ok)
    np.testing.assert_allclose(
        float(pfedwn.pi_entropy(torch.from_numpy(pi))),
        float(ref_pfedwn.pi_entropy(jnp.asarray(pi))), atol=1e-6)
    np.testing.assert_allclose(
        float(pfedwn.effective_neighbors(torch.from_numpy(pi), tok)),
        float(ref_pfedwn.effective_neighbors(jnp.asarray(pi), jok)),
        rtol=1e-6)
