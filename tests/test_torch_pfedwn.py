"""The port's EM refinement loop (Algorithm 1, bottom half) and its whole
Algorithm-2 round against ``repro.core.pfedwn`` on a tiny CNN, the round's
properties on ``tests/test_pfedwn.py``'s toy model, and the tap metrics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PFLConfig as RefPFLConfig
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import pfedwn as ref_pfedwn
from repro.models import cnn as ref_cnn
from repro_torch.configs import CNNConfig, PFLConfig
from repro_torch.core import baselines, pfedwn
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


# ------------------------------------------------------------ pfedwn_round

def _quadratic_fns():
    """``tests/test_pfedwn.py``'s toy model: params w (D,), per-sample loss
    ||w − x_i||², over the port's stacked form (K, D) and x (1, n, D)."""
    def psl(w, x, y):
        return torch.sum((w[:, None, :] - x) ** 2, dim=-1)

    def loss(w, x, y):
        return torch.mean(psl(w, x, y), dim=-1)

    return pfedwn.ModelFns(logits=None, per_sample_loss=psl, loss=loss,
                           accuracy=None)


def test_pfedwn_round_moves_toward_similar_neighbor():
    """Target data clusters at +1; neighbour A sits at +1, B at −5: π
    favours A and the target moves toward +1."""
    fns = _quadratic_fns()
    x = torch.from_numpy(np.random.default_rng(0).normal(1.0, 0.1, (64, 4)))
    x, y = x.float(), torch.zeros(64, dtype=torch.int64)
    target = torch.zeros(4)
    neighbors = torch.stack([torch.full((4,), 1.0), torch.full((4,), -5.0)])
    cfg = PFLConfig(alpha=0.5, lr=0.05, em_iters=5)

    def local_train(w, gen):
        _, g = baselines.loss_and_grad(fns.loss, w[None], x[None], y[None])
        return w - 0.05 * g[0]

    new_w, pi, info = pfedwn.pfedwn_round(
        torch.Generator().manual_seed(0), fns, target, neighbors,
        torch.tensor([0.5, 0.5]), x, y, torch.tensor([0.0, 0.0]), cfg,
        local_train, component_steps=0)
    assert float(pi[0]) > 0.9
    assert float(new_w.mean()) > float(target.mean())
    assert bool(info["link_ok"].all()) and info["pi_history"].shape == (5, 2)


def test_pfedwn_round_erasure_fallback():
    """P_err = 1 on every link: the round reduces to local-only."""
    fns = _quadratic_fns()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (16, 4)))
    x, y = x.float(), torch.zeros(16, dtype=torch.int64)
    target = torch.full((4,), 2.0)
    new_w, _, info = pfedwn.pfedwn_round(
        torch.Generator().manual_seed(0), fns, target,
        torch.full((1, 4), -9.0), torch.tensor([1.0]), x, y,
        torch.tensor([1.0]), PFLConfig(alpha=0.5, lr=0.0, em_iters=2),
        lambda w, gen: w, component_steps=0)
    torch.testing.assert_close(new_w, target, atol=1e-6, rtol=0)
    assert not bool(info["link_ok"][0])


@pytest.mark.parametrize("p_err", [0.0, 1.0])
@pytest.mark.parametrize("component_steps", [0, 1])
def test_pfedwn_round_matches_reference(components, p_err, component_steps):
    """The whole round on the tiny CNN against the reference's, at the two
    erasure probabilities where the link draw is fixed (all up, all
    lost), with a local SGD step on the target's data after the mix."""
    tree, x, y = components
    target_tree = jax.tree.map(lambda a: a[0] * 0.5, tree)
    pi0 = np.array([0.2, 0.5, 0.3], np.float32)
    perr = np.full(M, p_err, np.float32)
    kw = dict(alpha=0.6, lr=0.3, em_iters=3)

    def ref_train(w, key):
        g = jax.grad(ref_cnn.loss)(w, x, y)
        return jax.tree.map(lambda p, gw: p - 0.1 * gw, w, g)

    r_new, r_pi, r_info = ref_pfedwn.pfedwn_round(
        jax.random.PRNGKey(0), REF_FNS, target_tree, tree, jnp.asarray(pi0),
        x, y, jnp.asarray(perr), RefPFLConfig(**kw), ref_train,
        component_steps=component_steps)

    layout = cnn.param_layout(CNNConfig(**KW))
    fns = cnn_fns(layout)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()

    def local_train(w, gen):
        _, g = baselines.loss_and_grad(fns.loss, w[None], tx[None], ty[None])
        return w - 0.1 * g[0]

    new, pi, info = pfedwn.pfedwn_round(
        torch.Generator().manual_seed(0), fns,
        from_jax_params(target_tree, "cpu"), from_jax_params(tree, "cpu"),
        torch.from_numpy(pi0), tx, ty, torch.from_numpy(perr),
        PFLConfig(**kw), local_train, component_steps=component_steps)
    np.testing.assert_allclose(pi.numpy(), np.asarray(r_pi), atol=1e-4)
    np.testing.assert_allclose(info["pi_history"].numpy(),
                               np.asarray(r_info["pi_history"]), atol=1e-4)
    np.testing.assert_array_equal(info["link_ok"].numpy(),
                                  np.asarray(r_info["link_ok"]))
    for a, b in zip(jax.tree.leaves(to_numpy(new, layout)),
                    jax.tree.leaves(r_new)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
