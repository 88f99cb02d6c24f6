"""The port's CNN against ``repro.models.cnn`` on JAX-initialised params:
logits, per-sample NLL, per-leaf gradients of the loss, accuracies."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.models import cnn as ref_cnn
from repro_torch.configs import CNNConfig
from repro_torch.models import cnn
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)

CFGS = [dict(image_size=8, widths=(4,), hidden=16, n_classes=4),
        dict(image_size=12, channels=1, widths=(4, 6), hidden=8,
             n_classes=5)]


def _setup(cfg_kw, n=None, batch=6, seed=0):
    key = jax.random.PRNGKey(seed)
    ref_cfg = RefCNNConfig(**cfg_kw)
    if n is None:
        tree = ref_cnn.init_params(key, ref_cfg)
    else:
        tree = jax.vmap(lambda k: ref_cnn.init_params(k, ref_cfg))(
            jax.random.split(key, n))
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    s, c = ref_cfg.image_size, ref_cfg.channels
    x = rng.uniform(0, 1, lead + (batch, s, s, c)).astype(np.float32)
    y = rng.integers(0, ref_cfg.n_classes, lead + (batch,)).astype(np.int32)
    layout = cnn.param_layout(CNNConfig(**cfg_kw))
    return tree, x, y, layout


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_logits_and_nll_match(cfg_kw):
    tree, x, y, layout = _setup(cfg_kw)
    p = layout.views(from_jax_params(tree, "cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    np.testing.assert_allclose(cnn.apply(p, xt).numpy(),
                               np.asarray(ref_cnn.apply(tree, x)), atol=1e-5)
    np.testing.assert_allclose(cnn.per_sample_nll(p, xt, yt).numpy(),
                               np.asarray(ref_cnn.per_sample_nll(tree, x, y)),
                               atol=1e-5)


@pytest.mark.parametrize("cfg_kw", CFGS)
def test_loss_grads_match_per_leaf(cfg_kw):
    tree, x, y, layout = _setup(cfg_kw)
    flat = from_jax_params(tree, "cpu").requires_grad_(True)
    loss = cnn.loss(layout.views(flat), torch.from_numpy(x),
                    torch.from_numpy(y).long())
    (g,) = torch.autograd.grad(loss, flat)
    ref_loss, ref_g = jax.value_and_grad(ref_cnn.loss)(tree, x, y)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=1e-5)
    got = to_numpy(g, layout)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_stacked_forward_matches_vmap_over_weights():
    cfg_kw = CFGS[0]
    tree, x, y, layout = _setup(cfg_kw, n=3)
    p = layout.views(from_jax_params(tree, "cpu"))
    got = cnn.apply_stacked(p, torch.from_numpy(x)).numpy()
    expect = np.asarray(jax.vmap(ref_cnn.apply)(tree, x))
    np.testing.assert_allclose(got, expect, atol=1e-5)
    # a (1, B, ...) batch is fed to every client
    shared = cnn.apply_stacked(p, torch.from_numpy(x[:1])).numpy()
    expect = np.asarray(jax.vmap(ref_cnn.apply, in_axes=(0, None))(tree,
                                                                   x[0]))
    np.testing.assert_allclose(shared, expect, atol=1e-5)


def test_accuracies_match():
    cfg_kw = CFGS[1]
    tree, x, y, layout = _setup(cfg_kw, n=2, batch=20)
    mask = np.arange(20)[None, :] < np.array([[13], [20]])
    p = layout.views(from_jax_params(tree, "cpu"))
    got = cnn.masked_accuracy_stacked(p, torch.from_numpy(x),
                                      torch.from_numpy(y).long(),
                                      torch.from_numpy(mask)).numpy()
    expect = np.asarray(jax.vmap(ref_cnn.masked_accuracy)(tree, x, y, mask))
    np.testing.assert_allclose(got, expect, atol=1e-6)
    single = jax.tree.map(lambda a: a[0], tree)
    p0 = layout.views(from_jax_params(single, "cpu"))
    np.testing.assert_allclose(
        float(cnn.accuracy(p0, torch.from_numpy(x[0]),
                           torch.from_numpy(y[0]).long())),
        float(ref_cnn.accuracy(single, x[0], y[0])), atol=1e-6)
    np.testing.assert_allclose(
        float(cnn.masked_accuracy(p0, torch.from_numpy(x[0]),
                                  torch.from_numpy(y[0]).long(),
                                  torch.from_numpy(mask[0]))),
        float(ref_cnn.masked_accuracy(single, x[0], y[0], mask[0])),
        atol=1e-6)
