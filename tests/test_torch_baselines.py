"""The port's baselines (``repro_torch.core.baselines``) against
``repro.core.baselines`` on numpy inputs made from a seed, fp32, 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import baselines as ref
from repro.models import cnn as ref_cnn
from repro_torch.configs import CNNConfig
from repro_torch.core import baselines
from repro_torch.core.fedsim import cnn_fns
from repro_torch.models import cnn
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)

N, P = 6, 300
TOL = 1e-6
KW = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
# one non-participant (row 4); a lone participant (row 2); nobody
MASKS = {"one_out": [True, True, True, True, False, True],
         "lone": [False, False, True, False, False, False],
         "none": [False] * N}


def _stack(seed=0):
    """(N, P) rows at different scales, so the squared distances spread
    over two orders of magnitude."""
    rng = np.random.default_rng(seed)
    scale = np.array([0.05, 0.1, 0.2, 0.3, 0.5, 1.0])[:, None]
    return (rng.normal(size=(N, P)) * scale).astype(np.float32)


def _sizes(seed=0):
    return np.random.default_rng(seed).integers(1, 200, N).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mask", list(MASKS))
def test_fedavg_aggregate_matches_reference(mask):
    stack, sizes, pm = _stack(), _sizes(), np.array(MASKS[mask])
    got = baselines.fedavg_aggregate(_t(stack), _t(sizes), _t(pm))
    expect = ref.fedavg_aggregate(jnp.asarray(stack), jnp.asarray(sizes),
                                  jnp.asarray(pm))
    assert got.shape == (P,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=TOL)
    if mask == "none":
        assert not got.any()


@pytest.mark.parametrize("mask", list(MASKS))
def test_broadcast_global_matches_reference(mask):
    stack, pm = _stack(), np.array(MASKS[mask])
    g = _stack(1)[0]
    got = baselines.broadcast_global(_t(g), _t(stack), _t(pm))
    expect = ref.broadcast_global(jnp.asarray(g), jnp.asarray(stack),
                                  jnp.asarray(pm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("mu", [0.1, 3.0])
def test_prox_term_matches_reference(mu):
    """Per row against the reference's (P,) leaf: (K, P) rows to one
    anchor, to per-row anchors, and one row to one anchor."""
    stack = _stack()
    anchors = stack + 0.05 * _stack(2)
    got_one = baselines.prox_term(_t(stack), _t(anchors[0]), mu)
    got_rows = baselines.prox_term(_t(stack), _t(anchors), mu)
    assert got_one.shape == got_rows.shape == (N,)
    for k in range(N):
        np.testing.assert_allclose(
            float(got_one[k]),
            float(ref.prox_term(stack[k], anchors[0], mu)), rtol=TOL)
        np.testing.assert_allclose(
            float(got_rows[k]),
            float(ref.prox_term(stack[k], anchors[k], mu)), atol=TOL)
    single = baselines.prox_term(_t(stack[3]), _t(anchors[3]), mu)
    assert single.shape == ()
    np.testing.assert_allclose(float(single), float(got_rows[3]), atol=0)


def _d2_median(stack):
    d = stack[:, None] - stack[None]
    d2 = np.sum(d.astype(np.float64) ** 2, axis=-1)
    return float(np.median(d2[~np.eye(N, dtype=bool)]))


@pytest.mark.parametrize("sigma", ["1e4", "median"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("self_weight", [0.5, 0.3])
def test_fedamp_weights_match_reference(sigma, mask, self_weight):
    """At the default σ (the attention nearly uniform) and at σ the median
    squared distance (the attention spread), with one non-participant, a
    lone participant and nobody."""
    stack, pm = _stack(), np.array(MASKS[mask])
    s = 1e4 if sigma == "1e4" else _d2_median(stack)
    got = baselines.fedamp_weights(_t(stack), s, _t(pm), self_weight)
    expect = np.asarray(ref.fedamp_weights(jnp.asarray(stack), s,
                                           jnp.asarray(pm), self_weight))
    assert got.shape == (N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=TOL)
    rows = got.numpy().sum(axis=1)
    n_part = int(pm.sum())
    for n in range(N):
        if not pm[n]:
            np.testing.assert_array_equal(got[n].numpy(), np.eye(N)[n])
        elif n_part == 1:
            # the reference's quirk: an all −∞ softmax row turns NaN, then
            # 0, so a lone participant keeps only its self weight
            np.testing.assert_allclose(rows[n], self_weight, atol=TOL)
            np.testing.assert_allclose(got[n, n].item(), self_weight)
        else:
            np.testing.assert_allclose(rows[n], 1.0, atol=TOL)
    if sigma == "median" and mask == "one_out":
        off = got.numpy()[0, [1, 2, 3, 5]]
        assert off.max() - off.min() > 0.05      # σ spreads the attention


def test_fedamp_cloud_models_match_reference():
    stack, pm = _stack(), np.array(MASKS["lone"])
    for s, mask in ((1e4, MASKS["one_out"]), (_d2_median(stack), pm)):
        xi = ref.fedamp_weights(jnp.asarray(stack), s, jnp.asarray(mask))
        got = baselines.fedamp_cloud_models(_t(stack), _t(np.asarray(xi)))
        expect = ref.fedamp_cloud_models(jnp.asarray(stack), xi)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   atol=TOL)
    # the lone participant's cloud is half of its own model
    np.testing.assert_allclose(got[2].numpy(), 0.5 * stack[2], atol=TOL)


@pytest.fixture(scope="module")
def tiny_cnn():
    cfg = RefCNNConfig(**KW)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    tree = jax.tree.map(np.asarray,
                        jax.vmap(lambda k: ref_cnn.init_params(k, cfg))(keys))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 33, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, (2, 33)).astype(np.int32)
    layout = cnn.param_layout(CNNConfig(**KW))
    return tree, x, y, layout


def _row(tree, k):
    return jax.tree.map(lambda a: a[k], tree)


def test_perfedavg_step_matches_reference(tiny_cnn):
    """Two clients in one call against the reference client by client, on
    an odd batch (the query half takes the extra sample)."""
    tree, x, y, layout = tiny_cnn
    half = x.shape[1] // 2
    flat = from_jax_params(tree, "cpu")
    new, l2 = baselines.perfedavg_step(
        cnn_fns(layout).loss, flat, _t(x[:, :half]),
        _t(y[:, :half]).long(), _t(x[:, half:]), _t(y[:, half:]).long(),
        0.3, 0.05)
    assert new.shape == flat.shape and l2.shape == (2,)
    assert not new.requires_grad and not l2.requires_grad
    got = to_numpy(new, layout)
    for k in range(2):
        r_new, r_l2 = ref.perfedavg_step(
            ref_cnn.loss, _row(tree, k), x[k, :half], y[k, :half],
            x[k, half:], y[k, half:], 0.3, 0.05)
        np.testing.assert_allclose(float(l2[k]), float(r_l2), atol=TOL)
        for a, b in zip(jax.tree.leaves(_row(got, k)),
                        jax.tree.leaves(r_new)):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL)


def test_maml_adapt_matches_reference(tiny_cnn):
    tree, x, y, layout = tiny_cnn
    flat = from_jax_params(tree, "cpu")
    with torch.no_grad():                   # as the engine's eval calls it
        adapted = baselines.maml_adapt(cnn_fns(layout).loss, flat[:1],
                                       _t(x[:1]), _t(y[:1]).long(), 0.5)
    expect = ref.maml_adapt(ref_cnn.loss, _row(tree, 0), x[0], y[0], 0.5)
    got = to_numpy(adapted, layout)
    for a, b in zip(jax.tree.leaves(_row(got, 0)), jax.tree.leaves(expect)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)
    assert float((adapted - flat[:1]).abs().max()) > 1e-3
