"""The port's EM algebra (Eq 9-11) and Eq-1 aggregation: the properties of
``tests/test_em.py`` and ``tests/test_aggregation.py``, re-run on the port,
and parity with ``repro.core.em`` / ``repro.core.aggregation``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from repro.core import aggregation as ref_aggregation
from repro.core import em as ref_em
from repro_torch.core import aggregation, em

torch.set_num_threads(1)


def _rand_losses(seed, n, m, scale=3.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, scale, (n, m)).astype(np.float32))


# -------------------------------------------------------------------- EM

def test_posterior_rows_on_simplex():
    lam = em.posterior(torch.tensor([0.2, 0.3, 0.5]), _rand_losses(0, 50, 3))
    np.testing.assert_allclose(lam.sum(1).numpy(), 1.0, rtol=1e-5)
    assert bool(torch.all(lam >= 0))


def test_posterior_prefers_low_loss_component():
    lam = em.posterior(torch.tensor([0.5, 0.5]),
                       torch.tensor([[0.1, 5.0]] * 10))
    assert bool(torch.all(lam[:, 0] > 0.9))


def test_update_pi_is_mean_of_posteriors():
    lam = em.posterior(torch.tensor([0.25, 0.75]), _rand_losses(1, 32, 2))
    np.testing.assert_allclose(em.update_pi(lam).numpy(),
                               lam.mean(0).numpy(), rtol=1e-6)


def test_em_monotone_log_likelihood():
    losses = _rand_losses(2, 64, 4)
    pi = torch.full((4,), 0.25)
    prev = float(em.mixture_log_likelihood(pi, losses))
    for _ in range(10):
        pi = em.update_pi(em.posterior(pi, losses))
        cur = float(em.mixture_log_likelihood(pi, losses))
        assert cur >= prev - 1e-4
        prev = cur


def test_em_weights_converges_to_fixed_point():
    losses = _rand_losses(3, 128, 3)
    pi, _ = em.em_weights(torch.full((3,), 1 / 3), losses, iters=50)
    pi2 = em.update_pi(em.posterior(pi, losses, 1e-8))
    np.testing.assert_allclose(pi.numpy(), pi2.numpy(), atol=1e-4)


def test_em_identifies_similar_component():
    rng = np.random.default_rng(5)
    losses = np.column_stack([rng.uniform(0.0, 0.5, 200),
                              rng.uniform(2.0, 4.0, 200),
                              rng.uniform(1.0, 3.0, 200)]).astype(np.float32)
    pi, _ = em.em_weights(torch.full((3,), 1 / 3), torch.from_numpy(losses),
                          iters=20)
    assert int(torch.argmax(pi)) == 0 and float(pi[0]) > 0.8


@settings(max_examples=25, deadline=None)
@given(losses=hnp.arrays(np.float32, hnp.array_shapes(min_dims=2, max_dims=2,
                                                      min_side=2,
                                                      max_side=12),
                         elements=st.floats(0, 20, width=32)))
def test_em_weights_always_simplex(losses):
    n, m = losses.shape
    pi, lam = em.em_weights(torch.full((m,), 1.0 / m),
                            torch.from_numpy(losses), iters=5)
    assert np.isclose(float(pi.sum()), 1.0, atol=1e-4)
    assert bool(torch.all(pi >= 0))
    assert np.allclose(lam.sum(1).numpy(), 1.0, atol=1e-4)


def test_weighted_loss_matches_manual():
    assert np.isclose(float(em.weighted_loss(torch.tensor([1.0, 2.0, 3.0]),
                                             torch.tensor([1.0, 0.0, 1.0]))),
                      2.0)


def test_extreme_losses_no_nan():
    pi, lam = em.em_weights(torch.tensor([0.5, 0.5]),
                            torch.tensor([[1e4, 0.0], [0.0, 1e4]]), iters=5)
    assert bool(torch.all(torch.isfinite(pi)))
    assert bool(torch.all(torch.isfinite(lam)))


@pytest.mark.parametrize("min_weight", [0.0, 1e-6, 0.05, 0.5])
def test_em_matches_reference(min_weight):
    """posterior (with the affine floor), update_pi, em_weights and the
    log-likelihood against ``repro.core.em``."""
    losses = _rand_losses(6, 40, 4, scale=8.0)
    pi = torch.tensor([0.1, 0.2, 0.3, 0.4])
    jl, jp = jnp.asarray(losses.numpy()), jnp.asarray(pi.numpy())
    lam = em.posterior(pi, losses, min_weight)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(ref_em.posterior(jp, jl, min_weight)),
        atol=1e-6)
    if min_weight:   # a true floor; M·w >= 1 gives uniform rows
        assert float(lam.min()) >= min(min_weight, 1 / 4) * (1 - 1e-5)
    np.testing.assert_allclose(em.update_pi(lam).numpy(),
                               np.asarray(ref_em.update_pi(jnp.asarray(
                                   lam.numpy()))), atol=1e-6)
    pi_star, lam_star = em.em_weights(pi, losses, iters=7,
                                      min_weight=min_weight)
    rp, rl = ref_em.em_weights(jp, jl, iters=7, min_weight=min_weight)
    np.testing.assert_allclose(pi_star.numpy(), np.asarray(rp), atol=1e-5)
    np.testing.assert_allclose(lam_star.numpy(), np.asarray(rl), atol=1e-5)
    np.testing.assert_allclose(
        float(em.mixture_log_likelihood(pi, losses)),
        float(ref_em.mixture_log_likelihood(jp, jl)), rtol=1e-5)


# ------------------------------------------------------------ aggregation

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, scale, (4, 3))
                                  .astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(0, scale, (5,))
                                        .astype(np.float32))}}


def _stack(trees):
    return {"a": torch.stack([t["a"] for t in trees]),
            "b": {"c": torch.stack([t["b"]["c"] for t in trees])}}


def _leaves(t):
    return [t["a"], t["b"]["c"]]


def test_mix_params_matches_manual():
    own, t1, t2 = _tree(0), _tree(1), _tree(2)
    out = aggregation.mix_params(own, _stack([t1, t2]),
                                 torch.tensor([0.25, 0.75]), 0.4)
    for o, a, b, got in zip(_leaves(own), _leaves(t1), _leaves(t2),
                            _leaves(out)):
        expect = 0.4 * o + 0.6 * (0.25 * a + 0.75 * b)
        np.testing.assert_allclose(got.numpy(), expect.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_alpha_one_keeps_own_model():
    own = _tree(0)
    out = aggregation.mix_params(own, _stack([_tree(1), _tree(2)]),
                                 torch.tensor([0.5, 0.5]), 1.0)
    for a, b in zip(_leaves(out), _leaves(own)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_identical_models_fixed_point():
    own = _tree(7)
    out = aggregation.mix_params(own, _stack([_tree(7)] * 3),
                                 torch.tensor([0.2, 0.3, 0.5]), 0.37)
    for a, b in zip(_leaves(out), _leaves(own)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_masked_pi_renormalizes():
    w = aggregation.masked_pi(torch.tensor([0.2, 0.3, 0.5]),
                              torch.tensor([True, False, True]))
    np.testing.assert_allclose(w.numpy(), [0.2 / 0.7, 0.0, 0.5 / 0.7],
                               rtol=1e-5)
    none = aggregation.masked_pi(torch.tensor([0.2, 0.8]),
                                 torch.tensor([False, False]))
    np.testing.assert_array_equal(none.numpy(), [0.0, 0.0])


def test_all_links_failed_keeps_local():
    own = _tree(0)
    out = aggregation.mix_params_with_erasures(
        own, _stack([_tree(1), _tree(2)]), torch.tensor([0.5, 0.5]), 0.5,
        torch.tensor([False, False]))
    for a, b in zip(_leaves(out), _leaves(own)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_erasure_equals_renormalized_mix():
    own, n1, n2, n3 = _tree(0), _tree(1), _tree(2), _tree(3)
    out = aggregation.mix_params_with_erasures(
        own, _stack([n1, n2, n3]), torch.tensor([0.5, 0.2, 0.3]), 0.5,
        torch.tensor([True, False, True]))
    expect = aggregation.mix_params(own, _stack([n1, n3]),
                                    torch.tensor([0.5 / 0.8, 0.3 / 0.8]), 0.5)
    for a, b in zip(_leaves(out), _leaves(expect)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


@settings(max_examples=20, deadline=None)
@given(alpha=st.floats(0.0, 1.0),
       pi_raw=st.lists(st.floats(0.01, 1.0), min_size=2, max_size=5))
def test_mix_convexity_bound(alpha, pi_raw):
    pi = torch.tensor(pi_raw, dtype=torch.float32)
    pi = pi / pi.sum()
    M = len(pi_raw)
    own = {"w": torch.from_numpy(np.random.default_rng(0).normal(0, 1, (6,))
                                 .astype(np.float32))}
    trees = [{"w": torch.from_numpy(np.random.default_rng(i + 1)
                                    .normal(0, 1, (6,)).astype(np.float32))}
             for i in range(M)]
    out = aggregation.mix_params(
        own, {"w": torch.stack([t["w"] for t in trees])}, pi, alpha)["w"]
    allw = torch.stack([own["w"]] + [t["w"] for t in trees]).numpy()
    assert np.all(out.numpy() <= allw.max(0) + 1e-5)
    assert np.all(out.numpy() >= allw.min(0) - 1e-5)


def test_masked_pi_matches_reference():
    pi = np.array([0.1, 0.6, 0.3], np.float32)
    for ok in ([True, True, False], [False, False, False], [False, True, True]):
        np.testing.assert_allclose(
            aggregation.masked_pi(torch.from_numpy(pi),
                                  torch.tensor(ok)).numpy(),
            np.asarray(ref_aggregation.masked_pi(pi, np.array(ok))),
            atol=1e-7)
