"""The port's channel model and neighbour selection against
``repro.core.wireless`` / ``repro.core.selection``, on quickstart's
scenario, plus the properties of ``tests/test_wireless.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import WirelessConfig as RefWirelessConfig
from repro.core import selection as ref_selection
from repro.core import wireless as ref_wireless
from repro_torch.configs import WirelessConfig
from repro_torch.core import selection, wireless

torch.set_num_threads(1)

CFG, REF_CFG = WirelessConfig(), RefWirelessConfig()


def _quickstart_positions(seed=0, n=10):
    rng = np.random.default_rng(seed)
    return rng.uniform(10, 40, 2), rng.uniform(0, 50, (n, 2))


@pytest.mark.parametrize("seed,eps,gth", [(0, 0.1, 10.0), (0, 0.03, 15.0),
                                          (4, 0.05, 5.0)])
def test_select_neighbors_matches_reference(seed, eps, gth):
    target, nbrs = _quickstart_positions(seed)
    got = selection.select_neighbors(CFG, target, nbrs, eps=eps,
                                     sinr_threshold=gth, device="cpu")
    ref = ref_selection.select_neighbors(REF_CFG, jnp.asarray(target),
                                         jnp.asarray(nbrs), eps=eps,
                                         sinr_threshold=gth)
    np.testing.assert_allclose(got.p_err.numpy(), np.asarray(ref.p_err),
                               atol=1e-5)
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(ref.selected))


def test_select_neighbors_with_invalid_candidates():
    target, nbrs = _quickstart_positions(1)
    valid = np.arange(10) % 3 != 0
    got = selection.select_neighbors(CFG, target, nbrs, valid, eps=0.1,
                                     sinr_threshold=10.0, device="cpu")
    ref = ref_selection.select_neighbors(REF_CFG, jnp.asarray(target),
                                         jnp.asarray(nbrs),
                                         jnp.asarray(valid), eps=0.1,
                                         sinr_threshold=10.0)
    np.testing.assert_allclose(got.p_err.numpy(), np.asarray(ref.p_err),
                               atol=1e-5)
    assert np.all(got.p_err.numpy()[~valid] == 1.0)


def test_error_probability_matches_reference():
    interferers = np.array([10.0, 15.0, 20.0, -1.0], np.float32)
    for d, gth in [(2.0, 10.0), (30.0, 10.0), (10.0, 5.0), (49.0, 100.0)]:
        got = wireless.error_probability(CFG, torch.tensor(d),
                                         torch.from_numpy(interferers), gth)
        expect = ref_wireless.error_probability(
            REF_CFG, jnp.float32(d), jnp.asarray(interferers), gth)
        np.testing.assert_allclose(float(got), float(expect), atol=1e-5)


def test_error_probability_bounds_and_monotonicity():
    interferers = torch.tensor([10.0, 15.0, 20.0, -1.0])
    p_close = float(wireless.error_probability(CFG, torch.tensor(2.0),
                                               interferers, 10.0))
    p_far = float(wireless.error_probability(CFG, torch.tensor(30.0),
                                             interferers, 10.0))
    assert 0.0 <= p_close < p_far <= 1.0
    p_lo = wireless.error_probability(CFG, torch.tensor(10.0), interferers,
                                      5.0)
    p_hi = wireless.error_probability(CFG, torch.tensor(10.0), interferers,
                                      15.0)
    assert float(p_hi) >= float(p_lo)
    bound = np.exp(-CFG.fading_threshold ** 2 / CFG.rayleigh_gamma)
    p = wireless.error_probability(CFG, torch.tensor(49.0),
                                   torch.tensor([2.0, 2.0, 2.0]), 100.0)
    assert float(p) <= bound + 1e-3


@settings(max_examples=20, deadline=None)
@given(d=st.floats(1.0, 60.0), gth=st.floats(1.0, 30.0))
def test_error_probability_in_unit_interval(d, gth):
    p = wireless.error_probability(CFG, torch.tensor(d, dtype=torch.float32),
                                   torch.tensor([5.0, 12.0, 33.0]), gth)
    assert 0.0 <= float(p) <= 1.0


def test_channel_pieces_match_reference():
    d = np.array([1.0, 2.0, 5.0, 10.0, 50.0], np.float32)
    np.testing.assert_allclose(
        wireless.path_loss_amplitude(CFG, torch.from_numpy(d)).numpy(),
        np.asarray(ref_wireless.path_loss_amplitude(REF_CFG, d)), rtol=1e-6)
    np.testing.assert_allclose(wireless._moment_x3(CFG),
                               float(ref_wireless._moment_x3(REF_CFG)),
                               rtol=1e-6)
    np.testing.assert_allclose(wireless._moment_x5(CFG),
                               float(ref_wireless._moment_x5(REF_CFG)),
                               rtol=1e-6)
    dists = np.array([[3.0, 7.0, -1.0], [12.0, 4.0, 9.0]], np.float32)
    mean, var = wireless.interference_moments(CFG, torch.from_numpy(dists))
    for i in range(2):
        rm, rv = ref_wireless.interference_moments(REF_CFG, dists[i])
        np.testing.assert_allclose(float(mean[i]), float(rm), rtol=1e-5)
        np.testing.assert_allclose(float(var[i]), float(rv), rtol=1e-5)
    mu, sigma = wireless.lognormal_params(torch.tensor(3e-9),
                                          torch.tensor(4e-18))
    rmu, rsig = ref_wireless.lognormal_params(jnp.float32(3e-9),
                                              jnp.float32(4e-18))
    np.testing.assert_allclose([float(mu), float(sigma)],
                               [float(rmu), float(rsig)], rtol=1e-5)
    x = torch.tensor([-1.0, 1e-12, 1e-9, 1e-6])
    np.testing.assert_allclose(
        wireless.lognormal_ccdf(x, mu, sigma).numpy(),
        np.asarray(ref_wireless.lognormal_ccdf(x.numpy(), rmu, rsig)),
        atol=1e-6)


def test_link_success_mask_and_rate():
    gen = torch.Generator().manual_seed(0)
    ok = selection.link_success_mask(torch.full((20000,), 0.3), gen)
    assert ok.dtype == torch.bool and abs(float(ok.float().mean()) - 0.7) < 0.02
    edges = selection.link_success_mask(torch.tensor([0.0, 1.0] * 5), gen)
    assert bool(edges[0::2].all()) and not bool(edges[1::2].any())
    for m in ([True, False, True, True], [], [False]):
        np.testing.assert_allclose(
            float(selection.link_success_rate(torch.tensor(m, dtype=bool))),
            float(ref_selection.link_success_rate(jnp.asarray(m, bool))))


def test_pairwise_distances_match_reference():
    pos = np.random.default_rng(5).uniform(0, 50, (12, 2)).astype(np.float32)
    got = wireless.pairwise_distances(torch.from_numpy(pos))
    expect = ref_wireless.pairwise_distances(jnp.asarray(pos))
    assert got.shape == (12, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    # the +1e-12 under the root keeps the diagonal off zero
    np.testing.assert_allclose(np.diag(got.numpy()), 1e-6, rtol=1e-3)


@pytest.mark.parametrize("seed,density,max_nodes", [(1, 4e-3, 64),
                                                    (2, 4e-3, 5),
                                                    (3, 1e-7, 16)])
def test_ppp_positions_in_area(seed, density, max_nodes):
    """``tests/test_wireless.py``'s properties (the draws differ from
    ``jax.random``'s): positions in the area, between 1 and ``max_nodes``
    valid, valid rows first; the count follows Poisson(density · area)."""
    gen = torch.Generator().manual_seed(seed)
    pos, valid = wireless.ppp_positions(gen, CFG, density, max_nodes)
    assert pos.shape == (max_nodes, 2) and pos.dtype == torch.float32
    assert bool(torch.all((pos >= 0) & (pos <= CFG.area_m)))
    n = int(valid.sum())
    assert 1 <= n <= max_nodes
    assert bool(valid[:n].all()) and not bool(valid[n:].any())
    ref_pos, ref_valid = ref_wireless.ppp_positions(
        jax.random.PRNGKey(seed), REF_CFG, density, max_nodes)
    assert ref_pos.shape == tuple(pos.shape)
    assert ref_valid.dtype == jnp.bool_ and valid.dtype == torch.bool


def test_ppp_positions_count_is_poisson():
    """Over 400 draws the clipped-free count (λ = 10 nodes on the area)
    has the Poisson mean and variance."""
    gen = torch.Generator().manual_seed(0)
    lam = 10.0
    density = lam / CFG.area_m ** 2
    counts = np.array([int(wireless.ppp_positions(gen, CFG, density,
                                                  64)[1].sum())
                       for _ in range(400)])
    assert abs(counts.mean() - lam) < 0.5
    assert abs(counts.var() - lam) < 2.5
