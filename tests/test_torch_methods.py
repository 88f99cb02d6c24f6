"""The port's fused engine against the reference's for every method of
``METHODS`` on the same data, initial params and replayed random draws;
pFedWN's ablation switches (``em_uniform``, ``erasures``) and the
``restrict_target_train`` / ``invalidate_caches`` hooks."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.fedsim import METHODS as REF_METHODS
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro.core.fedsim import block_schedule as ref_block_schedule
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import METHODS, FederatedSimulation, FedSimConfig
from repro_torch.utils.bridge import from_jax_params, to_numpy
from test_torch_fedsim import SIM_KW, _replayed_draws, _tiny_setup

torch.set_num_threads(1)

CFG_KW = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
KW = dict(SIM_KW, adapt_subset=32)


def _pair(**switches):
    """A reference and a port simulation on ``_tiny_setup``'s data (one
    non-participant), the port starting from the reference's params."""
    (rtrain, rtest), (ptrain, ptest), pm, p_err = _tiny_setup()
    kw = {**KW, **switches}
    ref = RefSimulation(RefCNNConfig(**CFG_KW), rtrain, rtest, pm, p_err,
                        RefFedSimConfig(**kw))
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = FederatedSimulation(CNNConfig(**CFG_KW), ptrain, ptest, pm, p_err,
                               FedSimConfig(**kw),
                               params0=params0, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def engines():
    return _pair()


def _ref_run(ref_sim, method):
    """Drive the reference's round blocks by hand: per eval point
    (target acc, mean acc, π), the taps of every round, final params."""
    state = ref_sim.initial_state()
    evals, taps = [], []
    for length in ref_block_schedule(ref_sim.sim.rounds,
                                     ref_sim.sim.eval_every):
        state, (t_acc, mean_acc, pi, tap) = ref_sim.block_fn(method)(
            state, length)
        evals.append((float(t_acc), float(mean_acc), np.asarray(pi)))
        taps.append(jax.tree.map(np.asarray, tap))
    taps = {k: np.concatenate([t[k] for t in taps]) for k in taps[0]}
    return evals, taps, jax.tree.map(np.asarray, state[0])


def _assert_matches_reference(ref, port, method):
    """Accuracies within 5e-3, π, final params and the train-loss tap
    within 1e-4; the neighbour-count tap exact (for pFedWN it is a function
    of π, so within π's 1e-4)."""
    idx, masks = _replayed_draws(ref)
    evals, ref_taps, ref_params = _ref_run(ref, method)
    h = port.run(method, idx_stream=idx, link_masks=masks)

    np.testing.assert_allclose(h["target_acc"], [e[0] for e in evals],
                               atol=5e-3)
    np.testing.assert_allclose(h["mean_participant_acc"],
                               [e[1] for e in evals], atol=5e-3)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(h["pi"]),
                                   np.stack([e[2] for e in evals]),
                                   atol=1e-4)
    else:
        assert h["pi"] == []
    got = to_numpy(port.last_state["params"], port.layout)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    taps = h["taps"]
    assert taps["train_loss"].shape == ref_taps["train_loss"].shape
    np.testing.assert_allclose(taps["train_loss"], ref_taps["train_loss"],
                               atol=1e-4)
    if method == "pfedwn":
        np.testing.assert_allclose(taps["effective_neighbors"],
                                   ref_taps["effective_neighbors"],
                                   rtol=1e-4)
    else:
        np.testing.assert_array_equal(taps["effective_neighbors"],
                                      ref_taps["effective_neighbors"])
    np.testing.assert_array_equal(taps["link_success_rate"],
                                  ref_taps["link_success_rate"])


def test_methods_are_the_reference_methods():
    assert METHODS == REF_METHODS


@pytest.mark.parametrize("method", METHODS)
def test_engine_matches_reference_with_replayed_draws(engines, method):
    ref, port = engines
    _assert_matches_reference(ref, port, method)


@pytest.mark.parametrize("method,settings", [
    ("fedamp", dict(fedamp_sigma=2.0, prox_mu=1.0)),
    ("fedamp", dict(fedamp_self_weight=0.2)),
    ("fedprox", dict(prox_mu=1.0)),
    ("perfedavg", dict(maml_inner_lr=0.5)),
    ("perfedavg", dict(batch_size=15))])
def test_baselines_match_reference_with_strong_settings(method, settings):
    """The defaults barely move the baselines' extra terms (σ = 1e4 makes
    FedAMP's attention uniform up to ~1e-4; the tiny CNN's squared
    distances are ~44-48), so each term is also held to the reference
    where it matters: a σ that spreads the attention, a strong prox pull, a
    MAML step that moves the target's eval, an odd batch (the query half
    takes the extra sample)."""
    ref, port = _pair(**settings)
    _assert_matches_reference(ref, port, method)


@pytest.mark.parametrize("em_uniform,erasures", [(True, True),
                                                 (False, False),
                                                 (True, False)])
def test_ablation_switches_match_reference(em_uniform, erasures):
    """``em_uniform`` (π = 1/M, no EM) and ``erasures=False`` (every link
    succeeds, the injected masks notwithstanding) against the reference
    with the same switches."""
    ref, port = _pair(em_uniform=em_uniform, erasures=erasures)
    _assert_matches_reference(ref, port, "pfedwn")
    h = port.run("pfedwn", link_masks=np.zeros((KW["rounds"], port.m),
                                               bool))
    if em_uniform:
        np.testing.assert_allclose(np.stack(h["pi"]), 1.0 / port.m)
    if not erasures:
        np.testing.assert_array_equal(h["taps"]["link_success_rate"], 1.0)


def test_fedprox_single_pass_masking():
    """With nobody participating the prox pull is off for every client, so
    fedprox is plain local training: the same params, the same
    accuracies."""
    _, (train, test), _, p_err = _tiny_setup()
    pm_none = np.zeros(len(train), bool)
    sim = FederatedSimulation(CNNConfig(**CFG_KW), train, test, pm_none,
                              p_err, FedSimConfig(**KW), device="cpu")
    h_prox = sim.run("fedprox")
    prox_params = sim.last_state["params"]
    h_local = sim.run("local")
    np.testing.assert_allclose(h_prox["target_acc"], h_local["target_acc"],
                               atol=1e-6)
    np.testing.assert_allclose(h_prox["mean_participant_acc"],
                               h_local["mean_participant_acc"], atol=1e-6)
    torch.testing.assert_close(prox_params, sim.last_state["params"],
                               rtol=0, atol=0)
    np.testing.assert_array_equal(h_prox["taps"]["effective_neighbors"],
                                  0.0)


def test_restrict_target_train_restages_device_data():
    _, (train, test), pm, p_err = _tiny_setup()
    sim = FederatedSimulation(CNNConfig(**CFG_KW), train, test, pm, p_err,
                              FedSimConfig(**KW), device="cpu")
    before = int(sim._train_len[0])
    sim.run("local")
    sim.restrict_target_train(24)
    assert int(sim._train_len[0]) == 24
    assert int(sim.sizes[0]) == 24
    assert before > 24
    assert sim._em_x.shape[0] == 24 < KW["em_subset"]   # the EM set shrank
    h = sim.run("pfedwn")
    assert 0.0 <= h["max_target_acc"] <= 1.0


@pytest.mark.parametrize("method", ["fedavg", "perfedavg", "pfedwn"])
def test_restricted_target_matches_reference(method):
    """After ``restrict_target_train`` on both sides (24 samples, fewer
    than ``em_subset`` and ``adapt_subset``), the engines still agree."""
    ref, port = _pair()
    ref.restrict_target_train(24)
    port.restrict_target_train(24)
    np.testing.assert_array_equal(port.sizes.numpy(), np.asarray(ref.sizes))
    assert port.steps_per_round == ref.steps_per_round
    _assert_matches_reference(ref, port, method)


def test_invalidate_caches_restages_after_config_change():
    _, (train, test), pm, p_err = _tiny_setup()
    sim = FederatedSimulation(CNNConfig(**CFG_KW), train, test, pm, p_err,
                              FedSimConfig(**KW), device="cpu")
    assert sim._em_x.shape[0] == KW["em_subset"]
    sim.sim.em_subset, sim.sim.adapt_subset = 16, 8
    sim.invalidate_caches()
    assert sim._em_x.shape[0] == 16 and sim._adapt_x.shape[0] == 8
    np.testing.assert_array_equal(sim._em_x.numpy(), train[0].x[:16])


def test_config_defaults_match_reference():
    ref, port = RefFedSimConfig(), FedSimConfig()
    for field in ("adapt_subset", "prox_mu", "maml_inner_lr",
                  "fedamp_sigma", "fedamp_self_weight", "erasures",
                  "em_uniform", "rounds", "batch_size", "lr", "alpha",
                  "em_iters", "em_component_steps", "em_subset",
                  "eval_every", "seed", "sharded", "shard_devices", "fused",
                  "taps"):
        assert getattr(port, field) == getattr(ref, field), field
