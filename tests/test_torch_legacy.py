"""The port's legacy host-driven engine (``FedSimConfig(fused=False)``):
against the port's fused engine for every method, as
``tests/test_fedsim_fused.py`` holds the reference's two engines, and
against the reference's legacy engine on replayed draws."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import METHODS, FederatedSimulation, FedSimConfig
from repro_torch.utils.bridge import from_jax_params
from test_torch_fedsim import SIM_KW, _replayed_draws, _tiny_setup

torch.set_num_threads(1)

CFG_KW = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
KW = dict(SIM_KW, adapt_subset=32)


@pytest.fixture(scope="module")
def port_pair():
    """The port's fused and legacy engines on ``_tiny_setup``'s data (one
    non-participant), from the same params."""
    _, (train, test), pm, p_err = _tiny_setup()
    fused = FederatedSimulation(CNNConfig(**CFG_KW), train, test, pm, p_err,
                                FedSimConfig(**KW), device="cpu")
    legacy = FederatedSimulation(CNNConfig(**CFG_KW), train, test, pm, p_err,
                                 FedSimConfig(fused=False, **KW),
                                 params0=fused.params0, device="cpu")
    return fused, legacy


@pytest.mark.parametrize("method", METHODS)
def test_legacy_matches_fused(port_pair, method):
    """Same seed, so the same on-device draws: the same trajectory."""
    fused, legacy = port_pair
    hf, hl = fused.run(method), legacy.run(method)
    np.testing.assert_allclose(hf["target_acc"], hl["target_acc"], atol=5e-3)
    np.testing.assert_allclose(hf["mean_participant_acc"],
                               hl["mean_participant_acc"], atol=5e-3)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(hf["pi"]), np.stack(hl["pi"]),
                                   atol=1e-4)
    torch.testing.assert_close(hl["taps"]["train_loss"],
                               hf["taps"]["train_loss"], atol=1e-4, rtol=0)
    torch.testing.assert_close(legacy.last_state["params"],
                               fused.last_state["params"], atol=1e-4, rtol=0)
    assert fused.last_run_stats["engine"] == "fused"
    assert legacy.last_run_stats["engine"] == "legacy"


def test_engine_names_and_device_calls(port_pair):
    """``engine`` follows ``sim.fused``; the fused engine syncs once a
    block (rounds 3, eval every 2: blocks [1, 2]); a legacy round drives
    one dispatch for its draw and upload and the method's own, plus one an
    eval for each participant, as the reference counts them."""
    fused, legacy = port_pair
    assert (fused.engine, legacy.engine) == ("fused", "legacy")
    fused.run("fedavg")
    assert fused.last_run_stats == {"engine": "fused", "blocks": [1, 2],
                                    "device_calls": 2}
    legacy.run("fedavg")
    n_part = int(legacy.participants.sum())
    assert legacy.last_run_stats == {"engine": "legacy",
                                     "device_calls": 3 * (1 + 3)
                                     + 2 * n_part}


def test_legacy_round_ms_is_per_round(port_pair):
    _, legacy = port_pair
    h = legacy.run("local")
    assert len(h["round_ms"]) == KW["rounds"]
    assert h["taps"]["train_loss"].shape == (KW["rounds"], legacy.n)


@pytest.mark.parametrize("method", ["pfedwn", "fedamp"])
def test_legacy_matches_reference_legacy_on_replayed_draws(method):
    """The port's legacy engine fed the reference's draws against the
    reference's own legacy engine, which draws them itself."""
    (rtrain, rtest), (ptrain, ptest), pm, p_err = _tiny_setup()
    ref = RefSimulation(RefCNNConfig(**CFG_KW), rtrain, rtest, pm, p_err,
                        RefFedSimConfig(fused=False, **KW))
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = FederatedSimulation(CNNConfig(**CFG_KW), ptrain, ptest, pm, p_err,
                               FedSimConfig(fused=False, **KW),
                               params0=params0, device="cpu")
    idx, masks = _replayed_draws(ref)
    hr = ref.run(method)
    hp = port.run(method, idx_stream=idx, link_masks=masks)
    np.testing.assert_allclose(hp["target_acc"], hr["target_acc"], atol=5e-3)
    np.testing.assert_allclose(hp["mean_participant_acc"],
                               hr["mean_participant_acc"], atol=5e-3)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(hp["pi"]), np.stack(hr["pi"]),
                                   atol=1e-4)
    assert ref.last_run_stats["engine"] == "legacy"
    assert port.last_run_stats == ref.last_run_stats
