"""The port's client-sharded engine against the reference's fused engine on
the same data, initial params and replayed ``jax.random`` draws, for all
six methods, at D = 2 and D = 4 ranks (``gloo`` on the CPU, one process a
rank); the counterpart of ``tests/test_fedsim_sharded.py``'s parity test.
The last client does not take part, so a wrong slab offset or a target
written back on the wrong rank shows."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import METHODS, FederatedSimulation, FedSimConfig
from repro_torch.models import cnn
from repro_torch.sharding import join_slabs, spawn
from repro_torch.sharding.worker import run_methods
from repro_torch.utils.bridge import from_jax_params, to_numpy
from test_torch_fedsim import _replayed_draws, _tiny_setup
from test_torch_methods import CFG_KW, KW, _ref_run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    """The reference's fused runs of every method on replayed draws, and the
    port's simulation arguments on the same data and params."""
    (rtrain, rtest), (ptrain, ptest), pm, p_err = _tiny_setup()
    ref = RefSimulation(RefCNNConfig(**CFG_KW), rtrain, rtest, pm, p_err,
                        RefFedSimConfig(**KW))
    idx, masks = _replayed_draws(ref)
    runs = {m: _ref_run(ref, m) for m in METHODS}
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port_kw = dict(model_cfg=CNNConfig(**CFG_KW), train_sets=ptrain,
                   test_sets=ptest, participant_mask=pm, p_err=p_err,
                   params0=params0, device="cpu")
    return runs, port_kw, dict(idx_stream=idx, link_masks=masks)


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_matches_reference_fused(reference, devices):
    """Accuracies within 5e-3, π, the final params (the ranks' slabs
    joined) and the train-loss tap within 1e-4, the tap scalars as the
    fused parity test holds them; every rank reports the same history."""
    runs, port_kw, draws = reference
    build_kw = dict(port_kw, sim=FedSimConfig(sharded=True,
                                              shard_devices=devices, **KW))
    ranks = spawn(run_methods, devices, "gloo", "cpu", FederatedSimulation,
                  build_kw, list(METHODS), draws)
    layout = cnn.param_layout(port_kw["model_cfg"])
    for i, method in enumerate(METHODS):
        evals, ref_taps, ref_params = runs[method]
        res = [r[i] for r in ranks]
        assert [r["offset"] for r in res] == [
            k * (4 // devices) for k in range(devices)]
        h = res[0]["history"]
        for r in res[1:]:
            assert r["history"]["target_acc"] == h["target_acc"], method
            np.testing.assert_array_equal(r["history"]["taps"]["train_loss"],
                                          h["taps"]["train_loss"])
        assert res[0]["stats"] == {"engine": "sharded", "blocks": [1, 2],
                                   "device_calls": 2}
        np.testing.assert_allclose(h["target_acc"], [e[0] for e in evals],
                                   atol=5e-3, err_msg=method)
        np.testing.assert_allclose(h["mean_participant_acc"],
                                   [e[1] for e in evals], atol=5e-3,
                                   err_msg=method)
        if method == "pfedwn":
            np.testing.assert_allclose(np.stack(h["pi"]),
                                       np.stack([e[2] for e in evals]),
                                       atol=1e-4)
        else:
            assert h["pi"] == []
        got = to_numpy(join_slabs([r["params"] for r in res]), layout)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=method)
        taps = h["taps"]
        np.testing.assert_allclose(taps["train_loss"], ref_taps["train_loss"],
                                   atol=1e-4, err_msg=method)
        np.testing.assert_allclose(taps["effective_neighbors"],
                                   ref_taps["effective_neighbors"],
                                   rtol=1e-4, err_msg=method)
        np.testing.assert_array_equal(taps["link_success_rate"],
                                      ref_taps["link_success_rate"])
