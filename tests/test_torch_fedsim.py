"""The port's fused engine against the reference fused engine on the same
data, initial params and replayed random draws; the port's isolation from
JAX and its CUDA-by-default entry points."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro.core.fedsim import block_schedule as ref_block_schedule
from repro.core.selection import link_success_mask as ref_link_success_mask
from repro.data import (dirichlet_partition, make_client_datasets,
                        synthetic_image_dataset, train_test_split)
from repro_torch import data as tdata
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import (FederatedSimulation, FedSimConfig,
                                     block_schedule)
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)

ROUNDS, EVAL_EVERY = 3, 2
SIM_KW = dict(rounds=ROUNDS, batch_size=16, lr=0.05, em_iters=2,
              em_subset=64, eval_every=EVAL_EVERY, seed=0)
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src")


def _tiny_data(pkg_synth, pkg_part, pkg_make, pkg_split, n_clients=4,
               seed=0):
    """``tests/test_fedsim_fused.py::_tiny_setup``'s data, from either
    package's data functions."""
    base = pkg_synth(seed, 600, image_size=8, n_classes=4)
    parts = pkg_part(base.y, n_clients, alpha=0.3, seed=seed)
    train = pkg_make(base, [pkg_split(p, seed=1)[0] for p in parts])
    test = pkg_make(base, [pkg_split(p, seed=1)[1] for p in parts])
    return train, test


def _tiny_setup():
    n = 4
    pm = np.array([True] * (n - 1) + [False])
    p_err = np.linspace(0.0, 0.2, n).astype(np.float32)
    ref_data = _tiny_data(synthetic_image_dataset, dirichlet_partition,
                          make_client_datasets, train_test_split)
    port_data = _tiny_data(tdata.synthetic_image_dataset,
                           tdata.dirichlet_partition,
                           tdata.make_client_datasets,
                           tdata.train_test_split)
    return ref_data, port_data, pm, p_err


def _replayed_draws(ref_sim):
    """The reference fused engine's per-round draws, replayed outside it:
    key from PRNGKey(seed+7), split (key, k_sample, k_erase) each round."""
    sample = ref_sim._sample_idx_fn()
    p_err_nbr = ref_sim.p_err[np.asarray(ref_sim._neighbor_idx)]
    key = jax.random.PRNGKey(ref_sim.sim.seed + 7)
    idx, masks = [], []
    for _ in range(ref_sim.sim.rounds):
        key, k_sample, k_erase = jax.random.split(key, 3)
        idx.append(np.asarray(sample(k_sample)))
        masks.append(np.asarray(ref_link_success_mask(k_erase, p_err_nbr)))
    return np.stack(idx), np.stack(masks)


def _ref_blocks(ref_sim, method):
    """Drive the reference's donated round blocks by hand, keeping the
    final state (its ``run`` returns only the history)."""
    state = ref_sim.initial_state()
    evals = []
    for length in ref_block_schedule(ref_sim.sim.rounds,
                                     ref_sim.sim.eval_every):
        state, (t_acc, mean_acc, pi, _) = ref_sim.block_fn(method)(state,
                                                                  length)
        evals.append((float(t_acc), float(mean_acc), np.asarray(pi)))
    return evals, jax.tree.map(np.asarray, state[0])


@pytest.fixture(scope="module")
def engines():
    (rtrain, rtest), (ptrain, ptest), pm, p_err = _tiny_setup()
    cfg_kw = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
    ref = RefSimulation(RefCNNConfig(**cfg_kw), rtrain, rtest, pm, p_err,
                        RefFedSimConfig(adapt_subset=32, **SIM_KW))
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = FederatedSimulation(CNNConfig(**cfg_kw), ptrain, ptest, pm, p_err,
                               FedSimConfig(**SIM_KW), params0=params0,
                               device="cpu")
    return ref, port


@pytest.mark.parametrize("method", ["pfedwn", "local"])
def test_engine_matches_reference_with_replayed_draws(engines, method):
    ref, port = engines
    idx, masks = _replayed_draws(ref)
    evals, ref_params = _ref_blocks(ref, method)
    h = port.run(method, idx_stream=idx, link_masks=masks)

    np.testing.assert_allclose(h["target_acc"], [e[0] for e in evals],
                               atol=5e-3)
    np.testing.assert_allclose(h["mean_participant_acc"],
                               [e[1] for e in evals], atol=5e-3)
    if method == "pfedwn":
        np.testing.assert_allclose(np.stack(h["pi"]),
                                   np.stack([e[2] for e in evals]),
                                   atol=1e-4)
    got = to_numpy(port.last_state["params"], port.layout)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert h["taps"]["train_loss"].shape == (ROUNDS, port.n)
    assert len(h["round_ms"]) == len(block_schedule(ROUNDS, EVAL_EVERY))


def test_pfedwn_past_32_neighbors_matches_reference():
    """40 clients, all of them taking part, so the target mixes M = 39
    neighbours (past the 32 lanes of a warp): the port's fused engine
    against the reference's on replayed draws."""
    n = 40
    cfg_kw = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
    sim_kw = dict(rounds=2, batch_size=16, em_iters=1, em_subset=64,
                  eval_every=2, seed=0)
    pm = np.ones(n, bool)
    p_err = np.linspace(0.0, 0.2, n).astype(np.float32)
    data = []
    for synth, part, make, split in (
            (synthetic_image_dataset, dirichlet_partition,
             make_client_datasets, train_test_split),
            (tdata.synthetic_image_dataset, tdata.dirichlet_partition,
             tdata.make_client_datasets, tdata.train_test_split)):
        base = synth(0, 4000, image_size=8, n_classes=4)
        parts = part(base.y, n, alpha=1.0, seed=0)
        data.append((make(base, [split(p, seed=1)[0] for p in parts]),
                     make(base, [split(p, seed=1)[1] for p in parts])))
    ref = RefSimulation(RefCNNConfig(**cfg_kw), *data[0], pm, p_err,
                        RefFedSimConfig(**sim_kw))
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = FederatedSimulation(CNNConfig(**cfg_kw), *data[1], pm, p_err,
                               FedSimConfig(**sim_kw), params0=params0,
                               device="cpu")
    assert port.m == n - 1
    idx, masks = _replayed_draws(ref)
    evals, ref_params = _ref_blocks(ref, "pfedwn")
    h = port.run("pfedwn", idx_stream=idx, link_masks=masks)
    np.testing.assert_allclose(np.stack(h["pi"]),
                               np.stack([e[2] for e in evals]), atol=1e-4)
    np.testing.assert_allclose(h["target_acc"], [e[0] for e in evals],
                               atol=5e-3)
    np.testing.assert_allclose(h["mean_participant_acc"],
                               [e[1] for e in evals], atol=5e-3)
    got = to_numpy(port.last_state["params"], port.layout)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_engine_draws_its_own_stream(engines):
    """Without injected draws the engine samples on its device; π stays on
    the simplex and the taps are finite."""
    _, port = engines
    h = port.run("pfedwn")
    pi = h["pi"][-1]
    assert np.isclose(pi.sum(), 1.0, atol=1e-5) and np.all(pi >= 0)
    for v in h["taps"].values():
        assert np.all(np.isfinite(v))
    assert 0.0 <= h["max_target_acc"] <= 1.0


def test_engine_rejects_bad_injected_draws(engines):
    _, port = engines
    idx = np.zeros((ROUNDS, port.n, port.steps_per_round, 16), np.int64)
    with pytest.raises(ValueError):
        port.run("local", idx_stream=idx[:, :, :1])
    idx[0, 1, 0, 0] = 10_000
    with pytest.raises(ValueError):
        port.run("local", idx_stream=idx)
    with pytest.raises(ValueError):
        port.run("scaffold")


def test_block_schedule_matches_reference():
    for rounds, e in [(1, 1), (4, 1), (5, 2), (6, 3), (9, 4), (8, 4)]:
        assert block_schedule(rounds, e) == ref_block_schedule(rounds, e)


_ISOLATION = r"""
import sys
import numpy as np
import torch
import repro_torch
from repro_torch.configs import CNNConfig, WirelessConfig
from repro_torch.core import baselines, selection
from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
from repro_torch.data import (dirichlet_partition, make_client_datasets,
                              synthetic_image_dataset, train_test_split)
from repro_torch.models import cnn

base = synthetic_image_dataset(0, 300, image_size=8, n_classes=4)
parts = dirichlet_partition(base.y, 3, alpha=0.5, seed=0)
tr = make_client_datasets(base, [train_test_split(p)[0] for p in parts])
te = make_client_datasets(base, [train_test_split(p)[1] for p in parts])
args = (CNNConfig(image_size=8, widths=(4,), hidden=8, n_classes=4), tr, te,
        np.ones(3, bool), np.zeros(3, np.float32),
        FedSimConfig(rounds=2, batch_size=16, em_iters=2, em_subset=32))
sim = FederatedSimulation(*args, device="cpu")
h = sim.run("pfedwn")
assert len(h["pi"]) == 2
for method in ("fedavg", "perfedavg", "fedamp"):
    h = sim.run(method)
    assert 0.0 <= h["max_target_acc"] <= 1.0 and h["pi"] == []
xi = baselines.fedamp_weights(sim.params0, 1e4, sim.participants)
assert torch.allclose(xi.sum(1), torch.ones(3))
from benchmarks import (torch_ablations, torch_common,  # the port's tables
                        torch_table2_accuracy, torch_table3_accuracy,
                        torch_fig1_gap, torch_fig5_neighbors,
                        torch_fig6_selection, torch_fig8_em_weights,
                        torch_fedsim_bench, torch_kernel_times)
legacy = FederatedSimulation(*args[:-1], FedSimConfig(
    rounds=2, batch_size=16, em_iters=2, em_subset=32, fused=False),
    device="cpu")
assert legacy.run("pfedwn")["pi"][-1].shape == (2,)
import os, tempfile
from repro_torch import obs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.obs import report
lines = [obs.encode_event(e) for e in legacy.recorder.events]
assert obs.validate_jsonl_lines(lines) == []
assert report.load_runs(lines)[0]["summary"]["engine"] == "legacy"
path = os.path.join(tempfile.mkdtemp(), "p.npz")
save_checkpoint(path, {"p": sim.params0}, step=3)
assert load_checkpoint(path, {"p": sim.params0})[1] == 3
import repro_torch.sharding
from repro_torch.lint import blocks
from repro_torch.sharding import worker
import repro_torch.optim
from repro_torch.configs import get_config, musicgen_large, qwen2_vl_2b
from repro_torch.launch import train
assert {get_config(a).family for a in ("qwen2-vl-2b", "musicgen-large")} \
    == {"vlm", "audio"}
lm = get_config("smollm-135m").reduced()
assert len(train.single_client(lm, steps=1, batch=1, seq=4,
                               device="cpu")["losses"]) == 1
from repro_torch.configs import shapes, get_shape
from repro_torch.launch import steps
assert steps.input_specs(lm, get_shape("train_4k"))["tokens"].is_meta
step = steps.make_train_step(lm, repro_torch.configs.TrainConfig(lr=3e-3),
                             repro_torch.configs.ShapeConfig("t", 4, 1,
                                                             "train"))
tok = torch.zeros((1, 4), dtype=torch.int64)
bf = repro_torch.models.model.init_params(lm, torch.Generator(), "cpu",
                                          torch.bfloat16)
assert torch.isfinite(step(bf, {"tokens": tok, "labels": tok})[1]["loss"])
from repro_torch.launch import mesh
from repro_torch.sharding import rules
assert mesh.make_production_mesh(multi_pod=True).axis_sizes() == \
    {"pod": 2, "data": 16, "model": 16}
assert rules.param_shardings(mesh.make_debug_mesh(), steps.abstract_params(
    lm))["embed"] == ("model", "data")
round_step = steps.make_pfedwn_round_step(
    lm, repro_torch.configs.TrainConfig(lr=3e-3),
    repro_torch.configs.ShapeConfig("t", 4, 1, "train"),
    mesh.MeshSpec(("pod",), (1,)), n_clients=1, probe_sequences=1,
    probe_tokens=4)
assert torch.isfinite(round_step(bf, {"tokens": tok, "labels": tok},
                                 torch.ones((1, 1)),
                                 torch.ones((1, 1), dtype=torch.bool))[2]
                      ["loss"])
one = FederatedSimulation(*args[:-1], FedSimConfig(
    rounds=2, batch_size=16, em_iters=2, em_subset=32, sharded=True),
    device="cpu")
assert one.run("pfedwn")["pi"][-1].shape == (2,)
assert one.last_run_stats["engine"] == "sharded"
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
       or m.startswith("repro.")]
print("LOADED", bad)

raised = []
if not torch.cuda.is_available():
    for call in (lambda: FederatedSimulation(*args),
                 lambda: selection.select_neighbors(
                     WirelessConfig(), [1.0, 1.0], [[2.0, 2.0]]),
                 lambda: cnn.init_params(args[0], torch.Generator()),
                 lambda: train.single_client(lm, steps=1, batch=1, seq=4),
                 lambda: train.federated(lm, clients=2, rounds=1,
                                         local_steps=1, batch=1, seq=4),
                 lambda: train.main(["--arch", "smollm-135m"])):
        try:
            call()
        except RuntimeError:
            raised.append(True)
        else:
            raised.append(False)
print("RAISED", raised)
"""


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.abspath(SRC),
                                           os.path.abspath(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.splitlines()
                 if l.startswith(("LOADED", "RAISED")))
    assert lines["LOADED"] == "[]"
    if not torch.cuda.is_available():
        assert lines["RAISED"] == str([True] * 6)
