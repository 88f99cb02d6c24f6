"""The port's client-sharded engine on its own terms: against the port's
fused engine on the port's own draws (D = 2, gloo on the CPU), D = 1 in
process, the client group's errors, its RunRecords (rank 0 writes them,
both packages' validators reject the ``sharded`` engine name alike), the
per-rank compile-event FLOPs, the round-block lint
(``python -m repro_torch.lint.blocks``) and ``pod_mix``; the counterparts
of ``tests/test_fedsim_sharded.py`` and ``tests/test_system.py``'s
``pod_mix`` tests."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.obs import validate_jsonl_lines as ref_validate
from repro_torch import data as tdata
from repro_torch.configs import CNNConfig
from repro_torch.core.fedsim import METHODS, FederatedSimulation, FedSimConfig
from repro_torch.lint import blocks
from repro_torch.obs import validate_jsonl_lines
from repro_torch.sharding import (client_group, client_slab, join_slabs,
                                  spawn, take_slab)
from repro_torch.sharding.worker import run_methods, run_pod_mix

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "lint_blocks")
KW = dict(rounds=3, batch_size=16, lr=0.05, em_iters=2, em_subset=64,
          adapt_subset=32, eval_every=2, seed=0)


def _sim_kw(n_clients=4):
    """``tests/test_fedsim_sharded.py::_tiny_setup`` through the port's
    data functions: the last client does not take part."""
    base = tdata.synthetic_image_dataset(0, 600, image_size=8, n_classes=4)
    parts = tdata.dirichlet_partition(base.y, n_clients, alpha=0.3, seed=0)
    train = tdata.make_client_datasets(
        base, [tdata.train_test_split(p, seed=1)[0] for p in parts])
    test = tdata.make_client_datasets(
        base, [tdata.train_test_split(p, seed=1)[1] for p in parts])
    pm = np.array([True] * (n_clients - 1) + [False])
    p_err = np.linspace(0.0, 0.2, n_clients).astype(np.float32)
    return dict(model_cfg=CNNConfig(image_size=8, widths=(4,), hidden=16,
                                    n_classes=4),
                train_sets=train, test_sets=test, participant_mask=pm,
                p_err=p_err, device="cpu")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Every method on the port's fused engine in process, and on the
    sharded engine at D = 2 with its RunRecord persisted and its FLOPs
    counted, from the same params and seed (so the same draws)."""
    record_dir = str(tmp_path_factory.mktemp("sharded_record"))
    kw = _sim_kw()
    fused = FederatedSimulation(sim=FedSimConfig(**KW), **kw)
    hist = {m: fused.run(m) for m in METHODS}
    params = {}
    for m in METHODS:
        fused.run(m)
        params[m] = fused.last_state["params"].clone()
    sharded_kw = dict(kw, params0=fused.params0, sim=FedSimConfig(
        sharded=True, shard_devices=2, record_dir=record_dir, **KW))
    ranks = spawn(run_methods, 2, "gloo", "cpu", FederatedSimulation,
                  sharded_kw, list(METHODS), None, 1, False, True)
    return fused, hist, params, ranks, record_dir


def test_sharded_matches_port_fused(pair):
    """The port's own draws: every rank draws the full stream from the same
    generator and takes its slab, so sharded follows fused."""
    _, hist, params, ranks, _ = pair
    for i, method in enumerate(METHODS):
        hf, hs = hist[method], ranks[0][i]["history"]
        np.testing.assert_allclose(hs["target_acc"], hf["target_acc"],
                                   atol=5e-3, err_msg=method)
        np.testing.assert_allclose(hs["mean_participant_acc"],
                                   hf["mean_participant_acc"], atol=5e-3,
                                   err_msg=method)
        if method == "pfedwn":
            np.testing.assert_allclose(np.stack(hs["pi"]),
                                       np.stack(hf["pi"]), atol=1e-4)
        got = join_slabs([r[i]["params"] for r in ranks])
        np.testing.assert_allclose(got.numpy(), params[method].numpy(),
                                   atol=1e-4, err_msg=method)
        np.testing.assert_allclose(hs["taps"]["train_loss"],
                                   hf["taps"]["train_loss"], atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_collectives_a_round_and_a_block(pair, method):
    """Model-sized collectives a round (local 0, fedavg 1, fedprox 2,
    perfedavg 1, fedamp 1, pfedwn 1), one small exchange a block, each one
    collective on the wire, on every rank."""
    _, _, _, ranks, _ = pair
    i = METHODS.index(method)
    for r in ranks:
        calls = r[i]["calls"]
        model = calls["client_weighted_mean"] + calls["gather_clients"]
        assert model == blocks.PER_ROUND[method] * KW["rounds"]
        assert calls["exchange_block"] == 2 == r[i]["stats"]["device_calls"]
        assert r[i]["collectives"] == model + calls["exchange_block"]


def test_sharded_record_written_by_rank_zero(pair):
    """One JSONL and one trace, from rank 0; both packages' validators
    reject its meta and summary events with the same message (the
    reference's ``_ENGINES`` lacks ``sharded``, and the port mirrors it)."""
    _, _, _, _, record_dir = pair
    assert sorted(os.listdir(record_dir)) == [
        "fedsim_sharded_N4_seed0.jsonl", "fedsim_sharded_N4_seed0.trace.json"]
    with open(os.path.join(record_dir,
                           "fedsim_sharded_N4_seed0.jsonl")) as f:
        lines = f.readlines()
    errors = validate_jsonl_lines(lines)
    assert errors == ref_validate(lines)
    kinds = [json.loads(ln)["type"] for ln in lines]
    assert len(errors) == kinds.count("meta") + kinds.count("summary") == 12
    assert all("engine 'sharded' not in ('fused', 'legacy')" in e
               for e in errors)


def test_sharded_record_events_match_fused(pair):
    """In memory, on every rank: the round and eval events of each run match
    the fused engine's within the parity tolerances."""
    fused, _, _, ranks, _ = pair

    def kept(events):
        return [e for e in events if e["type"] in ("round", "eval")]

    fused_runs = {}
    for e in fused.recorder.events:
        if e["type"] in ("round", "eval"):
            fused_runs.setdefault(e["run_id"].split("/")[0], []).append(e)
    for r in ranks:
        for i, method in enumerate(METHODS):
            mine = kept(r[i]["events"])
            # the fused engine ran each method twice; its first run's events
            ref = fused_runs[method][:len(mine)]
            assert [e["type"] for e in mine] == [e["type"] for e in ref]
            for a, b in zip(mine, ref):
                assert a["round"] == b["round"]
                if a["type"] == "round":
                    np.testing.assert_allclose(a["train_loss"],
                                               b["train_loss"], atol=1e-4)
                    for k in ("em_entropy", "effective_neighbors"):
                        np.testing.assert_allclose(a[k], b[k], atol=1e-4)
                    assert a["link_success_rate"] == b["link_success_rate"]
                else:
                    for k in ("target_acc", "mean_participant_acc"):
                        np.testing.assert_allclose(a[k], b[k], atol=5e-3)


def test_compile_event_flops_per_rank(pair):
    """Each rank's compile events' FLOPs (its slab's SGD and eval, the
    replicated target math) sum to what ``FlopCounterMode`` counted over
    that rank's run of the blocks."""
    _, _, _, ranks, _ = pair
    for r in ranks:
        for res in r:
            got = sum(e["flops"] for e in res["events"]
                      if e["type"] == "compile")
            want = res["flops"]
            assert want > 0 and abs(got - want) <= 0.01 * want, (
                res["method"], got, want)
    # rank 0 adapts Per-FedAvg's target before scoring it; rank 1 does not
    i = METHODS.index("perfedavg")
    assert ranks[0][i]["flops"] > ranks[1][i]["flops"]


def test_sharded_single_rank_in_process():
    """D = 1 with no process group started runs in process, every
    collective over the one rank: it is the fused engine (the counterpart
    of ``test_sharded_single_device_matches_fused``)."""
    kw = _sim_kw()
    fused = FederatedSimulation(sim=FedSimConfig(**KW), **kw)
    sharded = FederatedSimulation(
        sim=FedSimConfig(sharded=True, shard_devices=1, **KW),
        params0=fused.params0, **kw)
    assert sharded.engine == "sharded" and fused.engine == "fused"
    for method in ("pfedwn", "fedprox"):
        hf, hs = fused.run(method), sharded.run(method)
        np.testing.assert_allclose(hs["target_acc"], hf["target_acc"],
                                   atol=5e-3)
        if method == "pfedwn":
            np.testing.assert_allclose(np.stack(hs["pi"]),
                                       np.stack(hf["pi"]), atol=1e-4)
        np.testing.assert_allclose(sharded.last_state["params"].numpy(),
                                   fused.last_state["params"].numpy(),
                                   atol=1e-4)
        assert sharded.last_run_stats["engine"] == "sharded"
        assert sharded.last_run_stats["device_calls"] == 2   # blocks [1, 2]
    # a sharded rank stages only its slab and the target's own train row
    assert sharded._train_x.shape[0] == 4 and sharded._train_x0.ndim == 4


def test_client_group_errors():
    """The counterpart of ``test_sharded_mesh_validation_errors``, and the
    error for D > 1 with no process group started."""
    sim = FederatedSimulation(
        sim=FedSimConfig(sharded=True, shard_devices=2, **KW),
        **_sim_kw(n_clients=3))
    with pytest.raises(ValueError, match="divisible"):
        sim._client_group_info()
    sim = FederatedSimulation(
        sim=FedSimConfig(sharded=True, shard_devices=2, **KW), **_sim_kw())
    with pytest.raises(RuntimeError, match="init_process_group"):
        sim.run("pfedwn")
    assert not dist.is_initialized()
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="devices"):
            client_group(4, 2)
        g = client_group(4, None)
        assert (g.d, g.s, g.rank) == (1, 4, 0)
    finally:
        dist.destroy_process_group()


def test_client_slabs():
    assert [client_slab(8, 4, r) for r in range(4)] == [
        (0, 2), (2, 2), (4, 2), (6, 2)]
    with pytest.raises(ValueError, match="divisible"):
        client_slab(6, 4, 0)
    x = torch.arange(24.0).reshape(2, 4, 3)           # (rounds, N, ...)
    parts = [take_slab(x, *client_slab(4, 2, r), client_axis=1)
             for r in range(2)]
    assert parts[1].shape == (2, 2, 3)
    assert torch.equal(join_slabs(parts, client_axis=1), x)
    stack = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(take_slab(stack, 2, 2), stack[2:])


def _lint(*args, extra_path=""):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (os.path.abspath(SRC), extra_path) if p))
    return subprocess.run([sys.executable, "-m", "repro_torch.lint.blocks",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_lint_blocks_holds_on_both_engines():
    out = _lint("--engine", "both", "--devices", "2", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("ok   ") for ln in lines) == 12
    assert "ok   sharded/fedprox: collectives a round 2, exchanges 2 in 2 " \
        "blocks, in loops 0" in out.stdout
    assert lines[-1] == "all round-block invariants hold"


def test_lint_blocks_catches_a_collective_in_the_sgd_loop():
    out = _lint("--engine", "both", "--devices", "2", "--device", "cpu",
                "--methods", "local,pfedwn", "--sim", "broken_engine:build",
                extra_path=os.path.abspath(FIXTURES))
    assert out.returncode == 1, out.stdout + out.stderr[-3000:]
    for tag in ("fused/local", "fused/pfedwn", "sharded/local",
                "sharded/pfedwn"):
        assert f"FAIL {tag}: " in out.stdout
    assert "inside the SGD loop" in out.stdout
    assert "rank 1: " in out.stdout


@pytest.mark.parametrize("argv", [["--bogus"], ["--devices", "3"],
                                  ["--methods", "scaffold"],
                                  ["--engine", "mesh"]])
def test_lint_blocks_usage_errors(argv):
    assert blocks.main(argv + ["--device", "cpu"]) == 2


def test_lint_float64_probe_sees_a_float64_op():
    with blocks._Float64Probe() as probe:
        torch.ones(2, dtype=torch.float32) * 2
    assert probe.ops == []
    with blocks._Float64Probe() as probe:
        torch.ones(2, dtype=torch.float32).double()
    assert probe.ops


def test_pod_mix_matches_reference_cases():
    """``tests/test_system.py``'s two ``pod_mix`` cases at C = 2 (each rank
    one client), a tree of two leaves (one all-gather for both), and a row
    whose one surviving link carries zero weight: the rank keeps its model,
    where ``mix_params_with_erasures``' ``any(link_ok)`` would have blended
    it."""
    w = np.arange(8, dtype=np.float32).reshape(2, 4)
    b = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    cases = [
        ({"w": w}, np.array([[0.0, 1.0], [1.0, 0.0]], np.float32), 0.5,
         np.ones((2, 2), bool)),
        ({"w": w}, np.full((2, 2), 0.5, np.float32), 0.3,
         np.zeros((2, 2), bool)),
        ({"w": w, "b": b}, np.array([[0.9, 0.0], [0.2, 0.7]], np.float32),
         0.25, np.array([[True, True], [True, True]])),
        ({"w": w}, np.array([[0.5, 0.0], [0.3, 0.7]], np.float32), 0.4,
         None),
    ]
    ranks = spawn(run_pod_mix, 2, "gloo", "cpu", cases, "cpu")
    out = [[r[i]["mixed"] for r in ranks] for i in range(len(cases))]
    for i, r in enumerate(ranks[0] + ranks[1]):
        assert r["collectives"] == 1 and r["k2"] == 0, i     # the CPU: plain
    # case 1: each mixes fully with the other
    np.testing.assert_allclose(out[0][0]["w"], 0.5 * w[:1] + 0.5 * w[1:],
                               rtol=1e-6)
    np.testing.assert_allclose(out[0][1]["w"], 0.5 * w[1:] + 0.5 * w[:1],
                               rtol=1e-6)
    # case 2: every link erased, each keeps its own
    for rank in range(2):
        np.testing.assert_allclose(out[1][rank]["w"], w[rank:rank + 1],
                                   rtol=1e-6)
    # case 3: rank 0's one link has weight 0, so it keeps its own model;
    # rank 1 mixes with rank 0 (its weight 0.2, renormalised to 1)
    for k, v in (("w", w), ("b", b)):
        np.testing.assert_allclose(out[2][0][k], v[:1], rtol=1e-6)
        np.testing.assert_allclose(out[2][1][k], 0.25 * v[1:] + 0.75 * v[:1],
                                   rtol=1e-6, atol=1e-6)
    # case 4: no link mask; rank 0's row is all zero off the diagonal
    np.testing.assert_allclose(out[3][0]["w"], w[:1], rtol=1e-6)
    np.testing.assert_allclose(out[3][1]["w"], 0.4 * w[1:] + 0.6 * w[:1],
                               rtol=1e-6)
