"""The port's benchmark plumbing (``benchmarks/torch_common.py``) against
the reference's (``benchmarks/common.py``): the same wireless scenarios and
the same simulations for the Table II/III and ablation scripts; and the
round-loop bench's ``obs_overhead`` and ``obs_smoke`` sections on the
CPU."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import torch_common  # noqa: E402
from benchmarks import torch_fedsim_bench  # noqa: E402

torch.set_num_threads(1)

# (seed, neighbours, γ_th, ε): Table II's three cases, Table III's, and
# the ablations' first scenario
SCENARIOS = [(5, 10, 5.0, 0.1), (10, 10, 10.0, 0.1), (15, 10, 15.0, 0.1),
             (20, 20, 10.0, 0.1), (11, 10, 5.0, 0.15)]


@pytest.mark.parametrize("seed,n,gamma,eps", SCENARIOS)
def test_build_scenario_matches_reference(seed, n, gamma, eps):
    got = torch_common.build_scenario(seed, n, gamma_th=gamma, eps=eps,
                                      device="cpu")
    ref = ref_common.build_scenario(seed, n, gamma_th=gamma, eps=eps)
    np.testing.assert_array_equal(got.target_pos, ref.target_pos)
    np.testing.assert_array_equal(got.neighbor_pos, ref.neighbor_pos)
    np.testing.assert_allclose(got.p_err, ref.p_err, atol=1e-5)
    np.testing.assert_array_equal(got.selected, ref.selected)


@pytest.mark.parametrize("noise", [0.35, 0.8])
def test_build_simulation_matches_reference(noise):
    """Same data, participants, P_err, sizes and settings (a reduced
    sample count keeps the reference's engine set-up quick)."""
    sc = ref_common.build_scenario(10, 10, gamma_th=10.0, eps=0.1)
    kw = dict(rounds=3, samples=900, noise=noise)
    ref = ref_common.build_simulation(10, sc, **kw)
    got = torch_common.build_simulation(
        10, torch_common.Scenario(sc.target_pos, sc.neighbor_pos, sc.p_err,
                                  sc.selected), device="cpu", **kw)
    for a, b in zip(got.train_sets + got.test_sets,
                    ref.train_sets + ref.test_sets):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(got.participants.numpy(),
                                  np.asarray(ref.participants))
    np.testing.assert_array_equal(got._p_err_nbr.numpy(),
                                  np.asarray(ref.p_err)[got.neighbor_idx])
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(ref.sizes))
    assert got.steps_per_round == ref.steps_per_round
    assert got.model_cfg.widths == ref.model_cfg.widths
    for field in ("rounds", "batch_size", "lr", "alpha", "em_iters",
                  "seed"):
        assert getattr(got.sim, field) == getattr(ref.sim, field), field


def test_timed_times_the_one_call_that_gives_the_result():
    calls = []
    us, out = torch_common.timed(lambda k: calls.append(k) or len(calls), 7)
    assert out == 1 and calls == [7] and us >= 0


class _Clock:
    """Stands in for the bench's ``time``: each timed run of
    ``obs_overhead`` reads ``perf_counter`` twice, taps off then on, so
    the runs take the given ms per round in turn."""

    def __init__(self, off_ms, on_ms, rounds):
        self.durations = [off_ms * rounds / 1e3, on_ms * rounds / 1e3]
        self.now, self.calls = 0.0, 0

    def perf_counter(self):
        if self.calls % 2:
            self.now += self.durations[(self.calls // 2) % 2]
        self.calls += 1
        return self.now


def test_obs_overhead_adds_its_section_and_keeps_the_budget(tmp_path,
                                                            monkeypatch):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps({"results": {"N=8": {}}}))
    monkeypatch.setattr(torch_fedsim_bench, "time", _Clock(10.0, 10.2, 2))
    entry = torch_fedsim_bench.obs_overhead("cpu", path=path, rounds=2)
    on_disk = json.loads(path.read_text())
    assert on_disk["results"] == {"N=8": {}}
    assert on_disk["obs_overhead"] == entry
    repeats = entry["repeats"]
    assert repeats >= 3
    assert entry["taps_off_ms_per_round"] == pytest.approx([10.0] * repeats)
    assert entry["taps_on_ms_per_round"] == pytest.approx([10.2] * repeats)
    assert entry["overhead_pct"] == pytest.approx((1 - 10.0 / 10.2) * 100)
    monkeypatch.setattr(torch_fedsim_bench, "time", _Clock(10.0, 11.0, 2))
    with pytest.raises(AssertionError, match="5% budget"):
        torch_fedsim_bench.obs_overhead("cpu", path=path, rounds=2)
    assert json.loads(path.read_text())["obs_overhead"][
        "overhead_pct"] == pytest.approx((1 - 10.0 / 11.0) * 100)


def test_obs_overhead_needs_the_base_sweep(tmp_path):
    with pytest.raises(RuntimeError, match="missing"):
        torch_fedsim_bench.obs_overhead("cpu", path=tmp_path / "none.json")


def test_obs_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OBS_SMOKE_DIR", str(tmp_path))
    torch_fedsim_bench.obs_smoke("cpu")
    assert sorted(os.listdir(tmp_path)) == ["obs_smoke.jsonl",
                                            "obs_smoke.trace.json"]
    out = capsys.readouterr().out
    assert "torch_obs_smoke" in out
    assert "rounds=3;compile_s=0.000000;ok" in out


def test_sharded_smoke_on_cpu(capsys):
    torch_fedsim_bench.sharded_smoke("cpu")
    out = capsys.readouterr().out
    assert "torch_fedsim_sharded_smoke" in out
    assert "devices=4;methods=6;" in out and out.rstrip().endswith("ok")


def test_sharded_bench_adds_its_section(tmp_path):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps({"results": {"N=8": {}}, "other": 1}))
    entry = torch_fedsim_bench.sharded_bench("cpu", path=path, n=4,
                                             rounds=2, devices=(1, 2))
    on_disk = json.loads(path.read_text())
    assert on_disk["results"] == {"N=8": {}} and on_disk["other"] == 1
    assert on_disk["sharded"] == entry
    assert sorted(entry["results"]) == ["devices=1", "devices=2"]
    for row in entry["results"].values():
        assert row["backend"] == "gloo"
        for m in ("fedavg", "pfedwn"):
            ms = row[f"{m}_round_latency_ms"]
            assert ms > 0 and row[f"{m}_rounds_per_sec"] == \
                pytest.approx(1e3 / ms)


def test_hoist_bench_reads_the_stored_row(tmp_path):
    path = tmp_path / "BENCH_torch.json"
    with pytest.raises(RuntimeError, match="missing"):
        torch_fedsim_bench.hoist_bench("cpu", path=path, n=4, rounds=2)
    path.write_text(json.dumps({"results": {"N=4": {"pfedwn": {
        "fused_round_latency_ms": 10.0}}}}))
    entry = torch_fedsim_bench.hoist_bench("cpu", path=path, n=4, rounds=2)
    assert json.loads(path.read_text())["pfedwn_hoist"] == entry
    assert entry["before_round_latency_ms"] == 10.0
    assert entry["before_over_after"] == pytest.approx(
        10.0 / entry["after_round_latency_ms"])
