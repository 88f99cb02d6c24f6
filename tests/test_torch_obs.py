"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``): the counterparts of ``tests/test_obs.py`` (byte-identical
JSONL, the registry's instruments, the validator, the Chrome trace, fused
and legacy RunRecords, ``taps=False``, the record files and the report
CLI), the same ``_drive`` through both packages, each package reading the
other's files, the port's RunRecord against the reference's on replayed
draws, and the compile events' FLOP counts against
``torch.utils.flop_counter``. Sizes are ``tests/test_obs.py``'s
``_tiny_setup``."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import obs as ref_obs
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro.data import (dirichlet_partition, make_client_datasets,
                        synthetic_image_dataset, train_test_split)
from repro.obs import report as ref_report
from repro.obs.trace import Tracer as RefTracer
from repro_torch import data as tdata
from repro_torch import obs
from repro_torch.configs import CNNConfig
from repro_torch.core import aggregation, pfedwn
from repro_torch.core.fedsim import METHODS, FederatedSimulation, FedSimConfig
from repro_torch.obs import report as obs_report
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.record import encode_event
from repro_torch.obs.trace import Tracer
from repro_torch.utils.bridge import from_jax_params
from test_torch_fedsim import _replayed_draws

torch.set_num_threads(1)

CFG_KW = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# --------------------------------------------------------------- fixtures

def _data(synth, part, make, split, n_clients, seed=0):
    base = synth(seed, 400, image_size=8, n_classes=4)
    parts = part(base.y, n_clients, alpha=0.3, seed=seed)
    return (make(base, [split(p, seed=1)[0] for p in parts]),
            make(base, [split(p, seed=1)[1] for p in parts]))


def _masks(n_clients):
    pm = np.array([True] * (n_clients - 1) + [False])
    return pm, np.linspace(0.0, 0.2, n_clients).astype(np.float32)


def _kw(**kw):
    base = dict(rounds=3, batch_size=16, lr=0.05, em_iters=2, em_subset=64,
                adapt_subset=32, eval_every=2, seed=0)
    base.update(kw)
    return base


def _port_sim(n_clients=4, params0=None, recorder=None, **kw):
    train, test = _data(tdata.synthetic_image_dataset,
                        tdata.dirichlet_partition,
                        tdata.make_client_datasets, tdata.train_test_split,
                        n_clients)
    return FederatedSimulation(CNNConfig(**CFG_KW), train, test,
                               *_masks(n_clients), FedSimConfig(**_kw(**kw)),
                               params0=params0, device="cpu",
                               recorder=recorder)


def _ref_sim(n_clients=4, **kw):
    train, test = _data(synthetic_image_dataset, dirichlet_partition,
                        make_client_datasets, train_test_split, n_clients)
    return RefSimulation(RefCNNConfig(**CFG_KW), train, test,
                         *_masks(n_clients), RefFedSimConfig(**_kw(**kw)))


@pytest.fixture(scope="module")
def recorded_pair():
    """(fused, legacy) port sims, pfedwn already run on both."""
    fused = _port_sim(fused=True)
    legacy = _port_sim(fused=False, params0=fused.params0)
    fused.run("pfedwn")
    legacy.run("pfedwn")
    return fused, legacy


# ---------------------------------------------------------- metrics core

def _drive(rec) -> None:
    """``tests/test_obs.py::_drive``: one run's worth of updates."""
    rec.begin_run(method="pfedwn", engine="fused",
                  meta={"n_clients": 4, "rounds": 3})
    rec.record_compile("pfedwn/block1",
                       cost={"flops": 1e6, "bytes accessed": 2e5},
                       seconds=1.5)
    for rnd in range(3):
        rec.record_round(rnd, train_loss=[1.5 - 0.1 * rnd, 1.2, 0.9, 1.1],
                         em_entropy=1.0 - 0.2 * rnd,
                         link_success_rate=2.0 / 3.0,
                         effective_neighbors=1.8)
        rec.observe_round_latency(12.5)
    rec.record_eval(2, target_acc=0.75, mean_participant_acc=0.6,
                    pi=[0.5, 0.3, 0.2])
    rec.end_run(method="pfedwn", engine="fused", rounds=3,
                max_target_acc=0.75, final_target_acc=0.75)


def test_metrics_core_byte_identical_jsonl():
    out = []
    for _ in range(2):
        rec = obs.RunRecorder(clock=lambda: 1234.5)
        _drive(rec)
        out.append(rec.memory.to_jsonl())
    assert out[0].encode() == out[1].encode()
    assert obs.validate_jsonl_lines(out[0].splitlines()) == []


def test_drive_byte_identical_across_packages():
    """The same updates and clocks give the same JSONL bytes and the same
    Chrome trace from either package."""
    def run(pkg, tracer_cls):
        ticks = iter(range(1000))
        tracer = tracer_cls(clock=lambda: next(ticks) * 1e-3)
        rec = pkg.RunRecorder(clock=lambda: 1234.5, tracer=tracer)
        with rec.span("stage_data", n_clients=4):
            pass
        _drive(rec)
        return rec.memory.to_jsonl(), rec.tracer.chrome_trace()

    port_jsonl, port_trace = run(obs, Tracer)
    ref_jsonl, ref_trace = run(ref_obs, RefTracer)
    assert port_jsonl.encode() == ref_jsonl.encode()
    assert port_trace == ref_trace
    assert json.dumps(port_trace, sort_keys=True) == json.dumps(
        ref_trace, sort_keys=True)


def test_encode_event_takes_numpy_and_host_tensors():
    """A 0-d tensor has ``__len__``, so it goes to ``tolist()``, which
    still gives a Python scalar; arrays and tensors become lists."""
    ev = {"a": torch.tensor(0.5), "b": torch.tensor([1.0, 2.0]),
          "c": np.float32(0.25), "d": np.arange(2), "e": torch.tensor(3)}
    line = encode_event(ev)
    assert line == ('{"a":0.5,"b":[1.0,2.0],"c":0.25,"d":[0,1],"e":3}')
    assert line == ref_obs.encode_event(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in ev.items()})


def test_metrics_registry_instruments():
    m = MetricsRegistry()
    m.counter("c").inc()
    m.counter("c").inc(2)
    m.gauge("g").set(0.5)
    m.timeseries("t").append(0, 1.0)
    m.timeseries("t").append(2, 3.0)
    h = m.histogram("h")
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        h.observe(v)
    snap = m.snapshot()
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == 0.5
    assert snap["timeseries"]["t"] == {"steps": [0, 2], "values": [1.0, 3.0]}
    assert snap["histograms"]["h"]["count"] == 5
    assert snap["histograms"]["h"]["p50"] == 3.0
    assert snap["histograms"]["h"]["p99"] == 100.0
    ref = ref_obs.MetricsRegistry()
    ref.counter("c").inc(3)
    ref.gauge("g").set(0.5)
    ref.timeseries("t").append(0, 1.0)
    ref.timeseries("t").append(2, 3.0)
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        ref.histogram("h").observe(v)
    assert snap == ref.snapshot()
    m.reset()
    assert m.snapshot()["counters"] == {}
    with pytest.raises(ValueError):
        m.counter("c").inc(-1)


def test_histogram_weighted_observe_and_empty():
    h = Histogram()
    assert h.snapshot() == {"count": 0}
    assert np.isnan(h.percentile(50))
    h.observe(10.0, n=4)
    snap = h.snapshot()
    assert snap["count"] == 4 and snap["p90"] == 10.0
    h.observe(2.0)
    assert h.snapshot()["min"] == 2.0 and h.percentile(0) == 2.0


def test_validate_event_catches_violations():
    assert obs.validate_event({"type": "nope"}) != []
    assert obs.validate_event([1]) == ["event is not an object"]
    assert any("missing key" in e
               for e in obs.validate_event({"type": "round"}))
    bad_engine = {"type": "meta", "schema": obs.SCHEMA_VERSION,
                  "run_id": "x", "method": "local", "engine": "warp",
                  "time_unix": 0.0, "meta": {}}
    assert any("engine" in e for e in obs.validate_event(bad_engine))
    bad_pi = {"type": "eval", "run_id": "x", "round": 0, "target_acc": 0.5,
              "mean_participant_acc": 0.5, "pi": ["a"]}
    assert any("pi" in e for e in obs.validate_event(bad_pi))
    assert obs.validate_jsonl_lines(["not json"]) != []
    for ev in (bad_engine, bad_pi, {"type": "round"}):
        assert obs.validate_event(ev) == ref_obs.validate_event(ev)


# ---------------------------------------------------------- span tracing

def test_chrome_trace_schema(tmp_path):
    fake = iter(range(100))
    tracer = Tracer(clock=lambda: next(fake) * 1e-3)
    with tracer.span("outer", method="pfedwn") as sp:
        sp.set(rounds=3)
        with tracer.span("inner", cat="compile"):
            pass
    tracer.instant("mark")
    info = tracer.add_compile_event(
        "blk", cost={"flops": 5.0, "bytes accessed": 7.0}, seconds=0.25)
    assert info == {"flops": 5.0, "bytes_accessed": 7.0}
    assert tracer.add_compile_event(
        "blk2", cost={"bytes_accessed": 3.0})["bytes_accessed"] == 3.0
    path = tmp_path / "t.trace.json"
    tracer.export(str(path))
    doc = json.loads(path.read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in ("X", "i")
        assert isinstance(ev["ts"], (int, float))
        assert "pid" in ev and "tid" in ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    names = [e["name"] for e in doc["traceEvents"]]
    assert "outer" in names and "compile:blk" in names
    outer = next(e for e in doc["traceEvents"] if e["name"] == "outer")
    assert outer["args"]["rounds"] == 3
    assert sp.duration_s is not None and sp.duration_s > 0


def test_ambient_span_and_decorator():
    tracer = Tracer()
    with obs.use_tracer(tracer):
        with obs.span("phase-a"):
            pass

        @obs.traced("phase-b")
        def work():
            return 42

        assert work() == 42
    names = [e["name"] for e in tracer.events]
    assert names == ["phase-a", "phase-b"]
    assert obs.get_tracer() is not tracer          # ambient restored

    @tracer.traced()
    def named():
        return 1

    named()
    assert tracer.events[-1]["name"].endswith("named")


# ----------------------------------------------- engine record integration

def test_fused_legacy_record_schema_parity(recorded_pair):
    """Both engines emit the same event sequence with the same keys, and
    the tap scalars agree (same draws)."""
    fused, legacy = recorded_pair
    ef = fused.recorder.events
    el = legacy.recorder.events
    assert [e["type"] for e in ef if e["type"] != "compile"] == \
        [e["type"] for e in el if e["type"] != "compile"]
    by_type_f = {e["type"]: e for e in ef}
    by_type_l = {e["type"]: e for e in el}
    for etype in ("meta", "round", "eval", "summary"):
        assert set(by_type_f[etype]) == set(by_type_l[etype]), etype
    rf = [e for e in ef if e["type"] == "round"]
    rl = [e for e in el if e["type"] == "round"]
    assert len(rf) == len(rl) == 3
    for a, b in zip(rf, rl):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   atol=5e-3)
        np.testing.assert_allclose(a["em_entropy"], b["em_entropy"],
                                   atol=1e-3)
        assert a["link_success_rate"] == pytest.approx(
            b["link_success_rate"])
        np.testing.assert_allclose(a["effective_neighbors"],
                                   b["effective_neighbors"], atol=1e-3)
    for events in (ef, el):
        lines = [obs.encode_event(e) for e in events]
        assert obs.validate_jsonl_lines(lines) == []
    assert [e["name"] for e in ef if e["type"] == "compile"] == \
        ["pfedwn/block1", "pfedwn/block2"]
    assert not any(e["type"] == "compile" for e in el)


def test_fused_round_events_deterministic(recorded_pair):
    """Same seed => byte-identical round/eval events from a fresh sim (the
    tap path carries no wall-clock)."""
    fused, _ = recorded_pair
    again = _port_sim(fused=True)
    again.run("pfedwn")

    def tap_lines(sim):
        return [obs.encode_event(e) for e in sim.recorder.events
                if e["type"] in ("round", "eval")]

    assert tap_lines(fused) == tap_lines(again)


def _counting(monkeypatch):
    """Count the calls of K1's and K2's wrappers (on a card, each call is
    one launch)."""
    calls = {"k1": 0, "k2": 0}

    def wrap(module, name, key):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    wrap(pfedwn, "em_posterior", "k1")
    wrap(aggregation, "weighted_agg", "k2")
    return calls


def test_instrumented_block_keeps_syncs_and_launches(monkeypatch):
    """Recording changes neither the host syncs (one per block) nor the
    kernel calls: K1 ``em_iters`` times a round and K2 once, taps on or
    off, and the same params either way."""
    calls = _counting(monkeypatch)
    out = {}
    for taps in (True, False):
        sim = _port_sim(fused=True, taps=taps)
        calls.update(k1=0, k2=0)
        sim.run("pfedwn")
        blocks = sim.last_run_stats["blocks"]
        assert sim.last_run_stats["device_calls"] == len(blocks) == 2
        out[taps] = (dict(calls), sim.last_state["params"])
    assert out[True][0] == out[False][0] == {"k1": 3 * 2, "k2": 3}
    torch.testing.assert_close(out[True][1], out[False][1], atol=0, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_taps_off_drops_round_events(fused):
    sim = _port_sim(n_clients=3, fused=fused, taps=False, rounds=2,
                    eval_every=1)
    h = sim.run("local")
    types = [e["type"] for e in sim.recorder.events]
    assert "round" not in types
    assert "eval" in types and "summary" in types
    assert h["taps"] == {}
    meta = next(e for e in sim.recorder.events if e["type"] == "meta")
    assert meta["meta"]["taps"] is False
    on = _port_sim(n_clients=3, fused=fused, rounds=2, eval_every=1,
                   params0=sim.params0)
    on.run("local")
    assert on.last_run_stats == sim.last_run_stats


def test_run_record_files_and_report_cli(tmp_path, capsys):
    sim = _port_sim(n_clients=3, fused=True, rounds=2, eval_every=1,
                    record_dir=str(tmp_path), run_name="rec")
    sim.run("local")
    jsonl = tmp_path / "rec.jsonl"
    trace = tmp_path / "rec.trace.json"
    assert jsonl.exists() and trace.exists()
    assert obs.validate_jsonl_lines(jsonl.read_text().splitlines()) == []
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"stage_data", "compile", "block_exec", "drain",
            "compile:local/block1"} <= names
    assert obs_report.main([str(jsonl)]) == 0
    out = capsys.readouterr().out
    assert "local" in out and "fused" in out
    assert obs_report.main([str(jsonl), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["runs"]
    assert rows[0]["tap_rounds"] == 2 and rows[0]["compiles"] == 1


def test_default_record_names(tmp_path):
    sim = _port_sim(n_clients=3, fused=False, rounds=1,
                    record_dir=str(tmp_path))
    sim.run("local")
    assert sorted(os.listdir(tmp_path)) == [
        "fedsim_legacy_N3_seed0.jsonl", "fedsim_legacy_N3_seed0.trace.json"]


def test_report_cli_rejects_schema_violations(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type":"round","run_id":"x"}\n')
    assert obs_report.main([str(bad)]) == 2
    assert "SCHEMA VIOLATIONS" in capsys.readouterr().err
    assert obs_report.main([str(tmp_path / "missing.jsonl")]) == 1


def _report_cli(module, path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_report_cli_module_entry(tmp_path):
    sim = _port_sim(n_clients=3, fused=True, rounds=2, eval_every=1,
                    record_dir=str(tmp_path), run_name="cli")
    sim.run("local")
    out = _report_cli("repro_torch.obs.report", tmp_path / "cli.jsonl")
    assert out.returncode == 0, out.stderr
    assert "RunRecord" in out.stdout and "local" in out.stdout
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type":"meta"}\n')
    assert _report_cli("repro_torch.obs.report", bad).returncode == 2


# ---------------------------------------------- against the reference

def test_each_package_reads_the_others_files(tmp_path, capsys):
    port = _port_sim(fused=True, record_dir=str(tmp_path), run_name="port")
    port.run("pfedwn")
    port.run("local")
    ref = _ref_sim(fused=True, record_dir=str(tmp_path), run_name="ref")
    ref.run("local")
    port_lines = (tmp_path / "port.jsonl").read_text().splitlines()
    ref_lines = (tmp_path / "ref.jsonl").read_text().splitlines()
    assert ref_obs.validate_jsonl_lines(port_lines) == []
    assert obs.validate_jsonl_lines(ref_lines) == []
    assert ref_report.main([str(tmp_path / "port.jsonl")]) == 0
    assert "pfedwn" in capsys.readouterr().out
    assert obs_report.main([str(tmp_path / "ref.jsonl")]) == 0
    assert "local" in capsys.readouterr().out
    for a, b in ((ref_report, obs_report), (obs_report, ref_report)):
        rows_a = [a.summarize_run(r) for r in a.load_runs(port_lines)]
        rows_b = [b.summarize_run(r) for r in b.load_runs(port_lines)]
        assert rows_a == rows_b
        assert a.render_table(rows_a) == b.render_table(rows_b)


def _ref_and_port(method, fused):
    ref = _ref_sim(fused=fused)
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = _port_sim(fused=fused, params0=params0)
    idx, masks = _replayed_draws(ref)
    ref.run(method)
    port.run(method, idx_stream=idx, link_masks=masks)
    return ref.recorder.events, port.recorder.events


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("method", ["pfedwn", "local"])
def test_run_record_matches_reference(method, fused):
    """On replayed draws the port's RunRecord has the reference's event
    types in order (compile events aside) and its round and eval values
    within the reference's tolerances."""
    ref, port = _ref_and_port(method, fused)

    def kept(events):
        return [e for e in events if e["type"] != "compile"]

    ref, port = kept(ref), kept(port)
    assert [e["type"] for e in port] == [e["type"] for e in ref]
    for r, p in zip(ref, port):
        assert set(p) == set(r), r["type"]
        assert p["run_id"] == r["run_id"]
        if r["type"] == "meta":
            assert p["meta"] == r["meta"]
        elif r["type"] == "round":
            assert p["round"] == r["round"]
            np.testing.assert_allclose(p["train_loss"], r["train_loss"],
                                       atol=1e-4)
            for k in ("em_entropy", "effective_neighbors"):
                np.testing.assert_allclose(p[k], r[k], atol=1e-4)
            assert p["link_success_rate"] == r["link_success_rate"]
        elif r["type"] == "eval":
            assert p["round"] == r["round"]
            for k in ("target_acc", "mean_participant_acc"):
                np.testing.assert_allclose(p[k], r[k], atol=5e-3)
            if r["pi"] is None:
                assert p["pi"] is None
            else:
                np.testing.assert_allclose(p["pi"], r["pi"], atol=1e-4)
        elif r["type"] == "summary":
            assert p["extra"] == r["extra"]
            assert p["rounds"] == r["rounds"]
            assert p["metrics"]["counters"] == r["metrics"]["counters"]
            assert p["metrics"]["histograms"]["round_latency_ms"][
                "count"] == r["metrics"]["histograms"]["round_latency_ms"][
                "count"]


# ---------------------------------------------------- the cost function

@pytest.mark.parametrize("method", METHODS)
def test_compile_event_flops_match_flop_counter(method):
    """Each compile event's ``flops`` is the FLOP count
    ``FlopCounterMode`` sees over the same block on the CPU: one block of
    one round, then blocks of 1 and 2 rounds (whose events sum to the
    run's count)."""
    for kw in (dict(rounds=1), dict(rounds=3, eval_every=2)):
        sim = _port_sim(**kw)
        with FlopCounterMode(display=False) as counter:
            sim.run(method)
        compiles = [e for e in sim.recorder.events if e["type"] == "compile"]
        assert len(compiles) == len(sim.last_run_stats["blocks"])
        got = sum(e["flops"] for e in compiles)
        want = counter.get_total_flops()
        assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)
        for e in compiles:
            assert e["bytes_accessed"] > 0 and e["seconds"] == 0.0
    # a second run of the same blocks records no compile event
    sim.run(method)
    assert sum(e["type"] == "compile" for e in sim.recorder.events) == 2
