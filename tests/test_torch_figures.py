"""The port's figure scripts (``benchmarks/torch_fig*.py``) and round-loop
bench (``benchmarks/torch_fedsim_bench.py``) against the reference's:
neighbour selection on injected positions, the trend checks of Figs 5 and
6, Fig 8's overlap ranking, and the bench's merge-write."""
import json
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from benchmarks import fig5_neighbors as ref_fig5  # noqa: E402
from benchmarks import fig6_selection as ref_fig6  # noqa: E402
from benchmarks import torch_fedsim_bench  # noqa: E402
from benchmarks import torch_fig5_neighbors as fig5  # noqa: E402
from benchmarks import torch_fig6_selection as fig6  # noqa: E402
from benchmarks import torch_fig8_em_weights as fig8  # noqa: E402
from repro.configs import WirelessConfig as RefWirelessConfig  # noqa: E402
from repro.core import selection as ref_selection  # noqa: E402
from repro_torch.configs import CNNConfig, WirelessConfig  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.fedsim import (FederatedSimulation,  # noqa: E402
                                     FedSimConfig)
from test_torch_fedsim import SIM_KW, _tiny_setup  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n_valid,gamma_th,F", [
    (0, 40, 5.0, 14), (1, 25, 10.0, 8), (2, 7, 15.0, 20), (3, 1, 5.0, 14)])
def test_select_neighbors_with_valid_matches_reference(seed, n_valid,
                                                       gamma_th, F):
    """Fig 5's selection: 40 node slots of which the first ``n_valid`` are
    placed, positions injected on both sides; an invalid slot interferes
    with nothing and is never selected."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 50, (40, 2)).astype(np.float32)
    valid = np.arange(40) < n_valid
    target = np.array([25.0, 25.0], np.float32)
    got = selection.select_neighbors(
        WirelessConfig(n_subchannels=F), target, pos, valid, eps=0.05,
        sinr_threshold=gamma_th, device="cpu")
    ref = ref_selection.select_neighbors(
        RefWirelessConfig(n_subchannels=F), jnp.asarray(target),
        jnp.asarray(pos), jnp.asarray(valid), eps=0.05,
        sinr_threshold=gamma_th)
    np.testing.assert_allclose(got.p_err.numpy(), np.asarray(ref.p_err),
                               atol=1e-5)
    np.testing.assert_array_equal(got.selected.numpy(),
                                  np.asarray(ref.selected))
    assert not got.selected.numpy()[~valid].any()


def _fig5_results(rng):
    return {(g, F, d): float(rng.integers(0, 12))
            for g in (5.0, 10.0, 15.0) for F in (8, 14, 20)
            for d in (1e-3, 4e-3, 7.5e-3)}


def _fig6_results(rng):
    out = {}
    for G in (5, 10, 15, 20):
        for eps in (0.01, 0.05, 0.1):
            out[("eps", G, eps)] = float(rng.integers(0, G + 1))
        for gth in (5.0, 10.0, 15.0):
            out[("gth", G, gth)] = float(rng.integers(0, G + 1))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fig5_and_fig6_trend_checks_match_reference(seed):
    """Hand-made result tables, some with the trends and some against
    them, scored by the port's and the reference's ``check_trends``."""
    rng = np.random.default_rng(seed)
    r5, r6 = _fig5_results(rng), _fig6_results(rng)
    assert fig5.check_trends(r5) == ref_fig5.check_trends(r5)
    assert fig6.check_trends(r6) == ref_fig6.check_trends(r6)
    up5 = {k: float(k[1] * 10 - k[0]) for k in r5}     # F up, γ_th down
    assert fig5.check_trends(up5) == {"F_monotone_frac": 1.0,
                                      "gamma_monotone_frac": 1.0}
    up6 = {k: (k[2] * 100 if k[0] == "eps" else -k[2]) for k in r6}
    assert fig6.check_trends(up6) == {"eps_monotone": 1.0,
                                      "gth_monotone": 1.0}


def test_fig8_overlap_ranking_on_hand_made_clients():
    """Neighbour 2 has the target's label mix, neighbour 1 none of it: the
    top π on neighbour 2 ranks 0 by overlap, on neighbour 1 last."""
    ys = [np.array([0, 0, 1, 1]), np.array([2, 2, 3, 3]),
          np.array([0, 1, 0, 1]), np.array([0, 2, 0, 2])]
    sim = SimpleNamespace(train_sets=[SimpleNamespace(y=y) for y in ys],
                          neighbor_idx=np.array([1, 2, 3]),
                          model_cfg=SimpleNamespace(n_classes=4))
    pis = [np.array([0.3, 0.4, 0.3]), np.array([0.1, 0.8, 0.1]),
           np.array([0.1, 0.85, 0.05])]
    s = fig8.em_summary(sim, pis)
    assert (s["top_pi_overlap_rank"], s["n_neighbors"]) == (0, 3)
    assert s["top_pi_weight"] == pytest.approx(0.85)
    assert s["early_move"] == pytest.approx(0.8)
    assert s["late_move"] == pytest.approx(0.1)
    s = fig8.em_summary(sim, [np.array([0.9, 0.05, 0.05])])
    assert s["top_pi_overlap_rank"] == 2
    assert s["early_move"] == s["late_move"] == 0.0


def test_fig8_overlap_ranking_on_a_tiny_simulation():
    """Fig 8's summary of a tiny pFedWN run, against the reference
    script's computation (its lines, on the same π and data)."""
    _, (train, test), pm, p_err = _tiny_setup()
    sim = FederatedSimulation(CNNConfig(image_size=8, widths=(4,), hidden=16,
                                        n_classes=4), train, test, pm, p_err,
                              FedSimConfig(**dict(SIM_KW, eval_every=1)),
                              device="cpu")
    h = sim.run("pfedwn")
    got = fig8.em_summary(sim, h["pi"])
    # benchmarks/fig8_em_weights.py::run, after its sim.run
    pis = np.stack(h["pi"])
    participants = np.where(sim.participants.numpy())[0]
    neighbor_ids = participants[participants != 0]
    t_hist = np.bincount(sim.train_sets[0].y, minlength=10).astype(float)
    t_hist /= t_hist.sum()
    overlaps = []
    for nid in neighbor_ids:
        h_n = np.bincount(sim.train_sets[nid].y, minlength=10).astype(float)
        h_n /= h_n.sum()
        overlaps.append(float(np.minimum(t_hist, h_n).sum()))
    top_pi = int(np.argmax(pis[-1]))
    assert got == {
        "early_move": float(np.abs(pis[1] - pis[0]).sum()),
        "late_move": float(np.abs(pis[-1] - pis[-2]).sum()),
        "top_pi_weight": float(pis[-1].max()),
        "top_pi_overlap_rank": int(np.argsort(overlaps)[::-1].tolist()
                                   .index(top_pi)),
        "n_neighbors": len(neighbor_ids)}
    assert len(pis) == SIM_KW["rounds"]


def test_fedsim_bench_merge_write_keeps_unknown_keys(tmp_path):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps({"obs_overhead": {"x": 1}, "results": {},
                                "sharded": [1, 2]}))
    merged = torch_fedsim_bench._merge_write(
        {"results": {"N=8": {}}, "bench": "b"}, path)
    on_disk = json.loads(path.read_text())
    assert merged == on_disk == {"obs_overhead": {"x": 1},
                                 "results": {"N=8": {}}, "sharded": [1, 2],
                                 "bench": "b"}
    fresh = tmp_path / "new.json"
    assert torch_fedsim_bench._merge_write({"a": 1}, fresh) == {"a": 1}
    assert fresh.read_text().endswith("}\n")
