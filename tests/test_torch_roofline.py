"""The port's roofline report against the reference on the CPU:
``roofline/analysis.py``'s analytic counts and terms, the work counter
(``roofline/counter.py``) against a hand count, the collective counter
(``roofline/collectives.py``) on a 2-rank gloo round step against the
analytic bytes and the reference's ``collective_bytes_from_hlo``, and the
dry run's records (``launch/dryrun.py``)."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.roofline import analysis as janalysis
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as tmodel
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline.counter import CostCounter
from repro_torch.sharding import spawn
from repro_torch.sharding.worker import run_round_step
from repro_torch.utils.bridge import tree_leaves

torch.set_num_threads(1)

ARCHS = sorted(tconfigs.list_archs())
SHAPES = sorted(tconfigs.SHAPES)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                   "src"))


def _reference_dryrun():
    """The reference's ``launch/dryrun.py``, which sets XLA_FLAGS to 512
    host devices as it is imported: imported once the backend is up (so
    this process keeps its devices), the variable restored after (so no
    child inherits it)."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def test_archs_and_shapes_are_the_references():
    assert ARCHS == sorted(jconfigs.list_archs())
    assert SHAPES == sorted(jconfigs.SHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_references(arch):
    """``param_counts`` and ``model_flops`` at full width, for the four
    shapes: the reference's numbers exactly (pure Python)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tanalysis.param_counts(tcfg) == janalysis.param_counts(jcfg)
    for name in SHAPES:
        assert tanalysis.model_flops(tcfg, tconfigs.get_shape(name)) == \
            janalysis.model_flops(jcfg, jconfigs.get_shape(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_within_5_percent_of_the_meta_tree(arch):
    """The analytic total against the port's full-width ``init_params``
    on the meta device, for every arch (``tests/test_system.py::
    test_param_count_analytic_matches_actual`` checks two reduced ones)."""
    cfg = tconfigs.get_config(arch)
    tree = tmodel.init_params(cfg, torch.Generator(), device="meta",
                              dtype=torch.bfloat16)
    actual = sum(x.numel() for x in tree_leaves(tree))
    analytic = tanalysis.param_counts(cfg)["total"]
    assert abs(analytic - actual) / actual < 0.05, (analytic, actual)


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variants_and_trips_equal_the_references(arch):
    jdryrun = _reference_dryrun()
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dryrun._layer_trips(tcfg) == jdryrun._layer_trips(jcfg)
    for periods in (1, 2):
        assert dryrun._depth_variant(tcfg, periods).n_layers == \
            jdryrun._depth_variant(jcfg, periods).n_layers


def test_roofline_terms_are_the_references_with_the_cards_constants(
        monkeypatch):
    """The reference's formula with its TPU v5e constants replaced by the
    H100's (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s): the same terms,
    dominant term and useful-compute ratio."""
    for name, value in (("PEAK_FLOPS", 989e12), ("HBM_BW", 3.35e12),
                        ("ICI_BW", 450e9)):
        monkeypatch.setattr(janalysis, name, value)
    assert (tanalysis.PEAK_FLOPS, tanalysis.HBM_BW, tanalysis.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    recs = [{"devices": 1, "flops": 3e15, "bytes_accessed": 2e12,
             "collective_bytes": 0.0},
            {"devices": 2, "flops": 1e13, "bytes_accessed": 9e12,
             "collective_bytes": 4e9},
            {"devices": 2, "flops": 1e12, "bytes_accessed": 1e9,
             "collective_bytes": 6e11}]
    for rec in recs:
        for arch, shape in (("smollm-135m", "train_4k"),
                            ("granite-moe-3b-a800m", "decode_32k")):
            got = tanalysis.roofline_terms(rec, tconfigs.get_config(arch),
                                           tconfigs.get_shape(shape))
            want = janalysis.roofline_terms(rec, jconfigs.get_config(arch),
                                            jconfigs.get_shape(shape))
            assert got == pytest.approx(want, rel=1e-12)


def _hand_count(cfg, B, S, train, remat=False):
    """FLOPs by hand for reduced smollm-135m: every projection 2·in·out a
    token (q, k, v, o, gate, up, down), the vocabulary head 2·d·V (on the
    last token in a prefill), K3 4·Dh a visible (query, key) pair a head;
    a training step adds each projection's two backward products (2×) and
    K3's five products of 2·Dh a pair, and with ``remat`` each layer's
    forward again but its last product (the MLP's down projection, whose
    output the backward does not read: torch's checkpoint stops its
    recomputation once it has every saved tensor)."""
    d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    T = B * S
    proj = 2 * T * (d * H * Dh + 2 * d * KH * Dh + H * Dh * d
                    + 3 * d * cfg.d_ff) * cfg.n_layers
    down = 2 * T * cfg.d_ff * d * cfg.n_layers
    head = 2 * d * cfg.vocab * (T if train else B)
    pairs = S * (S + 1) // 2
    attn_fwd = 4 * Dh * pairs * B * H * cfg.n_layers
    if not train:
        return proj + head + attn_fwd, attn_fwd
    fwd_again = (proj - down + attn_fwd) if remat else 0
    attn_bwd = 10 * Dh * pairs * B * H * cfg.n_layers
    return (3 * (proj + head) + attn_fwd + attn_bwd + fwd_again,
            attn_fwd * (2 if remat else 1) + attn_bwd)


def _count(cfg, shape, device, remat=False):
    """The counter's (FLOPs, kernel FLOPs) of one prefill or train step
    of ``cfg`` at ``shape`` on ``device`` (meta, or the CPU route with
    random bf16 weights)."""
    run = dryrun._step(cfg, shape, device, multi_pod=False)[0] \
        if device == "meta" else None
    if device == "cpu":
        params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu", dtype=torch.bfloat16)
        batch = dryrun._materialize(tsteps.input_specs(cfg, shape), cfg,
                                    "cpu")
        if shape.mode == "train":
            step = tsteps.make_train_step(
                cfg, tconfigs.TrainConfig(remat=remat), shape)
        else:
            step = tsteps.make_prefill_step(cfg, shape)

        def run():
            return step(params, batch)
    elif shape.mode == "train":
        params = tsteps.abstract_params(cfg)
        batch = tsteps.input_specs(cfg, shape)
        step = tsteps.make_train_step(
            cfg, tconfigs.TrainConfig(remat=remat), shape)

        def run():
            return step(params, batch)
    with CostCounter() as c:
        run()
    return c.flops, c.kernel_flops()


@pytest.mark.parametrize("mode,remat", [("prefill", False),
                                        ("train", False), ("train", True)])
def test_flop_count_matches_a_hand_count_on_meta_and_cpu(mode, remat):
    """The counter on reduced smollm-135m (B 2 × S 48): the step's FLOPs
    within 1 % of the hand count and K3's FLOPs exactly its visible-pair
    count, the same on the meta device and on the CPU route (where the
    plain version's own products are not counted)."""
    cfg = tconfigs.get_config("smollm-135m").reduced()
    shape = tconfigs.ShapeConfig("t", 48, 2, mode)
    want, want_k3 = _hand_count(cfg, 2, 48, mode == "train", remat)
    meta = _count(cfg, shape, "meta", remat)
    cpu = _count(cfg, shape, "cpu", remat)
    assert meta == cpu
    assert meta[1] == want_k3
    assert abs(meta[0] - want) <= 0.01 * want, (meta[0], want)


def test_visible_pairs_and_kernel_costs():
    """K3's pair count by index (causal, windowed, ragged) against the
    mask's sum, and by positions (ties, invalid keys, unsorted)."""
    from repro_torch.kernels.ref import _attention_mask
    for Sq, Skv, causal, window in ((48, 48, True, 0), (37, 50, True, 8),
                                    (20, 33, False, 5), (64, 16, True, 0),
                                    (5, 5, False, 0)):
        want = int(_attention_mask(Sq, Skv, causal, window, "cpu").sum())
        assert k3.visible_pairs(Sq, Skv, causal, window) == want
    g = torch.Generator().manual_seed(0)
    qp = torch.randint(-2, 30, (40,), generator=g)
    kp = torch.randint(-2, 30, (33,), generator=g)
    for causal, window in ((True, 0), (True, 6), (False, 4), (False, 0)):
        want = int(_attention_mask(40, 33, causal, window, "cpu", qp,
                                   kp).sum())
        assert k3.visible_pairs(40, 33, causal, window, qp, kp) == want
    # on the meta device the positions hold no values: the index count
    assert k3.visible_pairs(40, 33, True, 0, qp.to("meta"),
                            kp.to("meta")) == k3.visible_pairs(40, 33, True,
                                                               0)


def _round_case(bits):
    cfg = tconfigs.get_config("smollm-135m").reduced()
    rng = np.random.default_rng(bits)
    C = 2
    batch = {k: rng.integers(0, cfg.vocab, (C, 4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    return dict(cfg=cfg, train=tconfigs.TrainConfig(lr=3e-3, remat=False),
                shape=tconfigs.ShapeConfig("t", 64, 4, "train"),
                mesh=make_debug_mesh(multi_pod=True),
                kw=dict(n_clients=C, probe_sequences=2, probe_tokens=32),
                seed=0, dtype=torch.bfloat16, batch=batch,
                pi_matrix=np.full((C, C), 0.5, np.float32),
                link_ok=np.ones((C, C), bool), rounds=[bits])


# the reference's compiled round step (bf16, exchange 16) on a mesh whose
# within-client axes have size 1, (2, 1, 1), sharded as its dry run shards
# it, and the collectives of its HLO by kind
_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs import TrainConfig, get_config
from repro.configs.base import ShapeConfig
from repro.launch import steps
from repro.roofline.hlo import collective_bytes_from_hlo
from repro.sharding.rules import batch_spec, param_shardings

cfg = get_config("smollm-135m").reduced()
shape = ShapeConfig("t", seq_len=64, global_batch=4, mode="train")
mesh = compat.make_mesh((2, 1, 1), ("pod", "data", "model"))
step = steps.make_pfedwn_round_step(
    cfg, TrainConfig(lr=3e-3, remat=False), shape, mesh, n_clients=2,
    probe_sequences=2, probe_tokens=32, exchange_bits=16)
params = jax.tree.map(lambda x: jax.ShapeDtypeStruct((2,) + x.shape,
                                                     x.dtype),
                      steps.abstract_params(cfg))
batch = {k: jax.ShapeDtypeStruct((2, 4, 64), jnp.int32)
         for k in ("tokens", "labels")}
pi = jax.ShapeDtypeStruct((2, 2), jnp.float32)
ok = jax.ShapeDtypeStruct((2, 2), jnp.bool_)
# the shardings of the reference's dry run (launch/dryrun.py:96-110): the
# params and batch split over the pod axis, pi and the links replicated
with compat.set_mesh(mesh):
    pshard = param_shardings(mesh, params, client_axis=True)
    bshard = {k: NamedSharding(mesh, batch_spec(k, v.ndim, client_axis=True))
              for k, v in batch.items()}
    rep = NamedSharding(mesh, P())
    compiled = jax.jit(step, in_shardings=(pshard, bshard, rep, rep),
                       out_shardings=(pshard, rep, None)).lower(
        params, batch, pi, ok).compile()
pickle.dump(collective_bytes_from_hlo(compiled.as_text()),
            open(sys.argv[1], "wb"))
"""


def test_round_step_collective_bytes(tmp_path):
    """A 2-rank gloo round step of reduced smollm-135m in bf16 on the CPU:
    the collective counter's bytes by kind equal the analytic ones on
    every rank (exchange 16: the (2, P) bf16 stack and π's (2, 2) fp32
    gathered, 4 fp32 metrics reduced; exchange 8: the int8 stack and the
    (2, n_leaves) fp32 scales instead of the bf16 stack); and the
    exchange's all-gather bytes equal the reference's compiled step's
    (``collective_bytes_from_hlo``) on a (2, 1, 1) mesh, element for
    element: XLA's CPU backend widens the bf16 all-gathers to fp32 (its
    HLO gathers ``f32[2, ...]`` of each leaf), so its bytes are twice the
    bf16 stack's, and π's (2, 2) fp32 gather is the same."""
    out = str(tmp_path / "ref.pkl")
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            out], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn(run_round_step, 2, "gloo", "cpu",
                      [_round_case(16), _round_case(8)], "cpu")
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stderr[-3000:]
    with open(out, "rb") as f:
        reference = pickle.load(f)
    cfg = tconfigs.get_config("smollm-135m").reduced()
    leaves = tree_leaves(tmodel.init_params(cfg, torch.Generator(),
                                            device="meta"))
    P, n_leaves, C = sum(x.numel() for x in leaves), len(leaves), 2
    want = {16: {"all-gather": C * P * 2 + C * C * 4, "all-reduce": 16},
            8: {"all-gather": C * P + C * n_leaves * 4 + C * C * 4,
                "all-reduce": 16}}
    for rank in ranks:
        for case, bits in zip(rank, (16, 8)):
            got = case["rounds"][0]["collective_bytes"]
            assert got["by_kind"] == want[bits]
            assert got["total"] == sum(want[bits].values())
            assert got["count"] == (3 if bits == 16 else 4)
    # the reference gathers the exchange leaf by leaf (in fp32 on the
    # CPU) and π, and moves nothing else across the pod axis
    print("reference:", reference)
    assert reference["count"] == n_leaves + 2
    assert reference["by_kind"]["all-gather"] == 2 * (C * P * 2) + C * C * 4


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("granite-moe-3b-a800m", "prefill_32k"),
    ("minicpm3-4b", "decode_32k"), ("falcon-mamba-7b", "long_500k"),
    ("zamba2-7b", "decode_32k"), ("qwen2-vl-2b", "train_4k"),
    ("musicgen-large", "long_500k"), ("deepseek-v3-671b", "decode_32k")])
def test_dryrun_record_has_the_references_fields(arch, shape):
    """One arch per family: ``status: ok`` and the reference's fields
    (``arch``, ``shape``, ``mesh``, ``devices``, ``per_device_costs``,
    ``flops``, ``bytes_accessed``, ``collective_bytes``, ``collectives``,
    ``memory.argument_bytes``, ``extrapolated``, ``depth_probe``), the
    full-depth costs the extrapolation of the two probes; deepseek-v3 at
    full width meta only."""
    rec = dryrun.run_combo(arch, shape, None)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("arch", "shape", "mesh", "devices", "per_device_costs",
                "flops", "bytes_accessed", "collective_bytes",
                "collectives", "memory", "extrapolated", "depth_probe"):
        assert key in rec, key
    probe = rec["depth_probe"]
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        d1, d2 = probe["d1"][key], probe["d2"][key]
        assert rec[key] == pytest.approx(
            d1 + max(probe["trips"] - 1, 0) * (d2 - d1))
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["meta_only"] == (arch == "deepseek-v3-671b")


def test_dryrun_multi_pod_counts_the_round_steps_collectives():
    """``--multi-pod`` at smollm-135m (full width): the round step on a
    fake 2-rank group, its exchange counted as the analytic all-gather of
    the (2, P) bf16 stack plus π, extrapolated from the depth probes to
    the full tree's P; one K2 launch."""
    cfg = tconfigs.get_config("smollm-135m")
    rec = dryrun.run_combo("smollm-135m", "train_4k", None, multi_pod=True)
    assert rec["status"] == "ok", rec.get("traceback")
    P = sum(x.numel() for x in tree_leaves(tsteps.abstract_params(cfg)))
    assert rec["collectives"]["all-gather"] == 2 * P * 2 + 16
    assert rec["collectives"]["all-reduce"] == 16
    assert rec["kernels"]["k2"]["calls"] == 1
