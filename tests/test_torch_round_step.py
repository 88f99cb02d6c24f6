"""The port's multi-pod pFedWN round step
(``repro_torch.launch.steps.make_pfedwn_round_step``), its meshes
(``launch/mesh.py``) and the language models' sharding rules
(``sharding/rules.py``) against the reference on the CPU.

The round: the reference's compiled round step runs in a subprocess on 8
forced host devices (``tests/test_system.py``'s ``_run`` pattern), the
port's on C gloo ranks (``sharding.spawn`` of
``sharding.worker.run_round_step``) at the same time, on the same arrays:
reduced smollm-135m, seq 64, batch 4, probe 2 × 32, params from the
reference's ``init_params`` at keys 0..C−1, a non-uniform π with a zero
column, links with erasures and one all-erased row. Four cases (C = 2 on
``make_debug_mesh(multi_pod=True)``, C = 4 on a (4, 2, 1) mesh, each at
exchange 16 and 8), each in fp32 and in bf16 (the same weights rounded),
so that g, the reference's own bf16-vs-fp32 gap, is known. Gates: fp32
params, π and metrics within 1e-4; bf16 within max(2e-2, g); the
all-erased rank bitwise its post-step params; the local step's update
Δ = post-step − initial params against the reference's ``make_train_step``
in relative norm (fp32 within 1e-4, bf16 within max(2e-2, 2g)), as a bf16
step moves most params by less than half an ulp; the int8 exchange's stack
bitwise the reference's formula (steps.py:203-211) in ``jnp`` on the same
leaves; 3 collectives a round (4 at int8); no K2 launch on the CPU.

The rules: ``spec_for_param`` on every leaf of every registered arch at
three mesh sizes, ``batch_spec`` over every input name, and
``param_shardings``/``cache_shardings`` against the reference's ``.spec``
on its debug meshes (in the same subprocess)."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.sharding import (batch_spec, cache_shardings,
                                  param_shardings, spawn, spec_for_param)
from repro_torch.sharding.worker import run_round_step
from repro_torch.utils.bridge import lm_params_to_numpy, tree_leaves

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.abspath(os.path.join(ROOT, "src"))
TOL, BF16_TOL = 1e-4, 2e-2
LR = 3e-3
SEQ, BATCH, PROBE = 64, 4, (2, 32)
CASES = [(2, 16), (2, 8), (4, 16), (4, 8)]       # (C, exchange bits)
DTYPES = ("float32", "bfloat16")
RULE_ARCHS = ["smollm-135m", "granite-moe-3b-a800m", "deepseek-v3-671b",
              "falcon-mamba-7b", "zamba2-7b"]
CACHE_SHAPES = ["decode_32k", "long_500k"]

# the reference side, in a subprocess with 8 host devices: the compiled
# round step on each case, then param_shardings and cache_shardings on the
# debug meshes
_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro import compat
from repro.configs import TrainConfig, get_config, get_shape
from repro.configs.base import ShapeConfig
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.sharding.rules import cache_shardings, param_shardings

spec = pickle.load(open(sys.argv[1], "rb"))
cfg = get_config("smollm-135m").reduced()
shape = ShapeConfig("t", seq_len=spec["seq"], global_batch=spec["batch"],
                    mode="train")
train_step = jax.jit(steps.make_train_step(
    cfg, TrainConfig(lr=spec["lr"], remat=False), shape))
rounds = []
for case in spec["cases"]:
    C = case["C"]
    mesh = (make_debug_mesh(multi_pod=True) if C == 2 else
            compat.make_mesh((4, 2, 1), ("pod", "data", "model")))
    step = steps.make_pfedwn_round_step(
        cfg, TrainConfig(lr=spec["lr"], remat=False), shape, mesh,
        n_clients=C, probe_sequences=spec["probe"][0],
        probe_tokens=spec["probe"][1], exchange_bits=case["bits"])
    with compat.set_mesh(mesh):
        params, pi, metrics = jax.jit(step)(case["params"], case["batch"],
                                            case["pi"], case["ok"])
    # each client's local step alone: the round's first stage
    post = [jax.tree.map(np.asarray, train_step(
        jax.tree.map(lambda x: x[c], case["params"]),
        jax.tree.map(lambda b: b[c], case["batch"]))[0]) for c in range(C)]
    rounds.append({"params": jax.tree.map(np.asarray, params),
                   "pi": np.asarray(pi),
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "post_step": post})

def specs(tree):
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            tuple(s.spec) for path, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}

pod, flat = make_debug_mesh(multi_pod=True), make_debug_mesh()
rules = {}
for arch in spec["rule_archs"]:
    acfg = get_config(arch)
    acfg = acfg.reduced() if arch == "smollm-135m" else acfg
    ap = steps.abstract_params(acfg)
    stacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((2,) + x.shape, x.dtype), ap)
    rules[arch] = {"params": specs(param_shardings(flat, ap)),
                   "params_client": specs(param_shardings(
                       pod, stacked, client_axis=True))}
    for name in spec["cache_shapes"]:
        cache = steps.abstract_cache(acfg, get_shape(name))
        for pod_batch in (False, True):
            rules[arch][("cache", name, pod_batch)] = specs(cache_shardings(
                pod, cache, pod_batch=pod_batch))
pickle.dump({"rounds": rounds, "rules": rules}, open(sys.argv[2], "wb"))
"""


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _inputs(C: int, seed: int):
    """Params from the reference's ``init_params`` at keys 0..C−1 (fp32),
    tokens and labels, π with column 1 zero, links with erasures (the
    diagonal up) and the last row all erased."""
    cfg = jconfigs.get_config("smollm-135m").reduced()
    params = _stack([jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(c), cfg, jnp.float32)) for c in range(C)])
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (C, BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    pi = rng.uniform(0.1, 1.0, (C, C)).astype(np.float32)
    pi[:, 1] = 0.0
    ok = rng.uniform(size=(C, C)) > 0.3
    np.fill_diagonal(ok, True)
    ok[-1] = False
    return params, batch, pi, ok


def _cast(tree, dtype):
    if dtype == "float32":
        return tree
    return jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16), tree)


def _port_mesh(C):
    return (tmesh.make_debug_mesh(multi_pod=True) if C == 2 else
            tmesh.MeshSpec(("pod", "data", "model"), (4, 2, 1)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rounds and rules (subprocess) and the port's rounds
    (C ranks a case group), started together. Returns {"cases": [(C,
    bits, dtype, inputs)], "ref": reference rounds, "port": {C: ranks},
    "rules": the reference's specs}."""
    tmp = tmp_path_factory.mktemp("round_step")
    cases = []
    for C, bits in CASES:
        params, batch, pi, ok = _inputs(C, 10 * C + bits)
        for dtype in DTYPES:
            cases.append((C, bits, dtype, dict(
                params=_cast(params, dtype), batch=batch, pi=pi, ok=ok)))
    spec = {"cases": [dict(C=C, bits=bits, **inp)
                      for C, bits, _, inp in cases],
            "seq": SEQ, "batch": BATCH, "probe": PROBE, "lr": LR,
            "rule_archs": RULE_ARCHS, "cache_shapes": CACHE_SHAPES}
    inp, out = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump(spec, f)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            inp, out], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        cfg = tconfigs.get_config("smollm-135m").reduced()
        shape = tconfigs.ShapeConfig("t", SEQ, BATCH, "train")
        port = {}
        for C in sorted({c[0] for c in cases}):
            port[C] = spawn(run_round_step, C, "gloo", "cpu", [dict(
                cfg=cfg, train=tconfigs.TrainConfig(lr=LR, remat=False),
                shape=shape, mesh=_port_mesh(C),
                kw=dict(n_clients=C, probe_sequences=PROBE[0],
                        probe_tokens=PROBE[1]),
                params=inp_["params"], batch=inp_["batch"],
                pi_matrix=inp_["pi"], link_ok=inp_["ok"], rounds=[bits],
                keep=True, check=True)
                for C_, bits, _, inp_ in cases if C_ == C], "cpu")
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, (stdout[-1000:], stderr[-3000:])
    with open(out, "rb") as f:
        reference = pickle.load(f)
    return {"cases": cases, "ref": reference["rounds"], "port": port,
            "rules": reference["rules"]}


def _case(runs, C, bits, dtype):
    """(reference round, each rank's port result, inputs) of a case."""
    i = [c[:3] for c in runs["cases"]].index((C, bits, dtype))
    j = [c[:3] for c in runs["cases"] if c[0] == C].index((C, bits, dtype))
    return (runs["ref"][i], [r[j] for r in runs["port"][C]],
            runs["cases"][i][3])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _gaps(ref, ranks):
    """Max |d| of params (every leaf of every rank), π and the metrics
    between a reference round and the port's ranks."""
    gaps = {"params": 0.0, "pi": 0.0, "metrics": 0.0}
    for rank, res in enumerate(ranks):
        mine = jax.tree.map(lambda x: x[rank], ref["params"])
        for a, b in zip(tree_leaves(res["params"]), tree_leaves(mine)):
            gaps["params"] = max(gaps["params"],
                                 float(np.abs(_f32(a) - _f32(b)).max()))
        r = res["rounds"][0]
        gaps["pi"] = max(gaps["pi"],
                         float(np.abs(r["new_pi"] - ref["pi"]).max()))
        assert set(r["metrics"]) == set(ref["metrics"]) == \
            {"loss", "xent", "aux", "mtp"}
        gaps["metrics"] = max(gaps["metrics"], max(
            abs(r["metrics"][k] - ref["metrics"][k]) for k in ref["metrics"]))
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,bits", CASES)
def test_round_step_matches_reference(runs, C, bits, dtype):
    """Params (every leaf of every rank), π and metrics against the
    reference's compiled round step: fp32 within 1e-4; bf16 within
    max(2e-2, g), g the reference's own bf16-vs-fp32 gap here."""
    ref, ranks, _ = _case(runs, C, bits, dtype)
    gaps = _gaps(ref, ranks)
    if dtype == "float32":
        gates = dict.fromkeys(gaps, TOL)
    else:
        ref32, _, _ = _case(runs, C, bits, "float32")
        g = _gaps(ref32, [{"params": jax.tree.map(
            lambda x, r=r: x[r], ref["params"]), "rounds": [
            {"new_pi": ref["pi"], "metrics": ref["metrics"]}]}
            for r in range(C)])
        gates = {k: max(BF16_TOL, g[k]) for k in gaps}
    print(f"C={C} exchange {bits} {dtype}: {gaps} gates {gates}")
    for k in gaps:
        assert gaps[k] <= gates[k], (k, gaps[k], gates[k])
    # π* rows on the simplex, the own weight at EM's floor
    pi = ranks[0]["rounds"][0]["new_pi"]
    np.testing.assert_allclose(pi.sum(1), 1.0, atol=1e-5)
    assert np.all(np.diag(pi) < 1e-6)
    for res in ranks:
        np.testing.assert_array_equal(res["rounds"][0]["new_pi"], pi)


def _rel_err(got, want) -> float:
    """||got − want|| / ||want|| over two lists of arrays, in float64."""
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    return (num / max(den, 1e-300)) ** 0.5


def _update_gaps(ref, ranks, ref32, inputs32):
    """The local step inside the round, as its update Δ = post-step −
    initial params over every leaf of every rank: (the port's Δ against
    the reference's local step's in relative norm, g). A bf16 step moves
    most params by less than half an ulp, so the round's params cannot see
    a wrong gradient; Δ can. g (bf16 only): the reference's Δ against the
    Δ its SGD rule gives in bf16 from its fp32 twin's gradient, recovered
    as (p32 − post32)/lr, the gap two bf16 computations of one gradient
    may each have (``chip_smoke.bf16_step_against_cpu``'s "update" gate)."""
    from repro_torch.launch.train import _sgd_in_param_dtype_
    d_port, d_ref, d_alt = [], [], []
    for rank, res in enumerate(ranks):
        p32 = [torch.from_numpy(np.asarray(x[rank]))
               for x in tree_leaves(inputs32["params"])]
        port = tree_leaves(res["rounds"][0]["post_step"])
        start = [x.to(port[0].dtype) for x in p32]
        d_port += [a.float() - b.float() for a, b in zip(port, start)]
        d_ref += [_f32(a) - b.float().numpy() for a, b in zip(
            tree_leaves(ref["post_step"][rank]), start)]
        if ref32 is not None:
            post32 = [torch.from_numpy(_f32(x))
                      for x in tree_leaves(ref32["post_step"][rank])]
            alt = [x.clone() for x in start]
            _sgd_in_param_dtype_(alt, [(a - b) / LR
                                       for a, b in zip(p32, post32)], LR)
            d_alt += [a.float() - b.float() for a, b in zip(alt, start)]
    return (_rel_err(d_port, d_ref),
            _rel_err(d_alt, d_ref) if ref32 is not None else None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,bits", CASES)
def test_local_step_update_matches_reference(runs, C, bits, dtype):
    """The round's local step, through its update Δ = post-step − initial
    params (every leaf of every rank) against the reference's
    ``make_train_step`` on the same client's params and batch, in
    relative norm: fp32 within 1e-4; bf16 within max(2e-2, 2g), g the
    reference's own gap between its bf16 Δ and the Δ from its fp32
    gradient (:func:`_update_gaps`); a sign-flipped gradient puts Δ 2
    away."""
    ref, ranks, _ = _case(runs, C, bits, dtype)
    ref32, _, inputs32 = _case(runs, C, bits, "float32")
    gap, g = _update_gaps(ref, ranks, ref32 if dtype == "bfloat16" else None,
                          inputs32)
    gate = TOL if dtype == "float32" else max(BF16_TOL, 2 * g)
    print(f"C={C} exchange {bits} {dtype}: update gap {gap} (g {g}, "
          f"gate {gate})")
    assert gap <= gate, (gap, gate)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,bits", CASES)
def test_erased_rank_keeps_its_post_step_model(runs, C, bits, dtype):
    """The last rank's links are all erased: its round ends on its
    post-step params, bit for bit; every other rank's params moved."""
    _, ranks, _ = _case(runs, C, bits, dtype)
    for rank, res in enumerate(ranks):
        got = tree_leaves(res["params"])
        post = tree_leaves(res["rounds"][0]["post_step"])
        same = all(torch.equal(a, b) for a, b in zip(got, post))
        assert same == (rank == C - 1), rank


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [2, 4])
def test_int8_exchange_is_the_reference_formula(runs, C, dtype):
    """The dequantized (C, P) stack of every rank equals the reference's
    formula (steps.py:203-211), evaluated with ``jnp`` on the ranks'
    post-step leaves, bit for bit; and at exchange 16 the stack is the
    leaves themselves."""
    for bits in (8, 16):
        _, ranks, _ = _case(runs, C, bits, dtype)
        posts = [tree_leaves(lm_params_to_numpy(r["rounds"][0]["post_step"]))
                 for r in ranks]
        want = []
        for leaves in posts:
            row = []
            for p in leaves:
                p = jnp.asarray(p)
                if bits == 8:
                    scale = jnp.maximum(jnp.max(jnp.abs(p.astype(
                        jnp.float32))), 1e-12) / 127.0
                    q = jnp.clip(jnp.round(p.astype(jnp.float32) / scale),
                                 -127, 127).astype(jnp.int8)
                    p = q.astype(p.dtype) * scale.astype(p.dtype)
                row.append(np.asarray(p).reshape(-1))
            want.append(np.concatenate(row))
        want = np.stack(want)
        for rank, res in enumerate(ranks):
            stack = lm_params_to_numpy(res["rounds"][0]["stack"])
            assert stack.dtype == want.dtype and stack.shape == want.shape
            np.testing.assert_array_equal(stack.view(np.uint8),
                                          want.view(np.uint8), str(rank))


@pytest.mark.parametrize("C,bits", CASES)
def test_round_step_collectives_and_launches(runs, C, bits):
    """3 collectives a round (4 with int8's scales), one ``round_step``
    call, no K2 launch on the CPU, and K3's counts untouched (the CPU
    route)."""
    for dtype in DTYPES:
        _, ranks, _ = _case(runs, C, bits, dtype)
        for res in ranks:
            r = res["rounds"][0]
            assert r["collectives"] == (4 if bits == 8 else 3)
            assert r["calls"]["round_step"] == 1
            assert r["k2"] == r["k2_bf16"] == 0
            assert r["k3"]["forward"] == 0
            assert set(r["stage_ms"]) == {"local_step", "exchange", "em",
                                          "mix", "outputs"}


def test_round_step_rejects_a_mesh_or_group_of_another_size():
    cfg = tconfigs.get_config("smollm-135m").reduced()
    shape = tconfigs.ShapeConfig("t", SEQ, BATCH, "train")
    train = tconfigs.TrainConfig()
    with pytest.raises(ValueError, match="'pod' axis has 2 clients"):
        tsteps.make_pfedwn_round_step(cfg, train, shape,
                                      tmesh.make_debug_mesh(multi_pod=True),
                                      n_clients=4)
    with pytest.raises(ValueError, match="no 'pod' axis"):
        tmesh.pod_group(tmesh.make_debug_mesh())
    # no process group: C = 2 needs two ranks
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        tsteps.make_pfedwn_round_step(cfg, train, shape,
                                      tmesh.make_debug_mesh(multi_pod=True),
                                      n_clients=2)


def test_round_step_in_process_at_one_client():
    """C = 1 with no process group: every collective is the rank itself;
    the own model is masked out, so EM's floor puts π* at 1 on it, the mix
    blends the model with itself and returns it exactly (fp32), on a
    plain tree as on views of one buffer (either way the leaves are
    copied into one buffer and the mix copied back into them)."""
    from repro_torch.models.model import init_params
    from repro_torch.utils.bridge import ParamLayout
    cfg = tconfigs.get_config("smollm-135m").reduced()
    shape = tconfigs.ShapeConfig("t", 16, 2, "train")
    train = tconfigs.TrainConfig(lr=LR, remat=False)
    step = tsteps.make_pfedwn_round_step(
        cfg, train, shape, tmesh.MeshSpec(("pod",), (1,)), n_clients=1,
        probe_sequences=2, probe_tokens=8)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layout = ParamLayout.of(tree)
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(tree)])
    views = layout.views(flat.clone())
    expect = tsteps.make_train_step(cfg, train, shape)(
        layout.views(flat.clone()), batch)[0]
    pi, ok = torch.ones((1, 1)), torch.ones((1, 1), dtype=torch.bool)
    for params in (tree, views):
        out, new_pi, metrics = step(params, batch, pi, ok)
        assert out is params
        assert torch.equal(new_pi, torch.ones((1, 1)))
        assert torch.isfinite(metrics["loss"])
        for a, b in zip(tree_leaves(out), tree_leaves(expect)):
            assert torch.equal(a, b)


def test_mixed_dtype_params_are_refused():
    cfg = tconfigs.get_config("smollm-135m").reduced()
    shape = tconfigs.ShapeConfig("t", 16, 2, "train")
    step = tsteps.make_pfedwn_round_step(
        cfg, tconfigs.TrainConfig(), shape, tmesh.MeshSpec(("pod",), (1,)),
        n_clients=1)
    from repro_torch.models.model import init_params
    tree = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree["ln_f"] = tree["ln_f"].bfloat16()
    batch = {k: torch.zeros((2, 16), dtype=torch.int64)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="one dtype"):
        step(tree, batch, torch.ones((1, 1)),
                 torch.ones((1, 1), dtype=torch.bool))


# ------------------------------------------------------- meshes and rules


@pytest.mark.parametrize("fn", ["make_production_mesh", "make_debug_mesh"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_geometry_is_the_references(monkeypatch, fn, multi_pod):
    """Axis names and sizes equal those the reference passes to
    ``compat.make_mesh`` (recorded, since its meshes need 256 to 512
    devices), and ``axis_sizes()`` equals ``compat.mesh_axis_sizes`` of
    the mesh the reference would build."""
    seen = {}
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes, **kw:
                        seen.update(shape=tuple(shape), axes=tuple(axes)))
    getattr(jmesh, fn)(multi_pod=multi_pod)
    spec = getattr(tmesh, fn)(multi_pod=multi_pod)
    assert (spec.shape, spec.axis_names) == (seen["shape"], seen["axes"])
    abstract = jax.sharding.AbstractMesh(seen["shape"], seen["axes"])
    assert spec.axis_sizes() == compat.mesh_axis_sizes(abstract)


def _ref_names(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _rule_cfg(arch):
    cfg = tconfigs.get_config(arch)
    return cfg.reduced() if arch == "smollm-135m" else cfg


SIZES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
         {"pod": 2, "data": 2, "model": 2}]


@pytest.mark.parametrize("arch", sorted(tconfigs.list_archs()))
def test_spec_for_param_matches_reference(arch):
    """Every leaf of the arch's full-width abstract params (the
    reference's ``abstract_params``, the port's meta tensors), at the
    production, single-pod and debug sizes."""
    ref = jax.tree_util.tree_flatten_with_path(
        jsteps.abstract_params(jconfigs.get_config(arch)))[0]
    port = jax.tree_util.tree_flatten_with_path(
        tsteps.abstract_params(tconfigs.get_config(arch)))[0]
    assert [_ref_names(p) for p, _ in ref] == [_ref_names(p) for p, _ in port]
    for sizes in SIZES:
        for (path, x), (_, t) in zip(ref, port):
            names = _ref_names(path)
            assert tuple(t.shape) == tuple(x.shape)
            assert spec_for_param(names, tuple(t.shape), sizes) == \
                tuple(jrules.spec_for_param(names, tuple(x.shape), sizes)), \
                (names, sizes)


def test_batch_spec_matches_reference():
    names = ["tokens", "labels", "stub_embeds", "positions", "token", "pos"]
    for name in names:
        for ndim in range(0, 5):
            for client_axis in (False, True):
                for pod_batch in (False, True):
                    if client_axis and ndim == 0:
                        continue
                    assert batch_spec(name, ndim, client_axis=client_axis,
                                      pod_batch=pod_batch) == tuple(
                        jrules.batch_spec(name, ndim,
                                          client_axis=client_axis,
                                          pod_batch=pod_batch)), \
                        (name, ndim, client_axis, pod_batch)


def _port_specs(tree):
    return {_ref_names(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple))[0]}


@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_param_and_cache_shardings_match_reference(runs, arch):
    """``param_shardings`` (client axis or not) and ``cache_shardings``
    (serving replicas or not, at decode_32k and long_500k) against the
    reference's ``.spec`` on its debug meshes: smollm-135m reduced,
    granite-moe's expert stacks, deepseek-v3's ``c_kv``/``k_rope``,
    falcon-mamba's ``h``/``conv``, zamba2's hybrid cache."""
    ref = runs["rules"][arch]
    cfg = _rule_cfg(arch)
    pod = tmesh.make_debug_mesh(multi_pod=True)
    flat = tmesh.make_debug_mesh()
    ap = tsteps.abstract_params(cfg)
    stacked = jax.tree.map(lambda x: torch.empty((2,) + tuple(x.shape),
                                                 dtype=x.dtype,
                                                 device="meta"), ap)
    assert _port_specs(param_shardings(flat, ap)) == ref["params"]
    assert _port_specs(param_shardings(pod, stacked, client_axis=True)) == \
        ref["params_client"]
    for name in CACHE_SHAPES:
        cache = tsteps.abstract_cache(cfg, tconfigs.get_shape(name))
        for pod_batch in (False, True):
            got = _port_specs(cache_shardings(pod, cache,
                                              pod_batch=pod_batch))
            assert got == ref[("cache", name, pod_batch)], \
                (name, pod_batch)
