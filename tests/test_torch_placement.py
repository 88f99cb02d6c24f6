"""Placement within a client (``repro_torch.sharding.place``,
``repro_torch.sharding.tensor_parallel`` and the ``placement`` of
``repro_torch.launch.steps``' builders) against the reference on the CPU.

Shard shapes: the reference's ``NamedSharding(mesh, spec)`` on 8 forced
host devices (a subprocess, ``tests/test_system.py``'s pattern) gives each
mesh position its block of every leaf of every registered architecture's
``reduced()`` params and ``init_cache`` (batch 1 and 4), on the debug mesh
(2, 2) and on (1, 4); the port's ``shard_tree`` must give the rank at that
position the same block (leaves filled with their flat index, so a block
equal to the reference's slice has its shape and its offset). The same
subprocess sums the reference's shard bytes of params, batch and cache a
device for every arch and shape on the debug mesh:
``launch/dryrun.py::argument_bytes_per_card`` must equal them.

Parity: reduced smollm-135m (H 4, KH 2, d_ff 512) on 4 gloo ranks
(``sharding.spawn`` of ``sharding.worker.run_placed``) at meshes (2, 2)
and (1, 4) (which splits ``wk`` within a KV head, so the compute gathers
it), against the reference's unsharded ``make_train_step``,
``make_prefill_step`` and ``make_decode_step`` on the same numpy weights
from its ``init_params``: 2 SGD steps (params and every rank's loss within
1e-4, ``tests/test_torch_steps.py``'s), the prefill's logits within 1e-4
(``tests/test_torch_lm.py``'s) and 4 greedy decode steps' tokens equal;
the sharded and the one-rank port steps within the same tolerance.

Refusals: a world size other than D·T, a mesh without both axes (or with
``"pod"``), no started group, the MLA, SSM and hybrid families (the MoE
and the stub-prefix families' plans build;
``tests/test_torch_placement_moe.py`` and
``tests/test_torch_placement_stub.py`` run them); and without
``placement`` the steps are the one-device steps bit for bit.
"""
import copy
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import (MeshSpec, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.launch.train import _layered, _sgd_in_param_dtype_, \
    value_and_grad
from repro_torch.models import model as tmodel
from repro_torch.sharding import (default_backend, place, spawn,
                                  tensor_parallel)
from repro_torch.sharding.rules import cache_shardings, param_shardings
from repro_torch.sharding.worker import run_placed
from repro_torch.utils.bridge import from_jax_lm_params, tree_leaves

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.abspath(os.path.join(ROOT, "src"))
TOL = 1e-4                   # tests/test_torch_steps.py, test_torch_lm.py
LR = 3e-3
B, S = 4, 32                 # the train batch
PROMPT, GEN = (4, 16), 5     # the prefill, then 4 greedy decode steps
MESHES = [(2, 2), (1, 4)]
ARCHS = sorted(tconfigs.list_archs())
SHAPES = list(tconfigs.SHAPES)
CACHE_BATCHES = (1, 4)
CACHE_LEN = 8

# the reference side, in a subprocess with 8 host devices: each mesh
# position's block (start, stop per dim) of every leaf of the reduced params
# and caches, the device ids in mesh order, and the shard bytes a device of
# every arch x shape on the debug mesh
_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import functools
import jax, numpy as np
from jax.sharding import NamedSharding
from repro import compat
from repro.configs import get_config, get_shape, list_archs
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.models import model as model_lib
from repro.sharding.rules import batch_spec, cache_shardings, param_shardings

spec = pickle.load(open(sys.argv[1], "rb"))
meshes = {m: compat.make_mesh(m, ("data", "model")) for m in spec["meshes"]}
debug = make_debug_mesh()
from repro.launch.dryrun import _safe_spec   # after the devices exist

def names(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

def blocks(mesh, tree, shardings):
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    for (path, x), (_, sh) in zip(flat, specs):
        shape = tuple(x.shape)
        index = sh.devices_indices_map(shape)
        per = {}
        for pos in np.ndindex(mesh.devices.shape):
            sl = index[mesh.devices[pos]]
            per[pos] = tuple(s.indices(d)[:2] for s, d in zip(sl, shape))
        out[names(path)] = {"shape": shape, "blocks": per,
                            "shard_shape": sh.shard_shape(shape)}
    return out

layouts = {}
for arch in list_archs():
    cfg = get_config(arch).reduced()
    ap = steps.abstract_params(cfg)
    for m, mesh in meshes.items():
        rec = {"params": blocks(mesh, ap, param_shardings(mesh, ap))}
        for b in spec["cache_batches"]:
            ac = jax.eval_shape(functools.partial(
                model_lib.init_cache, cfg, b, spec["cache_len"]))
            rec[("cache", b)] = blocks(mesh, ac, cache_shardings(mesh, ac))
        layouts[(arch, m)] = rec

def shard_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(x.shape)))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, shs))

per_card = {}
for arch in list_archs():
    cfg = get_config(arch)
    ap = steps.abstract_params(cfg)
    pbytes = shard_bytes(ap, param_shardings(debug, ap))
    for name in spec["shapes"]:
        shape = get_shape(name)
        specs = steps.input_specs(cfg, shape)
        n = pbytes + sum(
            int(np.prod(NamedSharding(debug, _safe_spec(
                debug, batch_spec(k, v.ndim), v.shape)).shard_shape(v.shape)))
            * np.dtype(v.dtype).itemsize for k, v in specs.items())
        if shape.mode == "decode":
            ac = steps.abstract_cache(cfg, shape)
            n += shard_bytes(ac, cache_shardings(debug, ac))
        per_card[(arch, name)] = n
ids = {m: np.vectorize(lambda d: d.id)(mesh.devices) for m, mesh in meshes.items()}
pickle.dump({"layouts": layouts, "per_card": per_card, "ids": ids},
            open(sys.argv[2], "wb"))
"""


def _reference_serve(cfg, params, prompts, gen):
    """The reference's greedy serve: ``make_prefill_step``, the prefill
    cache moved into ``init_cache`` of P + gen positions, then
    ``make_decode_step`` from position P (its ``launch/serve.py``'s loop).
    Returns (tokens (B, gen), logits (gen, B, V), the cache after the
    last step)."""
    Bp, P = prompts.shape
    shape = jconfigs.ShapeConfig("d", P + gen, Bp, "decode")
    prefill = jax.jit(jsteps.make_prefill_step(cfg, shape))
    decode = jax.jit(jsteps.make_decode_step(cfg, shape))
    logits, pcache = prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = jmodel.init_cache(cfg, Bp, P + gen, dtype=jnp.float32)
    cache = jax.tree.map(lambda c, p: c.at[:, :, :p.shape[2]].set(p), cache,
                         pcache)
    tok = jnp.argmax(logits, axis=-1)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = decode(params, cache,
                               {"token": tok[:, None],
                                "pos": jnp.int32(P + i)})
        tok = jnp.argmax(logits, axis=-1)
        toks.append(tok)
        all_logits.append(logits)
    return (np.stack(toks, axis=1), np.stack(all_logits),
            jax.tree.map(np.asarray, cache))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's layouts and bytes (subprocess), the port's ranks at
    both meshes (one spawn of 4 gloo ranks), the reference's steps and
    serve and the one-rank port's, all on the same weights and batch."""
    tmp = tmp_path_factory.mktemp("placement")
    inp, out = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump({"meshes": MESHES, "shapes": SHAPES,
                     "cache_batches": CACHE_BATCHES,
                     "cache_len": CACHE_LEN}, f)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), inp, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jcfg = jconfigs.get_config("smollm-135m").reduced()
        tcfg = tconfigs.get_config("smollm-135m").reduced()
        params = jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(0), jcfg, jnp.float32))
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][1, :7] = -1                  # masked labels
        prompts = rng.integers(0, tcfg.vocab, PROMPT).astype(np.int32)
        cases = [dict(cfg=tcfg, mesh=MeshSpec(("data", "model"), m),
                      params=params, batch=batch, steps=2, lr=LR,
                      prompts=prompts, gen=GEN, keep=True, blocks=True)
                 for m in MESHES]
        ranks = spawn(run_placed, 4, default_backend(4, "cpu"), "cpu", cases,
                      "cpu")

        # the reference, unsharded, on the same arrays
        shape = jconfigs.ShapeConfig("t", S, B, "train")
        step = jax.jit(jsteps.make_train_step(
            jcfg, jconfigs.TrainConfig(lr=LR, remat=False), shape))
        p, losses = params, []
        for _ in range(2):
            p, metrics = step(p, batch)
            losses.append(float(metrics["loss"]))
        ref = {"params": jax.tree.map(np.asarray, p), "losses": losses}
        ref["tokens"], ref["logits"], ref["cache"] = _reference_serve(
            jcfg, params, prompts, GEN)

        # the one-rank port
        tp = from_jax_lm_params(params, tcfg, "cpu")
        served = tserve.serve(tcfg, tp, torch.as_tensor(prompts), GEN,
                              device="cpu")
        one_step = tsteps.make_train_step(
            tcfg, tconfigs.TrainConfig(lr=LR, remat=False),
            tconfigs.ShapeConfig("t", S, B, "train"))
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        one_losses = []
        for _ in range(2):
            tp, metrics = one_step(tp, tb)
            one_losses.append(float(metrics["loss"]))
        one = {"params": tp, "losses": one_losses, "tokens": served.tokens,
               "logits": served.logits}
        stdout, stderr = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, (stdout[-1000:], stderr[-3000:])
    with open(out, "rb") as f:
        reference = pickle.load(f)
    return {"ranks": ranks, "ref": ref, "one": one, "cfg": tcfg,
            **reference}


def _max_gap(a_tree, b_tree) -> float:
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _mesh_ranks(runs, mesh):
    i = MESHES.index(mesh)
    return [r[i] for r in runs["ranks"]]


# ------------------------------------------------------------ shard shapes

def _indexed(shape) -> torch.Tensor:
    """A leaf filled with its flat index (a block's values give its
    offset)."""
    n = int(np.prod(shape)) if shape else 1
    return torch.arange(n, dtype=torch.int64).reshape(shape)


def _names(path):
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _check_blocks(ref, tree, specs, mesh):
    """Every rank's block of every leaf of ``tree`` (meta) under ``specs``
    against the reference's block at the rank's mesh position."""
    flat = place.spec_items(specs)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert {_names(p) for p, _ in leaves} == set(ref)
    for path, meta in leaves:
        names = _names(path)
        shape = tuple(meta.shape)
        assert shape == ref[names]["shape"], names
        whole = _indexed(shape)
        for rank in range(int(np.prod(mesh))):
            pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
            pos = tuple(pl.coords[a] for a in ("data", "model"))
            want = ref[names]["blocks"][pos]
            block = place.shard_tree({"x": whole}, {"x": flat[names]},
                                     pl)["x"]
            assert tuple(block.shape) == tuple(ref[names]["shard_shape"])
            assert torch.equal(block, whole[tuple(slice(a, b)
                                                  for a, b in want)]), \
                (names, rank, want)


def test_rank_coords_follow_the_reference_mesh(runs):
    """Rank r sits at the mesh position of device id r (row-major), as
    ``compat.make_mesh`` lays the forced host devices."""
    for m in MESHES:
        ids = runs["ids"][m]
        mesh = MeshSpec(("data", "model"), m)
        for pos in np.ndindex(ids.shape):
            c = place.rank_coords(mesh, int(ids[pos]))
            assert (c["data"], c["model"]) == pos
    assert place.rank_coords(MeshSpec(("data", "model"), (2, 3)), 4) == \
        {"data": 1, "model": 1}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_blocks_are_the_references_shards(runs, arch, mesh):
    """Every rank's block of every param of ``reduced()``: the reference's
    shard shape, at the reference's offset."""
    cfg = tconfigs.get_config(arch).reduced()
    meta = tsteps.abstract_params(cfg)
    ref = runs["layouts"][(arch, mesh)]["params"]
    _check_blocks(ref, meta, param_shardings(MeshSpec(("data", "model"),
                                                      mesh), meta), mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_are_the_references_shards(runs, arch, mesh):
    """Every rank's block of every leaf of ``init_cache`` (batch 1, which
    no data split divides, and 4): shard shape and offset, the head-dim
    fallback included (KH 2 over 4 model ranks)."""
    cfg = tconfigs.get_config(arch).reduced()
    for b in CACHE_BATCHES:
        meta = tmodel.init_cache(cfg, b, CACHE_LEN, device="meta")
        ref = runs["layouts"][(arch, mesh)][("cache", b)]
        _check_blocks(ref, meta, cache_shardings(
            MeshSpec(("data", "model"), mesh), meta), mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_per_card_is_the_references(runs, arch):
    """``argument_bytes_per_card`` on the debug mesh equals the sum of the
    reference's shard bytes of params, batch (``_safe_spec``) and cache a
    device, at every shape, at full width."""
    cfg = tconfigs.get_config(arch)
    for name in SHAPES:
        got = tdryrun.argument_bytes_per_card(cfg, tconfigs.get_shape(name),
                                              make_debug_mesh())
        assert got == runs["per_card"][(arch, name)], (arch, name)


def test_dry_run_records_argument_bytes_per_card(tmp_path):
    """A record keeps the whole client's ``argument_bytes`` and adds the
    production mesh's bytes a card, 1/256 of the params and less than the
    whole."""
    rec = tdryrun.run_combo("smollm-135m", "decode_32k", str(tmp_path))
    mem = rec["memory"]
    assert rec["status"] == "ok", rec.get("error")
    cfg, shape = tconfigs.get_config("smollm-135m"), \
        tconfigs.get_shape("decode_32k")
    assert mem["argument_bytes_per_card"] == \
        tdryrun.argument_bytes_per_card(cfg, shape, make_production_mesh())
    assert 0 < mem["argument_bytes_per_card"] < mem["argument_bytes"] / 16


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("mesh", MESHES)
def test_placed_train_step_matches_reference(runs, mesh):
    """2 SGD steps: the params gathered whole and every rank's loss within
    1e-4 of the reference's unsharded ``make_train_step``."""
    ranks, ref = _mesh_ranks(runs, mesh), runs["ref"]
    assert _max_gap(ranks[0]["params"], ref["params"]) <= TOL
    for r in ranks:
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(ref["losses"], abs=TOL)
        assert set(r["metrics"][0]) == {"loss", "xent", "aux", "mtp"}


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_prefill_matches_reference(runs, mesh):
    """The prefill's last-token logits, whole on every rank, and every
    decode step's within 1e-4 of the reference's."""
    for r in _mesh_ranks(runs, mesh):
        got = r["serve"]["logits"].numpy()
        assert got.shape == runs["ref"]["logits"].shape
        assert np.abs(got[0] - runs["ref"]["logits"][0]).max() <= TOL
        assert np.abs(got - runs["ref"]["logits"]).max() <= TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_greedy_decode_tokens_match_reference(runs, mesh):
    for r in _mesh_ranks(runs, mesh):
        assert np.array_equal(r["serve"]["tokens"].numpy(),
                              runs["ref"]["tokens"])


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_steps_match_the_one_rank_port(runs, mesh):
    """The sharded and the one-rank port steps: params, losses and logits
    within 1e-4, tokens equal."""
    ranks, one = _mesh_ranks(runs, mesh), runs["one"]
    assert _max_gap(ranks[0]["params"], one["params"]) <= TOL
    for r in ranks:
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(one["losses"], abs=TOL)
        assert float((r["serve"]["logits"] - one["logits"]).abs().max()) \
            <= TOL
        assert torch.equal(r["serve"]["tokens"], one["tokens"])


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_holds_its_block_after_the_steps(runs, mesh):
    """Each rank's updated blocks are its blocks of the gathered params,
    and its parameter bytes those of its shard shapes."""
    ranks = _mesh_ranks(runs, mesh)
    whole = ranks[0]["params"]
    specs = param_shardings(MeshSpec(("data", "model"), mesh), whole)
    for rank, r in enumerate(ranks):
        pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
        mine = place.shard_tree(whole, specs, pl)
        for a, b in zip(tree_leaves(r["blocks"]), tree_leaves(mine)):
            assert torch.equal(a, b)
        assert r["param_bytes"] == place.tree_shard_bytes(whole, specs, pl)
        assert r["param_bytes"] < r["model_bytes"]


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_cache_blocks_are_the_references(runs, mesh):
    """After the prefill and the decode steps, every rank's cache blocks
    are ``cache_shardings``' blocks of the reference's cache (k and v
    over the data rows and the KV heads at (2, 2), over the head dim at
    (1, 4)) within 1e-4."""
    ref = {g: {k: torch.tensor(v) for k, v in e.items()}
           for g, e in runs["ref"]["cache"].items()}
    for rank, r in enumerate(_mesh_ranks(runs, mesh)):
        pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
        want = place.cache_blocks(ref, pl)
        for a, b in zip(tree_leaves(r["cache"]), tree_leaves(want)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= TOL


def test_plans_split_heads_and_gather_what_they_do_not_follow(runs):
    """(2, 2): 2 query heads over 1 KV head a rank, its cache block its
    compute form. (1, 4): 1 query head a rank and the KV head it reads,
    shared by two ranks, so ``wk`` and ``wv`` (stored a half head a rank)
    are gathered over "model" and their gradients summed over it, and
    the cache (split on the head dim) passes through a gathered copy."""
    cfg = runs["cfg"]
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    for rank in range(4):
        square = tensor_parallel.DensePlan(
            cfg, place.layout(MeshSpec(("data", "model"), (2, 2)), rank),
            shape)
        assert (square.heads, square.kv_heads) == (2, 1)
        assert square._kv_identity()
        assert square.layer_uses["attn"]["wk"].gather == ("data",)
        assert square.layer_uses["attn"]["wk"].sum_axes == ("data",)
        row = tensor_parallel.DensePlan(
            cfg, place.layout(MeshSpec(("data", "model"), (1, 4)), rank),
            shape)
        assert (row.heads, row.kv_heads, row.kv0) == (1, 1, rank // 2)
        assert row.layer_uses["attn"]["wk"].gather == ("model",)
        assert row.layer_uses["attn"]["wk"].sum_axes == ("model",)
        assert row.layer_uses["attn"]["wq"].gather == ()
        assert not row._kv_identity()
    for r in runs["ranks"]:
        assert r[0]["plan"]["attn_split"] and r[0]["plan"]["mlp_split"]


# ---------------------------------------------------------------- refusals

@pytest.fixture
def one_rank_group():
    """A started gloo group of one rank in this process, destroyed
    after."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_world_size_other_than_the_mesh_raises(one_rank_group):
    with pytest.raises(ValueError, match="4 devices, the process group 1"):
        place.make_placement(MeshSpec(("data", "model"), (2, 2)))
    pl = place.make_placement(MeshSpec(("data", "model"), (1, 1)))
    assert pl.coords == {"data": 0, "model": 0}
    assert pl.group("data") is None and pl.group("model") is None


def test_no_started_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="started process group"):
        place.make_placement(MeshSpec(("data", "model"), (1, 1)))


@pytest.mark.parametrize("axes,shape,err", [
    (("data",), (4,), ValueError),
    (("model", "clients"), (2, 2), ValueError),
    (("pod", "data", "model"), (2, 2, 1), NotImplementedError)])
def test_mesh_without_both_axes_raises(axes, shape, err):
    with pytest.raises(err):
        place.layout(MeshSpec(axes, shape), 0)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if tconfigs.get_config(a).family != "dense"
                                  or tconfigs.get_config(a).mla])
def test_other_families_raise_naming_their_item(arch):
    """The MoE family with GQA attention (granite-moe) builds its plan; the
    stub-prefix families (qwen2-vl-2b, musicgen-large) build a
    ``DensePlan`` and the three placed steps
    (``tests/test_torch_placement_stub.py`` runs them); the MLA, SSM and
    hybrid families raise naming D1c."""
    cfg = tconfigs.get_config(arch).reduced()
    pl = place.layout(MeshSpec(("data", "model"), (2, 2)), 0)
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    if cfg.moe and not cfg.mla:
        plan = tensor_parallel.plan_for(cfg, pl, shape)
        assert isinstance(plan, tensor_parallel.MoEPlan)
        assert plan.e_range == (0, cfg.moe.n_experts // 2)
        return
    builds = (lambda: tsteps.make_train_step(
        cfg, tconfigs.TrainConfig(), shape, placement=pl),
              lambda: tsteps.make_prefill_step(cfg, shape, placement=pl),
              lambda: tsteps.make_decode_step(cfg, shape, placement=pl))
    if cfg.family in ("vlm", "audio"):
        plan = tensor_parallel.plan_for(cfg, pl, shape)
        assert type(plan) is tensor_parallel.DensePlan
        assert (plan.heads, plan.attn_split) == (cfg.n_heads // 2, True)
        for build in builds:
            assert type(build().plan) is tensor_parallel.DensePlan
        return
    for build in builds:
        with pytest.raises(NotImplementedError, match="D1c") as err:
            build()
        assert "D1b" not in str(err.value)


def test_steps_without_placement_are_unchanged():
    """``placement=None``: the train step is ``value_and_grad(by_layer=True)``
    and the in-place SGD rule, prefill and decode are the model's, bit for
    bit."""
    cfg = tconfigs.get_config("smollm-135m").reduced()
    p0 = tmodel.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
             for k in ("tokens", "labels")}
    shape = tconfigs.ShapeConfig("t", 16, 2, "train")
    got, metrics = tsteps.make_train_step(
        cfg, tconfigs.TrainConfig(lr=LR), shape, placement=None)(
        copy.deepcopy(p0), batch)
    want = copy.deepcopy(p0)
    loss, _, grads = value_and_grad(want, cfg, batch, by_layer=True)
    _sgd_in_param_dtype_(_layered(want), grads, LR)
    assert float(metrics["loss"]) == float(loss)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    dshape = tconfigs.ShapeConfig("d", 20, 2, "decode")
    logits, pcache = tsteps.make_prefill_step(cfg, dshape)(
        p0, {"tokens": batch["tokens"]})
    l2, c2 = tmodel.prefill(p0, cfg, batch["tokens"])
    assert torch.equal(logits, l2)
    for a, b in zip(tree_leaves(pcache), tree_leaves(c2)):
        assert torch.equal(a, b)
    cache = tmodel.init_cache(cfg, 2, 20, device="cpu")
    for name, c in cache["layers"].items():
        c[:, :, :16] = pcache["layers"][name]
    tok = torch.argmax(logits, -1)[:, None]
    d1, c1 = tsteps.make_decode_step(cfg, dshape, placement=None)(
        p0, copy.deepcopy(cache), {"token": tok, "pos": 16})
    d2, c2 = tmodel.decode(p0, cfg, tok, copy.deepcopy(cache), 16)
    assert torch.equal(d1, d2)
    for a, b in zip(tree_leaves(c1), tree_leaves(c2)):
        assert torch.equal(a, b)
