"""The MoE family placed within a client (``repro_torch.sharding.
tensor_parallel.MoEPlan``, group-local routing in ``repro_torch.models.
moe``) against the reference on the CPU.

Layer parity: the reference's ``models/moe.py::moe_apply`` and its VJP run
under ``compat.set_mesh`` at (2, 2) and (1, 4) on 8 forced host devices (a
subprocess, ``tests/test_torch_placement.py``'s pattern), on fp32 numpy
weights, at capacity factor 1.0, which drops pairs on (4, 32) tokens.
Under the mesh the reference routes each data rank's rows as a group of
its own with its own capacity, so at (2, 2) its output differs from its
one-group output by O(1). The port's placed MoE layer on 4 gloo ranks
(``sharding.worker.placed_moe_layer``) must match the meshed output and
the input, router and expert gradients within 1e-5; its one-group output
must differ from the (2, 2) output by more than 1e-2, and its one-rank
``moe_apply(groups=2)`` must match it within 1e-5. Two configs: reduced
granite-moe-3b-a800m (4 experts, top 2) and a variant with 6 experts (so
that (1, 4) pads them to 8 and one model rank runs none), one shared
expert and a dense first layer.

Step parity: that variant, replaced alike on both sides, placed over (2, 2)
and (1, 4) in one spawn of 4 gloo ranks: at the reduced config's
drop-free capacity (4.0), 2 SGD steps (params and every rank's loss within
1e-4), the prefill's logits within 1e-4 and 4 greedy tokens equal against
the reference's unsharded steps; at a dropping capacity (0.5), the same
against the one-rank port routed in D groups (``moe.route_groups(D)``),
with pairs dropped. A 3-layer variant puts the shared expert's 2-layer
stack under the expert rule's "model" on its layer axis at (2, 2).

``moe_apply`` at one group is held bit for bit to the code it replaced.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import mlp_apply
from repro_torch.sharding import (default_backend, place, spawn,
                                  tensor_parallel)
from repro_torch.sharding.rules import param_shardings
from repro_torch.sharding.worker import run_placed
from repro_torch.utils.bridge import from_jax_lm_params, tree_leaves

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.abspath(os.path.join(ROOT, "src"))
LAYER_TOL = 1e-5
TOL = 1e-4                   # tests/test_torch_placement.py's
LR = 3e-3
B, S = 4, 32                 # the train batch and the layer's tokens
PROMPT, GEN = (4, 16), 5     # the prefill, then 4 greedy decode steps
MESHES = [(2, 2), (1, 4)]
LAYER_CF, DROP_CF = 1.0, 0.5
DAUX = 0.7                   # the aux loss's cotangent in the layer VJP

# (name, n_layers, MoEConfig overrides) of reduced granite-moe-3b-a800m
VARIANTS = {
    "granite": (2, {}),
    "six": (2, dict(n_experts=6, n_shared_experts=1, first_k_dense=1)),
    "six3": (3, dict(n_experts=6, n_shared_experts=1, first_k_dense=1)),
}


def _variant(configs, name, cf=None):
    n_layers, over = VARIANTS[name]
    cfg = configs.get_config("granite-moe-3b-a800m").reduced()
    if cf is not None:
        over = dict(over, capacity_factor=cf)
    return dataclasses.replace(cfg, n_layers=n_layers,
                               moe=dataclasses.replace(cfg.moe, **over))


# the reference side, in a subprocess with 8 host devices: moe_apply and
# its VJP under set_mesh at each mesh, and without a mesh
_REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import get_config
from repro.models import moe

spec = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, case in spec["layers"].items():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, **case["moe"]))
    params = jax.tree.map(jnp.asarray, case["params"])
    x, dy = jnp.asarray(case["x"]), jnp.asarray(case["dy"])

    def f(p, x):
        return moe.moe_apply(p, cfg, x)

    def run():
        (y, aux), vjp = jax.vjp(jax.jit(f), params, x)
        gp, gx = vjp((dy, jnp.float32(spec["daux"])))
        return jax.tree.map(np.asarray, {"out": y, "aux": aux, "dx": gx,
                                         "grads": gp})

    out[(name, None)] = run()
    for m in spec["meshes"]:
        with compat.set_mesh(compat.make_mesh(m, ("data", "model"))):
            out[(name, m)] = run()
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _reference_serve(cfg, params, prompts, gen):
    """The reference's greedy serve (``test_torch_placement``'s)."""
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
    return np.stack(toks, axis=1), np.stack(all_logits)


def _one_rank(tcfg, params, batch, prompts, groups):
    """The one-rank port routed in ``groups``: serve, then 2 steps."""
    with tmoe.route_groups(groups):
        tp = from_jax_lm_params(params, tcfg, "cpu")
        served = tserve.serve(tcfg, tp, torch.as_tensor(prompts), GEN,
                              device="cpu")
        step = tsteps.make_train_step(
            tcfg, tconfigs.TrainConfig(lr=LR, remat=False),
            tconfigs.ShapeConfig("t", S, B, "train"))
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        losses = []
        for _ in range(2):
            tp, metrics = step(tp, tb)
            losses.append(float(metrics["loss"]))
    return {"params": tp, "losses": losses, "tokens": served.tokens,
            "logits": served.logits}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's meshed MoE layers (subprocess), the port's ranks
    (one spawn of 4 gloo ranks: the layers, then the steps), the
    reference's unsharded steps and the one-rank port's, on the same
    weights, inputs and batch."""
    tmp = tmp_path_factory.mktemp("placement_moe")
    inp, out = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    rng = np.random.default_rng(7)
    layers = {}
    for i, name in enumerate(("granite", "six")):
        jcfg = _variant(jconfigs, name, LAYER_CF)
        p = jax.tree.map(np.asarray, jmoe.moe_init(
            jax.random.PRNGKey(1 + i), jcfg, jnp.float32))
        layers[name] = {
            "moe": dict(VARIANTS[name][1], capacity_factor=LAYER_CF),
            "params": p,
            "x": rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32),
            # the cotangent of a mean over the B·S tokens
            "dy": (rng.standard_normal((B, S, jcfg.d_model))
                   / (B * S)).astype(np.float32)}
    with open(inp, "wb") as f:
        pickle.dump({"layers": layers, "meshes": MESHES, "daux": DAUX}, f)
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")}
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), inp, out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cases, keys = [], []
        for name in ("granite", "six"):
            for m in MESHES:
                cases.append(dict(
                    cfg=_variant(tconfigs, name, LAYER_CF),
                    mesh=MeshSpec(("data", "model"), m),
                    moe_layer=layers[name]["params"], x=layers[name]["x"],
                    dy=layers[name]["dy"], daux=DAUX))
                keys.append(("layer", name, m))
        params, batches = {}, {}
        for name, seed in (("six", 0), ("six3", 2)):
            jcfg = _variant(jconfigs, name)
            params[name] = jax.tree.map(np.asarray, jmodel.init_params(
                jax.random.PRNGKey(seed), jcfg, jnp.float32))
        batch = {k: rng.integers(0, 512, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][1, :7] = -1                  # masked labels
        prompts = rng.integers(0, 512, PROMPT).astype(np.int32)
        steps = [("six", None, m) for m in MESHES] + \
            [("six", DROP_CF, m) for m in MESHES] + \
            [("six3", DROP_CF, (2, 2))]
        for name, cf, m in steps:
            cases.append(dict(cfg=_variant(tconfigs, name, cf),
                              mesh=MeshSpec(("data", "model"), m),
                              params=params[name], batch=batch, steps=2,
                              lr=LR, prompts=prompts, gen=GEN, keep=True,
                              blocks=True))
            keys.append(("step", name, cf, m))
        ranks = spawn(run_placed, 4, default_backend(4, "cpu"), "cpu", cases,
                      "cpu")
        placed = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}

        # the reference's unsharded steps at the drop-free capacity
        jcfg = _variant(jconfigs, "six")
        step = jax.jit(jsteps.make_train_step(
            jcfg, jconfigs.TrainConfig(lr=LR, remat=False),
            jconfigs.ShapeConfig("t", S, B, "train")))
        p, losses = params["six"], []
        for _ in range(2):
            p, metrics = step(p, batch)
            losses.append(float(metrics["loss"]))
        ref = {"params": jax.tree.map(np.asarray, p), "losses": losses}
        ref["tokens"], ref["logits"] = _reference_serve(
            jcfg, params["six"], prompts, GEN)

        # the one-rank port routed in D groups at the dropping capacity
        one = {(name, m): _one_rank(_variant(tconfigs, name, DROP_CF),
                                    params[name], batch, prompts, m[0])
               for name, _, m in steps[2:]}
        stdout, stderr = ref_proc.communicate(timeout=600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, (stdout[-1000:], stderr[-3000:])
    with open(out, "rb") as f:
        meshed = pickle.load(f)
    return {"placed": placed, "meshed": meshed, "layers": layers,
            "ref": ref, "one": one}


def _max_gap(a_tree, b_tree) -> float:
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _torch_layer(params):
    return {k: (torch.tensor(np.array(v)) if not isinstance(v, dict)
                else _torch_layer(v)) for k, v in params.items()}


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["granite", "six"])
def test_placed_moe_layer_matches_reference_under_mesh(runs, name, mesh):
    """Every rank's output, input gradient and params' gradients (router,
    expert stacks, shared expert) within 1e-5 of the reference's
    ``moe_apply`` and VJP under ``set_mesh``; the data ranks' aux shares
    sum to its aux."""
    want = runs["meshed"][(name, mesh)]
    ranks = runs["placed"][("layer", name, mesh)]
    for r in ranks:
        assert np.abs(r["out"].numpy() - want["out"]).max() <= LAYER_TOL
        assert np.abs(r["dx"].numpy() - want["dx"]).max() <= LAYER_TOL
        assert _max_gap(r["grads"], want["grads"]) <= LAYER_TOL
        assert set(r["grads"]) == set(want["grads"])
    D, T = mesh
    aux = sum(r["aux"] for r in ranks[::T])
    assert aux == pytest.approx(float(want["aux"]), abs=1e-9, rel=1e-5)
    assert sum(r["routing"]["dropped"] for r in ranks[::T]) > 0


@pytest.mark.parametrize("name", ["granite", "six"])
def test_one_group_route_is_not_the_references_under_mesh(runs, name):
    """At (2, 2) the reference routes each data rank's rows with their own
    capacity: the port's one-group ``moe_apply`` misses its output by
    more than 1e-2, and ``moe_apply(groups=2)`` on one rank matches it
    within 1e-5 (as does ``route_groups(2)``); at (1, 4) one group is
    the reference's route."""
    layer = runs["layers"][name]
    cfg = _variant(tconfigs, name, LAYER_CF)
    p, x = _torch_layer(layer["params"]), torch.as_tensor(layer["x"])
    one, _ = tmoe.moe_apply(p, cfg, x, groups=1)
    two, _ = tmoe.moe_apply(p, cfg, x, groups=2)
    with tmoe.route_groups(2):
        ctx, _ = tmoe.moe_apply(p, cfg, x)
    square = runs["meshed"][(name, (2, 2))]["out"]
    assert np.abs(one.numpy() - square).max() > 1e-2
    assert np.abs(two.numpy() - square).max() <= LAYER_TOL
    assert torch.equal(ctx, two)
    row = runs["meshed"][(name, (1, 4))]["out"]
    assert np.abs(one.numpy() - row).max() <= LAYER_TOL
    assert np.abs(runs["meshed"][(name, None)]["out"] - row).max() \
        <= LAYER_TOL


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("mesh", MESHES)
def test_placed_moe_train_step_matches_reference(runs, mesh):
    """2 SGD steps of the 6-expert variant (a dense first layer, a shared
    expert, 6 experts over 2 or 4 model ranks) free of drops: the params
    gathered whole and every rank's loss within 1e-4 of the reference's
    unsharded ``make_train_step``; the aux loss is in the loss."""
    ranks, ref = runs["placed"][("step", "six", None, mesh)], runs["ref"]
    assert _max_gap(ranks[0]["params"], ref["params"]) <= TOL
    for r in ranks:
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(ref["losses"], abs=TOL)
        assert all(m["aux"] > 0 and m["loss"] == pytest.approx(
            m["xent"] + m["aux"], abs=1e-6) for m in r["metrics"])
        assert r["routing"]["steps"]["dropped"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_placed_moe_serve_matches_reference(runs, mesh):
    """The prefill's and every decode step's logits within 1e-4 of the
    reference's, and the greedy tokens equal."""
    for r in runs["placed"][("step", "six", None, mesh)]:
        got = r["serve"]["logits"].numpy()
        assert got.shape == runs["ref"]["logits"].shape
        assert np.abs(got - runs["ref"]["logits"]).max() <= TOL
        assert np.array_equal(r["serve"]["tokens"].numpy(),
                              runs["ref"]["tokens"])


@pytest.mark.parametrize("name,mesh", [("six", (2, 2)), ("six", (1, 4)),
                                       ("six3", (2, 2))])
def test_placed_moe_steps_at_a_dropping_capacity(runs, name, mesh):
    """At capacity factor 0.5 (pairs dropped in the steps and the
    prefill on every data rank): params, losses and logits within 1e-4 of
    the one-rank port routed in D groups, the tokens equal."""
    ranks, one = runs["placed"][("step", name, DROP_CF, mesh)], \
        runs["one"][(name, mesh)]
    assert _max_gap(ranks[0]["params"], one["params"]) <= TOL
    for r in ranks:
        assert r["routing"]["steps"]["dropped"] > 0
        assert r["routing"]["serve"]["dropped"] > 0
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(one["losses"], abs=TOL)
        assert float((r["serve"]["logits"] - one["logits"]).abs().max()) \
            <= TOL
        assert torch.equal(r["serve"]["tokens"], one["tokens"])


@pytest.mark.parametrize("key", [("six", None, (2, 2)),
                                 ("six", None, (1, 4)),
                                 ("six3", DROP_CF, (2, 2))])
def test_every_moe_rank_holds_its_blocks_after_the_steps(runs, key):
    """Each rank's updated blocks are its blocks of the gathered params
    (the 3-layer variant's shared expert stored a layer a model rank)."""
    name, cf, mesh = key
    ranks = runs["placed"][("step",) + key]
    whole = ranks[0]["params"]
    specs = param_shardings(MeshSpec(("data", "model"), mesh), whole)
    for rank, r in enumerate(ranks):
        pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
        mine = place.shard_tree(whole, specs, pl)
        for a, b in zip(tree_leaves(r["blocks"]), tree_leaves(mine)):
            assert torch.equal(a, b)
        assert r["param_bytes"] < r["model_bytes"]


# ------------------------------------------------------------- the plans

def _plan(cfg, mesh, rank, batch=B):
    return tensor_parallel.plan_for(
        cfg, place.layout(MeshSpec(("data", "model"), mesh), rank),
        tconfigs.ShapeConfig("t", S, batch, "train"))


@pytest.mark.parametrize("mesh,ranges", [
    ((2, 2), [(0, 3), (3, 6)] * 2),
    ((1, 4), [(0, 2), (2, 4), (4, 6), (6, 6)])])
def test_moe_plan_pads_the_experts_over_model(mesh, ranges):
    """6 experts over T model ranks: padded to a multiple of T, rank t
    runs [t·E'/T, (t+1)·E'/T) ∩ [0, E). At T = 2 the stacks are stored
    over "model" as the rank runs them (gradients summed over "data"); at
    T = 4 they are stored whole on E, each rank slices its range out and
    the frames are summed over "model" too. The router is whole and its
    gradient summed over "data" only; the shared expert's 128 columns
    split over "model"."""
    cfg = _variant(tconfigs, "six")
    for rank, want in enumerate(ranges):
        plan = _plan(cfg, mesh, rank)
        assert isinstance(plan, tensor_parallel.MoEPlan)
        assert plan.e_range == want
        uses = plan.layer_uses["moe"]
        wg = uses["w_gate"]
        lo, hi = want
        if mesh[1] == 2:
            assert wg.spec[0] == "model" and wg.frame[0] == 3
            assert wg.sum_axes == ("data",) and wg.gather == ("data",)
        else:
            assert wg.spec[0] is None and wg.frame[0] == 6
            assert (wg.take[0].start, wg.take[0].stop) == (lo, hi)
            assert wg.sum_axes == ("model",) and wg.gather == ()
        router = uses["router"]
        assert router.take == (slice(0, 256), slice(0, 6))
        assert "model" not in router.sum_axes
        assert plan.shared_split
        sw = uses["shared"]["w_down"]
        assert sw.take[0].stop - sw.take[0].start == 128 // mesh[1]
        assert "mlp" in plan.group_uses["dense_layers"]


def test_moe_plan_gathers_every_data_split_on_every_rank():
    """Whether a leaf is gathered over "data" is the same on every rank,
    even where one rank's block is its compute form (the shared expert's
    ``w_down`` at (2, 2): rank (0, 0)'s data block is its model columns),
    so the ranks make the same collectives."""
    cfg = _variant(tconfigs, "six")
    uses = [_plan(cfg, (2, 2), r).layer_uses["moe"]["shared"]["w_down"]
            for r in range(4)]
    assert all(u.gather == ("data",) for u in uses)


def test_granite_at_full_width_places_40_experts_over_2():
    """granite-moe-3b-a800m on (2, 2): 20 experts a model rank, stored as
    run; 12 query heads over 4 KV heads a rank; routed in one group a
    data rank at B 4 (two where the batch is not split but D divides the
    tokens)."""
    cfg = tconfigs.get_config("granite-moe-3b-a800m")
    for rank in range(4):
        plan = _plan(cfg, (2, 2), rank)
        t = rank % 2
        assert plan.e_range == (20 * t, 20 * t + 20)
        assert (plan.heads, plan.kv_heads) == (12, 4)
        assert plan.layer_uses["moe"]["w_up"].gather == ("data",)
        assert plan.route_groups(512) == 1
        assert "shared" not in plan.layer_uses["moe"]
    unsplit = _plan(cfg, (2, 2), 0, batch=1)
    assert not unsplit.batch_split
    assert unsplit.route_groups(256) == 2 and unsplit.route_groups(1) == 1


def test_deepseek_raises_naming_d1c_only():
    cfg = tconfigs.get_config("deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="D1c") as err:
        tensor_parallel.check_placeable(cfg)
    assert "D1b" not in str(err.value)


# ------------------------------------------- moe_apply at one group

def _moe_apply_one_group(params, cfg, x):
    """``models/moe.py::moe_apply`` as it was before group-local routing
    (one group, one (E, C, D) buffer)."""
    m = cfg.moe
    Bx, Sx, D = x.shape
    T, k, E = Bx * Sx, m.top_k, m.n_experts
    xt = x.reshape(T, D)
    gates, ids, probs = tmoe.router_probs(params["router"], xt, k)
    aux = tmoe.load_balance_loss(probs, ids, E) * m.router_aux_weight
    cap = tmoe.capacity(m, T)
    Tk, pad = T * k, E * cap
    flat_ids = ids.reshape(Tk)
    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    counts = torch.zeros(E, dtype=torch.int64).index_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tk) - starts[s_ids]
    slot = torch.where(pos < cap, s_ids * cap + pos,
                       torch.full_like(pos, pad))
    token_table = torch.full((pad + 1,), T, dtype=torch.int64)
    token_table.scatter_(0, slot, order // k)
    slot_of_pair = torch.empty_like(slot).scatter_(0, order, slot)
    zero = x.new_zeros((1, D))
    packed = torch.cat([xt, zero])[token_table[:pad]].view(E, cap, D)
    h = F.silu(torch.bmm(packed, params["w_gate"])) * torch.bmm(
        packed, params["w_up"])
    y = torch.bmm(h, params["w_down"]).view(pad, D)
    parts = torch.cat([y, zero])[slot_of_pair].view(T, k, D)
    out = torch.einsum("tkd,tk->td", parts, gates.to(parts.dtype))
    if m.n_shared_experts:
        out = out + mlp_apply(params["shared"], xt)
    return out.view(Bx, Sx, D), aux


@pytest.mark.parametrize("cf", [4.0, 0.25])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_moe_apply_at_one_group_is_unchanged_bit_for_bit(arch, cf):
    """At one group (the default, ``groups=1`` and ``route_groups(1)``)
    ``moe_apply``'s output, aux and gradients are the earlier code's bit
    for bit, free of drops and dropping."""
    cfg = tconfigs.get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    gen = torch.Generator().manual_seed(4)
    p = tmoe.moe_init(gen, cfg, "cpu")
    x = torch.randn(3, 20, cfg.d_model, generator=gen)

    def run(fn):
        xs = x.clone().requires_grad_()
        ps = {k: (v.detach().clone().requires_grad_()
                  if torch.is_tensor(v) else v) for k, v in p.items()}
        out, aux = fn(ps, xs)
        grads = torch.autograd.grad(
            (out * out).sum() + 3.0 * aux,
            [xs] + [ps[k] for k in ("router", "w_gate", "w_up", "w_down")])
        return [out.detach(), aux.detach()] + list(grads)

    want = run(lambda ps, xs: _moe_apply_one_group(ps, cfg, xs))
    for fn in (lambda ps, xs: tmoe.moe_apply(ps, cfg, xs),
               lambda ps, xs: tmoe.moe_apply(ps, cfg, xs, groups=1)):
        for a, b in zip(run(fn), want):
            assert torch.equal(a, b)
    with tmoe.route_groups(1):
        for a, b in zip(run(lambda ps, xs: tmoe.moe_apply(ps, cfg, xs)),
                        want):
            assert torch.equal(a, b)
    dropped, pairs, gap = tmoe.routing_stats(p["router"], x, cfg.moe)
    assert pairs == 3 * 20 * cfg.moe.top_k
    assert (int(dropped) > 0) == (cf < 1)
    assert math.isfinite(float(gap))


def test_groups_route_each_run_of_tokens_alone():
    """``groups=G`` is each run of T/G tokens routed by its own call, bit
    for bit; a G that does not divide the tokens routes in one group."""
    cfg = tconfigs.get_config("granite-moe-3b-a800m").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(6)
    p = tmoe.moe_init(gen, cfg, "cpu")
    x = torch.randn(3, 24, cfg.d_model, generator=gen)
    got, _ = tmoe.moe_apply(p, cfg, x, groups=3)
    rows = torch.cat([tmoe.moe_apply(p, cfg, x[i:i + 1])[0]
                      for i in range(3)])
    assert torch.equal(got, rows)
    drops = [int(tmoe.routing_stats(p["router"], x[i:i + 1], cfg.moe)[0])
             for i in range(3)]
    assert int(tmoe.routing_stats(p["router"], x, cfg.moe, 3)[0]) == \
        sum(drops)
    assert tmoe.n_groups(72, 5) == 1 and tmoe.n_groups(72, 3) == 3
    assert torch.equal(tmoe.moe_apply(p, cfg, x, groups=5)[0],
                       tmoe.moe_apply(p, cfg, x)[0])
