"""The stub-prefix families placed within a client (``repro_torch.sharding.
tensor_parallel.DensePlan`` with ``stub_embeds`` and M-RoPE positions),
and the two dense archs not placed before, against the reference on the
CPU.

Four reduced configs, each at meshes (2, 2) and (1, 4), in one spawn of 4
gloo ranks (``sharding.worker.run_placed``):
  - qwen2-vl-2b: H 4 over KH 2, qkv biases, M-RoPE, 8 image patches. Its
    training batch carries explicit positions laid out as
    ``chip_smoke._mrope_layout`` lays them (the patches a 2 x 4 grid tied at
    t = 0, then the text), so the training forward takes K3 by positions;
    its serve takes the default (S_eff, 3) positions. At (1, 4) a KV head is
    shared by two model ranks: ``bk``/``bv`` are sliced from the
    replicated biases and their gradients summed over "model", and the KV
    cache takes the head-dim fallback (KH 2 < T 4).
  - musicgen-large: H 4 over KH 4, no rope, 8 conditioning frames; at
    (1, 4) its serve takes ``serve_placed``'s default prefix (zeros).
  - chatglm3-6b: "rope2d" on half the head, KH 2 (the cache's head-dim
    fallback at T 4).
  - starcoder2-15b with its sliding window cut to 8 on both sides, so that
    the 16-token prompt (and the training forward) wraps the ring.

The stub rows are N(0, 0.02²) and differ row by row, so a stub split wrongly
over "data" shows. Each placed rank is held to the reference's unsharded
``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` (the
prefill after the stub, a cache of n_stub + P + gen positions, decode from
n_stub + P: not the reference's ``serve.main``, which drops the prefill's
cache, ROADMAP C5) and to the one-rank port (``launch/serve.py::serve``
with the same stub, ``launch/steps.py::make_train_step``), all on the same
weights and inputs: 2 SGD steps' params and every rank's loss, the
prefill's and every decode step's logits within 1e-4, the greedy tokens
equal, every rank's cache blocks the reference's ``cache_shardings``
shards of its cache, every rank's blocks its shards of the gathered
params after the steps.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.sharding.rules import batch_spec as jbatch_spec
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshSpec
from repro_torch.sharding import (default_backend, place, spawn,
                                  tensor_parallel)
from repro_torch.sharding.rules import param_shardings
from repro_torch.sharding.worker import run_placed
from repro_torch.utils.bridge import from_jax_lm_params, tree_leaves

torch.set_num_threads(1)

TOL = 1e-4                   # tests/test_torch_placement.py's
LR = 3e-3
B, S = 4, 32                 # the train batch
PROMPT, GEN = (4, 16), 5     # the prefill, then 4 greedy decode steps
MESHES = [(2, 2), (1, 4)]
STAR_WINDOW = 8              # starcoder2-15b's window, cut so 16 tokens wrap
ARCHS = ("qwen2-vl-2b", "musicgen-large", "chatglm3-6b", "starcoder2-15b")
# the cases whose serve takes serve_placed's default prefix (zeros)
DEFAULT_STUB = {("musicgen-large", (1, 4))}
CASES = [(a, m) for a in ARCHS for m in MESHES]


def _configs(arch):
    """(the reference's, the port's) reduced config of ``arch``."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    if arch == "starcoder2-15b":
        jcfg = dataclasses.replace(jcfg, sliding_window=STAR_WINDOW)
        tcfg = dataclasses.replace(tcfg, sliding_window=STAR_WINDOW)
    return jcfg, tcfg


def _mrope_layout(n_stub: int, text: int) -> np.ndarray:
    """qwen2-vl's positions for ``n_stub`` patches (a grid of isqrt(n_stub)
    rows: t 0, h the row, w the column) and then ``text`` tokens from the
    grid's largest side on: (n_stub + text, 3) int32."""
    rows = int(np.sqrt(n_stub))
    cols = n_stub // rows
    i = np.arange(n_stub)
    image = np.stack([np.zeros_like(i), i // cols, i % cols], axis=-1)
    t = np.repeat(np.arange(text)[:, None], 3, axis=1) + max(rows, cols)
    return np.concatenate([image, t]).astype(np.int32)


def _stub(rng, cfg, rows: int) -> np.ndarray:
    return (0.02 * rng.standard_normal(
        (rows, cfg.n_stub_tokens, cfg.d_model))).astype(np.float32)


def _inputs(cfg, seed: int):
    """(train batch, prompts, the prompts' stub or None) in numpy."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][1, :7] = -1                  # masked labels
    batch["labels"][3, -3:] = -1
    stub = None
    if cfg.n_stub_tokens:
        batch["stub_embeds"] = _stub(rng, cfg, B)
        stub = _stub(rng, cfg, PROMPT[0])
    if cfg.rope == "mrope":
        batch["positions"] = _mrope_layout(cfg.n_stub_tokens, S)
    prompts = rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
    return batch, prompts, stub


def _reference_serve(cfg, params, prompts, stub, gen):
    """The reference's greedy serve after the stub prefix: its
    ``make_prefill_step`` on the prompts and ``stub``, the prefill cache
    moved into ``init_cache`` of n_stub + P + gen positions, then
    ``make_decode_step`` from position n_stub + P. Returns (tokens (B,
    gen), logits (gen, B, V), the cache after the last step)."""
    Bp, P = prompts.shape
    start = P + (stub.shape[1] if stub is not None else 0)
    shape = jconfigs.ShapeConfig("d", start + gen, Bp, "decode")
    prefill = jax.jit(jsteps.make_prefill_step(cfg, shape))
    decode = jax.jit(jsteps.make_decode_step(cfg, shape))
    inputs = {"tokens": jnp.asarray(prompts)}
    if stub is not None:
        inputs["stub_embeds"] = jnp.asarray(stub)
    logits, pcache = prefill(params, inputs)
    cache = jmodel.init_cache(cfg, Bp, start + gen, dtype=jnp.float32)
    cache = jax.tree.map(lambda c, p: c.at[:, :, :p.shape[2]].set(p), cache,
                         pcache)
    tok = jnp.argmax(logits, axis=-1)
    toks, all_logits = [tok], [logits]
    for i in range(gen - 1):
        logits, cache = decode(params, cache,
                               {"token": tok[:, None],
                                "pos": jnp.int32(start + i)})
        tok = jnp.argmax(logits, axis=-1)
        toks.append(tok)
        all_logits.append(logits)
    return {"tokens": np.stack(toks, axis=1), "logits": np.stack(all_logits),
            "cache": jax.tree.map(np.asarray, cache)}


def _reference_train(cfg, params, batch):
    """2 SGD steps of the reference's unsharded ``make_train_step``."""
    step = jax.jit(jsteps.make_train_step(
        cfg, jconfigs.TrainConfig(lr=LR, remat=False),
        jconfigs.ShapeConfig("t", S, B, "train")))
    p, losses = params, []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        p, metrics = step(p, jb)
        losses.append(float(metrics["loss"]))
    return {"params": jax.tree.map(np.asarray, p), "losses": losses}


def _one_rank(cfg, params, batch, prompts, stub):
    """The one-rank port on the CPU: ``serve`` (the stub given, or its
    default) and 2 steps of ``make_train_step``."""
    tp = from_jax_lm_params(params, cfg, "cpu")
    served = tserve.serve(cfg, tp, torch.as_tensor(prompts), GEN,
                          device="cpu", stub_embeds=None if stub is None
                          else torch.as_tensor(stub))
    step = tsteps.make_train_step(cfg, tconfigs.TrainConfig(lr=LR,
                                                            remat=False),
                                  tconfigs.ShapeConfig("t", S, B, "train"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        tp, metrics = step(tp, tb)
        losses.append(float(metrics["loss"]))
    return {"params": tp, "losses": losses, "tokens": served.tokens,
            "logits": served.logits}


@pytest.fixture(scope="module")
def runs():
    """The port's ranks for every (arch, mesh) in one spawn of 4 gloo ranks
    (in a thread), and meanwhile the reference's and the one-rank port's
    steps and serves, all on the same weights and inputs."""
    setup, cases = {}, []
    for i, arch in enumerate(ARCHS):
        jcfg, tcfg = _configs(arch)
        params = jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(i), jcfg, jnp.float32))
        batch, prompts, stub = _inputs(tcfg, 10 + i)
        setup[arch] = (jcfg, tcfg, params, batch, prompts, stub)
        for m in MESHES:
            case = dict(cfg=tcfg, mesh=MeshSpec(("data", "model"), m),
                        params=params, batch=batch, steps=2, lr=LR,
                        prompts=prompts, gen=GEN, keep=True, blocks=True)
            if stub is not None and (arch, m) not in DEFAULT_STUB:
                case["stub_embeds"] = stub
            cases.append(case)
    out = {}

    def ranks():
        try:
            out["ranks"] = spawn(run_placed, 4, default_backend(4, "cpu"),
                                 "cpu", cases, "cpu")
        except BaseException as e:        # raised in the test's thread
            out["error"] = e

    worker = threading.Thread(target=ranks)
    worker.start()
    ref, one = {}, {}
    try:
        for arch, (jcfg, tcfg, params, batch, prompts, stub) in setup.items():
            ref[arch] = _reference_train(jcfg, params, batch)
            ref[arch]["serve"] = _reference_serve(jcfg, params, prompts, stub,
                                                  GEN)
            one[arch] = _one_rank(tcfg, params, batch, prompts, stub)
            if stub is not None:          # serve_placed's default prefix
                zeros = np.zeros_like(stub)
                ref[arch]["serve_default"] = _reference_serve(
                    jcfg, params, prompts, zeros, GEN)
                one[arch]["default"] = _one_rank(tcfg, params, batch,
                                                 prompts, None)
    finally:
        worker.join()
    if "error" in out:
        raise out["error"]
    ranks_by_case = {c: [r[i] for r in out["ranks"]]
                     for i, c in enumerate(CASES)}
    return {"ranks": ranks_by_case, "ref": ref, "one": one, "setup": setup}


def _max_gap(a_tree, b_tree) -> float:
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _serve_ref(runs, arch, mesh):
    key = "serve_default" if (arch, mesh) in DEFAULT_STUB else "serve"
    return runs["ref"][arch][key]


# ------------------------------------------------------------------ inputs

@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if tconfigs.get_config(a).n_stub_tokens])
def test_stub_inputs_are_nonzero_and_differ_by_row(runs, arch):
    """The stubs of the train batch and of the prompts are nonzero and no
    two rows are equal; qwen2-vl's positions tie the patches at t = 0."""
    _, cfg, _, batch, _, stub = runs["setup"][arch]
    for x in (batch["stub_embeds"], stub):
        assert (x != 0).all()
        flat = x.reshape(x.shape[0], -1)
        for i in range(len(flat)):
            for j in range(i):
                assert np.abs(flat[i] - flat[j]).max() > 1e-3
    if cfg.rope == "mrope":
        pos = batch["positions"]
        assert pos.shape == (cfg.n_stub_tokens + S, 3)
        assert (pos[:cfg.n_stub_tokens, 0] == 0).all()
        assert (np.diff(pos[cfg.n_stub_tokens:, 0]) == 1).all()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_input_specs_place_as_the_references(arch, mode):
    """``place.batch_specs`` of ``launch/steps.py::input_specs`` under a
    placement: the reference's ``batch_spec`` of each input (the stub's
    batch dim over "data" with the tokens, positions and ``pos``
    replicated), an axis that does not divide its dim dropped."""
    cfg = tconfigs.get_config(arch)
    for m in MESHES:
        pl = place.layout(MeshSpec(("data", "model"), m), 0)
        for batch in (4, 1):
            shape = tconfigs.ShapeConfig("s", 64, batch, mode)
            specs = place.batch_specs(tsteps.input_specs(cfg, shape), pl)
            want = {"train": {"tokens", "labels"}, "prefill": {"tokens"},
                    "decode": {"token", "pos"}}[mode]
            if mode != "decode":
                want |= {"stub_embeds"} | ({"positions"} if cfg.rope ==
                                           "mrope" else set())
            assert set(specs) == want
            for name, spec in specs.items():
                ndim = len(spec)
                ref = tuple(jbatch_spec(name, ndim)) + (None,) * ndim
                ref = tuple(None if e == "data" and batch % m[0] else e
                            for e in ref[:ndim])
                assert spec == ref, (name, spec, ref)
                if name == "stub_embeds":
                    assert spec[0] == ("data" if batch % m[0] == 0
                                       else None)


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("arch,mesh", CASES)
def test_placed_train_step_matches_reference(runs, arch, mesh):
    """2 SGD steps on the stub batch: the params gathered whole (the qkv
    biases among them) and every rank's loss within 1e-4 of the
    reference's unsharded ``make_train_step``."""
    ranks, ref = runs["ranks"][(arch, mesh)], runs["ref"][arch]
    assert _max_gap(ranks[0]["params"], ref["params"]) <= TOL
    for r in ranks:
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(ref["losses"], abs=TOL)
    if arch == "qwen2-vl-2b":
        assert "bk" in ranks[0]["params"]["layers"]["attn"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_placed_serve_matches_reference(runs, arch, mesh):
    """The prefill's last-token logits after the stub, whole on every rank,
    and every decode step's within 1e-4 of the reference's; the greedy
    tokens equal."""
    want = _serve_ref(runs, arch, mesh)
    for r in runs["ranks"][(arch, mesh)]:
        got = r["serve"]["logits"].numpy()
        assert got.shape == want["logits"].shape
        assert np.abs(got[0] - want["logits"][0]).max() <= TOL
        assert np.abs(got - want["logits"]).max() <= TOL
        assert np.array_equal(r["serve"]["tokens"].numpy(), want["tokens"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_placed_steps_match_the_one_rank_port(runs, arch, mesh):
    """The sharded and the one-rank port steps and serves: params, losses
    and logits within 1e-4, tokens equal."""
    one = runs["one"][arch]
    serve_one = one["default"] if (arch, mesh) in DEFAULT_STUB else one
    ranks = runs["ranks"][(arch, mesh)]
    assert _max_gap(ranks[0]["params"], one["params"]) <= TOL
    for r in ranks:
        assert [m["loss"] for m in r["metrics"]] == \
            pytest.approx(one["losses"], abs=TOL)
        assert float((r["serve"]["logits"] - serve_one["logits"]).abs()
                     .max()) <= TOL
        assert torch.equal(r["serve"]["tokens"], serve_one["tokens"])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_placed_cache_blocks_are_the_references(runs, arch, mesh):
    """After the prefill and the decode steps, every rank's cache blocks are
    ``cache_shardings``' blocks of the reference's cache of n_stub + P +
    gen positions (a ring of the window's slots for starcoder2-15b) within
    1e-4."""
    _, cfg, *_ = runs["setup"][arch]
    want_cache = _serve_ref(runs, arch, mesh)["cache"]
    ref = {g: {k: torch.tensor(v) for k, v in e.items()}
           for g, e in want_cache.items()}
    n = cfg.n_stub_tokens + PROMPT[1] + GEN
    slots = min(n, cfg.sliding_window) if cfg.sliding_window else n
    assert ref["layers"]["k"].shape[2] == slots
    for rank, r in enumerate(runs["ranks"][(arch, mesh)]):
        pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
        want = place.cache_blocks(ref, pl)
        for a, b in zip(tree_leaves(r["cache"]), tree_leaves(want)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= TOL


@pytest.mark.parametrize("arch,mesh", CASES)
def test_every_rank_holds_its_block_after_the_steps(runs, arch, mesh):
    """Each rank's updated blocks are its blocks of the gathered params, and
    its parameter bytes those of its shard shapes."""
    ranks = runs["ranks"][(arch, mesh)]
    whole = ranks[0]["params"]
    specs = param_shardings(MeshSpec(("data", "model"), mesh), whole)
    for rank, r in enumerate(ranks):
        pl = place.layout(MeshSpec(("data", "model"), mesh), rank)
        mine = place.shard_tree(whole, specs, pl)
        for a, b in zip(tree_leaves(r["blocks"]), tree_leaves(mine)):
            assert torch.equal(a, b)
        assert r["param_bytes"] == place.tree_shard_bytes(whole, specs, pl)
        assert r["param_bytes"] < r["model_bytes"]


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "chatglm3-6b"])
def test_shared_kv_heads_take_the_fallbacks(runs, arch):
    """(1, 4), KH 2 over 4 model ranks: 1 query head a rank over the KV head
    it shares with its neighbour, ``wk``/``wv`` (and qwen2-vl's ``bk``/
    ``bv``, replicated and sliced) gathered or sliced and their gradients
    summed over "model", the cache split on the head dim (not the
    compute's split); (2, 2): 2 query heads over 1 KV head a rank, the
    cache block the compute form, ``bq`` summed over both axes."""
    _, cfg, *_ = runs["setup"][arch]
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    for rank in range(4):
        row = tensor_parallel.DensePlan(
            cfg, place.layout(MeshSpec(("data", "model"), (1, 4)), rank),
            shape)
        assert (row.heads, row.kv_heads, row.kv0) == (1, 1, rank // 2)
        assert row.kv_spec[2:] == (None, "model")
        assert not row._kv_identity()
        attn = row.layer_uses["attn"]
        assert attn["wk"].sum_axes == ("model",)
        square = tensor_parallel.DensePlan(
            cfg, place.layout(MeshSpec(("data", "model"), (2, 2)), rank),
            shape)
        assert (square.heads, square.kv_heads) == (2, 1)
        assert square._kv_identity()
        if cfg.qkv_bias:
            for name in ("bk", "bv"):
                assert attn[name].spec == (None,)
                assert attn[name].sum_axes == ("model",)
                assert attn[name].take == (slice(64 * (rank // 2),
                                                 64 * (rank // 2 + 1)),)
            assert square.layer_uses["attn"]["bq"].sum_axes == \
                ("data", "model")
    for m in MESHES:
        for r in runs["ranks"][(arch, m)]:
            assert r["plan"]["attn_split"] and r["plan"]["mlp_split"]


def test_musicgen_splits_whole_heads(runs):
    """musicgen-large (G 1): 2 heads a rank over their own 2 KV heads at
    (2, 2), 1 over 1 at (1, 4); its cache is split over the KV heads as
    the compute splits them."""
    for m, h in (((2, 2), 2), ((1, 4), 1)):
        for r in runs["ranks"][("musicgen-large", m)]:
            assert (r["plan"]["heads"], r["plan"]["kv_heads"]) == (h, h)
    cfg = runs["setup"]["musicgen-large"][1]
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    for m in MESHES:
        plan = tensor_parallel.DensePlan(
            cfg, place.layout(MeshSpec(("data", "model"), m), 1), shape)
        assert plan._kv_identity()
