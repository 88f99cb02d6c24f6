"""The port's step builders and shapes (``repro_torch.launch.steps``,
``repro_torch.configs.shapes``) against the reference's
``launch/steps.py`` and ``configs/shapes.py`` on the CPU: the four shapes,
``effective_window``, ``input_specs``, ``abstract_params`` and
``abstract_cache`` (shapes, dtypes and tree keys for every registered
arch and shape; the port's meta tensors against ``jax.eval_shape``), the
bf16 SGD rule of ``make_train_step`` bit for bit on identical grads, one
``make_train_step`` of reduced chatglm3-6b in bf16 (within ``max(2e-2,
g)``, g the reference's own bf16-vs-fp32 gap), and ``make_prefill_step``,
``make_decode_step`` and ``_per_sequence_loss`` in fp32 (1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain_lib
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = sorted(tconfigs.list_archs())
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
TOL = 1e-4
KERNEL_TOL = 2e-2
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def _struct(tree):
    """{path: (shape, torch dtype)} of a reference tree of
    ShapeDtypeStructs (or arrays)."""
    return {jax.tree_util.keystr(path): (tuple(x.shape),
                                         DTYPES[jnp.dtype(x.dtype)])
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tstruct(tree):
    """The same for a port tree of tensors (meta or not)."""
    return {jax.tree_util.keystr(path): (tuple(x.shape), x.dtype)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_shapes_are_the_references():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES) == SHAPE_NAMES
    for name in SHAPE_NAMES:
        assert dataclasses.asdict(tconfigs.get_shape(name)) == \
            dataclasses.asdict(jconfigs.get_shape(name))
    assert [f.name for f in dataclasses.fields(tconfigs.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ShapeConfig)]
    with pytest.raises(KeyError, match="unknown shape"):
        tconfigs.get_shape("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_input_specs_and_window_match_reference(arch, shape):
    """The counterpart of ``tests/test_system.py::
    test_input_specs_cover_all_shapes``: every input's shape and dtype
    (meta tensors, nothing allocated), and the effective window."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape, tshape = jconfigs.get_shape(shape), tconfigs.get_shape(shape)
    specs = tsteps.input_specs(tcfg, tshape)
    assert specs and all(t.device.type == "meta" for t in specs.values())
    assert _tstruct(specs) == _struct(jsteps.input_specs(jcfg, jshape))
    assert tsteps.effective_window(tcfg, tshape) == \
        jsteps.effective_window(jcfg, jshape)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    """The full-width bf16 tree on the meta device against
    ``jax.eval_shape`` of the reference's ``init_params``: the same keys,
    shapes and dtypes."""
    got = tsteps.abstract_params(tconfigs.get_config(arch))
    assert all(t.device.type == "meta"
               for t in jax.tree.leaves(got))
    assert _tstruct(got) == _struct(
        jsteps.abstract_params(jconfigs.get_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_abstract_cache_matches_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    got = tsteps.abstract_cache(tcfg, tconfigs.get_shape(shape))
    assert _tstruct(got) == _struct(
        jsteps.abstract_cache(jcfg, jconfigs.get_shape(shape)))


def test_abstract_trees_take_fp32():
    cfg = tconfigs.get_config("chatglm3-6b")
    params = tsteps.abstract_params(cfg, torch.float32)
    assert {t.dtype for t in jax.tree.leaves(params)} == {torch.float32}
    assert sum(t.numel() for t in jax.tree.leaves(params)) == 6_243_454_976
    cache = tsteps.abstract_cache(cfg, tconfigs.get_shape("decode_32k"),
                                  torch.float32)
    assert cache["layers"]["k"].shape == (28, 128, 32_768, 2, 128)


def test_bf16_update_is_the_references_arithmetic_bitwise():
    """``make_train_step``'s update given identical grads: the port's
    in-place rule against steps.py:112-115 (lr rounded to bf16, g cast,
    the product rounded, then subtracted), bit for bit; in bf16 it parts
    from the fp32-then-round rule of ``optim.sgd_update_``."""
    from repro_torch.optim import sgd_update_
    rng = np.random.default_rng(0)
    lr = 3e-3
    shapes = [(64, 96), (96,), (3, 40)]
    p = [jnp.asarray(rng.normal(size=s) * 0.05).astype(jnp.bfloat16)
         for s in shapes]
    g = [jnp.asarray(rng.normal(size=s) * 3).astype(jnp.bfloat16)
         for s in shapes]
    want = jax.tree.map(
        lambda p, g: p - jnp.asarray(lr, p.dtype) * g.astype(p.dtype), p, g)

    def torch_leaf(a):
        return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16)

    tp, tg = [torch_leaf(a) for a in p], [torch_leaf(a) for a in g]
    other = [t.clone() for t in tp]
    tsteps._sgd_in_param_dtype_(tp, tg, lr)
    for a, b in zip(tp, want):
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    sgd_update_(other, tg, lr)
    assert any(not torch.equal(a, b) for a, b in zip(tp, other))
    # in fp32 the two rules agree
    p32 = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in shapes]
    g32 = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in shapes]
    a32, b32 = [t.clone() for t in p32], [t.clone() for t in p32]
    tsteps._sgd_in_param_dtype_(a32, g32, lr)
    sgd_update_(b32, g32, lr)
    assert all(torch.equal(x, y) for x, y in zip(a32, b32))


def _train_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def _rel(got, want):
    """||got − want|| / ||want|| over lists of leaves, in float64."""
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    return (num / den) ** 0.5


def test_train_step_bf16_matches_reference():
    """One ``make_train_step`` of reduced chatglm3-6b in bf16 (lr 3e-3,
    remat, B 2 × S 32) against the reference's: loss and updated params
    within ``max(2e-2, g)``, g the reference's own gap between its bf16
    step and its step on the same draws in fp32; the reference's metric
    keys; the params updated in place. A step moves most bf16 params by
    less than half an ulp, so the params alone cannot see a wrong
    gradient; two checks can. The gradients (``value_and_grad``, bf16)
    leaf by leaf against ``jax.grad`` of the reference's loss in bf16,
    in relative norm within ``max(2e-2, 2g)``, g the largest leaf's gap
    between the reference's bf16 and fp32 gradients: two bf16
    computations of one gradient, each about g from its fp32 value. The
    update Δ = new − old against the reference's, in relative norm
    within ``max(2e-2, 2g)``, g the gap between the reference's Δ and
    the Δ its rule gives from its fp32 gradients rounded to bf16. A
    sign-flipped gradient puts Δ 2 away, a half batch's about 1."""
    arch = "chatglm3-6b"
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    shape = dict(name="t", seq_len=32, global_batch=2, mode="train")
    jtrain, ttrain = jconfigs.TrainConfig(lr=3e-3), tconfigs.TrainConfig(
        lr=3e-3)
    assert jtrain.remat and ttrain.remat
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jp32 = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = from_jax_lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks, labels = _train_batch(tcfg, 2, 32)
    jstep = jsteps.make_train_step(jcfg, jtrain,
                                   jconfigs.ShapeConfig(**shape))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jnew, jmet = jstep(jp, jbatch)
    jnew32, jmet32 = jstep(jp32, jbatch)
    tstep = tsteps.make_train_step(tcfg, ttrain,
                                   tconfigs.ShapeConfig(**shape))
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    _, _, tgrads = ttrain_lib.value_and_grad(tp, tcfg, tbatch, remat=True)

    def jgrad(p):
        return jax.grad(lambda q: jmodel.loss_fn(q, jcfg, jbatch,
                                                 remat=True)[0])(p)

    jg, jg32 = jgrad(jp), jgrad(jp32)
    g_grad = max(_rel([a], [b]) for a, b in zip(jax.tree.leaves(jg),
                                                jax.tree.leaves(jg32)))
    d_grad = max(_rel([a.astype(np.float32)], [b]) for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(tgrads)), jax.tree.leaves(jg)))
    assert d_grad <= max(KERNEL_TOL, 2 * g_grad), (d_grad, g_grad)
    old = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp)]
    before = tp["layers"]["attn"]["wq"].clone()
    tnew, tmet = tstep(tp, tbatch)
    assert tnew is tp and not torch.equal(tp["layers"]["attn"]["wq"],
                                          before)
    assert set(tmet) == set(jmet) == {"loss", "xent", "aux", "mtp"}
    g_loss = abs(float(jmet["loss"]) - float(jmet32["loss"]))
    d_loss = abs(float(tmet["loss"]) - float(jmet["loss"]))
    assert d_loss <= max(KERNEL_TOL, g_loss), (d_loss, g_loss)
    got = jax.tree.leaves(lm_params_to_numpy(tnew))
    want = jax.tree.leaves(jnew)
    want32 = jax.tree.leaves(jnew32)
    g = max(float(np.abs(np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)).max())
            for a, b in zip(want, want32))
    d = max(float(np.abs(a.astype(np.float32)
                         - np.asarray(b, np.float32)).max())
            for a, b in zip(got, want))
    assert all(a.dtype == np.asarray(b).dtype for a, b in zip(got, want))
    assert d <= max(KERNEL_TOL, g), (d, g)
    lr = jnp.asarray(jtrain.lr, jnp.bfloat16)
    alt = jax.tree.leaves(jax.tree.map(
        lambda p, g: p - lr * g.astype(p.dtype), jp, jg32))
    j_delta = [np.asarray(b, np.float32) - o for b, o in zip(want, old)]
    alt_delta = [np.asarray(b, np.float32) - o for b, o in zip(alt, old)]
    t_delta = [a.astype(np.float32) - o for a, o in zip(got, old)]
    g_delta = _rel(alt_delta, j_delta)
    d_delta = _rel(t_delta, j_delta)
    assert d_delta <= max(KERNEL_TOL, 2 * g_delta), (d_delta, g_delta)


def test_single_client_bf16_step_is_make_train_steps():
    """``single_client``'s SGD in bf16 is ``make_train_step``'s rule: one
    step of each (remat) from the same bf16 params on the same batch,
    reduced chatglm3-6b, gives the same bits."""
    from repro_torch.data import token_batch_stream
    from repro_torch.models.model import init_params
    tcfg = tconfigs.get_config("chatglm3-6b").reduced()
    p16 = init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                      torch.bfloat16)
    got = ttrain_lib.single_client(tcfg, steps=1, batch=2, seq=16, lr=3e-3,
                                   params=p16, remat=True, device="cpu",
                                   log=lambda s: None)["params"]
    raw = next(token_batch_stream(0, batch=2, seq_len=16, vocab=tcfg.vocab))
    step = tsteps.make_train_step(tcfg, tconfigs.TrainConfig(lr=3e-3),
                                  tconfigs.ShapeConfig("t", 16, 2, "train"))
    want, _ = step(jax.tree.map(torch.clone, p16),
                   {k: torch.from_numpy(v) for k, v in raw.items()})
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(p16)))


_FP32 = {}


def _fp32_weights(arch):
    if arch not in _FP32:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        _FP32[arch] = (jcfg, tcfg, jp, from_jax_lm_params(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _FP32[arch]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b",
                                  "qwen2-vl-2b"])
def test_prefill_step_matches_reference(arch):
    """``make_prefill_step`` at a 12-token prefill shape, fp32: the
    last-token logits and the cache within 1e-4; qwen2-vl also takes its
    stub embeddings and M-RoPE positions through the batch."""
    jcfg, tcfg, jp, tp = _fp32_weights(arch)
    shape = dict(name="p", seq_len=12, global_batch=2, mode="prefill")
    jshape, tshape = (jconfigs.ShapeConfig(**shape),
                      tconfigs.ShapeConfig(**shape))
    specs = tsteps.input_specs(tcfg, tshape, dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)}
    if "stub_embeds" in specs:
        batch["stub_embeds"] = rng.normal(
            size=specs["stub_embeds"].shape).astype(np.float32) * 0.02
    if "positions" in specs:
        n = specs["positions"].shape[0]
        batch["positions"] = np.stack(
            [np.arange(n) // 2, np.arange(n) % 3, np.arange(n)],
            -1).astype(np.int32)
    assert set(batch) == set(specs)
    jlogits, jcache = jsteps.make_prefill_step(jcfg, jshape)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = tsteps.make_prefill_step(tcfg, tshape)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(logits, jlogits)
    for name in ("k", "v"):
        _close(cache["layers"][name], jcache["layers"][name])


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b",
                                  "starcoder2-15b"])
@pytest.mark.parametrize("force", [0, 8])
def test_decode_step_matches_reference(arch, force):
    """``make_decode_step`` at a 40-position decode shape, fp32, with and
    without a forced window of 8 (long_500k's substitution at a small
    size; starcoder2 keeps its own 4096): from the same random cache
    (``abstract_cache``'s shapes), one step at position 39, whose ring
    slot 7 the window wraps to; logits and the written cache within
    1e-4."""
    jcfg, tcfg, jp, tp = _fp32_weights(arch)
    shape = dict(name="d", seq_len=40, global_batch=2, mode="decode",
                 force_sliding_window=force)
    jshape, tshape = (jconfigs.ShapeConfig(**shape),
                      tconfigs.ShapeConfig(**shape))
    # a native window (starcoder2's 4096) wins over a forced one
    assert tsteps.effective_window(tcfg, tshape) == (
        tcfg.sliding_window or force)
    abstract = tsteps.abstract_cache(tcfg, tshape, torch.float32)
    rng = np.random.default_rng(2)
    init = {g: {n: rng.normal(size=t.shape).astype(np.float32)
                for n, t in e.items()} for g, e in abstract.items()}
    token = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
    jlogits, jcache = jsteps.make_decode_step(jcfg, jshape)(
        jp, jax.tree.map(jnp.asarray, init),
        {"token": jnp.asarray(token), "pos": jnp.int32(39)})
    cache = jax.tree.map(torch.from_numpy, init)
    logits, out = tsteps.make_decode_step(tcfg, tshape)(
        tp, cache, {"token": torch.from_numpy(token),
                    "pos": torch.tensor(39, dtype=torch.int32)})
    assert out is cache                       # written in place
    _close(logits, jlogits)
    for name in ("k", "v"):
        _close(out["layers"][name], jcache["layers"][name])


def test_per_sequence_loss_matches_reference():
    jcfg, tcfg, jp, tp = _fp32_weights("smollm-135m")
    toks, labels = _train_batch(tcfg, 3, 20, seed=5)
    labels[1, :7] = -1
    want = jsteps._per_sequence_loss(jp, jcfg, jnp.asarray(toks),
                                     jnp.asarray(labels), 0)
    got = tsteps._per_sequence_loss(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(labels), 0)
    assert got.shape == (3,)
    _close(got, want)
