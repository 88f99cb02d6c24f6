"""The port's stacked layer groups against the reference on the CPU.

``models/model.py::_stacked_init`` draws a group of n layers in order and
stacks them: one layer is the stack itself, a view with the leading axis
(no second copy, as the reference's ``vmap`` makes only the stack), more
are copied into the stack one by one, each released before the next
draw. The draws are held bit for bit to the rule the port used before
(every layer copied into a fresh stack) at n = 0, 1, 2 and 4.

``launch/train.py::value_and_grad`` gives a leaf that the loss does not
reach zeros of its shape and dtype, as ``jax.value_and_grad`` does: a MoE
config with ``n_layers == first_k_dense`` has an empty ``layers`` group
(``(0, ...)`` leaves in both packages). Reduced deepseek-v3 cut so: the
port's ``value_and_grad`` (with and without ``by_layer``) and one
``make_train_step`` against the reference's, on the reference's fp32
draws carried across the bridge, within 1e-4 (atol and rtol, the LM
tolerance), with the reference's tree structure and zero-size leaves.

``launch/train.py::_sgd_in_param_dtype_`` updates a large leaf in slices
(deepseek-v3's 7 GiB expert leaves): bit for bit its whole-leaf rule."""
import dataclasses
import gc
import weakref

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
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 1e-4
B, S = 2, 16


def _draw(gen):
    """A small layer tree of a few shapes, drawn from ``gen``."""
    return {"w": torch.randn((3, 5), generator=gen),
            "sub": {"b": torch.randn((7,), generator=gen),
                    "m": torch.rand((2, 2, 2), generator=gen)}}


def _stacked_before(n, init):
    """The rule ``_stacked_init`` followed before: every layer copied into
    a fresh stack as drawn."""
    first = init()
    stack = tmodel._map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        layer = first if i == 0 else init()
        tmodel._map(lambda dst, src: dst[i].copy_(src), stack, layer)
        first = None
    return stack


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("n", [0, 1, 2, 4])
def test_stacked_draws_are_those_of_before(n):
    """The same draws, bit for bit, and the generator left in the same
    state, at every group size."""
    g_new, g_old = (torch.Generator().manual_seed(3) for _ in range(2))
    new = tmodel._stacked_init(n, lambda: _draw(g_new))
    old = _stacked_before(n, lambda: _draw(g_old))
    for a, b in zip(_leaves(new), _leaves(old)):
        assert a.shape == b.shape and a.shape[0] == n
        assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=g_new),
                       torch.rand(4, generator=g_old))


def test_one_layer_group_is_the_drawn_layer():
    """At n = 1 the stack shares storage with the drawn layer: a view with
    the leading axis, no second copy."""
    drawn = []

    def init():
        drawn.append(_draw(torch.Generator().manual_seed(5)))
        return drawn[-1]

    stack = tmodel._stacked_init(1, init)
    for s, d in zip(_leaves(stack), _leaves(drawn[0])):
        assert s.shape == (1,) + d.shape
        assert s.data_ptr() == d.data_ptr()
        assert s.untyped_storage().data_ptr() == d.untyped_storage().data_ptr()


def test_at_most_one_layer_beside_the_stack():
    """At n = 4 each drawn layer is released before the next draw: when a
    draw starts, no earlier layer is alive (the rule before held the last
    one through the next draw)."""
    for stacked, want in ((tmodel._stacked_init, 0), (_stacked_before, 1)):
        alive, refs = [], []
        gen = torch.Generator().manual_seed(0)

        def init():
            gc.collect()
            alive.append(sum(r() is not None for r in refs))
            layer = _draw(gen)
            refs.append(weakref.ref(layer["w"]))
            return layer

        stacked(4, init)
        assert max(alive[1:]) == want, (stacked, alive)


def test_init_params_stacks_a_one_layer_moe_group_as_a_view():
    """Reduced deepseek-v3 (one dense layer, one MoE layer): every leaf of
    the one-layer ``layers`` group is a view of the drawn layer."""
    cfg = tconfigs.get_config(ARCH).reduced()
    assert cfg.n_layers - cfg.moe.first_k_dense == 1
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in _leaves(params["layers"]):
        assert leaf.shape[0] == 1 and leaf._base is not None


_WEIGHTS = {}


def _empty_group():
    """(jcfg, tcfg, reference fp32 params, port params): reduced deepseek-v3
    with n_layers cut to its dense prefix, so the MoE ``layers`` group is
    empty; the reference's draws carried across the bridge."""
    if not _WEIGHTS:
        jcfg, tcfg = (dataclasses.replace(
            c, n_layers=c.moe.first_k_dense) for c in (
                jconfigs.get_config(ARCH).reduced(),
                tconfigs.get_config(ARCH).reduced()))
        jp = jax.jit(lambda k: jmodel.init_params(k, jcfg, jnp.float32))(
            jax.random.PRNGKey(0))
        _WEIGHTS.update(jcfg=jcfg, tcfg=tcfg, jp=jp)
    w = _WEIGHTS
    tp = from_jax_lm_params(jax.tree.map(np.asarray, w["jp"]), w["tcfg"],
                            "cpu")
    return w["jcfg"], w["tcfg"], w["jp"], tp


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _restacked(grads, params):
    """``by_layer`` grads with each layer group's list stacked back to
    ``params``' ``(L, ...)`` leaves (zeros of the group's shape when the
    list is empty)."""
    out = dict(grads)
    for group in ("dense_layers", "layers"):
        if group not in grads:
            continue
        layers = grads[group]
        out[group] = (tmodel._map(torch.zeros_like, params[group])
                      if not layers else tmodel._map(
                          lambda *ts: torch.stack(ts), *layers))
    return out


@pytest.mark.parametrize("by_layer", [False, True])
def test_value_and_grad_with_an_empty_moe_group_matches_reference(by_layer):
    """The loss, its metrics and every gradient within 1e-4 of
    ``jax.value_and_grad``'s; the empty group's gradients zero-size leaves
    of its params' shapes and dtype (with ``by_layer`` an empty list), the
    tree the reference's."""
    jcfg, tcfg, jp, tp = _empty_group()
    assert _leaves(tp["layers"])[0].shape[0] == 0
    batch = _batch(tcfg)
    loss, metrics, grads = ttrain.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        by_layer=by_layer)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True))(jp)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL, rtol=TOL)
    for name in ("xent", "aux", "mtp"):
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(jmetrics[name]), atol=TOL, rtol=TOL)
    if by_layer:
        assert grads["layers"] == []
        grads = _restacked(grads, tp)
    for g, p in zip(_leaves(grads), _leaves(tp)):
        assert g.shape == p.shape and g.dtype == p.dtype
    for g in _leaves(grads["layers"]):
        assert g.numel() == 0
    got = lm_params_to_numpy(grads)
    assert jax.tree.structure(got) == jax.tree.structure(jgrads)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)


def test_train_step_with_an_empty_moe_group_matches_reference():
    """One fp32 ``make_train_step`` (SGD, lr 3e-3): the loss and every
    updated param within 1e-4 of the reference's step, the empty group
    left (0, ...)."""
    jcfg, tcfg, jp, tp = _empty_group()
    batch = _batch(tcfg, seed=5)
    shape = dict(name="t", seq_len=S, global_batch=B, mode="train")
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jconfigs.TrainConfig(lr=3e-3), jconfigs.ShapeConfig(**shape)))
    jnew, jmet = jstep(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tsteps.make_train_step(tcfg, tconfigs.TrainConfig(lr=3e-3),
                                   tconfigs.ShapeConfig(**shape))
    tnew, tmet = tstep(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               atol=TOL, rtol=TOL)
    assert _leaves(tnew["layers"])[0].shape[0] == 0
    got = lm_params_to_numpy(tnew)
    assert jax.tree.structure(got) == jax.tree.structure(jnew)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgd_update_in_slices_is_the_whole_leaf_update(monkeypatch, dtype):
    """``_sgd_in_param_dtype_`` updates a leaf of more than ``_SGD_CHUNK``
    elements in slices along its first axis: bit for bit the whole-leaf
    rule (lr rounded to the dtype, lr·g rounded, subtracted), for
    contiguous, transposed and 0-d leaves, slices of one row or several."""
    gen = torch.Generator().manual_seed(7)
    shapes = [(5, 7, 3), (9, 4), (), (11,)]
    params = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    grads = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    params.append(torch.randn((6, 8), generator=gen).to(dtype).t())
    grads.append(torch.randn((8, 6), generator=gen).to(dtype))
    lr = torch.tensor(3e-3, dtype=dtype)
    want = [p - lr * g for p, g in zip(params, grads)]
    for chunk in (1, 7, 20, 1 << 27):
        monkeypatch.setattr(ttrain, "_SGD_CHUNK", chunk)
        got = [p.clone() if p.is_contiguous() else p.t().clone().t()
               for p in params]
        ttrain._sgd_in_param_dtype_(got, grads, 3e-3)
        for a, b in zip(got, want):
            assert torch.equal(a, b), chunk
