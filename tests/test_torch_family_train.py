"""Training the MoE, MLA, SSM and hybrid families through the port's
trainer (``repro_torch.launch.train.single_client``) against the reference
on the CPU: granite-moe-3b-a800m, deepseek-v3-671b (MLA at K3's head dim
48, a dense layer, a shared expert, the MTP head), minicpm3-4b (MLA),
falcon-mamba-7b (Mamba1) and zamba2-7b (Mamba2 and the shared attention
block), each at ``reduced()``, with the reference's ``init_params`` weights
carried across and the same token batches. Also the in-place SGD step the
trainer takes (the bits of ``sgd_update``), its ``remat`` switch and its
per-layer gradient buffers (the bits of autograd through ``unbind``).
Tolerances:
  - 3 SGD steps against the reference's loop (``value_and_grad`` of
    ``loss_fn``, then ``sgd_update``): losses and params 1e-4 (the card's
    phase 7b gate);
  - ``remat=True`` against ``remat=False``: losses and params 1e-5;
  - the in-place step against ``sgd_update``, ``value_and_grad`` against
    ``torch.autograd.grad`` over the stacked params: bit for bit.
The card's runs of the same configs against the CPU are in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 7f."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data import token_batch_stream as jstream
from repro.models import model as jmodel
from repro_torch import optim as toptim
from repro_torch.configs import get_config as tget_config
from repro_torch.data import token_batch_stream as tstream
from repro_torch.launch import train as ttrain
from repro_torch.models.model import init_params, loss_fn
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b", "minicpm3-4b",
         "falcon-mamba-7b", "zamba2-7b"]
BATCH, SEQ, LR, STEPS = 2, 32, 3e-3, 3
TOL, REMAT_TOL = 1e-4, 1e-5

_WEIGHTS = {}


def _weights(arch):
    """(reference cfg, port cfg, reference params as numpy), reduced."""
    if arch not in _WEIGHTS:
        jcfg = jget_config(arch).reduced()
        jp = jax.jit(lambda key: jmodel.init_params(key, jcfg, jnp.float32))(
            jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jcfg, tget_config(arch).reduced(),
                          jax.tree.map(np.asarray, jp))
    return _WEIGHTS[arch]


def _port(arch):
    _, tcfg, jp = _weights(arch)
    return from_jax_lm_params(jp, tcfg, "cpu")


def _run(arch, **kw):
    return ttrain.single_client(_weights(arch)[1], steps=STEPS, batch=BATCH,
                                seq=SEQ, lr=LR, params=_port(arch),
                                device="cpu", log=lambda s: None, **kw)


def _close_tree(got, want, tol):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_single_client_steps_match_reference(arch):
    """3 SGD steps of the port's trainer against the reference's
    ``single_client`` loop (its ``loss_fn`` under ``jax.value_and_grad``,
    ``remat=False``, then ``sgd_update``) on ``token_batch_stream(0)``."""
    jcfg, _, jp = _weights(arch)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b, remat=False)[0]))
    params, losses = jax.tree.map(jnp.asarray, jp), []
    for _, raw in zip(range(STEPS), jstream(0, batch=BATCH, seq_len=SEQ,
                                            vocab=jcfg.vocab)):
        loss, grads = vg(params, {k: jnp.asarray(v) for k, v in raw.items()})
        params = joptim.sgd_update(params, grads, LR)
        losses.append(float(loss))
    got = _run(arch)
    np.testing.assert_allclose(got["losses"], losses, atol=TOL, rtol=TOL)
    _close_tree(lm_params_to_numpy(got["params"]), params, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_single_client_remat_matches_plain(arch):
    """``remat=True`` recomputes each layer in the backward: the same
    losses and params as without it."""
    plain, remat = _run(arch), _run(arch, remat=True)
    np.testing.assert_allclose(remat["losses"], plain["losses"],
                               atol=REMAT_TOL, rtol=REMAT_TOL)
    for a, b in zip(tree_flatten(remat["params"])[0],
                    tree_flatten(plain["params"])[0]):
        torch.testing.assert_close(a, b, atol=REMAT_TOL, rtol=REMAT_TOL)


def test_single_client_leaves_given_params_as_they_are():
    """The trainer steps a copy of the params it is given, in place."""
    arch = "granite-moe-3b-a800m"
    given = _port(arch)
    before = [x.clone() for x in tree_flatten(given)[0]]
    got = ttrain.single_client(_weights(arch)[1], steps=1, batch=BATCH,
                               seq=SEQ, lr=LR, params=given, device="cpu",
                               log=lambda s: None)
    for x, y, z in zip(tree_flatten(given)[0], before,
                       tree_flatten(got["params"])[0]):
        assert torch.equal(x, y) and z is not x
    assert any(not torch.equal(x, z) for x, z in zip(
        tree_flatten(given)[0], tree_flatten(got["params"])[0]))


def _trees(seed, pdtype, gdtype):
    g = torch.Generator().manual_seed(seed)
    mk = lambda dt: {"a": torch.randn((5, 3), generator=g).to(dt),
                     "b": [torch.randn(1000, generator=g).to(dt),
                           torch.randn((2, 2, 2), generator=g).to(dt)]}
    return mk(pdtype), [mk(gdtype) for _ in range(3)]


def _clone(tree):
    return tree_map(torch.clone, tree)


@pytest.mark.parametrize("pdtype,gdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("lr", [3e-3, torch.tensor(3e-3), 0.1])
def test_sgd_update_in_place_gives_the_functional_bits(pdtype, gdtype, lr):
    """``sgd_update_``, the reference optimizer's rule in place, writes
    ``sgd_update``'s bits into the params it is given, over 3 steps, in
    each param dtype."""
    params, grads = _trees(0, pdtype, gdtype)
    want, got = params, _clone(params)
    for g in grads:
        want = toptim.sgd_update(want, g, lr)
        before = tree_flatten(got)[0]
        got = toptim.sgd_update_(got, g, lr)
        assert all(x is y for x, y in zip(tree_flatten(got)[0], before))
    for a, b in zip(tree_flatten(want)[0], tree_flatten(got)[0]):
        assert a.dtype == b.dtype == pdtype and torch.equal(a, b)


def _autograd_grads(params, cfg, batch, remat):
    """``loss_fn``'s gradients through ``torch.autograd.grad`` over the
    params as they are stored (stacked layers differentiated through
    ``unbind``)."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = loss_fn(tree_unflatten(leaves, spec), cfg, batch, remat=remat)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS + ["smollm-135m"])
@pytest.mark.parametrize("remat", [False, True])
def test_layer_by_layer_grads_and_step_give_the_stacked_bits(arch, remat):
    """``value_and_grad(by_layer=True)``'s per-layer gradients are, bit for
    bit, the slices of what autograd gives through the stacked layers'
    ``unbind``, and the trainer's update over ``_layered(params)``
    (``_sgd_in_param_dtype_``, fp32) writes ``sgd_update``'s bits on the
    stacked gradients."""
    cfg = tget_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    raw = next(tstream(0, batch=BATCH, seq_len=16, vocab=cfg.vocab))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    want_loss, want = _autograd_grads(params, cfg, batch, remat)
    loss, _, stacked = ttrain.value_and_grad(params, cfg, batch, remat=remat)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_flatten(stacked)[0], want))
    loss, _, layered = ttrain.value_and_grad(params, cfg, batch,
                                             remat=remat, by_layer=True)
    assert torch.equal(loss, want_loss)
    restacked = {k: tree_map(lambda *xs: torch.stack(xs), *g)
                 if isinstance(g, list) else g for k, g in layered.items()}
    got, spec = tree_flatten(restacked)
    assert spec == tree_flatten(params)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    new = _clone(params)
    ttrain._sgd_in_param_dtype_(ttrain._layered(new), layered, LR)
    for a, b in zip(tree_flatten(new)[0], tree_flatten(
            toptim.sgd_update(params, stacked, LR))[0]):
        assert torch.equal(a, b)
