"""One ``make_train_step`` of the MoE, MLA, SSM, hybrid and stub-prefix
families in bf16 against the reference's on the CPU at ``reduced()``
(granite-moe-3b-a800m, minicpm3-4b, falcon-mamba-7b, zamba2-7b,
qwen2-vl-2b, deepseek-v3-671b): the training half of
``tests/test_torch_bf16_families.py``, whose weights, gates and exactly
compiled reference (:func:`_exact`) it shares, in a file of its own so
that the two halves run on two test workers."""
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
from test_torch_bf16_families import (B, FAMILIES, KERNEL_TOL, _exact, _rel,
                                      _stub, _weights)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_train_step_matches_reference(arch):
    """One ``make_train_step`` of reduced ``arch`` in bf16 (lr 3e-3, remat,
    B 2 × S 32, the stub prefix where the config has one) against the
    reference's, as ``tests/test_torch_steps.py`` holds chatglm3-6b's:
    the loss within ``max(2e-2, g)``; the gradients leaf by leaf in
    relative norm within ``max(2e-2, 2g)``, g the largest leaf's gap
    between the reference's bf16 and fp32 gradients; the update Δ = new −
    old in relative norm within ``max(2e-2, 2g)``, g the gap between the
    reference's Δ and the Δ its rule gives from its fp32 gradients
    rounded to bf16; the params updated in place, in bf16."""
    jcfg, tcfg, jp, jp32, _ = _weights(arch)
    tp = from_jax_lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    S = 32
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    stub = _stub(tcfg, seed=6)
    shape = dict(name="t", seq_len=S, global_batch=B, mode="train")
    jtrain, ttrain = (jconfigs.TrainConfig(lr=3e-3),
                      tconfigs.TrainConfig(lr=3e-3))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    if stub is not None:
        jbatch["stub_embeds"] = jnp.asarray(stub, jnp.bfloat16)
        tbatch["stub_embeds"] = torch.from_numpy(stub).bfloat16()
    jstep = jsteps.make_train_step(jcfg, jtrain,
                                   jconfigs.ShapeConfig(**shape))
    jnew, jmet = _exact(jstep, jp, jbatch)
    jbatch32 = dict(jbatch)
    if stub is not None:
        jbatch32["stub_embeds"] = jnp.asarray(stub, jnp.float32)

    def jgrad(p, b):   # (the step's loss, its gradients)
        return _exact(jax.value_and_grad(lambda q, b_: jmodel.loss_fn(
            q, jcfg, b_, remat=True)[0]), p, b)

    (_, jg), (loss32, jg32) = jgrad(jp, jbatch), jgrad(jp32, jbatch32)
    _, _, tgrads = ttrain_lib.value_and_grad(tp, tcfg, tbatch, remat=True)
    g_grad = max(_rel([a], [b]) for a, b in zip(jax.tree.leaves(jg),
                                                jax.tree.leaves(jg32)))
    gaps = [_rel([a.astype(np.float32)], [b]) for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(tgrads)), jax.tree.leaves(jg))]
    d_grad = max(gaps)
    old = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp)]
    tstep = tsteps.make_train_step(tcfg, ttrain,
                                   tconfigs.ShapeConfig(**shape))
    tnew, tmet = tstep(tp, tbatch)
    g_loss = abs(float(jmet["loss"]) - float(loss32))
    d_loss = abs(float(tmet["loss"]) - float(jmet["loss"]))
    got = jax.tree.leaves(lm_params_to_numpy(tnew))
    want = jax.tree.leaves(jnew)
    lr = jnp.asarray(jtrain.lr, jnp.bfloat16)
    alt = jax.tree.leaves(jax.tree.map(
        lambda p, g: p - lr * g.astype(p.dtype), jp, jg32))
    j_delta = [np.asarray(b, np.float32) - o for b, o in zip(want, old)]
    alt_delta = [np.asarray(b, np.float32) - o for b, o in zip(alt, old)]
    t_delta = [a.astype(np.float32) - o for a, o in zip(got, old)]
    g_delta = _rel(alt_delta, j_delta)
    d_delta = _rel(t_delta, j_delta)
    print(f"{arch}: loss {d_loss:.3g} (g {g_loss:.3g}), gradients "
          f"{d_grad:.3g} (g {g_grad:.3g}), update {d_delta:.3g} (g "
          f"{g_delta:.3g})")
    assert tnew is tp
    assert all(a.dtype == np.asarray(b).dtype for a, b in zip(got, want))
    assert set(tmet) == set(jmet)
    assert d_loss <= max(KERNEL_TOL, g_loss), (d_loss, g_loss)
    assert d_grad <= max(KERNEL_TOL, 2 * g_grad), (d_grad, g_grad)
    assert d_delta <= max(KERNEL_TOL, 2 * g_delta), (d_delta, g_delta)
