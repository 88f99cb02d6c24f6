"""deepseek-v3-671b's MLA at its published head dims against the reference
on the CPU: ``reduced()`` (2 layers, the first dense, 4 heads, 4 experts,
the shared expert and the MTP head) with qk_nope 128, qk_rope 64 and v 128
restored, so that K3 runs at deepseek-v3's full-width head dim 192 (v
zero-padded from 128 to 192 in ``_mla_attend``). The reference's fp32
``init_params`` draws go through the bridge, and both sides get the same
numpy inputs.

Gates: fp32 prefill and decode logits, ``loss_fn`` (with and without
explicit positions) and its gradients within 1e-4 (atol and rtol, the LM
tolerance); bf16 as ``tests/test_torch_bf16_families.py`` (whose exactly
compiled reference, :func:`_exact`, this file shares): logits and loss
within ``max(2e-2, g)``, gradients and the update Δ in relative norm within
``max(2e-2, 2g)``, g the reference's own bf16-vs-fp32 gap. Then K3's plain
backward at Dh 192 and with explicit positions at 48, 96, 112 and 192
against ``jax.vjp`` of the reference's ``chunked_attention``, and
``_check_backward``: both dtypes train at 192, with positions or without,
and a head dim no kernel takes still raises in each dtype."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain_lib
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy
from test_torch_bf16_families import (B, GEN, KERNEL_TOL, P, _exact,
                                      _port_run, _reference_run, _rel)

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 1e-4                       # fp32 against the reference
MLA_DIMS = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)

_WEIGHTS = {}


def _cfg(pkg):
    """``pkg``'s reduced deepseek-v3 with the published MLA head dims."""
    cfg = pkg.get_config(ARCH).reduced()
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla,
                                                            **MLA_DIMS))


def _weights():
    """(jcfg, tcfg, reference fp32 params, reference bf16 params (the fp32
    draws cast leaf by leaf to the reference's dtypes), port fp32 params,
    port bf16 params), both carried across the bridge."""
    if not _WEIGHTS:
        jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
        key = jax.random.PRNGKey(0)
        jp32 = jax.jit(lambda k: jmodel.init_params(k, jcfg, jnp.float32))(
            key)
        jp16 = jax.tree.map(lambda s, x: x.astype(s.dtype),
                            jax.eval_shape(lambda: jmodel.init_params(
                                key, jcfg)), jp32)
        _WEIGHTS.update(jcfg=jcfg, tcfg=tcfg, jp32=jp32, jp16=jp16)
    w = _WEIGHTS
    return (w["jcfg"], w["tcfg"], w["jp32"], w["jp16"],
            from_jax_lm_params(jax.tree.map(np.asarray, w["jp32"]),
                               w["tcfg"], "cpu"),
            from_jax_lm_params(jax.tree.map(np.asarray, w["jp16"]),
                               w["tcfg"], "cpu"))


def _batch(cfg, S, positions, seed=6):
    """tokens and labels (B, S), and with ``positions`` "offset" explicit
    positions 3..S+2 (the reference's ``batch["positions"]``, which K3
    then masks by)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if positions == "offset":
        batch["positions"] = np.arange(3, S + 3, dtype=np.int32)
    return batch


def test_config_keeps_the_published_mla_head_dims():
    """Both packages' configs agree field by field, and K3's head dim is
    deepseek-v3's full-width 192 (qk_nope 128 + qk_rope 64; v 128 padded
    to it), which the card's forward and both dtypes' backwards take."""
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    full = tconfigs.get_config(ARCH).mla
    assert dataclasses.asdict(tcfg.mla) == {
        **dataclasses.asdict(tcfg.mla),
        **{k: getattr(full, k) for k in MLA_DIMS}}
    dh = tcfg.mla.qk_nope_head_dim + tcfg.mla.qk_rope_head_dim
    assert dh == 192
    assert dh in k3.FWD_HEAD_DIMS and dh in k3.BWD_BF16_HEAD_DIMS
    assert dh in k3.BWD_HEAD_DIMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """A 13-token prefill and 4 teacher-forced decode steps (the absorbed
    MLA decode, ``dense_layers`` first): fp32 within 1e-4 of the
    reference's logits, bf16 within ``max(2e-2, g)`` of its bf16 run."""
    jcfg, tcfg, jp32, jp16, tp32, tp16 = _weights()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (B, P))
    feed = rng.integers(0, tcfg.vocab, (B, GEN))
    max_len = P + GEN
    ref32 = _reference_run(jp32, jcfg, toks, None, max_len, jnp.float32,
                           feed)
    if dtype == "float32":
        got = _port_run(tp32, tcfg, toks, None, max_len, feed)
        d = float(np.abs(got - ref32).max())
        print(f"fp32: port vs reference {d:.3g}")
        np.testing.assert_allclose(got, ref32, atol=TOL, rtol=TOL)
        return
    ref = _reference_run(jp16, jcfg, toks, None, max_len, jnp.bfloat16,
                         feed)
    got = _port_run(tp16, tcfg, toks, None, max_len, feed)
    g = float(np.abs(ref - ref32).max())
    d = float(np.abs(got - ref).max())
    print(f"bf16: port vs reference {d:.4g}, the reference's bf16 vs fp32 "
          f"{g:.4g}")
    assert np.isfinite(got).all()
    assert d <= max(KERNEL_TOL, g), (d, g)


@pytest.mark.parametrize("positions", [None, "offset"])
def test_fp32_loss_and_grads_match_reference(positions):
    """``loss_fn`` (xent + 0.3 · mtp + aux) and its metrics and gradients
    in fp32 against ``jax.value_and_grad`` of the reference's, within
    1e-4; with explicit positions too, which K3 then masks by (its
    position path)."""
    jcfg, tcfg, jp32, _, tp32, _ = _weights()
    batch = _batch(tcfg, 24, positions)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp32,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    loss, metrics = tmodel.loss_fn(
        params, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True))(jp32)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL,
                               rtol=TOL)
    for name in ("xent", "aux", "mtp"):
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(jmetrics[name]), atol=TOL,
                                   rtol=TOL)
    grads = lm_params_to_numpy(jax.tree.map(
        lambda t: t.grad, params,
        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    worst = 0.0
    for got, want in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads)):
        worst = max(worst, float(np.abs(got - np.asarray(want)).max()))
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL,
                                   rtol=TOL)
    print(f"positions {positions}: loss {float(loss.detach()):.6g}, "
          f"max|dgrad| "
          f"{worst:.3g}")


@pytest.mark.parametrize("positions", [None, "offset"])
def test_bf16_train_step_matches_reference(positions):
    """One ``make_train_step`` in bf16 (lr 3e-3, remat, B 2 x S 32; with
    explicit positions too) against the reference's, as
    ``tests/test_torch_bf16_family_steps.py`` holds the families': the
    loss within ``max(2e-2, g)``; the gradients leaf by leaf in relative
    norm within ``max(2e-2, 2g)``, g the largest leaf's gap between the
    reference's bf16 and fp32 gradients; the update Δ in relative norm
    within ``max(2e-2, 2g)``, g the gap between the reference's Δ and the
    Δ its rule gives from its fp32 gradients rounded to bf16."""
    jcfg, tcfg, jp32, jp16, _, tp16 = _weights()
    S = 32
    batch = _batch(tcfg, S, positions, seed=1)
    shape = dict(name="t", seq_len=S, global_batch=B, mode="train")
    jtrain, ttrain = (jconfigs.TrainConfig(lr=3e-3),
                      tconfigs.TrainConfig(lr=3e-3))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstep = jsteps.make_train_step(jcfg, jtrain,
                                   jconfigs.ShapeConfig(**shape))
    jnew, jmet = _exact(jstep, jp16, jbatch)

    def jgrad(p):   # (the step's loss, its gradients)
        return _exact(jax.value_and_grad(lambda q, b_: jmodel.loss_fn(
            q, jcfg, b_, remat=True)[0]), p, jbatch)

    (_, jg), (loss32, jg32) = jgrad(jp16), jgrad(jp32)
    _, _, tgrads = ttrain_lib.value_and_grad(tp16, tcfg, tbatch, remat=True)
    g_grad = max(_rel([a], [b]) for a, b in zip(jax.tree.leaves(jg),
                                                jax.tree.leaves(jg32)))
    d_grad = max(_rel([a.astype(np.float32)], [b]) for a, b in zip(
        jax.tree.leaves(lm_params_to_numpy(tgrads)), jax.tree.leaves(jg)))
    old = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp16)]
    tstep = tsteps.make_train_step(tcfg, ttrain,
                                   tconfigs.ShapeConfig(**shape))
    tnew, tmet = tstep(tp16, tbatch)
    g_loss = abs(float(jmet["loss"]) - float(loss32))
    d_loss = abs(float(tmet["loss"]) - float(jmet["loss"]))
    want = jax.tree.leaves(jnew)
    lr = jnp.asarray(jtrain.lr, jnp.bfloat16)
    alt = jax.tree.leaves(jax.tree.map(
        lambda p, g: p - lr * g.astype(p.dtype), jp16, jg32))
    j_delta = [np.asarray(b, np.float32) - o for b, o in zip(want, old)]
    alt_delta = [np.asarray(b, np.float32) - o for b, o in zip(alt, old)]
    t_delta = [a.astype(np.float32) - o for a, o in zip(
        jax.tree.leaves(lm_params_to_numpy(tnew)), old)]
    g_delta = _rel(alt_delta, j_delta)
    d_delta = _rel(t_delta, j_delta)
    print(f"positions {positions}: loss {d_loss:.3g} (g {g_loss:.3g}), "
          f"gradients {d_grad:.3g} (g {g_grad:.3g}), update {d_delta:.3g} "
          f"(g {g_delta:.3g})")
    assert tnew is tp16
    assert d_loss <= max(KERNEL_TOL, g_loss), (d_loss, g_loss)
    assert d_grad <= max(KERNEL_TOL, 2 * g_grad), (d_grad, g_grad)
    assert d_delta <= max(KERNEL_TOL, 2 * g_delta), (d_delta, g_delta)


def _tied(n, n_tied=16):
    """M-RoPE's temporal pattern: the first ``n_tied`` at 0, then counting
    on from 2."""
    return np.concatenate([np.zeros(n_tied, np.int32),
                           np.arange(n - n_tied, dtype=np.int32) + 2])


# (B, Sq, Skv, H, KH, Dh), causal, window, positions: Dh 192 by index
# (G 1 as MLA gives it, and G 2), ragged with a window; explicit positions
# at MLA's and zamba2's head dims (48, 96, 112) and at 192, tied
# (M-RoPE's pattern), windowed
BWD_CASES = [((2, 40, 40, 4, 4, 192), True, 0, None),
             ((1, 30, 41, 4, 2, 192), True, 8, None),
             ((2, 48, 48, 4, 4, 48), True, 0, "tied"),
             ((1, 40, 40, 4, 4, 96), True, 12, "tied"),
             ((1, 40, 40, 4, 2, 112), True, 0, "offset"),
             ((1, 40, 40, 4, 4, 192), True, 16, "tied")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window,positions", BWD_CASES)
def test_plain_backward_matches_reference(shape, causal, window, positions,
                                          dtype):
    """K3's plain backward (the CPU route: autograd through the plain
    forward, recomputed) against ``jax.vjp`` of ``chunked_attention``:
    fp32 within 1e-4, bf16 within 2e-2 (atol and rtol), where the plain
    version of the bf16 kernels' arithmetic
    (``flash_attention_bwd_bf16_ref``) also holds, its max error against
    the float64 backward of the same bf16 values at most twice the
    reference's own."""
    B_, Sq, Skv, H, KH, Dh = shape
    rng = np.random.default_rng(Dh + Sq)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((B_, Sq, H, Dh), (B_, Skv, KH, Dh),
                             (B_, Skv, KH, Dh), (B_, Sq, H, Dh)))
    qpos = (np.arange(Sq, dtype=np.int32) if positions is None
            else _tied(Sq) if positions == "tied"
            else np.arange(3, Sq + 3, dtype=np.int32))
    kpos = (np.arange(Skv, dtype=np.int32) if positions is None
            else _tied(Skv) if positions == "tied"
            else np.arange(3, Skv + 3, dtype=np.int32))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))

    def attend(a, b, c):
        return jattn.chunked_attention(
            a, b, c, q_positions=jnp.asarray(qpos),
            kv_positions=jnp.asarray(kpos), causal=causal, window=window)

    _, vjp = jax.vjp(attend, jq, jk, jv)
    jgrads = [np.asarray(g, np.float32) for g in vjp(jdo)]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tpos = ({} if positions is None else
            dict(q_positions=torch.from_numpy(qpos),
                 kv_positions=torch.from_numpy(kpos)))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = k3.flash_attention(*leaves, causal=causal, window=window, **tpos)
    grads = torch.autograd.grad(out, leaves, tdo)
    tol = TOL if dtype == "float32" else KERNEL_TOL
    for got, want in zip(grads, jgrads):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    if dtype == "float32":
        return
    out32 = tref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                     causal=causal, window=window, **tpos)
    lse = tref.attention_lse_ref(tq, tk, causal=causal, window=window,
                                 **tpos)
    plain = tref.flash_attention_bwd_bf16_ref(tq, tk, tv, out32, lse, tdo,
                                              causal=causal, window=window,
                                              **tpos)
    q64, k64, v64 = tq.double(), tk.double(), tv.double()
    exact = tref.flash_attention_bwd_ref(
        q64, k64, v64,
        tref.flash_attention_ref(q64, k64, v64, causal=causal, window=window,
                                 **tpos),
        tref.attention_lse_ref(q64, k64, causal=causal, window=window,
                               **tpos), tdo.double(), causal=causal,
        window=window, **tpos)
    for mine, want, ex in zip(plain, jgrads, exact):
        np.testing.assert_allclose(mine.float().numpy(), want,
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)
        err = float((mine.double() - ex).abs().max())
        ref_err = float((torch.from_numpy(want).double() - ex).abs().max())
        assert err <= 2 * ref_err, (err, ref_err)


def test_check_backward_splits_the_dtypes():
    """``_check_backward``, which the autograd forward runs on a CUDA
    tensor before any launch: fp32 and bf16 take Dh 192 with positions or
    without; a head dim neither backward takes (80) raises in each dtype,
    naming that dtype's head dims; explicit positions pass at every head
    dim of 48-128 in both dtypes."""
    for positions in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            k3._check_backward(192, dtype, positions)
            with pytest.raises(ValueError, match=(
                    "fp32" if dtype == torch.float32 else "bf16")):
                k3._check_backward(80, dtype, positions)
    for dh in (48, 64, 96, 112, 128):
        for dtype in (torch.float32, torch.bfloat16):
            k3._check_backward(dh, dtype, True)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_k3_at_dh192_is_counted_the_same_on_meta_and_cpu(mode):
    """``roofline/counter.py`` counts K3 at Dh 192 by its own formula on
    every device: in a bf16 prefill or ``make_train_step`` of the Dh-192
    config (B 2 × S 48), K3's FLOPs on the meta device (the dry run's
    route) equal the CPU route's and the hand count, 4·Dh a visible
    (query, key) pair a head forward and 10·Dh backward, once an
    attention layer (and the MTP block's in training)."""
    from test_torch_roofline import _count
    cfg = _cfg(tconfigs)
    B_, S = 2, 48
    shape = tconfigs.ShapeConfig("t", S, B_, mode)
    meta, cpu = _count(cfg, shape, "meta"), _count(cfg, shape, "cpu")
    pairs = S * (S + 1) // 2 * B_ * cfg.n_heads
    train = mode == "train"
    calls = cfg.n_layers + (cfg.mtp_depth if train else 0)
    want = calls * (4 + (10 if train else 0)) * 192 * pairs
    assert meta[1] == cpu[1] == want, (meta[1], cpu[1], want)
