"""The port's state-space language models against the reference:
falcon-mamba-7b (Mamba1, attention-free) and zamba2-7b (Mamba2 with one
shared attention + MLP block after every ``hybrid_attn_every``-th layer)
at ``reduced()``. Every case carries the reference's fp32 ``init_params``
weights across through ``from_jax_lm_params`` and feeds both sides the same
numpy inputs. Prompt lengths run from 1 and 2 (shorter than the conv
window of 4 − 1) to 300 (past the scan's 256-step chunk). Tolerances:
1e-5 (atol and rtol) for the SSM layers, their states, ``loss_fn`` and its
gradients; 1e-4 for serving (``tests/test_torch_lm.py``'s)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import make_prompts, prefill_to_cache, serve
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["falcon-mamba-7b", "zamba2-7b"]
TOL = 1e-5
SERVE_TOL = 1e-4
B = 2
# full width: (params, one Mamba layer's, the shared block's)
FULL_COUNTS = {"falcon-mamba-7b": (7_272_665_088, 105_312_256, 0),
               "zamba2-7b": (6_751_130_832, 77_978_064, 205_528_064)}


def _is_tensor(t):
    return isinstance(t, torch.Tensor)


_WEIGHTS = {}


def _weights(arch):
    """(reference config, port config, reference params, port params),
    reduced, on the CPU."""
    if arch not in _WEIGHTS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        jp = jax.jit(lambda key: jmodel.init_params(key, jcfg, jnp.float32))(
            jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jcfg, tcfg, jp, from_jax_lm_params(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _WEIGHTS[arch]


def _close(got, expect, tol=TOL):
    got = got.detach().numpy() if _is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(expect), atol=tol, rtol=tol)


def _tree_close(got, expect, tol=TOL):
    got, expect = lm_params_to_numpy(got), jax.tree.map(np.asarray, expect)
    assert jax.tree.structure(got) == jax.tree.structure(expect)
    for g, e in zip(jax.tree.leaves(got), jax.tree.leaves(expect)):
        _close(g, e, tol)


def _x(cfg, S, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _mamba(arch):
    """(reference prefill, decode (jitted, the config static), port
    prefill, decode) of the arch's Mamba version."""
    fns = ((jssm.mamba2_prefill, jssm.mamba2_decode, tssm.mamba2_prefill,
            tssm.mamba2_decode) if arch == "zamba2-7b" else
           (jssm.mamba1_prefill, jssm.mamba1_decode, tssm.mamba1_prefill,
            tssm.mamba1_decode))
    return tuple(jax.jit(f, static_argnums=1) for f in fns[:2]) + fns[2:]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert arch in tconfigs.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_matches_reference(arch):
    """At full width the port's tree (on the meta device, nothing
    allocated) has the reference's keys and shapes (``jax.eval_shape``)
    and parameter counts; zamba2's shared block attends at head dim
    3584 / 32 = 112."""
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    jshape = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tp = tmodel.init_params(tcfg, torch.Generator(), device="meta")
    ours = jax.tree.map(lambda t: tuple(t.shape), tp, is_leaf=_is_tensor)
    assert ours == jax.tree.map(lambda s: tuple(s.shape), jshape)

    def count(tree):
        return sum(t.numel() for t in jax.tree.leaves(tree,
                                                      is_leaf=_is_tensor))

    total, layer, shared = FULL_COUNTS[arch]
    assert count(tp) == total
    assert count(tp["layers"]) == layer * tcfg.n_layers
    assert count(tp.get("shared_attn", {})) == shared
    if arch == "zamba2-7b":
        assert tcfg.resolved_head_dim == 112
        assert tmodel._n_shared_apps(tcfg) == 13
        assert ours["layers"]["mamba"]["w_in"] == (81, 3584, 14576)
        assert ours["shared_attn"]["attn"]["wq"] == (3584, 3584)
    else:
        assert ours["layers"]["mamba"]["A_log"] == (64, 8192, 16)
        assert ours["layers"]["mamba"]["w_x"] == (64, 8192, 256 + 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree_and_distributions(arch):
    """The same tree; each leaf's spread within 10 % of the reference's
    draw; the deterministic leaves (``A_log``, ``D``, biases, norms)
    exactly."""
    jcfg, tcfg, jp, _ = _weights(arch)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    ours = lm_params_to_numpy(tp)
    theirs = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.1, atol=1e-6)
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(ours["layers"]["mamba"][name],
                                      theirs["layers"]["mamba"][name])
    np.testing.assert_allclose(ours["layers"]["mamba"]["conv"].std(), 0.1,
                               rtol=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_ssm_tree_exactly(arch):
    _, tcfg, jp, tp = _weights(arch)
    back = lm_params_to_numpy(tp)
    theirs = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(theirs)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    broken = dict(theirs)       # a hybrid's tree without its shared block
    if broken.pop("shared_attn", None) is None:     # or an ssm's with one
        broken["shared_attn"] = theirs["layers"]
    with pytest.raises(ValueError):
        from_jax_lm_params(broken, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [1, 2, 37, 300])
def test_mamba_prefill_and_decode_match_reference(arch, S):
    """Layer 0's prefill over S tokens (output and both states), then one
    decode step from the reference's states (output and both new states),
    within 1e-5."""
    jcfg, tcfg, jp, tp = _weights(arch)
    jpre, jdec, tpre, tdec = _mamba(arch)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    tl = tmodel.unstack(tp["layers"])[0]["mamba"]
    x = _x(tcfg, S + 1, seed=S)
    y, state = tpre(tl, tcfg, torch.from_numpy(x[:, :S]))
    jy, jstate = jpre(jl, jcfg, jnp.asarray(x[:, :S]))
    print(f"{arch} S={S}: max|dy|={float(np.abs(y.numpy() - jy).max()):.3g}"
          f" (max|y| {float(np.abs(jy).max()):.3g})")
    assert y.shape == (B, S, tcfg.d_model)
    _close(y, jy)
    assert set(state) == set(jstate) == {"h", "conv"}
    for name in state:
        _close(state[name], jstate[name])
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    step, new = tdec(tl, tcfg, torch.from_numpy(x[:, S:]), cache)
    jstep, jnew = jdec(jl, jcfg, jnp.asarray(x[:, S:]), jstate)
    _close(step, jstep)
    for name in new:
        assert new[name] is cache[name]               # written in place
        _close(new[name], jnew[name])


@pytest.mark.parametrize("S", [37, 300])
def test_ssd_chunked_matches_reference(S):
    """``_ssd_chunked`` alone at zamba2's reduced heads (16 of 32, state
    16, one group) with a nonzero initial state, at the scales the model
    feeds it (decays −softplus(N(0, 1)), x·dt ~ 0.25): one chunk (37),
    and a chunk and a zero-padded one (300), where a chunk's running sum
    of decays reaches about −200. Within 1e-5 of the reference and of a
    float64 step-by-step recurrence."""
    rng = np.random.default_rng(S)
    H, P, N = 16, 32, 16
    xh = (rng.normal(size=(B, S, H, P)) * 0.25).astype(np.float32)
    a_log = -np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    b, c = ((rng.normal(size=(B, S, 1, N)) * 0.5).astype(np.float32)
            for _ in range(2))
    h0 = (rng.normal(size=(B, H, P, N)) * 0.5).astype(np.float32)
    y, h = tssm._ssd_chunked(*(torch.from_numpy(a)
                               for a in (xh, a_log, b, c, h0)))
    jy, jh = jax.jit(jssm._ssd_chunked)(*(jnp.asarray(a)
                                          for a in (xh, a_log, b, c, h0)))
    hh, ys = h0.astype(np.float64), []
    for t in range(S):
        hh = (np.exp(a_log[:, t].astype(np.float64))[..., None, None] * hh
              + xh[:, t, :, :, None] * b[:, t, 0][:, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", hh, c[:, t, 0]))
    exact = np.stack(ys, 1)
    print(f"S={S}: max|y - reference|="
          f"{float(np.abs(y.numpy() - jy).max()):.3g}, max|y - float64|="
          f"{float(np.abs(y.numpy() - exact).max()):.3g}, the reference's "
          f"{float(np.abs(np.asarray(jy) - exact).max()):.3g}")
    _close(y, jy)
    _close(h, jh)
    _close(y, exact)
    _close(h, hh)


def test_mamba1_scan_holds_at_falcon_mambas_decay():
    """The Mamba1 scan at falcon-mamba's A (down to −16) and dt ≈ 0.7 over
    300 steps, where exp of a chunk's cumulative dt·A (about −2900)
    underflows: finite, and within 1e-5 of the reference and of a float64
    step-by-step recurrence."""
    rng = np.random.default_rng(1)
    S, Di, N = 300, 8, 16
    A_log = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32),
                                   (Di, N)))
    dt = np.full((B, S, Di), 0.7, np.float32) + rng.uniform(
        -0.05, 0.05, (B, S, Di)).astype(np.float32)
    xc = rng.normal(size=(B, S, Di)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = np.zeros((B, Di, N), np.float32)
    args = (dt, Bm, xc, h0, Cm)
    y, h = tssm._linear_recurrence_chunked(
        {"A_log": torch.from_numpy(A_log)},
        *(torch.from_numpy(a) for a in args))
    jy, jh = jssm._linear_recurrence_chunked(
        {"A_log": jnp.asarray(A_log)}, *(jnp.asarray(a) for a in args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y, jy)
    _close(h, jh)
    A = -np.exp(A_log.astype(np.float64))
    hh = np.zeros((B, Di, N))
    ys = []
    for t in range(S):
        hh = (np.exp(dt[:, t, :, None] * A) * hh
              + (dt[:, t] * xc[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(np.einsum("bdn,bn->bd", hh, Cm[:, t]))
    _close(y, np.stack(ys, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    """The full forward to the final normed hidden states, past a chunk;
    zamba2's shared block with a window of 8 (K3's plain version)."""
    jcfg, tcfg, jp, tp = _weights(arch)
    toks = _tokens(tcfg, 270, seed=4)
    window = 8 if arch == "zamba2-7b" else 0
    h, aux = tmodel.forward_hidden(tp, tcfg, torch.from_numpy(toks),
                                   window=window)
    jh, jaux = jmodel.forward_hidden(jp, jcfg, jnp.asarray(toks),
                                     window=window)
    _close(h, jh)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (xent; aux 0), with ``remat``, and its gradients as to
    every weight under ``jax.value_and_grad``, within 1e-5."""
    jcfg, tcfg, jp, tp = _weights(arch)
    toks = _tokens(tcfg, 24, seed=6)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp,
                          is_leaf=_is_tensor)
    loss, metrics = tmodel.loss_fn(params, tcfg, {
        "tokens": torch.from_numpy(toks),
        "labels": torch.from_numpy(labels)}, remat=True)
    loss.backward()
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)}),
        has_aux=True))(jp)
    _close(loss, jloss)
    _close(metrics["xent"], jmetrics["xent"])
    assert float(metrics["aux"]) == float(metrics["mtp"]) == 0.0
    _tree_close(jax.tree.map(lambda t: t.grad, params, is_leaf=_is_tensor),
                jgrads)


def _place_jax(cache, pcache):
    """``launch/serve.py``'s move of the prefill cache into a max-len one
    (states are replaced whole: their shapes are equal)."""
    return jax.tree.map(lambda c, pc: jax.lax.dynamic_update_slice_in_dim(
        c, pc.astype(c.dtype), 0, axis=2), cache, pcache)


@pytest.mark.parametrize("arch,window", [("falcon-mamba-7b", 0),
                                         ("zamba2-7b", 0), ("zamba2-7b", 8)])
def test_serve_matches_reference_greedy_loop(arch, window):
    """``serve`` against ``launch/serve.py``'s loop on the reference, 12
    prompt tokens and 4 generated: the same greedy tokens and per-step
    logits; the prefill's caches; both caches after a teacher-forced step.
    zamba2 also with a window of 8 that the prompt wraps (the Mamba layers
    ignore it, as in the reference)."""
    jcfg, tcfg, jp, tp = _weights(arch)
    P, gen = 12, 4
    prompts = make_prompts(tcfg, B, P, seed=1, device="cpu")
    res = serve(tcfg, tp, prompts, gen, window=window, device="cpu")
    assert res.tokens.shape == (B, gen)
    jlogits, jpc = jmodel.prefill(jp, jcfg, jnp.asarray(prompts.numpy()),
                                  window=window)

    def jcache():
        return _place_jax(jmodel.init_cache(jcfg, B, P + gen, window=window,
                                            dtype=jnp.float32), jpc)

    dec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, jcfg, t, c, pos,
                                                     window=window))
    cache = jcache()
    token = jnp.argmax(jlogits, axis=-1)[:, None]
    jtokens, jall = [token], [jlogits]
    for i in range(gen - 1):
        jlogits, cache = dec(jp, token, cache, jnp.int32(P + i))
        token = jnp.argmax(jlogits, axis=-1)[:, None]
        jtokens.append(token)
        jall.append(jlogits)
    err = float(np.abs(res.logits.numpy() - np.stack(jall)).max())
    print(f"{arch} window={window}: max|dlogits|={err:.3g}")
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(jtokens, axis=1))
    _close(res.logits, np.stack(jall), SERVE_TOL)

    _, pcache = tmodel.prefill(tp, tcfg, prompts, window=window)
    assert set(pcache) == set(jpc) == (
        {"ssm", "shared_attn"} if arch == "zamba2-7b" else {"ssm"})
    for group in pcache:
        assert set(pcache[group]) == set(jpc[group])
        for name in pcache[group]:
            _close(pcache[group][name], jpc[group][name], SERVE_TOL)
    if window:
        assert pcache["shared_attn"]["k"].shape[2] == window
    _, cache = prefill_to_cache(tp, tcfg, prompts, P + gen, window=window)
    step = torch.from_numpy(np.array(jtokens[0]))
    logits, cache = tmodel.decode(tp, tcfg, step, cache, P, window=window)
    _, jnext = dec(jp, jtokens[0], jcache(), jnp.int32(P))
    _close(logits, jall[1], SERVE_TOL)
    assert set(cache) == set(jnext)
    for group in cache:
        for name in cache[group]:
            _close(cache[group][name], jnext[group][name], SERVE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(arch):
    """The port alone: a decode step after a prefill of P tokens gives the
    last logits of a prefill of the P + 1 tokens (the recurrent form
    against the chunked one), 1e-4."""
    _, tcfg, _, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, 38, seed=9))
    full, _ = tmodel.prefill(tp, tcfg, toks)
    _, cache = prefill_to_cache(tp, tcfg, toks[:, :-1], 40)
    step, _ = tmodel.decode(tp, tcfg, toks[:, -1:], cache, 37)
    _close(step, full, SERVE_TOL)
