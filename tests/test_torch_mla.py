"""The port's multi-head latent attention (MLA) and the MLA language model
against the reference: minicpm3-4b at ``reduced()`` (K3 at head dim 32 +
16 = 48) and a narrow config at minicpm3's own MLA widths (qk 64 + 32 =
96, v 64, kv_lora 256, q_lora 768; 2 layers, d_model 256, 4 heads). Every
case carries the reference's fp32 ``init_params`` weights across through
``from_jax_lm_params`` and feeds both sides the same numpy inputs.
Tolerance 1e-4 (fp32), as ``tests/test_torch_lm.py``."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as k3
from repro_torch.launch.serve import make_prompts, prefill_to_cache, serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["minicpm3-4b", "narrow-96"]
TOL = 1e-4
B = 2
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _cfgs(arch):
    """(reference config, port config): minicpm3-4b reduced, or reduced
    with minicpm3's full MLA widths."""
    jcfg = jconfigs.get_config("minicpm3-4b").reduced()
    tcfg = tconfigs.get_config("minicpm3-4b").reduced()
    if arch == "narrow-96":
        jcfg = dataclasses.replace(jcfg,
                                   mla=jconfigs.get_config("minicpm3-4b").mla)
        tcfg = dataclasses.replace(tcfg,
                                   mla=tconfigs.get_config("minicpm3-4b").mla)
    return jcfg, tcfg


_WEIGHTS = {}


def _weights(arch):
    """(jcfg, tcfg, reference params, port params) on the CPU."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch)
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        tree = jax.tree.map(np.asarray, jp)
        _WEIGHTS[arch] = (jcfg, tcfg, jp, from_jax_lm_params(tree, tcfg,
                                                             "cpu"))
    return _WEIGHTS[arch]


def _qk_dim(cfg):
    return cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _close(got, expect, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(expect), atol=tol, rtol=tol)


def _jax_layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


def _place_jax(cache, pcache):
    """``launch/serve.py``'s move of the prefill cache into a max-len one."""
    def place(c, pc):
        if c.shape == pc.shape:
            return pc.astype(c.dtype)
        return jax.lax.dynamic_update_slice_in_dim(c, pc.astype(c.dtype), 0,
                                                   axis=2)
    return jax.tree.map(place, cache, pcache)


def test_config_matches_reference():
    jcfg = jconfigs.get_config("minicpm3-4b")
    tcfg = tconfigs.get_config("minicpm3-4b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert "minicpm3-4b" in tconfigs.list_archs()
    assert _qk_dim(tcfg) == 96 and _qk_dim(tcfg.reduced()) == 48


def test_full_size_tree_matches_reference():
    """minicpm3-4b at full width: the port's tree (on the meta device) has
    the reference's keys and shapes (``jax.eval_shape``), nothing
    allocated."""
    jcfg = jconfigs.get_config("minicpm3-4b")
    tcfg = tconfigs.get_config("minicpm3-4b")
    jshape = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tp = tmodel.init_params(tcfg, torch.Generator(), device="meta")
    ours = jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    theirs = jax.tree.map(lambda s: tuple(s.shape), jshape)
    assert ours == theirs
    attn = {k: v[1:] for k, v in ours["layers"]["attn"].items()}
    assert attn == {"wq_a": (2560, 768), "q_norm": (768,),
                    "wq_b": (768, 3840), "wkv_a": (2560, 288),
                    "kv_norm": (256,), "wkv_b": (256, 5120),
                    "wo": (2560, 2560)}
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        theirs, is_leaf=lambda s: isinstance(s, tuple)))
    assert n == sum(t.numel() for t in jax.tree.leaves(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert 4.2e9 < n < 4.35e9


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree_and_distributions(arch):
    jcfg, tcfg, jp, _ = _weights(arch)
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    ours = lm_params_to_numpy(tp)
    assert jax.tree.structure(ours) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(jp)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.std(), np.asarray(b).std(), rtol=0.1,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_mla_tree_exactly(arch):
    _, _, jp, tp = _weights(arch)
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_mla_apply_and_prefill_match_reference(arch, window):
    """Output and the full-length ``{c_kv, k_rope}`` cache; K3 runs its
    plain version at head dim 48 or 96 on the CPU."""
    jcfg, tcfg, jp, tp = _weights(arch)
    S = 13
    x = np.random.default_rng(2).normal(size=(B, S, tcfg.d_model)).astype(
        np.float32)
    pos = np.arange(S, dtype=np.int32)
    attn0 = tmodel.unstack(tp["layers"])[0]["attn"]
    out, cache = tattn.mla_prefill(attn0, tcfg, torch.from_numpy(x),
                                   positions=torch.from_numpy(pos),
                                   window=window)
    jout, jcache = jattn.mla_prefill(_jax_layer(jp, 0)["attn"], jcfg, x,
                                     positions=jnp.asarray(pos),
                                     window=window)
    _close(out, jout)
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name])
    _close(tattn.mla_apply(attn0, tcfg, torch.from_numpy(x),
                           positions=torch.from_numpy(pos), window=window),
           jout)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window,S,pos", [(0, 16, 0), (0, 16, 9), (0, 16, 15),
                                          (8, 8, 5), (8, 8, 21)])
def test_mla_decode_matches_reference(arch, window, S, pos):
    """The absorbed decode on a hand-built cache: the first slot, the
    middle, the last; a ring not yet full and one past its second wrap
    (pos 21 writes slot 5)."""
    jcfg, tcfg, jp, tp = _weights(arch)
    m = tcfg.mla
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    cache = {"c_kv": rng.normal(size=(B, S, m.kv_lora_rank)),
             "k_rope": rng.normal(size=(B, S, m.qk_rope_head_dim))}
    cache = {n: c.astype(np.float32) for n, c in cache.items()}
    out, new = tattn.mla_decode(
        tmodel.unstack(tp["layers"])[1]["attn"], tcfg, torch.from_numpy(x),
        cache={n: torch.from_numpy(c.copy()) for n, c in cache.items()},
        pos=pos, positions=torch.tensor([pos], dtype=torch.int32),
        window=window)
    jout, jnew = jattn.mla_decode(
        _jax_layer(jp, 1)["attn"], jcfg, x, cache=cache, pos=jnp.int32(pos),
        positions=jnp.asarray([pos], jnp.int32), window=window)
    _close(out, jout)
    for n in ("c_kv", "k_rope"):
        _close(new[n], jnew[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp = _weights(arch)
    toks = _tokens(tcfg, 12)
    h, aux = tmodel.forward_hidden(tp, tcfg, torch.from_numpy(toks))
    jh, jaux = jmodel.forward_hidden(jp, jcfg, jnp.asarray(toks))
    _close(h, jh)
    assert float(aux) == float(jaux) == 0.0

    logits, cache = tmodel.prefill(tp, tcfg, torch.from_numpy(toks))
    jlogits, jcache = jmodel.prefill(jp, jcfg, jnp.asarray(toks))
    assert logits.shape == (B, tcfg.vocab) and logits.dtype == torch.float32
    _close(logits, jlogits)
    assert set(cache["layers"]) == {"c_kv", "k_rope"}
    for n in ("c_kv", "k_rope"):
        assert cache["layers"][n].shape == jcache["layers"][n].shape
        _close(cache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """On the CPU the MLA model trains through the plain attention, as
    the reference's ``loss_fn`` under ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp = _weights(arch)
    toks = _tokens(tcfg, 10, seed=6)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    loss, _ = tmodel.loss_fn(params, tcfg, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    loss.backward()
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)}),
        has_aux=True)(jp)
    _close(loss, jloss)
    grads = jax.tree.map(lambda t: t.grad, params,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    for g, jg in zip(jax.tree.leaves(lm_params_to_numpy(grads)),
                     jax.tree.leaves(jgrads)):
        _close(g, jg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_teacher_forced_decode_matches_reference(arch, window):
    """Prefill 7 tokens, then 6 absorbed decode steps fed the reference's
    greedy tokens; with window 8 the ring wraps at position 8."""
    jcfg, tcfg, jp, tp = _weights(arch)
    P, steps = 7, 6
    toks = _tokens(tcfg, P, seed=4)
    jlogits, jpc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), window=window)
    jcache = _place_jax(jmodel.init_cache(jcfg, B, P + steps, window=window,
                                          dtype=jnp.float32), jpc)
    logits, cache = prefill_to_cache(tp, tcfg, torch.from_numpy(toks),
                                     P + steps, window=window)
    _close(logits, jlogits)
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, jcfg, t, c, pos,
                                                     window=window))
    for i in range(steps):
        token = np.array(jnp.argmax(jlogits, axis=-1))[:, None]
        jlogits, jcache = dec(jp, jnp.asarray(token), jcache,
                              jnp.int32(P + i))
        logits, cache = tmodel.decode(tp, tcfg, torch.from_numpy(token),
                                      cache, P + i, window=window)
        _close(logits, jlogits)
    for n in ("c_kv", "k_rope"):
        _close(cache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("arch", ARCHS)
def test_absorbed_decode_matches_the_expanded_prefill(arch):
    """The first decode step's logits (latent-space attention) against the
    last logits of a prefill of all P + 1 tokens (K3's expanded heads)."""
    _, tcfg, _, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, 9, seed=5))
    full, _ = tmodel.prefill(tp, tcfg, toks)
    _, cache = prefill_to_cache(tp, tcfg, toks[:, :-1], 16)
    step, _ = tmodel.decode(tp, tcfg, toks[:, -1:], cache, 8)
    _close(step, full)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_greedy_loop(arch):
    """``serve`` against ``launch/serve.py``'s loop on the reference: the
    same greedy tokens and per-step logits."""
    jcfg, tcfg, jp, tp = _weights(arch)
    prompts = make_prompts(tcfg, B, 9, seed=1, device="cpu")
    gen = 5
    res = serve(tcfg, tp, prompts, gen, device="cpu")
    assert res.tokens.shape == (B, gen)
    jlogits, jpc = jmodel.prefill(jp, jcfg, jnp.asarray(prompts.numpy()))
    cache = _place_jax(jmodel.init_cache(jcfg, B, 9 + gen,
                                         dtype=jnp.float32), jpc)
    token = jnp.argmax(jlogits, axis=-1)[:, None]
    jtokens, jall = [token], [jlogits]
    for i in range(gen - 1):
        jlogits, cache = jmodel.decode(jp, jcfg, token, cache,
                                       jnp.int32(9 + i))
        token = jnp.argmax(jlogits, axis=-1)[:, None]
        jtokens.append(token)
        jall.append(jlogits)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(jtokens, axis=1))
    _close(res.logits, np.stack(jall))


def test_windowed_prompt_longer_than_the_ring_raises():
    """MLA's prefill keeps full-length latents under a window, as the
    reference's; a prompt past the window does not fit the decode ring,
    and the port raises where the reference's serve drops the cache."""
    _, tcfg, _, tp = _weights("minicpm3-4b")
    toks = torch.from_numpy(_tokens(tcfg, 12))
    _, pcache = tmodel.prefill(tp, tcfg, toks, window=8)
    assert pcache["layers"]["c_kv"].shape[2] == 12
    with pytest.raises(NotImplementedError, match="C4"):
        prefill_to_cache(tp, tcfg, toks, 16, window=8)


def test_mla_gradient_at_the_kernel_refuses_up_front():
    """K3's fp32 backward takes Dh 48, 64, 96, 112, 128 and deepseek-v3's
    full-width MLA dim 192 (qk_nope 128 + qk_rope 64), as the bf16 one
    does; on a card, a call at a head dim neither takes (80) that needs a
    gradient raises in the autograd forward, before any launch (the check
    the forward runs on a CUDA tensor). The CPU route,
    one autograd node too since the roofline counter, takes any head dim,
    as the reference does."""
    k3._check_backward(192, torch.float32, False)
    with pytest.raises(ValueError, match="head dim 80"):
        k3._check_backward(80, torch.float32, False)
    q, k, v = (torch.zeros((1, 16, 2, 192), requires_grad=True)
               for _ in range(3))
    n = k3.launches
    out = k3._FlashAttention.apply(q, k, v, True, 0)
    torch.autograd.grad(out.sum(), (q, k, v))
    assert out.shape == q.shape and k3.launches == n


def test_example_serves_minicpm3_on_cpu():
    """``examples/torch_serve_decode.py`` drives the serving CLI, MLA
    included, and runs on the CPU when asked."""
    example = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                           "torch_serve_decode.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, example, "--arch", "minicpm3-4b",
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "decode: 31 steps" in out.stdout
    assert "sample tokens:" in out.stdout
