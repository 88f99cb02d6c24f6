"""The port's dense GQA language model against the reference, at
``reduced()`` width for smollm-135m, starcoder2-15b (native 4096 window)
and chatglm3-6b (rope2d), and a narrow config with smollm's G = 3. Every
case carries the reference's ``init_params`` weights across through
``from_jax_lm_params`` and feeds both sides the same numpy tokens.
Tolerance 1e-4 (fp32), 2e-3 for the port's own prefill-then-decode ==
full-forward check (``tests/test_models_smoke.py``'s)."""
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rope as jrope
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.launch.serve import make_prompts, prefill_to_cache, serve
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["smollm-135m", "starcoder2-15b", "chatglm3-6b", "narrow-g3"]
TOL = 1e-4
B = 2
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _cfgs(arch):
    """(reference config, port config), both reduced."""
    name = "smollm-135m" if arch == "narrow-g3" else arch
    jcfg = jconfigs.get_config(name).reduced()
    tcfg = tconfigs.get_config(name).reduced()
    if arch == "narrow-g3":
        kw = dict(n_heads=3, n_kv_heads=1, head_dim=64)
        jcfg = dataclasses.replace(jcfg, **kw)
        tcfg = dataclasses.replace(tcfg, **kw)
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


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _close(got, expect, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(expect), atol=tol, rtol=tol)


def _jax_layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


def _place_jax(cache, pcache):
    """``launch/serve.py``'s move of the prefill KV into a max-len cache."""
    def place(c, pc):
        if c.shape == pc.shape:
            return pc.astype(c.dtype)
        return jax.lax.dynamic_update_slice_in_dim(c, pc.astype(c.dtype), 0,
                                                   axis=2)
    return jax.tree.map(place, cache, pcache)


@pytest.mark.parametrize("name", ["smollm-135m", "starcoder2-15b",
                                  "chatglm3-6b"])
def test_configs_match_reference(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert name in tconfigs.list_archs()


def test_smollm_full_size_matches_the_published_count():
    cfg = tconfigs.get_config("smollm-135m")
    params = tmodel.init_params(cfg, torch.Generator(), device="meta")

    def numel(t):
        if isinstance(t, dict):
            return sum(numel(v) for v in t.values())
        return t.numel()

    assert numel(params) == 162_826_560
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim) == (30, 576, 9, 3, 64)


def test_bridge_round_trip_is_exact():
    jcfg, tcfg, jp, tp = _weights("chatglm3-6b")
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tp["layers"]["attn"]["wq"].shape == (2, 256, 4 * 64)


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


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    _close(tlayers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x)),
           jlayers.rmsnorm(scale, x), 1e-6)
    mlp = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
           (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    _close(tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in
                              mlp.items()}, torch.from_numpy(x)),
           jlayers.mlp_apply(mlp, x), 1e-5)
    emb = rng.normal(size=(50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (B, 5))
    _close(tlayers.embed_apply(torch.from_numpy(emb), torch.from_numpy(toks)),
           jlayers.embed_apply(emb, toks), 0)
    for transpose, w in ((True, emb), (False, emb.T.copy())):
        _close(tlayers.unembed_apply(torch.from_numpy(w), torch.from_numpy(x),
                                     transpose),
               jlayers.unembed_apply(w, x, transpose), 1e-5)


@pytest.mark.parametrize("variant,fraction,theta", [
    ("rope", 1.0, 10000.0), ("rope2d", 0.5, 10000.0), ("none", 1.0, 1e4)])
def test_apply_rope_matches_reference(variant, fraction, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 9, 3, 64)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 1000    # large angles too
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           variant=variant, theta=theta, fraction=fraction)
    expect = jrope.apply_rope(x, pos, variant=variant, theta=theta,
                              fraction=fraction)
    _close(got, expect, 1e-5)
    # M-RoPE, which raised before qwen2-vl was ported: (S, 3) positions
    pos3 = np.stack([pos, pos + 7, pos * 2], -1).astype(np.int32)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3),
                            variant="mrope", theta=theta),
           jrope.apply_rope(x, pos3, variant="mrope", theta=theta), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_gqa_prefill_matches_reference(arch, window):
    jcfg, tcfg, jp, tp = _weights(arch)
    S = 13                     # with window 8: ring-packed and rolled by 5
    x = np.random.default_rng(2).normal(size=(B, S, tcfg.d_model)).astype(
        np.float32)
    pos = np.arange(S, dtype=np.int32)
    attn0 = tmodel.unstack(tp["layers"])[0]["attn"]
    out, kv = tattn.gqa_prefill(attn0, tcfg, torch.from_numpy(x),
                                positions=torch.from_numpy(pos),
                                window=window)
    jout, jkv = jattn.gqa_prefill(_jax_layer(jp, 0)["attn"], jcfg, x,
                                  positions=jnp.asarray(pos), window=window)
    _close(out, jout)
    for name in ("k", "v"):
        assert kv[name].shape == jkv[name].shape
        _close(kv[name], jkv[name])
    _close(tattn.gqa_apply(attn0, tcfg, torch.from_numpy(x),
                           positions=torch.from_numpy(pos), window=window),
           jout)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window,S,pos", [(0, 16, 9), (8, 8, 21)])
def test_gqa_decode_matches_reference(arch, window, S, pos):
    """Full cache, and a ring past its second wrap (pos 21 writes slot 5)."""
    jcfg, tcfg, jp, tp = _weights(arch)
    rng = np.random.default_rng(3)
    dh = tcfg.resolved_head_dim
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    cache = {n: rng.normal(size=(B, S, tcfg.n_kv_heads, dh)).astype(
        np.float32) for n in ("k", "v")}
    out, new = tattn.gqa_decode(
        tmodel.unstack(tp["layers"])[1]["attn"], tcfg, torch.from_numpy(x),
        cache={n: torch.from_numpy(c.copy()) for n, c in cache.items()},
        pos=pos, positions=torch.tensor([pos], dtype=torch.int32),
        window=window)
    jout, jnew = jattn.gqa_decode(
        _jax_layer(jp, 1)["attn"], jcfg, x, cache=cache, pos=jnp.int32(pos),
        positions=jnp.asarray([pos], jnp.int32), window=window)
    _close(out, jout)
    for n in ("k", "v"):
        _close(new[n], jnew[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp = _weights(arch)
    toks = _tokens(tcfg, 12)
    h, aux = tmodel.forward_hidden(tp, tcfg, torch.from_numpy(toks))
    jh, jaux = jmodel.forward_hidden(jp, jcfg, jnp.asarray(toks))
    _close(h, jh)
    assert float(aux) == float(jaux) == 0.0
    _close(tmodel.logits_from_hidden(tp, tcfg, h),
           jmodel.logits_from_hidden(jp, jcfg, jh))

    logits, cache = tmodel.prefill(tp, tcfg, torch.from_numpy(toks))
    jlogits, jcache = jmodel.prefill(jp, jcfg, jnp.asarray(toks))
    assert logits.shape == (B, tcfg.vocab) and logits.dtype == torch.float32
    _close(logits, jlogits)
    for n in ("k", "v"):
        assert cache["layers"][n].shape == jcache["layers"][n].shape
        _close(cache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_teacher_forced_decode_matches_reference(arch, window):
    """Prefill 7 tokens, then 6 decode steps fed the reference's greedy
    tokens; with window 8 the ring wraps at position 8."""
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
    for n in ("k", "v"):
        _close(cache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    _, tcfg, _, tp = _weights(arch)
    toks = torch.from_numpy(_tokens(tcfg, 8, seed=5))
    h, _ = tmodel.forward_hidden(tp, tcfg, toks)
    full = tmodel.logits_from_hidden(tp, tcfg, h[:, -1:])[:, 0]
    _, cache = prefill_to_cache(tp, tcfg, toks[:, :-1], 16)
    step, _ = tmodel.decode(tp, tcfg, toks[:, -1:], cache, 7)
    _close(step, full.numpy(), 2e-3)


def test_serve_matches_reference_greedy_loop():
    """``serve`` against ``launch/serve.py``'s loop on the reference: the
    same greedy tokens and per-step logits."""
    jcfg, tcfg, jp, tp = _weights("smollm-135m")
    prompts = make_prompts(tcfg, B, 9, seed=1, device="cpu")
    gen = 5
    res = serve(tcfg, tp, prompts, gen, device="cpu")
    assert res.tokens.shape == (B, gen) and res.logits.shape == (gen, B,
                                                                 tcfg.vocab)
    assert set(res.timings) == {"prefill_ms", "decode_ms_per_step",
                                "decode_tok_per_s"}
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


def test_unported_families_raise():
    """A family the port does not run raises. mrope, stub tokens and
    custom positions raised until qwen2-vl and musicgen were ported; they
    now run, and a prefill at custom positions matches the reference."""
    cfg = tconfigs.get_config("smollm-135m").reduced()
    with pytest.raises(NotImplementedError):
        tmodel.init_params(dataclasses.replace(cfg, family="encoder"),
                           torch.Generator(), device="cpu")
    for kw in (dict(rope="mrope"), dict(n_stub_tokens=8)):
        tmodel.init_params(dataclasses.replace(cfg, **kw),
                           torch.Generator(), device="cpu")
    jcfg, tcfg, jp, tp = _weights("smollm-135m")
    toks = _tokens(tcfg, 4)
    pos = np.arange(4, dtype=np.int32) + 3
    logits, cache = tmodel.prefill(tp, tcfg, torch.from_numpy(toks),
                                   positions=torch.from_numpy(pos))
    jlogits, jcache = jmodel.prefill(jp, jcfg, jnp.asarray(toks),
                                     positions=jnp.asarray(pos))
    _close(logits, jlogits)
    _close(cache["layers"]["k"], jcache["layers"]["k"])


_SERVE_ISOLATION = r"""
import sys
import torch
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models.model import init_params

ARCH = sys.argv[1]
cfg = get_config(ARCH).reduced()
params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
prompts = serve_mod.make_prompts(cfg, 2, 5, seed=1, device="cpu")
res = serve_mod.serve(cfg, params, prompts, 3, device="cpu")
assert res.tokens.shape == (2, 3)
serve_mod.main(["--arch", ARCH, "--batch", "1", "--prompt-len",
                "4", "--gen", "2", "--device", "cpu"])
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro"
       or m.startswith("repro.")]
print("LOADED", bad)

raised = []
if not torch.cuda.is_available():
    for call in (lambda: serve_mod.serve(cfg, params, prompts, 3),
                 lambda: serve_mod.main(["--arch", ARCH]),
                 lambda: serve_mod.make_prompts(cfg, 2, 5, seed=1)):
        try:
            call()
        except RuntimeError:
            raised.append(True)
        else:
            raised.append(False)
print("RAISED", raised)
"""


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b",
                                  "granite-moe-3b-a800m", "deepseek-v3-671b",
                                  "falcon-mamba-7b", "zamba2-7b"])
def test_serve_imports_no_jax_and_defaults_to_cuda(arch):
    """GQA, MLA, MoE, SSM and hybrid serving import neither ``jax`` nor
    ``repro``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SERVE_ISOLATION, arch],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sample tokens:" in out.stdout
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "RAISED")))
    assert lines["LOADED"] == "[]"
    if not torch.cuda.is_available():
        assert lines["RAISED"] == "[True, True, True]"
