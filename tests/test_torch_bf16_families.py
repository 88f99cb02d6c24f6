"""The MoE, MLA, SSM, hybrid and stub-prefix families in bf16, the
reference's default dtype, against the reference on the CPU at
``reduced()``: granite-moe-3b-a800m, minicpm3-4b, falcon-mamba-7b,
zamba2-7b, qwen2-vl-2b and deepseek-v3 (MoE with MLA, a dense layer, a
shared expert and the MTP head). For each: a prefill and teacher-forced
decode steps, and one ``make_train_step``; and K3's plain bf16 backward at
the head dims these families train at (MLA's 48 and 96, zamba2's 112) and
with explicit positions (M-RoPE's, at 64 and 128).

The gates are ``tests/test_torch_bf16.py``'s and
``tests/test_torch_steps.py``'s: logits and losses within ``max(2e-2, g)``,
g the reference's own gap between its bf16 run and its fp32 run of the
same draws on the same inputs; gradients and the update Δ in relative
norm within ``max(2e-2, 2g)``. Each fault this file found has a test of
its own below the family tests (ROADMAP Queue C).

The reference runs compiled with XLA's ``xla_allow_excess_precision`` off
(:func:`_exact`): its bf16 program as written, each op's result rounded
to bf16, bit for bit its run op by op (``jax.disable_jit``), as the port
computes. XLA's default on the CPU keeps some bf16 intermediates in fp32:
at reduced minicpm3-4b those logits are 0.041 from the op-by-op ones at
the last decode step (the port: 0.023 from them, 0.063 from the default
compile), and at reduced granite-moe the hidden state moves 8.6 % in
relative norm (fp32: 6e-7), past the gradient gate."""
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
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import prefill_to_cache
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

FAMILIES = ["granite-moe-3b-a800m", "minicpm3-4b", "falcon-mamba-7b",
            "zamba2-7b", "qwen2-vl-2b", "deepseek-v3-671b"]
KERNEL_TOL = 2e-2
B, P, GEN = 2, 13, 4
# the reference's programs compiled as written: no fp32 intermediates
# where the program rounds to bf16
EXACT = {"xla_allow_excess_precision": False}

_WEIGHTS = {}


def _exact(fn, *args):
    """``fn(*args)``, ``fn`` compiled with :data:`EXACT`."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _weights(arch):
    """(jcfg, tcfg, reference bf16 params, the same draws in fp32, port
    bf16 params carried across the bridge), reduced, on the CPU."""
    if arch not in _WEIGHTS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        key = jax.random.PRNGKey(0)
        jp32 = jmodel.init_params(key, jcfg, jnp.float32)
        # the bf16 init is the fp32 one cast leaf by leaf to each leaf's
        # dtype (the leaves the reference keeps in fp32 stay so)
        jp = jax.tree.map(lambda s, x: x.astype(s.dtype),
                          jax.eval_shape(lambda: jmodel.init_params(
                              key, jcfg)), jp32)
        tp = from_jax_lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _WEIGHTS[arch] = (jcfg, tcfg, jp, jp32, tp)
    return _WEIGHTS[arch]


def _stub(cfg, seed=5):
    """A stub prefix of bf16 values (N(0, 0.02²)), as float32 numpy, or
    None for a config without a stub frontend."""
    if not cfg.n_stub_tokens:
        return None
    rng = np.random.default_rng(seed)
    x = 0.02 * rng.normal(size=(B, cfg.n_stub_tokens, cfg.d_model))
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _reference_run(params, cfg, toks, stub, max_len, dtype, feed):
    """The reference's prefill into a cache of ``max_len`` positions, then
    teacher-forced decode steps on ``feed``: the logits of each, stacked
    (each program compiled by :func:`_exact`)."""
    stub = None if stub is None else jnp.asarray(stub, dtype)
    logits, pcache = _exact(
        lambda p, t, s: jmodel.prefill(p, cfg, t, stub_embeds=s), params,
        jnp.asarray(toks), stub)
    cache = jmodel.init_cache(cfg, B, max_len, dtype=dtype)
    cache = jax.tree.map(
        lambda c, pc: jax.lax.dynamic_update_slice_in_dim(
            c, pc.astype(c.dtype), 0, axis=2) if c.shape != pc.shape
        else pc.astype(c.dtype), cache, pcache)
    out = [np.asarray(logits, np.float32)]
    start = toks.shape[1] + (0 if stub is None else stub.shape[1])
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, cfg, t, c, pos)
                  ).lower(params, jnp.asarray(feed[:, :1]), cache,
                          jnp.int32(start)).compile(compiler_options=EXACT)
    for i in range(feed.shape[1]):
        logits, cache = dec(params, jnp.asarray(feed[:, i:i + 1]), cache,
                            jnp.int32(start + i))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _port_run(params, cfg, toks, stub, max_len, feed):
    stub_t = None if stub is None else torch.from_numpy(stub).bfloat16()
    logits, cache = prefill_to_cache(params, cfg, torch.from_numpy(toks),
                                     max_len, stub_embeds=stub_t)
    out = [logits.numpy()]
    start = toks.shape[1] + (0 if stub is None else stub.shape[1])
    for i in range(feed.shape[1]):
        logits, cache = tmodel.decode(params, cfg,
                                      torch.from_numpy(feed[:, i:i + 1]),
                                      cache, start + i)
        assert logits.dtype == torch.float32
        out.append(logits.numpy())
    return np.stack(out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_prefill_and_decode_match_reference(arch):
    """Reduced ``arch`` in bf16: a 13-token prefill (after the stub
    prefix) and 4 teacher-forced decode steps, the logits of every step
    within ``max(2e-2, g)`` of the reference's bf16 run."""
    jcfg, tcfg, jp, jp32, tp = _weights(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (B, P))
    feed = rng.integers(0, tcfg.vocab, (B, GEN))
    stub = _stub(tcfg)
    max_len = P + GEN + tcfg.n_stub_tokens
    ref = _reference_run(jp, jcfg, toks, stub, max_len, jnp.bfloat16, feed)
    ref32 = _reference_run(jp32, jcfg, toks, stub, max_len, jnp.float32,
                           feed)
    got = _port_run(tp, tcfg, toks, stub, max_len, feed)
    g = float(np.abs(ref - ref32).max())
    d = float(np.abs(got - ref).max())
    print(f"{arch}: port vs reference bf16 {d:.4g}, the reference's bf16 "
          f"vs fp32 {g:.4g}")
    assert np.isfinite(got).all()
    assert d <= max(KERNEL_TOL, g), (d, g)


def _rel(got, want):
    """||got − want|| / ||want|| over lists of leaves, in float64."""
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    return (num / den) ** 0.5


def _attention_inputs(shape, seed=0):
    B_, Sq, Skv, H, KH, Dh = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B_, Sq, H, Dh), (B_, Skv, KH, Dh), (B_, Skv, KH, Dh),
                      (B_, Sq, H, Dh))]


def _mrope_temporal(n_stub, text):
    """qwen2-vl's temporal positions: the patches at 0, then the text from
    max(2, half the grid's width)."""
    return np.concatenate([np.zeros(n_stub, np.int32),
                           np.arange(text, dtype=np.int32)
                           + max(2, n_stub // 2)])


# (B, Sq, Skv, H, KH, Dh), causal, window, positions: the families' new
# bf16 head dims (reduced MLA's 48, minicpm3-4b's 96, zamba2's 112) and
# M-RoPE's temporal positions at 128 (qwen2-vl) and 64, windowed too
BWD_CASES = [((2, 64, 64, 4, 4, 48), True, 0, None),
             ((1, 96, 96, 4, 4, 96), True, 0, None),
             ((1, 80, 80, 2, 2, 112), True, 24, None),
             ((1, 72, 72, 6, 2, 128), True, 0, "mrope"),
             ((1, 72, 72, 4, 1, 64), True, 16, "mrope")]


@pytest.mark.parametrize("shape,causal,window,positions", BWD_CASES)
def test_plain_bf16_backward_at_the_families_dims(shape, causal, window,
                                                  positions):
    """K3's plain bf16 backward (the CPU route, autograd through the
    plain bf16 forward, recomputed) and the plain version of the bf16
    kernels' arithmetic (``flash_attention_bwd_bf16_ref``) against
    ``jax.vjp`` of ``chunked_attention`` in bf16 within 2e-2 (atol and
    rtol), at the head dims the families train at and with M-RoPE's
    temporal positions; the kernels' version's max error against the
    float64 backward of the same bf16 values at most twice the
    reference's own."""
    q, k, v, do = _attention_inputs(shape)
    Sq = shape[1]
    pos = (_mrope_temporal(16, Sq - 16) if positions
           else np.arange(Sq, dtype=np.int32))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))

    def attend(a, b, c):
        return jattn.chunked_attention(
            a, b, c, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), causal=causal, window=window)

    _, vjp = jax.vjp(attend, jq, jk, jv)
    jgrads = [np.asarray(g, np.float32) for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    tpos = (dict(q_positions=torch.from_numpy(pos),
                 kv_positions=torch.from_numpy(pos)) if positions else {})
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = k3.flash_attention(*leaves, causal=causal, window=window, **tpos)
    grads = torch.autograd.grad(out, leaves, tdo)
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
    for got, mine, want, ex in zip(grads, plain, jgrads, exact):
        assert got.dtype == mine.dtype == torch.bfloat16
        for a in (got, mine):
            np.testing.assert_allclose(a.float().numpy(), want,
                                       atol=KERNEL_TOL, rtol=KERNEL_TOL)
        err = float((mine.double() - ex).abs().max())
        ref_err = float((torch.from_numpy(want).double() - ex).abs().max())
        assert err <= 2 * ref_err, (err, ref_err)


@pytest.mark.parametrize("window", [0, 8])
def test_mla_absorbed_decode_sums_its_scores_in_fp32(window):
    """ROADMAP C8: MLA's weight-absorbed decode in bf16 (reduced
    minicpm3-4b, one layer, a cache of 16 random bf16 latents, the new
    token at position 11; a window of 8 makes it a ring) against the
    reference's ``mla_decode``, which sums both score einsums in fp32
    (``preferred_element_type``) and rounds P to the cache's dtype before
    P·c_kv. The port summed them in bf16 and its softmax ran in bf16: the
    layer's output was 1.6e-2 of its largest element off (0.0483 on the
    model's logits, the gate 0.0449); now both compute the same products,
    and the outputs agree to within 2^-8 of the largest element (one bf16
    ulp at its scale), the new latents written into the cache bitwise."""
    jcfg, tcfg, jp, _, tp = _weights("minicpm3-4b")
    m = tcfg.mla
    S, pos = 16, 11
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    c_kv = rng.normal(size=(B, S, m.kv_lora_rank)).astype(np.float32)
    k_rope = rng.normal(size=(B, S, m.qk_rope_head_dim)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    bf = jnp.bfloat16
    jout, jcache = jattn.mla_decode(
        jl, jcfg, jnp.asarray(x, bf),
        cache={"c_kv": jnp.asarray(c_kv, bf),
               "k_rope": jnp.asarray(k_rope, bf)},
        pos=jnp.int32(pos), positions=jnp.full((1,), pos, jnp.int32),
        window=window)
    cache = {"c_kv": torch.from_numpy(c_kv).bfloat16(),
             "k_rope": torch.from_numpy(k_rope).bfloat16()}
    tout, tcache = tattn.mla_decode(
        tl, tcfg, torch.from_numpy(x).bfloat16(), cache=cache, pos=pos,
        positions=torch.full((1,), pos, dtype=torch.int32), window=window)
    want = np.asarray(jout, np.float32)
    d = float(np.abs(tout.float().numpy() - want).max())
    scale = float(np.abs(want).max())
    print(f"window {window}: max|d| {d:.3g}, max|ref| {scale:.3g}")
    assert tout.dtype == torch.bfloat16
    assert d <= 2.0 ** -8 * scale, (d, scale)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_array_equal(
            tcache[name].view(torch.int16).numpy(),
            np.asarray(jcache[name]).view(np.int16))
