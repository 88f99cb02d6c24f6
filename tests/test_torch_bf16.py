"""The port in bf16, the reference's default dtype, against the reference
on the CPU: the weight bridge's bf16 round trip (C7), ``init_params``'s
tree and dtypes in bf16 for every registered arch, bf16 prefill and
decode of reduced smollm-135m, chatglm3-6b and starcoder2-15b, K3's
plain bf16 forward and backward against ``chunked_attention`` in bf16
(also the plain version of the bf16 backward kernels' arithmetic, and its
error against float64 beside the reference's own), and the bf16 serving
drivers.

The gate for a bf16 run is ``max(2e-2, g)``, where g is the reference's
own gap between its bf16 run (bf16 weights, ``init_params``'s default)
and its fp32 run (the same draws in fp32) on the same inputs, computed in
the test: the port may differ from the reference's bf16 bits by no more
than the reference's bf16 differs from its own fp32. 2e-2 is the
reference's bf16 kernel tolerance (``tests/test_kernels.py``)."""
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
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

DENSE = ["smollm-135m", "chatglm3-6b", "starcoder2-15b"]
KERNEL_TOL = 2e-2
B = 2


def _gate(g: float) -> float:
    return max(KERNEL_TOL, g)


_WEIGHTS = {}


def _weights(arch):
    """(jcfg, tcfg, reference bf16 params, the same draws in fp32, port
    bf16 params carried across the bridge), reduced, on the CPU."""
    if arch not in _WEIGHTS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        jp32 = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        tp = from_jax_lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _WEIGHTS[arch] = (jcfg, tcfg, jp, jp32, tp)
    return _WEIGHTS[arch]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b"])
def test_bridge_carries_bf16_both_ways_bitwise(arch):
    """C7: the reference's bf16 tree (numpy ``ml_dtypes.bfloat16`` leaves)
    to the port's tensors and back to numpy, bit for bit."""
    jcfg, tcfg, jp, _, tp = _weights(arch)
    tree = jax.tree.map(np.asarray, jp)
    for leaf in jax.tree.leaves(tp):
        assert leaf.dtype == torch.bfloat16 and leaf.device.type == "cpu"
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.dtype.name == "bfloat16"
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # and the torch side holds the same bits as the numpy side
    wq = tp["layers"]["attn"]["wq"]
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy().view(np.uint16),
        _bits(tree["layers"]["attn"]["wq"]))


@pytest.mark.parametrize("arch", sorted(tconfigs.list_archs()))
def test_init_params_bf16_has_the_reference_tree_and_dtypes(arch):
    """``init_params(dtype=bf16)`` at ``reduced()`` against the
    reference's ``init_params(PRNGKey(0), cfg)`` (bf16 by default): the
    same keys, shapes and dtypes (the draws differ, so not the values);
    the leaves the reference keeps in fp32 (an MoE router, the Mamba
    layers' A_log, dt_bias, D) stay fp32 too."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = lm_params_to_numpy(tmodel.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.bfloat16))
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, b), a in zip(paths, jax.tree.leaves(tp)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


def _reference_run(params, cfg, toks, max_len, window, dtype, feed):
    logits, pcache = jmodel.prefill(params, cfg, jnp.asarray(toks),
                                    window=window)
    cache = jmodel.init_cache(cfg, B, max_len, window=window, dtype=dtype)
    cache = jax.tree.map(
        lambda c, pc: jax.lax.dynamic_update_slice_in_dim(
            c, pc.astype(c.dtype), 0, axis=2) if c.shape != pc.shape
        else pc.astype(c.dtype), cache, pcache)
    out = [np.asarray(logits, np.float32)]
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, cfg, t, c, pos,
                                                     window=window))
    P = toks.shape[1]
    for i in range(feed.shape[1]):
        logits, cache = dec(params, jnp.asarray(feed[:, i:i + 1]), cache,
                            jnp.int32(P + i))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _port_run(params, cfg, toks, max_len, window, dtype, feed):
    logits, cache = prefill_to_cache(params, cfg, torch.from_numpy(toks),
                                     max_len, window=window)
    for group in cache.values():
        for c in group.values():
            assert c.dtype == torch.bfloat16
    out = [logits.numpy()]
    P = toks.shape[1]
    for i in range(feed.shape[1]):
        logits, cache = tmodel.decode(params, cfg,
                                      torch.from_numpy(feed[:, i:i + 1]),
                                      cache, P + i, window=window)
        assert logits.dtype == torch.float32
        out.append(logits.numpy())
    return np.stack(out)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("window", [0, 8])
def test_bf16_prefill_and_decode_match_reference(arch, window):
    """Reduced ``arch`` in bf16: a 13-token prefill (which a window of 8
    wraps) and 4 decode steps fed the same tokens, logits of every step
    within ``max(2e-2, g)`` of the reference's bf16 run."""
    jcfg, tcfg, jp, jp32, tp = _weights(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (B, 13))
    feed = rng.integers(0, tcfg.vocab, (B, 4))
    ref = _reference_run(jp, jcfg, toks, 17, window, jnp.bfloat16, feed)
    ref32 = _reference_run(jp32, jcfg, toks, 17, window, jnp.float32, feed)
    got = _port_run(tp, tcfg, toks, 17, window, torch.bfloat16, feed)
    g = float(np.abs(ref - ref32).max())
    d = float(np.abs(got - ref).max())
    print(f"{arch} window {window}: port vs reference bf16 {d:.4g}, the "
          f"reference's bf16 vs fp32 {g:.4g}")
    assert np.isfinite(got).all()
    assert d <= _gate(g), (d, g)


def _attention_inputs(shape, seed=0):
    B_, Sq, Skv, H, KH, Dh = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B_, Sq, H, Dh), (B_, Skv, KH, Dh), (B_, Skv, KH, Dh),
                      (B_, Sq, H, Dh))]


ATTN_SHAPES = [((2, 64, 64, 4, 2, 64), True, 0),
               ((1, 77, 77, 8, 2, 128), True, 0),
               ((1, 96, 96, 4, 1, 64), True, 24),
               ((1, 700, 700, 2, 1, 64), True, 0)]   # past one 512-key chunk


@pytest.mark.parametrize("shape,causal,window", ATTN_SHAPES)
def test_plain_bf16_attention_and_backward_match_reference(shape, causal,
                                                           window):
    """K3's plain bf16 forward (the CPU route: P rounded to bf16 before
    P·V) and its gradients two ways, autograd through it and
    ``flash_attention_bwd_ref`` on bf16 inputs (computed in float64, the
    card's oracle), against ``jax.vjp`` of ``chunked_attention`` in bf16,
    within 2e-2 (atol and rtol)."""
    q, k, v, do = _attention_inputs(shape)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    pos = jnp.arange(shape[1], dtype=jnp.int32)

    def attend(a, b, c):
        return jattn.chunked_attention(a, b, c, q_positions=pos,
                                       kv_positions=pos, causal=causal,
                                       window=window)

    jout, vjp = jax.vjp(attend, jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    before = k3.launches
    out = k3.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert k3.launches == before and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, (tq, tk, tv), tdo)
    lse = tref.attention_lse_ref(tq.detach(), tk.detach(), causal=causal,
                                 window=window)
    oracle = tref.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse, tdo,
        causal=causal, window=window)

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)

    close(out.detach(), jout)
    for got, bwd, want in zip(grads, oracle, jgrads):
        assert got.dtype == bwd.dtype == torch.bfloat16
        close(got, want)
        close(bwd, want)


@pytest.mark.parametrize("shape,causal,window", ATTN_SHAPES)
def test_plain_bf16_kernel_backward_matches_reference(shape, causal, window):
    """``flash_attention_bwd_bf16_ref``, the arithmetic of K3's bf16
    backward kernels (P and dS rounded to bf16 before their products,
    every sum in fp32, from the training forward's fp32 output: here the
    plain fp32 forward of the bf16 values), against ``jax.vjp`` of
    ``chunked_attention`` in bf16 within 2e-2 (atol and rtol); and, per
    gradient, its max error against the float64 backward of the same bf16
    values at most twice the reference's own. The card holds the kernels
    to this version's error (``chip_smoke.BWD_BF16_PLAIN_FACTOR``)."""
    q, k, v, do = _attention_inputs(shape)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    pos = jnp.arange(shape[1], dtype=jnp.int32)

    def attend(a, b, c):
        return jattn.chunked_attention(a, b, c, q_positions=pos,
                                       kv_positions=pos, causal=causal,
                                       window=window)

    _, vjp = jax.vjp(attend, jq, jk, jv)
    jgrads = [torch.from_numpy(np.asarray(g, np.float32)).double()
              for g in vjp(jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out32 = tref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                     causal=causal, window=window)
    lse = tref.attention_lse_ref(tq, tk, causal=causal, window=window)
    plain = tref.flash_attention_bwd_bf16_ref(tq, tk, tv, out32, lse, tdo,
                                              causal=causal, window=window)
    q64, k64, v64 = tq.double(), tk.double(), tv.double()
    oracle = tref.flash_attention_bwd_ref(
        q64, k64, v64,
        tref.flash_attention_ref(q64, k64, v64, causal=causal,
                                 window=window),
        tref.attention_lse_ref(q64, k64, causal=causal, window=window),
        tdo.double(), causal=causal, window=window)
    for got, want, exact in zip(plain, jgrads, oracle):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)
        err = float((got.double() - exact).abs().max())
        ref_err = float((want - exact).abs().max())
        assert err <= 2 * ref_err, (err, ref_err)


def test_plain_bf16_backward_is_float64_of_the_bf16_values():
    """``flash_attention_bwd_ref`` on bf16 inputs is its float64 run on
    the same values, rounded to bf16 once."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _attention_inputs((1, 40, 40, 4, 2, 64), 3))
    out = tref.flash_attention_ref(q, k, v)
    lse = tref.attention_lse_ref(q, k)
    got = tref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    want = tref.flash_attention_bwd_ref(q.double(), k.double(), v.double(),
                                        out.double(), lse.double(),
                                        do.double())
    for a, b in zip(got, want):
        assert torch.equal(a, b.bfloat16())


def test_bf16_gradient_raises_before_any_launch_where_the_card_has_none():
    """The bf16 and fp32 backwards take the same six head dims,
    deepseek-v3's 192 among them, explicit positions at each of them in
    both dtypes; either dtype at a head dim the forward has no kernel for
    raises in the forward, before any launch."""
    assert k3.BWD_HEAD_DIMS == (48, 64, 96, 112, 128, 192)
    assert k3.BWD_BF16_HEAD_DIMS == k3.BWD_HEAD_DIMS
    assert k3.BWD_POSITION_HEAD_DIMS == k3.BWD_BF16_HEAD_DIMS
    for positions in (False, True):
        k3._check_backward(192, torch.float32, positions)
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="head dim"):
                k3._check_backward(80, dtype, positions)
    for dh in k3.BWD_BF16_HEAD_DIMS:
        k3._check_backward(dh, torch.bfloat16, False)
        k3._check_backward(dh, torch.bfloat16, True)
    for dh in k3.BWD_HEAD_DIMS:
        k3._check_backward(dh, torch.float32, True)


@pytest.mark.parametrize("arch", ["smollm-135m", "chatglm3-6b"])
def test_serve_in_bf16_matches_the_reference_loop(arch):
    """``serve`` with bf16 params (the CLI's ``--dtype bfloat16``) against
    the reference's greedy loop in bf16: logits within the gate, and the
    same greedy tokens wherever the reference's top-2 logit gap exceeds
    twice it."""
    from repro_torch.launch.serve import make_prompts, serve
    jcfg, tcfg, jp, jp32, tp = _weights(arch)
    prompts = make_prompts(tcfg, B, 9, seed=1, device="cpu")
    gen = 4
    res = serve(tcfg, tp, prompts, gen, device="cpu")
    toks = prompts.numpy()
    feed = res.tokens.numpy()[:, :-1]
    ref = _reference_run(jp, jcfg, toks, 9 + gen, 0, jnp.bfloat16, feed)
    ref32 = _reference_run(jp32, jcfg, toks, 9 + gen, 0, jnp.float32, feed)
    gate = _gate(float(np.abs(ref - ref32).max()))
    got = res.logits.numpy()
    assert float(np.abs(got - ref).max()) <= gate
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * gate       # (gen, B)
    np.testing.assert_array_equal(res.tokens.numpy().T[clear],
                                  ref.argmax(-1)[clear])


def test_serve_and_train_cli_take_dtype(capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    tserve.main(["--arch", "chatglm3-6b", "--dtype", "bfloat16", "--batch",
                 "2", "--prompt-len", "9", "--gen", "3", "--device", "cpu"])
    assert "decode: 2 steps" in capsys.readouterr().out
    ttrain.main(["--arch", "chatglm3-6b", "--dtype", "bfloat16", "--steps",
                 "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "step     1 loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "chatglm3-6b", "--dtype", "float16"])


def test_train_cli_refuses_bf16_federated_rounds():
    """The federated rounds run fp32 only: ``--clients`` with ``--dtype
    bfloat16`` is refused before anything runs."""
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "chatglm3-6b", "--clients", "2", "--dtype",
                     "bfloat16", "--device", "cpu"])


def test_init_cache_takes_dtype_and_keeps_ssm_states_fp32():
    for arch in ("chatglm3-6b", "zamba2-7b"):
        cfg = tconfigs.get_config(arch).reduced()
        cache = tmodel.init_cache(cfg, 2, 16, window=8, device="meta",
                                  dtype=torch.bfloat16)
        for group, entries in cache.items():
            for name, c in entries.items():
                want = torch.float32 if name == "h" else torch.bfloat16
                assert c.dtype == want, (arch, group, name)


def test_bf16_init_draws_the_fp32_init_rounded():
    """A seed gives the same draws in every dtype: the bf16 init is the
    fp32 init rounded, leaf for leaf, as the reference's is."""
    cfg = tconfigs.get_config("zamba2-7b").reduced()
    a = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tmodel.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                           torch.bfloat16)
    flat_a = jax.tree.leaves(a)
    flat_b = jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert torch.equal(x.to(y.dtype), y)
