"""The stub-prefix families against the reference: qwen2-vl-2b (M-RoPE over
(S, 3) positions, qkv biases, 12 heads over 2 KV heads) and musicgen-large
(no rope, G = 1), at ``reduced()`` on the reference's own weights
(``from_jax_lm_params``, with random qkv biases), with random stub
embeddings, with and without custom positions. Also M-RoPE's angles and
rotation, K3's CPU route with explicit positions against the reference's
``chunked_attention`` (tied positions, a -1 padding tail, a window, fully
masked rows, unsorted positions), and the serving driver's cache sizing
(ROADMAP Queue C, C5). Tolerances: M-RoPE 1e-6, K3 with positions 2e-6
(atol and rtol, fp32 against fp32), model level ``tests/test_torch_lm.py``'s
1e-4. ``tests/test_torch_gpu.py`` holds the card's kernels with positions
to their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import token_batch_stream
from repro.models import model as jmodel
from repro.models import rope as jrope
from repro.models.attention import chunked_attention
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["qwen2-vl-2b", "musicgen-large"]
TOL = 1e-4                     # tests/test_torch_lm.py's, model level
ROPE_TOL = 1e-6
ATTN_TOL = 2e-6
B, S = 2, 11                   # batch and text tokens at reduced() width


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert arch in tconfigs.list_archs()
    full = {"qwen2-vl-2b": (28, 1536, 12, 2, 128, 8960, 151_936, 256),
            "musicgen-large": (48, 2048, 32, 32, 64, 8192, 2048, 64)}[arch]
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.resolved_head_dim, tcfg.d_ff, tcfg.vocab,
            tcfg.n_stub_tokens) == full
    red = tcfg.reduced()
    assert (red.resolved_head_dim, red.n_stub_tokens) == (64, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_matches_reference(arch):
    """The full-width tree (on the meta device) has the reference's keys
    and shapes (``jax.eval_shape``), nothing allocated."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tp = tmodel.init_params(tcfg, torch.Generator(), device="meta")
    ours = jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert ours == jax.tree.map(lambda s: tuple(s.shape), jshape)
    n = sum(t.numel() for t in jax.tree.leaves(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n == {"qwen2-vl-2b": 1_777_088_000,
                 "musicgen-large": 3_229_812_736}[arch]


# -------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("rot_dim", [64, 128])
def test_mrope_angles_match_reference(rot_dim):
    half = rot_dim // 2
    sections = {64: (8, 12, 12), 128: (16, 24, 24)}[rot_dim]
    n_t = int(round(trope.MROPE_SECTIONS[0] * half))
    n_h = int(round(trope.MROPE_SECTIONS[1] * half))
    assert (n_t, n_h, half - n_t - n_h) == sections
    pos = np.random.default_rng(rot_dim).integers(0, 5000, (37, 3)).astype(
        np.int32)
    got = trope._mrope_angles(torch.from_numpy(pos), rot_dim, 1e6)
    _close(got, jrope._mrope_angles(pos, rot_dim, 1e6), ROPE_TOL)
    # each band follows its own component
    inv = 1.0 / (1e6 ** (np.arange(0, rot_dim, 2) / rot_dim))
    band = np.repeat([0, 1, 2], sections)
    np.testing.assert_allclose(got.numpy(), pos[:, band] * inv, rtol=1e-5)


@pytest.mark.parametrize("rot_dim", [64, 128])
@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_apply_mrope_matches_reference(rot_dim, theta):
    rng = np.random.default_rng(rot_dim + int(theta))
    x = rng.normal(size=(B, 37, 3, rot_dim)).astype(np.float32)
    pos = rng.integers(0, 5000, (37, 3)).astype(np.int32)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           variant="mrope", theta=theta)
    _close(got, jrope.apply_rope(x, pos, variant="mrope", theta=theta),
           ROPE_TOL)


def test_mrope_with_equal_components_is_rope():
    """Positions whose three components agree rotate as plain rope."""
    x = torch.randn((B, 9, 3, 128), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9, dtype=torch.int32) + 700
    got = trope.apply_rope(x, torch.stack([pos, pos, pos], -1),
                           variant="mrope", theta=1e6)
    _close(got, trope.apply_rope(x, pos, variant="rope", theta=1e6), 0)


# -------------------------------------------------- K3 with positions

def _pattern(name, S_):
    """(q_positions, kv_positions, causal, window) int32 numpy arrays for
    a self-attention pattern over S_ positions."""
    ar = np.arange(S_, dtype=np.int32)
    image = np.concatenate([np.zeros(16, np.int32),           # 4 x 4 image
                            np.arange(4, 4 + S_ - 16, dtype=np.int32)])
    if name == "mrope":                  # tied t, then text counting on
        return image, image, True, 0
    if name == "mrope_window":
        return image, image, True, 8
    if name == "pad":                    # a -1 padding tail
        pos = np.where(ar < S_ - 10, ar, -1).astype(np.int32)
        return pos, pos, True, 0
    if name == "pad_bidirectional":
        pos = np.where(ar < S_ - 10, ar, -1).astype(np.int32)
        return pos, pos, False, 20
    if name == "masked_rows":            # rows 0..19 see no key
        return ar, ar + 20, True, 0
    if name == "unsorted":               # a permutation, ties and a window
        pos = np.random.default_rng(3).permutation(image).astype(np.int32)
        return pos, pos, True, 30
    raise ValueError(name)


PATTERNS = ["mrope", "mrope_window", "pad", "pad_bidirectional",
            "masked_rows", "unsorted"]


def _attn_case(name, Dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    S_ = 72
    qp, kp, causal, window = _pattern(name, S_)
    return (f(2, S_, 4, Dh), f(2, S_, 2, Dh), f(2, S_, 2, Dh),
            f(2, S_, 4, Dh), qp, kp, causal, window)


def _chunked(q, k, v, dout, qp, kp, causal, window):
    """The reference's output and (dq, dk, dv) by ``jax.vjp``, over KV
    chunks of 16 (so the padding and the ties cross chunks)."""
    def attend(q_, k_, v_):
        return chunked_attention(q_, k_, v_, q_positions=jnp.asarray(qp),
                                 kv_positions=jnp.asarray(kp),
                                 causal=causal, window=window, chunk=16)
    out, vjp = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_positions_match_chunked_attention(name, Dh):
    q, k, v, dout, qp, kp, causal, window = _attn_case(name, Dh)
    out_ref, grads_ref = _chunked(q, k, v, dout, qp, kp, causal, window)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n = k3.launches
    out = k3.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_positions=torch.from_numpy(qp),
                             kv_positions=torch.from_numpy(kp))
    out.backward(torch.from_numpy(dout))
    assert k3.launches == n                              # the plain path
    _close(out, out_ref, ATTN_TOL)
    for t, g in zip((tq, tk, tv), grads_ref):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, g, ATTN_TOL)
    if name == "masked_rows":                  # 0 out, 0 gradient
        assert not out[:, :20].any() and not tq.grad[:, :20].any()


@pytest.mark.parametrize("name", PATTERNS)
def test_plain_backward_with_positions_matches_chunked_attention(name):
    """``flash_attention_bwd_ref`` and ``attention_lse_ref`` with explicit
    positions, the plain versions of the card's position kernels."""
    q, k, v, dout, qp, kp, causal, window = _attn_case(name, 64, seed=1)
    _, grads_ref = _chunked(q, k, v, dout, qp, kp, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    pos = dict(q_positions=torch.from_numpy(qp),
               kv_positions=torch.from_numpy(kp))
    out = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   **pos)
    lse = tref.attention_lse_ref(tq, tk, causal=causal, window=window, **pos)
    seen = tref._attention_mask(len(qp), len(kp), causal, window, "cpu",
                                **pos).any(1)
    assert torch.equal(torch.isinf(lse), ~seen[None, None, :].expand_as(lse))
    grads = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window, **pos)
    for got, want in zip(grads, grads_ref):
        _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9),
                                           (False, 0), (False, 9)])
def test_arange_positions_equal_the_index_path(causal, window):
    q, k, v, *_ = _attn_case("mrope", 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ar = torch.arange(72, dtype=torch.int32)
    got = k3.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_positions=ar, kv_positions=ar)
    assert torch.equal(got, k3.flash_attention(tq, tk, tv, causal=causal,
                                               window=window))


def test_flash_attention_refuses_bad_positions():
    q, k, v, *_ = _attn_case("mrope", 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ar = torch.arange(72)
    with pytest.raises(ValueError, match="both"):
        k3.flash_attention(tq, tk, tv, q_positions=ar)
    with pytest.raises(ValueError, match=r"\(72,\)"):
        k3.flash_attention(tq, tk, tv, q_positions=ar[:5], kv_positions=ar)
    with pytest.raises(TypeError, match="integer"):
        k3.flash_attention(tq, tk, tv, q_positions=ar.float(),
                           kv_positions=ar)


# --------------------------------------------------------- the models

_WEIGHTS = {}


def _weights(arch):
    """(jcfg, tcfg, reference params, port params): reduced(), the
    reference's init with random qkv biases (its init gives zeros)."""
    if arch not in _WEIGHTS:
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = tconfigs.get_config(arch).reduced()
        tree = jax.tree.map(np.array, jmodel.init_params(
            jax.random.PRNGKey(0), jcfg, jnp.float32))
        rng = np.random.default_rng(5)
        for name in ("bq", "bk", "bv"):
            if name in tree["layers"]["attn"]:
                b = tree["layers"]["attn"][name]
                tree["layers"]["attn"][name] = (
                    0.1 * rng.normal(size=b.shape)).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, tree)
        _WEIGHTS[arch] = (jcfg, tcfg, jp, from_jax_lm_params(tree, tcfg,
                                                             "cpu"))
    return _WEIGHTS[arch]


def _mrope_layout(n_stub, S_text):
    """An M-RoPE prompt: the stub prefix as a 2 x (n_stub / 2) image (t 0,
    h the row, w the column), then text from the image's largest position
    + 1, every component counting on. (S_eff, 3) int32."""
    w = n_stub // 2
    r, c = np.divmod(np.arange(n_stub), w)
    image = np.stack([np.zeros(n_stub, np.int64), r, c], -1)
    text = np.arange(S_text)[:, None] + max(2, w)
    return np.concatenate([image, np.repeat(text, 3, 1)]).astype(np.int32)


def _inputs(arch, custom, seed=0, S_text=S):
    """(tokens, stub_embeds, positions or None) as numpy arrays."""
    _, tcfg, _, _ = _weights(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab, (B, S_text))
    stub = rng.normal(size=(B, tcfg.n_stub_tokens, tcfg.d_model)).astype(
        np.float32)
    pos = None
    if custom:
        pos = _mrope_layout(tcfg.n_stub_tokens, S_text)
        if tcfg.rope != "mrope":
            pos = np.ascontiguousarray(pos[:, 0])        # the temporal one
    return tokens, stub, pos


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("custom", [False, True])
def test_forward_hidden_matches_reference(arch, custom):
    jcfg, tcfg, jp, tp = _weights(arch)
    tokens, stub, pos = _inputs(arch, custom)
    h, aux = tmodel.forward_hidden(tp, tcfg, _t(tokens), stub_embeds=_t(stub),
                                   positions=_t(pos))
    jh, _ = jmodel.forward_hidden(jp, jcfg, _j(tokens), stub_embeds=_j(stub),
                                  positions=_j(pos))
    assert h.shape == (B, tcfg.n_stub_tokens + S, tcfg.d_model)
    _close(h, jh)
    assert float(aux) == 0.0
    # without a stub prefix the tokens alone run, as in federated training
    h0, _ = tmodel.forward_hidden(tp, tcfg, _t(tokens))
    _close(h0, jmodel.forward_hidden(jp, jcfg, _j(tokens))[0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("custom", [False, True])
def test_loss_fn_and_grads_match_reference(arch, custom):
    jcfg, tcfg, jp, tp = _weights(arch)
    tokens, stub, pos = _inputs(arch, custom, seed=1)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels, "stub_embeds": stub}
    if pos is not None:
        batch["positions"] = pos
    loss, metrics, grads = ttrain.value_and_grad(
        tp, tcfg, {k: _t(v) for k, v in batch.items()})
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {k: _j(v) for k, v
                                           in batch.items()}),
        has_aux=True)(jp)
    _close(loss, jloss)
    _close(metrics["xent"], jmetrics["xent"])
    got, want = lm_params_to_numpy(grads), jax.tree.map(np.asarray, jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w)


def _place_jax(cache, pcache):
    """The reference driver's move of the prefill KV into a decode cache
    (``src/repro/launch/serve.py``): a prefill cache longer than the decode
    cache is dropped, the decode cache keeps its zeros."""
    def place(c, pc):
        if c.shape == pc.shape:
            return pc.astype(c.dtype)
        if c.ndim == pc.ndim and pc.shape[2] <= c.shape[2]:
            return jax.lax.dynamic_update_slice_in_dim(
                c, pc.astype(c.dtype), 0, axis=2)
        return c
    return jax.tree.map(place, cache, pcache)


def _reference_decode(jcfg, jp, tokens, stub, pos, max_len, gen,
                      feed=None):
    """The reference's prefill into a cache of ``max_len`` positions, then
    ``gen`` - 1 greedy decode steps from n_stub + P (or teacher-forced on
    ``feed``): (tokens (B, gen), logits (gen, B, V))."""
    logits, pc = jmodel.prefill(jp, jcfg, _j(tokens), stub_embeds=_j(stub),
                                positions=_j(pos))
    cache = _place_jax(jmodel.init_cache(jcfg, B, max_len,
                                         dtype=jnp.float32), pc)
    start = tokens.shape[1] + (stub.shape[1] if stub is not None else 0)
    token = jnp.argmax(logits, axis=-1)[:, None]
    toks, all_logits = [token], [logits]
    for i in range(gen - 1):
        if feed is not None:
            token = jnp.asarray(feed[:, i:i + 1])
        logits, cache = jmodel.decode(jp, jcfg, token, cache,
                                      jnp.int32(start + i))
        token = jnp.argmax(logits, axis=-1)[:, None]
        toks.append(token)
        all_logits.append(logits)
    return np.concatenate(toks, axis=1), np.stack(all_logits)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("custom", [False, True])
def test_prefill_then_decode_matches_reference(arch, custom):
    """The port's prefill (stub prefix, positions) and three teacher-forced
    decode steps against the reference's, its cache sized to hold the
    prefill (n_stub + P + gen)."""
    jcfg, tcfg, jp, tp = _weights(arch)
    tokens, stub, pos = _inputs(arch, custom, seed=2)
    gen = 4
    feed = np.random.default_rng(3).integers(0, tcfg.vocab, (B, gen))
    _, want = _reference_decode(jcfg, jp, tokens, stub, pos,
                                tcfg.n_stub_tokens + S + gen, gen, feed)
    logits, pc = tmodel.prefill(tp, tcfg, _t(tokens), stub_embeds=_t(stub),
                                positions=_t(pos))
    assert pc["layers"]["k"].shape[2] == tcfg.n_stub_tokens + S
    cache = tmodel.init_cache(tcfg, B, tcfg.n_stub_tokens + S + gen,
                              device="cpu")
    for name, c in cache["layers"].items():
        c[:, :, :pc["layers"][name].shape[2]] = pc["layers"][name]
    got = [logits]
    for i in range(gen - 1):
        logits, cache = tmodel.decode(tp, tcfg, _t(feed[:, i:i + 1]), cache,
                                      tcfg.n_stub_tokens + S + i)
        got.append(logits)
    _close(torch.stack(got), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    """``serve`` (zero stub prefix, greedy) against the reference's model
    functions with a cache that holds the prefill."""
    jcfg, tcfg, jp, tp = _weights(arch)
    prompts = tserve.make_prompts(tcfg, B, 9, seed=1, device="cpu")
    gen = 5
    res = tserve.serve(tcfg, tp, prompts, gen, device="cpu")
    stub = np.zeros((B, tcfg.n_stub_tokens, tcfg.d_model), np.float32)
    toks, logits = _reference_decode(jcfg, jp, prompts.numpy(), stub, None,
                                     tcfg.n_stub_tokens + 9 + gen, gen)
    np.testing.assert_array_equal(res.tokens.numpy(), toks)
    _close(res.logits, logits)


# ---------------------------------------------- C5: the cache's sizing

def test_reference_serve_sizing_drops_the_prefill_cache():
    """C5: the reference's driver prefills n_stub + P positions into a
    decode cache of P + gen (``src/repro/launch/serve.py:36-52``). At
    reduced qwen2-vl (8 stubs, P 7, gen 4) the prefill's 15 positions do
    not fit 11, so ``place`` keeps the zeros, and the first decode step at
    position 15 attends to no prompt token: its logits differ from a
    prefill of the P + 1 tokens, which a cache of n_stub + P + gen
    reproduces."""
    jcfg, tcfg, jp, _ = _weights("qwen2-vl-2b")
    P, gen = 7, 4
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab, (B, P + 1))
    stub = np.zeros((B, tcfg.n_stub_tokens, tcfg.d_model), np.float32)
    _, pc = jmodel.prefill(jp, jcfg, _j(prompts[:, :P]), stub_embeds=_j(stub))
    dropped = _place_jax(jmodel.init_cache(jcfg, B, P + gen,
                                           dtype=jnp.float32), pc)
    assert pc["layers"]["k"].shape[2] == 15 and np.abs(
        np.asarray(pc["layers"]["k"])).max() > 0
    assert dropped["layers"]["k"].shape[2] == 11
    assert not np.asarray(dropped["layers"]["k"]).any()
    full, _ = jmodel.prefill(jp, jcfg, _j(prompts), stub_embeds=_j(stub))
    for max_len, agrees in ((P + gen, False),
                            (tcfg.n_stub_tokens + P + gen, True)):
        _, logits = _reference_decode(jcfg, jp, prompts[:, :P], stub, None,
                                      max_len, 2, feed=prompts[:, P:])
        gap = float(np.abs(logits[1] - np.asarray(full)).max())
        assert (gap <= TOL) == agrees, (max_len, gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_serve_decode_equals_prefill_of_p_plus_one(arch):
    """The port sizes the decode cache at n_stub + P + gen: its first
    decode step equals a prefill of the prompt and the first generated
    token, stub prefix included."""
    _, tcfg, _, tp = _weights(arch)
    prompts = tserve.make_prompts(tcfg, B, 7, seed=2, device="cpu")
    res = tserve.serve(tcfg, tp, prompts, 4, device="cpu")
    stub = tserve.stub_prefix(tcfg, B, "cpu")
    full, _ = tmodel.prefill(tp, tcfg, torch.cat([prompts,
                                                  res.tokens[:, :1]], 1),
                             stub_embeds=stub)
    _close(res.logits[1], full)


def test_single_client_trains_with_the_stub_prefix():
    """``single_client`` puts a zero stub prefix before every batch, as the
    reference's trainer: its first loss is the reference's ``loss_fn`` on
    that batch, and two SGD steps give the reference's params."""
    jcfg, tcfg, jp, tp = _weights("qwen2-vl-2b")
    raws = list(token_batch_stream(0, batch=B, seq_len=16, vocab=jcfg.vocab,
                                   n_batches=2))
    stub = jnp.zeros((B, jcfg.n_stub_tokens, jcfg.d_model), jnp.float32)
    vg = jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, jcfg, b)[0])
    params, losses = jp, []
    for raw in raws:
        loss, g = vg(params, {**{k: jnp.asarray(v) for k, v in raw.items()},
                              "stub_embeds": stub})
        params = jax.tree.map(lambda w, gw: w - 3e-3 * gw, params, g)
        losses.append(float(loss))
    res = ttrain.single_client(
        tcfg, steps=2, batch=B, seq=16, lr=3e-3,
        params=jax.tree.map(torch.clone, tp), device="cpu",
        log=lambda line: None)
    _close(np.asarray(res["losses"]), np.asarray(losses))
    got = lm_params_to_numpy(res["params"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(
            jax.tree.map(np.asarray, params))):
        _close(g, w)


# ------------------------------------ C6: a zero stub prefix at depth

def _deep(arch, n_layers=28):
    """``arch`` at reduced() width and ``n_layers`` layers, 64 stub
    tokens: (jcfg, tcfg, reference params, port params)."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(),
                               n_layers=n_layers, n_stub_tokens=64)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).reduced(),
                               n_layers=n_layers, n_stub_tokens=64)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, tcfg, jp, from_jax_lm_params(jax.tree.map(np.asarray, jp),
                                              tcfg, "cpu")


def test_zero_stub_prefix_overflows_the_backward_at_depth():
    """C6: the reference's trainer feeds zero stub embeddings
    (``src/repro/launch/train.py:66-68``). A zero row stays zero through
    every pre-norm layer, and each layer's RMSNorm of it scales its
    gradient by 1/sqrt(eps) = 316, so at qwen2-vl's 28 layers the
    backward overflows: the reference's gradients and the port's are
    NaN. Embeddings at the token embeddings' scale give finite gradients
    that agree."""
    jcfg, tcfg, jp, tp = _deep("qwen2-vl-2b")
    raw = next(token_batch_stream(0, batch=B, seq_len=16, vocab=jcfg.vocab))
    stub = np.zeros((B, 64, jcfg.d_model), np.float32)
    noise = (0.02 * np.random.default_rng(6).normal(size=stub.shape)).astype(
        np.float32)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, jcfg,
                                                                b)[0]))
    for prefix, finite in ((stub, False), (noise, True)):
        batch = {**raw, "stub_embeds": prefix}
        loss, grads = vg(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tloss, _, tgrads = ttrain.value_and_grad(
            tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        want = jax.tree.leaves(jax.tree.map(np.asarray, grads))
        got = jax.tree.leaves(lm_params_to_numpy(tgrads))
        assert np.isfinite(float(loss)) and np.isfinite(float(tloss))
        assert all(np.isfinite(g).all() for g in want) == finite
        assert all(np.isfinite(g).all() for g in got) == finite
        if finite:
            _close(tloss, loss)
            for g, w in zip(got, want):
                _close(g, w)
