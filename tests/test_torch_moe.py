"""The port's Mixture-of-Experts layer and MoE language models against the
reference: granite-moe-3b-a800m and deepseek-v3-671b at ``reduced()``
(deepseek: MLA with K3 at head dim 48, one dense layer, a shared expert and
the MTP head). Every case carries the reference's fp32 ``init_params``
weights across through ``from_jax_lm_params`` and feeds both sides the
same numpy inputs. ``reduced()`` sets a capacity factor of 4, which never
drops a pair, so each case also runs with a factor that drops (the same
config on both sides) and checks that pairs were dropped. Tolerances:
1e-5 for the MoE layer, its gradients and ``loss_fn``; 1e-4 for serving
(``tests/test_torch_lm.py``'s). Where routing is compared, the smallest gap
between the k-th and (k+1)-th router probability is printed beside the
error: a top-k flip within rounding shows as a gap near 1e-7."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import make_prompts, prefill_to_cache, serve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
# capacity factors: reduced()'s drop-free 4.0, and 0.25, which drops
CAPACITY = {"free": None, "drops": 0.25}
TOL = 1e-5
SERVE_TOL = 1e-4
B = 2


def _cfgs(arch, capacity):
    """(reference config, port config), reduced, at capacity ``capacity``
    (a key of ``CAPACITY``)."""
    cfgs = []
    for pkg in (jconfigs, tconfigs):
        cfg = pkg.get_config(arch).reduced()
        if CAPACITY[capacity] is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=CAPACITY[capacity]))
        cfgs.append(cfg)
    return tuple(cfgs)


_WEIGHTS = {}


def _weights(arch):
    """(reference params, port params) on the CPU; the capacity factor is
    not a weight, so both capacities share them."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, "free")
        jp = jax.jit(lambda key: jmodel.init_params(key, jcfg, jnp.float32))(
            jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, from_jax_lm_params(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _WEIGHTS[arch]


def _close(got, expect, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(expect), atol=tol, rtol=tol)


def _moe_layer(jp, tp):
    """Layer 0 of ``layers`` (the first MoE layer) on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["moe"]),
            tmodel.unstack(tp["layers"])[0]["moe"])


def _x(cfg, S=16, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _tree_close(got, expect, tol=TOL):
    for g, e in zip(jax.tree.leaves(lm_params_to_numpy(got)),
                    jax.tree.leaves(expect)):
        _close(g, e, tol)


@pytest.fixture
def routed(monkeypatch):
    """Records ``routing_stats`` of every ``moe_apply`` call the model
    makes: a list of (dropped pairs, pairs, smallest top-k gap)."""
    calls = []
    apply = tmoe.moe_apply

    def recording(params, cfg, x):
        with torch.no_grad():
            d, n, gap = tmoe.routing_stats(params["router"], x, cfg.moe)
        calls.append((int(d), n, float(gap)))
        return apply(params, cfg, x)

    monkeypatch.setattr(tmoe, "moe_apply", recording)
    return calls


def _report(calls, what, capacity):
    """Print the dropped share and the smallest gap; with a dropping
    capacity, pairs must have been dropped."""
    dropped = sum(c[0] for c in calls)
    pairs = sum(c[1] for c in calls)
    gap = min(c[2] for c in calls)
    print(f"{what}: dropped {dropped} of {pairs} pairs, smallest top-k gap "
          f"{gap:.3g}")
    assert (dropped > 0) == (capacity == "drops")
    return gap


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
    allocated) has the reference's keys and shapes (``jax.eval_shape``);
    granite-moe-3b-a800m holds 3,374,295,552 parameters."""
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    jshape = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    tp = tmodel.init_params(tcfg, torch.Generator(), device="meta")
    ours = jax.tree.map(lambda t: tuple(t.shape), tp,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert ours == jax.tree.map(lambda s: tuple(s.shape), jshape)
    n = sum(t.numel() for t in jax.tree.leaves(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    if arch == "granite-moe-3b-a800m":
        assert n == 3_374_295_552
        assert ours["layers"]["moe"] == {"router": (32, 1536, 40),
                                         "w_gate": (32, 40, 1536, 512),
                                         "w_up": (32, 40, 1536, 512),
                                         "w_down": (32, 40, 512, 1536)}
    else:
        assert set(ours) >= {"dense_layers", "mtp", "mtp_ln"}
        assert ours["dense_layers"]["ln1"] == (3, 7168)
        assert ours["layers"]["moe"]["shared"]["w_up"] == (58, 7168, 2048)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree_and_distributions(arch):
    jcfg, tcfg = _cfgs(arch, "free")
    jp, _ = _weights(arch)
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
def test_bridge_carries_the_moe_tree_exactly(arch):
    jp, tp = _weights(arch)
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("T,factor,expect", [(8192, 1.25, 2048),
                                             (8, 1.25, 8), (32, 4.0, 64),
                                             (32, 0.25, 8), (48, 0.25, 8),
                                             (1000, 1.0, 200)])
def test_capacity_is_the_reference_arithmetic(T, factor, expect):
    """granite-moe's prefill (T 8192) and decode (T 8), then reduced()'s
    E 4 and k 2 (1000 tokens: granite's E and k)."""
    m = tconfigs.get_config("granite-moe-3b-a800m").moe
    if T <= 48:
        m = dataclasses.replace(m, n_experts=4, top_k=2)
    m = dataclasses.replace(m, capacity_factor=factor)
    assert tmoe.capacity(m, T) == expect


@pytest.mark.parametrize("arch", ARCHS)
def test_router_and_balance_loss_match_reference(arch):
    jcfg, tcfg = _cfgs(arch, "free")
    jl, tl = _moe_layer(*_weights(arch))
    xt = _x(tcfg).reshape(-1, tcfg.d_model)
    gates, ids, probs = tmoe.router_probs(tl["router"], torch.from_numpy(xt),
                                          tcfg.moe.top_k)
    jgates, jids, jprobs = jmoe.router_probs(jl["router"], jnp.asarray(xt),
                                             jcfg.moe.top_k)
    _, _, gap = tmoe.routing_stats(tl["router"], torch.from_numpy(xt),
                                   tcfg.moe)
    print(f"smallest top-k gap {float(gap):.3g}")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(gates, jgates)
    _close(probs, jprobs)
    _close(gates.sum(-1), np.ones(xt.shape[0]))
    _close(tmoe.load_balance_loss(probs, ids, tcfg.moe.n_experts),
           jmoe.load_balance_loss(jprobs, jids, jcfg.moe.n_experts))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_apply_matches_reference(arch, capacity):
    """Output and aux; with the dropping factor pairs are dropped, and the
    layer's output is not the drop-free one."""
    jcfg, tcfg = _cfgs(arch, capacity)
    jl, tl = _moe_layer(*_weights(arch))
    x = _x(tcfg)
    out, aux = tmoe.moe_apply(tl, tcfg, torch.from_numpy(x))
    jout, jaux = jmoe.moe_apply(jl, jcfg, jnp.asarray(x))
    dropped, pairs, gap = tmoe.routing_stats(tl["router"],
                                             torch.from_numpy(x), tcfg.moe)
    err = float(np.abs(out.numpy() - jout).max())
    print(f"{arch} {capacity}: max|d|={err:.3g}, dropped {int(dropped)} of "
          f"{pairs}, smallest top-k gap {float(gap):.3g}")
    assert (int(dropped) > 0) == (capacity == "drops")
    assert out.shape == x.shape and out.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)
    if capacity == "drops":
        free, _ = tmoe.moe_apply(tl, _cfgs(arch, "free")[1],
                                 torch.from_numpy(x))
        assert float((free - out).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_moe_apply_grads_match_reference(arch, capacity):
    """Gradients of sum(sin(out)) + aux as to the input and every weight,
    against ``jax.grad`` through the reference's ``routed_gather``."""
    jcfg, tcfg = _cfgs(arch, capacity)
    jl, tl = _moe_layer(*_weights(arch))
    x = _x(tcfg, seed=3)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(jnp.sin(y)) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl, jnp.asarray(x))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tl,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_apply(params, tcfg, xt)
    (torch.sin(y).sum() + aux).backward()
    _close(xt.grad, jgx)
    _tree_close(jax.tree.map(lambda t: t.grad, params,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                jgp)


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_loss_and_grads_match_reference(capacity, routed):
    """deepseek-v3's ``loss_fn`` (xent + 0.3 · mtp + aux: a dense layer,
    an MoE layer with a shared expert, the MTP head) and its metrics and
    gradients under ``jax.value_and_grad``."""
    arch = "deepseek-v3-671b"
    jcfg, tcfg = _cfgs(arch, capacity)
    jp, tp = _weights(arch)
    toks = _tokens(tcfg, 24, seed=6)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    loss, metrics = tmodel.loss_fn(params, tcfg, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    loss.backward()
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)}),
        has_aux=True))(jp)
    _report(routed, f"{arch} {capacity} loss_fn", capacity)
    _close(loss, jloss)
    for name in ("xent", "aux", "mtp"):
        _close(metrics[name], jmetrics[name])
        assert float(metrics[name].detach()) > 0
    _tree_close(jax.tree.map(lambda t: t.grad, params,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                jgrads)


def _place_jax(cache, pcache):
    """``launch/serve.py``'s move of the prefill cache into a max-len one."""
    return jax.tree.map(lambda c, pc: jax.lax.dynamic_update_slice_in_dim(
        c, pc.astype(c.dtype), 0, axis=2), cache, pcache)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_serve_matches_reference_greedy_loop(arch, capacity, routed):
    """``serve`` against ``launch/serve.py``'s loop on the reference: the
    same greedy tokens and per-step logits; the prefill's caches, then both
    caches after a teacher-forced step, ``dense_layers`` included."""
    jcfg, tcfg = _cfgs(arch, capacity)
    jp, tp = _weights(arch)
    P, gen = 24, 4
    prompts = make_prompts(tcfg, B, P, seed=1, device="cpu")
    res = serve(tcfg, tp, prompts, gen, device="cpu")
    gap = _report(routed[:tcfg.n_layers - tcfg.moe.first_k_dense],
                  f"{arch} {capacity} prefill", capacity)
    assert res.tokens.shape == (B, gen)
    jlogits, jpc = jmodel.prefill(jp, jcfg, jnp.asarray(prompts.numpy()))
    jcache = _place_jax(jmodel.init_cache(jcfg, B, P + gen,
                                          dtype=jnp.float32), jpc)
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, jcfg, t, c, pos))
    token = jnp.argmax(jlogits, axis=-1)[:, None]
    jtokens, jall = [token], [jlogits]
    for i in range(gen - 1):
        jlogits, jcache = dec(jp, token, jcache, jnp.int32(P + i))
        token = jnp.argmax(jlogits, axis=-1)[:, None]
        jtokens.append(token)
        jall.append(jlogits)
    err = float(np.abs(res.logits.numpy() - np.stack(jall)).max())
    print(f"max|dlogits|={err:.3g}, smallest prefill top-k gap {gap:.3g}")
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate(jtokens, axis=1))
    _close(res.logits, np.stack(jall), SERVE_TOL)

    _, pcache = tmodel.prefill(tp, tcfg, prompts)
    assert set(pcache) == set(jpc)
    assert ("dense_layers" in pcache) == (arch == "deepseek-v3-671b")
    for group in pcache:
        assert set(pcache[group]) == set(jpc[group])
        for name in pcache[group]:
            _close(pcache[group][name], jpc[group][name], SERVE_TOL)
    _, cache = prefill_to_cache(tp, tcfg, prompts, P + gen)
    step = torch.from_numpy(np.array(jtokens[0]))
    logits, cache = tmodel.decode(tp, tcfg, step, cache, P)
    _, jcache = dec(jp, jtokens[0], _place_jax(
        jmodel.init_cache(jcfg, B, P + gen, dtype=jnp.float32), jpc),
        jnp.int32(P))
    _close(logits, jall[1], SERVE_TOL)
    assert set(cache) == set(jcache)
    for group in cache:
        for name in cache[group]:
            _close(cache[group][name], jcache[group][name], SERVE_TOL)


def test_mtp_is_train_only():
    """The MTP head has no cache and no part in serving: the decode cache
    has only the layer groups, and serving never reads ``mtp``."""
    _, tcfg = _cfgs("deepseek-v3-671b", "free")
    _, tp = _weights("deepseek-v3-671b")
    cache = tmodel.init_cache(tcfg, B, 8, device="cpu")
    assert set(cache) == {"dense_layers", "layers"}
    assert cache["dense_layers"]["c_kv"].shape[0] == 1
    assert cache["layers"]["c_kv"].shape[0] == 1
    prompts = make_prompts(tcfg, B, 5, seed=1, device="cpu")
    stripped = {k: v for k, v in tp.items() if not k.startswith("mtp")}
    a = serve(tcfg, tp, prompts, 3, device="cpu")
    b = serve(tcfg, stripped, prompts, 3, device="cpu")
    assert torch.equal(a.logits, b.logits)
