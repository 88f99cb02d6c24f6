"""LM training in the port (``repro_torch.optim``, ``models.model.
softmax_xent``/``loss_fn``, ``launch.train``) against the reference on the
CPU, on reduced smollm-135m (2 layers, d 256, 4 heads over 2 KV heads of
64, vocab 512) with the reference's ``init_params`` weights carried across
and the same numpy token batches. Tolerances:
  - ``token_batch_stream``: byte-identical;
  - optimizers, ``clip_by_global_norm``, schedules, ``softmax_xent``: 1e-6;
  - ``loss_fn``: loss 1e-5, grads 1e-4;
  - 3 single-client steps (sgd, momentum): losses 1e-5, params 1e-4;
    AdamW losses 1e-4 and params 1e-4 except where the two packages'
    gradients part by more than 1e-4 / (3·lr) of the reference's at some
    step (its scale-free, sign-like update turns that into moves past
    1e-4; see the test);
  - 2 federated pFedWN rounds at C = 3 with 2 local steps on the
    reference's replayed init and link draws (``PRNGKey(0)`` split C ways
    for the init, split again each round for the links): target loss and
    π* 1e-4, links exact, params 1e-4; the mirror of the reference loop
    they are held to is itself held to the printout of the reference's
    own ``federated(args)``.
The card's training step against the CPU's is in ``tests/test_torch_gpu.py``.
"""
import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import em as jem
from repro.data import token_batch_stream as jstream
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch import optim as toptim
from repro_torch.configs import get_config as tget_config
from repro_torch.data import token_batch_stream as tstream
from repro_torch.kernels import weighted_agg as k2
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.utils.bridge import from_jax_lm_params, lm_params_to_numpy

torch.set_num_threads(1)

ARCH = "smollm-135m"
BATCH, SEQ, LR = 2, 32, 3e-3
C, ROUNDS, LOCAL = 3, 2, 2
P_ERR = [0.6, 0.6, 0.6]          # some links erased in the two rounds


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _close_tree(got, want, tol):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)


_STATE = {}


def _setup():
    """(reference cfg, port cfg, reference params, jitted value_and_grad)."""
    if not _STATE:
        jcfg = jget_config(ARCH).reduced()
        tcfg = tget_config(ARCH).reduced()
        assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                tcfg.resolved_head_dim, tcfg.vocab) == (2, 256, 4, 2, 64, 512)
        jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, jcfg, b)[0]))
        _STATE.update(jcfg=jcfg, tcfg=tcfg, jp=jp, vg=vg)
    s = _STATE
    return s["jcfg"], s["tcfg"], s["jp"], s["vg"]


def _port(tree):
    return from_jax_lm_params(jax.tree.map(np.asarray, tree), _setup()[1],
                              "cpu")


def _jbatch(raw):
    return {k: jnp.asarray(v) for k, v in raw.items()}


def _tbatch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


# ------------------------------------------------------------ data, optim

@pytest.mark.parametrize("seed,vocab", [(0, 512), (131, 49_152)])
def test_token_batch_stream_is_byte_identical(seed, vocab):
    got = list(tstream(seed, batch=3, seq_len=17, vocab=vocab, n_batches=3))
    want = list(jstream(seed, batch=3, seq_len=17, vocab=vocab, n_batches=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype == np.int32
            assert g[k].tobytes() == w[k].tobytes()


def _trees(seed):
    """A nested param tree and three gradient trees, numpy fp32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    shapes = {"a": (5, 3), "b": [(7,), (2, 2, 2)]}
    mk = lambda: {"a": f(*shapes["a"]), "b": [f(*s) for s in shapes["b"]]}
    return mk(), [mk() for _ in range(3)]


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_match_reference(name):
    params, grads = _trees(1)
    j_init, j_update = joptim.make_optimizer(name)
    t_init, t_update = toptim.make_optimizer(name)
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = j_init(jp), t_init(tp)
    for i, g in enumerate(grads):
        lr = 0.05 * (i + 1)
        jp, js = j_update(jp, jax.tree.map(jnp.asarray, g), js, lr)
        tp, ts = t_update(tp, _t(g), ts, lr)
        _close_tree(tp, jp, 1e-6)
        _close_tree(ts, js, 1e-6)
    assert tp["a"].dtype == torch.float32
    if name == "adamw":
        assert int(ts["t"]) == 3
        wd_j, _ = joptim.adamw_update(jp, jax.tree.map(jnp.asarray,
                                                       grads[0]), js, 0.1,
                                      weight_decay=0.01)
        wd_t, _ = toptim.adamw_update(tp, _t(grads[0]), ts, 0.1,
                                      weight_decay=0.01)
        _close_tree(wd_t, wd_j, 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    from repro.optim import sgd as jsgd
    _, grads = _trees(2)
    g = grads[0]
    _close(toptim.global_norm(_t(g)), jsgd.global_norm(
        jax.tree.map(jnp.asarray, g)), 1e-6)
    _close_tree(toptim.clip_by_global_norm(_t(g), max_norm),
                jsgd.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm), 1e-6)


def test_schedules_match_reference():
    pairs = [(toptim.constant(3e-3), joptim.constant(3e-3)),
             (toptim.cosine(1e-2, 50), joptim.cosine(1e-2, 50)),
             (toptim.cosine(1e-2, 0, 0.2), joptim.cosine(1e-2, 0, 0.2)),
             (toptim.warmup_cosine(1e-2, 10, 60),
              joptim.warmup_cosine(1e-2, 10, 60))]
    for t_fn, j_fn in pairs:
        for step in (0, 1, 5, 9, 10, 11, 37, 60, 75):
            _close(t_fn(step), j_fn(jnp.float32(step)), 1e-6)


# ------------------------------------------------------------ loss

def test_softmax_xent_masks_negative_labels_like_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 6] = -100
    for lab in (labels, np.full_like(labels, -1)):
        got = tmodel.softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(lab))
        want = jmodel.softmax_xent(jnp.asarray(logits), jnp.asarray(lab))
        _close(got, want, 1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_grads_match_reference(remat):
    jcfg, tcfg, jp, vg = _setup()
    raw = next(tstream(5, batch=BATCH, seq_len=SEQ, vocab=tcfg.vocab))
    jloss, jgrads = vg(jp, _jbatch(raw))
    jxent = jmodel.loss_fn(jp, jcfg, _jbatch(raw))[1]["xent"]
    loss, metrics, grads = ttrain.value_and_grad(_port(jp), tcfg,
                                                 _tbatch(raw), remat=remat)
    _close(loss, jloss, 1e-5)
    _close(metrics["xent"], jxent, 1e-5)
    assert float(metrics["aux"]) == float(metrics["mtp"]) == 0.0
    _close_tree(lm_params_to_numpy(grads), jgrads, 1e-4)


# ------------------------------------------------------------ single client

def _reference_single_client(name, steps):
    """The reference's ``single_client`` loop, returning its losses, its
    params and each step's gradients (its own function only prints the
    losses)."""
    jcfg, _, jp, vg = _setup()
    opt_init, opt_update = joptim.make_optimizer(name)
    state = opt_init(jp)
    losses, grads_by_step = [], []
    for _, raw in zip(range(steps), jstream(0, batch=BATCH, seq_len=SEQ,
                                            vocab=jcfg.vocab)):
        loss, grads = vg(jp, _jbatch(raw))
        grads_by_step.append(grads)
        jp, state = opt_update(jp, grads, state, LR)
        losses.append(float(loss))
    return losses, jp, grads_by_step


def _port_grads_by_step(name, steps):
    """The port's gradient at each step of its own ``single_client`` run:
    the params after ``t`` steps (a run of ``t`` steps) on batch ``t``."""
    _, tcfg, jp, _ = _setup()
    raws = list(tstream(0, batch=BATCH, seq_len=SEQ, vocab=tcfg.vocab,
                        n_batches=steps))
    out = []
    for t in range(steps):
        params = _port(jp) if t == 0 else ttrain.single_client(
            tcfg, steps=t, batch=BATCH, seq=SEQ, lr=LR, optimizer=name,
            params=_port(jp), device="cpu", log=lambda s: None)["params"]
        out.append(lm_params_to_numpy(
            ttrain.value_and_grad(params, tcfg, _tbatch(raws[t]))[2]))
    return out


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_single_client_steps_match_reference(name, tmp_path):
    _, tcfg, jp, _ = _setup()
    want_losses, want_params, want_grads = _reference_single_client(
        name, 3)
    ckpt = str(tmp_path / "port.npz")
    lines = []
    got = ttrain.single_client(tcfg, steps=3, batch=BATCH, seq=SEQ, lr=LR,
                               optimizer=name, ckpt=ckpt, params=_port(jp),
                               device="cpu", log=lines.append)
    got_params = lm_params_to_numpy(got["params"])
    if name != "adamw":
        _close(got["losses"], want_losses, 1e-5)
        _close_tree(got_params, want_params, 1e-4)
    else:
        # AdamW's step is lr·m̂/(√v̂ + eps), about lr·sign(g) early on: it
        # moves an element by at most ~lr a step whatever the gradient's
        # size, and a relative error r in that element's gradient moves it
        # by up to ~r·lr. So an element whose two gradients (each package's
        # at its own params) part by more than r = 1e-4 / (3·lr) of the
        # reference's at some step can leave 1e-4 in 3 steps from rounding
        # alone, and near-zero gradients part by far more than that; such
        # an element need only be finite. Every other param is held at
        # 1e-4, the first step's gradients (same params) at 1e-4, and the
        # losses at 1e-4 (the sign-like moves nudge later losses: the third
        # 7.7e-5 apart)
        steps, tol = 3, 1e-4
        _close(got["losses"], want_losses, tol)
        got_grads = _port_grads_by_step(name, steps)
        _close_tree(got_grads[0], want_grads[0], tol)
        r = tol / (steps * LR)
        for g, w, *gs in zip(jax.tree.leaves(got_params),
                             jax.tree.leaves(want_params),
                             *(jax.tree.leaves(x) for x in want_grads),
                             *(jax.tree.leaves(x) for x in got_grads)):
            w = np.asarray(w)
            assert np.all(np.isfinite(g))
            held = np.ones(w.shape, bool)
            for want_g, got_g in zip(gs[:steps], gs[steps:]):
                want_g = np.asarray(want_g)
                held &= np.abs(got_g - want_g) <= r * np.abs(want_g)
            _close(g[held], w[held], tol)
    assert [l.split(" (")[0] for l in lines[:3]] == [
        f"step {i:5d} loss {v:.4f}" for i, v in enumerate(got["losses"])]
    assert lines[-1] == f"saved {ckpt}"
    # the reference's loader reads the port's checkpoint, bit for bit
    tree, step = jload_checkpoint(ckpt, jax.tree.map(np.asarray, jp))
    assert step == 3
    for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(got_params)):
        assert np.array_equal(np.asarray(g), w)


def test_single_client_matches_reference_printout(capsys):
    """The reference's own ``single_client`` prints every step's loss at 3
    steps; the port's losses round to the same 4 decimals (±1 in the
    last)."""
    args = argparse.Namespace(arch=ARCH, full=False, steps=3, batch=BATCH,
                              seq=SEQ, lr=LR, optimizer="sgd", ckpt=None)
    jtrain.single_client(args)
    printed = [float(v) for v in re.findall(r"loss (\S+)",
                                            capsys.readouterr().out)]
    _, tcfg, jp, _ = _setup()
    got = ttrain.single_client(tcfg, steps=3, batch=BATCH, seq=SEQ, lr=LR,
                               params=_port(jp), device="cpu",
                               log=lambda s: None)
    assert len(printed) == 3
    _close(got["losses"], printed, 1.5e-4)


# ------------------------------------------------------------ federated

def _replayed_draws():
    """The reference's ``federated`` draws replayed outside it: C client
    inits from ``split(PRNGKey(0), C)``, then each round ``key, k1 =
    split(key)`` and links ``uniform(k1, (C - 1,)) >= p_err[1:]``."""
    jcfg = _setup()[0]
    key = jax.random.PRNGKey(0)
    params = jax.vmap(lambda k: jmodel.init_params(k, jcfg, jnp.float32))(
        jax.random.split(key, C))
    links = []
    for _ in range(ROUNDS):
        key, k1 = jax.random.split(key)
        links.append(np.asarray(jax.random.uniform(k1, (C - 1,))
                                >= jnp.asarray(P_ERR)[1:]))
    return params, np.stack(links)


def _reference_federated(params, links):
    """The reference ``federated`` loop (train.py:78-143) with the clients
    in a Python loop, returning what it prints, unrounded, and the final
    params."""
    jcfg, _, _, vg = _setup()
    streams = [jstream(100 + 31 * c, batch=BATCH, seq_len=SEQ,
                       vocab=jcfg.vocab) for c in range(C)]
    pi = jnp.full((C,), 1.0 / (C - 1))
    hist = {"target_loss": [], "pi": []}
    for rnd in range(ROUNDS):
        batches = [[next(streams[c]) for _ in range(LOCAL)]
                   for c in range(C)]
        clients = []
        for c in range(C):
            p = jax.tree.map(lambda x: x[c], params)
            for raw in batches[c]:
                _, g = vg(p, _jbatch(raw))
                p = jax.tree.map(lambda w, gw: w - LR * gw, p, g)
            clients.append(p)
        params = jax.tree.map(lambda *xs: jnp.stack(xs), *clients)
        probe = _jbatch(next(streams[0]))
        neighbors = jax.tree.map(lambda p: p[1:], params)
        losses = jnp.stack([vg(clients[m], probe)[0]
                            for m in range(1, C)])[None, :]
        pi_star, _ = jem.em_weights(pi[:C - 1] / jnp.sum(pi[:C - 1]),
                                    losses, iters=3)
        target = jax.tree.map(lambda p: p[0], params)
        mixed = jagg.mix_params_with_erasures(target, neighbors, pi_star,
                                              0.5, jnp.asarray(links[rnd]))
        params = jax.tree.map(lambda s, t: s.at[0].set(t), params, mixed)
        l0, _ = vg(mixed, _jbatch(next(streams[0])))
        hist["target_loss"].append(float(l0))
        hist["pi"].append(np.asarray(pi_star))
    hist["params"] = params
    return hist


def test_federated_rounds_match_reference(capsys):
    jparams, links = _replayed_draws()
    want = _reference_federated(jparams, links)

    # the mirror is the reference: its own federated() prints the same
    args = argparse.Namespace(arch=ARCH, full=False, clients=C,
                              rounds=ROUNDS, local_steps=LOCAL, batch=BATCH,
                              seq=SEQ, lr=LR, alpha=0.5, p_err=P_ERR)
    jtrain.federated(args)
    printed = re.findall(r"round (\d+): target loss (\S+) pi=\[([^\]]*)\] "
                         r"links=\[([^\]]*)\]", capsys.readouterr().out)
    assert len(printed) == ROUNDS
    for rnd, (_, loss, pi, link) in enumerate(printed):
        assert abs(float(loss) - want["target_loss"][rnd]) <= 1.5e-4
        np.testing.assert_allclose([float(x) for x in pi.split()],
                                   want["pi"][rnd], atol=1.5e-3)
        assert [int(x) for x in link.split()] == links[rnd].astype(
            int).tolist()
    assert not links.all()                  # an erased link is replayed

    _, tcfg, _, _ = _setup()
    ported = [_port(jax.tree.map(lambda x: x[c], jparams)) for c in range(C)]
    stacked = jax.tree.map(lambda *xs: torch.stack(xs), *ported)
    n2 = k2.launches
    got = ttrain.federated(tcfg, clients=C, rounds=ROUNDS,
                           local_steps=LOCAL, batch=BATCH, seq=SEQ, lr=LR,
                           p_err=P_ERR, params=stacked, link_masks=links,
                           device="cpu", log=lambda s: None)
    assert k2.launches == n2                 # CPU tensors: the plain mix
    _close(got["target_loss"], want["target_loss"], 1e-4)
    _close(np.stack(got["pi"]), np.stack(want["pi"]), 1e-4)
    np.testing.assert_array_equal(np.stack(got["links"]), links)
    _close_tree(lm_params_to_numpy(got["params"]), want["params"], 1e-4)


# ------------------------------------------------------------ entry point

def test_train_cli_runs_both_modes_on_cpu(capsys):
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                 "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert len(re.findall(r"^step +\d+ loss \d", out, re.M)) == 3
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--clients", "3",
                 "--rounds", "2", "--local-steps", "1", "--batch", "2",
                 "--seq", "16"])
    rounds = re.findall(r"round \d: target loss (\S+) pi=\[([^\]]*)\]",
                        capsys.readouterr().out)
    assert len(rounds) == 2
    for loss, pi in rounds:
        assert np.isfinite(float(loss))
        assert abs(sum(float(x) for x in pi.split()) - 1) < 2e-3
    with pytest.raises(ValueError, match="2 clients"):
        ttrain.federated(tget_config(ARCH).reduced(), clients=1, rounds=1,
                         local_steps=1, batch=1, seq=4, device="cpu")
