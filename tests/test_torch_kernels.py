"""The port's kernels, K1 (EM E-step) and K2 (Eq-1 mix).

On the CPU each wrapper runs its plain version, which is held against the
reference's jnp oracle and its Pallas kernel in interpret mode, at the
reference's sweep shapes and tolerances (``tests/test_kernels.py``), and on
the ragged shapes the pFedWN round gives it. ``test_torch_gpu.py`` holds
each CUDA kernel against its plain version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_aggregation
from repro.core import em as ref_em
from repro.kernels import ref as jref
from repro.kernels.em_posterior import em_posterior as pallas_em_posterior
from repro.kernels.weighted_agg import weighted_agg as pallas_weighted_agg
from repro.models import cnn as ref_cnn
from repro_torch.core import aggregation
from repro_torch.kernels import em_posterior as k1
from repro_torch.kernels import weighted_agg as k2
from repro_torch.kernels.ref import em_posterior_ref

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _em_inputs(M, T, V, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=M)
    pi = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    logits = (rng.normal(size=(M, T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    return pi, logits, labels


def _em_port(pi, logits, labels, tdtype, device="cpu"):
    return k1.em_posterior_forward(
        torch.from_numpy(pi).to(device),
        torch.from_numpy(logits).to(device=device, dtype=tdtype),
        torch.from_numpy(labels).long().to(device))


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("M,T,V", [(2, 128, 512), (4, 128, 1024),
                                   (8, 256, 512), (3, 384, 1536)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_plain_matches_reference(M, T, V, dtype):
    tdtype, jdtype = DTYPES[dtype]
    pi, logits, labels = _em_inputs(M, T, V)
    lam, ell = _em_port(pi, logits, labels, tdtype)
    jl = jnp.asarray(logits).astype(jdtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jref.em_posterior_ref(pi, jl, labels)),
        atol=tol)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(pallas_em_posterior(pi, jl, labels)),
        atol=tol)
    np.testing.assert_allclose(lam.sum(1).numpy(), 1.0, atol=1e-4)
    assert ell.shape == (T, M) and lam.dtype == ell.dtype == torch.float32


@pytest.mark.parametrize("M,T,V", [(3, 37, 10), (10, 512, 10), (1, 5, 3),
                                   (32, 9, 33)])
def test_em_posterior_ragged_matches_reference(M, T, V):
    """Shapes the Pallas kernel refuses (T % 128, V % 512), which the
    pFedWN round gives (V = n_classes)."""
    pi, logits, labels = _em_inputs(M, T, V, seed=1)
    lam, ell = _em_port(pi, logits, labels, torch.float32)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jref.em_posterior_ref(pi, logits, labels)),
        atol=1e-5)
    ce = (jax.nn.logsumexp(logits, axis=2)
          - jnp.take_along_axis(logits, labels[None, :, None], axis=2)[..., 0])
    np.testing.assert_allclose(ell.numpy(), np.asarray(ce).T, atol=1e-5)


def test_em_posterior_matches_core_posterior_on_ce_losses():
    M, T, V = 3, 128, 512
    pi, logits, labels = _em_inputs(M, T, V, seed=2)
    lam, ell = _em_port(pi, logits, labels, torch.float32)
    ce = (jax.nn.logsumexp(logits, axis=2)
          - jnp.take_along_axis(logits, labels[None, :, None], axis=2)[..., 0])
    expect = ref_em.posterior(pi, ce.T, min_weight=0.0)
    np.testing.assert_allclose(lam.numpy(), np.asarray(expect), atol=1e-5)
    np.testing.assert_allclose(ell.numpy(), np.asarray(ce).T, atol=1e-5)


@pytest.mark.parametrize("M", [33, 39, 64, 257])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_past_32_components_matches_reference(M, dtype):
    """More components than a warp's lanes (a target with more than 32
    selected neighbours, which the reference runs): the port against the
    reference's oracle in both dtypes and, in fp32, against the core
    posterior on the same cross-entropies."""
    tdtype, jdtype = DTYPES[dtype]
    T, V = 24, 10
    pi, logits, labels = _em_inputs(M, T, V, seed=3)
    lam, ell = _em_port(pi, logits, labels, tdtype)
    assert lam.shape == ell.shape == (T, M)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jl = jnp.asarray(logits).astype(jdtype)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jref.em_posterior_ref(pi, jl, labels)),
        atol=tol)
    np.testing.assert_allclose(lam.sum(1).numpy(), 1.0, atol=1e-4)
    if dtype == "float32":
        ce = (jax.nn.logsumexp(logits, axis=2)
              - jnp.take_along_axis(logits, labels[None, :, None],
                                    axis=2)[..., 0])
        expect = ref_em.posterior(pi, ce.T, min_weight=0.0)
        np.testing.assert_allclose(lam.numpy(), np.asarray(expect),
                                   atol=1e-5)
        np.testing.assert_allclose(ell.numpy(), np.asarray(ce).T, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_em_posterior_backward_matches_jax_vjp(dtype):
    """ℓ's backward, ct·(softmax_V(logits) − onehot(y)), equals the VJP of
    the reference's per-sample NLL with respect to the logits."""
    tdtype, _ = DTYPES[dtype]
    M, T, V = 4, 37, 10
    pi, logits, labels = _em_inputs(M, T, V, seed=3)
    ct = np.random.default_rng(4).uniform(0, 1, (T, M)).astype(np.float32)
    lt = torch.from_numpy(logits).to(tdtype).requires_grad_(True)
    lam, ell = k1.em_posterior(torch.from_numpy(pi), lt,
                               torch.from_numpy(labels).long())
    assert not lam.requires_grad
    (g,) = torch.autograd.grad(ell, lt, grad_outputs=torch.from_numpy(ct))
    assert g.dtype == tdtype

    def nll(lg):   # (M, T, V) -> (T, M), the reference's CE on logits
        logp = jax.nn.log_softmax(lg, axis=-1)
        return -jnp.take_along_axis(logp, labels[None, :, None],
                                    axis=-1)[..., 0].T

    jl = jnp.asarray(lt.detach().float().numpy())
    _, pullback = jax.vjp(nll, jl)
    (expect,) = pullback(jnp.asarray(ct))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(g.float().numpy(), np.asarray(expect),
                               atol=tol)


def test_em_posterior_backward_through_cnn_matches_jax():
    """Pulled back through the CNN forward, the kernel's ℓ gives the
    reference's vjp of per-sample NLL losses with respect to the params."""
    from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
    from repro_torch.configs import CNNConfig
    from repro_torch.core.fedsim import cnn_fns
    from repro_torch.models import cnn
    from repro_torch.utils.bridge import from_jax_params, to_numpy

    kw = dict(image_size=8, widths=(4,), hidden=16, n_classes=4)
    M, T = 3, 12
    tree = jax.tree.map(np.asarray, jax.vmap(
        lambda k: ref_cnn.init_params(k, RefCNNConfig(**kw)))(
            jax.random.split(jax.random.PRNGKey(0), M)))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (T, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, T).astype(np.int32)
    ct = rng.uniform(0, 1, (T, M)).astype(np.float32)
    pi = np.full(M, 1.0 / M, np.float32)

    layout = cnn.param_layout(CNNConfig(**kw))
    flat = from_jax_params(tree, "cpu").requires_grad_(True)
    logits = cnn_fns(layout).logits(flat, torch.from_numpy(x)[None])
    _, ell = k1.em_posterior(torch.from_numpy(pi), logits,
                             torch.from_numpy(y).long())
    (g,) = torch.autograd.grad(ell, flat, grad_outputs=torch.from_numpy(ct))

    def losses(p):
        return jax.vmap(lambda q: ref_cnn.per_sample_nll(q, x, y))(p).T

    _, pullback = jax.vjp(losses, tree)
    (expect,) = pullback(jnp.asarray(ct))
    for a, b in zip(jax.tree.leaves(to_numpy(g, layout)),
                    jax.tree.leaves(expect)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_em_posterior_rejects_what_the_kernel_does_not_take():
    pi, logits, labels = _em_inputs(3, 8, 5)
    args = (torch.from_numpy(pi), torch.from_numpy(logits),
            torch.from_numpy(labels).long())
    with pytest.raises(ValueError):   # no component (any M >= 1 runs)
        k1.em_posterior_forward(torch.ones(0), torch.zeros(0, 8, 5), args[2])
    with pytest.raises(TypeError):
        k1.em_posterior_forward(args[0], args[1].double(), args[2])
    with pytest.raises(ValueError):
        k1.em_posterior_forward(args[0], args[1], args[2].int())
    with pytest.raises(ValueError):
        k1.em_posterior_forward(args[0], args[1].transpose(1, 2), args[2])
    with pytest.raises(ValueError):   # no CPU fallback for other devices
        k1.em_posterior_forward(*(a.to("meta") for a in args))


def test_em_posterior_cpu_path_counts_no_launch():
    before = k1.launches
    _em_port(*_em_inputs(3, 8, 5), torch.float32)
    assert k1.launches == before


@pytest.mark.parametrize("M,T,V,dtype,address,expect", [
    # the round: fp32 rows of 40 B take 8-byte vectors, two lanes a row
    # (4 vectors a lane hold 8 logits), 4 tokens (40 rows, 80 lanes) a
    # block of 96 threads, 128 blocks
    (10, 512, 10, torch.float32, 1 << 20, (2, 8, 4, 96)),
    (10, 512, 10, torch.bfloat16, 1 << 20, (2, 4, 4, 96)),
    # a view 4 bytes past an 8-byte boundary: 4-byte vectors, four lanes
    (10, 512, 10, torch.float32, (1 << 20) + 4, (4, 4, 4, 160)),
    (10, 512, 10, torch.bfloat16, (1 << 20) + 2, (4, 2, 4, 160)),
    (1, 16, 1, torch.float32, 1 << 20, (1, 4, 1, 32)),
    # 4 vectors of 16 bytes: 16 fp32 logits a lane, 32 bf16
    (32, 9, 16, torch.float32, 1 << 20, (1, 16, 1, 32)),
    (32, 9, 32, torch.float32, 1 << 20, (2, 16, 1, 64)),
    (32, 9, 32, torch.bfloat16, 1 << 20, (1, 16, 1, 32)),
    # odd V: scalar loads, 4 logits a lane
    (3, 100, 33, torch.float32, 1 << 20, (16, 4, 1, 64)),
    (17, 53, 31, torch.float32, 1 << 20, (8, 4, 1, 160)),
    (8, 33, 1024, torch.float32, 1 << 20, (32, 16, 1, 256)),
    (2, 70, 1025, torch.float32, 1 << 20, (32, 4, 1, 64)),
    (32, 16, 1025, torch.bfloat16, 1 << 20, (32, 2, 1, 256)),
    # a vocabulary's width: a warp a row, 16-byte vectors, 512 blocks
    (8, 512, 49_152, torch.float32, 1 << 20, (32, 16, 1, 256)),
    (8, 512, 49_152, torch.bfloat16, 1 << 20, (32, 16, 1, 256)),
    # many tokens: the tile grows so the grid stays one block an SM
    (1, 4099, 10, torch.float32, 1 << 20, (2, 8, 32, 64)),
])
def test_em_posterior_plan_follows_width_and_alignment(M, T, V, dtype,
                                                       address, expect):
    """K1's team of lanes a row and its vector width follow V and the
    alignment the logits' address and a row's bytes share; its token tile
    keeps the grid near one block an SM of an H100 (132). The kernel's
    tuning: 4 vectors a lane a chunk, at most 256 threads a block."""
    assert tuple(k1.plan(M, T, V, dtype, address, 132, 4, 256)) == expect


@pytest.mark.parametrize("M", [1, 10, 17, 32, 33, 39, 64, 256, 257, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_em_posterior_plan_fits_the_kernel(M, dtype):
    """Over widths on both sides of every team-size switch, ragged T and
    unaligned views: every plan is one the launcher takes, covers every
    token, and reads a row of up to a warp's share in one chunk. A tile's
    rows fit the kernel's shared-memory stage of 256, or (past M = 256)
    the tile is one token, staged in the kernel's outputs."""
    elem = 4 if dtype == torch.float32 else 2
    for V in (1, 2, 10, 31, 32, 33, 255, 256, 1024, 1025, 49_152):
        for T in (1, 37, 131, 133, 512, 4099):
            for offset in (0, elem, 8, 16):
                p = k1.plan(M, T, V, dtype, (1 << 20) + offset, 132, 4, 256)
                blocks = -(-T // p.tile)
                assert p.team in (1, 2, 4, 8, 16, 32)
                assert V * elem % p.vector_bytes == 0
                assert offset % p.vector_bytes == 0
                assert 1 <= p.tile
                assert p.tile * M <= 256 or (p.tile == 1 and M > 256)
                assert p.threads % 32 == 0 and p.tile <= p.threads <= 256
                assert p.tile * M * p.team <= p.threads or p.tile == 1
                assert blocks <= 132 or p.tile * M * p.team * 2 > 256
                chunk = p.team * 4 * p.vector_bytes // elem
                assert chunk >= V or p.team == 32
                assert p.team == 1 or chunk // 2 < V


@pytest.mark.parametrize("M,T,V,scale", [
    (10, 512, 10, 3), (10, 512, 10, 100), (17, 53, 31, 100),
    (3, 64, 1024, 100), (2, 16, 1025, 3), (2, 8, 49_152, 100)])
def test_em_posterior_plain_ell_meets_the_gate_at_large_logits(M, T, V,
                                                               scale):
    """The plain version, which the kernel is held to on the card, keeps ℓ
    within atol and rtol 1e-5 of its float64 value and λ within 1e-5 of the
    JAX oracle, also with logits 100x the sweep's, where ℓ reaches ~10^3."""
    pi, logits, labels = _em_inputs(M, T, V, seed=6)
    logits = logits * scale
    y = torch.from_numpy(labels).long()
    lam, ell = em_posterior_ref(torch.from_numpy(pi),
                                torch.from_numpy(logits), y)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jref.em_posterior_ref(pi, logits, labels)),
        atol=1e-5, rtol=0)
    l64 = torch.from_numpy(logits).double()
    exact = torch.logsumexp(l64, -1) - l64.gather(
        2, y[None, :, None].expand(M, -1, 1))[..., 0]
    torch.testing.assert_close(ell.double(), exact.T, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- K2

def _agg_inputs(M, P, seed=0):
    rng = np.random.default_rng(seed)
    own = rng.normal(size=P).astype(np.float32)
    nb = rng.normal(size=(M, P)).astype(np.float32)
    z = rng.normal(size=M)
    pi = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    return own, nb, pi


@pytest.mark.parametrize("M,P", [(2, 4096), (4, 10000), (8, 65536),
                                 (3, 8191), (5, 128)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_weighted_agg_plain_matches_reference(M, P, dtype, alpha):
    tdtype, jdtype = DTYPES[dtype]
    own, nb, pi = _agg_inputs(M, P)
    out = k2.weighted_agg(torch.from_numpy(own).to(tdtype),
                          torch.from_numpy(nb).to(tdtype),
                          torch.from_numpy(pi), alpha)
    assert out.dtype == tdtype and out.shape == (P,)
    jo, jn = jnp.asarray(own).astype(jdtype), jnp.asarray(nb).astype(jdtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    got = out.float().numpy()
    for expect in (jref.weighted_agg_ref(jo, jn, pi, alpha),
                   pallas_weighted_agg(jo, jn, pi, alpha)):
        np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                                   atol=tol, rtol=tol)


def test_weighted_agg_reads_rows_by_index_and_gates_on_any_ok():
    own, nb, pi = _agg_inputs(4, 1000, seed=1)
    stack = torch.from_numpy(np.concatenate([own[None], nb]))
    rows = torch.tensor([3, 1, 4, 2])
    w = torch.from_numpy(pi)
    out = k2.weighted_agg(stack[0], stack, w, 0.3, index=rows,
                          any_ok=torch.tensor(True))
    expect = jref.weighted_agg_ref(own, nb[[2, 0, 3, 1]], pi, 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-6,
                               rtol=1e-6)
    kept = k2.weighted_agg(stack[0], stack, w, 0.3, index=rows,
                           any_ok=torch.tensor(False))
    np.testing.assert_array_equal(kept.numpy(), own)


@pytest.mark.parametrize("M", [33, 39, 64, 257])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weighted_agg_past_32_neighbors_matches_reference(M, dtype):
    """More than 32 neighbours: the mix against the reference's oracle
    and Pallas kernel in both dtypes, and the flat erasure-gated mix that
    the round runs (rows read in place, a third of the links erased)
    against the reference's ``mix_params_with_erasures`` in fp32."""
    tdtype, jdtype = DTYPES[dtype]
    P = 1001
    own, nb, pi = _agg_inputs(M, P, seed=4)
    out = k2.weighted_agg(torch.from_numpy(own).to(tdtype),
                          torch.from_numpy(nb).to(tdtype),
                          torch.from_numpy(pi), 0.7)
    jo, jn = jnp.asarray(own).astype(jdtype), jnp.asarray(nb).astype(jdtype)
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(jref.weighted_agg_ref(jo, jn, pi, 0.7), np.float32),
        atol=tol, rtol=tol)
    if dtype != "float32":
        return
    ok = np.random.default_rng(5).random(M) > 1 / 3
    stack = torch.from_numpy(np.concatenate([own[None], nb]))
    flat = aggregation.mix_flat_with_erasures(
        stack, 0, torch.arange(1, M + 1), torch.from_numpy(pi), 0.7,
        torch.from_numpy(ok))
    expect = ref_aggregation.mix_params_with_erasures(
        jnp.asarray(own), jnp.asarray(nb), jnp.asarray(pi), 0.7,
        jnp.asarray(ok))
    np.testing.assert_allclose(flat.numpy(), np.asarray(expect), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("link_ok", [[True, False, True], [False, True, True],
                                     [False, False, False]])
def test_mix_params_with_erasures_on_cnn_tree(link_ok):
    from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
    from repro_torch.configs import CNNConfig
    from repro_torch.models import cnn
    from repro_torch.utils.bridge import from_jax_params, to_numpy

    kw = dict(image_size=8, widths=(4, 6), hidden=16, n_classes=4)
    stack = jax.tree.map(np.asarray, jax.vmap(
        lambda k: ref_cnn.init_params(k, RefCNNConfig(**kw)))(
            jax.random.split(jax.random.PRNGKey(3), 4)))
    own = jax.tree.map(lambda a: a[0], stack)
    nbs = jax.tree.map(lambda a: a[1:], stack)
    pi = np.array([0.5, 0.2, 0.3], np.float32)
    ok = np.array(link_ok)
    expect = ref_aggregation.mix_params_with_erasures(own, nbs, pi, 0.7, ok)

    layout = cnn.param_layout(CNNConfig(**kw))
    flat = from_jax_params(stack, "cpu")
    tree_out = aggregation.mix_params_with_erasures(
        layout.views(flat[0]), layout.views(flat[1:]), torch.from_numpy(pi),
        0.7, torch.from_numpy(ok))
    flat_out = aggregation.mix_flat_with_erasures(
        flat, 0, torch.tensor([1, 2, 3]), torch.from_numpy(pi), 0.7,
        torch.from_numpy(ok))
    for got in (jax.tree.map(lambda t: t.numpy(), tree_out),
                to_numpy(flat_out, layout)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(expect)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    if not ok.any():
        np.testing.assert_array_equal(flat_out.numpy(), flat[0].numpy())


def test_weighted_agg_rejects_what_the_kernel_does_not_take():
    own, nb, pi = _agg_inputs(3, 64)
    o, n, w = (torch.from_numpy(a) for a in (own, nb, pi))
    with pytest.raises(TypeError):
        k2.weighted_agg(o.double(), n.double(), w, 0.5)
    with pytest.raises(TypeError):
        k2.weighted_agg(o, n.bfloat16(), w, 0.5)
    with pytest.raises(ValueError):
        k2.weighted_agg(o, n[:, :32], w, 0.5)
    with pytest.raises(ValueError):
        k2.weighted_agg(o, n, w[:2], 0.5)
    with pytest.raises(ValueError):
        k2.weighted_agg(o, n, w, 0.5, index=torch.tensor([0, 1, 2],
                                                         dtype=torch.int32))
    with pytest.raises(ValueError):   # no CPU fallback for other devices
        k2._route(torch.device("xpu"))
    # the meta route (the dry run's): shapes only
    out = k2.weighted_agg(o.to("meta"), n.to("meta"), w.to("meta"), 0.5)
    assert out.device.type == "meta" and out.shape == o.shape


@pytest.mark.parametrize("addresses,stride,dtype,expect", [
    # the round's stack: P = 188,810 fp32 is a row stride of 755,240 B,
    # 8 (mod 16), so odd rows are only 8-byte aligned
    ((1 << 20, 2 << 20, 3 << 20), 188_810 * 4, torch.float32, 8),
    ((1 << 20, 2 << 20, 3 << 20), 188_812 * 4, torch.float32, 16),
    ((1 << 20, 2 << 20, 3 << 20), 188_811 * 4, torch.float32, 4),
    ((1 << 20, 2 << 20, 3 << 20), 188_810 * 2, torch.bfloat16, 4),
    ((1 << 20, 2 << 20, 3 << 20), 188_811 * 2, torch.bfloat16, 2),
    ((1 << 20, 2 << 20, 3 << 20), 188_812 * 2, torch.bfloat16, 8),
    ((1 << 20, 2 << 20, 3 << 20), 188_816 * 2, torch.bfloat16, 16),
    # own is row 1 of a stack: its address sets the width
    ((1 << 20, (1 << 20) + 755_240, 4 << 20), 188_812 * 4, torch.float32,
     8),
    (((1 << 20) + 4, 2 << 20, 3 << 20), 64 * 4, torch.float32, 4),
    ((1 << 20, 2 << 20, (3 << 20) + 2), 64 * 2, torch.bfloat16, 2),
])
def test_weighted_agg_vector_width_follows_alignment(addresses, stride,
                                                     dtype, expect):
    """K2's wrapper picks the widest vector that every row base (the
    stack's base plus any multiple of the row stride), own and out share."""
    vb = k2.vector_bytes(addresses, stride, dtype)
    assert vb == expect
    assert vb in k2.VECTOR_BYTES[dtype]
    for a in addresses:
        assert a % vb == 0
    assert stride % vb == 0


@pytest.mark.parametrize("addresses,stride,dtype", [
    ((2, 64, 128), 64, torch.float32),      # fp32 not 4-byte aligned
    ((4, 64, 128), 66, torch.float32),
    ((1, 64, 128), 64, torch.bfloat16)])    # bf16 not 2-byte aligned
def test_weighted_agg_vector_width_refuses_misaligned_buffers(addresses,
                                                              stride, dtype):
    with pytest.raises(ValueError):
        k2.vector_bytes(addresses, stride, dtype)
