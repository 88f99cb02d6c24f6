"""Weights and data carried across: the port's param buffers round-trip the
reference's CNN params exactly, and its numpy data pipeline is
byte-identical to the reference's."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.configs.paper_cnn import cifar10_cnn as ref_cifar10_cnn
from repro.data import partition as ref_partition
from repro.data import synthetic as ref_synthetic
from repro.models import cnn as ref_cnn
from repro_torch.configs import CNNConfig, cifar10_cnn
from repro_torch.data import partition, synthetic
from repro_torch.models import cnn
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)


def _ref_params(cfg_kw, n=None, seed=0):
    key = jax.random.PRNGKey(seed)
    cfg = RefCNNConfig(**cfg_kw)
    if n is None:
        tree = ref_cnn.init_params(key, cfg)
    else:
        tree = jax.vmap(lambda k: ref_cnn.init_params(k, cfg))(
            jax.random.split(key, n))
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("cfg_kw", [dict(image_size=8, widths=(4,), hidden=16,
                                         n_classes=4),
                                    dict(image_size=16, widths=(8, 16),
                                         hidden=32)])
def test_params_round_trip_exactly(n, cfg_kw):
    tree = _ref_params(cfg_kw, n)
    flat = from_jax_params(tree, "cpu")
    layout = cnn.param_layout(CNNConfig(**cfg_kw))
    assert flat.shape == ((layout.size,) if n is None else (n, layout.size))
    lead = () if n is None else (n,)
    expect = np.concatenate([x.reshape(lead + (-1,))
                             for x in jax.tree.leaves(tree)], axis=-1)
    np.testing.assert_array_equal(flat.numpy(), expect)
    back = to_numpy(flat, layout)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_views_write_through_to_the_flat_buffer():
    layout = cnn.param_layout(CNNConfig(image_size=8, widths=(4,), hidden=16,
                                        n_classes=4))
    flat = torch.zeros((2, layout.size))
    layout.views(flat)["fc2"]["w"][1, -1, -1] = 7.0   # the last leaf
    assert float(flat[1, -1]) == 7.0 and float(flat.sum()) == 7.0
    with pytest.raises(ValueError):
        layout.views(flat[:, 1:])


def test_cifar10_layout_matches_reference():
    layout = cnn.param_layout(cifar10_cnn())
    tree = _ref_params(dict(vars(ref_cifar10_cnn())))
    assert layout.shapes == tuple(x.shape for x in jax.tree.leaves(tree))
    assert layout.size == 188_810


def test_init_params_scheme():
    """Same shapes, zero biases and 1/sqrt(fan_in) weight scale as the
    reference's initialiser (the bits differ: another generator)."""
    cfg = CNNConfig(image_size=16, widths=(8, 16), hidden=32)
    flat = cnn.init_params(cfg, torch.Generator().manual_seed(0), 2,
                           device="cpu")
    tree = to_numpy(flat, cnn.param_layout(cfg))
    assert not np.any(tree["fc1"]["b"]) and not np.any(tree["blocks"][0]["bias"])
    w = tree["blocks"][1]["conv"]
    assert abs(w.std() * np.sqrt(9 * 8) - 1.0) < 0.1


@pytest.mark.parametrize("seed,n,kw", [
    (0, 600, dict(image_size=8, n_classes=4)),
    (3, 257, dict(image_size=16, channels=1, n_classes=10, noise=0.5)),
])
def test_synthetic_dataset_byte_identical(seed, n, kw):
    a = synthetic.synthetic_image_dataset(seed, n, **kw)
    b = ref_synthetic.synthetic_image_dataset(seed, n, **kw)
    assert a.x.tobytes() == b.x.tobytes() and a.x.dtype == b.x.dtype
    assert a.y.tobytes() == b.y.tobytes() and a.y.dtype == b.y.dtype
    assert a.n_classes == b.n_classes and len(a) == len(b)


@pytest.mark.parametrize("seed,n_clients,alpha", [(0, 4, 0.3), (1, 11, 0.1)])
def test_partition_split_and_stack_byte_identical(seed, n_clients, alpha):
    base = ref_synthetic.synthetic_image_dataset(seed, 2000, image_size=8)
    pa = partition.dirichlet_partition(base.y, n_clients, alpha=alpha,
                                       seed=seed)
    pb = ref_partition.dirichlet_partition(base.y, n_clients, alpha=alpha,
                                           seed=seed)
    assert [p.tobytes() for p in pa] == [p.tobytes() for p in pb]
    sa = [partition.train_test_split(p, seed=seed + 1) for p in pa]
    sb = [ref_partition.train_test_split(p, seed=seed + 1) for p in pb]
    for (tra, tea), (trb, teb) in zip(sa, sb):
        assert tra.tobytes() == trb.tobytes() and tea.tobytes() == teb.tobytes()
    da = synthetic.make_client_datasets(base, [s[0] for s in sa])
    db = ref_synthetic.make_client_datasets(base, [s[0] for s in sb])
    for x, y in zip(synthetic.stack_datasets(da),
                    ref_synthetic.stack_datasets(db)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
