"""The port's npz checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): each package reads the other's files
exactly (a CNN param tree, a nested list, bfloat16 and float8 leaves), the
step round-trips, a shape mismatch raises, the atomic write leaves no
temporary behind, and a reduced smollm-135m saved by the reference and
loaded by the port prefills to the reference's logits within 1e-4."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.models import cnn as jcnn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import CNNConfig
from repro_torch.models import cnn as tcnn
from repro_torch.models import model as tmodel

torch.set_num_threads(1)

CFG_KW = dict(image_size=8, widths=(4, 8), hidden=16, n_classes=4)


def _cnn_trees():
    """(reference CNN params as jax arrays, the port's tree of tensors
    with the same values)."""
    jp = jcnn.init_params(jax.random.PRNGKey(3), RefCNNConfig(**CFG_KW))
    layout = tcnn.param_layout(CNNConfig(**CFG_KW))
    tp = layout.views(torch.zeros(layout.size))
    jleaves = jax.tree.leaves(jp)
    tleaves = jax.tree.leaves(tp)
    for t, j in zip(tleaves, jleaves):
        t.copy_(torch.from_numpy(np.array(j)))
    return jp, tp


def _assert_same(torch_tree, jax_tree):
    tl, jl = jax.tree.leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        if j.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_reference_cnn_checkpoint_loads_in_the_port(tmp_path):
    jp, tp = _cnn_trees()
    path = str(tmp_path / "cnn.npz")
    ref_save(path, jp, step=11)
    zeros = jax.tree.map(torch.zeros_like, tp)
    got, step = load_checkpoint(path, zeros)
    assert step == 11
    _assert_same(got, jp)


def test_port_cnn_checkpoint_loads_in_the_reference(tmp_path):
    jp, tp = _cnn_trees()
    path = str(tmp_path / "cnn.npz")
    save_checkpoint(path, tp, step=4)
    got, step = ref_load(path, jax.tree.map(jnp.zeros_like, jp))
    assert step == 4
    _assert_same(tp, got)


def _mixed_trees():
    """A tree with a nested list, bf16 leaves and an int leaf: (torch,
    jax) with the same values."""
    g = torch.Generator().manual_seed(0)
    tt = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
          "stack": [torch.randn(4, generator=g),
                    [torch.randn(2, 2, generator=g).to(torch.bfloat16),
                     torch.arange(6, dtype=torch.int32).reshape(2, 3)]],
          "b": {"z": torch.randn(7, generator=g)}}
    jt = jax.tree.map(
        lambda t: (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                   if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())),
        tt)
    return tt, jt


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_nested_list_and_bf16_cross_packages(tmp_path, writer):
    tt, jt = _mixed_trees()
    path = str(tmp_path / "mixed.npz")
    if writer == "reference":
        ref_save(path, jt, step=9)
        got, step = load_checkpoint(path, jax.tree.map(torch.zeros_like, tt))
        _assert_same(got, jt)
    else:
        save_checkpoint(path, tt, step=9)
        got, step = ref_load(path, jax.tree.map(jnp.zeros_like, jt))
        _assert_same(tt, got)
    assert step == 9
    with np.load(path) as data:
        assert str(data["__dtype__/w"]) == "bfloat16"
        assert data["w"].dtype == np.uint16
        assert "__dtype__/stack/0" not in data


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_float8_cross_packages(tmp_path, dtype):
    t = torch.randn(9, generator=torch.Generator().manual_seed(1)).to(dtype)
    path = str(tmp_path / "f8.npz")
    save_checkpoint(path, {"x": t})
    jdtype = getattr(jnp, str(dtype).split(".")[1])
    got, _ = ref_load(path, {"x": jnp.zeros((9,), jdtype)})
    np.testing.assert_array_equal(np.asarray(got["x"]).view(np.uint8),
                                  t.view(torch.uint8).numpy())
    ref_save(path, got)
    back, _ = load_checkpoint(path, {"x": torch.zeros(9, dtype=dtype)})
    assert back["x"].dtype == dtype
    assert torch.equal(back["x"].view(torch.uint8), t.view(torch.uint8))


def test_step_round_trip_and_numpy_leaves(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [torch.ones(2)], "skip": None}
    path = str(tmp_path / "sub" / "t.npz")
    save_checkpoint(path, tree, step=123)
    got, step = load_checkpoint(path, tree)
    assert step == 123
    assert isinstance(got["a"], np.ndarray) and got["skip"] is None
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0])


def test_leaves_take_the_dtype_of_like(tmp_path):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.tensor([1.5, 2.5]),
                           "h": torch.tensor([0.5]).to(torch.bfloat16)})
    got, _ = load_checkpoint(path, {"a": torch.zeros(2, dtype=torch.bfloat16),
                                    "h": np.zeros(1, np.float32)})
    assert got["a"].dtype == torch.bfloat16
    assert got["a"].tolist() == [1.5, 2.5]
    assert got["h"].dtype == np.float32 and got["h"].tolist() == [0.5]


def test_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch at a"):
        load_checkpoint(path, {"a": torch.zeros(4)})
    ref_save(path, {"a": jnp.zeros((2, 2))})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"a": torch.zeros(4)})


def test_atomic_write_leaves_no_temporary(tmp_path):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"a": torch.zeros(3)}, step=1)
    save_checkpoint(path, {"a": torch.ones(3)}, step=2)
    assert os.listdir(tmp_path) == ["x.npz"]
    got, step = load_checkpoint(path, {"a": torch.zeros(3)})
    assert step == 2 and torch.equal(got["a"], torch.ones(3))


def test_reduced_smollm_checkpoint_prefills_as_the_reference(tmp_path):
    """A reduced smollm-135m saved by the reference, loaded into the
    port's param tree (the same keys, layers stacked over L) and
    prefilled: the reference's logits within 1e-4."""
    jcfg = jconfigs.get_config("smollm-135m").reduced()
    tcfg = tconfigs.get_config("smollm-135m").reduced()
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    path = str(tmp_path / "lm.npz")
    ref_save(path, jp, step=5)
    like = tmodel.init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    tp, step = load_checkpoint(path, like)
    assert step == 5
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12))
    logits, _ = tmodel.prefill(tp, tcfg, torch.from_numpy(toks))
    jlogits, _ = jmodel.prefill(jp, jcfg, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    # and the port's save of it loads back into the reference
    save_checkpoint(path, tp, step=6)
    back, step = ref_load(path, jax.tree.map(jnp.zeros_like, jp))
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
