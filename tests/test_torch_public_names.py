"""Public names of the reference that the port carries under the same
name: ``configs.cifar100_cnn`` (field for field the reference's, and the
fused engine at a 100-class width against the reference's on replayed
draws), ``ModelConfig.attention_free`` for every registered arch, and
``core.wireless.p_transmit``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import wireless as jwireless
from repro.core.fedsim import FederatedSimulation as RefSimulation
from repro.core.fedsim import FedSimConfig as RefFedSimConfig
from repro.data import (dirichlet_partition, make_client_datasets,
                        synthetic_image_dataset, train_test_split)
from repro_torch import configs as tconfigs
from repro_torch import data as tdata
from repro_torch.core import wireless as twireless
from repro_torch.core.fedsim import FederatedSimulation, FedSimConfig
from repro_torch.utils.bridge import from_jax_params
from test_torch_fedsim import SIM_KW
from test_torch_methods import _assert_matches_reference

torch.set_num_threads(1)


def test_cifar100_cnn_is_the_reference_config():
    assert "cifar100_cnn" in tconfigs.__all__
    got, want = tconfigs.cifar100_cnn(), jconfigs.cifar100_cnn()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_classes == 100 and got.name == "cifar100-cnn"


def _data(synth, part, make, split, n_classes, n_clients=4, seed=0):
    """``tests/test_fedsim_fused.py::_tiny_setup``'s data at
    ``n_classes`` classes, from either package's data functions."""
    base = synth(seed, 600, image_size=8, n_classes=n_classes)
    parts = part(base.y, n_clients, alpha=0.3, seed=seed)
    return (make(base, [split(p, seed=1)[0] for p in parts]),
            make(base, [split(p, seed=1)[1] for p in parts]))


@pytest.mark.parametrize("method", ["pfedwn", "local"])
def test_fused_engine_at_100_classes_matches_reference(method):
    """``_tiny_setup``'s size with a 100-class head (the cifar100-cnn
    width's class count, so K1's plain version runs at V 100): accuracies
    within 5e-3, π, final params and the train-loss tap within 1e-4 of the
    reference's fused engine on its replayed draws."""
    cfg_kw = dict(image_size=8, widths=(4,), hidden=16, n_classes=100)
    n = 4
    pm = np.array([True] * (n - 1) + [False])
    p_err = np.linspace(0.0, 0.2, n).astype(np.float32)
    rtrain, rtest = _data(synthetic_image_dataset, dirichlet_partition,
                          make_client_datasets, train_test_split, 100)
    ptrain, ptest = _data(tdata.synthetic_image_dataset,
                          tdata.dirichlet_partition,
                          tdata.make_client_datasets,
                          tdata.train_test_split, 100)
    kw = dict(SIM_KW, adapt_subset=32)
    ref = RefSimulation(RefCNNConfig(**cfg_kw), rtrain, rtest, pm, p_err,
                        RefFedSimConfig(**kw))
    params0 = from_jax_params(jax.tree.map(np.asarray, ref.params0), "cpu")
    port = FederatedSimulation(tconfigs.CNNConfig(**cfg_kw), ptrain, ptest,
                               pm, p_err, FedSimConfig(**kw),
                               params0=params0, device="cpu")
    assert port.model_cfg.n_classes == 100
    _assert_matches_reference(ref, port, method)


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_attention_free_matches_reference(arch):
    """``attention_free`` is ``family == "ssm"``, as the reference's, at
    full width and at reduced()."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert t.attention_free == j.attention_free == (t.family == "ssm")
    assert t.reduced().attention_free == j.reduced().attention_free


@pytest.mark.parametrize("kw", [{}, dict(fading_threshold=0.3),
                                dict(n_subchannels=1),
                                dict(n_subchannels=16, rayleigh_gamma=2.5)])
def test_p_transmit_matches_reference(kw):
    """The probability that an interferer transmits on the considered
    sub-channel, within 1e-7 of the reference's."""
    got = twireless.p_transmit(tconfigs.WirelessConfig(**kw))
    want = float(jwireless.p_transmit(jconfigs.WirelessConfig(**kw)))
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-7, (got, want)
