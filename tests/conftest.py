import importlib.util
import os
import sys

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 placeholders.

# pin the backend before any test module imports jax: with libtpu installed
# but no TPUs attached, backend autodetection stalls for minutes per
# GCP-metadata variable; the whole suite targets host (CPU) devices
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# make `import repro` work even when pytest is launched without
# PYTHONPATH=src (the tier-1 command sets it; humans often forget)
_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
if importlib.util.find_spec("repro") is None:
    sys.path.insert(0, os.path.abspath(_SRC))

# Offline-test policy (ROADMAP): when the real `hypothesis` package is
# absent, alias the vendored deterministic engine (repro.testing) under the
# `hypothesis` names so `from hypothesis import given` keeps working.
from repro.testing import install_as_hypothesis  # noqa: E402

install_as_hypothesis()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
