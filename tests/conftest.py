"""Test harness config: JAX on a virtual 8-device CPU mesh by default.

``JAX_PLATFORMS`` selects another platform list (``JAX_PLATFORMS=cuda,cpu
python -m pytest -m gpu tests/`` runs the tests that need a GPU).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest


@pytest.fixture()
def rng():
    # function-scoped: each test draws from a fresh, identical stream, so a
    # test's data cannot depend on which tests ran before it (a
    # session-scoped generator made assertions order-dependent)
    return np.random.default_rng(12345)


@pytest.fixture()
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
