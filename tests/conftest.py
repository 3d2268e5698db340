"""Test configuration.

Tests run on CPU with 8 virtual devices (the cluster-free analog of the
reference's local MATLAB worker pool, per SURVEY.md section 4) and with
float64 enabled so the randomized oracle tests can assert the reference's
tolerances (1e-6..1e-10 relative gaps).

``ADMM_TEST_GPU=1`` leaves JAX its default platform, so that the tests
marked ``gpu`` can reach the card:

    ADMM_TEST_GPU=1 python -m pytest tests/ -m gpu

Whether a card is there is decided inside the ``gpu`` fixture, never while
a module is imported: every pytest-xdist worker must collect the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("ADMM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run with ADMM_TEST_GPU=1 on a GPU host")
    return dev
