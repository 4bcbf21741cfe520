"""Test configuration.

The suite runs on an 8-device virtual CPU mesh: multi-device logic
(sharded descriptor bank, distributed PGO) is validated on the CPU because
JAX collectives are backend-portable.

Tests marked ``gpu`` need an NVIDIA GPU.  They skip here and run on the
card with NRS_TESTS_GPU=1, which leaves JAX on its default backend:

    NRS_TESTS_GPU=1 python -m pytest tests/test_gpu_only.py

(`python chip_smoke.py` runs them as its phase D.)
"""

import os

GPU_TESTS = os.environ.get("NRS_TESTS_GPU") == "1"

if not GPU_TESTS:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; runs only with NRS_TESTS_GPU=1")


@pytest.fixture
def gpu_backend():
    """Skip unless the run targets the card and JAX found a GPU."""
    if not GPU_TESTS:
        pytest.skip("GPU-only test: set NRS_TESTS_GPU=1 on a GPU machine")
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"GPU-only test: JAX backend is {jax.default_backend()}")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
