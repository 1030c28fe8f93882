"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) with an 8-device virtual mesh,
so the multi-device domain decomposition path (parallel/) is exercised
without cards, and with x64 enabled so quadrature/consistency checks have
headroom (the engine still computes in the dtype of its state arrays —
simulations pin float32). Pallas kernels run in interpret mode here.

On a machine with a GPU, ``SPH_TEST_GPU=1 python -m pytest tests/ -m gpu``
leaves JAX on the card (no virtual mesh, no x64) and runs the tests that
need it; everywhere else those tests skip through the ``gpu`` fixture.
"""
import os

import pytest

ON_GPU = os.environ.get("SPH_TEST_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at test time, never at
    collection, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run SPH_TEST_GPU=1 pytest -m gpu on a "
                    "machine with a card")
