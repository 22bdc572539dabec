"""Test configuration.

Tests run on the CPU with 8 virtual devices (sharding tests build an 8-way
mesh); the Pallas kernels run in interpreter mode there, mirroring the
role of the reference's no-GPU internal test oracle.  Tests marked ``gpu``
compile the kernels for an NVIDIA GPU and skip elsewhere; run them on the
card in one process with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernels)")
