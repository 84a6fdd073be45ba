"""Test environment: JAX on a virtual 8-device CPU mesh by default.

Must run before any jax import (hence module-level, in conftest). Card-only
tests (marker ``gpu``) run on the GPU with ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/``; their ``gpu_device`` fixture skips them elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from versalignlib_tpu.params import AlignmentParameters


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first device, when it is a CUDA GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX found {dev.platform})")
    return dev


@pytest.fixture
def default_params():
    return AlignmentParameters()


def random_codes(rng, n, length, padded=False, n_prob=0.0):
    """Random code batches (1..4, optionally N=5 and trailing padding)."""
    codes = rng.integers(1, 5, size=(n, length)).astype(np.uint8)
    if n_prob > 0:
        mask = rng.random((n, length)) < n_prob
        codes = np.where(mask, np.uint8(5), codes)
    if padded:
        # random valid lengths; trailing zeros
        lens = rng.integers(1, length + 1, size=n)
        idx = np.arange(length)[None, :]
        codes = np.where(idx < lens[:, None], codes, np.uint8(0))
    return codes
