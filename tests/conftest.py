"""Test environment: CPU backend with 8 virtual devices (sharding tests run
on a forced host-platform mesh, SURVEY §4), and x64 enabled so the f64
round-trip / golden comparisons against the reference are meaningful."""

import os

# Must be set before the CPU backend initializes; jax.config below is the
# authoritative override.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def data_2d(rng):
    return rng.normal(size=(128, 128)).astype(np.float64)


@pytest.fixture
def data_2d_f32(rng):
    return rng.normal(size=(128, 128)).astype(np.float32)


@pytest.fixture
def data_1d(rng):
    return rng.normal(size=(512,)).astype(np.float64)


@pytest.fixture
def data_3d(rng):
    return rng.normal(size=(16, 64, 64)).astype(np.float64)
