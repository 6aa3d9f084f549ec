"""Card-only checks: the phases of chip_smoke.py at reduced sizes.

They need an NVIDIA GPU and skip elsewhere — tests/conftest.py holds the
whole test session on the CPU, so on the card run them through the
script itself: ``python chip_smoke.py`` (one card) and
``python chip_smoke.py --four`` (four cards)."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def smoke():
    """chip_smoke's phases, or a skip when JAX has no GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_wow(smoke):
    smoke.phase_wow(0, n=1024)


def test_bilateral(smoke):
    smoke.phase_bilateral(0, n_ref=256, n_big=1024)


def test_denoise(smoke):
    smoke.phase_denoise(0, n2=512, n_tri=256)


def test_volume(smoke):
    smoke.phase_volume(0, shape=(16, 128, 128))


def test_roundtrip_1d(smoke):
    smoke.phase_roundtrip_1d(0, n=1 << 16)


def test_richardson_lucy(smoke):
    smoke.phase_rl(0, n=256, sweep=(3, 9))


def test_stack(smoke):
    smoke.phase_stack(0, n=512)


def test_median(smoke):
    smoke.phase_median(0, n=1024)
