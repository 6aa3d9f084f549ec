"""The exact median behind the MAD noise estimator, against np.median
(numpy semantics: the mean of the two middle order statistics for even
counts)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavelets_tpu.ops.stats import (
    mad_noise,
    mad_noise_frames,
    median_abs,
    median_abs_frames,
)


@pytest.mark.parametrize("n", [1, 2, 5, 6, 100, 1001, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_median_abs_exact(rng, n, dtype):
    x = rng.normal(size=(n,)).astype(dtype)
    assert float(median_abs(jnp.asarray(x))) == float(
        np.median(np.abs(x)))


@pytest.mark.parametrize("values,want", [
    ([1.0] * 512 + [2.0] * 512, 1.5),
    ([3.25] * 2048, 3.25),
    ([0.0] * 1024, 0.0),
    ([-4.0, 4.0, 1.0, -1.0], 2.5),
    ([2.0, -2.0, 2.0, 7.0, -7.0], 2.0),
])
def test_median_abs_duplicates(values, want):
    x = jnp.asarray(np.asarray(values, np.float32))
    assert float(median_abs(x)) == want


def test_median_abs_2d_and_jit(rng):
    x = rng.normal(size=(64, 48)).astype(np.float32)
    got = jax.jit(median_abs)(jnp.asarray(x))
    assert float(got) == float(np.median(np.abs(x)))


@pytest.mark.parametrize("shape", [(3, 64, 64), (4, 10, 11)])
def test_median_abs_frames_exact(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    x[1] *= 5.0
    got = np.asarray(median_abs_frames(jnp.asarray(x)))
    want = np.median(np.abs(x).reshape(shape[0], -1), axis=1)
    assert np.array_equal(got, want)


def test_median_vmappable(rng):
    """Every median left is vmappable: a vmap of the single-frame form
    equals the per-frame form."""
    x = jnp.asarray(rng.normal(size=(3, 32, 32)).astype(np.float32))
    assert np.array_equal(np.asarray(jax.vmap(median_abs)(x)),
                          np.asarray(median_abs_frames(x)))


def test_mad_noise_matches_numpy(rng):
    w0 = rng.normal(size=(2, 128, 128))
    sigma_e0 = 0.8907
    want = np.median(np.abs(w0[0])) / 0.6745 / sigma_e0
    assert float(mad_noise(jnp.asarray(w0[0]), sigma_e0)) == \
        pytest.approx(want, rel=1e-12)
    wantb = np.median(np.abs(w0).reshape(2, -1), axis=1) / 0.6745 / sigma_e0
    np.testing.assert_allclose(
        np.asarray(mad_noise_frames(jnp.asarray(w0), sigma_e0)), wantb,
        rtol=1e-12)
