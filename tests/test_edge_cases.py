"""Edge cases: degenerate levels, empty parameter lists, constant
inputs, odd-but-tileable shapes."""

import jax.numpy as jnp
import numpy as np
import pytest

import wavelets_tpu as wt
from wavelets_tpu.core.transform import decompose
from wavelets_tpu.ops.filters import B3SPLINE


def test_level_zero(data_2d):
    coeffs = wt.AtrousTransform()(data_2d, 0)
    arr = np.asarray(coeffs)
    assert arr.shape == (1, 128, 128)
    np.testing.assert_array_equal(arr[0], data_2d)


def test_denoise_empty_weights(data_2d):
    out = np.asarray(wt.denoise(data_2d, []))
    np.testing.assert_allclose(out, data_2d, atol=1e-12)


def test_constant_image_denoise():
    """Constant input → zero noise → significance ones → identity."""
    data = np.full((128, 128), 7.5)
    out = np.asarray(wt.denoise(data, [5, 3]))
    np.testing.assert_allclose(out, data, atol=1e-12)


def test_wow_constant_image():
    data = np.full((128, 128), 3.0, np.float64)
    recon, coeffs = wt.wow(data, denoise_coefficients=[5])
    assert np.isfinite(np.asarray(recon)).all()


def test_tileable_768(rng):
    """768 = 3·256, a non-power-of-two extent: the transform telescopes
    back to the input and each plane is the difference of two
    successive smooths."""
    from wavelets_tpu.ops.conv import smooth

    x = jnp.asarray(rng.normal(size=(768, 768)).astype(np.float32))
    got = decompose(x, 4, B3SPLINE)
    np.testing.assert_allclose(np.asarray(jnp.sum(got, 0)),
                               np.asarray(x), atol=1e-5)
    s1 = smooth(x, B3SPLINE, scale=0)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(x - s1),
                               atol=1e-6)


def test_untileable_shape_falls_back(rng):
    """Shapes with no power-of-two factor transform exactly too."""
    x = jnp.asarray(rng.normal(size=(200, 200)).astype(np.float32))
    coeffs = wt.AtrousTransform()(x, 3)
    recon = np.sum(np.asarray(coeffs), axis=0)
    np.testing.assert_allclose(recon, np.asarray(x), atol=1e-5)


def test_weights_longer_than_scales(data_2d):
    """Extra weights are ignored (zip truncation parity)."""
    r1, _ = wt.wow(data_2d, n_scales=2, weights=[1.0, 1.0, 1.0, 9.9, 9.9])
    r2, _ = wt.wow(data_2d, n_scales=2, weights=[1.0, 1.0, 1.0])
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2))


def test_coefficients_setter_noise_array(data_3d):
    """Per-channel noise arrays pass through significance (enhance
    path, watroo/utils.py:72)."""
    coeffs = wt.AtrousTransform()(data_3d, 2)
    coeffs.noise = np.full((16, 64, 64), 0.5)
    sig = np.asarray(coeffs.significance(3, 0))
    assert sig.shape == (16, 64, 64)
    assert np.isfinite(sig).all()
