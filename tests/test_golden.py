"""Golden-value tests against the plain float64 reference
(tests/plain_reference.py, written from the watroo semantics).  Every
pipeline output is compared numerically; all comparisons use float64
for tight tolerances."""

import numpy as np
import pytest

import wavelets_tpu as wt
from tests import plain_reference as ref

RTOL = 1e-10
ATOL = 1e-10

_NAME = {"Triangle": "triangle", "B3spline": "b3spline"}


@pytest.fixture
def img(rng):
    return rng.normal(size=(128, 128)).astype(np.float64)


@pytest.mark.parametrize("cls_name", ["Triangle", "B3spline"])
@pytest.mark.parametrize("s", [0, 1, 3])
def test_convolution_2d(img, cls_name, s):
    want = ref.convolution(img, _NAME[cls_name], s=s)
    got = np.asarray(wt.convolution(img, getattr(wt, cls_name)(2), s=s))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_convolution_1d(rng):
    x = rng.normal(size=(256,))
    want = ref.convolution(x, "b3spline", s=2)
    got = np.asarray(wt.convolution(x, wt.B3spline(1), s=2))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_convolution_3d(rng):
    x = rng.normal(size=(8, 32, 32))
    want = ref.convolution(x, "triangle", s=1)
    got = np.asarray(wt.convolution(x, wt.Triangle(3), s=1))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sdev_loc(img):
    want = ref.sdev_loc(img, "b3spline", s=1, variance=True)
    got = np.asarray(wt.sdev_loc(img, wt.B3spline(2), s=1, variance=True))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=ATOL)


@pytest.mark.parametrize("cls_name", ["Triangle", "B3spline"])
@pytest.mark.parametrize("level", [1, 4])
def test_decomposition(img, cls_name, level):
    want = ref.transform(img, level, _NAME[cls_name])
    got = np.asarray(
        wt.AtrousTransform(getattr(wt, cls_name))(img, level))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decomposition_3d(rng):
    x = rng.normal(size=(8, 32, 32))
    want = ref.transform(x, 2)
    got = np.asarray(wt.AtrousTransform()(x, 2))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_atrous_convolution_bilateral(img):
    var = ref.sdev_loc(img, "b3spline", s=1, variance=True) * 4.0
    kernel = ref.kernel_nd("b3spline", 2)
    want = ref.atrous_convolution(img, kernel, bilateral_variance=var, s=1)
    got = np.asarray(wt.atrous_convolution(
        img, kernel, bilateral_variance=var, s=1))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("bilateral", [None, 1, [2.0, 1.0, 1.0]])
def test_bilateral_decomposition(img, bilateral):
    want = ref.transform(img, 2, bilateral=bilateral)
    got = np.asarray(
        wt.AtrousTransform(wt.B3spline, bilateral=bilateral)(img, 2))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_bilateral_scaling(img):
    want = ref.transform(img, 2, bilateral=1, bilateral_scaling=True)
    got = np.asarray(wt.AtrousTransform(
        wt.B3spline, bilateral=1, bilateral_scaling=True)(img, 2))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_noise_and_significance(img):
    ref_c = ref.Coefficients(ref.transform(img, 3))
    got_c = wt.AtrousTransform()(img, 3)
    assert float(got_c.get_noise()) == pytest.approx(
        float(ref_c.get_noise()), rel=1e-9)
    for soft in (True, False):
        want = ref_c.significance(3, 1, soft_threshold=soft)
        got_s = np.asarray(got_c.significance(3, 1, soft_threshold=soft),
                           dtype=np.float64)
        np.testing.assert_allclose(got_s, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("anscombe", [False, True])
def test_denoise_pipeline(rng, soft, anscombe):
    img = (rng.normal(size=(128, 128)) + 10.0)  # positive for anscombe
    want = ref.denoise(img, [5, 3], "triangle", soft_threshold=soft,
                       anscombe=anscombe)
    got = np.asarray(wt.denoise(img, [5, 3], wt.Triangle,
                                soft_threshold=soft, anscombe=anscombe))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_denoise_with_noise_param(img):
    want = ref.denoise(img, [3, 3], noise=0.5)
    got = np.asarray(wt.denoise(img, [3, 3], noise=0.5))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_generalized_anscombe(rng):
    x = rng.uniform(0.1, 10.0, size=(64, 64))
    want = ref.generalized_anscombe(x, alpha=2, g=0.5, sigma=1)
    got = np.asarray(wt.generalized_anscombe(x, alpha=2, g=0.5, sigma=1))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    want_i = ref.generalized_anscombe(want, alpha=2, g=0.5, sigma=1,
                                      inverse=True)
    got_i = np.asarray(wt.generalized_anscombe(got, alpha=2, g=0.5, sigma=1,
                                               inverse=True))
    np.testing.assert_allclose(got_i, want_i, rtol=1e-12)


class TestWow:
    def test_plain(self, img):
        want, _ = ref.wow(img)
        got, _ = wt.wow(img)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_denoise_weights(self, img):
        want, _ = ref.wow(img, denoise_coefficients=[5, 2],
                          weights=[1.2, 0.8])
        got, _ = wt.wow(img, denoise_coefficients=[5, 2],
                        weights=[1.2, 0.8])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_preserve_variance(self, img):
        want, _ = ref.wow(img, preserve_variance=True)
        got, _ = wt.wow(img, preserve_variance=True)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_gamma_blend(self, img):
        want, _ = ref.wow(img, denoise_coefficients=[5, 2], h=0.5)
        got, _ = wt.wow(img, denoise_coefficients=[5, 2], h=0.5)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_no_whitening(self, img):
        want, _ = ref.wow(img, whitening=False)
        got, _ = wt.wow(img, whitening=False)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_bilateral(self, img):
        want, _ = ref.wow(img, bilateral=1, denoise_coefficients=[5, 2])
        got, _ = wt.wow(img, bilateral=1, denoise_coefficients=[5, 2])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                   atol=1e-7)

    def test_coefficients_input(self, img):
        ref_coeffs = ref.Coefficients(ref.transform(img, 4))
        got_coeffs = wt.AtrousTransform()(img, 4)
        want, _ = ref.wow(ref_coeffs)
        got, _ = wt.wow(got_coeffs)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_n_scales_explicit(self, img):
        want, want_c = ref.wow(img, n_scales=3)
        got, got_c = wt.wow(img, n_scales=3)
        assert len(got_c) == len(want_c)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)


@pytest.mark.parametrize("fft", [False, True])
@pytest.mark.parametrize("threshold_type", ["soft", "hard"])
def test_richardson_lucy(rng, fft, threshold_type):
    img = rng.normal(size=(64, 64)) + 10.0
    x, y = np.meshgrid(np.arange(7) - 3, np.arange(7) - 3)
    psf = np.exp(-(x ** 2 + y ** 2) / 4.0)
    psf /= psf.sum()
    blurred = ref.correlate2d(img, psf[::-1, ::-1])

    want = ref.richardson_lucy(blurred, psf, iterations=3,
                               threshold_type=threshold_type, fft=fft)
    got = np.asarray(wt.richardson_lucy(blurred, psf, iterations=3,
                                        threshold_type=threshold_type,
                                        fft=fft))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_enhance(rng):
    img = rng.normal(size=(128, 128))
    want = ref.enhance(img, denoise=[5, 3])
    got = np.asarray(wt.enhance(img, denoise=[5, 3]))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_enhance_3d(rng):
    img = rng.normal(size=(3, 64, 64))
    # 3-D input: list params are per-channel (watroo/utils.py:25-26)
    weights = [[1.0, 0.9], [1.0, 1.0], [0.8, 1.1]]
    want = ref.enhance(img, denoise=5, weights=weights)
    got = np.asarray(wt.enhance(img, denoise=5, weights=weights))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_prepare_params_parity():
    for param, ndims in [(None, 2), (3, 2), ([1, 2], 2), (None, 3),
                         (5, 3), ([[1], [2], None], 3)]:
        assert wt.prepare_params(param, ndims) == ref.prepare_params(
            param, ndims)
