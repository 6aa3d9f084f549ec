"""Additional golden-value tests vs the plain float64 reference
(tests/plain_reference.py): RL variants, wow corner configurations,
3-D pipelines."""

import numpy as np
import pytest

import wavelets_tpu as wt
from tests import plain_reference as ref


@pytest.fixture
def img(rng):
    return rng.normal(size=(128, 128)).astype(np.float64)


class TestRichardsonLucyVariants:
    @pytest.fixture
    def blurred(self, rng):
        # well-posed positive scene (RL on pure noise diverges, in the
        # reference too): smooth blobs + small noise + offset
        yy, xx = np.mgrid[0:64, 0:64]
        img = (10.0
               + 50 * np.exp(-((xx - 20) ** 2 + (yy - 30) ** 2) / 40.0)
               + 30 * np.exp(-((xx - 45) ** 2 + (yy - 15) ** 2) / 25.0)
               + 0.5 * rng.normal(size=(64, 64)))
        x, y = np.meshgrid(np.arange(5) - 2, np.arange(5) - 2)
        psf = np.exp(-(x ** 2 + y ** 2) / 3.0)
        psf /= psf.sum()
        return ref.correlate2d(img, psf[::-1, ::-1]), psf

    def test_uniform_init(self, blurred):
        # the engine runs float32 input in float32; the reference is
        # float64 throughout
        data, psf = blurred
        data = data.astype(np.float32)
        psf = psf.astype(np.float32)
        want = ref.richardson_lucy(data, psf, iterations=3,
                                   uniform_init=True)
        got = np.asarray(wt.richardson_lucy(data, psf, iterations=3,
                                            uniform_init=True))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)

    def test_non_persistent_mrs(self, blurred):
        data, psf = blurred
        want = ref.richardson_lucy(data, psf, iterations=3,
                                     persistent_mrs=False)
        got = np.asarray(wt.richardson_lucy(data, psf, iterations=3,
                                            persistent_mrs=False))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    def test_hard_non_persistent(self, blurred):
        data, psf = blurred
        want = ref.richardson_lucy(data, psf, iterations=2,
                                     threshold_type="hard",
                                     persistent_mrs=False, fft=True)
        got = np.asarray(wt.richardson_lucy(data, psf, iterations=2,
                                            threshold_type="hard",
                                            persistent_mrs=False,
                                            fft=True))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    def test_custom_denoise_coefficients(self, blurred):
        data, psf = blurred
        want = ref.richardson_lucy(data, psf, iterations=2,
                                     denoise_coefficients=(3, 1))
        got = np.asarray(wt.richardson_lucy(data, psf, iterations=2,
                                            denoise_coefficients=(3, 1)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


class TestWowCorners:
    def test_h_one_gamma_only(self, img):
        """h=1: pure gamma-scaled output; n_scales from denoise list."""
        want, _ = ref.wow(img, denoise_coefficients=[5, 2],
                            h=1)
        got, _ = wt.wow(img, denoise_coefficients=[5, 2], h=1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_explicit_gamma_bounds(self, img):
        want, _ = ref.wow(img, denoise_coefficients=[5],
                            h=0.3, gamma=2.0, gamma_min=-1.0,
                            gamma_max=2.0)
        got, _ = wt.wow(img, denoise_coefficients=[5], h=0.3, gamma=2.0,
                        gamma_min=-1.0, gamma_max=2.0)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_hard_threshold(self, img):
        want, _ = ref.wow(img, denoise_coefficients=[4, 2],
                            soft_threshold=False)
        got, _ = wt.wow(img, denoise_coefficients=[4, 2],
                        soft_threshold=False)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_known_noise(self, img):
        want, _ = ref.wow(img, denoise_coefficients=[5, 2],
                            noise=0.7)
        got, _ = wt.wow(img, denoise_coefficients=[5, 2], noise=0.7)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_triangle_wow(self, img):
        want, _ = ref.wow(img, "triangle")
        got, _ = wt.wow(img, scaling_function=wt.Triangle)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_wow_3d_volume(self, rng):
        vol = rng.normal(size=(16, 64, 64))
        want, _ = ref.wow(vol, n_scales=2,
                            denoise_coefficients=[3])
        got, _ = wt.wow(vol, n_scales=2, denoise_coefficients=[3])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-9)

    def test_scale_clamp_warning(self, img):
        """len(denoise_coefficients) >= table length triggers the clamp
        warning (watroo/utils.py:135-138)."""
        dc = [1.0] * 11
        with pytest.warns(UserWarning):
            want, _ = ref.wow(img, denoise_coefficients=dc,
                                h=1)
        with pytest.warns(UserWarning):
            got, _ = wt.wow(img, denoise_coefficients=dc, h=1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7,
                                   atol=1e-8)


def test_enhance_with_noise_arg(rng):
    img = rng.normal(size=(128, 128))
    want = ref.enhance(img, 0.8, denoise=[4, 2])
    got = np.asarray(wt.enhance(img, 0.8, denoise=[4, 2]))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_denoise_bilateral_golden(rng):
    img = rng.normal(size=(128, 128))
    want = ref.denoise(img, [5, 3], bilateral=1)
    got = np.asarray(wt.denoise(img, [5, 3], bilateral=1))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)


class TestRecursiveGolden:
    """recursive=True vs the reference's decimated recursive transform
    (watroo/wavelets.py:330-406, tests/plain_reference.py)."""

    @pytest.mark.parametrize("sf_name,level", [("B3spline", 4),
                                               ("Triangle", 5)])
    def test_recursive_vs_reference(self, rng, sf_name, level):
        img = rng.normal(size=(128, 128))
        name = sf_name.lower()
        want = ref.transform_recursive(img, level, name)
        got = np.asarray(wt.AtrousTransform(getattr(wt, sf_name))(
            img, level, recursive=True).data)

        # interior: both modes equal the standard path beyond the
        # deepest-scale reach hw·2^(level-1) (SURVEY §2.4)
        hw = 1 if sf_name == "Triangle" else 2
        margin = hw * 2 ** (level - 1)
        core = (slice(None), slice(margin, -margin), slice(margin, -margin))
        np.testing.assert_allclose(got[core], want[core], rtol=1e-9,
                                   atol=1e-11)

        # border: bounded by the reference's own standard-vs-recursive
        # border gap (different decimated-subarray reflection), ~1e-2
        want_std = ref.transform(img, level, name)
        own_gap = np.abs(want_std - want).max()
        border_gap = np.abs(got - want).max()
        assert border_gap <= max(2 * own_gap, 1e-9), (border_gap, own_gap)


class TestBilateral3D:
    """3-D + bilateral together (the n-D atrous_convolution at
    watroo/wavelets.py:74-105 plus the 3-D σ_e bilateral tables at
    :252-254,:282-283)."""

    @pytest.fixture
    def vol(self, rng):
        return rng.normal(size=(16, 32, 32))

    def test_decompose_3d_bilateral(self, vol):
        want = ref.transform(vol, 2, bilateral=1)
        got = np.asarray(wt.AtrousTransform(bilateral=1)(vol, 2).data)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)

    def test_denoise_3d_bilateral(self, vol):
        want = ref.denoise(vol, [5, 3], bilateral=1)
        got = np.asarray(wt.denoise(vol, [5, 3], bilateral=1))
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-8)
