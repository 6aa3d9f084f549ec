"""Batched enhance channels and frame-stack Richardson-Lucy."""

import jax.numpy as jnp
import numpy as np


class TestEnhanceBatched:
    def test_channels_one_program_matches_loop(self, rng):
        from wavelets_tpu.models.enhance import enhance, prepare_params
        from wavelets_tpu.api import AtrousTransform

        img = rng.normal(size=(3, 128, 128)).astype(np.float32)

        def seq(weights, denoise, noise=None):
            at = AtrousTransform()
            outs = []
            wp = prepare_params(weights, 3)
            dp = prepare_params(denoise, 3)
            for c in range(3):
                wgt = list(wp[c]) + [1] * (len(dp[c]) - len(wp[c]))
                dns = list(dp[c]) + [0] * (len(wgt) - len(dp[c]))
                coeffs = at(img[c], len(wgt))
                coeffs.noise = (coeffs.get_noise()
                                if noise is None or noise[c] is None
                                else noise[c])
                coeffs.denoise(dns, weights=wgt)
                outs.append(jnp.sum(coeffs.data, axis=0))
            return jnp.stack(outs)

        for w, d, nz in [([[1, 1.2], [1, 1], [0.5, 2]],
                          [[5, 2], [3, 0], [0, 0]], None),
                         ([1.0, 1.0, 1.0],
                          [[5, 2], [4, 1], [3, 3]], [0.9, 1.1, 1.0])]:
            a = enhance(img, *(() if nz is None else (nz,)),
                        weights=w, denoise=d)
            b = seq(w, d, nz)
            assert float(jnp.abs(jnp.asarray(a) - b).max()) < 1e-6

    def test_mixed_lengths_fall_back(self, rng):
        from wavelets_tpu.models.enhance import enhance

        img = rng.normal(size=(3, 64, 64)).astype(np.float32)
        out = enhance(img, weights=[[1, 1], [1], [1, 1, 1]],
                      denoise=[[5, 2], [3], [1, 1, 1]])
        assert np.asarray(out).shape == (3, 64, 64)


class TestRichardsonLucyR5:
    def test_stack_matches_per_frame(self, rng):
        from wavelets_tpu.models.richardson_lucy import (
            richardson_lucy, richardson_lucy_stack)

        psf = np.outer(*(np.hanning(5),) * 2).astype(np.float32)
        psf = psf / psf.sum()
        # positive data: RL's multiplicative update assumes a
        # nonnegative image (division by the blurred estimate)
        stack = (rng.normal(size=(2, 128, 128)) ** 2 +
                 np.array([1, 3])[:, None, None]).astype(np.float32)
        got = richardson_lucy_stack(stack, psf, iterations=4,
                                    fft=False)
        assert got.shape == stack.shape
        for i in range(2):
            ref = richardson_lucy(stack[i], psf, iterations=4,
                                  fft=False)
            d = float(jnp.abs(got[i] - ref).max())
            sc = float(jnp.abs(ref).max())
            assert d < 1e-5 * max(sc, 1.0), (i, d, sc)

    def test_fft_auto_dispatch(self):
        from wavelets_tpu.models.richardson_lucy import _fft_auto

        assert _fft_auto("auto", (15, 15)) is True
        assert _fft_auto("auto", (5, 5)) is False
        # the card's crossover: direct up to 7×7 = 49 taps
        assert _fft_auto("auto", (7, 7)) is False
        assert _fft_auto("auto", (9, 9)) is True
        assert _fft_auto(False, (15, 15)) is False
        assert _fft_auto(True, (3, 3)) is True

    def test_stack_golden_vs_reference(self, rng):
        """Golden: stack mode vs the plain reference per frame."""
        from tests.plain_reference import richardson_lucy as ref_rl
        from wavelets_tpu.models.richardson_lucy import (
            richardson_lucy_stack)

        psf = np.outer(*(np.hanning(5),) * 2)
        psf = psf / psf.sum()
        stack = rng.normal(size=(2, 64, 64)) ** 2 + 1.0
        got = richardson_lucy_stack(stack, psf, iterations=3,
                                    denoise_coefficients=(5.0, 2.0),
                                    fft=False)
        for i in range(2):
            want = ref_rl(stack[i], psf, iterations=3,
                          denoise_coefficients=(5.0, 2.0))
            np.testing.assert_allclose(np.asarray(got[i]), want,
                                       rtol=1e-6, atol=1e-7)
