"""Batched (frame-stack) WOW: per-frame statistics match single-frame
calls."""

import jax.numpy as jnp
import numpy as np
import pytest

import wavelets_tpu as wt
from wavelets_tpu.models.wow import wow_stack


@pytest.fixture
def stack(rng):
    scales = np.array([1.0, 2.0, 0.5], np.float32)[:, None, None]
    return jnp.asarray(
        rng.normal(size=(3, 128, 128)).astype(np.float32) * scales)


def test_per_frame_parity(stack):
    recon, planes = wow_stack(stack, denoise_coefficients=[5, 2],
                              weights=[1.1, 0.9])
    assert recon.shape == stack.shape
    assert planes.shape == (3, 6, 128, 128)
    for i in range(3):
        ref, ref_c = wt.wow(stack[i], denoise_coefficients=[5, 2],
                            weights=[1.1, 0.9])
        np.testing.assert_allclose(np.asarray(recon[i]), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(planes[i]),
                                   np.asarray(ref_c.data),
                                   rtol=1e-5, atol=1e-6)


def test_known_noise_broadcast(stack):
    recon, _ = wow_stack(stack, noise=0.5, denoise_coefficients=[3])
    ref, _ = wt.wow(stack[1], noise=0.5, denoise_coefficients=[3])
    np.testing.assert_allclose(np.asarray(recon[1]), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_rejects_non_stack(rng):
    with pytest.raises(ValueError):
        wow_stack(jnp.zeros((64, 64)))


def test_rejects_unknown_kwarg(stack):
    with pytest.raises(TypeError):
        wow_stack(stack, nonsense=1)


def test_wow_core_need_planes_static(rng):
    """``need_planes`` must be a *static* argument of wow_core's jit —
    it decides in Python whether the planes are returned — and the
    (recon, None) serving contract holds."""
    from wavelets_tpu.models.wow import wow_core
    from wavelets_tpu.ops.filters import B3SPLINE

    data = jnp.asarray(rng.normal(size=(128, 128)).astype(np.float32))
    st = dict(sf=B3SPLINE, n_scales=3, weights=(1.0,) * 4,
              whitening=True,
              denoise_coefficients=(5.0, 2.0, 0.0, 1.0), bilateral=None,
              bilateral_scaling=False, soft_threshold=True,
              preserve_variance=False, gamma=3.2, gamma_min=None,
              gamma_max=None, h=0.0, has_noise=False)
    zero = jnp.zeros((), jnp.float32)
    r1, planes = wow_core(data, zero, **st)
    r2, none = wow_core(data, zero, need_planes=False, **st)
    assert none is None and planes is not None
    # XLA re-fuses once the dead plane stack is eliminated, so
    # equality is to f32 fusion tolerance
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                               rtol=1e-4, atol=1e-6)


def test_wow_stack_no_coefficients(rng):
    """with_coefficients=False returns (recon, None) with recon equal
    to the coefficient-bearing call, to f32 fusion tolerance (the two
    are different XLA programs)."""
    stack = jnp.asarray(
        rng.normal(size=(2, 256, 256)).astype(np.float32))
    r1, planes = wow_stack(stack, denoise_coefficients=[5, 2])
    r2, none = wow_stack(stack, denoise_coefficients=[5, 2],
                         with_coefficients=False)
    assert none is None
    assert planes is not None
    d = np.abs(np.asarray(r1) - np.asarray(r2)).max()
    assert d < 1e-5, d
