"""Engine vs the plain float64 reference (tests/plain_reference.py) over
scaling function × level × dimensionality × dtype."""

import jax.numpy as jnp
import numpy as np
import pytest

import wavelets_tpu as wt
from tests import plain_reference as ref

_SHAPES = {1: (256,), 2: (64, 64), 3: (8, 32, 32)}
_CLS = {"triangle": wt.Triangle, "b3spline": wt.B3spline}
# float32 engine vs float64 reference: rounding of the chained
# smoothings; float64 both sides: summation order only
_TOL = {np.float32: 2e-6, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("level", [1, 3, 5])
@pytest.mark.parametrize("name", ["triangle", "b3spline"])
def test_transform_vs_reference(rng, name, level, ndim, dtype):
    x = rng.normal(size=_SHAPES[ndim]).astype(dtype)
    got = wt.AtrousTransform(_CLS[name])(x, level)
    planes = np.asarray(got.data)
    assert planes.dtype == dtype
    assert planes.shape == (level + 1,) + x.shape
    want = ref.transform(x, level, name)
    err = np.abs(planes - want).max() / np.abs(want).max()
    assert err < _TOL[dtype], err
    # the sum telescopes back to the input
    np.testing.assert_allclose(planes.sum(0), x,
                               atol=50 * np.finfo(dtype).eps)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("name", ["triangle", "b3spline"])
def test_denoise_vs_reference(rng, name, soft, ndim, dtype):
    x = rng.normal(size=_SHAPES[ndim]).astype(dtype)
    got = np.asarray(wt.denoise(x, [4, 2], _CLS[name],
                                soft_threshold=soft))
    want = ref.denoise(x, [4, 2], name, soft_threshold=soft)
    bad = np.abs(got - want) > 10 * _TOL[dtype] * np.abs(want).max()
    # a hard threshold may flip a pixel sitting on it in float32
    assert bad.mean() <= (0.002 if dtype == np.float32 and not soft
                          else 0.0), bad.mean()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["triangle", "b3spline"])
def test_wow_stack_vs_reference(rng, name, dtype):
    stack = rng.normal(size=(2, 64, 64)).astype(dtype)
    stack[1] *= 3.0
    recon, _ = wt.wow_stack(jnp.asarray(stack), scaling_function=_CLS[name],
                            denoise_coefficients=[5, 2])
    for i in range(2):
        want, _ = ref.wow(stack[i], name, denoise_coefficients=[5, 2])
        err = (np.abs(np.asarray(recon[i]) - want).max()
               / np.abs(want).max())
        assert err < 50 * _TOL[dtype], (i, err)
