"""Round-3 regression tests: Coefficients construction/mutation shims,
convolution out-param warning, and WOW front-door parameter parity
(shared static normalization incl. the scale-clamp warning)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavelets_tpu import B3spline, Coefficients, convolution, wow
from wavelets_tpu.api import atrous_convolution
from wavelets_tpu.models.wow import normalize_wow_params, wow_stack
from wavelets_tpu.ops.filters import B3SPLINE
from wavelets_tpu.parallel import make_mesh, sharded_wow


def test_coefficients_nested_list_is_cube(rng):
    # a nested Python list must coerce to a cube (previously stored as
    # rows of lists and crashed on .data with AttributeError)
    rows = [rng.normal(size=(16, 16)).tolist() for _ in range(3)]
    c = Coefficients(rows, B3spline(2))
    assert len(c) == 3
    assert c.data.shape == (3, 16, 16)
    float(c.get_noise())  # must not raise


def test_coefficients_rows_numpy_coerced(rng):
    rows = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(2)]
    c = Coefficients(rows, B3spline(2))
    assert isinstance(c._rows[0], jax.Array)
    assert c.data.shape == (2, 8, 8)


def test_coefficients_setitem_rows_and_cube(rng):
    rows = [jnp.asarray(rng.normal(size=(8, 8)).astype(np.float32))
            for _ in range(3)]
    c = Coefficients(list(rows), B3spline(2))
    c[1] = c[1] * 2.0  # functional substitute for data[1] *= 2
    np.testing.assert_array_equal(np.asarray(c[1]),
                                  np.asarray(rows[1]) * 2.0)
    # cube form
    c2 = Coefficients(jnp.stack(rows), B3spline(2))
    c2[0] = c2[0] * 3.0
    np.testing.assert_array_equal(np.asarray(c2[0]),
                                  np.asarray(rows[0]) * 3.0)
    # untouched planes unchanged
    np.testing.assert_array_equal(np.asarray(c2[2]), np.asarray(rows[2]))


def test_convolution_output_param_warns(rng):
    x = rng.normal(size=(32, 32)).astype(np.float32)
    buf = np.empty_like(x)
    with pytest.warns(UserWarning, match="IGNORED"):
        convolution(x, B3spline(2), s=0, output=buf)
    with pytest.warns(UserWarning, match="IGNORED"):
        atrous_convolution(x, np.outer([0.25, 0.5, 0.25],
                                       [0.25, 0.5, 0.25]), output=buf)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        convolution(x, B3spline(2), s=0)  # no warning without output


def test_normalize_params_matches_reference_conventions():
    n, w, d, sb = normalize_wow_params(
        B3SPLINE, None, [], [], None, 0.0, 2, min_extent=4096)
    assert n == 10  # round(log2(4096) - log2(5))
    assert w == (1.0,) * 11
    assert d == (0.0,) * 10 + (1.0,)
    assert sb is None
    # explicit lists pad per watroo/utils.py:160-170
    n, w, d, _ = normalize_wow_params(
        B3SPLINE, None, [2.0], [5, 2], None, 0.0, 2, min_extent=256)
    assert n == 6 and w[:1] == (2.0,) and w[1:] == (1.0,) * 6
    assert d == (5.0, 2.0, 0.0, 0.0, 0.0, 0.0, 1.0)


def _clamp_args():
    # more denoise coefficients than the sigma_e table length (11)
    # triggers the reference's clamp warning (watroo/utils.py:135-138)
    return dict(denoise_coefficients=[1.0] * 11)


def test_clamp_warning_parity_all_front_doors(rng):
    img = rng.normal(size=(64, 64)).astype(np.float32)
    with pytest.warns(UserWarning, match="larger than the maximum"):
        wow(img, n_scales=2, **_clamp_args())
    with pytest.warns(UserWarning, match="larger than the maximum"):
        wow_stack(img[None], n_scales=2, **_clamp_args())
    mesh = make_mesh(data=1, rows=2, cols=2, devices=jax.devices()[:4])
    with pytest.warns(UserWarning, match="larger than the maximum"):
        sharded_wow(jnp.asarray(img), mesh, n_scales=2, **_clamp_args())


def test_front_door_parity_sharded_vs_single(rng):
    # identical padded-parameter handling through wow and sharded_wow
    # on a well-conditioned config (the clamp config whitens a
    # near-constant residual — 1/std blows up any eps difference, so
    # numeric parity there is meaningless; the warning test above
    # covers the clamp itself)
    img = jnp.asarray(rng.normal(size=(64, 64)).astype(np.float32))
    r1, _ = wow(img, n_scales=4, weights=[2.0],
                denoise_coefficients=[5, 2])
    mesh = make_mesh(data=1, rows=2, cols=2, devices=jax.devices()[:4])
    r2, _ = sharded_wow(img, mesh, n_scales=4, weights=[2.0],
                        denoise_coefficients=[5, 2])
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                               rtol=0, atol=1e-6)


def test_wow_from_coefficients_lazy_rows_no_assembly(rng):
    # the reuse entry point must not force cube assembly just to read
    # ndim (regression for the data.data[0] touch)
    img = jnp.asarray(rng.normal(size=(64, 64)).astype(np.float32))
    _, coeffs = wow(img, n_scales=3)
    assert coeffs._rows is not None  # rows layout preserved
    recon, out = wow(coeffs, denoise_coefficients=[3.0])
    assert recon.shape == img.shape


def test_bilateral_scales_beyond_sigma_table(rng):
    """8k-bilateral regression: auto n_scales (11) exceeds the 10-entry
    B3spline 2-D bilateral σ_e table (watroo/wavelets.py:274-276), which
    the reference tolerates because significance's sigma==0 early-out
    never touches sigma_e for un-denoised scales
    (watroo/wavelets.py:136).  The deep-tail threshold computation must
    be guarded the same way.  Trace-only (eval_shape)."""
    import jax

    from wavelets_tpu.models.wow import normalize_wow_params, wow_core
    from wavelets_tpu.ops.filters import B3SPLINE

    n, w, d, sb = normalize_wow_params(
        B3SPLINE, None, [], [5.0, 2.0], 1, 0.0, 2, 8192)
    assert n == 11 and len(B3SPLINE.sigma_e(2, True)) == 10
    st = dict(sf=B3SPLINE, n_scales=n, weights=w,
              whitening=True, denoise_coefficients=d, bilateral=sb,
              bilateral_scaling=False, soft_threshold=True,
              preserve_variance=False, gamma=3.2, gamma_min=None,
              gamma_max=None, h=0.0, has_noise=True)
    x = jax.ShapeDtypeStruct((8192, 8192), jnp.float32)
    one = jax.ShapeDtypeStruct((), jnp.float32)
    out = jax.eval_shape(
        lambda a, nz: wow_core(a, nz, planes_layout="rows", **st), x, one)
    assert out[0].shape == (8192, 8192)
