"""Sharded WOW against the single-device engine.

Stage 1 — data-axis-only mesh: every shard is whole frames and runs the
same per-frame program as wow_stack (`_stack_core`).

Stage 2 — spatially tiled mesh: the halo-exchange body with collective
statistics; deep scales whose reach exceeds the tile gather the plane.

Comparisons use abs diff < 5e-6: batched/sharded program shapes let XLA
contract FMAs differently, so bitwise equality is not promised across
*program* boundaries (cf. test_sharded_decompose_batched), only across
identical programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wavelets_tpu.models.wow import (
    _stack_core,
    normalize_wow_params,
    wow_core,
    wow_stack,
)
from wavelets_tpu.ops.filters import B3SPLINE
from wavelets_tpu.parallel import make_mesh, sharded_wow

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _statics(n_scales, weights, dcs, has_noise, min_extent):
    n_scales, w, d, _ = normalize_wow_params(
        B3SPLINE, n_scales, list(weights), list(dcs), None, 0.0, 2,
        min_extent)
    return dict(
        sf=B3SPLINE, n_scales=n_scales, weights=w, whitening=True,
        denoise_coefficients=d, bilateral=None, bilateral_scaling=False,
        soft_threshold=True, preserve_variance=False, gamma=3.2,
        gamma_min=None, gamma_max=None, h=0.0, has_noise=has_noise)


def _forced_stack_ref(stack, noise, with_coefficients=True,
                      n_scales=None, weights=(), dcs=()):
    """Single-device reference: the wow_stack program on one device."""
    statics = _statics(n_scales, weights, dcs, noise is not None,
                       min(stack.shape[1:]))
    if noise is not None:
        noise_arr = jnp.broadcast_to(
            jnp.asarray(noise, stack.dtype), (stack.shape[0],))
    else:
        noise_arr = jnp.zeros((stack.shape[0],), stack.dtype)
    return _stack_core(stack, noise_arr, with_coefficients, statics)


class TestStage1DataAxis:
    """sharded_wow on a data-only mesh == wow_stack dispatch."""

    def test_planes_vs_forced_stack(self, rng):
        mesh = make_mesh(data=8, rows=1, cols=1)
        stack = jnp.asarray(
            rng.normal(size=(8, 256, 256)).astype(np.float32))
        ref_r, ref_p = _forced_stack_ref(stack, 1.0, dcs=[5.0, 2.0])
        got_r, got_p = sharded_wow(stack, mesh, noise=1.0,
                                   denoise_coefficients=[5.0, 2.0])
        assert got_p.shape == ref_p.shape  # batch-major (B, L+1, H, W)
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6
        assert float(jnp.max(jnp.abs(got_p - ref_p))) < 5e-6

    def test_matches_wow_stack_semantics(self, rng):
        """Against the public wow_stack front door."""
        mesh = make_mesh(data=4, rows=1, cols=1,
                         devices=jax.devices()[:4])
        stack = jnp.asarray(
            rng.normal(size=(4, 256, 256)).astype(np.float32))
        ref_r, ref_p = wow_stack(stack, noise=1.0,
                                 denoise_coefficients=[5.0, 2.0])
        got_r, got_p = sharded_wow(stack, mesh, noise=1.0,
                                   denoise_coefficients=[5.0, 2.0])
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6
        assert float(jnp.max(jnp.abs(got_p - ref_p))) < 5e-6

    def test_lazy_noise_per_frame(self, rng):
        """Lazy MAD noise stays per-frame across the sharded batch."""
        mesh = make_mesh(data=4, rows=1, cols=1,
                         devices=jax.devices()[:4])
        stack = jnp.asarray(
            (rng.normal(size=(4, 256, 256)) *
             np.array([1, 2, 3, 4])[:, None, None]).astype(np.float32))
        ref_r, _ = _forced_stack_ref(stack, None, dcs=[5.0, 2.0])
        got_r, _ = sharded_wow(stack, mesh,
                               denoise_coefficients=[5.0, 2.0])
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6

    def test_serving_recon_matches_planes_mode(self, rng):
        mesh = make_mesh(data=8, rows=1, cols=1)
        stack = jnp.asarray(
            rng.normal(size=(8, 256, 256)).astype(np.float32))
        r1, _ = sharded_wow(stack, mesh, noise=1.0,
                            denoise_coefficients=[5.0, 2.0])
        r2, none = sharded_wow(stack, mesh, noise=1.0,
                               denoise_coefficients=[5.0, 2.0],
                               with_coefficients=False)
        assert none is None
        # serving drops the plane stores — same math, another program
        assert float(jnp.max(jnp.abs(r1 - r2))) < 5e-6


class TestStage2Tiled:
    """Spatially tiled mesh: halo-exchange body with collective
    statistics."""

    def _ref_single(self, img, noise, n_scales, dcs):
        statics = _statics(n_scales, (), dcs, noise is not None,
                           min(img.shape))
        noise_arr = (jnp.asarray(noise, img.dtype) if noise is not None
                     else jnp.zeros((), img.dtype))
        return wow_core(img, noise_arr, planes_layout="cube", **statics)

    def test_tiled_vs_forced_single(self, rng):
        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(
            rng.normal(size=(512, 512)).astype(np.float32))
        ref_r, ref_p = self._ref_single(img, 1.0, 5, [5.0, 2.0])
        got_r, got_p = sharded_wow(img, mesh, n_scales=5, noise=1.0,
                                   denoise_coefficients=[5.0, 2.0])
        assert got_p.shape == (6, 512, 512)
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6
        assert float(jnp.max(jnp.abs(got_p - ref_p))) < 5e-6

    def test_tiled_vs_xla_semantics(self, rng):
        """Against the public single-device ``wow``."""
        from wavelets_tpu.models.wow import wow

        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(
            rng.normal(size=(512, 512)).astype(np.float32))
        ref_r, _ = wow(img, n_scales=4, noise=1.0,
                       denoise_coefficients=[5.0, 2.0])
        got_r, _ = sharded_wow(img, mesh, n_scales=4, noise=1.0,
                               denoise_coefficients=[5.0, 2.0])
        assert float(jnp.max(jnp.abs(got_r - np.asarray(ref_r)))) < 5e-6

    def test_tiled_lazy_noise(self, rng):
        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(
            rng.normal(size=(512, 512)).astype(np.float32))
        ref_r, _ = self._ref_single(img, None, 4, [5.0, 2.0])
        got_r, _ = sharded_wow(img, mesh, n_scales=4,
                               denoise_coefficients=[5.0, 2.0])
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6

    def test_tiled_serving_bitwise(self, rng):
        """Serving mode skips the plane writes — the reconstruction is
        unchanged up to XLA's fusion of the two programs (the bitwise
        promise belonged to the removed kernels' shared tile plan)."""
        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(
            rng.normal(size=(512, 512)).astype(np.float32))
        r1, _ = sharded_wow(img, mesh, n_scales=4, noise=1.0,
                            denoise_coefficients=[5.0, 2.0])
        r2, none = sharded_wow(img, mesh, n_scales=4, noise=1.0,
                               denoise_coefficients=[5.0, 2.0],
                               with_coefficients=False)
        assert none is None
        assert float(jnp.max(jnp.abs(r1 - r2))) < 5e-6

    def test_tiled_batched(self, rng):
        """data × rows×cols mesh over a stack: per-frame statistics on
        halo-tiled blocks."""
        mesh = make_mesh(data=2, rows=2, cols=1,
                         devices=jax.devices()[:4])
        stack = jnp.asarray(
            (rng.normal(size=(2, 512, 256)) *
             np.array([1, 3])[:, None, None]).astype(np.float32))
        refs = [self._ref_single(stack[i], None, 3, [5.0, 2.0])[0]
                for i in range(2)]
        got_r, got_p = sharded_wow(stack, mesh, n_scales=3,
                                   denoise_coefficients=[5.0, 2.0])
        assert got_p.shape == (2, 4, 512, 256)  # batch-major
        for i in range(2):
            d = float(jnp.max(jnp.abs(got_r[i] - refs[i])))
            assert d < 5e-6, (i, d)

    def test_small_tiles_fall_back(self, rng):
        """Small local blocks (deep scales gather the plane) match
        wow() in float64."""
        from wavelets_tpu.models.wow import wow

        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(rng.normal(size=(128, 128)))
        ref_r, _ = wow(img, denoise_coefficients=[5, 2])
        got_r, _ = sharded_wow(img, mesh, denoise_coefficients=[5, 2])
        np.testing.assert_allclose(np.asarray(got_r), np.asarray(ref_r),
                                   rtol=1e-11, atol=1e-12)


class TestBandDeepTail:
    """Tiled meshes at depths whose reach passes the tile: scales whose
    halo fits exchange it with ppermute, deeper ones gather the plane
    (parallel/halo.py)."""

    def _ref_single(self, img, noise, n_scales, dcs):
        statics = _statics(n_scales, (), dcs, noise is not None,
                           min(img.shape))
        noise_arr = (jnp.asarray(noise, img.dtype) if noise is not None
                     else jnp.zeros((), img.dtype))
        return wow_core(img, noise_arr, planes_layout="cube", **statics)

    def test_band_tail_deep_vs_single(self, rng):
        """2×2 mesh, L7 at 512² (256² tiles): reach hw·2^s passes the
        tile at s = 7."""
        mesh = make_mesh(data=1, rows=2, cols=2,
                         devices=jax.devices()[:4])
        img = jnp.asarray(
            rng.normal(size=(512, 512)).astype(np.float32))
        ref_r, ref_p = self._ref_single(img, 1.0, 7, [5.0, 2.0])
        got_r, got_p = sharded_wow(img, mesh, n_scales=7, noise=1.0,
                                   denoise_coefficients=[5.0, 2.0])
        assert got_p.shape == (8, 512, 512)
        assert float(jnp.max(jnp.abs(got_r - ref_r))) < 5e-6
        assert float(jnp.max(jnp.abs(got_p - ref_p))) < 5e-6

    def test_band_tail_rows_mesh_batched(self, rng):
        """rows-only mesh over a stack with per-frame statistics and
        deep scales."""
        mesh = make_mesh(data=2, rows=2, cols=1,
                         devices=jax.devices()[:4])
        stack = jnp.asarray(
            (rng.normal(size=(2, 512, 512)) *
             np.array([1, 3])[:, None, None]).astype(np.float32))
        refs = [self._ref_single(stack[i], None, 6, [5.0, 2.0])[0]
                for i in range(2)]
        got_r, got_p = sharded_wow(stack, mesh, n_scales=6,
                                   denoise_coefficients=[5.0, 2.0])
        assert got_p.shape == (2, 7, 512, 512)
        for i in range(2):
            d = float(jnp.max(jnp.abs(got_r[i] - refs[i])))
            assert d < 5e-6, (i, d)
