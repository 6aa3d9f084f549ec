"""Sharded à trous transform and WOW over a device mesh.

The scaling layer the reference lacks entirely (SURVEY §2.3):
images (or frame stacks) are tiled over a ``(data, rows, cols)`` mesh
with ``shard_map``; every scale-``s`` convolution exchanges ``hw·2^s``
boundary rows/cols with mesh neighbors (``ppermute``), global
statistics (MAD noise median, residual std, gamma min/max) become
collectives, and the whole pipeline still compiles to one SPMD program.

Numerical contract: sharded == single-device **bitwise** for the
standard transform (identical per-element accumulation order; verified
in tests/test_sharded.py on a forced 8-device CPU mesh)."""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core.transform import normalize_bilateral
from ..models.wow import _stack_core, _wow_body, normalize_wow_params
from ..ops.conv import _noncenter_offsets
from ..ops.filters import ScalingFunction
from .halo import halo_exchange_axis, halo_smooth_axis
from .mesh import COL_AXIS, DATA_AXIS, ROW_AXIS
from .reductions import (
    distributed_max,
    distributed_mean,
    distributed_median,
    distributed_min,
    distributed_std,
)

__all__ = ["sharded_decompose", "sharded_wow", "ShardedReduceOps"]

_SPATIAL_AXES = (ROW_AXIS, COL_AXIS)


class ShardedReduceOps:
    """Collective-backed reductions over the spatial mesh axes, per batch
    element.  Results keep singleton spatial dims so they broadcast
    against local blocks."""

    def __init__(self, total_count: int, batch_ndim: int):
        self.total_count = total_count
        self.batch_ndim = batch_ndim

    def _expand(self, v, ndim):
        return v.reshape(v.shape + (1,) * (ndim - v.ndim))

    def median_abs(self, x):
        m = distributed_median(jnp.abs(x), _SPATIAL_AXES, self.total_count,
                               self.batch_ndim)
        return self._expand(m, x.ndim)

    def mean(self, x):
        return self._expand(
            distributed_mean(x, _SPATIAL_AXES, self.total_count,
                             self.batch_ndim), x.ndim)

    def std(self, x):
        return self._expand(
            distributed_std(x, _SPATIAL_AXES, self.total_count,
                            self.batch_ndim), x.ndim)

    def min(self, x):
        return self._expand(
            distributed_min(x, _SPATIAL_AXES, self.batch_ndim), x.ndim)

    def max(self, x):
        return self._expand(
            distributed_max(x, _SPATIAL_AXES, self.batch_ndim), x.ndim)


def _smooth_local(x, sf: ScalingFunction, s: int, n_rows: int, n_cols: int):
    """Separable dilated smoothing of a local block with halo exchange on
    both spatial axes (last two dims)."""
    row_axis, col_axis = x.ndim - 2, x.ndim - 1
    out = halo_smooth_axis(x, sf.taps, s, row_axis, ROW_AXIS, n_rows,
                           "symmetric")
    return halo_smooth_axis(out, sf.taps, s, col_axis, COL_AXIS, n_cols,
                            "symmetric")


def _halo_extend_2d(x, h: int, n_rows: int, n_cols: int):
    """Extend a local block by ``h`` on all four spatial sides; corners are
    correct because the column exchange operates on the row-extended
    block (the neighbor's row halos match)."""
    row_axis, col_axis = x.ndim - 2, x.ndim - 1
    ext = halo_exchange_axis(x, h, row_axis, ROW_AXIS, n_rows, "symmetric")
    return halo_exchange_axis(ext, h, col_axis, COL_AXIS, n_cols,
                              "symmetric")


def _bilateral_smooth_local(x, var, sf: ScalingFunction, s: int,
                            n_rows: int, n_cols: int):
    """Bilateral à trous smoothing of a local block (dense 2-D tap loop on
    a halo-extended block; cf. ops.conv.atrous_conv_nd)."""
    d = 2 ** s
    hw = sf.half_width
    h = hw * d
    row_axis, col_axis = x.ndim - 2, x.ndim - 1
    nloc_r, nloc_c = x.shape[row_axis], x.shape[col_axis]
    if h > nloc_r or h > nloc_c:
        # deep-scale fallback: reach exceeds the tile — gather the full
        # (heavily smoothed) plane and its variance, run the dense
        # bilateral conv, slice the local block back (cf. halo.py)
        from ..ops.conv import atrous_conv_nd

        full_x = lax.all_gather(x, ROW_AXIS, axis=row_axis, tiled=True)
        full_x = lax.all_gather(full_x, COL_AXIS, axis=col_axis,
                                tiled=True)
        full_v = lax.all_gather(var, ROW_AXIS, axis=row_axis, tiled=True)
        full_v = lax.all_gather(full_v, COL_AXIS, axis=col_axis,
                                tiled=True)
        kern = sf.kernel_nd(2)
        conv = lambda xi, vi: atrous_conv_nd(
            xi, kern, s, bilateral_variance=vi, boundary="symmetric")
        for _ in range(x.ndim - 2):
            conv = jax.vmap(conv)
        out_full = conv(full_x, full_v)
        ri = lax.axis_index(ROW_AXIS)
        ci = lax.axis_index(COL_AXIS)
        out = lax.dynamic_slice_in_dim(out_full, ri * nloc_r, nloc_r,
                                       axis=row_axis)
        return lax.dynamic_slice_in_dim(out, ci * nloc_c, nloc_c,
                                        axis=col_axis)
    ext = _halo_extend_2d(x, h, n_rows, n_cols)
    kernel = sf.kernel_nd(2)
    center = float(kernel[hw, hw])
    inv_two_var = 0.5 / var
    out = x * jnp.asarray(center, x.dtype)
    norm = jnp.full_like(x, center)

    def tap(off_r, off_c):
        sl = lax.slice_in_dim(ext, h + off_r * d, h + off_r * d + nloc_r,
                              axis=row_axis)
        return lax.slice_in_dim(sl, h + off_c * d, h + off_c * d + nloc_c,
                                axis=col_axis)

    for off in _noncenter_offsets(kernel.shape):
        k = float(kernel[hw + off[0], hw + off[1]])
        shifted = tap(*off)
        diff = x - shifted
        w = jnp.asarray(k, x.dtype) * jnp.exp(-(diff * diff) * inv_two_var)
        norm = norm + w
        out = out + w * shifted
    return out / norm


def _local_variance(x, sf, s, n_rows, n_cols, floor=1e-20):
    mean = _smooth_local(x, sf, s, n_rows, n_cols)
    vari = _smooth_local(x * x, sf, s, n_rows, n_cols) - mean * mean
    return jnp.where(vari <= 0, jnp.asarray(floor, x.dtype), vari)


def _decompose_local(
    x, level: int, sf: ScalingFunction, n_rows: int, n_cols: int,
    bilateral: Optional[Tuple[float, ...]], bilateral_scaling: bool,
):
    planes = []
    c = x
    for s in range(level):
        if bilateral is None:
            c_next = _smooth_local(c, sf, s, n_rows, n_cols)
        else:
            var = _local_variance(c, sf, s, n_rows, n_cols)
            var = var * jnp.asarray(bilateral[s] ** 2, c.dtype)
            if bilateral_scaling:
                var = var * (s + 1)
            c_next = _bilateral_smooth_local(c, var, sf, s, n_rows, n_cols)
        planes.append(c - c_next)
        c = c_next
    planes.append(c)
    return jnp.stack(planes)


def _specs(mesh: Mesh, batched: bool):
    spatial = P(ROW_AXIS, COL_AXIS)
    data_spec = P(DATA_AXIS, ROW_AXIS, COL_AXIS) if batched else spatial
    planes_spec = (P(None, DATA_AXIS, ROW_AXIS, COL_AXIS) if batched
                   else P(None, ROW_AXIS, COL_AXIS))
    return data_spec, planes_spec


def _mesh_dims(mesh: Mesh):
    return (mesh.shape[DATA_AXIS], mesh.shape[ROW_AXIS],
            mesh.shape[COL_AXIS])


#: jitted shard_map programs, keyed on (mesh, shapes, statics):
#: sharded_wow builds a fresh shard_map closure per call, which would
#: otherwise defeat jax.jit's cache and recompile every invocation —
#: fatal for serving loops.
#: LRU-bounded: a long-lived serving process cycling shapes/configs
#: must not pin every compiled executable (each holds device buffers
#: and host IR); 32 programs comfortably covers a serving fleet's
#: active config set while letting stale entries (and their XLA
#: executables) be collected.
from collections import OrderedDict

_PROGRAM_CACHE = OrderedDict()
_PROGRAM_CACHE_MAX = 32


def _cached_jit(key, build):
    fn = _PROGRAM_CACHE.get(key)
    if fn is None:
        fn = _PROGRAM_CACHE[key] = jax.jit(build())
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
            _PROGRAM_CACHE.popitem(last=False)
    else:
        _PROGRAM_CACHE.move_to_end(key)
    return fn


def sharded_decompose(
    x: jax.Array,
    level: int,
    sf: ScalingFunction,
    mesh: Mesh,
    *,
    bilateral=None,
    bilateral_scaling: bool = False,
) -> jax.Array:
    """À trous decomposition of a 2-D image (H, W) or frame stack
    (B, H, W) tiled over ``mesh``.  Bitwise-identical to the
    single-device :func:`~wavelets_tpu.core.transform.decompose`."""
    batched = x.ndim == 3
    n_data, n_rows, n_cols = _mesh_dims(mesh)
    data_spec, planes_spec = _specs(mesh, batched)
    bil = normalize_bilateral(bilateral, level)

    local = partial(
        _decompose_local, level=level, sf=sf, n_rows=n_rows, n_cols=n_cols,
        bilateral=bil, bilateral_scaling=bilateral_scaling,
    )
    fn = shard_map(local, mesh=mesh, in_specs=(data_spec,),
                   out_specs=planes_spec)
    x = jax.device_put(x, NamedSharding(mesh, data_spec))
    return jax.jit(fn)(x)


def sharded_wow(
    data: jax.Array,
    mesh: Mesh,
    *,
    sf: ScalingFunction = None,
    n_scales: Optional[int] = None,
    weights=(),
    whitening: bool = True,
    denoise_coefficients=(),
    noise=None,
    bilateral=None,
    bilateral_scaling: bool = False,
    soft_threshold: bool = True,
    preserve_variance: bool = False,
    gamma: float = 3.2,
    gamma_min: Optional[float] = None,
    gamma_max: Optional[float] = None,
    h: float = 0,
    with_coefficients: bool = True,
):
    """WOW on a mesh-tiled image (H, W) or frame stack (B, H, W).

    Semantics of :func:`wavelets_tpu.models.wow.wow`, with global
    reductions as collectives and per-frame statistics along a sharded
    batch axis.  Returns ``(recon, planes)`` with the same sharding as
    the input tiling; batched planes are batch-major ``(B, n_scales+1,
    H, W)``, matching :func:`~wavelets_tpu.models.wow.wow_stack`.
    ``with_coefficients=False`` returns ``(recon, None)`` and lets XLA
    dead-code-eliminate the plane cube (per-shard plane stores and
    their device memory disappear under jit).

    A data-axis-only mesh runs each shard (whole frames) through the
    same per-frame program as :func:`wow_stack`; a spatially tiled mesh
    runs the halo-exchange body, with global statistics as
    collectives."""
    from ..ops.filters import B3SPLINE

    if sf is None:
        sf = B3SPLINE
    batched = data.ndim == 3
    spatial_shape = data.shape[-2:]
    n_data, n_rows, n_cols = _mesh_dims(mesh)

    # static parameter normalization shared with the single-device
    # front doors — one code path, incl. the scale-clamp warning
    # (watroo/utils.py:122-170)
    n_scales, rec_w, dcs, sigma_bilateral = normalize_wow_params(
        sf, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims=2, min_extent=min(spatial_shape))

    has_noise = noise is not None
    noise_arr = (jnp.asarray(noise, data.dtype) if has_noise
                 else jnp.zeros((), data.dtype))
    total_count = int(np.prod(spatial_shape))
    batch_ndim = 1 if batched else 0
    data_spec, _ = _specs(mesh, batched)
    # wow planes: batch-major for stacks (wow_stack layout), scale-major
    # cube for single frames
    planes_spec = (P(DATA_AXIS, None, ROW_AXIS, COL_AXIS) if batched
                   else P(None, ROW_AXIS, COL_AXIS))
    rops = ShardedReduceOps(total_count, batch_ndim)

    # ---- data-axis-only mesh: shards are whole frames; the
    # single-device stack program (per-frame statistics) runs per
    # shard with no collectives
    if batched and n_rows == 1 and n_cols == 1:
        statics = dict(
            sf=sf, n_scales=n_scales, weights=rec_w,
            whitening=bool(whitening), denoise_coefficients=dcs,
            bilateral=sigma_bilateral,
            bilateral_scaling=bool(bilateral_scaling),
            soft_threshold=bool(soft_threshold),
            preserve_variance=bool(preserve_variance),
            gamma=float(gamma),
            gamma_min=None if gamma_min is None else float(gamma_min),
            gamma_max=None if gamma_max is None else float(gamma_max),
            h=float(h), has_noise=has_noise)
        if has_noise and noise_arr.ndim == 0:
            noise_arr = jnp.broadcast_to(noise_arr, (data.shape[0],))
        elif not has_noise:
            noise_arr = jnp.zeros((data.shape[0],), data.dtype)
        noise_spec = P(DATA_AXIS)

        def local_stack(x, nz):
            r, p = _stack_core(x, nz, with_coefficients, statics)
            return (r, p) if with_coefficients else r

        key = ("stack", mesh, data.shape, str(data.dtype),
               with_coefficients,
               tuple(sorted(statics.items(), key=lambda kv: kv[0])))
        fn = _cached_jit(key, lambda: shard_map(
            local_stack, mesh=mesh,
            in_specs=(data_spec, noise_spec),
            out_specs=((data_spec, planes_spec) if with_coefficients
                       else data_spec)))
        data = jax.device_put(data, NamedSharding(mesh, data_spec))
        noise_arr = jax.device_put(
            noise_arr, NamedSharding(mesh, noise_spec))
        out = fn(data, noise_arr)
        return out if with_coefficients else (out, None)

    # ---- spatially tiled mesh: halo-exchange body with collective
    # statistics
    def local(x, noise_v):
        planes = _decompose_local(
            x, n_scales, sf, n_rows, n_cols, sigma_bilateral,
            bilateral_scaling)
        recon, out_planes = _wow_body(
            planes, noise_v, has_noise, sf, n_scales,
            rec_w,
            whitening,
            dcs,
            sigma_bilateral is not None, soft_threshold, preserve_variance,
            float(gamma), gamma_min, gamma_max, float(h),
            smooth_fn=lambda p, s: _smooth_local(p, sf, s, n_rows, n_cols),
            rops=rops, n_dim=2,
        )
        if batched:
            out_planes = jnp.moveaxis(out_planes, 0, 1)
        return recon, out_planes

    key = ("xla", mesh, data.shape, str(data.dtype), with_coefficients,
           n_scales, rec_w, dcs, sigma_bilateral,
           bool(bilateral_scaling), bool(whitening),
           bool(soft_threshold), bool(preserve_variance), float(gamma),
           gamma_min, gamma_max, float(h), has_noise, sf)
    fn = _cached_jit(
        key, lambda: shard_map(
            local, mesh=mesh,
            in_specs=(data_spec, P()),
            out_specs=(data_spec, planes_spec),
        ) if with_coefficients else (lambda d, nz: shard_map(
            local, mesh=mesh,
            in_specs=(data_spec, P()),
            out_specs=(data_spec, planes_spec))(d, nz)[0]))
    data = jax.device_put(data, NamedSharding(mesh, data_spec))
    if with_coefficients:
        return fn(data, noise_arr)
    return fn(data, noise_arr), None
