"""WOW — Wavelets Optimized Whitening (reference: watroo/utils.py:105-219).

The flagship pipeline: à trous decomposition, per-scale local-power
whitening, optional erf/hard significance denoising, optional bilateral
(edge-aware) decomposition, optional variance preservation and gamma-blend
tone mapping.  ``wow_core`` compiles the entire pipeline — 2n dilated
convolutions plus all elementwise work and global reductions — into one
XLA program per (shape, config).

Paper: Auchère et al. 2023, A&A 670, A66 (reference README.md:111).
"""

from __future__ import annotations

import copy
import warnings
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api import B3spline, Coefficients, _as_device_array, _spec_of
from ..core.transform import decompose, normalize_bilateral, synthesize
from ..ops.conv import smooth
from ..ops.filters import ScalingFunction
from ..ops.stats import mad_noise_frames, significance

__all__ = ["wow", "wow_core", "wow_stack", "normalize_wow_params"]


def normalize_wow_params(spec, n_scales, weights, denoise_coefficients,
                         bilateral, h, n_dims, min_extent=None):
    """Shared static parameter normalization for the three WOW front
    doors (:func:`wow`, :func:`wow_stack`,
    :func:`wavelets_tpu.parallel.sharded.sharded_wow`): auto scale count
    from the smallest extent (watroo/utils.py:122-127), clamp to the
    σ_e table length with the reference's warning (:135-138), weight /
    denoise list padding (:160-170), and bilateral σ-list normalization
    (:140-146) — one code path so parity changes land once.

    ``min_extent=None`` skips the auto-derivation/max clamp (the
    coefficients-reuse entry point, where ``n_scales`` is fixed by the
    cube).  Returns ``(n_scales, weights, denoise, sigma_bilateral)``
    with the lists as float tuples of length ``n_scales + 1``."""
    denoise_coefficients = list(denoise_coefficients)
    if min_extent is not None:
        max_scales = int(np.round(
            np.log2(min_extent) - np.log2(len(spec.taps))))
        if n_scales is None:
            n_scales = (max_scales if h < 1
                        else len(denoise_coefficients))
        elif n_scales > max_scales:
            n_scales = max_scales
    table_len = len(spec.sigma_e(n_dims, bilateral is not None))
    if len(denoise_coefficients) >= table_len:
        warnings.warn(
            "Required number of scales larger than the maximum for "
            f"scaling function. Using {table_len}.")
        n_scales = table_len
    sigma_bilateral = normalize_bilateral(bilateral, n_scales)
    w = list(copy.copy(weights))
    if len(w) <= n_scales:
        w.extend([1] * (n_scales - len(w) + 1))
    d = denoise_coefficients
    if len(d) < n_scales:
        d.extend([0] * (n_scales - len(d)))
    if len(d) == n_scales:
        d.extend([1])
    return (n_scales,
            tuple(float(x) for x in w[:n_scales + 1]),
            tuple(float(x) for x in d[:n_scales + 1]),
            sigma_bilateral)


class LocalReduceOps:
    """Single-device global reductions over a whole plane.

    The sharded engine substitutes a collective-backed implementation
    (``wavelets_tpu.parallel.sharded.ShardedReduceOps``) so the WOW body
    below is written once for both."""

    def median_abs(self, x):
        from ..ops.stats import median_abs

        return median_abs(x)

    def mean(self, x):
        return jnp.mean(x)

    def std(self, x):
        return jnp.std(x)

    def min(self, x):
        return jnp.min(x)

    def max(self, x):
        return jnp.max(x)


_LOCAL_OPS = LocalReduceOps()


def _wow_body(
    planes: jax.Array,
    noise: jax.Array,
    has_noise: bool,
    sf: ScalingFunction,
    n_scales: int,
    weights: Tuple[float, ...],
    whitening: bool,
    denoise_coefficients: Tuple[float, ...],
    bilateral: bool,
    soft_threshold: bool,
    preserve_variance: bool,
    gamma: float,
    gamma_min: Optional[float],
    gamma_max: Optional[float],
    h: float,
    smooth_fn=None,
    rops=None,
    n_dim: Optional[int] = None,
    planes_layout="cube",
):
    """Per-scale whitening loop (watroo/utils.py:157-219), traced once.

    ``planes`` is the (n_scales+1, ...) coefficient cube; all other
    parameters are static.  ``smooth_fn(x, s)`` and ``rops`` (reduction
    namespace) default to the single-device implementations; the sharded
    engine injects halo-exchange smoothing and collective reductions.
    """
    if n_dim is None:
        n_dim = planes.ndim - 1
    if smooth_fn is None:
        smooth_fn = lambda x, s: smooth(x, sf, scale=s)
    if rops is None:
        rops = _LOCAL_OPS
    sigma_e = sf.sigma_e(n_dim, bilateral)

    # Lazy MAD noise (watroo/wavelets.py:132): needed iff some detail
    # plane has a nonzero denoise coefficient.
    if not has_noise and any(
        d != 0 for d in denoise_coefficients[:n_scales]
    ):
        noise = rops.median_abs(planes[0]) / 0.6745 / float(sigma_e[0])

    gamma_scaled = jnp.zeros_like(planes[0]) if h > 0 else None
    out_planes = []
    for s in range(n_scales + 1):
        c = planes[s]
        w = float(weights[s])
        d = float(denoise_coefficients[s])
        power = c * c
        if preserve_variance:
            # watroo/utils.py:178-184
            power_norm = rops.std(c) if s == n_scales else jnp.sqrt(
                rops.mean(power))
        else:
            power_norm = jnp.asarray(1.0, c.dtype)
        if s == n_scales:
            # residual plane: global std, clamped (watroo/utils.py:185-191)
            if whitening and h < 1:
                lp = rops.std(c)
                local_power = jnp.where(
                    lp <= 0, jnp.asarray(1e-15, c.dtype), lp)
            else:
                local_power = jnp.asarray(1.0, c.dtype)
        else:
            # detail plane: smoothed local power (watroo/utils.py:193-199)
            if whitening and h < 1:
                lp = smooth_fn(power, s)
                lp = jnp.where(lp <= 0, jnp.asarray(1e-15, c.dtype), lp)
                local_power = jnp.sqrt(lp)
            else:
                local_power = jnp.asarray(1.0, c.dtype)
            if d != 0:
                c = c * significance(
                    c, d, noise, float(sigma_e[s]), soft_threshold)
        if h > 0:
            gamma_scaled = gamma_scaled + c
        c = c * (w * power_norm / local_power)
        out_planes.append(c)

    if planes_layout == "rows":
        # separate plane arrays — no cube concat; the sequential adds fold in the same scale order as the
        # synthesize reduction
        out = tuple(out_planes)
        recon = out_planes[0]
        for c in out_planes[1:]:
            recon = recon + c
    else:
        out = jnp.stack(out_planes)
        recon = synthesize(out)

    if h > 0:
        # gamma-blend tone mapping (watroo/utils.py:207-217)
        gmin = rops.min(gamma_scaled) if gamma_min is None else jnp.asarray(
            gamma_min, recon.dtype)
        gmax = rops.max(gamma_scaled) if gamma_max is None else jnp.asarray(
            gamma_max, recon.dtype)
        gs = (gamma_scaled - gmin) / (gmax - gmin)
        gs = jnp.clip(gs, 0.0, 1.0) ** (1.0 / gamma)
        recon = (1 - h) * recon + h * gs
    return recon, out


@partial(
    jax.jit,
    static_argnames=(
        "sf", "n_scales", "weights", "whitening", "denoise_coefficients",
        "bilateral", "bilateral_scaling", "soft_threshold",
        "preserve_variance", "gamma", "gamma_min", "gamma_max", "h",
        "has_noise", "need_planes", "planes_layout",
    ),
)
def wow_core(
    data: jax.Array,
    noise: jax.Array,
    *,
    sf: ScalingFunction,
    n_scales: int,
    weights: Tuple[float, ...],
    whitening: bool,
    denoise_coefficients: Tuple[float, ...],
    bilateral: Optional[Tuple[float, ...]],
    bilateral_scaling: bool,
    soft_threshold: bool,
    preserve_variance: bool,
    gamma: float,
    gamma_min: Optional[float],
    gamma_max: Optional[float],
    h: float,
    has_noise: bool,
    need_planes: bool = True,
    planes_layout: str = "cube",
):
    """Decomposition + whitening from a raw image, one XLA program per
    (shape, config).  Returns ``(recon, planes)``.

    ``need_planes=False`` (serving paths that discard the coefficients)
    returns ``(recon, None)``; XLA then dead-code-eliminates the plane
    stores.  ``planes_layout="rows"`` returns the planes as a tuple of
    n_scales+1 arrays instead of one stacked cube — the same values
    without the cube concatenation."""
    planes = decompose(
        data, n_scales, sf, bilateral=bilateral,
        bilateral_scaling=bilateral_scaling)
    recon, out = _wow_body(
        planes, noise, has_noise, sf, n_scales, weights, whitening,
        denoise_coefficients, bilateral is not None, soft_threshold,
        preserve_variance, gamma, gamma_min, gamma_max, h,
        planes_layout=planes_layout,
    )
    return (recon, out) if need_planes else (recon, None)


@partial(
    jax.jit,
    static_argnames=(
        "sf", "n_scales", "weights", "whitening", "denoise_coefficients",
        "bilateral", "soft_threshold", "preserve_variance", "gamma",
        "gamma_min", "gamma_max", "h", "has_noise",
    ),
)
def _wow_from_planes_core(
    planes,
    noise: jax.Array,
    *,
    sf: ScalingFunction,
    n_scales: int,
    weights: Tuple[float, ...],
    whitening: bool,
    denoise_coefficients: Tuple[float, ...],
    bilateral: bool,
    soft_threshold: bool,
    preserve_variance: bool,
    gamma: float,
    gamma_min: Optional[float],
    gamma_max: Optional[float],
    h: float,
    has_noise: bool,
):
    """Whitening from a precomputed coefficient set (the
    ``wow(Coefficients)`` reuse entry, watroo/utils.py:128-133,152-155).
    ``planes`` is the (n_scales+1, ...) cube or — the lazy rows form
    ``wow`` itself emits — a tuple of n_scales+1 per-scale arrays.
    ``bilateral`` here is only a flag: it selects the σ_e table (the
    power smooth is plain either way, watroo/utils.py:194)."""
    rows = planes if isinstance(planes, tuple) else None
    cube = jnp.stack(list(planes)) if rows is not None else planes
    return _wow_body(
        cube, noise, has_noise, sf, n_scales, weights, whitening,
        denoise_coefficients, bilateral, soft_threshold,
        preserve_variance, gamma, gamma_min, gamma_max, h,
        planes_layout="rows" if rows is not None else "cube",
    )


def wow(data,
        scaling_function=B3spline,
        n_scales=None,
        weights=[],
        whitening=True,
        denoise_coefficients=[],
        noise=None,
        bilateral=None,
        bilateral_scaling=False,
        soft_threshold=True,
        preserve_variance=False,
        gamma=3.2,
        gamma_min=None,
        gamma_max=None,
        h=0):
    """Wavelets Optimized Whitening, signature-compatible with
    ``watroo.utils.wow`` (watroo/utils.py:105-219).

    ``data`` may be a raw image (2-D/3-D array) or a precomputed
    :class:`~wavelets_tpu.api.Coefficients` (reuse entry point,
    watroo/utils.py:128-133).  Returns ``(reconstruction, Coefficients)``.
    """
    from_coefficients = isinstance(data, Coefficients)

    if not from_coefficients:
        if not isinstance(data, (np.ndarray, jax.Array)):
            # parity with watroo/utils.py:133
            raise ValueError("Unknown input type")
        if data.ndim not in (2, 3):
            # parity with watroo/utils.py:52
            raise ValueError("Unsupported number of dimensions")
        data = _as_device_array(data)
        spec = _spec_of(scaling_function)
        n_dims = data.ndim
        min_extent = min(data.shape)
    else:
        n_scales = len(data) - 1
        n_dims = data[0].ndim
        scaling_function = data.scaling_function.__class__
        spec = _spec_of(scaling_function)
        min_extent = None

    n_scales, weights_t, denoise_t, sigma_bilateral = normalize_wow_params(
        spec, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims, min_extent)

    has_noise = noise is not None
    static = dict(
        sf=spec,
        n_scales=n_scales,
        weights=weights_t,
        whitening=bool(whitening),
        denoise_coefficients=denoise_t,
        soft_threshold=bool(soft_threshold),
        preserve_variance=bool(preserve_variance),
        gamma=float(gamma),
        gamma_min=None if gamma_min is None else float(gamma_min),
        gamma_max=None if gamma_max is None else float(gamma_max),
        h=float(h),
        has_noise=has_noise,
    )

    if from_coefficients:
        # lazy rows pass through as-is — assembling the cube here would
        # cost the full concat the rows form exists to avoid
        planes = (data._rows if data._rows is not None else data.data)
        noise_arr = (jnp.asarray(noise) if has_noise
                     else (jnp.asarray(data.noise)
                           if data.noise is not None
                           else jnp.zeros((), data[0].dtype)))
        if data.noise is not None:
            static["has_noise"] = True
        recon, out_planes = _wow_from_planes_core(
            planes, noise_arr,
            bilateral=data.bilateral is not None, **static)
        coeffs = Coefficients(
            out_planes, data.scaling_function, data.bilateral)
        coeffs.noise = data.noise
        return recon, coeffs

    noise_arr = (jnp.asarray(noise, data.dtype) if has_noise
                 else jnp.zeros((), data.dtype))
    recon, out_planes = wow_core(
        data, noise_arr,
        bilateral=sigma_bilateral,
        bilateral_scaling=bool(bilateral_scaling),
        planes_layout="rows",
        **static)
    sf_compat = scaling_function(n_dims)
    coeffs = Coefficients(out_planes, sf_compat, bilateral)
    coeffs.noise = noise
    return recon, coeffs


def _stack_core(data, noise_arr, with_coefficients, statics):
    """Batched (B, H, W) stack: one batched decomposition, then a
    per-frame ``vmap`` of the whitening body, so every statistic (MAD
    noise, residual std, gamma bounds) is per frame.  Shared by
    :func:`wow_stack` and the sharded engine's data-axis path
    (wavelets_tpu/parallel/sharded.py)."""
    return _stack_program(data, noise_arr, need_planes=with_coefficients,
                          statics=tuple(sorted(statics.items())))


@partial(jax.jit, static_argnames=("need_planes", "statics"))
def _stack_program(data, noise_arr, *, need_planes, statics):
    # one cached program per (shape, config): without planes XLA
    # dead-code-eliminates the plane stores
    st = dict(statics)
    sf, n, bil = st["sf"], st["n_scales"], st["bilateral"]
    planes = decompose(data, n, sf, axes=(1, 2), bilateral=bil,
                       bilateral_scaling=st["bilateral_scaling"])
    has_noise = st["has_noise"]
    if not has_noise and any(d != 0 for d in st["denoise_coefficients"][:n]):
        # the lazy MAD noise (watroo/wavelets.py:126-127) per frame,
        # outside the vmap: one sort per frame instead of the batched
        # sort vmap would make of it (ops/stats.median_abs_frames)
        noise_arr = mad_noise_frames(
            planes[0], float(sf.sigma_e(2, bil is not None)[0]))
        noise_arr = noise_arr.astype(data.dtype)
        has_noise = True
    body = lambda p, nz: _wow_body(
        p, nz, has_noise, sf, n, st["weights"], st["whitening"],
        st["denoise_coefficients"], bil is not None, st["soft_threshold"],
        st["preserve_variance"], st["gamma"], st["gamma_min"],
        st["gamma_max"], st["h"])
    recon, out = jax.vmap(body, in_axes=(1, 0))(planes, noise_arr)
    return recon, (out if need_planes else None)


def wow_stack(data, noise=None, with_coefficients=True, **kwargs):
    """Per-frame WOW over a frame stack (B, H, W) — the batched 4k-frames
    serving path.  Statistics (MAD noise, residual std, gamma bounds) are
    computed per frame (``vmap``), matching a loop of single-frame
    :func:`wow` calls.  Returns ``(recon (B, H, W), planes
    (B, n_scales+1, H, W))``.

    ``with_coefficients=False`` skips materializing the plane cube in
    device memory (XLA drops the plane stores; the reconstruction is
    unchanged) and returns ``(recon, None)`` — the fast mode for
    serving pipelines that only keep the enhanced frames
    (:func:`wavelets_tpu.models.pipeline.process_stack`).

    Accepts the same keyword arguments as :func:`wow` (except
    ``n_scales`` auto-derivation uses the frame shape).  For multi-chip
    execution prefer :func:`wavelets_tpu.parallel.sharded.sharded_wow`,
    which shards frames and tiles with halo exchange."""
    data = _as_device_array(data)
    if data.ndim != 3:
        raise ValueError("wow_stack expects a (B, H, W) stack")
    scaling_function = kwargs.pop("scaling_function", B3spline)
    spec = _spec_of(scaling_function)
    n_scales = kwargs.pop("n_scales", None)
    h = float(kwargs.get("h", 0))
    denoise_coefficients = list(kwargs.pop("denoise_coefficients", []))
    weights = list(kwargs.pop("weights", []))
    bilateral = kwargs.pop("bilateral", None)

    n_scales, weights_t, denoise_t, sigma_bilateral = normalize_wow_params(
        spec, n_scales, weights, denoise_coefficients, bilateral, h,
        n_dims=2, min_extent=min(data.shape[1:]))

    has_noise = noise is not None
    statics = dict(
        sf=spec,
        n_scales=n_scales,
        weights=weights_t,
        whitening=bool(kwargs.pop("whitening", True)),
        denoise_coefficients=denoise_t,
        bilateral=sigma_bilateral,
        bilateral_scaling=bool(kwargs.pop("bilateral_scaling", False)),
        soft_threshold=bool(kwargs.pop("soft_threshold", True)),
        preserve_variance=bool(kwargs.pop("preserve_variance", False)),
        gamma=float(kwargs.pop("gamma", 3.2)),
        gamma_min=kwargs.pop("gamma_min", None),
        gamma_max=kwargs.pop("gamma_max", None),
        h=h,
        has_noise=has_noise,
    )
    kwargs.pop("h", None)
    if kwargs:
        raise TypeError(f"unexpected arguments: {sorted(kwargs)}")

    if has_noise:
        noise_arr = jnp.asarray(noise, data.dtype)
        if noise_arr.ndim == 0:
            noise_arr = jnp.broadcast_to(noise_arr, (data.shape[0],))
    else:
        noise_arr = jnp.zeros((data.shape[0],), data.dtype)

    return _stack_core(data, noise_arr, with_coefficients, statics)
