"""Coefficient statistics: noise estimation, significance, thresholds.

Rewrites of the reference's coefficient algebra
(``watroo/wavelets.py:14-21`` Anscombe, ``:126-149`` noise/significance/
denoise).  Everything is elementwise or a single global reduction, and
fuses into the surrounding jitted pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


__all__ = [
    "generalized_anscombe",
    "mad_noise",
    "mad_noise_frames",
    "median_abs_frames",
    "significance_soft",
    "significance_hard",
    "significance",
    "apply_denoise",
]

#: MAD → σ conversion constant for a Gaussian (watroo/wavelets.py:127).
MAD_TO_SIGMA = 0.6745


def generalized_anscombe(signal, alpha=1.0, g=0.0, sigma=0.0, inverse=False):
    """Generalized Anscombe variance-stabilizing transform.

    Mirrors ``watroo/wavelets.py:14-21`` including the ``≤0 → 0`` clamp on
    the forward branch.  Works on numpy or jax arrays.
    """
    signal = jnp.asarray(signal)
    if inverse:
        return ((alpha * signal / 2) ** 2 + alpha * g - sigma ** 2
                - 3 * alpha / 8) / alpha
    dum = alpha * signal + 3 * alpha ** 2 / 8 + sigma ** 2 - alpha * g
    dum = jnp.where(dum <= 0, jnp.zeros((), dum.dtype), dum)
    return 2 * jnp.sqrt(dum) / alpha


def median_abs(x: jax.Array) -> jax.Array:
    """``median(|x|)`` with numpy semantics (mean of the two middle order
    statistics for even counts), by sorting.

    One H100 (400 W limit) took 1.07 ms for a 4096² plane, against
    2.65 ms for a 30-pass bit-pattern bisection; see
    :func:`median_abs_frames` for stacks."""
    return jnp.median(jnp.abs(x))


def median_abs_frames(x: jax.Array) -> jax.Array:
    """Per-frame ``median(|x|)`` over a stack ``(B, ...)`` → ``(B,)``:
    one whole-plane sort per frame.  A single sort along the frame axis
    (``jnp.median(..., axis=1)``, also what ``vmap`` of
    :func:`median_abs` becomes) took 38.4 ms for 4×4096² on one H100,
    against 1.07 ms per plane sorted alone."""
    return jnp.stack([median_abs(x[b]) for b in range(x.shape[0])])


def mad_noise(w0: jax.Array, sigma_e0: float) -> jax.Array:
    """Noise level from the finest detail plane via the MAD estimator:
    ``median(|w0|) / 0.6745 / σ_e[0]`` (watroo/wavelets.py:126-127)."""
    return median_abs(w0) / MAD_TO_SIGMA / sigma_e0


def mad_noise_frames(w0: jax.Array, sigma_e0: float) -> jax.Array:
    """Per-frame MAD noise over a stack of finest detail planes
    ``(B, H, W)`` → ``(B,)``."""
    return median_abs_frames(w0) / MAD_TO_SIGMA / sigma_e0


def significance_soft(w: jax.Array, threshold) -> jax.Array:
    """Smooth multiplicative mask ``erf(|w|/t)`` (watroo/wavelets.py:136-139).

    Note: this is *not* classic soft shrinkage — it is the reference's
    erf-based significance weighting, in (0, 1).
    """
    r = jnp.abs(w / threshold)
    return jax.scipy.special.erf(r)


def significance_hard(w: jax.Array, threshold) -> jax.Array:
    """Boolean mask ``|w| > t`` (watroo/wavelets.py:141)."""
    return jnp.abs(w) > threshold


def significance(
    w: jax.Array,
    sigma: float,
    noise,
    sigma_e_scale: float,
    soft_threshold: bool = True,
) -> jax.Array:
    """Per-plane significance, replicating ``Coefficients.significance``
    (watroo/wavelets.py:129-143) for a known ``noise`` level.

    ``sigma`` is static; the ``sigma == 0`` shortcut must be handled by the
    caller (it returns ones without touching ``noise``).  A zero threshold
    (``noise == 0``, e.g. constant input) yields ones, matching the
    reference's explicit ``noise == 0`` branch (watroo/wavelets.py:133-135)
    without a data-dependent Python branch.
    """
    t = jnp.asarray(sigma * noise * sigma_e_scale, w.dtype)
    ones = jnp.ones_like(w)
    safe_t = jnp.where(t == 0, jnp.ones_like(t), t)
    if soft_threshold:
        mask = significance_soft(w, safe_t)
        return jnp.where(t == 0, ones, mask)
    mask = significance_hard(w, safe_t).astype(w.dtype)
    return jnp.where(t == 0, ones, mask)


def apply_denoise(
    planes: jax.Array,
    sigmas,
    weights,
    sigma_e,
    noise,
    soft_threshold: bool = True,
) -> jax.Array:
    """Scale-wise denoise of a coefficient cube, replicating
    ``Coefficients.denoise`` (watroo/wavelets.py:145-149).

    ``planes`` has shape ``(level+1, ...)``.  ``zip`` truncation semantics
    are preserved: only ``min(len(sigmas), len(weights), planes)`` leading
    planes are modified; trailing planes (typically the residual) pass
    through untouched.
    """
    sigmas = tuple(sigmas)
    weights = tuple(weights) if weights is not None else (1.0,) * len(sigmas)
    n = min(planes.shape[0], len(sigmas), len(weights))
    out = []
    for s in range(planes.shape[0]):
        c = planes[s]
        if s < n:
            wgt = jnp.asarray(weights[s], c.dtype)
            if sigmas[s] != 0:
                mask = significance(
                    c, sigmas[s], noise, sigma_e[s], soft_threshold
                )
                c = c * (wgt * mask)
            else:
                c = c * wgt
        out.append(c)
    return jnp.stack(out)
