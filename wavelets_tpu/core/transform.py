"""The à trous transform engine — functional core.

An accelerator-first redesign of ``AtrousTransform`` (``watroo/wavelets.py:290-444``):

* **Pure and jit-compiled.**  ``decompose(x, level, sf, ...)`` is a pure
  function of the input array; ``level`` and the scaling function are
  static, so the per-scale loop unrolls at trace time into one XLA
  program — no Python↔native boundary crossings per scale/tap as in the
  reference (SURVEY §3.1).
* **Coefficients are an array**, shape ``(level+1, *x.shape)``: planes
  0..level−1 are detail coefficients (successive differences), plane
  ``level`` the smooth residual.  Synthesis is ``sum(planes, 0)`` and is
  exact by construction (the sum telescopes; watroo/wavelets.py:442).
* **The recursive algorithm is deliberately not ported.**  It is a CPU
  cache optimization (decimated sub-array convolution,
  watroo/wavelets.py:330-406) with no use on an accelerator; its output
  contract (identical to the standard path in the interior, one-shot
  symmetric padding at the borders) is reproduced by
  ``decompose(..., recursive_borders=True)``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.conv import (
    atrous_conv_nd,
    boundary_for_ndim,
    local_variance,
    smooth,
)
from ..ops.filters import ScalingFunction

__all__ = [
    "decompose",
    "synthesize",
    "decompose_fn",
    "normalize_bilateral",
]


def normalize_bilateral(bilateral, level: int):
    """Reference list-padding convention for per-scale bilateral σ
    (watroo/wavelets.py:349-352, :421-424): scalar → repeated level+1
    times; list shorter than level+1 → extended with 1s."""
    if bilateral is None:
        return None
    if isinstance(bilateral, (list, tuple)):
        sig = list(bilateral)
    else:
        sig = [bilateral] * (level + 1)
    if len(sig) <= level:
        sig.extend([1] * (level - len(sig) + 1))
    return tuple(float(s) for s in sig)


def _smooth_step(
    c: jax.Array,
    s: int,
    sf: ScalingFunction,
    axes: Tuple[int, ...],
    boundary: str,
    bilateral: Optional[Tuple[float, ...]],
    bilateral_scaling: bool,
):
    """One scale of the chained smoothing (watroo/wavelets.py:429-440)."""
    if bilateral is None:
        return smooth(c, sf, s, axes=axes, boundary=boundary)
    # Bilateral branch: range variance from the local variance estimator
    # scaled by the per-scale σ_b (watroo/wavelets.py:434-440).  The
    # bilateral kernel is not separable (data-dependent weights), so the
    # dense n-D kernel is used with dilated tap offsets.
    variance = local_variance(c, sf, s, axes=axes, boundary=boundary)
    variance = variance * jnp.asarray(bilateral[s] ** 2, c.dtype)
    if bilateral_scaling:
        variance = variance * (s + 1)
    kernel = sf.kernel_nd(len(axes))
    if len(axes) != c.ndim:
        # batched input: vmap the non-separable bilateral conv over the
        # leading (batch) axes.
        batch_axes = tuple(a for a in range(c.ndim) if a not in axes)
        if batch_axes != tuple(range(len(batch_axes))):
            raise ValueError("batch axes must be leading")
        f = lambda ci, vi: atrous_conv_nd(
            ci, kernel, s, bilateral_variance=vi, boundary="symmetric"
        )
        for _ in batch_axes:
            f = jax.vmap(f)
        return f(c, variance)
    return atrous_conv_nd(
        c, kernel, s, bilateral_variance=variance, boundary="symmetric"
    )


@partial(
    jax.jit,
    static_argnames=(
        "level",
        "sf",
        "axes",
        "bilateral",
        "bilateral_scaling",
        "recursive_borders",
        "boundary",
    ),
)
def decompose(
    x: jax.Array,
    level: int,
    sf: ScalingFunction,
    *,
    axes: Optional[Tuple[int, ...]] = None,
    bilateral: Optional[Tuple[float, ...]] = None,
    bilateral_scaling: bool = False,
    recursive_borders: bool = False,
    boundary: Optional[str] = None,
) -> jax.Array:
    """À trous decomposition → coefficient cube ``(level+1, *x.shape)``.

    Standard algorithm (watroo/wavelets.py:408-444): chained smoothing with
    per-scale dilation ``2^s``; plane ``s`` = ``smooth_s − smooth_{s+1}``,
    plane ``level`` = residual.

    ``axes`` selects the spatial axes (default: all); leading non-spatial
    axes are treated as batch.  ``bilateral`` must already be normalized to
    a length-``level+1`` tuple (see :func:`normalize_bilateral`).

    ``recursive_borders=True`` reproduces the reference recursive
    algorithm's border contract: pad once by ``hw·2^(level−1)`` with
    symmetric reflection (watroo/wavelets.py:394-395), transform, crop.
    Interior values are identical to the standard path (SURVEY §2.4).
    """
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if boundary is None:
        boundary = boundary_for_ndim(len(axes))

    if recursive_borders:
        hw = sf.half_width * 2 ** (level - 1) if level > 0 else 0
        pad_widths = [(hw, hw) if a in axes else (0, 0) for a in range(x.ndim)]
        xp = jnp.pad(x, pad_widths, mode="symmetric")
        planes = decompose(
            xp, level, sf,
            axes=axes, bilateral=bilateral, bilateral_scaling=bilateral_scaling,
            recursive_borders=False, boundary=boundary,
        )
        crop = tuple(
            slice(hw, planes.shape[1 + a] - hw) if a in axes else slice(None)
            for a in range(x.ndim)
        )
        return planes[(slice(None),) + crop]

    planes = []
    c = x
    for s in range(level):
        c_next = _smooth_step(
            c, s, sf, axes, boundary, bilateral, bilateral_scaling)
        planes.append(c - c_next)
        c = c_next
    planes.append(c)
    return jnp.stack(planes)


def synthesize(planes: jax.Array) -> jax.Array:
    """Inverse transform: plain sum of planes (watroo/utils.py:98,
    via ``Coefficients.__array__``).  Exact by construction."""
    return jnp.sum(planes, axis=0)


def decompose_fn(level, sf, **static_kwargs):
    """Partially-applied :func:`decompose` for use under vmap/shard_map."""
    return partial(decompose, level=level, sf=sf, **static_kwargs)
