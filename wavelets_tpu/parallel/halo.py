"""Scale-dependent halo exchange for dilated stencils under ``shard_map``.

This is the spatial analog of sequence/context parallelism (SURVEY §2.3):
the à trous kernel at scale ``s`` reaches ``hw·2^s`` pixels, so a tile
needs exactly that many boundary rows/cols from each neighbor before the
stencil — exchanged with ``lax.ppermute`` between mesh neighbors.  Global image borders apply the reference's per-ndim
reflection locally on the edge shards, so the sharded result is
*bitwise identical* to the single-device transform (same values, same
accumulation order per element).

Deep scales where the reach exceeds the local tile extent fall back to a
tiled ``all_gather`` of the (heavily smoothed, cheap) plane along that
axis — the degradation path called out in SURVEY §5."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.conv import separable_smooth_axis

__all__ = ["halo_smooth_axis", "halo_exchange_axis"]


def _reflect_halos(x, h: int, axis: int, boundary: str):
    """Local reflection halos for the global image border.

    ``symmetric``: edge-duplicated (cv2 BORDER_REFLECT); ``reflect``:
    whole-sample reflect-101 (scipy mirror) — SURVEY §2.4."""
    n = x.shape[axis]
    if boundary == "symmetric":
        left = jnp.flip(lax.slice_in_dim(x, 0, h, axis=axis), axis=axis)
        right = jnp.flip(lax.slice_in_dim(x, n - h, n, axis=axis), axis=axis)
    elif boundary == "reflect":
        left = jnp.flip(lax.slice_in_dim(x, 1, h + 1, axis=axis), axis=axis)
        right = jnp.flip(
            lax.slice_in_dim(x, n - h - 1, n - 1, axis=axis), axis=axis)
    else:
        raise ValueError(f"unsupported boundary {boundary!r}")
    return left, right


def halo_exchange_axis(
    x: jax.Array,
    h: int,
    axis: int,
    axis_name: str,
    n_shards: int,
    boundary: str = "symmetric",
) -> jax.Array:
    """Extend the local block by ``h`` rows/cols on each side along
    ``axis``: interior halos come from ring neighbors via ``ppermute``;
    the first/last shard substitutes the reference boundary reflection.

    Requires ``h <= local extent`` (single-neighbor reach)."""
    n = x.shape[axis]
    if h > n:
        raise ValueError(f"halo {h} exceeds local extent {n}")
    my_left = lax.slice_in_dim(x, 0, h, axis=axis)
    my_right = lax.slice_in_dim(x, n - h, n, axis=axis)
    # shard i's right edge → shard i+1's left halo, and vice versa
    from_left = lax.ppermute(
        my_right, axis_name, [(i, i + 1) for i in range(n_shards - 1)])
    from_right = lax.ppermute(
        my_left, axis_name, [(i + 1, i) for i in range(n_shards - 1)])
    refl_left, refl_right = _reflect_halos(x, h, axis, boundary)
    idx = lax.axis_index(axis_name)
    left = jnp.where(idx == 0, refl_left, from_left)
    right = jnp.where(idx == n_shards - 1, refl_right, from_right)
    return jnp.concatenate([left, x, right], axis=axis)


def halo_smooth_axis(
    x: jax.Array,
    taps: Tuple[float, ...],
    scale: int,
    axis: int,
    axis_name: str,
    n_shards: int,
    boundary: str = "symmetric",
) -> jax.Array:
    """1-D dilated convolution along a sharded axis.

    Per-element arithmetic is identical to the single-device
    :func:`~wavelets_tpu.ops.conv.separable_smooth_axis` (same shifted-slice
    accumulation order), so sharded == unsharded bitwise."""
    if n_shards == 1:
        return separable_smooth_axis(x, taps, scale, axis, boundary)
    k = len(taps)
    hw = (k - 1) // 2
    if hw == 0:
        return x * taps[0]
    d = 2 ** scale
    h = hw * d
    n = x.shape[axis]

    if h > n:
        # deep-scale fallback: reach exceeds the tile — gather the full
        # axis (tiled all_gather), smooth, take the local slice back.
        full = lax.all_gather(x, axis_name, axis=axis, tiled=True)
        out_full = separable_smooth_axis(full, taps, scale, axis, boundary)
        idx = lax.axis_index(axis_name)
        return lax.dynamic_slice_in_dim(out_full, idx * n, n, axis=axis)

    ext = halo_exchange_axis(x, h, axis, axis_name, n_shards, boundary)

    def shifted(offset):
        return lax.slice_in_dim(ext, h + offset, h + offset + n, axis=axis)

    symmetric = all(taps[i] == taps[-1 - i] for i in range(hw))
    out = x * taps[hw]
    if symmetric:
        for j in range(1, hw + 1):
            out = out + taps[hw + j] * (shifted(-j * d) + shifted(j * d))
    else:
        for j in range(1, hw + 1):
            out = out + taps[hw - j] * shifted(-j * d)
            out = out + taps[hw + j] * shifted(j * d)
    return out
