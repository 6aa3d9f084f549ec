#!/usr/bin/env python
"""Headline benchmark: 4096×4096 standard WOW, auto scale count (10),
one GPU — the reference's config #4 (BASELINE.md: 27.3 s ⇒ 0.037
frames/s on 1× CPU; measured there, the repo publishes no numbers).

Each timing ends with ``block_until_ready``.  Every printed line names
the device (platform, kind, count, power limit); with no GPU the bench
raises instead of timing the CPU, and a failed row ends the process
with a nonzero exit code.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from wavelets_tpu.utils.compile_cache import enable_compile_cache
from wavelets_tpu.utils.device import device_tag

BASELINE_FPS = 0.037  # BASELINE.md row 4: 4k² standard WOW, 1× CPU


def _rate(fn, x, iters):
    """Calls per second of ``fn(x)`` after a warm-up call."""
    jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    jax.block_until_ready(out)
    return iters / (time.perf_counter() - t0)


def main_table():
    """Full per-config table (wavelets_tpu/evidence.py): one JSON line
    per row while it runs, then ONE JSON line with the headline metric
    plus the whole table."""
    enable_compile_cache()
    from wavelets_tpu.evidence import run_table

    tag = device_tag()
    table = run_table()
    head = table["wow_4k_L10_planes"]
    print(json.dumps({
        "metric": "wow_4k_auto10scale_frames_per_s_per_chip",
        "value": head["fps"],
        "unit": "frames/s",
        "vs_baseline": head["fps"] / BASELINE_FPS,
        "device": tag,
        "table": table,
    }), flush=True)


def main():
    """Headline rows only: 4k² L10 with planes, recon-only serving, and
    a 4×4k² stack at L6."""
    enable_compile_cache()
    from wavelets_tpu.models.wow import wow_core, wow_stack
    from wavelets_tpu.ops.filters import B3SPLINE

    tag = device_tag()
    n = 4096
    n_scales = 10  # wow() auto: round(log2(4096) - log2(5)) = 10
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(size=(n, n)).astype(np.float32))

    statics = dict(
        sf=B3SPLINE,
        n_scales=n_scales,
        weights=(1.0,) * (n_scales + 1),
        whitening=True,
        denoise_coefficients=(0.0,) * n_scales + (1.0,),
        bilateral=None,
        bilateral_scaling=False,
        soft_threshold=True,
        preserve_variance=False,
        gamma=3.2,
        gamma_min=None,
        gamma_max=None,
        h=0.0,
        has_noise=False,
    )
    zero = jnp.zeros((), jnp.float32)

    # planes_layout="rows": every plane is computed and leaves the
    # program as one of n_scales+1 arrays (what wow() consumes)
    planes = jax.jit(lambda v: wow_core(v, zero, planes_layout="rows",
                                        **statics))
    fps = _rate(planes, data, 30)
    # serving mode: recon only; XLA drops the plane stores
    serve = jax.jit(lambda v: wow_core(v, zero, need_planes=False,
                                       **statics)[0])
    serving_fps = _rate(serve, data, 30)
    # batched serving: 4 x 4k frame stack, 6 scales, per-frame
    # statistics, coefficients discarded (process_stack mode)
    stack = jnp.stack([data, data * 0.5, data + 1.0, data * 2.0])
    fstack = lambda v: wow_stack(v, n_scales=6,
                                 with_coefficients=False)[0]
    stack_fps = 4.0 * _rate(fstack, stack, 10)

    print(json.dumps({
        "metric": "wow_4k_auto10scale_frames_per_s_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "serving_l10_recon_only_fps": serving_fps,
        "stack4_l6_serving_fps": stack_fps,
        "device": tag,
    }), flush=True)


if __name__ == "__main__":
    main()
