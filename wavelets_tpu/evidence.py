"""Per-config benchmark table.

``run_table()`` measures every config row on the attached GPU and
returns a dict; ``bench.py`` runs it and emits the whole table inside
its one JSON line.

Timing: each row runs ``n_batches`` batches of ``iters`` calls; a batch
ends with ``block_until_ready`` on its last output (the device runs the
calls in order), and the row reports the **best batch mean**."""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from .utils.device import device_tag

__all__ = ["run_table", "measure"]


def measure(fn, v, iters=6, n_batches=5):
    """Best-of-``n_batches`` mean seconds per call of ``fn(v)``."""
    jax.block_until_ready(fn(v))  # compile + warm up
    best = float("inf")
    for _ in range(n_batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(v)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def run_table():
    """Measure every published config row; returns ``{row: entry}``."""
    import importlib

    W = importlib.import_module("wavelets_tpu.models.wow")
    from wavelets_tpu.core.transform import decompose
    from wavelets_tpu.models.denoise import denoise_core
    from wavelets_tpu.models.richardson_lucy import richardson_lucy_core
    from wavelets_tpu.ops.filters import B3SPLINE, TRIANGLE
    from wavelets_tpu.ops.stats import median_abs

    R = {}
    tag = device_tag()
    R["env"] = dict(tag, date=time.strftime("%Y-%m-%d"))

    def rec(key, dt, frames=1.0, note=""):
        R[key] = {"ms": dt * 1e3, "fps": frames / dt}
        if note:
            R[key]["note"] = note
        print(json.dumps({"row": key, **R[key], "device": tag}),
              flush=True)

    def statics(n_scales, dcs, bilateral=None, has_noise=True,
                extent=4096, **over):
        n, w, d, sb = W.normalize_wow_params(
            B3SPLINE, n_scales, [], list(dcs), bilateral, 0.0, 2,
            extent)
        st = dict(sf=B3SPLINE, n_scales=n, weights=w, whitening=True,
                  denoise_coefficients=d, bilateral=sb,
                  bilateral_scaling=False, soft_threshold=True,
                  preserve_variance=False, gamma=3.2, gamma_min=None,
                  gamma_max=None, h=0.0, has_noise=has_noise)
        st.update(over)
        return st

    rng = np.random.default_rng(0)
    big = jnp.asarray(rng.normal(size=(4096, 4096)).astype(np.float32))
    one = jnp.ones((), jnp.float32)
    zero = jnp.zeros((), jnp.float32)

    # ---- headline: 4k L10 standard WOW (BASELINE #4), best of 5 ------
    st10 = statics(None, [], has_noise=False)
    rec("wow_4k_L10_planes", measure(jax.jit(
        lambda a: W.wow_core(a, zero, planes_layout="rows",
                             **st10)[0]), big))
    rec("wow_4k_L10_serving", measure(jax.jit(
        lambda a: W.wow_core(a, zero, need_planes=False, **st10)[0]),
        big))

    # ---- north star: 4k L6 denoise [5,2] ------------------------------
    st6 = statics(6, [5.0, 2.0])
    rec("wow_4k_L6_denoise_known_noise", measure(jax.jit(
        lambda a: W.wow_core(a, one, planes_layout="rows", **st6)[0]),
        big))
    st6l = dict(st6, has_noise=False)
    rec("wow_4k_L6_denoise_lazy_noise", measure(jax.jit(
        lambda a: W.wow_core(a, zero, planes_layout="rows",
                             **st6l)[0]), big))

    # ---- bf16 ---------------------------------------------------------
    b16 = big.astype(jnp.bfloat16)
    rec("wow_4k_L6_bf16_known_noise", measure(jax.jit(
        lambda a: W.wow_core(a, one.astype(jnp.bfloat16),
                             planes_layout="rows", **st6)[0]), b16,
        n_batches=3))
    rec("wow_4k_L10_bf16", measure(jax.jit(
        lambda a: W.wow_core(a, zero.astype(jnp.bfloat16),
                             planes_layout="rows", **st10)[0]), b16,
        n_batches=3))

    # ---- batched serving ---------------------------------------------
    stack4 = jnp.stack([big, big * 0.5, big + 1.0, big * 2.0])
    rec("wow_stack_4x4k_L6_serving_known_noise", measure(jax.jit(
        lambda v: W.wow_stack(v, n_scales=6, noise=1.0,
                              denoise_coefficients=[5, 2],
                              with_coefficients=False)[0]),
        stack4, iters=3, n_batches=3), frames=4.0)
    rec("wow_stack_4x4k_L6_serving_lazy_noise", measure(jax.jit(
        lambda v: W.wow_stack(v, n_scales=6,
                              denoise_coefficients=[5, 2],
                              with_coefficients=False)[0]),
        stack4, iters=3, n_batches=3), frames=4.0)

    # ---- sharded per-chip rate ----------------------------------------
    from wavelets_tpu.parallel import make_mesh
    from wavelets_tpu.parallel.sharded import sharded_wow

    mesh1 = make_mesh(data=1, rows=1, cols=1)
    rec("sharded_wow_1chip_4k_L6_serving", measure(
        lambda v: sharded_wow(v, mesh1, n_scales=6,
                              denoise_coefficients=[5, 2], noise=1.0,
                              with_coefficients=False)[0],
        big[None], n_batches=3),
        note="data-axis mesh, one device")

    # ---- bilateral ----------------------------------------------------
    stb = statics(None, [5.0, 2.0], bilateral=1)
    rec(f"wow_4k_bilateral_L{stb['n_scales']}", measure(jax.jit(
        lambda a: W.wow_core(a, one, planes_layout="rows", **stb)[0]),
        big, iters=3, n_batches=3))
    rec("wow_stack_4x4k_bilateral_L6_serving", measure(jax.jit(
        lambda v: W.wow_stack(v, n_scales=6, bilateral=1,
                              denoise_coefficients=[5, 2],
                              with_coefficients=False)[0]),
        stack4, iters=2, n_batches=3), frames=4.0)

    # ---- odd shapes ---------------------------------------------------
    xo = jnp.asarray(rng.normal(size=(4112, 4100)).astype(np.float32))
    sto = statics(None, [], has_noise=False, extent=4100)
    rec("wow_4112x4100_L10", measure(jax.jit(
        lambda a: W.wow_core(a, zero, planes_layout="rows",
                             **sto)[0]), xo, n_batches=3))
    sto6 = statics(6, [], has_noise=False, extent=4100)
    rec("wow_4112x4100_L6", measure(jax.jit(
        lambda a: W.wow_core(a, zero, planes_layout="rows",
                             **sto6)[0]), xo, n_batches=3))
    st6p = statics(6, [], has_noise=False)
    rec("wow_4096_L6_same_config", measure(jax.jit(
        lambda a: W.wow_core(a, zero, planes_layout="rows",
                             **st6p)[0]), big, n_batches=3))
    ov = (R["wow_4112x4100_L6"]["ms"]
          / R["wow_4096_L6_same_config"]["ms"] - 1) * 100
    px = (4112 * 4100) / (4096 * 4096) * 100 - 100
    R["pad_overhead"] = {"pct": ov, "extra_pixels_pct": px}

    # ---- 3-D volume and 1-D -------------------------------------------
    vol = jnp.asarray(
        rng.normal(size=(64, 1024, 1024)).astype(np.float32))
    rec("denoise_64x1024x1024_3scale", measure(jax.jit(
        lambda v: denoise_core(v, None, (5.0, 3.0, 2.0), B3SPLINE)),
        vol, iters=3, n_batches=3))
    sig = jnp.asarray(rng.normal(size=(1 << 20,)).astype(np.float32))
    rec("transform_1d_1M_L8_roundtrip", measure(jax.jit(
        lambda v: jnp.sum(decompose(v, 8, B3SPLINE), 0)), sig,
        n_batches=3))

    # ---- smaller reference configs ------------------------------------
    x2k = jnp.asarray(rng.normal(size=(2048, 2048)).astype(np.float32))
    rec("denoise_2k_3sigma_soft", measure(jax.jit(
        lambda v: denoise_core(v, None, (3.0, 3.0, 3.0), B3SPLINE)),
        x2k, n_batches=3))
    rec("denoise_2k_3sigma_hard", measure(jax.jit(
        lambda v: denoise_core(v, None, (3.0, 3.0, 3.0), B3SPLINE,
                               soft_threshold=False)), x2k,
        n_batches=3))
    x512 = jnp.asarray(rng.normal(size=(512, 512)).astype(np.float32))
    rec("denoise_512_triangle_2scale", measure(jax.jit(
        lambda v: denoise_core(v, None, (5.0, 3.0), TRIANGLE)), x512,
        n_batches=3))
    x1k = jnp.asarray(rng.normal(size=(1024, 1024)).astype(np.float32))
    rt = jax.jit(lambda v: jnp.sum(decompose(v, 6, B3SPLINE), 0))
    rec("roundtrip_1k_L6", measure(rt, x1k, n_batches=3))
    R["roundtrip_1k_L6"]["max_err_f32"] = float(
        jnp.abs(rt(x1k) - x1k).max())

    # ---- component kernels --------------------------------------------
    rec("decompose_4k_L6", measure(jax.jit(
        lambda v: jnp.sum(decompose(v, 6, B3SPLINE), 0)), big,
        n_batches=3))
    rec("median_abs_4k", measure(jax.jit(
        lambda v: v + median_abs(v)), big, n_batches=3))

    # ---- Richardson-Lucy ----------------------------------------------
    pos1k = x1k * x1k + 1.0
    psf = jnp.asarray(
        np.outer(*(np.hanning(15),) * 2).astype(np.float32))
    psf = psf / psf.sum()
    for fft, name in ((False, "direct"), (True, "fft")):
        f = jax.jit(lambda v, fft=fft: richardson_lucy_core(
            v, psf, iterations=10,
            denoise_coefficients=(5.0, 2.0, 1.0),
            threshold_type="soft", fft=fft))
        rec(f"richardson_lucy_1k_10it_{name}",
            measure(f, pos1k, iters=3, n_batches=3))
    stack2 = jnp.stack([pos1k, pos1k * 2.0])
    rec("richardson_lucy_stack2_1k_10it_auto", measure(jax.jit(
        lambda v: richardson_lucy_core(
            v, psf, iterations=10,
            denoise_coefficients=(5.0, 2.0, 1.0),
            threshold_type="soft", fft=True)), stack2, iters=3,
        n_batches=3), frames=2.0)

    # ---- 8k rows (slowest compiles last) ------------------------------
    big8 = jnp.asarray(rng.normal(size=(8192, 8192)).astype(np.float32))
    st8 = statics(None, [5.0, 2.0], extent=8192)
    n8 = st8["n_scales"]
    rec(f"wow_8k_L{n8}_denoise_planes", measure(jax.jit(
        lambda a: W.wow_core(a, one, planes_layout="rows", **st8)[0]),
        big8, iters=3, n_batches=3))
    rec(f"wow_8k_L{n8}_denoise_serving", measure(jax.jit(
        lambda a: W.wow_core(a, one, need_planes=False, **st8)[0]),
        big8, iters=3, n_batches=3))
    stb8 = statics(None, [5.0, 2.0], bilateral=1, extent=8192)
    rec(f"wow_8k_bilateral_L{stb8['n_scales']}", measure(jax.jit(
        lambda a: W.wow_core(a, one, planes_layout="rows", **stb8)[0]),
        big8, iters=2, n_batches=2))

    return R
