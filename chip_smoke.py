#!/usr/bin/env python
"""Bring-up smoke test of the wavelet engine on one NVIDIA GPU.

    python chip_smoke.py            # every one-card phase, one GPU
    python chip_smoke.py --four     # the four-card mesh phase only

Drives the main paths through the entry points a user calls, at full
size (4096² frames, 10 scales), on random data made from ``--seed``.
Every phase prints its compile time, ``compiled.memory_analysis()``, its
steady time (each call ended with ``block_until_ready``) and its
comparison with the plain float64 reference (tests/plain_reference.py).
A phase that fails raises, and the script exits nonzero; so does a run
that finds no GPU.  The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Tolerances (relative = max |engine − reference| / max |reference|):

* The engine runs float32 on the card; the reference is float64.  Each
  dilated smoothing rounds at about 6e-8 relative, and the pipelines
  chain tens of them, whiten by a local power and sum up to 11 planes.
* ``erf`` is XLA's float32 approximation on the card and
  ``scipy.special.erf`` in float64 (a few 1e-7 apart).
* Reductions (means, std, sums over planes) run in another order than
  numpy's.
* No matrix product runs on the main path, so TF32 never enters.
* Hard thresholds can flip where ``|w|`` sits at the threshold, so they
  are compared as the share of pixels that disagree beyond the float32
  tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "smoke_out")

#: relative tolerance of float32 pipelines against the float64 reference
TOL_F32 = 1e-4
#: ...of Richardson-Lucy, whose multiplicative update compounds the
#: float32 rounding of ten iterations of blur, transform and division
TOL_RL = 1e-3
#: ...of float64 on the card against float64 numpy (erf and order only)
TOL_F64 = 1e-9
#: ...between one card and a mesh of four (float32 both sides; only
#: the order of reductions and the fusion of the programs differ)
TOL_MESH = 1e-4
#: largest share of pixels a hard threshold may flip
HARD_FLIP_SHARE = 1e-4

def report(phase, **fields):
    """Print one result line."""
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


# ---- measurement helpers ---------------------------------------------

def _memory(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def stage(phase, fn, *args, iters=5):
    """Compile ``jax.jit(fn)`` for ``args``, run it once to warm up, then
    ``iters`` times, each ended with ``block_until_ready``.  Reports the
    compile time, the memory analysis and the median steady time, and
    returns the output and the steady seconds."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    steady = float(np.median(times))
    report(phase, compile_s=t_compile, memory=_memory(compiled),
           steady_ms=steady * 1e3, iters=iters)
    return out, steady


def compare(phase, got, want, tol, what="relative max error"):
    """Engine output vs reference: shape, finiteness and the relative
    max error against ``tol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (phase, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{phase}: non-finite output"
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    report(phase, compare=what, value=err, limit=tol, ok=err <= tol)
    assert err <= tol, f"{phase}: {what} {err:.3e} > {tol:.1e}"
    return err


def compare_hard(phase, got, want, tol=TOL_F32, share=HARD_FLIP_SHARE):
    """Hard-threshold output: the share of pixels off by more than
    ``tol`` (relative to max |reference|) must stay under ``share``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (phase, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{phase}: non-finite output"
    bad = np.abs(got - want) > tol * np.max(np.abs(want))
    frac = float(bad.mean())
    report(phase, compare="share of pixels beyond tolerance",
           value=frac, limit=share, ok=frac <= share)
    assert frac <= share, f"{phase}: {frac:.3e} of pixels flipped"
    return frac


def _frame(rng, n):
    return rng.normal(size=(n, n)).astype(np.float32)


# ---- phases ------------------------------------------------------------

def phase_wow(seed, n=4096):
    """``wt.wow`` auto scales, denoise [5, 2]; the transform round trip."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    img = _frame(np.random.default_rng(seed), n)
    x = jnp.asarray(img)

    def wow(v):
        recon, coeffs = wt.wow(v, denoise_coefficients=[5, 2])
        return recon, tuple(coeffs[s] for s in range(len(coeffs)))

    (recon, planes), _ = stage("wow", wow, x)
    level = len(planes) - 1
    report("wow", n_scales=level)
    # the reference takes the engine's auto scale count explicitly
    # (10 at 4096², SURVEY §2.4) and reuses its transform below
    ref_planes = ref.transform(img, level)
    want, want_c = ref.wow(ref.Coefficients(ref_planes.copy()),
                           denoise_coefficients=[5, 2])
    compare("wow", recon, want, TOL_F32)
    compare("wow_planes", np.stack([np.asarray(p) for p in planes]),
            want_c.data, TOL_F32)
    # no denoising: the configuration of the CPU reference time
    # (BASELINE.md config 4)
    got, _ = stage("wow_no_denoise", lambda v: wt.wow(v)[0], x)
    want, _ = ref.wow(ref.Coefficients(ref_planes.copy()))
    compare("wow_no_denoise", got, want, TOL_F32)

    rt, _ = stage("transform_roundtrip",
                  lambda v: jnp.sum(wt.AtrousTransform()(v, level).data, 0),
                  x)
    err = float(np.max(np.abs(np.asarray(rt, np.float64) - img)))
    report("transform_roundtrip", compare="max |sum(planes) - input|",
           value=err, limit=1e-5, ok=err <= 1e-5)
    assert err <= 1e-5, err
    planes_c, _ = stage("transform_planes",
                        lambda v: wt.AtrousTransform()(v, level).data, x,
                        iters=3)
    compare("transform_planes", planes_c, ref_planes, TOL_F32)


def phase_served(seed, n=4096, frames=8, batch=4):
    """``python -m wavelets_tpu wow … --batch 4`` in-process on a seeded
    uint16 stack (the card belongs to this process)."""
    from tests import plain_reference as ref
    from wavelets_tpu.cli import main as cli_main

    os.makedirs(DATA_DIR, exist_ok=True)
    src = os.path.join(DATA_DIR, "stack_u16.raw")
    dst = os.path.join(DATA_DIR, "stack_wow.f32")
    rng = np.random.default_rng(seed)
    stack = np.clip(1000 + 100 * rng.standard_normal((frames, n, n)),
                    0, 65535).astype(np.uint16)
    stack.tofile(src)
    argv = ["wow", src, dst, "--frames", str(frames), "--shape", str(n),
            str(n), "--dtype", "uint16", "--denoise", "5", "2",
            "--batch", str(batch)]
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        assert cli_main(argv) == 0
        dt = time.perf_counter() - t0
        report("served", run=run, seconds=dt, frames_per_s=frames / dt)
    out0 = np.fromfile(dst, np.float32, count=n * n).reshape(n, n)
    for path in (src, dst):
        os.remove(path)
    want, _ = ref.wow(stack[0].astype(np.float64),
                      denoise_coefficients=[5, 2])
    compare("served_frame0", out0, want, TOL_F32)


def phase_bilateral(seed, n_ref=1024, n_big=4096):
    """Bilateral WOW [5, 2]: against the reference at 1024² (BASELINE.md
    config 5), finite output and time at 4096²."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    rng = np.random.default_rng(seed)
    img = _frame(rng, n_ref)
    f = lambda v: wt.wow(v, bilateral=1, denoise_coefficients=[5, 2])[0]
    got, _ = stage("bilateral_1k", f, jnp.asarray(img))
    want, _ = ref.wow(img.astype(np.float64), bilateral=1,
                      denoise_coefficients=[5, 2])
    compare("bilateral_1k", got, want, TOL_F32)
    big = _frame(rng, n_big)
    got, _ = stage("bilateral_4k", f, jnp.asarray(big), iters=3)
    ok = bool(np.isfinite(np.asarray(got)).all())
    report("bilateral_4k", compare="finite", value=ok, ok=ok)
    assert ok


def phase_denoise(seed, n2=2048, n_tri=512):
    """3σ denoise at 2048² (soft and hard) and Triangle denoise at 512²."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    rng = np.random.default_rng(seed)
    img = _frame(rng, n2)
    x = jnp.asarray(img)
    for soft in (True, False):
        name = "denoise_2k_3sigma_" + ("soft" if soft else "hard")
        got, _ = stage(name, lambda v: wt.denoise(
            v, [3, 3, 3], soft_threshold=soft), x, iters=10)
        want = ref.denoise(img, [3, 3, 3], soft_threshold=soft)
        if soft:
            compare(name, got, want, TOL_F32)
        else:
            compare_hard(name, got, want)
    small = _frame(rng, n_tri)
    got, _ = stage("denoise_512_triangle",
                   lambda v: wt.denoise(v, [5, 3], wt.Triangle),
                   jnp.asarray(small), iters=20)
    compare("denoise_512_triangle", got,
            ref.denoise(small, [5, 3], "triangle"), TOL_F32)


def phase_volume(seed, shape=(64, 1024, 1024)):
    """3-scale denoise of a 64×1024×1024 volume (a 3-D transform)."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    vol = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    got, _ = stage("volume_denoise", lambda v: wt.denoise(v, [5, 3, 2]),
                   jnp.asarray(vol), iters=3)
    compare("volume_denoise", got, ref.denoise(vol, [5, 3, 2]), TOL_F32)


def phase_roundtrip_1d(seed, n=1 << 20, level=8):
    """1-D signal of 1M samples, 8 scales: round trip and planes."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    sig = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    planes, _ = stage("transform_1d",
                      lambda v: wt.AtrousTransform()(v, level).data,
                      jnp.asarray(sig), iters=10)
    err = float(np.max(np.abs(np.asarray(planes, np.float64).sum(0)
                              - sig)))
    report("transform_1d", compare="max |sum(planes) - input|",
           value=err, limit=1e-5, ok=err <= 1e-5)
    assert err <= 1e-5, err
    compare("transform_1d_planes", planes, ref.transform(sig, level),
            TOL_F32)


def _rl_scene(rng, n, psf):
    from tests import plain_reference as ref

    scene = 10.0 + 100.0 * rng.random((n, n)) ** 8
    return ref.correlate2d(scene, psf[::-1, ::-1]).astype(np.float32)


def _gauss_psf(k):
    r = np.arange(k) - k // 2
    psf = np.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (0.25 * k * k))
    return psf / psf.sum()


def phase_rl(seed, n=1024, iterations=10, sweep=(3, 5, 7, 9, 11, 15)):
    """Richardson-Lucy at 1024², 10 iterations, direct and FFT against
    the reference; then direct vs FFT time over PSF sizes (the
    ``fft="auto"`` crossover)."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    rng = np.random.default_rng(seed)
    psf = _gauss_psf(9)
    data = _rl_scene(rng, n, psf)
    x = jnp.asarray(data)
    for fft in (False, True):
        name = "rl_1k_10it_" + ("fft" if fft else "direct")
        got, _ = stage(name, lambda v: wt.richardson_lucy(
            v, psf.astype(np.float32), iterations=iterations, fft=fft),
            x, iters=3)
        want = ref.richardson_lucy(data, psf, iterations=iterations,
                                   fft=fft)
        compare(name, got, want, TOL_RL)
    for k in sweep:
        p = _gauss_psf(k).astype(np.float32)
        row = {}
        for fft in (False, True):
            _, t = stage(f"rl_sweep_{k}x{k}_" + ("fft" if fft else "direct"),
                         lambda v: wt.richardson_lucy(
                             v, p, iterations=iterations, fft=fft),
                         x, iters=3)
            row["fft" if fft else "direct"] = t * 1e3
        report("rl_crossover", psf=f"{k}x{k}", taps=k * k, ms=row)


def phase_stack(seed, n=4096, frames=4):
    """``wow_stack`` serving: 4×4096², 6 scales, per-frame lazy noise,
    no coefficients kept."""
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    rng = np.random.default_rng(seed)
    stack = np.stack([_frame(rng, n) * (1 + k) for k in range(frames)])
    got, t = stage("wow_stack_4x4k_serving", lambda v: wt.wow_stack(
        v, n_scales=6, denoise_coefficients=[5, 2],
        with_coefficients=False)[0], jnp.asarray(stack))
    report("wow_stack_4x4k_serving", frames_per_s=frames / t)
    want, _ = ref.wow(stack[1].astype(np.float64), n_scales=6,
                      denoise_coefficients=[5, 2])
    compare("wow_stack_frame1", got[1], want, TOL_F32)


def phase_median(seed, n=4096, frames=4):
    """Exact median of |x| (the MAD noise): one 4096² frame, and a
    4×4096² stack sorted per frame (the engine's way) and along the
    frame axis (what ``vmap`` would make of it)."""
    import jax.numpy as jnp

    from wavelets_tpu.ops import stats

    rng = np.random.default_rng(seed)
    one = _frame(rng, n)
    many = np.stack([_frame(rng, n) for _ in range(frames)])
    got, _ = stage("median_4k", stats.median_abs, jnp.asarray(one),
                   iters=10)
    assert float(got) == float(np.median(np.abs(one)))
    want = np.median(np.abs(many).reshape(frames, -1), axis=1)
    for name, f in (("per_frame", stats.median_abs_frames),
                    ("axis_sort", lambda a: jnp.median(
                        jnp.abs(a).reshape(a.shape[0], -1), axis=1))):
        got, _ = stage(f"median_4x4k_{name}", f, jnp.asarray(many),
                       iters=10)
        assert np.array_equal(np.asarray(got), want), name
    report("median", compare="exact vs np.median", ok=True)


def phase_x64(seed, n=2048):
    """uint16 input under x64: the engine recasts to float64 on the card
    (watroo/wavelets.py:297) and matches the float64 reference."""
    import jax
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from tests import plain_reference as ref

    jax.config.update("jax_enable_x64", True)
    img = np.random.default_rng(seed).integers(
        0, 4096, size=(n, n)).astype(np.uint16)
    recon, _ = wt.wow(img, denoise_coefficients=[5, 2])
    assert recon.dtype == jnp.float64, recon.dtype
    got, _ = stage("wow_uint16_x64",
                   lambda v: wt.wow(v, denoise_coefficients=[5, 2])[0],
                   jnp.asarray(img), iters=3)
    want, _ = ref.wow(img, denoise_coefficients=[5, 2])
    compare("wow_uint16_x64", got, want, TOL_F64)
    compare("wow_uint16_x64_front_door", recon, want, TOL_F64)


PHASES = {
    "wow": phase_wow,
    "served": phase_served,
    "bilateral": phase_bilateral,
    "denoise": phase_denoise,
    "volume": phase_volume,
    "roundtrip1d": phase_roundtrip_1d,
    "rl": phase_rl,
    "stack": phase_stack,
    "median": phase_median,
    "x64": phase_x64,  # last: it switches the process to x64
}


def phase_four(seed, n_stack=4096, n_tiled=8192):
    """Four cards: ``sharded_wow`` on a data=4 mesh against ``wow_stack``
    on one card, and a rows=2 × cols=2 tiled 8192² WOW (plain and
    bilateral) against the same WOW on one card."""
    import jax
    import jax.numpy as jnp

    import wavelets_tpu as wt
    from wavelets_tpu.parallel import make_mesh, sharded_wow

    assert len(jax.devices()) == 4, jax.devices()
    rng = np.random.default_rng(seed)
    stack = jnp.asarray(np.stack([_frame(rng, n_stack) * (1 + k)
                                  for k in range(4)]))
    mesh_d = make_mesh(data=4)
    got, t = stage("four_data_axis_4x4k", lambda v: sharded_wow(
        v, mesh_d, denoise_coefficients=[5, 2],
        with_coefficients=False)[0], stack)
    report("four_data_axis_4x4k", frames_per_s=4 / t)
    want, t1 = stage("one_card_wow_stack_4x4k", lambda v: wt.wow_stack(
        v, denoise_coefficients=[5, 2], with_coefficients=False)[0],
        stack)
    report("one_card_wow_stack_4x4k", frames_per_s=4 / t1)
    compare("four_data_axis_vs_one_card", got, want, TOL_MESH)

    img = jnp.asarray(_frame(rng, n_tiled))
    mesh_t = make_mesh(rows=2, cols=2)
    for bil in (None, 1):
        tag = "bilateral" if bil else "plain"
        got, _ = stage(f"four_tiled_8k_{tag}", lambda v: sharded_wow(
            v, mesh_t, bilateral=bil, denoise_coefficients=[5, 2],
            with_coefficients=False)[0], img, iters=3)
        want, _ = stage(f"one_card_wow_8k_{tag}", lambda v: wt.wow(
            v, bilateral=bil, denoise_coefficients=[5, 2])[0], img,
            iters=3)
        compare(f"four_tiled_8k_{tag}_vs_one_card", got, want, TOL_MESH)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from wavelets_tpu.utils.device import (gpu_name_and_power_limit,
                                           require_gpu)

    smi = gpu_name_and_power_limit()
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    import jax

    print(f"jax {jax.__version__}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    dev = require_gpu()
    print(f"device_kind {dev.device_kind!r}; {len(jax.devices())} "
          f"device(s)", flush=True)
    from wavelets_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache {enable_compile_cache()}", flush=True)

    t_all = time.perf_counter()
    if args.four:
        phase_four(args.seed)
    else:
        for name, phase in PHASES.items():
            t0 = time.perf_counter()
            phase(args.seed)
            report(name, phase_seconds=time.perf_counter() - t0)
    report("total", seconds=time.perf_counter() - t_all)
    print(f"nvidia-smi name, power.limit: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
