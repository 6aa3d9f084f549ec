"""Timing and roofline instrumentation.

The reference has no tracing/profiling at all (SURVEY §5); for a
production engine the per-stage cost and the distance to the hardware
roofline are first-class outputs.  This module provides:

* :func:`trace` — a ``jax.profiler`` trace of a block,
* :class:`StageTimer` — wall-clock stage timing that ends every stage
  with ``block_until_ready``,
* analytic cost models (bytes moved / FLOPs) for the dilated-conv
  transform and the WOW pipeline,
* :data:`PEAKS` and :func:`roofline` — measured time vs the bandwidth or
  compute bound of the device that ran it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import jax
import numpy as np

from ..ops.filters import ScalingFunction

__all__ = ["StageTimer", "Cost", "Peak", "PEAKS", "peak_for",
           "decompose_cost", "wow_cost", "roofline", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block (view with
    TensorBoard / Perfetto).  A profiler that cannot start raises."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class Peak:
    """Published peak rates of one device."""

    hbm_gbps: float
    f32_gflops: float
    source: str


#: Peaks keyed by ``jax.Device.device_kind``.  The stencils here are
#: float32 elementwise work, so the compute bound is the f32 rate
#: outside the tensor cores.
PEAKS: Dict[str, Peak] = {
    "NVIDIA H100 80GB HBM3": Peak(
        hbm_gbps=3350.0, f32_gflops=67000.0,
        source="NVIDIA H100 data sheet, SXM5: 3.35 TB/s HBM3, "
               "67 TFLOP/s FP32 (non-tensor), at the 700 W limit"),
}


def peak_for(device_kind: Optional[str] = None) -> Peak:
    """Peak rates of ``device_kind`` (default: the first JAX device).
    A device that is not in :data:`PEAKS` raises."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


@dataclasses.dataclass
class Cost:
    """Analytic cost of a pipeline stage."""

    flops: float
    hbm_bytes: float

    def bound_ms(self, peak: Peak) -> float:
        """Roofline bound (ms): max of bandwidth and compute limits."""
        t_bw = self.hbm_bytes / (peak.hbm_gbps * 1e9)
        t_fl = self.flops / (peak.f32_gflops * 1e9)
        return max(t_bw, t_fl) * 1e3

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops,
                    self.hbm_bytes + other.hbm_bytes)


def decompose_cost(shape: Tuple[int, ...], level: int,
                   sf: ScalingFunction, itemsize: int = 4) -> Cost:
    """Ideal cost of an ``level``-scale decomposition: read the image
    once, write level+1 planes, with 2·k taps of FMA per element per
    scale (separable passes)."""
    n = float(np.prod(shape))
    k = len(sf.taps)
    flops = n * level * 2 * (2 * k)  # two 1-D passes, mul+add per tap
    bytes_ = n * itemsize * (1 + (level + 1))
    return Cost(flops, bytes_)


def wow_cost(shape: Tuple[int, ...], n_scales: int, sf: ScalingFunction,
             denoise: bool = False, itemsize: int = 4) -> Cost:
    """Ideal cost of standard WOW: decomposition + per-scale local power
    smoothing + elementwise whitening + synthesis."""
    n = float(np.prod(shape))
    k = len(sf.taps)
    c = decompose_cost(shape, n_scales, sf, itemsize)
    # local power smooth per detail scale + elementwise ops
    flops = c.flops + n * n_scales * (2 * (2 * k) + 8)
    # planes are re-read and re-written once by the whiten stage +
    # recon written
    bytes_ = c.hbm_bytes + n * itemsize * (2 * (n_scales + 1) + 1)
    if denoise:
        flops += n * 10  # median passes + significance
        bytes_ += n * itemsize * 10
    return Cost(flops, bytes_)


class StageTimer:
    """Collects per-stage wall times; each stage ends when its output
    (``box["out"]``, any pytree of arrays) is ready on the device.

    >>> t = StageTimer()
    >>> with t.stage("decompose") as box:
    ...     box["out"] = decompose(x, 6, B3SPLINE)
    >>> t.report()
    """

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            jax.block_until_ready(box.get("out"))
            self.times.setdefault(name, []).append(
                time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.times.items():
            best = min(ts) * 1e3
            lines.append(f"{name:30s} {best:9.3f} ms (best of {len(ts)})")
        return "\n".join(lines)


def roofline(fn: Callable, args: tuple, cost: Cost, iters: int = 10,
             peak: Optional[Peak] = None) -> Dict[str, float]:
    """Measure ``fn(*args)`` steady-state (mean of ``iters`` calls, each
    ended with ``block_until_ready``) and compare to the roofline bound
    for ``cost`` on ``peak`` (default: the running device's)."""
    if peak is None:
        peak = peak_for()
    jax.block_until_ready(fn(*args))  # compile + warm up
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    bound = cost.bound_ms(peak) / 1e3
    return {
        "measured_ms": dt * 1e3,
        "bound_ms": bound * 1e3,
        "roofline_fraction": bound / dt if dt > 0 else 0.0,
        "achieved_gbps": cost.hbm_bytes / dt / 1e9,
        "achieved_gflops": cost.flops / dt / 1e9,
    }


def count_collectives(fn: Callable, *args) -> Dict[str, int]:
    """Count communication ops in the compiled (post-SPMD-partitioner)
    HLO of ``jax.jit(fn)(*args)``.

    Validates the scaling model's per-config collective counts
    (DESIGN.md "Multi-chip scaling model") at trace level: a
    virtual-mesh dry run asserts the compiled program contains exactly
    the halos/reductions the model prices — no hidden resharding.
    Counts ``-start`` forms once (async pairs are one collective)."""
    import re

    txt = jax.jit(fn).lower(*args).compile().as_text()
    counts: Dict[str, int] = {}
    for op in ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all"):
        n = len(re.findall(rf"\b{op}(?:-start)?\(", txt))
        done = len(re.findall(rf"\b{op}-done\(", txt))
        counts[op] = n - done if n > done else n
    return counts
