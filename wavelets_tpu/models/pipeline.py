"""Streaming serving pipeline: disk → device → WOW → disk.

The production path the reference lacks entirely: frame stacks stream
through the native IO layer (utils/frameio.py, C++ mmap + threaded
conversion), batches are processed by the jitted WOW engine, and
results stream back out.  Host IO for batch k+1 overlaps device compute
for batch k through JAX's async dispatch: the next batch is read and
enqueued before the previous result is fetched."""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.frameio import FrameStack, write_array

__all__ = ["process_stack"]


def process_stack(
    input_path: str,
    output_path: str,
    n_frames: int,
    shape: Tuple[int, int],
    dtype="uint16",
    offset: int = 0,
    batch: int = 4,
    progress: bool = False,
    mesh=None,
    **wow_kwargs,
):
    """Run WOW over every frame of a stored stack.

    ``input_path``: raw frame stack (see :class:`FrameStack`);
    ``output_path``: float32 raw output, same frame order;
    ``batch``: frames per device dispatch (``wow_stack``).
    Remaining keyword arguments go to :func:`wavelets_tpu.wow_stack`.
    Returns (n_frames, seconds, frames/s).

    ``mesh``: optional ``jax.sharding.Mesh`` from
    :func:`wavelets_tpu.parallel.make_mesh` — batches then run through
    :func:`wavelets_tpu.parallel.sharded.sharded_wow` (frames shard
    over the ``data`` axis, each frame tiles over ``rows × cols`` with
    halo exchange); ``batch`` should be a multiple of the mesh's data
    extent.  Single-host multi-chip serving out of the box; multi-host
    after ``init_distributed``.
    """
    from .wow import wow_stack

    if mesh is not None:
        from ..api import _spec_of
        from ..parallel.sharded import sharded_wow

        sf_cls = wow_kwargs.pop("scaling_function", None)
        if sf_cls is not None:
            wow_kwargs["sf"] = _spec_of(sf_cls)

        def run_batch(dev):
            recon, _ = sharded_wow(dev, mesh, with_coefficients=False,
                                   **wow_kwargs)
            return recon
    else:
        def run_batch(dev):
            recon, _ = wow_stack(dev, with_coefficients=False,
                                 **wow_kwargs)
            return recon

    t0 = time.perf_counter()
    out_f = open(output_path, "wb")
    pending = None  # (device_result, n_valid)
    try:
        with FrameStack(input_path, n_frames, shape, dtype=dtype,
                        offset=offset) as fs:
            starts = list(range(0, n_frames, batch))
            for b0 in starts:
                idx = list(range(b0, min(b0 + batch, n_frames)))
                host = fs.read_batch(idx)
                if len(idx) < batch:
                    # static shapes: pad the tail batch
                    pad = np.repeat(host[-1:], batch - len(idx), axis=0)
                    host = np.concatenate([host, pad], axis=0)
                dev = jnp.asarray(host)
                # coefficients are never kept here: skip their device
                # memory writes entirely (with_coefficients=False)
                recon = run_batch(dev)
                if pending is not None:
                    prev, n_valid = pending
                    np.asarray(prev[:n_valid]).tofile(out_f)
                pending = (recon, len(idx))
                if progress:
                    print(f"dispatched frames {idx[0]}..{idx[-1]}",
                          flush=True)
            if pending is not None:
                prev, n_valid = pending
                np.asarray(prev[:n_valid]).tofile(out_f)
    finally:
        out_f.close()
    dt = time.perf_counter() - t0
    return n_frames, dt, n_frames / dt
