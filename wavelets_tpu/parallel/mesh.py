"""Device mesh construction for the sharded wavelet engine.

The reference has no parallelism of any kind (SURVEY §2.3); this engine
shards a batch ("data") axis plus a 2-D spatial tiling ("rows" × "cols")
over the devices.  The mesh shape follows the algorithm alone: the cards
of one host are joined all to all (NVLink), so no axis order is closer
than another.  Multi-host setups go through ``jax.distributed.initialize``
+ the same mesh API."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
ROW_AXIS = "rows"
COL_AXIS = "cols"

__all__ = ["make_mesh", "init_distributed", "DATA_AXIS", "ROW_AXIS",
           "COL_AXIS"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the multi-host process group before building a mesh
    that spans hosts.  Thin wrapper over ``jax.distributed.initialize``
    so the framework has one entry point.  Where no cluster environment
    describes the job, pass all three arguments."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(
    data: int = 1,
    rows: int = 1,
    cols: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, rows, cols)`` mesh over the available devices,
    taken in ``jax.devices()`` order."""
    if devices is None:
        devices = jax.devices()
    n = data * rows * cols
    if len(devices) < n:
        raise ValueError(
            f"mesh {data}x{rows}x{cols} needs {n} devices, "
            f"have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(data, rows, cols)
    return Mesh(dev, (DATA_AXIS, ROW_AXIS, COL_AXIS))
