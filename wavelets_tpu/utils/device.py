"""The device a measurement ran on.

Every timing this package prints names the device it came from, and a
measurement that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["require_gpu", "gpu_name_and_power_limit", "device_tag"]


def require_gpu() -> jax.Device:
    """The first JAX device; raises ``RuntimeError`` unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind!r}); refusing to measure on it")
    return dev


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of every card as ``nvidia-smi`` reports
    them, one line per card.  Runs ``nvidia-smi`` as a child process, so
    it never touches JAX's hold on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_tag() -> dict:
    """Platform, kind and count of the JAX devices plus the cards' power
    limit — the label every printed measurement carries."""
    dev = require_gpu()
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": gpu_name_and_power_limit().splitlines()[0],
    }
