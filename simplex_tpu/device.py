"""The accelerator a measurement runs on.

Every measurement path (``bench.py``, ``chip_smoke.py``, the tools)
names the device it ran on and refuses to run without a GPU: a number
taken on JAX's CPU backend is never reported as a device number.
"""

from __future__ import annotations

import subprocess

import jax


class NoGPUError(RuntimeError):
    """JAX found no GPU; the message names the platform it did find."""


def require_gpu() -> dict:
    """The JAX device record of a GPU run, as
    ``{"platform", "kind", "count"}`` — or NoGPUError naming the
    platform JAX found instead."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX found platform {platform!r} "
            f"({len(devices)} device(s), {devices[0].device_kind})")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each). A card may be set
    below its maximum power and then runs slower under load, so every
    number kept names both."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
