"""The device a measurement ran on, and the refusal to measure anything else.

Every benchmark and smoke run prints the card's name and power limit (a
card set below its maximum runs slower under load) beside JAX's own view
of the device, and stops when JAX finds no GPU: a CPU run is never
reported as a device number.
"""
from __future__ import annotations

import os
import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """JAX's device header; raises SystemExit unless the platform is gpu."""
    import jax
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found platform {d.platform!r} "
                         f"({d.device_kind}); refusing to measure it")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def header_lines(cache_dir: str) -> list[str]:
    """The lines a run prints before its results."""
    import jax
    return [nvidia_smi_line(),
            f"jax {jax.__version__}",
            f"devices {require_gpu()}",
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
            f"compile cache {cache_dir}"]
