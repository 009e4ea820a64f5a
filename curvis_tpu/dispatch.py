"""Where each march runs: the one place that chooses from the platform.

    gpu, float32  -> the Pallas kernel compiled for the card (Triton route)
    cpu           -> the XLA path; a path that only a kernel implements runs
                     that kernel in Pallas interpret mode
    float64       -> the XLA path on whatever device is present

Every ``backend='auto'`` in the renderers and adjoints asks :func:`choose`,
and the kernel launcher (ops/launch.py) asks it whether to interpret.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

KERNEL = "kernel"
INTERPRET = "interpret"
XLA = "xla"


def platform() -> str:
    """JAX's default platform ('gpu' or 'cpu')."""
    return jax.default_backend()


def choose(dtype=jnp.float32, *, kernel_only: bool = False) -> str:
    """'kernel', 'interpret' or 'xla' for a march of ``dtype`` rays.

    ``kernel_only``: the path has no XLA twin (the Kerr RK45 disk, volume and
    scatter variants, and the kernel launcher itself), so the kernel runs in
    any precision on the card and in interpret mode on the CPU."""
    on = platform()
    if on == "cpu":
        return INTERPRET if kernel_only else XLA
    if on == "gpu" and (kernel_only or jnp.dtype(dtype) == jnp.float32):
        return KERNEL
    if kernel_only:
        raise NotImplementedError(f"no ray-march kernel for platform {on!r}")
    return XLA


def use_kernel(dtype=jnp.float32) -> bool:
    """True where ``backend='auto'`` takes the GPU kernel."""
    return choose(dtype) == KERNEL
