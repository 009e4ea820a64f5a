"""Batched ray-march: integrate photon bundles until they escape.

Data-parallel re-design of the reference's per-ray escape loop
(/root/reference/src/systems.rs:115-139): instead of one sequential Rust loop
per photon, the whole ray bundle advances in lock-step under `jit`, with
per-ray termination masks.  Backends of the 4-state march:

  - ``while``  : `lax.while_loop` with global early exit — the forward-only
                 path via XLA fusion.
  - ``scan``   : fixed-length `lax.scan` in two checkpointed levels —
                 reverse-mode differentiable (gradients w.r.t. metric
                 parameters, camera pose, ray directions).
The production march is the planar reduction, whose kernels live in
:mod:`curvis_tpu.ops.march_pallas` (chosen by :mod:`curvis_tpu.dispatch`).

Escape semantics match the reference exactly: after each step, a ray with
l > escape_radius freezes with sign +1, l < -escape_radius with sign -1
(systems.rs:126-135); rays that never cross within ``max_steps`` end with
sign 0 ("not escaped", rendered black).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.physics import geodesic
from curvis_tpu.physics.geodesic import L

_STEPPERS = {
    "euler": geodesic.euler_step,   # reference-parity (metrics.rs:283-297)
    "rk4": geodesic.rk4_step,
}


class MarchResult(NamedTuple):
    x: jax.Array        # (..., 4) final contravariant position
    p: jax.Array        # (..., 4) final covariant momentum
    sign: jax.Array     # (...,) int32: +1 positive space, -1 negative, 0 not escaped
    steps: jax.Array    # (...,) int32: integration steps taken while active


def _masked_step(metric, x, p, sign, steps, dt, stepper, escape_radius,
                 max_steps=None):
    """Advance active rays one step, then update escape signs.

    ``max_steps`` (when given) caps per-ray stepping so fixed-length scan
    backends that overshoot the cap stay sign-identical to the early-exit
    while backend (see tests/test_planar.py::test_backends_agree_at_step_cap).
    """
    active = sign == 0
    if max_steps is not None:
        active = active & (steps < max_steps)
    x1, p1 = stepper(metric, x, p, dt)
    am = active[..., None]
    x = jnp.where(am, x1, x)
    p = jnp.where(am, p1, p)
    l = x[..., L]
    sign = jnp.where(active & (l > escape_radius), 1,
                     jnp.where(active & (l < -escape_radius), -1, sign))
    steps = steps + active.astype(jnp.int32)
    return x, p, sign, steps


def march_while(metric, x0, p0, *, dt, max_steps, escape_radius,
                stepper="euler") -> MarchResult:
    """Forward-only march with global early exit (all rays escaped)."""
    step_fn = _STEPPERS[stepper]
    dt = jnp.asarray(dt, dtype=x0.dtype)
    sign0 = jnp.zeros(x0.shape[:-1], dtype=jnp.int32)
    steps0 = jnp.zeros(x0.shape[:-1], dtype=jnp.int32)

    def cond(carry):
        _, _, sign, _, it = carry
        return (it < max_steps) & jnp.any(sign == 0)

    def body(carry):
        x, p, sign, steps, it = carry
        x, p, sign, steps = _masked_step(
            metric, x, p, sign, steps, dt, step_fn, escape_radius)
        return x, p, sign, steps, it + 1

    x, p, sign, steps, _ = lax.while_loop(
        cond, body, (x0, p0, sign0, steps0, jnp.int32(0)))
    return MarchResult(x, p, sign, steps)


def march_scan(metric, x0, p0, *, dt, max_steps, escape_radius,
               stepper="euler", segment=None) -> MarchResult:
    """Differentiable march: two-level checkpointed scan.

    The outer scan runs ``ceil(max_steps / segment)`` rematerialized segments;
    backward-pass memory is O(n_segments * state + segment-replay), i.e.
    O(sqrt(max_steps)) with the default segment size.  This is the
    checkpointed-recurrence strategy from SURVEY.md section 7 ("Hard parts").
    """
    step_fn = _STEPPERS[stepper]
    dt = jnp.asarray(dt, dtype=x0.dtype)
    if segment is None:
        segment = max(1, int(math.sqrt(max_steps)))
    n_seg = -(-max_steps // segment)

    sign0 = jnp.zeros(x0.shape[:-1], dtype=jnp.int32)
    steps0 = jnp.zeros(x0.shape[:-1], dtype=jnp.int32)

    def one_step(carry, _):
        x, p, sign, steps = carry
        x, p, sign, steps = _masked_step(
            metric, x, p, sign, steps, dt, step_fn, escape_radius,
            max_steps=max_steps)
        return (x, p, sign, steps), None

    @jax.checkpoint
    def one_segment(carry, _):
        carry, _ = lax.scan(one_step, carry, None, length=segment)
        return carry, None

    (x, p, sign, steps), _ = lax.scan(
        one_segment, (x0, p0, sign0, steps0), None, length=n_seg)
    # steps is capped per-ray inside _masked_step, so segment overshoot never
    # advances a ray past max_steps and sign agrees with the while backend.
    return MarchResult(x, p, sign, steps)


def march(metric, x0, p0, *, dt, max_steps, escape_radius, stepper="euler",
          backend="auto", differentiable=False) -> MarchResult:
    """Dispatching entry point of the 4-state march: the while-loop, or the
    checkpointed scan for ``differentiable=True`` / ``backend='scan'``.
    (The 4-state march has no kernel; kernels run the planar reduction,
    render/direct.py ``method='planar'``.)
    """
    if differentiable or backend == "scan":
        return march_scan(metric, x0, p0, dt=dt, max_steps=max_steps,
                          escape_radius=escape_radius, stepper=stepper)
    return march_while(metric, x0, p0, dt=dt, max_steps=max_steps,
                       escape_radius=escape_radius, stepper=stepper)


def compute_trajectory(metric, x0, p0, *, dt, n_steps, stepper="euler"):
    """Record a photon's full path — the science/debug API mirroring
    `compute_photon_trajectory` (systems.rs:77-92).  Returns (xs, ps) with a
    leading step axis of length ``n_steps`` (state *before* each step, like
    the reference which pushes then updates)."""
    step_fn = _STEPPERS[stepper]
    dt = jnp.asarray(dt, dtype=x0.dtype)

    def body(carry, _):
        x, p = carry
        out = (x, p)
        x, p = step_fn(metric, x, p, dt)
        return (x, p), out

    _, (xs, ps) = lax.scan(body, (x0, p0), None, length=n_steps)
    return xs, ps
