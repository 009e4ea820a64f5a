"""Bounded-memory gradients through the planar ray march: custom VJP whose
backward is checkpointed recompute (integrate/ckpt.py).

The plain checkpointed-scan backend (physics/planar.march_planar_scan) is
exact but its *forward* already runs at XLA scan speed: every loss
evaluation pays max_steps trips with the carry streamed through HBM.  This
module keeps the production forward — the Pallas Euler kernel on the GPU
(ops/march_pallas.march_planar_pallas, sprint phase, early block exit),
the masked while-loop elsewhere — and pays the scan-like cost only in the
backward pass, which re-marches the trajectory from the spawn state in
segments and pulls the cotangent through each segment with ``jax.vjp`` of
the masked segment map (exact discrete gradients; see integrate/ckpt.py for
why this beats reverse-time replay).  The backward is XLA on every
platform.

Per-ray escape freezing is respected: on backward step j, only rays whose
forward march was still active at step j (j < steps_i) participate; frozen
rays carry their adjoint unchanged — matching the forward masking exactly.
Captured rays (sign 2, Schwarzschild/RN) are excluded: capture is a
discrete event, and their frozen states sit where the step math can
overflow (the masked recompute still evaluates it); the renderers mask
them to black, so their pixel gradients flow through that select's other
branch.

Gradients flow to the metric parameter pytree, the spawn state and ``b``.

Reference context: the Rust implementation is not differentiable at all;
SURVEY.md section 7 lists the "backward pass through a 40k-step recurrence"
as a hard part, solved here with O(max_steps/segment) checkpoints instead
of trajectory storage.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu.physics.planar import (PlanarRays, PlanarResult, planar_rhs)

def _step(metric, y, b, dt):
    """One forward-Euler planar step of y = (l, psi, p_l)."""
    l, psi, p_l = y
    dl, dpsi, dpl = planar_rhs(metric, l, psi, p_l, b)
    return (l + dt * dl, psi + dt * dpsi, p_l + dt * dpl)


def _step_theta(dt, theta, y):
    """integrate/ckpt.py step contract: theta = (metric, b)."""
    metric, b = theta
    return _step(metric, y, b, dt)


class _ParamRow:
    """Duck-typed scalar row whose metric-parameter slots hold per-lane
    ARRAYS — lets ops/march_pallas._deriv_fns compute per-ray derivatives
    for jax.vjp without duplicating the metric algebra."""

    def __init__(self, slots):
        self._v = slots

    def __getitem__(self, key):
        return self._v[key[1]]


def _forward(metric, state, b, dt, max_steps, escape_radius):
    from curvis_tpu.physics.planar import _capture_radius
    r_cap = _capture_radius(metric)
    l, psi, p_l = state
    sign0 = jnp.zeros_like(l, dtype=jnp.int32)
    steps0 = jnp.zeros_like(l, dtype=jnp.int32)

    def cond(c):
        _, sign, _, it = c
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        y, sign, steps, it = c
        active = sign == 0
        y1 = _step(metric, y, b, dt)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        ln = y[0]
        sign = jnp.where(active & (ln > escape_radius), 1,
                         jnp.where(active & (ln < -escape_radius), -1, sign))
        if r_cap is not None:
            sign = jnp.where(active & (ln < r_cap), 2, sign)
        steps = steps + active.astype(jnp.int32)
        return y, sign, steps, it + 1

    (l, psi, p_l), sign, steps, _ = lax.while_loop(
        cond, body, ((l, psi, p_l), sign0, steps0, jnp.int32(0)))
    return (l, psi, p_l, sign, steps)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def _march_core(max_steps, escape_radius, backend, segment, metric, state,
                b, dt):
    out, _ = _march_fwd(max_steps, escape_radius, backend, segment,
                        metric, state, b, dt)
    return out


def _march_fwd(max_steps, escape_radius, backend, segment, metric, state,
               b, dt):
    if backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_planar_pallas
        l, psi, p_l = state
        rays = PlanarRays(l=l, psi=psi, p_l=p_l, b=b,
                          r_hat=jnp.zeros((1, 3), l.dtype),
                          e2=jnp.zeros((1, 3), l.dtype))
        res = march_planar_pallas(metric, rays, dt=dt, max_steps=max_steps,
                                  escape_radius=escape_radius)
        out = (res.l, res.psi, res.p_l, res.sign, res.steps)
    else:
        out = _forward(metric, state, b, dt, max_steps, escape_radius)
    return out, (metric, state, b, dt, out[3], out[4])


def _march_bwd(max_steps, escape_radius, backend, segment, res, cot):
    metric, state0, b, dt, sign, steps = res
    cot3 = cot[:3]

    smooth = sign != 2                       # captured rays excluded
    cot3 = tuple(jnp.where(smooth, c, 0.0) for c in cot3)
    steps_eff = jnp.where(smooth, steps, 0)

    step_fn = partial(_step_theta, dt)
    (g_metric, g_b), lam = ckpt_adjoint_backward(
        step_fn, (metric, b), tuple(state0), steps_eff, cot3,
        max_steps=max_steps, segment=segment)

    return g_metric, lam, g_b, jnp.zeros_like(dt)


def _table_metric_grads(metric, g_sums):
    """Slot cotangents -> TabulatedMetric pytree cotangent: g_sums =
    [g_s2, g_c1..., g_c2...] (lane-summed); s^2 chain-rules to s."""
    import dataclasses
    n1 = metric.c1.shape[0]
    g_s2 = g_sums[0]
    gc = g_sums[1:]
    return dataclasses.replace(
        jax.tree_util.tree_map(jnp.zeros_like, metric),
        c1=jnp.stack(gc[:n1]).astype(metric.c1.dtype),
        c2=jnp.stack(gc[n1:]).astype(metric.c2.dtype),
        s=jnp.asarray(2.0 * metric.s * g_s2, jnp.result_type(metric.s)))


def _planar_metric_grads(metric, g012):
    """Map the scalar-row param-slot cotangents (slots 2-4 of the row built by
    ops/march_pallas._metric_kind_and_params) back onto the metric pytree's
    fields."""
    import dataclasses
    from curvis_tpu.metrics.base import (EllisMetric, FlatSphericalMetric,
                                         InterstellarMetric,
                                         ReissnerNordstromMetric,
                                         SchwarzschildMetric)
    g0, g1, g2 = g012
    zero_m = jax.tree_util.tree_map(jnp.zeros_like, metric)
    cast = lambda g, ref: jnp.asarray(g, jnp.result_type(ref))  # noqa: E731
    if isinstance(metric, EllisMetric):
        return dataclasses.replace(zero_m, rho=cast(g0, metric.rho))
    if isinstance(metric, InterstellarMetric):
        return dataclasses.replace(zero_m, m=cast(g0, metric.m),
                                   a=cast(g1, metric.a),
                                   rho=cast(g2, metric.rho))
    if isinstance(metric, FlatSphericalMetric):
        return zero_m
    if isinstance(metric, SchwarzschildMetric):
        return dataclasses.replace(zero_m, m=cast(g0, metric.m))
    if isinstance(metric, ReissnerNordstromMetric):
        # slot 1 carries q^2 (see _metric_kind_and_params): chain rule
        return dataclasses.replace(zero_m, m=cast(g0, metric.m),
                                   q=cast(2.0 * metric.q * g1, metric.q))
    raise NotImplementedError(
        f"planar adjoint: unsupported metric {type(metric).__name__}")


_march_core.defvjp(_march_fwd, _march_bwd)


def march_planar_adjoint(metric, state, b, dt, max_steps, escape_radius,
                         backend="xla", segment=None):
    """Differentiable planar march with the checkpointed-recompute backward.

    ``state``: (l, psi, p_l) arrays; returns (l, psi, p_l, sign, steps).
    Gradients flow to ``metric`` (parameter pytree), ``state`` and ``b``.
    ``backend='pallas'`` marches the forward with the Pallas kernel, 'xla'
    (default) with the while-loop; the backward is the XLA checkpointed
    recompute either way.  ``segment`` is the backward recompute length
    (default ~sqrt(max_steps))."""
    if segment is None:
        segment = max(1, int(max_steps ** 0.5))
    return _march_core(max_steps, escape_radius, backend, int(segment),
                       metric, state, b, dt)


def march_planar_adjoint_rays(metric, rays: PlanarRays, *, dt, max_steps,
                              escape_radius, backend="auto",
                              segment=None) -> PlanarResult:
    """PlanarRays-facing wrapper with the standard result contract.
    ``backend='auto'`` marches the forward with the kernel where the
    dispatch rule picks it (curvis_tpu/dispatch.py)."""
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(rays.l.dtype) else "xla"
    l, psi, p_l, sign, steps = march_planar_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b,
        jnp.asarray(dt, rays.l.dtype), max_steps, escape_radius,
        backend=backend, segment=segment)
    return PlanarResult(l, psi, p_l, sign, steps)
