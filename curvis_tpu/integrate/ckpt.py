"""Generic checkpointed-recompute adjoint for masked lock-step marches.

Every marcher in this framework is the same discrete map: a per-ray state
``y`` advanced by a smooth step function while a per-ray step count says the
ray is still active, then frozen.  Its exact reverse-mode gradient therefore
has one canonical form — recompute the trajectory forward from the spawn
state in segments, checkpoint the segment starts, and pull the cotangent
backward segment by segment with ``jax.vjp`` of the (masked) segment map.
Unlike reverse-time replay (fixed-point inversion of the step), this is

  * **exact**: the recomputed trajectory is the forward trajectory (same
    ops), so the adjoint is the true discrete gradient — no Lyapunov
    amplification, no drift guard, valid even for strongly-lensed rays where
    the step's local Lipschitz constant makes the inverse iteration diverge;
  * **cheap**: one extra forward sweep + the VJP (~4x a forward step),
    versus reverse-RK4 + polish + VJP (~6x) for replay;
  * **bounded-memory**: O(max_steps / segment) checkpoints + O(segment)
    rematerialized states, never O(max_steps).

This module is the backward of every adjoint front door (integrate/
adjoint.py, kerr_adjoint.py, rk45_adjoint*.py, *_surface_adjoint.py), on
every platform.

Contract:

  ``step_fn(theta, y) -> y`` — one unmasked step; ``y`` is a tuple of
  per-ray arrays, ``theta`` any differentiable pytree (metric parameters,
  conserved quantities, impact parameters).  Masking — the ray ``i`` is
  advanced only while ``j < steps[i]`` — is applied OUTSIDE ``step_fn`` by
  this module, exactly as the forward marchers do, so frozen rays are
  bit-frozen and contribute nothing to ``theta``'s cotangent.

NaN-safety invariant (callers must uphold): ``step_fn`` is *evaluated* (then
discarded by the mask) on frozen states every step, so every frozen state
must be one where the step math is finite — exclude blown-up / captured rays
by zeroing their cotangents AND their ``steps`` and substituting a benign
state (the spawn state) before calling.

Reference context: the Rust reference (/root/reference) has no gradients at
all; its fixed recurrence (src/metrics.rs:283-297) is what ``step_fn``
generalizes.  SURVEY.md section 7 lists "backward through a 40k-step
recurrence" as a hard part — solved here with sqrt-style checkpointing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def march_masked(step_fn, theta, y0, steps, *, max_steps, segment):
    """Forward recompute of the masked march: ``y0`` advanced ``steps[i]``
    times per ray (two-level scan, ``jax.checkpoint`` on the segment).
    Differentiable in ``theta`` and ``y0``; ``steps`` is data."""
    n_seg = -(-max_steps // segment)

    def one(c, j):
        y = c
        y1 = step_fn(theta, y)
        act = j < steps
        return tuple(jnp.where(act, a1, a0) for a0, a1 in zip(y, y1)), None

    @jax.checkpoint
    def seg(c, s):
        js = s * segment + jnp.arange(segment)
        c, _ = lax.scan(one, c, js)
        return c, None

    y, _ = lax.scan(seg, tuple(y0), jnp.arange(n_seg))
    return y


def ckpt_adjoint_backward(step_fn, theta, y0, steps, cot, *, max_steps,
                          segment):
    """Exact reverse-mode pullback of :func:`march_masked` at ``(theta,
    y0)``: returns ``(d_theta, d_y0)`` for the output cotangent ``cot``
    (tuple matching ``y``).  This is the XLA backend for the custom-VJP
    marchers in integrate/adjoint.py and integrate/kerr_adjoint.py."""
    def march(th, y):
        return march_masked(step_fn, th, y, steps, max_steps=max_steps,
                            segment=segment)

    _, pull = jax.vjp(march, theta, tuple(y0))
    return pull(tuple(cot))
