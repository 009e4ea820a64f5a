"""Reduced planar geodesic system — the hot-loop formulation.

In a spherically symmetric spacetime every null geodesic stays in the plane
through the origin spanned by its initial position and direction.  The
reference exploits this once, globally, to collapse the image to a 1-D
function of the launch angle (systems.rs:345-384).  This design applies it
*per ray*: each photon is integrated in its own plane with the
2-D state

    state  = (l, psi, p_l)        psi: in-plane angle from the launch radius
    const  = b = p_psi            (conserved angular momentum)

    dl/dlam   = p_l
    dpsi/dlam = b / r(l)^2
    dp_l/dlam = b^2 r'(l) / r(l)^3

which is exactly the reference's equatorial-plane system (theta = pi/2,
p_theta = 0 in metrics.rs:223-270) — an explicit Euler step here is
bit-equivalent to the reference stepper, while costing ~8 flops with **no
trigonometry** in the inner loop (vs sin/cos/pow of the general 3-D RHS).
The 3-D escape direction is reconstructed afterwards by a single Rodrigues
rotation of the camera's radial direction about the ray's plane normal.

This is the formulation the Pallas kernels march in registers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.geometry.rotations import (_any_perpendicular, normalize,
                                           vector3_from_theta_phi)
from curvis_tpu.metrics.base import Metric


class PlanarRays(NamedTuple):
    """A bundle of rays, each reduced to its own orbital plane."""
    l: jax.Array        # (...,) radial coordinate
    psi: jax.Array      # (...,) in-plane angle from the launch radius
    p_l: jax.Array      # (...,) radial covariant momentum
    b: jax.Array        # (...,) conserved angular momentum (p_psi)
    r_hat: jax.Array    # (..., 3) world launch radial direction (e1 basis)
    e2: jax.Array       # (..., 3) in-plane transverse basis, e2 = n x e1


class PlanarResult(NamedTuple):
    l: jax.Array
    psi: jax.Array
    p_l: jax.Array
    sign: jax.Array     # int32 +1/-1/0
    steps: jax.Array    # int32


def _unit_lapse(metric) -> bool:
    """True for the reference's metric family (g00 = -1, g11 = 1;
    metrics.rs:49-57). General static metrics (e.g. Schwarzschild) define
    ``unit_lapse = False`` plus lapse/lapse_deriv/radial_B methods."""
    return getattr(metric, "unit_lapse", True)


def _capture_radius(metric):
    """Coordinate radius below which a photon is irreversibly captured
    (black-hole shadows); None for metrics without capture."""
    return getattr(metric, "capture_radius", None)


CAPTURED = 2      # PlanarResult.sign value for captured (shadow) rays


def spawn_planar(metric: Metric, camera_position, directions_world) -> PlanarRays:
    """Decompose world ray directions into per-ray orbital planes.

    ``camera_position``: (4,) contravariant (t, l, theta, phi).
    ``directions_world``: (..., 3) unit world directions.

    alpha = angle(d, r_hat) in [0, pi]; the in-plane momentum components are
    p_l = cos(alpha), b = sin(alpha) * r(l0) — the planar specialization of
    new_photon (metrics.rs:322-333).  Radial rays (d parallel to r_hat) get an
    arbitrary plane, which is exact: they stay radial (b = 0).
    """
    l0 = camera_position[..., 1]
    r_hat = vector3_from_theta_phi(camera_position[..., 2], camera_position[..., 3])
    r_hat = jnp.broadcast_to(r_hat, directions_world.shape)
    d = normalize(directions_world)
    cos_a = jnp.clip(jnp.sum(d * r_hat, axis=-1), -1.0, 1.0)
    n = jnp.cross(r_hat, d)                       # |n| = sin(alpha)
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    # Degenerate (radial) rays: any perpendicular plane works since b = 0.
    # gate on the computed cross norm, not sin_a (see render/fast.py: FMA
    # rounding can make them disagree at d ~ -r_hat -> 0/0 NaN)
    n2 = jnp.sum(n * n, axis=-1)
    n_safe = jnp.where((n2 < 1e-12)[..., None], _any_perpendicular(r_hat), n)
    n_hat = normalize(n_safe)
    e2 = jnp.cross(n_hat, r_hat)
    r0 = metric.r(l0)
    shape = d.shape[:-1]
    p_l = cos_a
    b = sin_a * r0
    if not _unit_lapse(metric):
        # Static-observer tetrad spawn with the E = p_t = 1 affine
        # normalization: p_l = d_l sqrt(B/A), b = d_psi r / sqrt(A).
        A0 = metric.lapse(l0)
        B0 = metric.radial_B(l0)
        p_l = cos_a * jnp.sqrt(B0 / A0)
        b = b / jnp.sqrt(A0)
    return PlanarRays(
        l=jnp.broadcast_to(l0, shape),
        psi=jnp.zeros(shape, dtype=d.dtype),
        p_l=p_l,
        b=b,
        r_hat=r_hat,
        e2=e2,
    )


def planar_rhs(metric: Metric, l, psi, p_l, b):
    r2 = metric.r_squared(l)
    r = metric.r(l)
    if _unit_lapse(metric):
        dl = p_l
        dpsi = b / r2
        dp_l = (b * b) * metric.r_derivative(l) / (r2 * r)
        return dl, dpsi, dp_l
    # General static spherically symmetric metric with B = 1/A
    #   ds^2 = -A dt^2 + dl^2/A + r^2 dOmega^2,  E = p_t = 1:
    #   H = (-1/A + A p_l^2 + b^2/r^2)/2 = 0
    #   dl     =  dH/dp_l = A p_l
    #   dp_l   = -dH/dl   = -A'/2 (1/A^2 + p_l^2) + b^2 r'/r^3
    A = metric.lapse(l)
    Ap = metric.lapse_deriv(l)
    dl = A * p_l
    dpsi = b / r2
    dp_l = (-0.5 * Ap * (1.0 / (A * A) + p_l * p_l)
            + (b * b) * metric.r_derivative(l) / (r2 * r))
    return dl, dpsi, dp_l


def planar_euler_step(metric: Metric, l, psi, p_l, b, dt):
    dl, dpsi, dp_l = planar_rhs(metric, l, psi, p_l, b)
    return l + dt * dl, psi + dt * dpsi, p_l + dt * dp_l


def planar_rk4_step(metric: Metric, l, psi, p_l, b, dt):
    k1 = planar_rhs(metric, l, psi, p_l, b)
    k2 = planar_rhs(metric, l + 0.5 * dt * k1[0], psi, p_l + 0.5 * dt * k1[2], b)
    k3 = planar_rhs(metric, l + 0.5 * dt * k2[0], psi, p_l + 0.5 * dt * k2[2], b)
    k4 = planar_rhs(metric, l + dt * k3[0], psi, p_l + dt * k3[2], b)
    l1 = l + (dt / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    psi1 = psi + (dt / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    pl1 = p_l + (dt / 6.0) * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
    return l1, psi1, pl1


_PLANAR_STEPPERS = {"euler": planar_euler_step, "rk4": planar_rk4_step}


def march_planar_while(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                       escape_radius, stepper="euler") -> PlanarResult:
    """Lock-step planar march with global early exit (XLA while_loop)."""
    step = _PLANAR_STEPPERS[stepper]
    dt = jnp.asarray(dt, dtype=rays.l.dtype)
    sign0 = jnp.zeros(rays.l.shape, dtype=jnp.int32)
    steps0 = jnp.zeros(rays.l.shape, dtype=jnp.int32)

    def cond(c):
        _, _, _, sign, _, it = c
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        l, psi, p_l, sign, steps, it = c
        active = sign == 0
        l1, psi1, pl1 = step(metric, l, psi, p_l, rays.b, dt)
        l = jnp.where(active, l1, l)
        psi = jnp.where(active, psi1, psi)
        p_l = jnp.where(active, pl1, p_l)
        sign = jnp.where(active & (l > escape_radius), 1,
                         jnp.where(active & (l < -escape_radius), -1, sign))
        if r_cap is not None:
            sign = jnp.where(active & (l < r_cap), CAPTURED, sign)
        steps = steps + active.astype(jnp.int32)
        return l, psi, p_l, sign, steps, it + 1

    r_cap = _capture_radius(metric)
    l, psi, p_l, sign, steps, _ = lax.while_loop(
        cond, body, (rays.l, rays.psi, rays.p_l, sign0, steps0, jnp.int32(0)))
    return PlanarResult(l, psi, p_l, sign, steps)


def march_planar_scan(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                      escape_radius, stepper="euler", segment=None) -> PlanarResult:
    """Differentiable planar march (two-level checkpointed scan)."""
    import math
    step = _PLANAR_STEPPERS[stepper]
    dt = jnp.asarray(dt, dtype=rays.l.dtype)
    if segment is None:
        segment = max(1, int(math.sqrt(max_steps)))
    n_seg = -(-max_steps // segment)
    sign0 = jnp.zeros(rays.l.shape, dtype=jnp.int32)
    steps0 = jnp.zeros(rays.l.shape, dtype=jnp.int32)

    r_cap = _capture_radius(metric)

    def one(c, _):
        l, psi, p_l, sign, steps = c
        # Mask on steps as well as sign: the scan runs n_seg*segment >=
        # max_steps iterations, and a ray escaping during the overshoot must
        # keep sign 0 exactly like the while backend (which stops at
        # max_steps).  Backend agreement at the cap is pinned by
        # tests/test_planar.py::test_backends_agree_at_step_cap.
        active = (sign == 0) & (steps < max_steps)
        l1, psi1, pl1 = step(metric, l, psi, p_l, rays.b, dt)
        l = jnp.where(active, l1, l)
        psi = jnp.where(active, psi1, psi)
        p_l = jnp.where(active, pl1, p_l)
        sign = jnp.where(active & (l > escape_radius), 1,
                         jnp.where(active & (l < -escape_radius), -1, sign))
        if r_cap is not None:
            sign = jnp.where(active & (l < r_cap), CAPTURED, sign)
        steps = steps + active.astype(jnp.int32)
        return (l, psi, p_l, sign, steps), None

    @jax.checkpoint
    def seg(c, _):
        c, _ = lax.scan(one, c, None, length=segment)
        return c, None

    (l, psi, p_l, sign, steps), _ = lax.scan(
        seg, (rays.l, rays.psi, rays.p_l, sign0, steps0), None, length=n_seg)
    return PlanarResult(l, psi, p_l, sign, steps)


def march_planar_tiled(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                       escape_radius, stepper="euler", tile=16384,
                       sort=True, unroll=8) -> PlanarResult:
    """Cost-coherent tiled march — the fast XLA path on real hardware.

    The global while-loop marches *every* ray until the slowest one escapes
    (up to 40k steps for photon-ring rays), wasting ~10-20x FLOPs on frozen
    lanes.  Here rays are sorted by a cost proxy (outward rays are cheap;
    inward rays get expensive as the impact parameter b approaches the
    critical value), reshaped to (n_tiles, tile), and each tile runs its own
    early-exiting while_loop under ``lax.map`` — all inside a single jit.
    Cost ~= sum over tiles of (tile * max steps in tile), within ~20% of the
    ideal sum of per-ray steps for image workloads.
    """
    step = _PLANAR_STEPPERS[stepper]
    dtype = rays.l.dtype
    dt = jnp.asarray(dt, dtype=dtype)
    n = rays.l.reshape(-1).shape[0]
    n_pad = -(-n // tile) * tile

    def pad(a):
        a = a.reshape(-1)
        return jnp.concatenate([a, jnp.full((n_pad - n,), a[0], a.dtype)])

    l, psi, p_l, b = (pad(rays.l), pad(rays.psi), pad(rays.p_l), pad(rays.b))
    if sort:
        # Outward rays (p_l >= 0) escape in ~(R - l0)/dt steps regardless of b;
        # inward cost rises sharply near the critical b, so contiguity in
        # (inwardness, b) gives cost-coherent tiles.
        key = jnp.where(p_l < 0, 100.0 + b, b)
        order = jnp.argsort(key)
        inv = jnp.argsort(order)
        l, psi, p_l, b = (a[order] for a in (l, psi, p_l, b))

    shape2 = (n_pad // tile, tile)
    l, psi, p_l, b = (a.reshape(shape2) for a in (l, psi, p_l, b))

    r_cap = _capture_radius(metric)

    def tile_fn(args):
        l, psi, p_l, b = args
        sign0 = jnp.zeros_like(l, dtype=jnp.int32)
        steps0 = jnp.zeros_like(l, dtype=jnp.int32)

        def cond(c):
            _, _, _, sign, _, it = c
            return (it < max_steps) & jnp.any(sign == 0)

        def body(c):
            l, psi, p_l, sign, steps, it = c
            # ``unroll`` masked steps per loop iteration amortize the
            # while-loop per-iteration overhead (the dominant cost at small
            # tile sizes) without changing semantics: each sub-step masks on
            # the up-to-date per-ray escape state.
            for _ in range(unroll):
                active = (sign == 0) & (steps < max_steps)
                l1, psi1, pl1 = step(metric, l, psi, p_l, b, dt)
                l = jnp.where(active, l1, l)
                psi = jnp.where(active, psi1, psi)
                p_l = jnp.where(active, pl1, p_l)
                sign = jnp.where(active & (l > escape_radius), 1,
                                 jnp.where(active & (l < -escape_radius), -1,
                                           sign))
                if r_cap is not None:
                    sign = jnp.where(active & (l < r_cap), CAPTURED, sign)
                steps = steps + active.astype(jnp.int32)
            return l, psi, p_l, sign, steps, it + unroll

        l, psi, p_l, sign, steps, _ = lax.while_loop(
            cond, body, (l, psi, p_l, sign0, steps0, jnp.int32(0)))
        return l, psi, p_l, sign, steps

    l, psi, p_l, sign, steps = lax.map(tile_fn, (l, psi, p_l, b))
    l, psi, p_l, sign, steps = (a.reshape(-1) for a in (l, psi, p_l, sign, steps))
    if sort:
        l, psi, p_l, sign, steps = (a[inv] for a in (l, psi, p_l, sign, steps))
    out_shape = rays.l.shape
    return PlanarResult(l[:n].reshape(out_shape), psi[:n].reshape(out_shape),
                        p_l[:n].reshape(out_shape), sign[:n].reshape(out_shape),
                        steps[:n].reshape(out_shape))


def escape_angle_beta(metric: Metric, res: PlanarResult, b):
    """Exact in-plane escape direction angle beta (from the launch radius):
    beta = psi + atan2(u_psi, u_l) with local components u_psi = b / r,
    u_l = p_l / sqrt(B) (= p_l sqrt(A) for the B = 1/A metrics)."""
    u_psi = b / metric.r(res.l)
    u_l = res.p_l
    if not _unit_lapse(metric):
        u_l = u_l * jnp.sqrt(metric.lapse(res.l))
    return res.psi + jnp.arctan2(u_psi, u_l)


def planar_world_directions(metric: Metric, rays: PlanarRays, res: PlanarResult):
    """Reconstruct 3-D world escape directions: rotate e1 = r_hat by beta in
    the ray's plane: w = cos(beta) e1 + sin(beta) e2."""
    beta = escape_angle_beta(metric, res, rays.b)
    return (jnp.cos(beta)[..., None] * rays.r_hat
            + jnp.sin(beta)[..., None] * rays.e2)
