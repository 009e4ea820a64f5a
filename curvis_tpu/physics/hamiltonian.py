"""General-metric geodesic integration with autodiff-generated equations.

The planar reduction (physics/planar.py) covers every spherically symmetric
metric — the reference's whole domain.  This module removes that symmetry
requirement: given ANY inverse metric g^{mu nu}(x), the geodesic equations
come from the super-Hamiltonian

    H(x, p) = (1/2) g^{mu nu}(x) p_mu p_nu
    dx/dlam  =  dH/dp  =  g^{-1} p
    dp/dlam  = -dH/dx          (computed with jax.grad — no hand-derived
                                Christoffel symbols, ever)

and local photon spawn uses an orthonormal tetrad built numerically by
Gram-Schmidt on the coordinate basis under g — also metric-agnostic.

This is what lets curvis_tpu render **rotating (Kerr) black holes**, which
the reference README explicitly rules out for its architecture
("CurVis currently supports only ... spherical symmetry (preventing, for
instance, the simulation of rotating black holes)", README.md:111).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class HamiltonianResult(NamedTuple):
    x: jax.Array        # (..., 4) final position
    p: jax.Array        # (..., 4) final covariant momentum
    sign: jax.Array     # int32: +1 escaped, 2 captured, 0 not terminated
    steps: jax.Array    # int32


def hamiltonian(metric, x, p):
    """H = (1/2) g^{mu nu} p_mu p_nu, batched over leading dims.

    Uses the metric's SoA ``inverse_components`` when available (the (N,4,4)
    (N,4,4) einsum is the general fallback)."""
    if hasattr(metric, "inverse_components"):
        gtt, grr, gthth, gphph, gtph = metric.inverse_components(x)
        pt, pr_, pth, pph = (p[..., 0], p[..., 1], p[..., 2], p[..., 3])
        return 0.5 * (gtt * pt * pt + grr * pr_ * pr_ + gthth * pth * pth
                      + gphph * pph * pph) + gtph * pt * pph
    ginv = metric.inverse_metric(x)                    # (..., 4, 4)
    return 0.5 * jnp.einsum("...ij,...i,...j->...", ginv, p, p,
                            precision=jax.lax.Precision.HIGHEST)


def geodesic_rhs(metric, x, p):
    """(dx, dp) = (dH/dp, -dH/dx) for a single (4,) state — vmap over rays."""
    ginv = metric.inverse_metric(x)
    dx = ginv @ p
    dp = -jax.grad(lambda xx: hamiltonian(metric, xx, p))(x)
    return dx, dp


def _rhs_batched(metric, x, p):
    """Batched RHS: dp = -grad_x sum_i H(x_i, p_i) (block-diagonal, so the
    summed gradient IS the per-ray gradient) — one grad call, no vmap."""
    if hasattr(metric, "inverse_components"):
        gtt, grr, gthth, gphph, gtph = metric.inverse_components(x)
        pt, pr_, pth, pph = (p[..., 0], p[..., 1], p[..., 2], p[..., 3])
        dx = jnp.stack([gtt * pt + gtph * pph, grr * pr_, gthth * pth,
                        gtph * pt + gphph * pph], axis=-1)
    else:
        ginv = metric.inverse_metric(x)                # (..., 4, 4)
        dx = jnp.einsum("...ij,...j->...i", ginv, p,
                        precision=jax.lax.Precision.HIGHEST)
    dp = -jax.grad(lambda X: jnp.sum(hamiltonian(metric, X, p)))(x)
    return dx, dp


def rk4_step_batched(metric, x, p, dt):
    k1x, k1p = _rhs_batched(metric, x, p)
    k2x, k2p = _rhs_batched(metric, x + 0.5 * dt * k1x, p + 0.5 * dt * k1p)
    k3x, k3p = _rhs_batched(metric, x + 0.5 * dt * k2x, p + 0.5 * dt * k2p)
    k4x, k4p = _rhs_batched(metric, x + dt * k3x, p + dt * k3p)
    x1 = x + (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    p1 = p + (dt / 6.0) * (k1p + 2 * k2p + 2 * k3p + k4p)
    return x1, p1


def static_tetrad(metric, x):
    """Orthonormal tetrad e_(a)^mu at x by Gram-Schmidt on the coordinate
    basis (d_t, d_r, d_theta, d_phi) under g — first leg timelike.

    Rows of the returned (4, 4) array are the tetrad vectors' coordinate
    components: tetrad[a, mu] = e_(a)^mu.  Valid wherever d_t is timelike
    (outside the ergosphere for Kerr).
    """
    g = metric.metric(x)                               # (4, 4) covariant

    def dot(u, v):
        return u @ g @ v

    basis = jnp.eye(4, dtype=x.dtype)
    e0 = basis[0] / jnp.sqrt(-dot(basis[0], basis[0]))
    vecs = [e0]
    signs = [-1.0]
    for k in range(1, 4):
        v = basis[k]
        for e, s in zip(vecs, signs):
            v = v - s * dot(v, e) * e                  # project out (eta_ab)
        v = v / jnp.sqrt(dot(v, v))
        vecs.append(v)
        signs.append(1.0)
    return jnp.stack(vecs)                             # (4, 4)


def spawn_photon(metric, x, direction3):
    """Covariant null momentum for a photon at x with local direction
    ``direction3`` (components along the spatial tetrad legs), local energy
    1 in the static frame.  Batched over rays (x (...,4), dir (...,3))."""
    def one(xi, di):
        tet = static_tetrad(metric, xi)                # e_(a)^mu
        d = di / jnp.linalg.norm(di)
        p_up = tet[0] + d[0] * tet[1] + d[1] * tet[2] + d[2] * tet[3]
        g = metric.metric(xi)
        return g @ p_up                                # lower the index
    return jax.vmap(one)(x, direction3)


def axis_dt_scale(theta, axis_u0):
    """Polar-axis step control shared by every Kerr/BL marcher: shrink dt by
    up to 16x inside the sin^2(theta) < axis_u0 band (the theta-equation
    stiffens as 1/sin^2 there; NEXT.md round-1 'polar-axis seam').
    ``axis_u0 = 0`` disables (guarded ratio clips to 1).  The pallas Kerr
    kernel implements the identical rule."""
    s = jnp.sin(theta)
    return jnp.clip((s * s + 1e-12) / jnp.maximum(axis_u0, 1e-12),
                    1.0 / 16.0, 1.0)


FAR_DT_CAP = 8.0


def far_dt_scale(r, far_r0):
    """Far-field step acceleration shared by every Kerr/BL marcher: grow dt
    linearly with r beyond ``far_r0`` (capped at FAR_DT_CAP).  Outside a
    few M the curvature scale is ~r, so affine step ~ r keeps local
    truncation error flat while cutting the straight-leg step count ~2-3x
    (measured: 1416 -> 663 lock-step iterations on the 512x288 shadow
    bundle at far_r0 = 8M, escape-direction error p99 ~ 3e-3 rad —
    sub-texel for <= 1k-wide backgrounds).  ``far_r0 = None`` at the
    call sites encodes 'disabled' as 1e30: r/1e30 clips to 1 exactly, so
    the disabled path is bit-identical to not applying the rule (the
    Pallas kernel relies on this — no branch needed)."""
    return jnp.clip(r / jnp.maximum(far_r0, 1e-12), 1.0, FAR_DT_CAP)


def march_hamiltonian(metric, x0, p0, *, dt, max_steps, escape_radius,
                      capture_radius=None, axis_u0=0.01,
                      far_r0=None) -> HamiltonianResult:
    """Masked lock-step RK4 march of the general system.  Radial coordinate
    is x[..., 1]; escape at r > escape_radius, capture at r < capture_radius
    (e.g. just outside the horizon)."""
    dt = jnp.asarray(dt, x0.dtype)
    if far_r0 is None:
        far_r0 = jnp.asarray(1e30, x0.dtype)
    sign0 = jnp.zeros(x0.shape[:-1], jnp.int32)
    steps0 = jnp.zeros(x0.shape[:-1], jnp.int32)

    def cond(c):
        _, _, sign, _, it = c
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        x, p, sign, steps, it = c
        active = sign == 0
        dte = dt * axis_dt_scale(x[..., 2], axis_u0) \
            * far_dt_scale(x[..., 1], far_r0)
        x1, p1 = rk4_step_batched(metric, x, p, dte[..., None])
        am = active[..., None]
        x = jnp.where(am, x1, x)
        p = jnp.where(am, p1, p)
        r = x[..., 1]
        # blowup guard (sign 3): same full-state abs-sum predicate as the
        # pallas Kerr kernel so backends agree ray for ray (catches inf AND
        # NaN in any of r/theta/phi/p_r/p_theta — NaN compares false)
        m_chk = (jnp.abs(r) + jnp.abs(x[..., 2]) + jnp.abs(x[..., 3])
                 + jnp.abs(p[..., 1]) + jnp.abs(p[..., 2]))
        ok = m_chk <= 1e8
        sign = jnp.where(active & ok & (r > escape_radius), 1, sign)
        if capture_radius is not None:
            sign = jnp.where(active & ok & (r < capture_radius), 2, sign)
        sign = jnp.where(active & ~ok, 3, sign)
        steps = steps + active.astype(jnp.int32)
        return x, p, sign, steps, it + 1

    x, p, sign, steps, _ = lax.while_loop(
        cond, body, (x0, p0, sign0, steps0, jnp.int32(0)))
    return HamiltonianResult(x, p, sign, steps)


def march_hamiltonian_scan(metric, x0, p0, *, dt, max_steps, escape_radius,
                           capture_radius=None, axis_u0=0.01,
                           segment=None, far_r0=None) -> HamiltonianResult:
    """Differentiable general-metric march (two-level checkpointed scan).

    Same per-step semantics as :func:`march_hamiltonian` (masking on
    ``steps < max_steps`` as well as ``sign`` keeps the backends in
    agreement at the step cap, like physics/planar.march_planar_scan), but
    reverse-mode differentiable: ``lax.while_loop`` has no transpose, so
    gradient flows — e.g. *recovering a black hole's spin from an image*
    (tests/test_gradients.py, examples/inverse_problem.py) — route through
    this fixed-trip-count scan with O(sqrt(steps)) rematerialization.
    Gradients reach the metric parameter pytree, ``x0`` and ``p0``.
    """
    import math
    dt = jnp.asarray(dt, x0.dtype)
    if far_r0 is None:
        far_r0 = jnp.asarray(1e30, x0.dtype)
    if segment is None:
        segment = max(1, int(math.sqrt(max_steps)))
    n_seg = -(-max_steps // segment)
    sign0 = jnp.zeros(x0.shape[:-1], jnp.int32)
    steps0 = jnp.zeros(x0.shape[:-1], jnp.int32)

    def one(c, _):
        x, p, sign, steps = c
        active = (sign == 0) & (steps < max_steps)
        dte = dt * axis_dt_scale(x[..., 2], axis_u0) \
            * far_dt_scale(x[..., 1], far_r0)
        x1, p1 = rk4_step_batched(metric, x, p, dte[..., None])
        am = active[..., None]
        x = jnp.where(am, x1, x)
        p = jnp.where(am, p1, p)
        r = x[..., 1]
        m_chk = (jnp.abs(r) + jnp.abs(x[..., 2]) + jnp.abs(x[..., 3])
                 + jnp.abs(p[..., 1]) + jnp.abs(p[..., 2]))
        ok = m_chk <= 1e8
        sign = jnp.where(active & ok & (r > escape_radius), 1, sign)
        if capture_radius is not None:
            sign = jnp.where(active & ok & (r < capture_radius), 2, sign)
        sign = jnp.where(active & ~ok, 3, sign)
        steps = steps + active.astype(jnp.int32)
        return (x, p, sign, steps), None

    @jax.checkpoint
    def seg(c, _):
        c, _ = lax.scan(one, c, None, length=segment)
        return c, None

    (x, p, sign, steps), _ = lax.scan(seg, (x0, p0, sign0, steps0), None,
                                      length=n_seg)
    return HamiltonianResult(x, p, sign, steps)
