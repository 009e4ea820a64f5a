"""Null-geodesic physics: metric components, frame fields, Hamiltonian RHS,
photon spawn/readout, and metric-space inner products.

Data-parallel re-design of the computational core of the reference
(/root/reference/src/metrics.rs:49-349 and src/vectors.rs): 4-vectors are plain
``(..., 4)`` jnp arrays; covariance is a *naming convention* enforced by tests,
not a runtime tag (the reference's runtime `Covariance` checks, vectors.rs:13-35,
cannot exist under `jit`).  Every function is batched over leading dimensions
and differentiable w.r.t. metric parameters, positions and momenta.

State convention used throughout the framework:
  - ``x``      : contravariant position, components (t, l, theta, phi)
  - ``p``      : covariant momentum, components (p_t, p_l, p_theta, p_phi)
p_t and p_phi are exact constants of motion (metrics.rs:259-264 sets their
derivatives to zero), which the integrators exploit.
"""
from __future__ import annotations

import jax.numpy as jnp

from curvis_tpu.metrics.base import Metric

# Coordinate indices.
T, L, TH, PH = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Metric components (diagonal): g = diag(-1, 1, r^2, r^2 sin^2 theta)
# (metrics.rs:49-68; contravariant components are reciprocals, 84-104)
# ---------------------------------------------------------------------------

def metric_diag(metric: Metric, x):
    """Covariant diagonal (g00, g11, g22, g33) at position x -> (..., 4)."""
    r2 = metric.r_squared(x[..., L])
    s2 = jnp.sin(x[..., TH]) ** 2
    one = jnp.ones_like(r2)
    return jnp.stack([-one, one, r2, r2 * s2], axis=-1)


def metric_diag_contr(metric: Metric, x):
    """Contravariant diagonal (1/g_ii) at position x -> (..., 4)."""
    return 1.0 / metric_diag(metric, x)


def to_covariant(metric: Metric, x, v_contr):
    """Lower the index of a contravariant vector (metrics.rs:160-171)."""
    return v_contr * metric_diag(metric, x)


def to_contravariant(metric: Metric, x, v_cov):
    """Raise the index of a covariant vector (metrics.rs:190-203)."""
    return v_cov * metric_diag_contr(metric, x)


# ---------------------------------------------------------------------------
# Frame field: diag(1, 1, r, r sin theta) and its inverse (metrics.rs:109-156)
# ---------------------------------------------------------------------------

def frame_field_diag(metric: Metric, x):
    r = metric.r(x[..., L])
    st = jnp.sin(x[..., TH])
    one = jnp.ones_like(r)
    return jnp.stack([one, one, r, r * st], axis=-1)


# ---------------------------------------------------------------------------
# Geodesic right-hand sides — James et al. 2015 eqs. (A7)
# (metrics.rs:223-270)
# ---------------------------------------------------------------------------

def position_deriv(metric: Metric, x, p_cov):
    """dx^i/dlambda = g^{ii} p_i, contravariant (metrics.rs:223-244)."""
    r2 = metric.r_squared(x[..., L])
    s2 = jnp.sin(x[..., TH]) ** 2
    return jnp.stack([
        -p_cov[..., T],
        p_cov[..., L],
        p_cov[..., TH] / r2,
        p_cov[..., PH] / (r2 * s2),
    ], axis=-1)


def momentum_deriv(metric: Metric, x, p_cov):
    """dp_i/dlambda, covariant; p_t and p_phi are conserved
    (metrics.rs:247-270).

        b^2     = p_theta^2 + p_phi^2 / sin^2 theta
        dp_l    = b^2 r'(l) / r(l)^3
        dp_th   = p_phi^2 cos(theta) / (r^2 sin^3 theta)
    """
    l = x[..., L]
    th = x[..., TH]
    st = jnp.sin(th)
    r = metric.r(l)
    r2 = metric.r_squared(l)
    pth = p_cov[..., TH]
    pph = p_cov[..., PH]
    b2 = pth * pth + (pph * pph) / (st * st)
    zero = jnp.zeros_like(l)
    return jnp.stack([
        zero,
        b2 * metric.r_derivative(l) / (r * r * r),
        pph * pph * jnp.cos(th) / (r2 * st * st * st),
        zero,
    ], axis=-1)


def geodesic_rhs(metric: Metric, x, p_cov):
    """(dx, dp) evaluated at the current state — one fused call for steppers."""
    return position_deriv(metric, x, p_cov), momentum_deriv(metric, x, p_cov)


def euler_step(metric: Metric, x, p_cov, dt):
    """One explicit forward-Euler step, both derivatives at the current state
    (reference-parity stepper, metrics.rs:283-297)."""
    dx, dp = geodesic_rhs(metric, x, p_cov)
    return x + dt * dx, p_cov + dt * dp


def rk4_step(metric: Metric, x, p_cov, dt):
    """Classic RK4 step of the same Hamiltonian flow (quality upgrade —
    the reference only ships Euler, SURVEY.md section 2 #5)."""
    k1x, k1p = geodesic_rhs(metric, x, p_cov)
    k2x, k2p = geodesic_rhs(metric, x + 0.5 * dt * k1x, p_cov + 0.5 * dt * k1p)
    k3x, k3p = geodesic_rhs(metric, x + 0.5 * dt * k2x, p_cov + 0.5 * dt * k2p)
    k4x, k4p = geodesic_rhs(metric, x + dt * k3x, p_cov + dt * k3p)
    x1 = x + (dt / 6.0) * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
    p1 = p_cov + (dt / 6.0) * (k1p + 2.0 * k2p + 2.0 * k3p + k4p)
    return x1, p1


# ---------------------------------------------------------------------------
# Photon spawn and direction readout (metrics.rs:301-349)
# ---------------------------------------------------------------------------

def new_photon(metric: Metric, x, direction3):
    """Covariant null momentum for a photon at ``x`` moving along the
    tangent-space direction ``direction3`` (components along l-hat, theta-hat,
    phi-hat).  Reproduces metrics.rs:301-334:

        p = (1, d_x, d_y * r, d_z * r * sin(theta))
    """
    d = direction3 / jnp.linalg.norm(direction3, axis=-1, keepdims=True)
    r = metric.r(x[..., L])
    st = jnp.sin(x[..., TH])
    return jnp.stack([
        jnp.ones_like(r),
        d[..., 0],
        d[..., 1] * r,
        d[..., 2] * r * st,
    ], axis=-1)


def momentum_to_direction(metric: Metric, x, p_cov, *, compat_ff22_bug=False):
    """Tangent-space 3-direction of a (covariant) momentum at ``x``.

    The correct frame-field projection is (p^1, p^2 r, p^3 r sin(theta)).
    The reference has a bug: its third component uses frame_field_22 = r
    instead of frame_field_33 = r sin(theta) (metrics.rs:344-348) — invisible
    on the equatorial plane.  ``compat_ff22_bug=True`` reproduces it for
    bit-parity comparisons against the reference's naive path.
    """
    r = metric.r(x[..., L])
    st = jnp.sin(x[..., TH])
    r2 = metric.r_squared(x[..., L])
    third_scale = r if compat_ff22_bug else r * st
    return jnp.stack([
        p_cov[..., L],
        (p_cov[..., TH] / r2) * r,
        (p_cov[..., PH] / (r2 * st * st)) * third_scale,
    ], axis=-1)


# ---------------------------------------------------------------------------
# Metric-space inner products (metrics.rs:355-389)
# ---------------------------------------------------------------------------

def dot_product(metric: Metric, x, v1_contr, v2_contr):
    """g_ij v1^i v2^j for two contravariant vectors at x."""
    return jnp.sum(v1_contr * v2_contr * metric_diag(metric, x), axis=-1)


def squared_norm(metric: Metric, x, v_contr):
    return dot_product(metric, x, v_contr, v_contr)


def norm(metric: Metric, x, v_contr):
    return jnp.sqrt(squared_norm(metric, x, v_contr))


def squared_norm_cov(metric: Metric, x, p_cov):
    """g^{ij} p_i p_j for a covariant vector (the null-norm invariant ||p||^2
    preserved by the flow; test oracle from metrics.rs:544-570)."""
    return jnp.sum(p_cov * p_cov * metric_diag_contr(metric, x), axis=-1)
