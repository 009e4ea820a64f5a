"""Batched 3-D rotation / spherical-coordinate utilities.

Data-parallel re-design of the reference's orientation algebra
(/root/reference/src/algebra.rs:1-134): instead of scalar nalgebra calls, every
function here is a pure jnp function over arbitrary batch dimensions, safe under
`jit`/`vmap` (no panics — degenerate inputs are handled with epsilon guards and
`jnp.where` so everything stays differentiable and compiles to fused VPU code).

Conventions (identical to the reference):
  - theta in [0, pi] measured from +z; phi in [0, 2*pi) from +x toward +y.
  - An Orientation is a (forward, up) pair; its rotation matrix maps the
    canonical frame (forward = +x, up = +z) onto the pair, with `up` repaired
    to be orthogonal to `forward` (algebra.rs:16-38, via face_towards pairs
    algebra.rs:64-74).
  - `rotation_between(v1, v2)` is the minimal rotation taking v1 to v2
    (algebra.rs:92-101).

All rotation matrices are (..., 3, 3) acting on column vectors: w = R @ v.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-30


def _norm(v, axis=-1, keepdims=True):
    return jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))


def normalize(v, axis=-1):
    """Safe vector normalization (returns v/|v|, zeros stay zeros)."""
    n = _norm(v, axis=axis)
    return v / jnp.maximum(n, _EPS)


def normalize_theta_phi(theta, phi):
    """Map (theta, phi) into [0, pi] x [0, 2*pi).

    Mirrors algebra.rs:106-116: negative theta is reflected (abs) with phi
    shifted by pi, then phi is reduced mod 2*pi.
    """
    neg = theta < 0.0
    theta = jnp.abs(theta)
    phi = jnp.where(neg, phi + jnp.pi, phi)
    phi = jnp.mod(phi, 2.0 * jnp.pi)
    return theta, phi


def vector3_from_theta_phi(theta, phi):
    """Unit vector for spherical angles; batched. (algebra.rs:118-126)"""
    theta, phi = normalize_theta_phi(theta, phi)
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def theta_phi_from_vector3(v):
    """Spherical angles of a (not necessarily unit) vector. (algebra.rs:128-134)"""
    r = jnp.maximum(_norm(v, keepdims=False), _EPS)
    theta = jnp.arccos(jnp.clip(v[..., 2] / r, -1.0, 1.0))
    phi = jnp.arctan2(v[..., 1], v[..., 0])
    return normalize_theta_phi(theta, phi)


def rotation_from_forward_up(forward, up):
    """Rotation taking the canonical frame (fwd=+x, up=+z) to (forward, up).

    Column construction reproduces nalgebra's face_towards pair composition used
    by Orientation::new (algebra.rs:16-38, 64-74): columns are
    [f_hat, normalize(up x f_hat), f_hat x normalize(up x f_hat)], i.e.
    R @ x = f_hat, R @ z = repaired up, R @ y = left.
    """
    f = normalize(forward)
    left = normalize(jnp.cross(up, f))
    u = jnp.cross(f, left)
    return jnp.stack([f, left, u], axis=-1)


def orthogonal_up(forward, up):
    """The repaired up vector of an Orientation (algebra.rs:30)."""
    f = normalize(forward)
    return jnp.cross(f, normalize(jnp.cross(up, f)))


def rotation_between(v1, v2):
    """Minimal rotation taking v1 to v2 (batched Rodrigues; algebra.rs:92-101).

    Degenerate cases (which panic in the reference) are handled smoothly:
    parallel vectors give the identity; antiparallel vectors give a pi-rotation
    about an arbitrary perpendicular axis.
    """
    a = normalize(v1)
    b = normalize(v2)
    c = jnp.cross(a, b)                       # |c| = sin(angle)
    cos_t = jnp.sum(a * b, axis=-1)[..., None, None]
    K = _skew(c)
    # R = I + K + K^2 / (1 + cos)   (Rodrigues with s*k folded into the cross)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=a.dtype), K.shape)
    denom = jnp.where(jnp.abs(1.0 + cos_t) < 1e-12, 1.0, 1.0 + cos_t)
    R = eye + K + (K @ K) / denom
    # Antiparallel: rotate pi about any axis perpendicular to a.
    anti = (cos_t < -1.0 + 1e-12)
    perp = normalize(_any_perpendicular(a))
    R_pi = rotation_axis_angle(perp, jnp.full(a.shape[:-1], jnp.pi, dtype=a.dtype))
    return jnp.where(anti, R_pi, R)


def _any_perpendicular(a):
    """A vector perpendicular to a (nonzero for any nonzero a)."""
    # Pick the world axis least aligned with a, cross with it.
    ax = jnp.abs(a)
    use_x = (ax[..., 0:1] <= jnp.minimum(ax[..., 1:2], ax[..., 2:3]))
    use_y = (~use_x) & (ax[..., 1:2] <= ax[..., 2:3])
    e = jnp.where(use_x, jnp.array([1.0, 0.0, 0.0], dtype=a.dtype),
                  jnp.where(use_y, jnp.array([0.0, 1.0, 0.0], dtype=a.dtype),
                            jnp.array([0.0, 0.0, 1.0], dtype=a.dtype)))
    return jnp.cross(a, e)


def _skew(v):
    """Skew-symmetric cross-product matrix [v]_x, batched -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)


def rotation_axis_angle(axis, angle):
    """Rodrigues rotation about (unnormalized) axis by angle; batched."""
    k = normalize(axis)
    s = jnp.sin(angle)[..., None, None]
    c = jnp.cos(angle)[..., None, None]
    K = _skew(k)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=k.dtype), K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotation_from_theta_phi(theta, phi):
    """Rotation mapping +x to the (theta, phi) direction: Rz(phi) @ Ry(theta - pi/2).

    (algebra.rs:82-90 — rotate by (theta - pi/2) about +y, then phi about +z.)
    """
    theta, phi = normalize_theta_phi(theta, phi)
    a = theta - jnp.pi / 2.0
    ca, sa = jnp.cos(a), jnp.sin(a)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    zero = jnp.zeros_like(ca)
    one = jnp.ones_like(ca)
    ry = jnp.stack([
        jnp.stack([ca, zero, sa], axis=-1),
        jnp.stack([zero, one, zero], axis=-1),
        jnp.stack([-sa, zero, ca], axis=-1),
    ], axis=-2)
    rz = jnp.stack([
        jnp.stack([cp, -sp, zero], axis=-1),
        jnp.stack([sp, cp, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ], axis=-2)
    return rz @ ry


class Orientation:
    """Forward/up orientation with cached rotation + inverse
    (algebra.rs:8-56).  A thin convenience wrapper over
    rotation_from_forward_up for the scripting API; hot paths use the
    functions directly."""

    def __init__(self, forward, up):
        import jax.numpy as _jnp
        forward = _jnp.asarray(forward)
        up = _jnp.asarray(up)
        if float(_norm(_jnp.cross(forward, up), keepdims=False)) == 0.0:
            raise ValueError("Forward and up vectors must not be parallel")
        self._forward = forward
        self._up = orthogonal_up(forward, up)
        self._rotation = rotation_from_forward_up(forward, up)

    @property
    def forward(self):
        return self._forward

    @property
    def up(self):
        return self._up

    @property
    def rotation_matrix(self):
        return self._rotation

    @property
    def inverse_rotation_matrix(self):
        return self._rotation.T


def frame_matrix(theta, phi):
    """Orthonormal coordinate frame [r_hat, theta_hat, phi_hat] as columns.

    This is the *true* tangent-frame embedding at a point on the coordinate
    sphere: tangent components (along increasing l, theta, phi) map to world
    space as w = F @ u.  The reference instead identifies tangent and world
    space via the minimal rotation x_hat -> r_hat (systems.rs:180-186), which
    agrees on r_hat but twists the transverse axes; `rotation_between` provides
    that convention for parity paths.
    """
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    r_hat = jnp.stack([st * cp, st * sp, ct], axis=-1)
    t_hat = jnp.stack([ct * cp, ct * sp, -st], axis=-1)
    p_hat = jnp.stack([-sp, cp, jnp.zeros_like(sp)], axis=-1)
    return jnp.stack([r_hat, t_hat, p_hat], axis=-1)
