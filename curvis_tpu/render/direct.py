"""Direct per-pixel renderer: the flagship TPU path.

Generalizes the reference's naive `render_image` (systems.rs:307-330) — one
photon per pixel, fully integrated — but batched: all H*W rays march in
lock-step under `jit`, so on TPU the per-pixel path is *faster* than the
reference's 1-D symmetry trick while working for any camera pose (including
off-equatorial-plane, where the symmetry reduction still applies but the
reference's frame handling is buggy; see metrics.rs:347).

Physics conventions (the *correct* ones — see SURVEY.md section 3.4 and the
symmetric renderer for the reference-parity variants):
  - camera world ray directions are decomposed in the true orthonormal
    coordinate frame [l-hat, theta-hat, phi-hat] at the camera position,
  - escaped momenta are re-embedded with the frame at the escape position.
With a flat metric this pipeline reproduces the background exactly (the
analytic end-to-end oracle used by the test suite).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp

from curvis_tpu.camera.camera import Camera, pixel_rays_world
from curvis_tpu.dispatch import use_kernel
from curvis_tpu.env.spherical_image import SphericalImage, sample
from curvis_tpu.geometry.rotations import frame_matrix, normalize, rotation_between
from curvis_tpu.integrate.march import march
from curvis_tpu.physics import geodesic
from curvis_tpu.physics.geodesic import TH, PH

# the frame products run in full float32: a TF32 product (the GPU default)
# errs by ~1e-3 rad, which the lensing map amplifies
_HIGHEST = jax.lax.Precision.HIGHEST


def spawn_pixel_photons(metric, camera: Camera, *, center_pixels=False,
                        frame_convention="frame"):
    """Camera pixel grid -> (x0, p0) photon bundle, row-major over (x, y).

    ``frame_convention``:
      - 'frame'   : decompose world rays in the true coordinate frame at the
                    camera position (correct; flat-space oracle holds).
      - 'identity': pass world components straight through as tangent
                    components — parity with the reference's naive spawn
                    (systems.rs:531-534 feeds the world vector to new_photon).
      - 'minimal' : minimal rotation x-hat -> r-hat, the efficient-path
                    convention (systems.rs:411).
    """
    d_world = pixel_rays_world(camera, center_pixels=center_pixels)   # (N, 3)
    theta = camera.position[TH]
    phi = camera.position[PH]
    if frame_convention == "frame":
        F = frame_matrix(theta, phi)                                  # (3, 3)
        comps = d_world @ F                                           # F^T d
    elif frame_convention == "minimal":
        from curvis_tpu.geometry.rotations import vector3_from_theta_phi
        R = rotation_between(jnp.array([1.0, 0.0, 0.0], d_world.dtype),
                             vector3_from_theta_phi(theta, phi))
        comps = d_world @ R                                           # R^T d
    elif frame_convention == "identity":
        comps = d_world
    else:
        raise ValueError(frame_convention)
    x0 = jnp.broadcast_to(camera.position, d_world.shape[:-1] + (4,))
    p0 = geodesic.new_photon(metric, x0, comps)
    return x0, p0


def escape_world_directions(metric, res, *, frame_convention="frame",
                            compat_ff22_bug=False):
    """Escaped bundle -> world-space propagation directions (N, 3)."""
    u = geodesic.momentum_to_direction(metric, res.x, res.p,
                                       compat_ff22_bug=compat_ff22_bug)
    theta = res.x[..., TH]
    phi = res.x[..., PH]
    if frame_convention == "frame":
        F = frame_matrix(theta, phi)                                  # (N, 3, 3)
        w = jnp.einsum("...ij,...j->...i", F, u, precision=_HIGHEST)
    elif frame_convention == "minimal":
        from curvis_tpu.geometry.rotations import vector3_from_theta_phi
        R = rotation_between(
            jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], u.dtype), u.shape),
            vector3_from_theta_phi(theta, phi))
        w = jnp.einsum("...ij,...j->...i", R, u, precision=_HIGHEST)
    elif frame_convention == "identity":
        w = u
    else:
        raise ValueError(frame_convention)
    return normalize(w)


def shade(bg_positive: SphericalImage, bg_negative: SphericalImage,
          directions, sign, *, filtering="nearest"):
    """Background lookup by escape sign; not-escaped rays are black
    (systems.rs:540-561)."""
    pos = sample(bg_positive, directions, filtering=filtering)
    neg = sample(bg_negative, directions, filtering=filtering)
    s = sign[..., None]
    return jnp.where(s == 1, pos,
                     jnp.where(s == -1, neg, jnp.zeros_like(pos)))


def render_direct(metric, camera: Camera, bg_positive: SphericalImage,
                  bg_negative: SphericalImage, *, dt, max_steps, escape_radius,
                  stepper="euler", backend="auto", filtering="nearest",
                  center_pixels=False, frame_convention="frame",
                  compat_ff22_bug=False, differentiable=False,
                  method="planar", planar_tile=None):
    """Render an (H, W, 3) image. Jit-compatible end to end.

    ``method``:
      - 'planar'  : per-ray orbital-plane reduction (the hot path —
                    3-state march, no trig; see physics/planar.py).
      - 'frame3d' : full 4-position/4-momentum march with frame-field
                    embedding (cross-validation path; supports the
                    reference-parity ``frame_convention`` / ``compat_ff22_bug``
                    variants).
    """
    if method == "planar":
        from curvis_tpu.physics import planar as pl
        d_world = pixel_rays_world(camera, center_pixels=center_pixels)
        rays = pl.spawn_planar(metric, camera.position, d_world)
        kw = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
                  stepper=stepper)
        if differentiable == "adjoint":
            if stepper == "rk45":
                # error-controlled march with exact checkpointed-recompute
                # gradients (integrate/rk45_adjoint_planar.py): the planar
                # cell of the stepper x gradient matrix
                from curvis_tpu.integrate.rk45_adjoint_planar import (
                    march_planar_rk45_adjoint_rays)
                res = march_planar_rk45_adjoint_rays(
                    metric, rays, dt0=dt, max_steps=max_steps,
                    escape_radius=escape_radius)
            else:
                from curvis_tpu.integrate.adjoint import (
                    march_planar_adjoint_rays)
                res = march_planar_adjoint_rays(
                    metric, rays, dt=dt, max_steps=max_steps,
                    escape_radius=escape_radius)
        elif differentiable or backend == "scan":
            res = pl.march_planar_scan(metric, rays, **kw)
        elif backend == "pallas" or (backend == "auto"
                                     and use_kernel(rays.l.dtype)
                                     and stepper == "euler"):
            from curvis_tpu.ops.march_pallas import march_planar_pallas
            # camera pixel order is already cost-coherent per block
            res = march_planar_pallas(metric, rays, **kw)
        elif backend == "tiled" or planar_tile:
            res = pl.march_planar_tiled(metric, rays,
                                        tile=planar_tile or 65536, **kw)
        else:
            res = pl.march_planar_while(metric, rays, **kw)
        w = normalize(pl.planar_world_directions(metric, rays, res))
        sign = res.sign
    elif method == "frame3d":
        from curvis_tpu.physics.planar import _unit_lapse
        if not _unit_lapse(metric):
            raise NotImplementedError(
                "method='frame3d' marches the reference's g00=-1 system; "
                "general static metrics (Schwarzschild) use method='planar'")
        # frame_convention may be a (spawn, readout) pair: the reference's
        # naive path mixes them — identity spawn (systems.rs:531-534) but
        # minimal-rotation readout (systems.rs:144-187).
        if isinstance(frame_convention, tuple):
            spawn_conv, readout_conv = frame_convention
        else:
            spawn_conv = readout_conv = frame_convention
        x0, p0 = spawn_pixel_photons(metric, camera,
                                     center_pixels=center_pixels,
                                     frame_convention=spawn_conv)
        res = march(metric, x0, p0, dt=dt, max_steps=max_steps,
                    escape_radius=escape_radius, stepper=stepper,
                    backend=backend, differentiable=differentiable)
        w = escape_world_directions(metric, res,
                                    frame_convention=readout_conv,
                                    compat_ff22_bug=compat_ff22_bug)
        sign = res.sign
    else:
        raise ValueError(f"unknown method {method!r}")
    colors = shade(bg_positive, bg_negative, w, sign, filtering=filtering)
    # Bundle is row-major over (x, y): index = x * H + y (systems.rs:513-514).
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).transpose(1, 0, 2)


render_direct_jit = jax.jit(
    render_direct,
    static_argnames=("dt", "max_steps", "escape_radius", "stepper", "backend",
                     "filtering", "center_pixels", "frame_convention",
                     "compat_ff22_bug", "differentiable"),
)
