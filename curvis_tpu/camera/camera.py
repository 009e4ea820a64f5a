"""Pinhole camera in curved spacetime — vectorized ray generation.

Data-parallel re-design of the reference Camera (/root/reference/src/cameras.rs):
instead of a per-pixel method call (cameras.rs:150-172), the whole pixel grid
of ray directions is produced as one ``(H*W, 3)`` jnp computation, ready to be
sharded across devices.  The camera itself is an immutable pytree, so "moving"
the camera (video playback, pose optimization) is just building a new one —
and camera pose is differentiable by construction.

Geometry matches cameras.rs exactly:
  - sensor sizes from diagonal + aspect ratio (cameras.rs:107-110)
  - per-pixel camera-space ray v = normalize(f, -sw*(x/W - 0.5), sh*(0.5 - y/H))
    (cameras.rs:150-164; note: pixel *corners*, no half-pixel offset — kept for
    parity, with an opt-in ``center_pixels`` quality mode)
  - camera->world rotation from the forward/up Orientation (cameras.rs:104-105)
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from curvis_tpu.geometry import rotations


@dataclasses.dataclass(frozen=True)
class Camera:
    """Viewpoint: 4-position on the metric + tangent-space orientation.

    ``position``: (4,) contravariant (t, l, theta, phi).
    ``forward``/``up``: (3,) tangent-space vectors (cameras.rs:30-43).
    Resolution is static metadata (shapes must be static under jit).
    """

    position: jax.Array
    forward: jax.Array
    up: jax.Array
    focal_length: jax.Array
    sensor_diagonal: jax.Array
    resolution_x: int
    resolution_y: int

    def __post_init__(self):
        if self.resolution_x <= 0 or self.resolution_y <= 0:
            raise ValueError("resolution must be positive")


jax.tree_util.register_dataclass(
    Camera,
    data_fields=["position", "forward", "up", "focal_length", "sensor_diagonal"],
    meta_fields=["resolution_x", "resolution_y"],
)


def make_camera(position, forward, up, focal_length, sensor_diagonal,
                resolution_x, resolution_y, dtype=jnp.float32) -> Camera:
    """Validated constructor (checks mirror cameras.rs:89-102)."""
    if float(focal_length) <= 0:
        raise ValueError("focal_length must be > 0")
    if float(sensor_diagonal) <= 0:
        raise ValueError("sensor_diagonal must be > 0")
    return Camera(
        position=jnp.asarray(position, dtype=dtype),
        forward=jnp.asarray(forward, dtype=dtype),
        up=jnp.asarray(up, dtype=dtype),
        focal_length=jnp.asarray(focal_length, dtype=dtype),
        sensor_diagonal=jnp.asarray(sensor_diagonal, dtype=dtype),
        resolution_x=int(resolution_x),
        resolution_y=int(resolution_y),
    )


def sensor_size(camera: Camera):
    """(sensor_width, sensor_height) from diagonal + aspect (cameras.rs:107-110)."""
    aspect = camera.resolution_x / camera.resolution_y
    h = jnp.sqrt(camera.sensor_diagonal ** 2 / (aspect * aspect + 1.0))
    return aspect * h, h


def camera_rotation(camera: Camera):
    """Camera->world rotation matrix (3, 3) from the forward/up pair."""
    return rotations.rotation_from_forward_up(camera.forward, camera.up)


def pixel_rays_camera_space(camera: Camera, *, center_pixels=False):
    """All pixel ray directions in camera space -> (H*W, 3), row-major over
    (x, y) like the reference's double loop (systems.rs:405-423: index = x*H + y).
    """
    dtype = camera.position.dtype
    xs = jnp.arange(camera.resolution_x, dtype=dtype)
    ys = jnp.arange(camera.resolution_y, dtype=dtype)
    if center_pixels:
        xs = xs + 0.5
        ys = ys + 0.5
    w = xs / camera.resolution_x - 0.5          # (W,)
    h = 0.5 - ys / camera.resolution_y          # (H,)
    sw, sh = sensor_size(camera)
    vx = jnp.broadcast_to(camera.focal_length, (camera.resolution_x, camera.resolution_y))
    vy = jnp.broadcast_to((-sw * w)[:, None], vx.shape)
    vz = jnp.broadcast_to((sh * h)[None, :], vx.shape)
    v = jnp.stack([vx, vy, vz], axis=-1).reshape(-1, 3)
    return rotations.normalize(v)


def pixel_rays_world(camera: Camera, *, center_pixels=False):
    """All pixel ray directions rotated to world/tangent space -> (H*W, 3)
    (cameras.rs:169-172)."""
    v = pixel_rays_camera_space(camera, center_pixels=center_pixels)
    R = camera_rotation(camera)
    return v @ R.T


def aberrate_directions(dx, dy, dz, velocity):
    """Special-relativistic aberration of LOOK directions (the directions
    backward-traced rays are marched along) from the camera's comoving
    frame into the local static frame, SoA in/out.

    ``velocity``: the camera's 3-velocity beta (|beta| < 1) in the same
    orthonormal basis as the direction components (world/static frame).
    Boosting the incoming photon's null 4-momentum (propagation n = -d)
    gives, in terms of the look direction d:

        d' = [ d/gamma - beta + (gamma/(gamma+1)) (beta . d) beta ]
             / (1 - beta . d)

    beta -> 0 reduces to d' = d; a comoving-frame pixel cone maps onto a
    WIDER static-frame cone around the motion (the relativistic headlight
    effect: the moving camera sees the sky bunched toward its velocity —
    the DNGR camera-motion aberration, James et al. 2015 section A).

    Returns (dx', dy', dz', delta) with delta = nu_received / nu_static =
    gamma (1 + beta . d') the per-ray Doppler factor; received surface
    brightness of the (frequency-flat-texture) background scales as
    delta^3 by I_nu / nu^3 invariance.
    """
    beta = jnp.asarray(velocity, dx.dtype)
    bx, by, bz = beta[0], beta[1], beta[2]
    b2 = bx * bx + by * by + bz * bz
    gamma = jax.lax.rsqrt(jnp.maximum(1.0 - b2, 1e-12))
    bd = bx * dx + by * dy + bz * dz
    coef = (gamma / (gamma + 1.0)) * bd - 1.0      # (g/(g+1))(b.d) - 1
    inv_g = 1.0 / gamma
    inv = 1.0 / (1.0 - bd)
    nx = (dx * inv_g + coef * bx) * inv
    ny = (dy * inv_g + coef * by) * inv
    nz = (dz * inv_g + coef * bz) * inv
    delta = gamma * (1.0 + bx * nx + by * ny + bz * nz)
    return nx, ny, nz, delta
