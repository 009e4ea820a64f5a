"""Device-mesh construction and ray-axis sharding helpers.

Parallelism design (SURVEY.md section 2, "Parallelism status"):
the reference is single-threaded (README.md:110); its natural work axes are
per-pixel rays, per-alpha samples, and per-frame videos.  Here the ray/pixel
axis is sharded over a 1-D ``Mesh`` ('rays'); video adds a 'frames' axis.
Backgrounds and metric parameters are replicated (tens of MB at most); the
only collective the workload needs is the psum of parameter gradients that
GSPMD inserts automatically in differentiable mode — over ICI within a slice.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS = "rays"
FRAMES = "frames"


def make_mesh(n_devices=None, axis_name=RAYS, devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis_name,))


def make_mesh_2d(n_frames, n_rays=None, devices=None) -> Mesh:
    """(frames, rays) 2-D mesh — the video-workload topology: whole frames
    sharded across one axis, each frame's ray bundle split across the other
    (SURVEY.md section 2: per-frame and per-pixel are the two natural
    parallel axes)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_rays is None:
        n_rays = len(devs) // n_frames
    need = n_frames * n_rays
    if need > len(devs):
        raise ValueError(f"requested {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_frames, n_rays),
                (FRAMES, RAYS))


def ray_sharding(mesh: Mesh, axis_name=RAYS) -> NamedSharding:
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(arr, multiple, axis=0):
    """Pad (with edge copies) so arr.shape[axis] divides evenly; returns
    (padded, original_size)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    import jax.numpy as jnp
    idx = jnp.concatenate([jnp.arange(n), jnp.zeros(rem, dtype=jnp.int32)])
    return jnp.take(arr, idx, axis=axis), n


def shard_rays(tree, mesh: Mesh, axis_name=RAYS):
    """Apply a sharding constraint on the leading (ray) axis of every leaf."""
    sh = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda a: jax.lax.with_sharding_constraint(a, sh), tree)
