"""Equirectangular ("360-degree") background environments as pure gathers.

Data-parallel re-design of the reference SphericalImage
(/root/reference/src/images.rs:24-193): the texture lives on-device as a float
array and direction->color lookup is a batched gather under `jit`, not a
per-pixel method call.  Two filters:

  - ``nearest``  : bit-parity with the reference indexing (images.rs:115-121):
                   y = floor(theta/pi * H),
                   x = floor(((0.5 - phi/2pi) mod 1) * W)   (horizontal flip!)
  - ``bilinear`` : quality mode, differentiable w.r.t. the looked-up direction
                   (the reference has no filtering — README.md notes the
                   aliasing).  Wraps horizontally, clamps vertically.

Orientation: the image can be oriented in world space by a forward/up pair;
world directions are rotated *into* image space with the inverse rotation
(images.rs:132-142) before the (theta, phi) conversion.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from curvis_tpu.geometry import rotations


@dataclasses.dataclass(frozen=True)
class SphericalImage:
    """Texture (H, W, 3) float in [0, 1] + world-space orientation rotation."""

    texture: jax.Array
    rotation: jax.Array           # image->world (3, 3); world->image is R.T

    @property
    def height(self) -> int:
        return self.texture.shape[0]

    @property
    def width(self) -> int:
        return self.texture.shape[1]


jax.tree_util.register_dataclass(
    SphericalImage, data_fields=["texture", "rotation"], meta_fields=[])


def make_spherical_image(texture, forward=None, up=None, dtype=jnp.float32) -> SphericalImage:
    """Build from an (H, W, 3) array (float [0,1] or uint8) and an optional
    orientation (defaults: forward=+x, up=+z; images.rs:71-89)."""
    tex = jnp.asarray(texture)
    if tex.dtype == jnp.uint8:
        tex = tex.astype(dtype) / 255.0
    else:
        tex = tex.astype(dtype)
    if forward is None:
        forward = jnp.array([1.0, 0.0, 0.0], dtype=dtype)
    if up is None:
        up = jnp.array([0.0, 0.0, 1.0], dtype=dtype)
    R = rotations.rotation_from_forward_up(jnp.asarray(forward, dtype=dtype),
                                           jnp.asarray(up, dtype=dtype))
    return SphericalImage(texture=tex, rotation=R)


def load_spherical_image(path, forward=None, up=None, dtype=jnp.float32) -> SphericalImage:
    """Load an image file as a SphericalImage (images.rs:186-193).  PNG is
    read by the built-in codec (utils/png.py); other formats need PIL."""
    return make_spherical_image(read_image(path), forward=forward, up=up,
                                dtype=dtype)


def read_image(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a PNG (built-in codec) or, with PIL
    installed, any format PIL reads."""
    from curvis_tpu.utils import png
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png._SIG:
        return png.read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: {path.suffix or 'this'} images need PIL (not "
            f"installed); PNG is read without it") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def save_image(array01, path):
    """Save an (H, W, 3) float [0,1] array as PNG (built-in codec)."""
    from curvis_tpu.utils import png
    arr = np.asarray(jnp.clip(array01, 0.0, 1.0) * 255.0).astype(np.uint8)
    png.write_png(path, arr)


# ---------------------------------------------------------------------------
# Direction -> texture coordinates
# ---------------------------------------------------------------------------

def direction_to_theta_phi(img: SphericalImage, v_world):
    """World direction -> (theta, phi) in *image* space (images.rs:151-167):
    rotate by the inverse orientation, then spherical angles."""
    # R^{-1} v == v @ R (R orthogonal); full float32, not TF32
    v_img = jnp.matmul(v_world, img.rotation,
                       precision=jax.lax.Precision.HIGHEST)
    return rotations.theta_phi_from_vector3(v_img)


def _uv_from_theta_phi(theta, phi):
    """Continuous texture coordinates in [0,1): u horizontal, v vertical.
    u = (0.5 - phi/2pi) mod 1 (the reference's horizontal flip, images.rs:119),
    v = theta/pi."""
    u = jnp.mod(0.5 - phi / (2.0 * jnp.pi), 1.0)
    v = theta / jnp.pi
    return u, v


def sample_nearest(img: SphericalImage, v_world):
    """Nearest-neighbor lookup, parity with images.rs:115-121. -> (..., 3)"""
    theta, phi = direction_to_theta_phi(img, v_world)
    u, v = _uv_from_theta_phi(theta, phi)
    x = jnp.clip((u * img.width).astype(jnp.int32), 0, img.width - 1)
    y = jnp.clip((v * img.height).astype(jnp.int32), 0, img.height - 1)
    return img.texture[y, x]


def sample_bilinear(img: SphericalImage, v_world):
    """Bilinear lookup: horizontal wrap, vertical pole-reflect (a row beyond
    a pole is the same row half a turn around — no clamped-pole seam);
    differentiable.  Identical formula to render/fast._filter_lookup."""
    theta, phi = direction_to_theta_phi(img, v_world)
    u, v = _uv_from_theta_phi(theta, phi)
    W, H = img.width, img.height
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), W)
    x1i = jnp.mod(x0i + 1, W)

    def pole(yr):
        over = (yr < 0) | (yr > H - 1)
        yc = jnp.clip(jnp.where(yr < 0, -1 - yr, 2 * H - 1 - yr), 0, H - 1)
        yc = jnp.where(over, yc, yr)
        xs = jnp.where(over, W // 2, 0)
        return yc, xs

    y0r = y0.astype(jnp.int32)
    y0c, xs0 = pole(y0r)
    y1c, xs1 = pole(y0r + 1)
    t = img.texture
    top = (t[y0c, jnp.mod(x0i + xs0, W)] * (1.0 - wx)
           + t[y0c, jnp.mod(x1i + xs0, W)] * wx)
    bot = (t[y1c, jnp.mod(x0i + xs1, W)] * (1.0 - wx)
           + t[y1c, jnp.mod(x1i + xs1, W)] * wx)
    return top * (1.0 - wy) + bot * wy


def sample(img: SphericalImage, v_world, *, filtering="nearest"):
    if filtering == "nearest":
        return sample_nearest(img, v_world)
    if filtering == "bilinear":
        return sample_bilinear(img, v_world)
    raise ValueError(f"unknown filtering {filtering!r}")
