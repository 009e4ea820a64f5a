"""SoA fast render pipeline — the production path.

The readable pipeline (render/direct.py) carries vectors as (N, 3) arrays.
This module implements the same math in structure-of-arrays form: every
vector quantity is three separate (N,) arrays, the camera rotation and
radial directions are scalars, and both backgrounds are shaded with a
single row-gather from a concatenated (2*H*W, 3) texture.
Semantics are identical to render_direct (method='planar'); tests assert
agreement.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from curvis_tpu.camera.camera import Camera, camera_rotation
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.metrics.base import Metric
from curvis_tpu.physics import planar as pl


def _pixel_dirs_soa(camera: Camera, center_pixels=False):
    """World-space unit ray directions as three (W*H,) arrays, row-major over
    (x, y) like the reference (systems.rs:405-423)."""
    dtype = camera.position.dtype
    W, H = camera.resolution_x, camera.resolution_y
    # row-band cameras (parallel/distributed.py) expose an offset into the
    # full pixel grid; optics always use the full-image geometry
    H_full = getattr(camera, "full_resolution_y", H)
    row_off = getattr(camera, "row_offset", 0)
    xs = jnp.arange(W, dtype=dtype) + (0.5 if center_pixels else 0.0)
    ys = jnp.arange(H, dtype=dtype) + row_off + (0.5 if center_pixels else 0.0)
    wfrac = xs / W - 0.5
    hfrac = 0.5 - ys / H_full
    aspect = W / H_full
    sh = jnp.sqrt(camera.sensor_diagonal ** 2 / (aspect * aspect + 1.0))
    sw = aspect * sh
    vx = jnp.broadcast_to(camera.focal_length, (W, H))
    vy = jnp.broadcast_to((-sw * wfrac)[:, None], (W, H))
    vz = jnp.broadcast_to((sh * hfrac)[None, :], (W, H))
    inv = jax.lax.rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    R = camera_rotation(camera)
    dx = R[0, 0] * vx + R[0, 1] * vy + R[0, 2] * vz
    dy = R[1, 0] * vx + R[1, 1] * vy + R[1, 2] * vz
    dz = R[2, 0] * vx + R[2, 1] * vy + R[2, 2] * vz
    return dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)


def _dirs_for_pixel_coords(camera: Camera, px, py):
    """World-space unit ray directions for arbitrary FLOAT pixel
    coordinates (N,) px, py — same optics/convention as _pixel_dirs_soa
    (integer coords = pixel corners; +0.5 = centers).  Used by the
    edge-adaptive supersamplers to aim sub-pixel rays."""
    dtype = camera.position.dtype
    W, H = camera.resolution_x, camera.resolution_y
    H_full = getattr(camera, "full_resolution_y", H)
    wfrac = px.astype(dtype) / W - 0.5
    hfrac = 0.5 - py.astype(dtype) / H_full
    aspect = W / H_full
    sh = jnp.sqrt(camera.sensor_diagonal ** 2 / (aspect * aspect + 1.0))
    sw = aspect * sh
    vx = jnp.broadcast_to(camera.focal_length, px.shape).astype(dtype)
    vy = -sw * wfrac
    vz = sh * hfrac
    inv = jax.lax.rsqrt(vx * vx + vy * vy + vz * vz)
    vx, vy, vz = vx * inv, vy * inv, vz * inv
    R = camera_rotation(camera)
    dx = R[0, 0] * vx + R[0, 1] * vy + R[0, 2] * vz
    dy = R[1, 0] * vx + R[1, 1] * vy + R[1, 2] * vz
    dz = R[2, 0] * vx + R[2, 1] * vy + R[2, 2] * vz
    return dx, dy, dz


def _spawn_planar_soa(metric: Metric, camera: Camera, dx, dy, dz):
    """Planar decomposition with scalar camera geometry (physics/planar.py
    semantics, componentwise)."""
    pos = camera.position
    l0, th, ph = pos[1], pos[2], pos[3]
    st, ct = jnp.sin(th), jnp.cos(th)
    sp, cp = jnp.sin(ph), jnp.cos(ph)
    rx, ry, rz = st * cp, st * sp, ct                      # r_hat (scalars)
    cos_a = dx * rx + dy * ry + dz * rz
    cos_a = jnp.clip(cos_a, -1.0, 1.0)
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    # Radial rays: any plane through r_hat works (b = 0) — use theta_hat.
    # Degeneracy MUST be gated on the computed cross norm, not on sin_a:
    # near d = -r_hat, FMA rounding can give cos_a != +-1 (sin_a > 0) while
    # the cross components cancel to exactly 0, and rsqrt(0) * 0 = NaN
    # poisons the ray's plane basis (observed: 1 ray in 960x540).
    fx, fy, fz = ct * cp, ct * sp, -st
    n2 = nx * nx + ny * ny + nz * nz
    deg = n2 < 1e-12
    nn = jax.lax.rsqrt(jnp.where(deg, 1.0, n2))
    nx = jnp.where(deg, fx, nx * nn)
    ny = jnp.where(deg, fy, ny * nn)
    nz = jnp.where(deg, fz, nz * nn)
    e2x = ny * rz - nz * ry
    e2y = nz * rx - nx * rz
    e2z = nx * ry - ny * rx
    b = sin_a * metric.r(l0)
    p_l0 = cos_a
    from curvis_tpu.physics.planar import _unit_lapse
    if not _unit_lapse(metric):
        A0 = metric.lapse(l0)
        B0 = metric.radial_B(l0)
        p_l0 = cos_a * jnp.sqrt(B0 / A0)
        b = b / jnp.sqrt(A0)
    l = jnp.full_like(cos_a, 1.0) * l0
    psi = jnp.zeros_like(cos_a)
    return (l, psi, p_l0, b), (rx, ry, rz), (e2x, e2y, e2z)


def _texture_uv(img: SphericalImage, wx, wy, wz):
    """Continuous equirect coordinates (u, v) in [0,1) from world directions,
    componentwise (images.rs:115-167 semantics)."""
    R = img.rotation
    # world -> image space: v_img = R^T v (componentwise, R scalars)
    ix = R[0, 0] * wx + R[1, 0] * wy + R[2, 0] * wz
    iy = R[0, 1] * wx + R[1, 1] * wy + R[2, 1] * wz
    iz = R[0, 2] * wx + R[1, 2] * wy + R[2, 2] * wz
    inv = jax.lax.rsqrt(ix * ix + iy * iy + iz * iz)
    theta = jnp.arccos(jnp.clip(iz * inv, -1.0, 1.0))
    phi = jnp.arctan2(iy, ix)
    u = jnp.mod(0.5 - phi / (2.0 * jnp.pi), 1.0)
    v = theta / jnp.pi
    return u, v


def _quad_rows(rows, W, H):
    """Pack each texel's bilinear 2x2 neighbourhood (horizontal wrap +
    vertical pole-reflect already resolved) into one (P*(H+1)*W, 12) table:
    row k of a page holds the quads for rays whose floor row y0 = k-1, so
    the 4-gather bilinear readout collapses to ONE row gather of 12
    contiguous floats per ray."""
    P = rows.shape[0] // (W * H)
    T = rows.reshape(P, H, W, 3)

    def pole_np(y):
        over = (y < 0) | (y > H - 1)
        yc = np.clip(np.where(y < 0, -1 - y, 2 * H - 1 - y), 0, H - 1)
        return np.where(over, yc, y), over

    y0v = np.arange(H + 1) - 1
    yt, ot = pole_np(y0v)
    yb, ob = pole_np(y0v + 1)

    def band(yc, over):
        A = T[:, yc]                                  # (P, H+1, W, 3)
        Ar = jnp.roll(A, -(W // 2), axis=2)
        return jnp.where(jnp.asarray(over)[None, :, None, None], Ar, A)

    t0 = band(yt, ot)
    b0 = band(yb, ob)
    q = jnp.concatenate([t0, jnp.roll(t0, -1, axis=2),
                         b0, jnp.roll(b0, -1, axis=2)], axis=-1)
    return q.reshape(P * (H + 1) * W, 12)


def _filter_lookup(rows, base, u, v, W, H, filtering):
    """Gather from (M, 3) texture rows at per-ray base offset + (u, v).
    rows may hold several stacked textures; ``base`` selects the page."""
    if filtering == "nearest":
        xi = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
        return rows[base + yi * W + xi]                    # (N, 3)
    # bilinear: horizontal wrap, vertical pole-reflect — a row beyond a pole
    # maps to the same row half a turn around (y = -1 -> row 0 with x + W/2),
    # removing the clamped-pole seam at extreme up/down views.  The four
    # neighbour fetches ride ONE packed-quad gather (see _quad_rows); the
    # blend arithmetic is bit-identical to the legacy 4-gather form
    # (_filter_lookup_legacy, kept as the test oracle).
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wxf = (fx - x0)[:, None]
    wyf = (fy - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), W)
    k = jnp.clip(y0.astype(jnp.int32) + 1, 0, H)
    page = base // (W * H)
    qrows = _quad_rows(rows, W, H)
    q = qrows[page * ((H + 1) * W) + k * W + x0i]          # (N, 12)
    top = q[:, 0:3] * (1.0 - wxf) + q[:, 3:6] * wxf
    bot = q[:, 6:9] * (1.0 - wxf) + q[:, 9:12] * wxf
    return top * (1.0 - wyf) + bot * wyf


def _filter_lookup_legacy(rows, base, u, v, W, H, filtering):
    """Pre-round-5 form: bilinear as 4 row gathers.
    Kept as the bit-parity oracle for the packed-quad path."""
    if filtering == "nearest":
        xi = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
        return rows[base + yi * W + xi]                # (N, 3)
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wxf = (fx - x0)[:, None]
    wyf = (fy - y0)[:, None]
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
    x0t = jnp.mod(x0i + xs0, W)
    x1t = jnp.mod(x1i + xs0, W)
    x0b = jnp.mod(x0i + xs1, W)
    x1b = jnp.mod(x1i + xs1, W)
    y0i = base + y0c * W
    y1i = base + y1c * W
    top = rows[y0i + x0t] * (1.0 - wxf) + rows[y0i + x1t] * wxf
    bot = rows[y1i + x0b] * (1.0 - wxf) + rows[y1i + x1b] * wxf
    return top * (1.0 - wyf) + bot * wyf


def _shade_soa(img: SphericalImage, wx, wy, wz, filtering):
    """Equirect lookup: SoA index math + row-gathers ((H*W, 3) rows)."""
    u, v = _texture_uv(img, wx, wy, wz)
    rows = img.texture.reshape(-1, 3)
    zero = jnp.zeros_like(u, dtype=jnp.int32)
    return _filter_lookup(rows, zero, u, v, img.width, img.height, filtering)


def render_frames_batched(metric: Metric, cameras, bg_positive: SphericalImage,
                          bg_negative: SphericalImage, *, dt, max_steps,
                          escape_radius, filtering="nearest", backend="auto",
                          center_pixels=False, stepper="euler"):
    """Render several camera poses in ONE device call -> (F, H, W, 3).

    The frame axis is the natural second batch axis of this workload
    (SURVEY.md section 2): all frames' rays concatenate into a single march
    bundle, amortizing dispatch/compile and letting cheap frames subsidize
    expensive ones inside the same kernel tiles.  All cameras must share a
    resolution.
    """
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    per = []
    for cam in cams:
        dx, dy, dz = _pixel_dirs_soa(cam, center_pixels)
        state, r_hat, e2 = _spawn_planar_soa(metric, cam, dx, dy, dz)
        per.append((state, r_hat, e2))
    n = W * H
    l = jnp.concatenate([p[0][0] for p in per])
    psi = jnp.concatenate([p[0][1] for p in per])
    p_l = jnp.concatenate([p[0][2] for p in per])
    b = jnp.concatenate([p[0][3] for p in per])
    # per-frame scalar bases broadcast to their ray ranges
    def chain(idx, comp):
        return jnp.concatenate([
            jnp.broadcast_to(p[idx][comp], (n,)) for p in per])
    rx, ry, rz = chain(1, 0), chain(1, 1), chain(1, 2)
    e2x, e2y, e2z = chain(2, 0), chain(2, 1), chain(2, 2)
    img = _finish_render(metric, cams[0], bg_positive, bg_negative,
                         (l, psi, p_l, b), (rx, ry, rz), (e2x, e2y, e2z),
                         dt=dt, max_steps=max_steps,
                         escape_radius=escape_radius, filtering=filtering,
                         backend=backend, stepper=stepper,
                         n_frames=len(cams))
    return img


def _render_planar_fast_impl(metric, camera, bg_positive, bg_negative, dt,
                             escape_radius, *, max_steps, filtering, backend,
                             center_pixels, stepper, camera_velocity=None):
    dx, dy, dz = _pixel_dirs_soa(camera, center_pixels)
    delta = None
    if camera_velocity is not None:
        # DNGR moving-camera physics: special-relativistic aberration of
        # the pixel directions (camera/camera.py:aberrate_directions) +
        # delta^3 surface-brightness scaling of the received field
        from curvis_tpu.camera.camera import aberrate_directions
        dx, dy, dz, delta = aberrate_directions(dx, dy, dz, camera_velocity)
    state, r_hat, e2 = _spawn_planar_soa(metric, camera, dx, dy, dz)
    img = _finish_render(metric, camera, bg_positive, bg_negative, state,
                         r_hat, e2, dt=dt, max_steps=max_steps,
                         escape_radius=escape_radius, filtering=filtering,
                         backend=backend, stepper=stepper, n_frames=1)
    if delta is not None:
        W, H = camera.resolution_x, camera.resolution_y
        boost = (delta ** 3).reshape(W, H).T[..., None]
        img = jnp.clip(img * boost, 0.0, 1.0)
    return img


_render_planar_fast_jit = jax.jit(
    _render_planar_fast_impl,
    static_argnames=("max_steps", "filtering", "backend", "center_pixels",
                     "stepper"))


def _auto_backend(dtype, stepper):
    """'pallas' (the Euler or RK45 kernel) where the dispatch rule picks
    the GPU kernel, else the XLA march (tiled Euler / RK45 twin)."""
    from curvis_tpu.dispatch import use_kernel
    return "pallas" if (use_kernel(dtype) and stepper in ("euler", "rk45")) \
        else "tiled"


def render_planar_fast(metric: Metric, camera: Camera,
                       bg_positive: SphericalImage,
                       bg_negative: SphericalImage, *, dt, max_steps,
                       escape_radius, filtering="nearest", backend="auto",
                       center_pixels=False, stepper="euler", supersample=1,
                       camera_velocity=None):
    """(H, W, 3) image; SoA throughout.  Self-jitting: eager calls reuse a
    cached compiled bundle; calls from inside jit simply inline.

    ``supersample=k`` renders k x k rays per pixel (centered) and box-filters
    — the anti-aliasing fix for the reference's documented boundary artifacts
    (README.md:108); cost scales with k^2.

    f32 caveat: rays traversing the throat amplify ulp-level rounding
    differences exponentially (the deflection map is chaotic there), so f32
    images differ from f64 in the lensed-disk band at the ~1e-2-angle level
    whichever backend computes them; use f64 on CPU for parity gates.
    """
    if backend == "auto":
        backend = _auto_backend(camera.position.dtype, stepper)
    if supersample > 1:
        import dataclasses
        k = int(supersample)
        big = dataclasses.replace(camera,
                                  resolution_x=camera.resolution_x * k,
                                  resolution_y=camera.resolution_y * k)
        if camera_velocity is not None:
            camera_velocity = jnp.asarray(camera_velocity,
                                          camera.position.dtype)
        img = _render_planar_fast_jit(metric, big, bg_positive, bg_negative,
                                      dt, escape_radius, max_steps=max_steps,
                                      filtering=filtering, backend=backend,
                                      center_pixels=True, stepper=stepper,
                                      camera_velocity=camera_velocity)
        H, W = camera.resolution_y, camera.resolution_x
        return img.reshape(H, k, W, k, 3).mean(axis=(1, 3))
    if camera_velocity is not None:
        camera_velocity = jnp.asarray(camera_velocity,
                                      camera.position.dtype)
    return _render_planar_fast_jit(metric, camera, bg_positive, bg_negative,
                                   dt, escape_radius, max_steps=max_steps,
                                   filtering=filtering, backend=backend,
                                   center_pixels=center_pixels,
                                   stepper=stepper,
                                   camera_velocity=camera_velocity)


def render_planar_fused(metric: Metric, camera: Camera,
                        bg_positive: SphericalImage,
                        bg_negative: SphericalImage, *, dt, max_steps,
                        escape_radius, filtering="nearest", backend="auto",
                        stepper="euler", rtol=1e-4, atol=None, dt_max=10.0,
                        max_iters=None):
    """(H, W, 3) image of one frame: spawn, march and readout, with the
    adaptive stepper's controller exposed — the headline render.

    ``backend='pallas'`` (the dispatch rule's choice on the GPU in
    float32): spawn, march (Euler, or DP5(4) for ``stepper='rk45'``) and
    readout in one kernel (ops/render_fused.py), then the XLA texture
    gather.  Otherwise XLA spawn and readout around the named XLA march
    (``'tiled'``, ``'while'``; ``stepper='rk45'`` takes the XLA DP5(4)).
    ``stepper='rk45'``: ``dt`` is the initial step, ``max_steps`` counts
    accepted steps (pass rk45-scale values), the error is bounded by
    ``rtol`` (``atol`` defaults to ``rtol * 1e-3``)."""
    if backend == "auto":
        backend = _auto_backend(camera.position.dtype, stepper)
    rk45 = None
    if stepper == "rk45":
        rk45 = (rtol, rtol * 1e-3 if atol is None else atol, dt_max,
                4 * max_steps if max_iters is None else int(max_iters))
    return _render_fused_jit(metric, camera, bg_positive, bg_negative, dt,
                             escape_radius, max_steps=max_steps,
                             filtering=filtering, backend=backend,
                             stepper=stepper, rk45=rk45)


@functools.partial(jax.jit, static_argnames=("max_steps", "filtering",
                                             "backend", "stepper", "rk45"))
def _render_fused_jit(metric, camera, bg_positive, bg_negative, dt,
                      escape_radius, *, max_steps, filtering, backend,
                      stepper, rk45):
    if backend == "pallas":
        from curvis_tpu.ops.render_fused import render_fused_pallas
        wx, wy, wz, sign = render_fused_pallas(
            metric, camera, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius,
            rk45=(rk45 if stepper == "rk45" else None))
        return _shade_image(camera, bg_positive, bg_negative, wx, wy, wz,
                            sign, filtering=filtering, n_frames=1)
    dx, dy, dz = _pixel_dirs_soa(camera, False)
    state, r_hat, e2 = _spawn_planar_soa(metric, camera, dx, dy, dz)
    return _finish_render(metric, camera, bg_positive, bg_negative, state,
                          r_hat, e2, dt=dt, max_steps=max_steps,
                          escape_radius=escape_radius, filtering=filtering,
                          backend=backend, stepper=stepper, n_frames=1,
                          rk45=rk45)


def _finish_render(metric, camera, bg_positive, bg_negative, state, r_hat,
                   e2, *, dt, max_steps, escape_radius, filtering, backend,
                   stepper, n_frames, precomputed=None, as_image=True,
                   rk45=None):
    """March + readout + shade + image assembly.  ``r_hat``/``e2`` components
    may be scalars (single frame) or (N,) arrays (frame batches).
    ``backend='precomputed'`` skips the march and shades an existing
    PlanarResult (``precomputed``).  ``rk45``: (rtol, atol, dt_max,
    max_iters) for the adaptive stepper (None: the marchers' defaults)."""
    if backend == "auto":
        backend = _auto_backend(state[0].dtype, stepper)
    if stepper == "rk45" and backend != "precomputed":
        backend = "rk45_pallas" if backend == "pallas" else "rk45"
    l, psi, p_l, b = state
    rx, ry, rz = r_hat
    e2x, e2y, e2z = e2
    rays = pl.PlanarRays(l=l, psi=psi, p_l=p_l, b=b,
                         r_hat=jnp.zeros((1, 3), l.dtype),
                         e2=jnp.zeros((1, 3), l.dtype))
    if backend == "precomputed":
        res = precomputed
    elif backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_planar_pallas
        res = march_planar_pallas(metric, rays, dt=dt, max_steps=max_steps,
                                  escape_radius=escape_radius,
                                  stepper=stepper)
    elif backend in ("rk45_pallas", "rk45"):
        kw45 = dict(escape_radius=escape_radius, dt0=dt, max_steps=max_steps)
        if rk45 is not None:
            kw45.update(zip(("rtol", "atol", "dt_max", "max_iters"), rk45))
        if backend == "rk45_pallas":
            from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
            res = march_planar_rk45_pallas(metric, rays, **kw45)
        else:
            from curvis_tpu.integrate.rk45 import march_planar_rk45
            res = march_planar_rk45(metric, rays, **kw45)
    else:
        res = pl.march_planar_tiled(metric, rays, dt=dt, max_steps=max_steps,
                                    escape_radius=escape_radius,
                                    stepper=stepper)
    # readout: w = cos(beta) r_hat + sin(beta) e2, componentwise
    from curvis_tpu.physics.planar import _unit_lapse
    u_l = res.p_l
    if not _unit_lapse(metric):
        u_l = u_l * jnp.sqrt(metric.lapse(res.l))
    beta = res.psi + jnp.arctan2(b / metric.r(res.l), u_l)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    wx = cb * rx + sb * e2x
    wy = cb * ry + sb * e2y
    wz = cb * rz + sb * e2z
    return _shade_image(camera, bg_positive, bg_negative, wx, wy, wz,
                        res.sign, filtering=filtering, n_frames=n_frames,
                        as_image=as_image)


def _shade_image(camera, bg_positive, bg_negative, wx, wy, wz, sign, *,
                 filtering, n_frames, as_image=True):
    """Texture gather of the escaped rays (sign +-1 picks the universe;
    the rest render black), as an (H, W, 3) image, (N, H, W, 3) frames,
    or flat (n, 3) colors."""
    if bg_positive.texture.shape == bg_negative.texture.shape:
        # Single-gather shading: select (u, v) per ray by escape sign, gather
        # once from the concatenated [positive; negative] texture rows.
        up, vp = _texture_uv(bg_positive, wx, wy, wz)
        un, vn = _texture_uv(bg_negative, wx, wy, wz)
        neg = sign == -1
        u = jnp.where(neg, un, up)
        v = jnp.where(neg, vn, vp)
        H, W = bg_positive.height, bg_positive.width
        rows = jnp.concatenate([bg_positive.texture.reshape(-1, 3),
                                bg_negative.texture.reshape(-1, 3)])
        base = jnp.where(neg, H * W, 0)
        colors = _filter_lookup(rows, base, u, v, W, H, filtering)
    else:
        pos_rgb = _shade_soa(bg_positive, wx, wy, wz, filtering)
        neg_rgb = _shade_soa(bg_negative, wx, wy, wz, filtering)
        s = sign[:, None]
        colors = jnp.where(s == 1, pos_rgb, neg_rgb)
    # not-escaped (0) and captured (2, black-hole shadow) rays render black
    lit = (sign == 1) | (sign == -1)
    colors = jnp.where(lit[:, None], colors, jnp.zeros_like(colors))
    if not as_image:
        return colors
    W, H = camera.resolution_x, camera.resolution_y
    if n_frames == 1:
        return colors.reshape(W, H, 3).transpose(1, 0, 2)
    return colors.reshape(n_frames, W, H, 3).transpose(0, 2, 1, 3)


def _contrast_topk(base, n_refine):
    """(iy, ix) of the ``n_refine`` highest-contrast pixels of an (H, W, 3)
    image — contrast = max |4-neighbor color difference|.  Shared by the
    planar and Kerr edge-adaptive supersamplers."""
    H, W, _ = base.shape
    dx_im = jnp.abs(jnp.diff(base, axis=1)).max(-1)
    dy_im = jnp.abs(jnp.diff(base, axis=0)).max(-1)
    z_col = jnp.zeros((H, 1), base.dtype)
    z_row = jnp.zeros((1, W), base.dtype)
    score = jnp.maximum(
        jnp.maximum(jnp.concatenate([dx_im, z_col], 1),
                    jnp.concatenate([z_col, dx_im], 1)),
        jnp.maximum(jnp.concatenate([dy_im, z_row], 0),
                    jnp.concatenate([z_row, dy_im], 0)))
    _, idx = jax.lax.top_k(score.reshape(-1), n_refine)
    return idx // W, idx % W


def _subpixel_coords(iy, ix, k, n_refine, dtype):
    """Flattened (n_refine * k * k,) float pixel coords of the centered
    k x k sub-grid of each selected pixel."""
    off = (jnp.arange(k, dtype=dtype) + 0.5) / k
    px = jnp.broadcast_to(ix[:, None, None].astype(dtype)
                          + off[None, :, None], (n_refine, k, k)).reshape(-1)
    py = jnp.broadcast_to(iy[:, None, None].astype(dtype)
                          + off[None, None, :], (n_refine, k, k)).reshape(-1)
    return px, py


def render_planar_adaptive(metric: Metric, camera: Camera,
                           bg_positive: SphericalImage,
                           bg_negative: SphericalImage, *, dt, max_steps,
                           escape_radius, filtering="bilinear",
                           backend="auto", stepper="euler", refine_frac=0.1,
                           supersample=3, camera_velocity=None):
    """Edge-adaptive antialiasing for the planar renderers: base render +
    k x k sub-rays for the ``refine_frac`` highest-contrast pixels only
    (lax.top_k -> one static-shape second bundle).  The reference documents
    pixel-boundary artifacts at the wormhole rim as a known limitation
    (README.md:108); full supersampling pays k^2 everywhere, this pays
    1 + refine_frac k^2.  Non-refined pixels are bitwise the base render.
    """
    if backend == "auto":
        backend = _auto_backend(camera.position.dtype, stepper)
    W, H = camera.resolution_x, camera.resolution_y
    n_refine = max(1, int(refine_frac * W * H))
    if camera_velocity is not None:
        camera_velocity = jnp.asarray(camera_velocity,
                                      camera.position.dtype)
    return _render_planar_adaptive_jit(
        metric, camera, bg_positive, bg_negative, jnp.asarray(dt),
        escape_radius, max_steps=max_steps, filtering=filtering,
        backend=backend, stepper=stepper, n_refine=n_refine,
        supersample=int(supersample), camera_velocity=camera_velocity)


_render_planar_adaptive_jit = jax.jit(
    lambda *a, **k: _render_planar_adaptive_impl(*a, **k),
    static_argnames=("max_steps", "filtering", "backend", "stepper",
                     "n_refine", "supersample"))


def _render_planar_adaptive_impl(metric, camera, bg_positive, bg_negative,
                                 dt, escape_radius, *, max_steps, filtering,
                                 backend, stepper, n_refine, supersample,
                                 camera_velocity):
    base = _render_planar_fast_impl(metric, camera, bg_positive, bg_negative,
                                    dt, escape_radius, max_steps=max_steps,
                                    filtering=filtering, backend=backend,
                                    center_pixels=False, stepper=stepper,
                                    camera_velocity=camera_velocity)
    iy, ix = _contrast_topk(base, n_refine)
    k = supersample
    px, py = _subpixel_coords(iy, ix, k, n_refine, base.dtype)
    dxs, dys, dzs = _dirs_for_pixel_coords(camera, px, py)
    delta = None
    if camera_velocity is not None:
        from curvis_tpu.camera.camera import aberrate_directions
        dxs, dys, dzs, delta = aberrate_directions(dxs, dys, dzs,
                                                   camera_velocity)
    state, r_hat, e2 = _spawn_planar_soa(metric, camera, dxs, dys, dzs)
    # march + shade the sub-ray bundle through the same backend, flat colors
    colors = _finish_render(metric, camera, bg_positive, bg_negative, state,
                            r_hat, e2, dt=dt, max_steps=max_steps,
                            escape_radius=escape_radius, filtering=filtering,
                            backend=backend, stepper=stepper, n_frames=1,
                            as_image=False)
    if delta is not None:
        colors = jnp.clip(colors * (delta ** 3)[:, None], 0.0, 1.0)
    refined = colors.reshape(n_refine, k * k, 3).mean(axis=1)
    return base.at[iy, ix].set(refined)
