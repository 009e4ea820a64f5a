"""Symmetry/sampling renderer — parity with the reference's production path.

Re-designs `render_image_efficient` (/root/reference/src/systems.rs:333-527)
for an accelerator: the image is reduced to the 1-D deflection function
alpha -> (escape angle, escape space) on the equatorial plane, sampled
adaptively (each refinement generation of geodesics marched as one batched
device bundle), interpolated onto every pixel's alpha, then reconstructed
per pixel with a Rodrigues rotation — all elementwise SoA math.

Conventions follow the reference *exactly* (for image parity), including:
  - alpha range hardcoded to [-0.1*pi, 1.1*pi] (systems.rs:437-438),
  - per-pixel alpha = acos(d . x_hat) of the camera-tangent direction
    (systems.rs:429-433),
  - the tangent->background identification via the minimal rotation
    x_hat -> r_hat (systems.rs:411),
  - the escape-angle readout formula acos(v_x) with a sign flip on v_y
    (systems.rs:246-252) — an O(b/R) approximation of the exact in-plane
    angle (see physics/planar.py's escape_angle_beta for the exact form,
    available via ``exact_escape_angle=True``),
  - the black seam where the interpolated escape space is not exactly +-1
    (systems.rs:516-520); ``seam='nearest_side'`` instead colors by the
    nearer side (quality mode).

This path renders an HD frame with O(1000) geodesics instead of O(500k) —
it is the one for huge resolutions and video, where the direct path's
per-pixel marching would dominate.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from curvis_tpu.camera.camera import Camera
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.metrics.base import Metric
from curvis_tpu.physics import planar as pl
from curvis_tpu.render.fast import _filter_lookup, _pixel_dirs_soa, _texture_uv
from curvis_tpu.sampling.adaptive import doubly_sample_function

ALPHA_MIN = -0.1 * np.pi      # systems.rs:437
ALPHA_MAX = 1.1 * np.pi       # systems.rs:438


def compute_escape_angles(metric: Metric, l0, alphas, *, dt, max_steps,
                          escape_radius, stepper="euler", backend="auto",
                          exact_escape_angle=False):
    """Batched `compute_escape_angle` (systems.rs:203-261): photons launched
    at (0, l0, pi/2, 0) with in-plane angle alpha; returns (angle, space)
    with space +1/-1 and NaN angle for NotEscaped rays.

    Jit-compatible; alphas is a (n,) array.
    """
    alphas = jnp.asarray(alphas)
    dtype = alphas.dtype
    l0 = jnp.asarray(l0, dtype)
    p_l = jnp.cos(alphas)
    b = jnp.sin(alphas) * metric.r(l0)
    from curvis_tpu.physics.planar import _unit_lapse
    if not _unit_lapse(metric):
        A0 = metric.lapse(l0)
        p_l = p_l * jnp.sqrt(metric.radial_B(l0) / A0)
        b = b / jnp.sqrt(A0)
    rays = pl.PlanarRays(
        l=jnp.full_like(alphas, 1.0) * l0,
        psi=jnp.zeros_like(alphas),
        p_l=p_l, b=b,
        r_hat=jnp.zeros((1, 3), dtype), e2=jnp.zeros((1, 3), dtype))
    from curvis_tpu.dispatch import use_kernel
    if backend == "pallas" or (backend == "auto" and use_kernel(dtype)
                               and stepper == "euler"):
        from curvis_tpu.ops.march_pallas import march_planar_pallas
        res = march_planar_pallas(metric, rays, dt=dt, max_steps=max_steps,
                                  escape_radius=escape_radius,
                                  stepper=stepper)
    else:
        res = pl.march_planar_while(metric, rays, dt=dt, max_steps=max_steps,
                                    escape_radius=escape_radius,
                                    stepper=stepper)
    # tangent direction at escape: (u_l, u_psi) in the photon's plane; the
    # plane here IS the equatorial plane with psi = phi.
    u_l = res.p_l
    if not _unit_lapse(metric):
        u_l = u_l * jnp.sqrt(metric.lapse(res.l))
    u_psi = b / metric.r(res.l)
    if exact_escape_angle:
        angle = jnp.mod(res.psi + jnp.arctan2(u_psi, u_l), 2.0 * jnp.pi)
    else:
        # Reference formula (systems.rs:246-252): rotate (u_l, 0, u_psi) by
        # R(x_hat -> r_hat(pi/2, phi)) = Rz(phi), normalize, then
        # angle = acos(v_x) flipped by sign(v_y).
        inv = jax.lax.rsqrt(u_l * u_l + u_psi * u_psi)
        vx = (u_l * jnp.cos(res.psi)) * inv
        vy = (u_l * jnp.sin(res.psi)) * inv
        a = jnp.arccos(jnp.clip(vx, -1.0, 1.0))
        angle = jnp.where(vy >= 0.0, a, 2.0 * jnp.pi - a)
    nan = jnp.asarray(jnp.nan, dtype)
    angle = jnp.where(res.sign == 0, nan, angle)
    space = jnp.where(res.sign == 0, nan, res.sign.astype(dtype))
    return angle, space


def sample_deflection_function(metric: Metric, l0, *, dt, max_steps,
                               escape_radius, alpha_nums,
                               max_iterations_sampling,
                               threshold_1, threshold_2, stepper="euler",
                               exact_escape_angle=False, dtype=jnp.float64):
    """Adaptively sample alpha -> (escape angle, space) over the reference's
    hardcoded range; returns numpy arrays (alphas, angles, spaces)."""
    fn = jax.jit(lambda a: compute_escape_angles(
        metric, l0, a, dt=dt, max_steps=max_steps,
        escape_radius=escape_radius, stepper=stepper,
        exact_escape_angle=exact_escape_angle))

    # ONE fixed batch size for every generation: each distinct shape would
    # recompile, so all evaluations reuse a single compiled bundle, chunking
    # when a generation exceeds it.
    bucket = max(1024, 1 << (int(alpha_nums) - 1).bit_length())

    def batch(alphas_np):
        n = len(alphas_np)
        if n == 0:
            return np.zeros(0), np.zeros(0)
        es, ss = [], []
        for k in range(0, n, bucket):
            chunk = alphas_np[k:k + bucket]
            padded = np.concatenate(
                [chunk, np.full(bucket - len(chunk), chunk[0])])
            e, s = fn(jnp.asarray(padded, dtype))
            es.append(np.asarray(e)[:len(chunk)])
            ss.append(np.asarray(s)[:len(chunk)])
        return (np.concatenate(es).astype(np.float64),
                np.concatenate(ss).astype(np.float64))

    from curvis_tpu import native
    sampler = (native.doubly_sample_native if native.available()
               else doubly_sample_function)
    return sampler(ALPHA_MIN, ALPHA_MAX, alpha_nums,
                   max_iterations_sampling, threshold_1, threshold_2, batch)


def sample_deflection_function_device(metric: Metric, l0, *, dt, max_steps,
                                      escape_radius, alpha_nums,
                                      max_iterations_sampling,
                                      threshold_1, threshold_2,
                                      stepper="euler",
                                      exact_escape_angle=False,
                                      dtype=jnp.float64, capacity=4096,
                                      march_width=512):
    """On-device counterpart of :func:`sample_deflection_function` — the whole
    refinement loop is one jitted program (sampling/device.py).  Returns numpy
    (alphas, angles, spaces) trimmed to the live count; on CPU f64 the output
    is bit-identical to the host sampler (tested)."""
    from curvis_tpu.sampling.device import doubly_sample_on_device

    @jax.jit
    def run(l0, thr1, thr2):
        def march_fn(a):
            return compute_escape_angles(
                metric, l0, a, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, stepper=stepper,
                exact_escape_angle=exact_escape_angle)
        return doubly_sample_on_device(
            march_fn, ALPHA_MIN, ALPHA_MAX, alpha_nums,
            max_iterations_sampling, thr1, thr2, capacity=capacity,
            march_width=march_width, dtype=dtype)

    a, e, s, n, ovf = run(jnp.asarray(l0, dtype), threshold_1, threshold_2)
    _warn_sampler_overflow(np.asarray(ovf))
    n = int(n)
    return (np.asarray(a[:n], np.float64), np.asarray(e[:n], np.float64),
            np.asarray(s[:n], np.float64))


def _warn_sampler_overflow(ovf):
    """Host-side overflow warning (sampling/device.py returns the flag; a
    True means some refinement pass dropped points — the image is valid but
    less refined than the thresholds asked for)."""
    if np.any(ovf):
        from curvis_tpu.utils.log import get_logger
        get_logger().warning(
            "device sampler hit its capacity/march_width limit; deflection "
            "table is less refined than requested (raise capacity= / "
            "march_width= or loosen the sampling thresholds)")


def _overflow_callback(ovf):
    """Emit the overflow warning from inside jit (a host callback)."""
    jax.debug.callback(_warn_sampler_overflow, ovf, ordered=False)


@functools.partial(jax.jit, static_argnames=(
    "max_steps", "alpha_nums", "max_iterations", "filtering", "seam",
    "center_pixels", "stepper", "exact_escape_angle", "capacity",
    "march_width"))
def _render_symmetric_device(metric, camera, bg_positive, bg_negative, dt,
                             escape_radius, thr1, thr2, *, max_steps,
                             alpha_nums, max_iterations, filtering, seam,
                             center_pixels, stepper, exact_escape_angle,
                             capacity, march_width):
    """Whole symmetric frame — adaptive sampling + reconstruction — as ONE
    jitted program (one device dispatch per frame warm)."""
    from curvis_tpu.sampling.device import doubly_sample_on_device
    dtype = camera.position.dtype
    l0 = camera.position[1]

    def march_fn(a):
        return compute_escape_angles(
            metric, l0, a, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, stepper=stepper,
            exact_escape_angle=exact_escape_angle)

    alphas_s, angles_s, spaces_s, _, ovf = doubly_sample_on_device(
        march_fn, ALPHA_MIN, ALPHA_MAX, alpha_nums, max_iterations,
        thr1, thr2, capacity=capacity, march_width=march_width, dtype=dtype)
    _overflow_callback(ovf)
    return _reconstruct_image(metric, camera, bg_positive, bg_negative,
                              alphas_s, angles_s, spaces_s,
                              filtering=filtering, seam=seam,
                              center_pixels=center_pixels)


@functools.partial(jax.jit, static_argnames=(
    "n_frames", "max_steps", "alpha_nums", "max_iterations", "filtering",
    "seam", "center_pixels", "stepper", "exact_escape_angle", "capacity",
    "march_width"))
def _render_symmetric_frames_device(metric, cams, bg_positive, bg_negative,
                                    dt, escape_radius, thr1, thr2, *,
                                    n_frames, max_steps, alpha_nums,
                                    max_iterations, filtering, seam,
                                    center_pixels, stepper,
                                    exact_escape_angle, capacity,
                                    march_width):
    """F symmetric frames — F adaptive refinements in lock-step, every pass
    marching ONE flat (F*M,) geodesic bundle — as one jitted program.
    ``cams`` is a stacked Camera pytree (leaves have leading F axis)."""
    from curvis_tpu.sampling.device import doubly_sample_on_device_frames
    F = int(n_frames)
    M = int(march_width)
    l0s = cams.position[:, 1]                      # (F,)

    def march_fn(a_flat):
        # frame-major flat bundle: lane k belongs to frame k // M
        l0_flat = jnp.repeat(l0s, M)
        return compute_escape_angles(
            metric, l0_flat, a_flat, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, stepper=stepper,
            exact_escape_angle=exact_escape_angle)

    a, e, s, _, ovf = doubly_sample_on_device_frames(
        march_fn, ALPHA_MIN, ALPHA_MAX, alpha_nums, max_iterations,
        thr1, thr2, n_frames=F, capacity=capacity, march_width=M,
        dtype=cams.position.dtype)
    _overflow_callback(ovf)
    recon = jax.vmap(lambda cam, al, an, sp: _reconstruct_image(
        metric, cam, bg_positive, bg_negative, al, an, sp,
        filtering=filtering, seam=seam, center_pixels=center_pixels))
    return recon(cams, a, e, s)


def render_symmetric_frames_batched(metric: Metric, cameras,
                                    bg_positive: SphericalImage,
                                    bg_negative: SphericalImage, *, dt,
                                    max_steps, escape_radius, alpha_nums=100,
                                    max_iterations_sampling=50,
                                    sampling_convergence_threshold_1=1e-5,
                                    sampling_convergence_threshold_2=1e-5,
                                    filtering="nearest", seam="exact",
                                    exact_escape_angle=False,
                                    center_pixels=False, stepper="euler",
                                    capacity=4096, march_width=512):
    """Render several camera poses via the symmetry reduction in ONE device
    call -> (F, H, W, 3).

    The frame axis is the workload's natural extra batch axis (SURVEY.md
    section 2); batching it through the on-device sampler amortizes the
    per-call dispatch across the whole batch AND fills the card better
    (each refinement pass marches F*M rays instead of M).  All cameras must share a resolution.  Per-frame results
    match :func:`render_symmetric`'s ``sampler='device'`` path to ulp level
    on CPU f64 — identical refinement structure and sample counts; the flat
    F*M march fuses slightly differently than the single-frame M march
    (tested to 1e-12).
    """
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    dtype = stacked.position.dtype
    return _render_symmetric_frames_device(
        metric, stacked, bg_positive, bg_negative,
        jnp.asarray(dt, dtype), jnp.asarray(escape_radius, dtype),
        jnp.asarray(sampling_convergence_threshold_1, dtype),
        jnp.asarray(sampling_convergence_threshold_2, dtype),
        n_frames=len(cams), max_steps=max_steps, alpha_nums=int(alpha_nums),
        max_iterations=int(max_iterations_sampling), filtering=filtering,
        seam=seam, center_pixels=center_pixels, stepper=stepper,
        exact_escape_angle=exact_escape_angle, capacity=int(capacity),
        march_width=int(march_width))


def render_symmetric(metric: Metric, camera: Camera,
                     bg_positive: SphericalImage,
                     bg_negative: SphericalImage, *, dt, max_steps,
                     escape_radius, alpha_nums=100,
                     max_iterations_sampling=50,
                     sampling_convergence_threshold_1=1e-5,
                     sampling_convergence_threshold_2=1e-5,
                     filtering="nearest", seam="exact",
                     exact_escape_angle=False, center_pixels=False,
                     stepper="euler", sampler="auto", dense_n=4096,
                     capacity=4096, march_width=512):
    """(H, W, 3) image via the 1-D symmetry reduction (systems.rs:333-527).

    ``sampler``:
      - 'auto'     : 'device' on the GPU (production), 'adaptive' on CPU
      - 'device'   : reference refinement control flow run on-device — the
                     whole frame is one jitted device call
                     (sampling/device.py)
      - 'adaptive' : the reference's host-driven refinement (~30 sequential
                     device calls per frame; parity oracle for 'device')
      - 'dense'    : one batched march of ``dense_n`` uniform alphas
                     (quality mode for video at fixed resolution)
    """
    dtype = camera.position.dtype
    if sampler == "auto":
        from curvis_tpu.dispatch import platform
        sampler = "adaptive" if platform() == "cpu" else "device"
    if sampler == "device":
        return _render_symmetric_device(
            metric, camera, bg_positive, bg_negative,
            jnp.asarray(dt, dtype), jnp.asarray(escape_radius, dtype),
            jnp.asarray(sampling_convergence_threshold_1, dtype),
            jnp.asarray(sampling_convergence_threshold_2, dtype),
            max_steps=max_steps, alpha_nums=int(alpha_nums),
            max_iterations=int(max_iterations_sampling),
            filtering=filtering, seam=seam, center_pixels=center_pixels,
            stepper=stepper, exact_escape_angle=exact_escape_angle,
            capacity=int(capacity), march_width=int(march_width))
    # ---- Step 3 first (sampling of the 1-D deflection function)
    if sampler == "dense":
        alphas_j = jnp.linspace(ALPHA_MIN, ALPHA_MAX, dense_n, dtype=dtype)
        angles_j, spaces_j = jax.jit(
            lambda a: compute_escape_angles(
                metric, camera.position[1], a, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, stepper=stepper,
                exact_escape_angle=exact_escape_angle))(alphas_j)
        alphas_s = np.asarray(alphas_j, np.float64)
        angles_s = np.asarray(angles_j, np.float64)
        spaces_s = np.asarray(spaces_j, np.float64)
        keep = np.isfinite(angles_s) & np.isfinite(spaces_s)
        alphas_s, angles_s, spaces_s = (alphas_s[keep], angles_s[keep],
                                        spaces_s[keep])
    else:
        alphas_s, angles_s, spaces_s = sample_deflection_function(
            metric, camera.position[1], dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, alpha_nums=alpha_nums,
            max_iterations_sampling=max_iterations_sampling,
            threshold_1=sampling_convergence_threshold_1,
            threshold_2=sampling_convergence_threshold_2,
            exact_escape_angle=exact_escape_angle, dtype=dtype)

    # Bucket-pad the sampled function to a power-of-two length so the jitted
    # reconstruction compiles once per bucket (sample counts vary per frame).
    n = len(alphas_s)
    m = max(256, 1 << (n - 1).bit_length())
    if m > n:
        # strictly-increasing epsilon tail beyond the last sample keeps
        # jnp.interp well-defined and never matches a query (clamped range)
        tail = alphas_s[-1] + np.arange(1, m - n + 1) * 1e-6
        alphas_s = np.concatenate([alphas_s, tail])
        angles_s = np.concatenate([angles_s, np.full(m - n, angles_s[-1])])
        spaces_s = np.concatenate([spaces_s, np.full(m - n, spaces_s[-1])])

    return _reconstruct_jit(
        metric, camera, bg_positive, bg_negative,
        jnp.asarray(alphas_s, dtype), jnp.asarray(angles_s, dtype),
        jnp.asarray(spaces_s, dtype), filtering=filtering, seam=seam,
        center_pixels=center_pixels)


_reconstruct_jit = jax.jit(
    lambda *a, **k: _reconstruct_image(*a, **k),
    static_argnames=("filtering", "seam", "center_pixels"))


def _reconstruct_image(metric, camera, bg_positive, bg_negative, alphas_s,
                       angles_s, spaces_s, *, filtering, seam, center_pixels):
    """Steps 1-2, 4-5 of systems.rs:333-527, SoA and jit-compatible."""
    pos = camera.position
    th, ph = pos[2], pos[3]
    st, ct = jnp.sin(th), jnp.cos(th)
    sp, cp = jnp.sin(ph), jnp.cos(ph)
    rx, ry, rz = st * cp, st * sp, ct            # camera dir on bg space

    # Step 1-2: tangent dirs per pixel; rotate into bg space by the minimal
    # rotation R(x_hat -> r_hat); rotation axis = r_hat x dir_bg; alpha from
    # the *tangent* dir against x_hat (systems.rs:405-433).
    dx, dy, dz = _pixel_dirs_soa(camera, center_pixels)
    R = _rotation_between_xhat(rx, ry, rz, dx.dtype)
    bx = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * dz
    by = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * dz
    bz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * dz
    ax = ry * bz - rz * by
    ay = rz * bx - rx * bz
    az = rx * by - ry * bx
    inv = jax.lax.rsqrt(jnp.maximum(ax * ax + ay * ay + az * az, 1e-30))
    ax, ay, az = ax * inv, ay * inv, az * inv
    img_alpha = jnp.arccos(jnp.clip(dx, -1.0, 1.0))

    # Step 4: 1-D linear interpolation (clamped ends, like interp_slice)
    angle = jnp.interp(img_alpha, alphas_s, angles_s)
    space = jnp.interp(img_alpha, alphas_s, spaces_s)

    # Step 5: rotate r_hat about the per-pixel axis by the escape angle
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    adotr = ax * rx + ay * ry + az * rz
    k = adotr * (1.0 - c)
    wx = rx * c + (ay * rz - az * ry) * s + ax * k
    wy = ry * c + (az * rx - ax * rz) * s + ay * k
    wz = rz * c + (ax * ry - ay * rx) * s + az * k

    if seam == "exact":
        pos_mask = space == 1.0                   # reference: exact match
        neg_mask = space == -1.0                  # (systems.rs:516-520)
    elif seam == "nearest_side":
        ok = jnp.isfinite(space)
        pos_mask = ok & (space >= 0.0)
        neg_mask = ok & (space < 0.0)
    else:
        raise ValueError(f"unknown seam mode {seam!r}")

    up, vp = _texture_uv(bg_positive, wx, wy, wz)
    if bg_positive.texture.shape == bg_negative.texture.shape:
        un, vn = _texture_uv(bg_negative, wx, wy, wz)
        u = jnp.where(neg_mask, un, up)
        v = jnp.where(neg_mask, vn, vp)
        H, W = bg_positive.height, bg_positive.width
        rows = jnp.concatenate([bg_positive.texture.reshape(-1, 3),
                                bg_negative.texture.reshape(-1, 3)])
        base = jnp.where(neg_mask, H * W, 0)
        colors = _filter_lookup(rows, base, u, v, W, H, filtering)
    else:
        cpos = _filter_lookup(bg_positive.texture.reshape(-1, 3),
                              jnp.zeros_like(up, jnp.int32), up, vp,
                              bg_positive.width, bg_positive.height, filtering)
        un, vn = _texture_uv(bg_negative, wx, wy, wz)
        cneg = _filter_lookup(bg_negative.texture.reshape(-1, 3),
                              jnp.zeros_like(un, jnp.int32), un, vn,
                              bg_negative.width, bg_negative.height, filtering)
        colors = jnp.where(neg_mask[:, None], cneg, cpos)
    lit = (pos_mask | neg_mask)[:, None]
    colors = jnp.where(lit, colors, jnp.zeros_like(colors))
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).transpose(1, 0, 2)


def _rotation_between_xhat(rx, ry, rz, dtype):
    """Minimal rotation taking x_hat to (rx, ry, rz) as a (3,3) matrix of
    traced scalars (algebra.rs:92-101 convention)."""
    from curvis_tpu.geometry.rotations import rotation_between
    v1 = jnp.array([1.0, 0.0, 0.0], dtype)
    v2 = jnp.stack([rx, ry, rz])
    return rotation_between(v1, v2)
