"""The fused render kernel: camera spawn, planar march and world-direction
readout in one Pallas program (Triton route, ops/launch.py).

The composition (XLA spawn -> march kernel -> XLA readout) streams the
planar state through device memory twice around the march and runs the
spawn and readout as separate XLA passes.  Here each program takes its
block of pixel indices, builds the camera rays and the planar state in
registers, marches them and writes only (w_x, w_y, w_z, sign) per ray; the
texture gather stays XLA (render/fast.py).  Measured on the H100 against
that composition at equal settings (CHANGES.md): faster by 3-6 % for the
Euler march and 10-20 % for DP5(4), beyond the spread of the runs.

The readout needs no atan2: with gamma the local direction angle
(cos gamma = u_l/|u|, sin gamma = u_psi/|u|) and psi the accumulated plane
angle, cos(beta) = cos psi cos gamma - sin psi sin gamma, etc.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.camera.camera import Camera, camera_rotation
from curvis_tpu.metrics.base import Metric
from curvis_tpu.ops.launch import any_alive, launch
from curvis_tpu.ops.march_pallas import (_DP_A, _DP_B4, _DP_B5, UNROLL,
                                         CHEB_OFF_COMPACT, _atan_poly,
                                         _deriv_fns, _metric_kind_and_params,
                                         _shape_fns)
from curvis_tpu.physics.planar import _unit_lapse

# Row layout: [0:6] the compact march row (dt, R, metric params, capture),
# [6:29] camera and spawn scalars (_row below), [29:32] the DP5(4)
# controller (rtol, atol, dt_max); a table metric's Chebyshev tail follows
# at FUSED_CHEB_OFF.
FUSED_CHEB_OFF = 32


def _readout_u_l(kind, pr, l, p_l):
    if kind == "schwarzschild":
        M = pr[0, 2]
        return p_l * jnp.sqrt(jnp.maximum(1.0 - 2.0 * M / l, 1e-6))
    if kind == "rn":
        M, q2 = pr[0, 2], pr[0, 3]
        A = 1.0 - (2.0 * M - q2 / l) / l
        return p_l * jnp.sqrt(jnp.maximum(A, 1e-6))
    return p_l


def _r_of_l(kind, pr, l):
    if kind == "ellis":
        rho = pr[0, 2]
        return jnp.sqrt(rho * rho + l * l)
    if kind in ("flat", "schwarzschild", "rn"):
        return jnp.abs(l)
    if kind == "interstellar":
        m, a, rho = pr[0, 2], pr[0, 3], pr[0, 4]
        al = jnp.abs(l)
        x = 2.0 * (al - a) / (jnp.pi * m)
        r_out = rho + m * (x * _atan_poly(x) - 0.5 * jnp.log(1.0 + x * x))
        return jnp.where(al > a, r_out, rho)
    if kind.startswith("cheb"):
        inv_r2, _ = _shape_fns(kind, FUSED_CHEB_OFF)(pr, l)
        return lax.rsqrt(jnp.maximum(inv_r2, 1e-30))
    raise NotImplementedError(kind)


def _spawn(pr, H, idx):
    """Camera ray and planar state of pixel ``idx`` (column-major, like
    render/fast.py's _pixel_dirs_soa; the same operation order as its
    _spawn_planar_soa)."""
    focal, sw, sh = pr[0, 6], pr[0, 7], pr[0, 8]
    invW, invH = pr[0, 9], pr[0, 10]
    R00, R01, R02 = pr[0, 11], pr[0, 12], pr[0, 13]
    R10, R11, R12 = pr[0, 14], pr[0, 15], pr[0, 16]
    R20, R21, R22 = pr[0, 17], pr[0, 18], pr[0, 19]
    rx, ry, rz = pr[0, 20], pr[0, 21], pr[0, 22]
    fx, fy, fz = pr[0, 23], pr[0, 24], pr[0, 25]       # degenerate fallback
    l0, s_pl, s_b = pr[0, 26], pr[0, 27], pr[0, 28]

    xpix = idx // H
    ypix = idx - xpix * H
    wfrac = xpix.astype(jnp.float32) * invW - 0.5
    hfrac = 0.5 - ypix.astype(jnp.float32) * invH
    vx = focal + jnp.zeros_like(wfrac)
    vy = -sw * wfrac
    vz = sh * hfrac
    inv = lax.rsqrt(vx * vx + vy * vy + vz * vz)
    vxn, vyn, vzn = vx * inv, vy * inv, vz * inv
    dx = R00 * vxn + R01 * vyn + R02 * vzn
    dy = R10 * vxn + R11 * vyn + R12 * vzn
    dz = R20 * vxn + R21 * vyn + R22 * vzn

    cos_a = jnp.clip(dx * rx + dy * ry + dz * rz, -1.0, 1.0)
    nx = ry * dz - rz * dy
    ny = rz * dx - rx * dz
    nz = rx * dy - ry * dx
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    # gate on the computed cross norm, not sin_a (render/fast.py)
    n2 = nx * nx + ny * ny + nz * nz
    deg = n2 < 1e-12
    nn = lax.rsqrt(jnp.where(deg, 1.0, n2))
    nx = jnp.where(deg, fx, nx * nn)
    ny = jnp.where(deg, fy, ny * nn)
    nz = jnp.where(deg, fz, nz * nn)
    e2 = (ny * rz - nz * ry, nz * rx - nx * rz, nx * ry - ny * rx)
    l = jnp.full_like(cos_a, 1.0) * l0
    return l, jnp.zeros_like(l), cos_a * s_pl, sin_a * s_b, (rx, ry, rz), e2


def _readout(kind, pr, l, psi, p_l, b, r_hat, e2, owx, owy, owz):
    """w = cos(beta) r_hat + sin(beta) e2 without atan2 (module doc)."""
    rx, ry, rz = r_hat
    e2x, e2y, e2z = e2
    u_l = _readout_u_l(kind, pr, l, p_l)
    u_psi = b / _r_of_l(kind, pr, l)
    invu = lax.rsqrt(jnp.maximum(u_l * u_l + u_psi * u_psi, 1e-30))
    cg = u_l * invu
    sg = u_psi * invu
    cp = jnp.cos(psi)
    sp = jnp.sin(psi)
    cb = cp * cg - sp * sg
    sb = sp * cg + cp * sg
    owx[:] = cb * rx + sb * e2x
    owy[:] = cb * ry + sb * e2y
    owz[:] = cb * rz + sb * e2z


def _euler_kernel(kind, H, max_steps, unroll, pr, idx_ref,
                  owx, owy, owz, osign):
    """Spawn + the Euler march of ops/march_pallas._march_kernel (maskless
    sprint, then masked steps) + readout."""
    deriv = _deriv_fns(kind, FUSED_CHEB_OFF)
    dt, R, r_cap = pr[0, 0], pr[0, 1], pr[0, 5]
    l, psi, p_l, b, r_hat, e2 = _spawn(pr, H, idx_ref[:])
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    sign = jnp.zeros_like(l)

    m0 = jnp.max(jnp.abs(l))
    d_free = jnp.minimum(R - m0, jnp.min(l) - r_cap)
    k_free = jnp.floor(d_free / (dt * 1.05) - 2.0).astype(jnp.int32)
    k_free = jnp.clip(k_free, 0, max_steps)
    k_free = (k_free // unroll) * unroll

    def sprint(i, c):
        l, psi, p_l = c
        for _ in range(unroll):
            dl, dpsi, dpl = deriv(pr, l, p_l, b, b2)
            l = l + dt * dl
            psi = psi + dt * dpsi
            p_l = p_l + dt * dpl
        return l, psi, p_l

    l, psi, p_l = lax.fori_loop(0, k_free // unroll, sprint, (l, psi, p_l))

    def cond(c):
        return (c[4] < max_steps) & any_alive(c[3])

    def body(c):
        l, psi, p_l, sign, it = c
        for _ in range(unroll):
            alive = jnp.where(sign == 0.0, one, zero)
            dte = dt * alive
            dl, dpsi, dpl = deriv(pr, l, p_l, b, b2)
            l = l + dte * dl
            psi = psi + dte * dpsi
            p_l = p_l + dte * dpl
            sign = sign + alive * (jnp.where(l > R, one, zero)
                                   - jnp.where(l < -R, one, zero)
                                   + 2.0 * jnp.where(l < r_cap, one, zero))
        return l, psi, p_l, sign, it + unroll

    l, psi, p_l, sign, _ = lax.while_loop(
        cond, body, (l, psi, p_l, sign, k_free))
    _readout(kind, pr, l, psi, p_l, b, r_hat, e2, owx, owy, owz)
    osign[:] = sign.astype(jnp.int32)


def _rk45_kernel(kind, H, max_steps, max_iters, pr, idx_ref,
                 owx, owy, owz, osign):
    """Spawn + the bare adaptive DP5(4) march of
    ops/march_pallas._rk45_kernel + readout; dt floor 1e-6."""
    deriv = _deriv_fns(kind, FUSED_CHEB_OFF)
    dt0, R, r_cap = pr[0, 0], pr[0, 1], pr[0, 5]
    rtol, atol, dt_max = pr[0, 29], pr[0, 30], pr[0, 31]
    l, psi, p_l, b, r_hat, e2 = _spawn(pr, H, idx_ref[:])
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    sign = jnp.zeros_like(l)
    steps = jnp.zeros_like(l)
    dt = jnp.full_like(l, 1.0) * dt0

    def cond(c):
        return (c[-1] < max_iters) & any_alive(c[4])

    def body(c):
        l, psi, p_l, dt, sign, steps, it = c
        alive = jnp.where((sign == 0.0) & (steps < max_steps), one, zero)
        ks = []
        for i in range(7):
            li, pli = l, p_l
            for j, a in enumerate(_DP_A[i]):
                li = li + dt * a * ks[j][0]
                pli = pli + dt * a * ks[j][2]
            ks.append(deriv(pr, li, pli, b, b2))

        def comb(w, comp):
            acc = zero
            for wi, k in zip(w, ks):
                if wi != 0.0:
                    acc = acc + wi * k[comp]
            return acc

        d5l, d5p, d5pl = comb(_DP_B5, 0), comb(_DP_B5, 1), comb(_DP_B5, 2)
        e_l = d5l - comb(_DP_B4, 0)
        e_p = d5p - comb(_DP_B4, 1)
        e_pl = d5pl - comb(_DP_B4, 2)
        l5 = l + dt * d5l
        psi5 = psi + dt * d5p
        pl5 = p_l + dt * d5pl

        def ec(e, y0, y1):
            return jnp.abs(dt * e) / (atol + rtol * jnp.maximum(
                jnp.abs(y0), jnp.abs(y1)))

        err = jnp.maximum(ec(e_l, l, l5),
                          jnp.maximum(ec(e_p, psi, psi5), ec(e_pl, p_l, pl5)))
        accept = alive * jnp.where(err <= 1.0, one, zero)
        esc_pos = accept * jnp.where(l5 > R, one, zero)
        esc_neg = accept * jnp.where(l5 < -R, one, zero)
        esc = esc_pos + esc_neg
        target = jnp.where(esc_pos > 0, R, -R)
        denom = l5 - l
        denom = jnp.where(jnp.abs(denom) < 1e-30, one, denom)
        frac = jnp.clip((target - l) / denom, 0.0, 1.0)
        frac = jnp.where(esc > 0, frac, one)
        l = l + accept * frac * (l5 - l)
        psi = psi + accept * frac * (psi5 - psi)
        p_l = p_l + accept * frac * (pl5 - p_l)
        capd = accept * jnp.where((l < r_cap) & (sign == 0.0), one, zero)
        sign = sign + esc_pos - esc_neg + 2.0 * capd
        steps = steps + accept
        stalled = ((alive > 0) & ~(err <= 1.0) & (dt <= 1e-6 * 1.01)
                   & (sign == 0.0))
        sign = jnp.where(stalled, 3.0, sign)
        err_s = jnp.maximum(err, 1e-10)
        factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
        factor = jnp.where(factor > 0.0, factor, 0.2)
        newdt = jnp.clip(dt * factor, 1e-6, dt_max)
        dt = jnp.where((alive > 0) & (esc == 0.0) & (sign == 0.0), newdt, dt)
        capped = (sign == 0.0) & (steps >= max_steps)
        sign = jnp.where(capped, -128.0, sign)
        return l, psi, p_l, dt, sign, steps, it + 1

    l, psi, p_l, dt, sign, steps, _ = lax.while_loop(
        cond, body, (l, psi, p_l, dt, sign, steps, jnp.int32(0)))
    sign = jnp.where(sign == -128.0, zero, sign)
    _readout(kind, pr, l, psi, p_l, b, r_hat, e2, owx, owy, owz)
    osign[:] = sign.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _fused_call(kind, H, n, max_steps, max_iters, params):
    f, i32 = jnp.float32, jnp.int32
    if max_iters is not None:
        kernel = functools.partial(_rk45_kernel, kind, H, max_steps,
                                   max_iters)
        name = "fused_rk45"
    else:
        unroll = UNROLL
        while max_steps % unroll:    # exact step cap (march_planar_pallas)
            unroll //= 2
        kernel = functools.partial(_euler_kernel, kind, H, max_steps, unroll)
        name = "fused_euler"
    return launch(kernel, params, [jnp.arange(n, dtype=i32)],
                  [f, f, f, i32], name=name)


def _row(metric, camera, dt, escape_radius, rk45):
    dtype = jnp.float32
    pos = camera.position.astype(dtype)
    W, H = camera.resolution_x, camera.resolution_y
    kind, base = _metric_kind_and_params(metric, dt, escape_radius, dtype)
    th, ph = pos[2], pos[3]
    st, ct = jnp.sin(th), jnp.cos(th)
    sp, cp = jnp.sin(ph), jnp.cos(ph)
    r_hat = jnp.stack([st * cp, st * sp, ct])
    th_hat = jnp.stack([ct * cp, ct * sp, -st])
    Rc = camera_rotation(camera).astype(dtype)
    aspect = W / H
    sh = jnp.sqrt(camera.sensor_diagonal.astype(dtype) ** 2
                  / (aspect * aspect + 1.0))
    l0 = pos[1]
    if _unit_lapse(metric):
        s_pl, s_b = jnp.asarray(1.0, dtype), metric.r(l0)
    else:
        A0 = metric.lapse(l0)
        s_pl = jnp.sqrt(metric.radial_B(l0) / A0)
        s_b = metric.r(l0) / jnp.sqrt(A0)
    scal = [base[0, k] for k in range(6)]
    scal += [camera.focal_length.astype(dtype), aspect * sh, sh,
             1.0 / W, 1.0 / H]
    scal += [Rc[i, j] for i in range(3) for j in range(3)]
    scal += [r_hat[0], r_hat[1], r_hat[2], th_hat[0], th_hat[1], th_hat[2],
             l0, s_pl, s_b]
    scal += list(rk45[:3]) if rk45 is not None else [0.0, 0.0, 0.0]
    assert len(scal) == FUSED_CHEB_OFF
    row = jnp.stack([jnp.asarray(v, dtype) for v in scal]).reshape(1, -1)
    if kind.startswith("cheb"):
        row = jnp.concatenate(
            [row, base[:, CHEB_OFF_COMPACT:].astype(dtype)], axis=1)
    return kind, row


def render_fused_pallas(metric: Metric, camera: Camera, *, dt, max_steps,
                        escape_radius, rk45=None):
    """Escape directions and signs of every pixel, each (W*H,) in the
    column-major pixel order of render/fast.py: the fused kernel, float32.
    ``rk45=(rtol, atol, dt_max, max_iters)`` selects the DP5(4) march
    (``dt`` the initial step); None the Euler march."""
    kind, row = _row(metric, camera, dt, escape_radius, rk45)
    W, H = camera.resolution_x, camera.resolution_y
    return _fused_call(kind, H, W * H, int(max_steps),
                       None if rk45 is None else int(rk45[3]), row)
