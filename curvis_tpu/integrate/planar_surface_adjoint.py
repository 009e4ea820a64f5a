"""Differentiable disk & volumetric PLANAR rendering — the planar twin of
integrate/kerr_surface_adjoint.py, completing the (family x stepper x
surface) differentiability matrix (VERDICT round-4 #1).

The reference's own metric family (Ellis/DNEG/flat + the
Schwarzschild/RN/tabulated upgrades) renders disks through the planar
reduction; through round 4 none of those disk images were differentiable.
Here the checkpointed-recompute machinery (integrate/ckpt.py) runs on
extended step maps that mirror the production kernels bit-for-bit:

  * **Euler thin disk** (ops/march_pallas._disk_kernel): state gains the
    incrementally-rotated ``(u, v)`` pair and the two crossing triples
    (r, p_l, psi) — 11-state.
  * **Euler volumetric** (_disk_vol_kernel): state gains ``(u, v)`` and
    the radiative-transfer accumulators — 9-state.
  * **rk45 thin disk / volumetric** (_rk45_kernel track_disk/vol): the
    4-state controller map of integrate/rk45_adjoint_planar.py gains the
    same carries (``zq`` is recomputed from psi, exactly as the kernel's
    carried value), with the kernels' anticipatory plane/slab dt clamps in
    the replayed controller chain.

Differentiated parameters: the metric pytree (incl. Chebyshev tables), the
spawn state (l, psi, p_l), the conserved ``b``, the plane coefficients
``(c1, c2)`` (and ``nz``), and the disk's own emission row — traced
``disk_theta`` overrides ride the same (10,) vector through the forward
scalar row and the backward replay (kerr_surface_adjoint.build_vol_row).

Fate policy matches the Kerr module: captured/opaque (sign 2) rays are
included for hit/tau/em cotangents (guarded derivative closures keep their
frozen-state evaluations finite — integrate/rk45_adjoint_planar.py's
bit-transparency argument), blown-up/stalled (3) rays are excluded, and
final-state cotangents flow only for smooth fates (escaped +-1, capped 0).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.integrate.adjoint import (_ParamRow, _planar_metric_grads,
                                          _table_metric_grads)
from curvis_tpu.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu.integrate.kerr_surface_adjoint import build_vol_row
from curvis_tpu.integrate.rk45_adjoint_planar import _guarded_deriv_fns
from curvis_tpu.ops.march_pallas import (CHEB_OFF_COMPACT, CHEB_OFF_VOL,
                                         SCATTER_BLOCK,
                                         _DP_A, _DP_B4, _DP_B5, _NO_CAPTURE,
                                         _metric_kind_and_params,
                                         _vol_emission)
from curvis_tpu.physics.planar import PlanarRays

# default backward segment lengths (steps / iterations per VJP pull)
_SEG_EULER = 32
_SEG_RK45 = 16


def _n_metric(kind):
    return 1 + 2 * (int(kind[4:-1]) + 1) if kind.startswith("cheb") else 3


def _metric_slots(kind, mp):
    """Duck row for the DERIVATIVE closures (cheb tail at the compact
    offset — a separate row from the emission one, so no slot conflicts)."""
    if kind.startswith("cheb"):
        slots = {2: mp[0]}
        for i in range(len(mp) - 1):
            slots[CHEB_OFF_COMPACT + i] = mp[1 + i]
    else:
        slots = {2: mp[0], 3: mp[1], 4: mp[2]}
    return _ParamRow(slots)


def _emission_slots(kind, mp, surf):
    """Duck row for `_vol_emission` (off=0 layout): metric at 2-4 / cheb at
    CHEB_OFF_VOL, (r_in, r_out) at 6-7, the 8 emission slots at 8-15.

    When ``surf`` carries a scattering tail (len 10 + SCATTER_BLOCK), the
    kernel contract applies: the 27-scalar block rides at CHEB_OFF_VOL and
    the Chebyshev tail shifts up by SCATTER_BLOCK (march_pallas module-top
    contract).  Returns (row, cheb_off, scatter_off)."""
    scatter = len(surf) > 10
    scatter_off = CHEB_OFF_VOL if scatter else None
    cheb_off = CHEB_OFF_VOL + (SCATTER_BLOCK if scatter else 0)
    if kind.startswith("cheb"):
        slots = {2: mp[0]}
        for i in range(len(mp) - 1):
            slots[cheb_off + i] = mp[1 + i]
    else:
        slots = {2: mp[0], 3: mp[1], 4: mp[2]}
    slots[6] = surf[0]
    slots[7] = surf[1]
    for i in range(8):
        slots[8 + i] = surf[2 + i]
    if scatter:
        for i in range(SCATTER_BLOCK):
            slots[CHEB_OFF_VOL + i] = surf[10 + i]
    return _ParamRow(slots), cheb_off, scatter_off


def _unpack_theta(kind, theta, vol):
    nm = _n_metric(kind)
    mp = theta[:nm]
    b, c1, c2 = theta[nm], theta[nm + 1], theta[nm + 2]
    k = nm + 3
    nz = None
    if vol:
        nz = theta[k]
        k += 1
    return mp, b, c1, c2, nz, theta[k:]


def _metric_theta_parts(kind, row, one=None):
    if kind.startswith("cheb"):
        ncoef = 2 * (int(kind[4:-1]) + 1)
        ps = ((row[0, 2],)
              + tuple(row[0, CHEB_OFF_COMPACT + i] for i in range(ncoef)))
    else:
        ps = (row[0, 2], row[0, 3], row[0, 4])
    if one is not None:
        ps = tuple(p * one for p in ps)
    return ps


def _metric_grads_of(kind, metric, gs):
    """Lane-summed metric-slot cotangents -> metric pytree cotangent."""
    if kind.startswith("cheb"):
        return _table_metric_grads(metric, list(gs))
    return _planar_metric_grads(metric, tuple(gs))


# ---------------------------------------------------------------------------
# Euler step maps (mirror _disk_kernel / _disk_vol_kernel per-substep math)
# ---------------------------------------------------------------------------

def _pl_disk_step(kind, dt, theta, y):
    """11-state Euler thin-disk map: y = (l, psi, p_l, u, v, h1, h1p, h1s,
    h2, h2p, h2s) with planar hit triples (r, p_l at crossing, psi at
    crossing) — the render/starlight.py shading contract."""
    mp, b, c1, c2, _, surf = _unpack_theta(kind, theta, vol=False)
    r_in, r_out = surf[0], surf[1]
    deriv = _guarded_deriv_fns(kind)
    pr = _metric_slots(kind, mp)
    l, psi, p_l, u, v, h1, h1p, h1s, h2, h2p, h2s = y
    b2 = b * b
    dl, dpsi, dpl = deriv(pr, l, p_l, b, b2)
    l1 = l + dt * dl
    pl1 = p_l + dt * dpl
    du = dt * dpsi
    u1 = u - v * du
    v1 = v + u * du
    zq = c1 * u + c2 * v
    zq1 = c1 * u1 + c2 * v1
    crossed = zq * zq1 < 0.0
    den = jnp.abs(zq) + jnp.abs(zq1)
    frac = jnp.abs(zq) / jnp.maximum(den, 1e-30)
    lh = l + frac * (l1 - l)          # signed (kernel contract): sheet
    r_hit = jnp.abs(lh)
    pl_hit = p_l + frac * (pl1 - p_l)
    psi_hit = psi + frac * du
    in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
    new1 = in_disk & (h1 == 0.0)
    new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
    h1 = jnp.where(new1, lh, h1)
    h1p = jnp.where(new1, pl_hit, h1p)
    h1s = jnp.where(new1, psi_hit, h1s)
    h2 = jnp.where(new2, lh, h2)
    h2p = jnp.where(new2, pl_hit, h2p)
    h2s = jnp.where(new2, psi_hit, h2s)
    return (l1, psi + dt * dpsi, pl1, u1, v1, h1, h1p, h1s, h2, h2p, h2s)


def _pl_vol_step(kind, blackbody, redshift, doppler, dt, theta, y):
    """9-state Euler volumetric map: y = (l, psi, p_l, u, v, tau, em_rgb)."""
    mp, b, c1, c2, nz, surf = _unpack_theta(kind, theta, vol=True)
    deriv = _guarded_deriv_fns(kind)
    pr = _metric_slots(kind, mp)
    pre = _emission_slots(kind, mp, surf)
    l, psi, p_l, u, v, tau, emr, emg, emb = y
    b2 = b * b
    dl, dpsi, dpl = deriv(pr, l, p_l, b, b2)
    l = l + dt * dl
    psi = psi + dt * dpsi
    p_l = p_l + dt * dpl
    du = dt * dpsi
    u, v = u - v * du, v + u * du
    zq = c1 * u + c2 * v
    pre_row, cheb_off, scatter_off = pre
    dtau, dr_, dg_, db_ = _vol_emission(kind, blackbody, redshift, doppler,
                                        pre_row, l, p_l, b, zq, tau, nz,
                                        cheb_off=cheb_off,
                                        scatter_off=scatter_off)
    return (l, psi, p_l, u, v, tau + dt * dtau, emr + dt * dr_,
            emg + dt * dg_, emb + dt * db_)


_EULER_MAKE_STEP = {}


def _euler_make_step(key):
    """Scalar row = [dt, 0, 0, 0].  key = (kind, 'disk') |
    (kind, 'vol', blackbody, redshift, doppler)."""
    fn = _EULER_MAKE_STEP.get(key)
    if fn is not None:
        return fn
    kind = key[0]
    if key[1] == "disk":
        def make_step(params_ref):
            dt = params_ref[0, 0]

            def step(theta, y):
                return _pl_disk_step(kind, dt, theta, y)
            return step
    else:
        _, _, blackbody, redshift, doppler = key

        def make_step(params_ref):
            dt = params_ref[0, 0]

            def step(theta, y):
                return _pl_vol_step(kind, blackbody, redshift, doppler, dt,
                                    theta, y)
            return step
    _EULER_MAKE_STEP[key] = make_step
    return make_step


# ---------------------------------------------------------------------------
# rk45 surface iteration (mirrors _rk45_kernel's track_disk / vol blocks)
# ---------------------------------------------------------------------------

def _pl_rk45_surface_iter(kind, consts, theta, y, track_disk, vol,
                          blackbody, redshift, doppler, freeze=False):
    """consts = (rtol, atol, dt_min, dt_max, R, r_cap, dt0); y =
    (l, psi, p_l, dt) + hit triples (6) | (tau, em_rgb)."""
    sg = lax.stop_gradient if freeze else (lambda x: x)
    rtol, atol, dt_min, dt_max, R, r_cap, dt0 = consts
    mp, b, c1, c2, nz, surf = _unpack_theta(kind, theta, vol)
    r_in, r_out = surf[0], surf[1]
    deriv = _guarded_deriv_fns(kind)
    pr = _metric_slots(kind, mp)
    b2 = b * b
    l, psi, p_l, dt = y[:4]
    ex = y[4:]
    one = jnp.ones_like(l)

    def rhs(li, pli):
        return deriv(pr, li, pli, b, b2)

    ks = []
    for i in range(7):
        li, pli = l, p_l
        for j, aa in enumerate(_DP_A[i]):
            li = li + dt * aa * ks[j][0]
            pli = pli + dt * aa * ks[j][2]
        ks.append(rhs(li, pli))

    def comb(w, comp):
        acc = jnp.zeros_like(l)
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
    err = sg(err)
    accept = err <= 1.0
    esc_pos = accept & (l5 > R)
    esc_neg = accept & (l5 < -R)
    esc = esc_pos | esc_neg

    target = jnp.where(esc_pos, R, -R)
    denom = l5 - l
    denom = jnp.where(jnp.abs(denom) < 1e-30, one, denom)
    frac = jnp.clip((target - l) / denom, 0.0, 1.0)
    frac = jnp.where(esc, frac, one)
    l_prev, psi_prev, pl_prev = l, psi, p_l
    ln = jnp.where(accept, l + frac * (l5 - l), l)
    psin = jnp.where(accept, psi + frac * (psi5 - psi), psi)
    pln = jnp.where(accept, p_l + frac * (pl5 - p_l), p_l)

    zq_prev = c1 * jnp.cos(psi) + c2 * jnp.sin(psi)
    zq_new = c1 * jnp.cos(psin) + c2 * jnp.sin(psin)
    if track_disk:
        h1, h1p, h1s, h2, h2p, h2s = ex
        crossed = accept & (zq_prev * zq_new < 0.0)
        cden = jnp.abs(zq_prev) + jnp.abs(zq_new)
        cfrac = jnp.abs(zq_prev) / jnp.maximum(cden, 1e-30)
        lh = l_prev + cfrac * (ln - l_prev)      # signed (kernel contract)
        r_hit = jnp.abs(lh)
        pl_hit = pl_prev + cfrac * (pln - pl_prev)
        psi_hit = psi_prev + cfrac * (psin - psi_prev)
        in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        new1 = in_disk & (h1 == 0.0)
        new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        h1 = jnp.where(new1, lh, h1)
        h1p = jnp.where(new1, pl_hit, h1p)
        h1s = jnp.where(new1, psi_hit, h1s)
        h2 = jnp.where(new2, lh, h2)
        h2p = jnp.where(new2, pl_hit, h2p)
        h2s = jnp.where(new2, psi_hit, h2s)
        ex = (h1, h1p, h1s, h2, h2p, h2s)

    opaque_i = jnp.zeros_like(accept)
    if vol:
        tau, emr, emg, emb = ex
        pre, cheb_off_v, scatter_off = _emission_slots(kind, mp, surf)
        dtau, dr_, dg_, db_ = _vol_emission(kind, blackbody, redshift,
                                            doppler, pre, ln, pln, b,
                                            zq_new, tau, nz,
                                            cheb_off=cheb_off_v,
                                            scatter_off=scatter_off)
        zero = jnp.zeros_like(tau)
        emr = emr + jnp.where(accept, dt * dr_, zero)
        emg = emg + jnp.where(accept, dt * dg_, zero)
        emb = emb + jnp.where(accept, dt * db_, zero)
        tau = tau + jnp.where(accept, dt * dtau, zero)
        ex = (tau, emr, emg, emb)
        tau_max = surf[2 + 3]                  # VOL_SLOT['tau_max'] = 3

    cap_i = accept & (ln < r_cap)
    if vol:
        opaque_i = ~(esc | cap_i) & (ex[0] > tau_max)
    stall_i = ~accept & (dt <= dt_min * 1.01)
    terminal = esc | cap_i | stall_i | opaque_i

    err_s = jnp.maximum(err, 1e-10)
    factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
    factor = jnp.where(factor > 0.0, factor, 0.2)
    dtn = jnp.where(terminal, dt, jnp.clip(dt * factor, dt_min, dt_max))
    sign0 = ~terminal
    if vol:
        # anticipatory slab-distance clamp (the kernel's planar-vol rule)
        if kind in ("schwarzschild", "rn"):
            rl = ln
        else:
            from curvis_tpu.ops.march_pallas import _shape_fns
            row_v, cheb_off_v, _ = _emission_slots(kind, mp, surf)
            inv_r2, _ = _shape_fns(kind, cheb_off_v)(row_v, ln)
            rl = lax.rsqrt(jnp.maximum(inv_r2, 1e-30))
        s2v = jnp.clip(1.0 - zq_new * zq_new, 1e-12, 1.0)
        r_cyl = rl * jnp.sqrt(s2v)
        gap_r = r_cyl - (r_out + 2.0)
        h_rel5 = 5.0 * jnp.sqrt(surf[2])               # VOL_SLOT['h2'] = 0
        gap_z = rl * jnp.abs(zq_new) - h_rel5 * r_cyl
        dt_gas = jnp.maximum(dt0, 0.5 * jnp.maximum(gap_r, gap_z))
        dtn = jnp.where(sign0, jnp.minimum(dtn, dt_gas), dtn)
    elif track_disk:
        # anticipatory plane-distance clamp (the kernel's planar-disk rule)
        near = jnp.abs(ln) < (r_out + 2.0)
        dt_pl = jnp.maximum(dt0, 0.2 * jnp.abs(ln) * jnp.abs(zq_new))
        dtn = jnp.where(near & sign0, jnp.minimum(dtn, dt_pl), dtn)
    dtn = sg(dtn)
    y1 = (ln, psin, pln, dtn) + ex
    return y1, (accept, esc_pos, esc_neg, cap_i, stall_i, opaque_i)


_RK45_MAKE_STEP = {}


def _rk45_make_step(key):
    """Scalar row = the 7 consts.  key = (kind, track_disk, vol, blackbody,
    redshift, doppler, freeze)."""
    fn = _RK45_MAKE_STEP.get(key)
    if fn is not None:
        return fn
    kind, track_disk, vol, blackbody, redshift, doppler, freeze = key

    def make_step(params_ref):
        consts = tuple(params_ref[0, i] for i in range(7))

        def step(theta, y):
            return _pl_rk45_surface_iter(kind, consts, theta, y, track_disk,
                                         vol, blackbody, redshift, doppler,
                                         freeze)[0]
        return step

    _RK45_MAKE_STEP[key] = make_step
    return make_step


# ---------------------------------------------------------------------------
# XLA forwards (masked loops on the identical step maps)
# ---------------------------------------------------------------------------

def _forward_xla_euler(step_fn, state0, extras0, escape_radius, r_cap,
                       max_steps, opaque_of=None):
    l0, psi0, pl0 = state0
    y0 = (l0, psi0, pl0) + tuple(extras0)
    sign0 = jnp.zeros_like(l0, dtype=jnp.int32)
    steps0 = jnp.zeros_like(sign0)

    def cond(c):
        _, sign, _, it = c
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        y, sign, steps, it = c
        active = sign == 0
        y1 = step_fn(y)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        ln = y[0]
        sign = jnp.where(active & (ln > escape_radius), 1,
                         jnp.where(active & (ln < -escape_radius), -1, sign))
        sign = jnp.where(active & (ln < r_cap), 2, sign)
        if opaque_of is not None:
            sign = jnp.where((sign == 0) & opaque_of(y), 2, sign)
        steps = steps + active.astype(jnp.int32)
        return y, sign, steps, it + 1

    y, sign, steps, _ = lax.while_loop(cond, body,
                                       (y0, sign0, steps0, jnp.int32(0)))
    return y, sign, steps


def _forward_xla_rk45(kind, consts, theta, state0, dt0, max_steps,
                      max_iters, track_disk, vol, blackbody, redshift,
                      doppler):
    l0, psi0, pl0 = state0
    zero = jnp.zeros_like(l0)
    extras0 = (zero,) * (6 if track_disk else 4)
    y0 = (l0, psi0, pl0, jnp.full_like(l0, dt0)) + extras0
    sign0 = jnp.zeros_like(l0, dtype=jnp.int32)
    zi = jnp.zeros_like(sign0)

    def cond(c):
        sign = c[1]
        it = c[-1]
        return (it < max_iters) & jnp.any(sign == 0)

    def body(c):
        y, sign, steps, iters, it = c
        active = sign == 0
        iters = iters + active.astype(jnp.int32)
        y1, (accept, esc_pos, esc_neg, cap_i, stall_i, opaque_i) = \
            _pl_rk45_surface_iter(kind, consts, theta, y, track_disk, vol,
                                  blackbody, redshift, doppler)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        dsign = (esc_pos.astype(jnp.int32) - esc_neg.astype(jnp.int32)
                 + 2 * cap_i.astype(jnp.int32))
        sign = jnp.where(active, sign + dsign, sign)
        sign = jnp.where(active & opaque_i & (sign == 0), 2, sign)
        sign = jnp.where(active & stall_i, 3, sign)
        steps = steps + (active & accept).astype(jnp.int32)
        capped = (sign == 0) & (steps >= max_steps)
        sign = jnp.where(capped, -128, sign)
        return y, sign, steps, iters, it + 1

    y, sign, steps, iters, _ = lax.while_loop(
        cond, body, (y0, sign0, zi, zi, jnp.int32(0)))
    sign = jnp.where(sign == -128, 0, sign)
    return y, sign, steps, iters


# ---------------------------------------------------------------------------
# custom-VJP cores (shared by euler and rk45; mode tuple dispatches)
# ---------------------------------------------------------------------------

def _r_cap_of(metric, dtype):
    r_cap = getattr(metric, "capture_radius", None)
    return jnp.asarray(_NO_CAPTURE if r_cap is None else r_cap, dtype)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _pl_surf_core(statics, max_steps, max_iters, segment, backend, metric,
                  state, b, c1, c2, nz, dt0, consts, surf):
    out, _ = _pl_surf_fwd(statics, max_steps, max_iters, segment, backend,
                          metric, state, b, c1, c2, nz, dt0, consts, surf)
    return out


def _pl_surf_fwd(statics, max_steps, max_iters, segment, backend, metric,
                 state, b, c1, c2, nz, dt0, consts, surf):
    stepper, track_disk, disk_static, blackbody, redshift, doppler, freeze \
        = statics
    vol = not track_disk
    dtype = state[0].dtype
    R = consts[4]
    kind, row = _metric_kind_and_params(metric, dt0, R, dtype)
    if backend == "pallas":
        rays = PlanarRays(l=state[0], psi=state[1], p_l=state[2], b=b,
                          r_hat=jnp.zeros((1, 3), dtype),
                          e2=jnp.zeros((1, 3), dtype))
        if stepper == "euler":
            if track_disk:
                from curvis_tpu.ops.march_pallas import \
                    march_planar_disk_pallas
                res, h1, h2 = march_planar_disk_pallas(
                    metric, rays, c1, c2, dt=dt0, max_steps=max_steps,
                    escape_radius=R, r_inner=surf[0], r_outer=surf[1])
                extra = (h1, h2)
            else:
                from curvis_tpu.ops.march_pallas import \
                    march_planar_disk_volumetric_pallas
                res, tau, em = march_planar_disk_volumetric_pallas(
                    metric, rays, c1, c2, nz, dt=dt0, max_steps=max_steps,
                    escape_radius=R, disk=disk_static, vol_row=surf[:10],
                    scatter_block=(surf[10:] if surf.shape[0] > 10
                                   else None))
                extra = (tau, em)
            counts = res.steps
        else:
            from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
            kw = dict(escape_radius=R, max_steps=max_steps,
                      max_iters=max_iters, rtol=consts[0], atol=consts[1],
                      dt0=dt0, dt_max=consts[3], c1=c1, c2=c2,
                      return_iters=True)
            if track_disk:
                res, h1, h2, iters = march_planar_rk45_pallas(
                    metric, rays, disk=(surf[0], surf[1]), **kw)
                extra = (h1, h2)
            else:
                res, tau, em, iters = march_planar_rk45_pallas(
                    metric, rays, vol_disk=disk_static, vol_row=surf[:10],
                    scatter_block=(surf[10:] if surf.shape[0] > 10
                                   else None),
                    nz=nz, **kw)
                extra = (tau, em)
            counts = iters
        out = (res.l, res.psi, res.p_l, res.sign, res.steps, extra)
    else:
        one = None
        mps = _metric_theta_parts(kind, row, one)
        theta = mps + ((b, c1, c2, nz) if vol else (b, c1, c2)) \
            + tuple(surf[i] for i in range(surf.shape[0]))
        if stepper == "euler":
            r_cap = _r_cap_of(metric, dtype)
            zero = jnp.zeros_like(state[0])
            if track_disk:
                u0 = jnp.cos(state[1])
                v0 = jnp.sin(state[1])
                extras0 = (u0, v0) + (zero,) * 6
                y, sign, steps = _forward_xla_euler(
                    lambda yy: _pl_disk_step(kind, dt0, theta, yy),
                    state, extras0, R, r_cap, max_steps)
                extra = (y[5:8], y[8:11])
            else:
                tau_max = surf[2 + 3]
                extras0 = (jnp.cos(state[1]), jnp.sin(state[1])) \
                    + (zero,) * 4
                y, sign, steps = _forward_xla_euler(
                    lambda yy: _pl_vol_step(kind, blackbody, redshift,
                                            doppler, dt0, theta, yy),
                    state, extras0, R, r_cap, max_steps,
                    opaque_of=lambda yy: yy[5] > tau_max)
                extra = (y[5], (y[6], y[7], y[8]))
            counts = steps
        else:
            cs = tuple(consts[i] for i in range(7))
            y, sign, steps, iters = _forward_xla_rk45(
                kind, cs, theta, state, dt0, max_steps, max_iters,
                track_disk, vol, blackbody, redshift, doppler)
            extra = ((y[4:7], y[7:10]) if track_disk
                     else (y[4], (y[5], y[6], y[7])))
            counts = iters
        out = (y[0], y[1], y[2], sign, steps, extra)
    res_ = (metric, state, b, c1, c2, nz, dt0, consts, surf, out[3], counts)
    return out, res_


def _pl_surf_bwd(statics, max_steps, max_iters, segment, backend, res, cot):
    stepper, track_disk, disk_static, blackbody, redshift, doppler, freeze \
        = statics
    vol = not track_disk
    metric, state0, b, c1, c2, nz, dt0, consts, surf, sign, counts = res
    dtype = state0[0].dtype
    n_surf = surf.shape[0]
    R = consts[4]
    kind, row = _metric_kind_and_params(metric, dt0, R, dtype)
    nm = _n_metric(kind)

    cot_l, cot_psi, cot_pl, _, _, cot_extra = cot
    zero = jnp.zeros_like(state0[0])
    smooth = (sign == 0) | (sign == 1) | (sign == -1)
    replayable = sign != 3
    cot_state = tuple(jnp.where(smooth, c, 0.0)
                      for c in (cot_l, cot_psi, cot_pl))
    if track_disk:
        cot_h1, cot_h2 = cot_extra
        cot_ex = tuple(jnp.where(replayable, c, 0.0)
                       for c in tuple(cot_h1) + tuple(cot_h2))
    else:
        cot_tau, cot_em = cot_extra
        cot_ex = tuple(jnp.where(replayable, c, 0.0)
                       for c in (cot_tau,) + tuple(cot_em))
    counts_eff = jnp.where(replayable, counts, 0)

    if stepper == "euler":
        u0 = jnp.cos(state0[1])
        v0 = jnp.sin(state0[1])
        zeros_ex = (zero,) * (6 if track_disk else 4)
        y0 = tuple(state0) + (u0, v0) + zeros_ex
        # (u, v) init = (cos psi0, sin psi0): their cotangents chain into
        # psi0 below; they carry no output cotangent themselves
        cot_full = cot_state + (zero, zero) + cot_ex
        replay_bound = max_steps
        key = ((kind, "disk") if track_disk
               else (kind, "vol", blackbody, redshift, doppler))
        make_step = _euler_make_step(key)
        params = jnp.stack([jnp.asarray(v, dtype)
                            for v in (dt0, 0.0, 0.0, 0.0)]).reshape(1, 4)
        seg_default = _SEG_EULER
    else:
        zeros_ex = (zero,) * (6 if track_disk else 4)
        y0 = tuple(state0) + (jnp.full_like(zero, dt0),) + zeros_ex
        cot_full = cot_state + (zero,) + cot_ex       # dt: no cotangent
        replay_bound = max_iters
        key = (kind, track_disk, vol, blackbody, redshift, doppler, freeze)
        make_step = _rk45_make_step(key)
        params = jnp.reshape(consts.astype(dtype), (1, 7))
        seg_default = _SEG_RK45
    seg = segment if segment else seg_default

    mps = _metric_theta_parts(kind, row)
    theta = mps + ((b, c1, c2, nz) if vol else (b, c1, c2)) \
        + tuple(surf[i] for i in range(n_surf))
    stepfn = make_step(params)
    d_theta, lam = ckpt_adjoint_backward(
        lambda th_, y_: stepfn(th_, y_), theta, y0, counts_eff,
        cot_full, max_steps=replay_bound, segment=seg)
    g_metric = _metric_grads_of(kind, metric, list(d_theta[:nm]))
    g_b = d_theta[nm]
    g_c1 = d_theta[nm + 1]
    g_c2 = d_theta[nm + 2]
    g_nz = d_theta[nm + 3] if vol else None
    k0 = nm + (4 if vol else 3)
    g_surf = jnp.stack(list(d_theta[k0:k0 + n_surf])).astype(surf.dtype)

    g_l0 = lam[0]
    g_psi0 = lam[1]
    g_pl0 = lam[2]
    if stepper == "euler":
        # (u0, v0) = (cos, sin)(psi0) chain rule
        g_psi0 = g_psi0 + lam[3] * (-jnp.sin(state0[1])) \
            + lam[4] * jnp.cos(state0[1])
    g_nz_out = g_nz if vol else jnp.zeros_like(c1)
    return (g_metric, (g_l0, g_psi0, g_pl0), g_b, g_c1, g_c2, g_nz_out,
            jnp.zeros_like(jnp.asarray(dt0, dtype)),
            jnp.zeros_like(jnp.asarray(consts)), g_surf)


_pl_surf_core.defvjp(_pl_surf_fwd, _pl_surf_bwd)


def _common(metric, state, b, c1, c2, nz, *, stepper, dt, max_steps,
            escape_radius, r_inner=None, r_outer=None, disk=None,
            disk_theta=None, scatter_block=None, rtol=1e-5, atol=None,
            dt_min=1e-6, dt_max=10.0,
            max_iters=None, backend="auto", segment=None,
            freeze_controller=False):
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(state[0].dtype) else "xla"
    if stepper == "rk45" and backend == "pallas" and dt_min != 1e-6:
        raise ValueError(
            "backend='pallas': the planar rk45 forward kernel hardcodes its "
            "dt floor at 1e-6 (ops/march_pallas._rk45_kernel); the replay "
            "must use the same dt_min or knife-edge stall decisions diverge")
    dtype = state[0].dtype
    if atol is None:
        atol = rtol * 1e-3 if stepper == "rk45" else 1e-7
    if max_iters is None:
        max_iters = 4 * max_steps
    max_iters = int(max_iters) + (int(max_iters) & 1)
    if segment is None:
        segment = 0                        # backend default chosen in bwd
    track_disk = disk is None
    if track_disk:
        surf = jnp.stack([jnp.asarray(r_inner, dtype),
                          jnp.asarray(r_outer, dtype)])
        blackbody = redshift = doppler = False
    else:
        surf = build_vol_row(disk, disk_theta, dtype)
        if scatter_block is not None:
            # in-gas starlight scattering (march_pallas module contract):
            # the traced 27-scalar block rides the surf row's tail, so its
            # cotangents flow back to the disk knobs/map it was built from
            surf = jnp.concatenate([surf,
                                    jnp.asarray(scatter_block, dtype)])
        blackbody = disk.color_mode == "blackbody"
        redshift, doppler = disk.redshift, disk.doppler
    consts = jnp.stack([jnp.asarray(v, dtype) for v in
                        (rtol, atol, dt_min, dt_max, escape_radius,
                         float(_NO_CAPTURE)
                         if getattr(metric, "capture_radius", None) is None
                         else metric.capture_radius, dt)])
    statics = (stepper, track_disk, disk, blackbody, redshift, doppler,
               bool(freeze_controller))
    if nz is None:
        nz = jnp.zeros_like(state[0])
    return _pl_surf_core(statics, int(max_steps), int(max_iters),
                         int(segment), backend, metric, tuple(state), b,
                         c1, c2, nz, jnp.asarray(dt, dtype), consts, surf)


def march_planar_disk_adjoint(metric, state, b, c1, c2, *, dt, max_steps,
                              escape_radius, r_inner, r_outer,
                              stepper="euler", **kw):
    """Differentiable planar thin-disk march (Euler or rk45): production
    forward + checkpointed-recompute backward on the crossing-tracking
    state.  ``state = (l, psi, p_l)``; returns (l, psi, p_l, sign, steps,
    ((h1, h1_pl, h1_psi), (h2, h2_pl, h2_psi))) — the
    march_planar_disk contract.  Gradients flow to the metric pytree
    (incl. Chebyshev tables), the spawn state, b, (c1, c2) and the
    recording band (a.e. zero through the gate)."""
    return _common(metric, state, b, c1, c2, None, stepper=stepper, dt=dt,
                   max_steps=max_steps, escape_radius=escape_radius,
                   r_inner=r_inner, r_outer=r_outer, **kw)


def march_planar_vol_adjoint(metric, state, b, c1, c2, nz, disk, *, dt,
                             max_steps, escape_radius, disk_theta=None,
                             scatter_block=None, stepper="euler", **kw):
    """Differentiable planar volumetric march (Euler or rk45): returns
    (l, psi, p_l, sign, steps, (tau, (em_r, em_g, em_b))).  Traced disk
    parameters via ``disk_theta`` (kerr_surface_adjoint.build_vol_row);
    ``scatter_block``: traced (SCATTER_BLOCK,) in-gas starlight
    coefficients (render/starlight.starlight_scatter_block) enabling the
    differentiable single-scattering source term."""
    return _common(metric, state, b, c1, c2, nz, stepper=stepper, dt=dt,
                   max_steps=max_steps, escape_radius=escape_radius,
                   disk=disk, disk_theta=disk_theta,
                   scatter_block=scatter_block, **kw)
