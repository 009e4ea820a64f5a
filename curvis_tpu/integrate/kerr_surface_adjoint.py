"""Differentiable disk & volumetric Kerr/KN rendering (VERDICT round-4 #1).

Through round 4 gradients stopped at bare marches: no disk or volumetric
surface was differentiable in either metric family, so the framework could
fit background lensing but not the one observable real instruments produce —
a disk image.  This module closes the Kerr half of that gap for BOTH
steppers by extending the checkpointed-recompute adjoints
(integrate/{kerr_adjoint,rk45_adjoint}.py) with larger carried states:

  * **thin disk** — the per-ray state gains the crossing tracker
    ``(ct_prev, h1, h1_phi, h1_side, h2, h2_phi, h2_side)``.  The crossing
    radius/azimuth are *smooth interpolants of the trajectory* (linear in
    the step, ops/march_pallas.py:_kerr_kernel), so d(hit)/d(M, a, q,
    spawn) is exact; the which-step-crossed decisions replay bit-identically
    as data exactly like the rk45 controller decisions do.
  * **volumetric gas** — the state gains the radiative-transfer
    accumulators ``(tau, em_r, em_g, em_b)`` and the differentiated
    parameter tuple gains the 10 emission-row entries (r_in, r_out + the 8
    ``_vol_param_slots``), passed as ONE traced vector consumed by both the
    forward kernel's scalar row and the backward replay — so gradients flow
    to the DISK parameters (r_in/r_out/kappa/h_rel/t_peak/...) through the
    in-march quadrature, everything smooth.

Fate policy (deliberately wider than the bare adjoints): captured (sign 2,
incl. tau_max-opaque) rays are *included* for their hit/tau/em cotangents —
the disk seen in front of the shadow is precisely the signal an EHT-like
inverse problem fits — while their final-state cotangents stay zeroed (the
renderer substitutes the spawn state there anyway).  This is safe because
every step map here uses the bounded-guarded RHS (`_kerr_rhs_guarded`):
frozen near-horizon states evaluate finitely under the mask, and the guards
are bit-transparent wherever they don't bind (sign(x)/max(|x|, eps) has the
bits of 1/x for |x| > eps), which is everywhere above the capture radius —
so replay fidelity for the steps that recorded the hits is preserved.
Blown-up rays (sign 3) stay fully excluded.

Forward = the production marchers (Pallas kernels on the GPU, XLA
while-loops built on the identical step maps elsewhere); backward =
integrate/ckpt.py — the same generic machinery, just with n_state up to
13.

Reference anchor: this generalizes the same recurrence everything else
does, /root/reference/src/metrics.rs:283-297 — which has no disks, no Kerr,
and no gradients.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from curvis_tpu.integrate.adjoint import _ParamRow
from curvis_tpu.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu.integrate.kerr_adjoint import _metric_grads, _q2_of
from curvis_tpu.integrate.rk45_adjoint import _kerr_rhs_guarded
from curvis_tpu.ops.march_pallas import (_DP_A, _DP_B4, _DP_B5,
                                         KERR_SCATTER_OFF,
                                         VOL_BLOCK_KERR, VOL_SLOT,
                                         _kerr_vol_emission)
from curvis_tpu.physics import hamiltonian as ham


# ---------------------------------------------------------------------------
# Traced volumetric parameter row
# ---------------------------------------------------------------------------

def build_vol_row(disk, disk_theta=None, dtype=jnp.float32):
    """The (10,) differentiable emission row [r_in, r_out, h2, inv_norm,
    kappa, tau_max, t_peak, emis_q, spin_sign, t_scale] consumed by the
    volumetric kernels' scalar-row layout (ops/march_pallas._vol_param_slots
    order) — computed with jnp so ``disk_theta`` overrides (a dict of
    traced scalars keyed by DiskParams field names: r_inner, r_outer,
    h_rel, kappa, t_peak, emissivity_index, spin_sign) chain-rule through
    the composite slots (inv_norm, t_scale).  Built ONCE per march so the
    forward scalar row and the backward replay see identical bits."""
    from curvis_tpu.render.disk import DIFF_DISK_KEYS
    ov = disk_theta or {}
    unknown = set(ov) - DIFF_DISK_KEYS
    if unknown:
        raise ValueError(f"disk_theta: non-differentiable or unknown "
                         f"keys {sorted(unknown)}")
    # only the volumetric-march subset rides the emission row; the other
    # DIFF_DISK_KEYS (brightness, opacity, tint, albedo) are shading-only
    # and applied by the renderer's DiskView after the march
    ov = {k: v for k, v in ov.items() if k in
          {"r_inner", "r_outer", "h_rel", "kappa", "t_peak",
           "emissivity_index", "spin_sign"}}

    def get(name):
        return jnp.asarray(ov.get(name, getattr(disk, name)), dtype)

    r_in = get("r_inner")
    r_out = get("r_outer")
    h_rel = get("h_rel")
    kappa = get("kappa")
    t_peak = get("t_peak")
    emis_q = get("emissivity_index")
    spin = get("spin_sign")
    h2 = h_rel * h_rel
    inv_norm = 1.0 / (jnp.sqrt(jnp.asarray(2.0 * np.pi, dtype)) * h_rel)
    rp = (49.0 / 36.0) * r_in                 # Shakura-Sunyaev peak radius
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    t_scale = t_peak / f_peak
    tau_max = jnp.asarray(disk.tau_max, dtype)        # control knob
    row = [r_in, r_out, h2, inv_norm, kappa, tau_max, t_peak, emis_q, spin,
           t_scale]
    # layout sanity: slot order must match _vol_param_slots
    assert [k for k, _ in sorted(VOL_SLOT.items(), key=lambda kv: kv[1])] \
        == ["h2", "inv_norm", "kappa", "tau_max", "t_peak", "emis_q",
            "spin_sign", "t_scale"]
    return jnp.stack(row)


def _vol_param_row_ref(M, a, q2, vol):
    """Duck-typed scalar row for `_kerr_vol_emission`: metric params at slots
    2-4, (r_in, r_out) at 6-7, the 8 emission slots at VOL_BLOCK_KERR+ —
    exactly the Kerr kernels' layout, so the replay runs the identical
    emission algebra on identical values.  A scattering tail (len(vol) >
    10, round 5) rides at KERR_SCATTER_OFF per the kernel contract.
    Returns (row, scatter_off)."""
    slots = {2: M, 3: a, 4: q2, 6: vol[0], 7: vol[1]}
    for i in range(8):
        slots[VOL_BLOCK_KERR + i] = vol[2 + i]
    scatter_off = None
    if len(vol) > 10:
        scatter_off = KERR_SCATTER_OFF
        for i in range(len(vol) - 10):
            slots[KERR_SCATTER_OFF + i] = vol[10 + i]
    return _ParamRow(slots), scatter_off


# ---------------------------------------------------------------------------
# Fixed-step (RK4) extended step maps
# ---------------------------------------------------------------------------

def _rk4_state(dt, axis_u0, far_r0, M, a, q2, E, L, r, th, ph, p_r, p_th):
    """One unmasked RK4 step on the guarded 5-state RHS with the production
    dt scaling — the exact combination order of ops/march_pallas._kerr_kernel
    (and integrate/kerr_adjoint._step5_theta, which uses the unguarded
    RHS)."""
    dte = dt * ham.axis_dt_scale(th, axis_u0) * ham.far_dt_scale(r, far_r0)
    k1 = _kerr_rhs_guarded(M, a, q2, E, L, r, th, p_r, p_th)
    k2 = _kerr_rhs_guarded(M, a, q2, E, L, r + 0.5 * dte * k1[0],
                           th + 0.5 * dte * k1[1], p_r + 0.5 * dte * k1[3],
                           p_th + 0.5 * dte * k1[4])
    k3 = _kerr_rhs_guarded(M, a, q2, E, L, r + 0.5 * dte * k2[0],
                           th + 0.5 * dte * k2[1], p_r + 0.5 * dte * k2[3],
                           p_th + 0.5 * dte * k2[4])
    k4 = _kerr_rhs_guarded(M, a, q2, E, L, r + dte * k3[0],
                           th + dte * k3[1], p_r + dte * k3[3],
                           p_th + dte * k3[4])
    w = dte * (1.0 / 6.0)
    return (dte,
            r + w * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0]),
            th + w * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1]),
            ph + w * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2]),
            p_r + w * (k1[3] + 2.0 * (k2[3] + k3[3]) + k4[3]),
            p_th + w * (k1[4] + 2.0 * (k2[4] + k3[4]) + k4[4]))


def _hit_update(r, ph, r1, ph1, ct_prev, ct, r_in, r_out, hits):
    """Crossing detection + first-two-hit recording, the kernels' exact
    formulas: frac is linear-in-step, side = sign(cos theta before)."""
    h1, h1f, h1d, h2, h2f, h2d = hits
    crossed = ct_prev * ct < 0.0
    den = jnp.abs(ct_prev) + jnp.abs(ct)
    frac = jnp.abs(ct_prev) / jnp.maximum(den, 1e-30)
    r_hit = r + frac * (r1 - r)
    ph_hit = ph + frac * (ph1 - ph)
    side = jnp.where(ct_prev > 0.0, 1.0, -1.0)
    in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
    new1 = in_disk & (h1 == 0.0)
    new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
    return (jnp.where(new1, r_hit, h1), jnp.where(new1, ph_hit, h1f),
            jnp.where(new1, side, h1d), jnp.where(new2, r_hit, h2),
            jnp.where(new2, ph_hit, h2f), jnp.where(new2, side, h2d))


def _disk_step(dt, axis_u0, far_r0, theta, y):
    """Extended 12-state thin-disk step map: y = (r, th, ph, p_r, p_th,
    ct_prev, h1, h1f, h1d, h2, h2f, h2d); theta = (M, a, q2, E, L, r_in,
    r_out)."""
    M, a, q2, E, L, r_in, r_out = theta
    r, th, ph, p_r, p_th, ct_prev = y[:6]
    hits = y[6:]
    _, r1, th1, ph1, pr1, pth1 = _rk4_state(dt, axis_u0, far_r0, M, a, q2,
                                            E, L, r, th, ph, p_r, p_th)
    ct = jnp.cos(th1)
    hits = _hit_update(r, ph, r1, ph1, ct_prev, ct, r_in, r_out, hits)
    return (r1, th1, ph1, pr1, pth1, ct) + hits


def _vol_step(blackbody, beaming, dt, axis_u0, far_r0, theta, y):
    """Extended 9-state volumetric step map: y = (r, th, ph, p_r, p_th,
    tau, em_r, em_g, em_b); theta = (M, a, q2, E, L) + 10 vol-row
    entries.  Emission at the post-step state with the pre-update tau,
    weighted by the scaled dte — the kernel's quadrature exactly."""
    M, a, q2, E, L = theta[:5]
    vol = theta[5:]
    r, th, ph, p_r, p_th, tau, emr, emg, emb = y
    dte, r1, th1, ph1, pr1, pth1 = _rk4_state(dt, axis_u0, far_r0, M, a, q2,
                                              E, L, r, th, ph, p_r, p_th)
    pr_row, sc_off = _vol_param_row_ref(M, a, q2, vol)
    b_ph = L / E
    dtau, dr_, dg_, db_ = _kerr_vol_emission(blackbody, beaming, pr_row,
                                             r1, th1, b_ph, tau,
                                             scatter_off=sc_off)
    # the kernels gate the quadrature on the post-step finiteness check
    # (a blowup step contributes nothing); flags only — ok is always true
    # on included rays' counted steps, so the gradient path is unaffected
    m_chk = lax.stop_gradient(jnp.abs(r1) + jnp.abs(th1) + jnp.abs(ph1)
                              + jnp.abs(pr1) + jnp.abs(pth1))
    ok = m_chk <= 1e8
    zero = jnp.zeros_like(tau)
    return (r1, th1, ph1, pr1, pth1,
            tau + jnp.where(ok, dte * dtau, zero),
            emr + jnp.where(ok, dte * dr_, zero),
            emg + jnp.where(ok, dte * dg_, zero),
            emb + jnp.where(ok, dte * db_, zero))


# ---------------------------------------------------------------------------
# Forward XLA twins (masked while-loops on the identical step maps)
# ---------------------------------------------------------------------------

def _forward_xla_fixed(step_fn, x0, p0, extras0, escape_radius,
                       r_cap, max_steps, opaque_of=None):
    """Masked fixed-step forward on the extended state.  ``opaque_of(y)``
    (vol): a predicate on the post-step extras freezing the ray with sign 2
    (the tau_max rule)."""
    E = -p0[:, 0]
    L = p0[:, 3]
    y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2]) + tuple(extras0)
    n = x0.shape[0]
    sign0 = jnp.zeros(n, jnp.int32)
    steps0 = jnp.zeros(n, jnp.int32)

    def cond(c):
        _, sign, _, it = c
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        y, sign, steps, it = c
        active = sign == 0
        y1 = step_fn(y)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        r, th, ph, p_r, p_th = y[:5]
        m_chk = (jnp.abs(r) + jnp.abs(th) + jnp.abs(ph)
                 + jnp.abs(p_r) + jnp.abs(p_th))
        ok = m_chk <= 1e8
        sign = jnp.where(active & ok & (r > escape_radius), 1, sign)
        sign = jnp.where(active & ok & (r < r_cap), 2, sign)
        sign = jnp.where(active & ~ok, 3, sign)
        if opaque_of is not None:
            sign = jnp.where((sign == 0) & opaque_of(y), 2, sign)
        steps = steps + active.astype(jnp.int32)
        return y, sign, steps, it + 1

    y, sign, steps, _ = lax.while_loop(cond, body,
                                       (y0, sign0, steps0, jnp.int32(0)))
    return y, sign, steps


def _pack_xp(y, E, L):
    zero = jnp.zeros_like(y[0])
    x = jnp.stack([zero, y[0], y[1], y[2]], axis=-1)
    p = jnp.stack([-E, y[3], y[4], L], axis=-1)
    return x, p


# ---------------------------------------------------------------------------
# Fixed-step thin-disk adjoint
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def _disk_core(max_steps, axis_u0, segment, backend, metric, x0, p0, dt,
               escape_radius, far_r0, band):
    out, _ = _disk_fwd(max_steps, axis_u0, segment, backend, metric, x0,
                       p0, dt, escape_radius, far_r0, band)
    return out


def _disk_fwd(max_steps, axis_u0, segment, backend, metric, x0, p0, dt,
              escape_radius, far_r0, band):
    if backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_kerr_pallas
        x, p, sign, steps, (h1, h2) = march_kerr_pallas(
            metric, x0, p0, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, disk=(band[0], band[1]),
            axis_u0=axis_u0, far_r0=far_r0)
    else:
        E = -p0[:, 0]
        L = p0[:, 3]
        theta = (metric.m, metric.a, _q2_of(metric), E, L, band[0], band[1])
        zero = jnp.zeros_like(x0[:, 1])
        extras0 = (jnp.cos(x0[:, 2]),) + (zero,) * 6
        y, sign, steps = _forward_xla_fixed(
            lambda yy: _disk_step(dt, axis_u0, far_r0, theta, yy),
            x0, p0, extras0, escape_radius, metric.capture_radius,
            max_steps)
        x, p = _pack_xp(y, E, L)
        h1, h2 = y[6:9], y[9:12]
    out = (x, p, sign, steps, (h1, h2))
    res = (metric, x0, p0, dt, far_r0, band, sign, steps)
    return out, res


def _disk_bwd(max_steps, axis_u0, segment, backend, res, cot):
    metric, x0, p0, dt, far_r0, band, sign, steps = res
    cot_x, cot_p, _, _, (cot_h1, cot_h2) = cot
    E = -p0[:, 0]
    L = p0[:, 3]
    q2 = _q2_of(metric)
    dtype = x0.dtype

    y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2],
          jnp.cos(x0[:, 2])) + (jnp.zeros_like(x0[:, 1]),) * 6
    # state cotangents: smooth fates only; hit cotangents: every replayable
    # fate (captured rays' crossings are the disk-in-front-of-shadow signal)
    smooth = (sign == 0) | (sign == 1)
    replayable = sign != 3
    zero = jnp.zeros_like(y0[0])
    cot_state = tuple(jnp.where(smooth, c, 0.0) for c in
                      (cot_x[:, 1], cot_x[:, 2], cot_x[:, 3],
                       cot_p[:, 1], cot_p[:, 2])) + (zero,)
    cot_hits = tuple(jnp.where(replayable, c, 0.0)
                     for c in tuple(cot_h1) + tuple(cot_h2))
    cot12 = cot_state + cot_hits
    steps_eff = jnp.where(replayable, steps, 0)

    theta = (metric.m, metric.a, q2, E, L, band[0], band[1])
    step_fn = partial(_disk_step, dt, axis_u0, far_r0)
    d_theta, lam = ckpt_adjoint_backward(
        step_fn, theta, y0, steps_eff, cot12, max_steps=max_steps,
        segment=segment)
    g_m, g_a, g_q2, gE, gL = d_theta[:5]
    g_band = jnp.stack([d_theta[5], d_theta[6]]).astype(band.dtype)

    g_metric = _metric_grads(metric, g_m, g_a, g_q2)
    # ct_prev0 = cos(theta0): its cotangent chain-rules into the spawn theta
    g_th0 = lam[1] + lam[5] * (-jnp.sin(x0[:, 2]))
    g_x0 = jnp.stack([jnp.zeros_like(lam[0]), lam[0], g_th0, lam[2]],
                     axis=-1)
    g_p0 = jnp.stack([cot_p[:, 0] - gE, lam[3], lam[4],
                      cot_p[:, 3] + gL], axis=-1)
    zero_s = jnp.zeros_like(jnp.asarray(dt, dtype))
    return g_metric, g_x0, g_p0, zero_s, zero_s, zero_s, g_band


_disk_core.defvjp(_disk_fwd, _disk_bwd)


def march_kerr_disk_adjoint(metric, x0, p0, *, dt, max_steps, escape_radius,
                            r_inner, r_outer, axis_u0=0.01, far_r0=None,
                            backend="auto", segment=None):
    """Differentiable Kerr/KN thin-disk march: production forward + exact
    checkpointed-recompute backward on the 12-state crossing-tracking map.
    Same contract as march_kerr_pallas(disk=...): (x, p, sign, steps,
    ((h1, h1_phi, h1_side), (h2, h2_phi, h2_side))).  Gradients flow to the
    metric pytree, x0, p0 and (r_inner, r_outer) — the latter a.e. only
    through the smooth shading (the in-band gate itself is discrete)."""
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(x0.dtype) else "xla"
    if segment is None:
        segment = max(1, int(max_steps ** 0.5))
    dtype = x0.dtype
    if far_r0 is None:
        far_r0 = jnp.asarray(1e30, dtype)
    band = jnp.stack([jnp.asarray(r_inner, dtype),
                      jnp.asarray(r_outer, dtype)])
    return _disk_core(max_steps, float(axis_u0), int(segment), backend,
                      metric, x0, p0, jnp.asarray(dt, dtype),
                      jnp.asarray(escape_radius, dtype),
                      jnp.asarray(far_r0, dtype), band)


# ---------------------------------------------------------------------------
# Fixed-step volumetric adjoint
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _vol_core(max_steps, axis_u0, segment, backend, modes, metric, x0, p0,
              dt, escape_radius, far_r0, vol_row):
    out, _ = _vol_fwd(max_steps, axis_u0, segment, backend, modes, metric,
                      x0, p0, dt, escape_radius, far_r0, vol_row)
    return out


def _vol_fwd(max_steps, axis_u0, segment, backend, modes, metric, x0, p0,
             dt, escape_radius, far_r0, vol_row):
    disk_static, blackbody, beaming = modes
    if backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_kerr_pallas
        x, p, sign, steps, (tau, em) = march_kerr_pallas(
            metric, x0, p0, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, vol_disk=disk_static,
            vol_row=vol_row[:10],
            scatter_block=(vol_row[10:] if vol_row.shape[0] > 10
                           else None),
            axis_u0=axis_u0, far_r0=far_r0)
    else:
        E = -p0[:, 0]
        L = p0[:, 3]
        theta = ((metric.m, metric.a, _q2_of(metric), E, L)
                 + tuple(vol_row[i] for i in range(vol_row.shape[0])))
        zero = jnp.zeros_like(x0[:, 1])
        tau_max = vol_row[2 + VOL_SLOT["tau_max"]]
        y, sign, steps = _forward_xla_fixed(
            lambda yy: _vol_step(blackbody, beaming, dt, axis_u0, far_r0,
                                 theta, yy),
            x0, p0, (zero,) * 4, escape_radius, metric.capture_radius,
            max_steps, opaque_of=lambda yy: yy[5] > tau_max)
        x, p = _pack_xp(y, E, L)
        tau, em = y[5], (y[6], y[7], y[8])
    out = (x, p, sign, steps, tau, em)
    res = (metric, x0, p0, dt, far_r0, vol_row, sign, steps)
    return out, res


def _vol_bwd(max_steps, axis_u0, segment, backend, modes, res, cot):
    metric, x0, p0, dt, far_r0, vol_row, sign, steps = res
    _, blackbody, beaming = modes
    cot_x, cot_p, _, _, cot_tau, cot_em = cot
    E = -p0[:, 0]
    L = p0[:, 3]
    q2 = _q2_of(metric)
    dtype = x0.dtype

    zero = jnp.zeros_like(x0[:, 1])
    y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2]) + (zero,) * 4
    smooth = (sign == 0) | (sign == 1)
    replayable = sign != 3
    cot9 = tuple(jnp.where(smooth, c, 0.0) for c in
                 (cot_x[:, 1], cot_x[:, 2], cot_x[:, 3],
                  cot_p[:, 1], cot_p[:, 2])) \
        + tuple(jnp.where(replayable, c, 0.0)
                for c in (cot_tau,) + tuple(cot_em))
    steps_eff = jnp.where(replayable, steps, 0)

    n_row = vol_row.shape[0]
    theta = ((metric.m, metric.a, q2, E, L)
             + tuple(vol_row[i] for i in range(n_row)))
    step_fn = partial(_vol_step, blackbody, beaming, dt, axis_u0,
                      far_r0)
    d_theta, lam = ckpt_adjoint_backward(
        step_fn, theta, y0, steps_eff, cot9, max_steps=max_steps,
        segment=segment)
    g_m, g_a, g_q2, gE, gL = d_theta[:5]
    g_vol = jnp.stack(list(d_theta[5:5 + n_row])).astype(vol_row.dtype)

    g_metric = _metric_grads(metric, g_m, g_a, g_q2)
    g_x0 = jnp.stack([jnp.zeros_like(lam[0]), lam[0], lam[1], lam[2]],
                     axis=-1)
    g_p0 = jnp.stack([cot_p[:, 0] - gE, lam[3], lam[4],
                      cot_p[:, 3] + gL], axis=-1)
    zero_s = jnp.zeros_like(jnp.asarray(dt, dtype))
    return g_metric, g_x0, g_p0, zero_s, zero_s, zero_s, g_vol


_vol_core.defvjp(_vol_fwd, _vol_bwd)


def march_kerr_vol_adjoint(metric, x0, p0, disk, *, dt, max_steps,
                           escape_radius, disk_theta=None,
                           scatter_block=None, axis_u0=0.01,
                           far_r0=None, backend="auto", segment=None):
    """Differentiable Kerr/KN volumetric march: production forward + exact
    checkpointed-recompute backward on the 9-state radiative-transfer map.
    Same contract as march_kerr_pallas(vol_disk=...): (x, p, sign, steps,
    tau, (em_r, em_g, em_b)).  Gradients flow to the metric pytree, x0,
    p0 AND the disk parameters: pass traced overrides in ``disk_theta``
    (see build_vol_row) — the whole gas quadrature is smooth in them."""
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(x0.dtype) else "xla"
    if segment is None:
        segment = max(1, int(max_steps ** 0.5))
    dtype = x0.dtype
    if far_r0 is None:
        far_r0 = jnp.asarray(1e30, dtype)
    vol_row = build_vol_row(disk, disk_theta, dtype)
    if scatter_block is not None:
        # in-gas starlight scattering: the traced block rides the row's
        # tail (kernel contract KERR_SCATTER_OFF), so its cotangents flow
        # back to the disk knobs / map it was built from
        vol_row = jnp.concatenate([vol_row,
                                   jnp.asarray(scatter_block, dtype)])
    modes = (disk, disk.color_mode == "blackbody",
             disk.redshift or disk.doppler)
    return _vol_core(max_steps, float(axis_u0), int(segment), backend,
                     modes, metric, x0, p0, jnp.asarray(dt, dtype),
                     jnp.asarray(escape_radius, dtype),
                     jnp.asarray(far_r0, dtype), vol_row)


# ---------------------------------------------------------------------------
# Error-controlled (rk45) surface step maps — one lock-step DP5(4) iteration
# on the extended state, mirroring ops/march_pallas._kerr_rk45_kernel's
# track_disk/vol blocks exactly (integrate/rk45_adjoint.py is the bare twin)
# ---------------------------------------------------------------------------

def _rk45_surface_iter(consts, theta, y, track_disk, vol, blackbody,
                       beaming, freeze=False):
    """consts = (rtol, atol, dt_min, dt_max, R, r_cap, dt0); theta =
    (M, a, q2, E, L) [+ (r_in, r_out)] [+ 10 vol-row entries]; y =
    (r, th, ph, p_r, p_th, dt) + (ct_prev, 6 hit carries) | (tau, em_rgb).
    Returns (y1, flags)."""
    sg = lax.stop_gradient if freeze else (lambda x: x)
    rtol, atol, dt_min, dt_max, R, r_cap, dt0 = consts
    M, a, q2, E, L = theta[:5]
    if track_disk:
        r_in, r_out = theta[5], theta[6]
    if vol:
        volrow = theta[5:]
        r_in, r_out = volrow[0], volrow[1]
    r, th, ph, p_r, p_th, dt = y[:6]
    ex = y[6:]
    one = jnp.ones_like(r)

    ks = []
    for i in range(7):
        ri, ti, pri, pti = r, th, p_r, p_th
        for j, aa in enumerate(_DP_A[i]):
            ri = ri + dt * aa * ks[j][0]
            ti = ti + dt * aa * ks[j][1]
            pri = pri + dt * aa * ks[j][3]
            pti = pti + dt * aa * ks[j][4]
        ks.append(_kerr_rhs_guarded(M, a, q2, E, L, ri, ti, pri, pti))

    def comb(w, comp):
        acc = jnp.zeros_like(r)
        for wi, k in zip(w, ks):
            if wi != 0.0:
                acc = acc + wi * k[comp]
        return acc

    d5 = [comb(_DP_B5, i) for i in range(5)]
    e = [d5[i] - comb(_DP_B4, i) for i in (0, 1, 3, 4)]
    r1 = r + dt * d5[0]
    th1 = th + dt * d5[1]
    ph1 = ph + dt * d5[2]
    pr1 = p_r + dt * d5[3]
    pth1 = p_th + dt * d5[4]

    def ec(ei, y0, y1_):
        return jnp.abs(dt * ei) / (atol + rtol * jnp.maximum(
            jnp.abs(y0), jnp.abs(y1_)))

    err = jnp.maximum(
        jnp.maximum(ec(e[0], r, r1), ec(e[1], th, th1)),
        jnp.maximum(ec(e[2], p_r, pr1), ec(e[3], p_th, pth1)))
    err = sg(err)
    accept = err <= 1.0
    esc_i = accept & (r1 > R)
    den = r1 - r
    den = jnp.where(jnp.abs(den) < 1e-30, one, den)
    frac = sg((R - r) / den)
    over = esc_i & (frac < 0.9) & (r1 > R * (1.0 + 1e-3))
    accept = accept & ~over
    esc_i = esc_i & ~over

    if track_disk:
        ct_prev = ex[0]
        hits = ex[1:]
        ct = jnp.cos(th1)
        crossed = accept & (ct_prev * ct < 0.0)
        cden = jnp.abs(ct_prev) + jnp.abs(ct)
        cfrac = jnp.abs(ct_prev) / jnp.maximum(cden, 1e-30)
        r_hit = r + cfrac * (r1 - r)
        ph_hit = ph + cfrac * (ph1 - ph)
        side = jnp.where(ct_prev > 0.0, 1.0, -1.0)
        h1, h1f, h1d, h2, h2f, h2d = hits
        in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
        new1 = in_disk & (h1 == 0.0)
        new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        h1 = jnp.where(new1, r_hit, h1)
        h1f = jnp.where(new1, ph_hit, h1f)
        h1d = jnp.where(new1, side, h1d)
        h2 = jnp.where(new2, r_hit, h2)
        h2f = jnp.where(new2, ph_hit, h2f)
        h2d = jnp.where(new2, side, h2d)
        ct_prev = jnp.where(accept, ct, ct_prev)
        ex = (ct_prev, h1, h1f, h1d, h2, h2f, h2d)

    rn = jnp.where(accept, r1, r)
    thn = jnp.where(accept, th1, th)
    phn = jnp.where(accept, ph1, ph)
    prn = jnp.where(accept, pr1, p_r)
    pthn = jnp.where(accept, pth1, p_th)

    m_chk = lax.stop_gradient(jnp.abs(rn) + jnp.abs(thn) + jnp.abs(phn)
                              + jnp.abs(prn) + jnp.abs(pthn))  # flags only
    ok = m_chk <= 1e8

    opaque_i = jnp.zeros_like(accept)
    if vol:
        tau, emr, emg, emb = ex
        pr_row, sc_off = _vol_param_row_ref(M, a, q2, volrow)
        b_ph = L / E
        dtau, dr_, dg_, db_ = _kerr_vol_emission(blackbody, beaming,
                                                 pr_row, rn, thn, b_ph, tau,
                                                 scatter_off=sc_off)
        gate = accept & ok
        zero = jnp.zeros_like(tau)
        emr = emr + jnp.where(gate, dt * dr_, zero)
        emg = emg + jnp.where(gate, dt * dg_, zero)
        emb = emb + jnp.where(gate, dt * db_, zero)
        tau = tau + jnp.where(gate, dt * dtau, zero)
        ex = (tau, emr, emg, emb)
        tau_max = volrow[2 + VOL_SLOT["tau_max"]]

    esc_set = accept & ok & esc_i
    cap_i = accept & ok & (rn < r_cap)
    blow_i = accept & ~ok
    stall_i = ~accept & (dt <= dt_min * 1.01)
    if vol:
        opaque_i = ~(esc_set | cap_i | blow_i) & (ex[0] > tau_max)
    terminal = esc_set | cap_i | blow_i | stall_i | opaque_i
    sign0 = ~terminal

    err_s = jnp.maximum(err, 1e-10)
    factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
    factor = jnp.where(jnp.isfinite(factor), factor, 0.2)
    dt_b = jnp.clip(dt * frac * 1.05, dt_min, dt_max)
    dtn = jnp.where(sign0, jnp.clip(dt * factor, dt_min, dt_max), dt)
    dtn = jnp.where(over & sign0, dt_b, dtn)
    if track_disk:
        # base-resolution clamp inside the disk region (kernel rule)
        near = rn < (r_out + 2.0 * M)
        dtn = jnp.where(near & sign0, jnp.minimum(dtn, dt0), dtn)
    if vol:
        # anticipatory slab-distance clamp (kernel rule)
        s_th = jnp.abs(jnp.sin(thn))
        r_cyl = rn * s_th
        gap_r = r_cyl - (r_out + 2.0 * M)
        h_rel5 = 5.0 * jnp.sqrt(volrow[2 + VOL_SLOT["h2"]])
        gap_z = rn * jnp.abs(jnp.cos(thn)) - h_rel5 * r_cyl
        dt_gas = jnp.maximum(dt0, 0.5 * jnp.maximum(gap_r, gap_z))
        dtn = jnp.where(sign0, jnp.minimum(dtn, dt_gas), dtn)
    dtn = sg(dtn)
    y1 = (rn, thn, phn, prn, pthn, dtn) + ex
    return y1, (accept, esc_set, cap_i, blow_i, stall_i, opaque_i)


def _forward_xla_rk45_surface(consts, theta, x0, p0, extras0, dt0,
                              max_steps, max_iters, track_disk, vol,
                              blackbody, beaming):
    """Masked lock-step rk45 forward on the SAME iter map the backward
    replays (the rk45_adjoint._forward_xla_rk45 pattern, extended)."""
    n = x0.shape[0]
    y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2],
          jnp.full_like(x0[:, 1], dt0)) + tuple(extras0)
    sign0 = jnp.zeros(n, jnp.int32)
    zi = jnp.zeros(n, jnp.int32)

    def cond(c):
        sign = c[1]
        it = c[-1]
        return (it < max_iters) & jnp.any(sign == 0)

    def body(c):
        y, sign, steps, iters, it = c
        active = sign == 0
        iters = iters + active.astype(jnp.int32)
        y1, (accept, esc_set, cap_i, blow_i, stall_i, opaque_i) = \
            _rk45_surface_iter(consts, theta, y, track_disk, vol,
                               blackbody, beaming)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        sign = jnp.where(active & esc_set, 1, sign)
        sign = jnp.where(active & cap_i, 2, sign)
        sign = jnp.where(active & blow_i, 3, sign)
        sign = jnp.where(active & stall_i, 3, sign)
        sign = jnp.where(active & opaque_i & (sign == 0), 2, sign)
        steps = steps + (active & accept).astype(jnp.int32)
        capped = (sign == 0) & (steps >= max_steps)
        sign = jnp.where(capped, -128, sign)
        return y, sign, steps, iters, it + 1

    y, sign, steps, iters, _ = lax.while_loop(
        cond, body, (y0, sign0, zi, zi, jnp.int32(0)))
    sign = jnp.where(sign == -128, 0, sign)
    return y, sign, steps, iters


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _rk45_surf_core(max_steps, max_iters, segment, backend, modes, metric,
                    x0, p0, dt0, consts, surf):
    out, _ = _rk45_surf_fwd(max_steps, max_iters, segment, backend, modes,
                            metric, x0, p0, dt0, consts, surf)
    return out


def _rk45_surf_fwd(max_steps, max_iters, segment, backend, modes, metric,
                   x0, p0, dt0, consts, surf):
    track_disk, disk_static, blackbody, beaming, freeze = modes
    vol = not track_disk
    rtol, atol, dt_min, dt_max, R, _, _ = (consts[i] for i in range(7))
    if backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
        kw = dict(dt0=dt0, max_steps=max_steps, max_iters=max_iters,
                  escape_radius=R, rtol=rtol, atol=atol, dt_min=dt_min,
                  dt_max=dt_max, return_iters=True)
        if track_disk:
            x, p, sign, steps, (h1, h2), iters = march_kerr_rk45_pallas(
                metric, x0, p0, disk=(surf[0], surf[1]), **kw)
            extra = (h1, h2)
        else:
            x, p, sign, steps, (tau, em), iters = march_kerr_rk45_pallas(
                metric, x0, p0, vol_disk=disk_static, vol_row=surf[:10],
                scatter_block=(surf[10:] if surf.shape[0] > 10 else None),
                **kw)
            extra = (tau, em)
    else:
        E = -p0[:, 0]
        L = p0[:, 3]
        theta = ((metric.m, metric.a, _q2_of(metric), E, L)
                 + tuple(surf[i] for i in range(surf.shape[0])))
        zero = jnp.zeros_like(x0[:, 1])
        extras0 = ((jnp.cos(x0[:, 2]),) + (zero,) * 6 if track_disk
                   else (zero,) * 4)
        y, sign, steps, iters = _forward_xla_rk45_surface(
            tuple(consts[i] for i in range(7)), theta, x0, p0, extras0,
            dt0, max_steps, max_iters, track_disk, vol, blackbody, beaming)
        x, p = _pack_xp(y, E, L)
        extra = ((y[7:10], y[10:13]) if track_disk
                 else (y[6], (y[7], y[8], y[9])))
    out = (x, p, sign, steps, extra)
    res = (metric, x0, p0, dt0, consts, surf, sign, iters)
    return out, res


def _rk45_surf_bwd(max_steps, max_iters, segment, backend, modes, res, cot):
    metric, x0, p0, dt0, consts, surf, sign, iters = res
    track_disk, _, blackbody, beaming, freeze = modes
    vol = not track_disk
    cot_x, cot_p, _, _, cot_extra = cot
    E = -p0[:, 0]
    L = p0[:, 3]
    q2 = _q2_of(metric)
    dtype = x0.dtype
    n_surf = surf.shape[0]

    dt0_arr = jnp.full_like(x0[:, 1], dt0)
    zero = jnp.zeros_like(x0[:, 1])
    if track_disk:
        extras0 = (jnp.cos(x0[:, 2]),) + (zero,) * 6
        cot_h1, cot_h2 = cot_extra
        cot_ex = (zero,) + tuple(cot_h1) + tuple(cot_h2)
    else:
        extras0 = (zero,) * 4
        cot_tau, cot_em = cot_extra
        cot_ex = (cot_tau,) + tuple(cot_em)
    y0 = (x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2], dt0_arr) \
        + extras0
    smooth = (sign == 0) | (sign == 1)
    replayable = sign != 3
    cot_state = tuple(jnp.where(smooth, c, 0.0) for c in
                      (cot_x[:, 1], cot_x[:, 2], cot_x[:, 3],
                       cot_p[:, 1], cot_p[:, 2])) + (zero,)   # dt: no cot
    cot_full = cot_state + tuple(jnp.where(replayable, c, 0.0)
                                 for c in cot_ex)
    iters_eff = jnp.where(replayable, iters, 0)
    key = (track_disk, vol, blackbody, beaming, freeze)

    theta = ((metric.m, metric.a, q2, E, L)
             + tuple(surf[i] for i in range(n_surf)))
    cs = tuple(consts[i] for i in range(7))

    def step_fn(th_, y_):
        return _rk45_surface_iter(cs, th_, y_, track_disk, vol,
                                  blackbody, beaming, freeze)[0]
    d_theta, lam = ckpt_adjoint_backward(
        step_fn, theta, y0, iters_eff, cot_full, max_steps=max_iters,
        segment=segment)
    g_m, g_a, g_q2, gE, gL = d_theta[:5]
    g_surf = jnp.stack(list(d_theta[5:5 + n_surf])).astype(surf.dtype)

    g_metric = _metric_grads(metric, g_m, g_a, g_q2)
    g_th0 = lam[1]
    if track_disk:
        g_th0 = g_th0 + lam[6] * (-jnp.sin(x0[:, 2]))   # ct_prev0 chain
    g_x0 = jnp.stack([jnp.zeros_like(lam[0]), lam[0], g_th0, lam[2]],
                     axis=-1)
    g_p0 = jnp.stack([cot_p[:, 0] - gE, lam[3], lam[4],
                      cot_p[:, 3] + gL], axis=-1)
    return (g_metric, g_x0, g_p0,
            jnp.zeros_like(jnp.asarray(dt0, dtype)),
            jnp.zeros_like(jnp.asarray(consts)), g_surf)


_rk45_surf_core.defvjp(_rk45_surf_fwd, _rk45_surf_bwd)


def _rk45_surface_common(metric, x0, p0, *, dt0, max_steps, escape_radius,
                         rtol, atol, dt_min, dt_max, max_iters, backend,
                         segment, freeze_controller, modes, surf):
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(x0.dtype) else "xla"
    if max_iters is None:
        max_iters = 2 * max_steps
    if segment is None:
        segment = max(1, int(max_iters ** 0.5))
    dtype = x0.dtype
    if dt_max is None:
        dt_max = escape_radius / 8.0
    consts = jnp.stack([jnp.asarray(v, dtype) for v in
                        (rtol, atol, dt_min, dt_max, escape_radius,
                         metric.capture_radius, dt0)])
    return _rk45_surf_core(max_steps, int(max_iters), int(segment), backend,
                           modes, metric, x0, p0, jnp.asarray(dt0, dtype),
                           consts, surf)


def march_kerr_rk45_disk_adjoint(metric, x0, p0, *, dt0, max_steps,
                                 escape_radius, r_inner, r_outer, rtol=1e-4,
                                 atol=1e-7, dt_min=1e-5, dt_max=None,
                                 max_iters=None, backend="auto",
                                 segment=None, freeze_controller=False):
    """Differentiable error-controlled Kerr/KN thin-disk march — the rk45
    twin of :func:`march_kerr_disk_adjoint` (same output contract; replay
    bound = max_iters, default 2*max_steps — pass rk45-scale max_steps)."""
    dtype = x0.dtype
    surf = jnp.stack([jnp.asarray(r_inner, dtype),
                      jnp.asarray(r_outer, dtype)])
    modes = (True, None, False, False, bool(freeze_controller))
    return _rk45_surface_common(
        metric, x0, p0, dt0=dt0, max_steps=max_steps,
        escape_radius=escape_radius, rtol=rtol, atol=atol, dt_min=dt_min,
        dt_max=dt_max, max_iters=max_iters, backend=backend,
        segment=segment, freeze_controller=freeze_controller, modes=modes,
        surf=surf)


def march_kerr_rk45_vol_adjoint(metric, x0, p0, disk, *, dt0, max_steps,
                                escape_radius, disk_theta=None,
                                scatter_block=None, rtol=1e-4,
                                atol=1e-7, dt_min=1e-5, dt_max=None,
                                max_iters=None, backend="auto",
                                segment=None, freeze_controller=False):
    """Differentiable error-controlled Kerr/KN volumetric march — the rk45
    twin of :func:`march_kerr_vol_adjoint` (same output contract; disk
    parameter gradients via ``disk_theta``, in-gas starlight via
    ``scatter_block``)."""
    dtype = x0.dtype
    surf = build_vol_row(disk, disk_theta, dtype)
    if scatter_block is not None:
        surf = jnp.concatenate([surf, jnp.asarray(scatter_block, dtype)])
    modes = (False, disk, disk.color_mode == "blackbody",
             disk.redshift or disk.doppler, bool(freeze_controller))
    x, p, sign, steps, (tau, em) = _rk45_surface_common(
        metric, x0, p0, dt0=dt0, max_steps=max_steps,
        escape_radius=escape_radius, rtol=rtol, atol=atol, dt_min=dt_min,
        dt_max=dt_max, max_iters=max_iters, backend=backend,
        segment=segment, freeze_controller=freeze_controller, modes=modes,
        surf=surf)
    return x, p, sign, steps, tau, em
