"""Differentiable error-controlled PLANAR marching — the planar twin of
integrate/rk45_adjoint.py, completing the stepper x gradient matrix for the
reference's own metric family (round-4: the Kerr family got this first;
planar rk45 was the last forward-only cell).

One lock-step DP5(4) iteration of the planar system (7 trial stages on
``(l, p_l)``, 3-component error estimate, accept writeback with the
*escape-radius interpolation*, controller dt update — exactly the
per-iteration semantics of ops/march_pallas._rk45_kernel) is a fixed
smooth-a.e. map on the extended per-ray state ``(l, psi, p_l, dt)``.  The
forward marchers count per-ray iterations (accepted + rejected,
``return_iters=True``), so the checkpointed-recompute machinery of
integrate/ckpt.py applies unchanged with
``steps = iters`` and ``step_fn`` = one iteration: the replay recovers every
controller decision bit-identically as data.

Differences from the Kerr pair worth knowing:

  * **No landing-overshoot systematic.** The planar forward *interpolates*
    the escaping step to ``|l| = R`` (integrate/rk45.py docstring), so the
    escape state is exactly on the readout sphere and the interpolation
    coefficient ``frac`` is part of the differentiated map — the ~6%
    dt-sensitivity the Kerr module documents does not exist here.
    ``freeze_controller=True`` still stop_gradients the err -> factor -> dt
    chain (step sizes as data) but keeps ``frac`` differentiable: it is a
    state readout, not a controller decision.
  * **Capture exclusion** follows the planar Euler adjoint
    (integrate/adjoint.py): captured (sign 2) and stalled/blown-up (sign 3)
    rays get zero cotangent and a zeroed replay; escaped (+-1) and
    step-capped (0) rays carry exact gradients.
  * The Pallas forward kernel hardcodes its dt floor at 1e-6
    (ops/march_pallas._rk45_kernel), so ``backend='pallas'`` requires
    ``dt_min=1e-6`` (the default) — the replay must clip dt with the same
    floor or knife-edge stall decisions would diverge.

NaN-safety mirrors the Kerr pair: the replay *evaluates* trial stages on
every masked state, and a wildly-overshooting rejected trial can cross the
horizon (``A = 0``) or the origin (``1/l``) where raw reciprocals produce
inf partials that poison the VJP through the zero-cotangent branch
(0 * inf = NaN).  :func:`_guarded_deriv_fns` therefore bounds the state and
guards every reciprocal — bit-identical to ops/march_pallas._deriv_fns
whenever no guard binds (``sign(x)/max(|x|, eps)`` has the same bits as
``1/x`` for ``|x| > eps``), and a trial a guard binds on has an astronomical
error estimate in both twins, so accept/reject parity holds.

Reference context: /root/reference has neither adaptive stepping nor
gradients; its fixed recurrence (src/metrics.rs:283-297) is the map both
upgrades generalize — here they compose for the planar family too.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from curvis_tpu.integrate.adjoint import (_ParamRow, _planar_metric_grads,
                                          _table_metric_grads)
from curvis_tpu.integrate.ckpt import ckpt_adjoint_backward
from curvis_tpu.ops.march_pallas import (CHEB_OFF_COMPACT, _DP_A, _DP_B4,
                                         _DP_B5, _NO_CAPTURE,
                                         _metric_kind_and_params)
from curvis_tpu.physics.planar import PlanarRays, PlanarResult

def _guarded_deriv_fns(kind):
    """ops/march_pallas._deriv_fns with bounded inputs + guarded
    reciprocals: finite outputs AND finite VJP partials for ANY finite
    state even in f32 (module docstring).  Same operation grouping as the
    unguarded closures, so off-guard evaluations are bit-identical."""
    if kind == "schwarzschild":
        def fns(pr, l, p_l, b, b2):
            M = pr[0, 2]
            l = jnp.clip(l, -1e4, 1e4)
            p_l = jnp.clip(p_l, -1e4, 1e4)
            invl = jnp.sign(l) / jnp.maximum(jnp.abs(l), 1e-4)
            invl2 = invl * invl
            A = 1.0 - 2.0 * M * invl
            invA = jnp.sign(A) / jnp.maximum(jnp.abs(A), 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-M * invl2) * (invA * invA + p_l * p_l) + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    if kind == "rn":
        def fns(pr, l, p_l, b, b2):
            M, q2 = pr[0, 2], pr[0, 3]
            l = jnp.clip(l, -1e4, 1e4)
            p_l = jnp.clip(p_l, -1e4, 1e4)
            invl = jnp.sign(l) / jnp.maximum(jnp.abs(l), 1e-4)
            invl2 = invl * invl
            A = 1.0 - (2.0 * M - q2 * invl) * invl
            invA = jnp.sign(A) / jnp.maximum(jnp.abs(A), 1e-4)
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-(M - q2 * invl) * invl2) * (invA * invA + p_l * p_l) \
                + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    if kind == "ellis":
        def fns(pr, l, p_l, b, b2):
            rho = pr[0, 2]
            l = jnp.clip(l, -1e4, 1e4)
            r2 = rho * rho + l * l
            inv = 1.0 / jnp.maximum(r2, 1e-12)
            return p_l, b * inv, b2 * (l * inv * inv)
        return fns
    if kind == "flat":
        def fns(pr, l, p_l, b, b2):
            l = jnp.clip(l, -1e4, 1e4)
            r2 = jnp.maximum(l * l, 1e-8)
            inv = 1.0 / r2
            r = jnp.sqrt(r2)
            return p_l, b * inv, b2 * (inv / r)
        return fns
    if kind == "interstellar":
        def fns(pr, l, p_l, b, b2):
            m, a, rho = pr[0, 2], pr[0, 3], pr[0, 4]
            l = jnp.clip(l, -1e4, 1e4)
            c = 2.0 / (jnp.pi * m)
            u = jnp.abs(l)
            x = jnp.maximum(c * (u - a), 0.0)
            v = jnp.minimum(x, 1.0 / jnp.maximum(x, 1.0))
            z = v * v
            from curvis_tpu.ops.march_pallas import _ATAN6
            pa = _ATAN6[-1] * (2.0 / jnp.pi)
            for k in range(len(_ATAN6) - 2, -1, -1):
                pa = pa * z + _ATAN6[k] * (2.0 / jnp.pi)
            av = v * pa
            atx2 = jnp.where(x > 1.0, 1.0 - av, av)
            L = jnp.log(1.0 + x * x)
            r = (rho + (0.5 * jnp.pi * m) * (x * atx2)) - (0.5 * m) * L
            dr = jnp.where(l < 0, -atx2, atx2)
            ir = 1.0 / jnp.maximum(r, 1e-6)
            inv = ir * ir
            return p_l, b * inv, b2 * (dr * inv * ir)
        return fns
    if kind.startswith("cheb"):
        from curvis_tpu.metrics.table import poly_eval
        K = int(kind[4:-1])
        basis = "horner" if kind.endswith("h") else "clenshaw"

        def fns(pr, l, p_l, b, b2):
            s2 = pr[0, 2]
            l = jnp.clip(l, -1e4, 1e4)
            w = 1.0 / jnp.sqrt(jnp.maximum(l * l + s2, 1e-12))
            t = l * w
            w2 = w * w
            c1 = [pr[0, CHEB_OFF_COMPACT + i] for i in range(K + 1)]
            c2 = [pr[0, CHEB_OFF_COMPACT + K + 1 + i] for i in range(K + 1)]
            inv = w2 * poly_eval(c1, t, basis)
            dr_r3 = w2 * w * poly_eval(c2, t, basis)
            return p_l, b * inv, b2 * dr_r3
        return fns
    raise NotImplementedError(
        f"planar rk45 adjoint: unsupported metric kind {kind!r}")


def _theta_slots(kind, theta):
    """theta tuple -> (_ParamRow duck-typed scalar row, b).  Named-param
    kinds: theta = (p0, p1, p2, b) (slots 2-4); table kinds: theta =
    (s^2, c1..., c2..., b) with the coefficient tail at slot 10+
    (integrate/adjoint.py layout, so gradients of the table itself flow)."""
    if kind.startswith("cheb"):
        ncoef = 2 * (int(kind[4:-1]) + 1)
        slots = {2: theta[0]}
        for i in range(ncoef):
            slots[CHEB_OFF_COMPACT + i] = theta[1 + i]
    else:
        slots = {2: theta[0], 3: theta[1], 4: theta[2]}
    return _ParamRow(slots), theta[-1]


def _planar_rk45_iter(kind, consts, theta, y, freeze=False):
    """One unmasked lock-step planar DP5(4) iteration on the extended
    4-state ``y = (l, psi, p_l, dt)`` — trial stages, error estimate,
    accept writeback with escape-radius interpolation, capture/stall flags
    and the controller dt update, exactly the per-iteration semantics of
    ops/march_pallas._rk45_kernel (whose factor uses exp(-0.2 ln err)).
    ``consts = (rtol, atol, dt_min, dt_max, R, r_cap)``; ``theta`` per
    :func:`_theta_slots`.  ``freeze`` stop_gradients the controller chain
    (err -> factor -> dt) but keeps the escape interpolation differentiable
    (module docstring)."""
    sg = lax.stop_gradient if freeze else (lambda x: x)
    rtol, atol, dt_min, dt_max, R, r_cap = consts
    pr, b = _theta_slots(kind, theta)
    deriv = _guarded_deriv_fns(kind)
    b2 = b * b
    l, psi, p_l, dt = y
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
    err = sg(err)                        # decision chain (freeze mode)
    accept = err <= 1.0
    esc_pos = accept & (l5 > R)
    esc_neg = accept & (l5 < -R)
    esc = esc_pos | esc_neg

    # escape interpolation to |l| = R: part of the differentiated state map
    # in BOTH modes (it is the smooth readout, not a controller decision)
    target = jnp.where(esc_pos, R, -R)
    denom = l5 - l
    denom = jnp.where(jnp.abs(denom) < 1e-30, one, denom)
    frac = jnp.clip((target - l) / denom, 0.0, 1.0)
    frac = jnp.where(esc, frac, one)
    ln = jnp.where(accept, l + frac * (l5 - l), l)
    psin = jnp.where(accept, psi + frac * (psi5 - psi), psi)
    pln = jnp.where(accept, p_l + frac * (pl5 - p_l), p_l)

    cap_i = accept & (ln < r_cap)
    stall_i = ~accept & (dt <= dt_min * 1.01)
    terminal = esc | cap_i | stall_i

    err_s = jnp.maximum(err, 1e-10)
    factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
    factor = jnp.where(factor > 0.0, factor, 0.2)    # NaN guard (kernel rule)
    dtn = jnp.where(terminal, dt, jnp.clip(dt * factor, dt_min, dt_max))
    dtn = sg(dtn)
    y1 = (ln, psin, pln, dtn)
    return y1, (accept, esc_pos, esc_neg, cap_i, stall_i)


def _planar_rk45_step(kind, consts, theta, y, freeze=False):
    """The bare 4-state step map (flags dropped) — what the checkpointed
    replay differentiates."""
    return _planar_rk45_iter(kind, consts, theta, y, freeze)[0]


def _forward_xla_planar_rk45(kind, consts, theta, state, dt0, max_steps,
                             max_iters):
    """Masked lock-step forward built on the SAME `_planar_rk45_iter` map
    the backward replays — forward trajectory == recomputed trajectory
    bit-for-bit (the kerr_adjoint._forward_xla pattern; the production
    twin integrate/rk45.march_planar_rk45 computes err**-0.2 via pow, whose
    ulp differences from the kernel's exp/log form flip knife-edge
    accepts)."""
    l0, psi0, pl0 = state
    n = l0.shape
    y0 = (l0, psi0, pl0, jnp.full_like(l0, dt0))
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
        y1, (accept, esc_pos, esc_neg, cap_i, stall_i) = _planar_rk45_iter(
            kind, consts, theta, y)
        y = tuple(jnp.where(active, a1, a0) for a0, a1 in zip(y, y1))
        # additive fate update (the kernel's formulation — the flags are
        # structurally disjoint for physical rays)
        dsign = (esc_pos.astype(jnp.int32) - esc_neg.astype(jnp.int32)
                 + 2 * cap_i.astype(jnp.int32))
        sign = jnp.where(active, sign + dsign, sign)
        sign = jnp.where(active & stall_i, 3, sign)
        steps = steps + (active & accept).astype(jnp.int32)
        capped = (sign == 0) & (steps >= max_steps)
        sign = jnp.where(capped, -128, sign)
        return y, sign, steps, iters, it + 1

    y, sign, steps, iters, _ = lax.while_loop(
        cond, body, (y0, sign0, zi, zi, jnp.int32(0)))
    sign = jnp.where(sign == -128, 0, sign)
    return (y[0], y[1], y[2], sign, steps), iters


def _theta_of(kind, row, b):
    """Differentiated parameter tuple from the scalar row (+ per-ray b)."""
    if kind.startswith("cheb"):
        ncoef = 2 * (int(kind[4:-1]) + 1)
        ps = ((row[0, 2],)
              + tuple(row[0, CHEB_OFF_COMPACT + i] for i in range(ncoef)))
    else:
        ps = (row[0, 2], row[0, 3], row[0, 4])
    return ps + (b,)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4))
def _march_core(max_steps, max_iters, segment, backend, freeze, metric,
                state, b, dt0, consts):
    out, _ = _march_fwd(max_steps, max_iters, segment, backend, freeze,
                        metric, state, b, dt0, consts)
    return out


def _march_fwd(max_steps, max_iters, segment, backend, freeze, metric,
               state, b, dt0, consts):
    rtol, atol, dt_min, dt_max, R, _ = (consts[i] for i in range(6))
    dtype = state[0].dtype
    if backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
        l, psi, p_l = state
        rays = PlanarRays(l=l, psi=psi, p_l=p_l, b=b,
                          r_hat=jnp.zeros((1, 3), dtype),
                          e2=jnp.zeros((1, 3), dtype))
        res, iters = march_planar_rk45_pallas(
            metric, rays, escape_radius=R, max_steps=max_steps,
            max_iters=max_iters, rtol=rtol, atol=atol, dt0=dt0,
            dt_max=dt_max, return_iters=True)
        out = (res.l, res.psi, res.p_l, res.sign, res.steps)
    else:
        kind, row = _metric_kind_and_params(metric, dt0, R, dtype)
        theta = _theta_of(kind, row, b)
        out, iters = _forward_xla_planar_rk45(
            kind, tuple(consts[i] for i in range(6)), theta, state, dt0,
            max_steps, max_iters)
    return out, (metric, state, b, dt0, consts, out[3], iters)


def _march_bwd(max_steps, max_iters, segment, backend, freeze, res_, cot):
    metric, state0, b, dt0, consts, sign, iters = res_
    dtype = state0[0].dtype
    cot_l, cot_psi, cot_pl = cot[0], cot[1], cot[2]

    # smooth fates only: escaped (+-1) and step-capped (0); captured (2)
    # and stalled/blown-up (3) rays are discrete events (module docstring)
    smooth = (sign == 0) | (sign == 1) | (sign == -1)
    zero = jnp.zeros_like(state0[0])
    cot4 = tuple(jnp.where(smooth, c, 0.0)
                 for c in (cot_l, cot_psi, cot_pl, zero))
    iters_eff = jnp.where(smooth, iters, 0)
    R = consts[4]
    kind, row = _metric_kind_and_params(metric, dt0, R, dtype)
    y0 = tuple(state0) + (jnp.full_like(state0[0], dt0),)

    theta = _theta_of(kind, row, b)
    cs = tuple(consts[i] for i in range(6))
    step_fn = partial(_planar_rk45_step, kind, cs, freeze=freeze)
    d_theta, lam = ckpt_adjoint_backward(
        step_fn, theta, y0, iters_eff, cot4, max_steps=max_iters,
        segment=segment)
    if kind.startswith("cheb"):
        g_metric = _table_metric_grads(metric, list(d_theta[:-1]))
    else:
        g_metric = _planar_metric_grads(metric, d_theta[:3])
    g_b = d_theta[-1]

    # lam[3] (the dt0 sensitivity) is dropped, matching the Kerr pair: dt0
    # is a solver knob, not a model parameter
    return (g_metric, (lam[0], lam[1], lam[2]), g_b,
            jnp.zeros_like(jnp.asarray(dt0, dtype)),
            jnp.zeros_like(jnp.asarray(consts)))


_march_core.defvjp(_march_fwd, _march_bwd)


def march_planar_rk45_adjoint(metric, state, b, *, dt0, max_steps,
                              escape_radius, rtol=1e-5, atol=1e-7,
                              dt_min=1e-6, dt_max=10.0, max_iters=None,
                              backend="auto", segment=None,
                              freeze_controller=False):
    """Differentiable error-controlled planar march: production DP5(4)
    forward (Pallas kernel on the GPU) + checkpointed-recompute backward over
    the replayed per-ray iteration sequence.  ``state = (l, psi, p_l)``;
    returns ``(l, psi, p_l, sign, steps)``.  Gradients flow to ``metric``
    (parameter pytree — including the Chebyshev table of a TabulatedMetric),
    ``state`` and ``b``.

    ``max_iters`` (static) bounds BOTH the forward lock-step iterations and
    the backward replay cost (default 4 * max_steps, the forward kernel's
    own bound — pass something near the expected per-ray iteration count
    to cut the replay).
    """
    if backend == "auto":
        from curvis_tpu.dispatch import use_kernel
        backend = "pallas" if use_kernel(state[0].dtype) else "xla"
    if max_iters is None:
        max_iters = 4 * max_steps
    if backend == "pallas" and dt_min != 1e-6:
        raise ValueError(
            "backend='pallas': the forward kernel hardcodes its dt floor at "
            "1e-6 (ops/march_pallas._rk45_kernel); the replay must use the "
            "same dt_min or knife-edge stall decisions diverge")
    if segment is None:
        segment = max(1, int(int(max_iters) ** 0.5))
    dtype = state[0].dtype
    r_cap = getattr(metric, "capture_radius", None)
    if r_cap is None:
        r_cap = _NO_CAPTURE
    consts = jnp.stack([jnp.asarray(v, dtype) for v in
                        (rtol, atol, dt_min, dt_max, escape_radius, r_cap)])
    return _march_core(int(max_steps), int(max_iters), int(segment), backend,
                       bool(freeze_controller), metric, tuple(state), b,
                       jnp.asarray(dt0, dtype), consts)


def march_planar_rk45_adjoint_rays(metric, rays: PlanarRays, *, dt0,
                                   max_steps, escape_radius, **kw
                                   ) -> PlanarResult:
    """PlanarRays-facing wrapper with the standard result contract."""
    l, psi, p_l, sign, steps = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, dt0=dt0,
        max_steps=max_steps, escape_radius=escape_radius, **kw)
    return PlanarResult(l, psi, p_l, sign, steps)
