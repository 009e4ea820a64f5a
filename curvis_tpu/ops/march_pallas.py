"""Pallas kernels for the ray marches — the production hot loops.

The whole render cost lives in the geodesic step loop (SURVEY.md section 3.1:
the innermost hot loop is `update_relativistic_object`, metrics.rs:283-297).
These kernels run the reduced planar system (physics/planar.py)

    dl = p_l;  dpsi = b / r^2;  dp_l = b^2 r'(l) / r^3

and the Kerr Boyer-Lindquist system with the ray state in registers: a 1-D
grid of ray blocks (ops/launch.py), each program looping with a
`lax.while_loop` that exits as soon as *its* block has fully terminated.
Ray state never touches device memory between steps (vs the XLA
while-loop path, which runs one loop iteration per launch and streams the
carry), and escape-check semantics are exactly the reference's (masked
per-step, post-step strict |l| > R test, systems.rs:126-135), so results
are bit-comparable with the scan/while backends for the Euler stepper.
Kernels in this file:

  - ``_march_kernel``     : Euler parity march (maskless sprint + masked phase)
  - ``_rk45_kernel``      : adaptive Dormand-Prince with per-ray dt
  - ``_disk_kernel``      : Euler march + equatorial-crossing capture for
                            accretion-disk rendering
  - ``_disk_vol_kernel``  : Euler march + volumetric radiative transfer
  - ``_kerr_kernel``      : Kerr/Kerr-Newman RK4 (+ disk or volume)
  - ``_kerr_rk45_kernel`` : Kerr/Kerr-Newman DP5(4) (+ disk, volume, scatter)
All planar kernels support Ellis / DNEG / flat / Schwarzschild / RN and
Chebyshev-tabulated metrics (capture via the row's radius slot).

Runtime parameters (dt, escape radius, metric params) ride the scalar row
so retuning them does not recompile; block size / max_steps / the Euler
unroll are compile-time.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from curvis_tpu.metrics.base import (EllisMetric, FlatSphericalMetric,
                                     InterstellarMetric, Metric,
                                     ReissnerNordstromMetric,
                                     SchwarzschildMetric)
from curvis_tpu.ops.launch import any_alive, launch
from curvis_tpu.physics.planar import PlanarRays, PlanarResult

# ---------------------------------------------------------------------------
# Scalar-row layout contract — SINGLE SOURCE OF TRUTH (VERDICT round-3
# next-step #4: the cheb-tail offset bug class shipped twice in round 3
# because the layout lived in three places).  Every kernel family reads its
# named scalars through these constants, the wrapper row-builders assert
# their splice arithmetic against them, and tests/test_smem_layout.py pins
# the whole contract.
#
#   compact rows (euler/_rk45_kernel/_disk_kernel):
#     [0]=dt [1]=R [2:5]=metric params [5]=capture [6:10]=family extras
#     (rk45: rtol, atol, dt_max, -; disk: r_in, r_out, -, -; euler march:
#     far_r0 at 9) — Chebyshev tail at CHEB_OFF_COMPACT.
#   planar volumetric row: compact[0:6] + [6]=r_in [7]=r_out +
#     the 8 _vol_param_slots at VOL_BLOCK_PLANAR — tail at CHEB_OFF_VOL.
#   Kerr rows: [0]=dt [1]=R [2]=M [3]=a [4]=q2 [5]=cap [6]=r_in [7]=r_out
#     + [8]=axis_u0 [9]=far_r0 (fixed) | [8]=rtol [9]=atol (rk45); vol
#     variants append the 8 _vol_param_slots at VOL_BLOCK_KERR; the rk45
#     controller bounds (dt_max, dt_min) sit at KERR_RK45_BOUNDS[vol].
# ---------------------------------------------------------------------------
VOL_SLOT = {"h2": 0, "inv_norm": 1, "kappa": 2, "tau_max": 3, "t_peak": 4,
            "emis_q": 5, "spin_sign": 6, "t_scale": 7}
VOL_BLOCK_PLANAR = 8               # _vol_emission / _disk_vol_kernel reads
VOL_BLOCK_KERR = 10                # _kerr_vol_emission / Kerr kernels reads
CHEB_OFF_COMPACT = 10              # compact-row Chebyshev tail offset
CHEB_OFF_VOL = VOL_BLOCK_PLANAR + len(VOL_SLOT)       # = 16
KERR_RK45_BOUNDS = {False: 10, True: VOL_BLOCK_KERR + len(VOL_SLOT)}
# planar rk45 disk/vol rows keep the bare-rk45 controller slots ([6]=rtol
# [7]=atol [8]=dt_max) and insert (r_in, r_out) after them — every vol/
# emission read shifts by RK45_EXTRA_OFF relative to the Euler vol row
# (_vol_emission takes the shift as its ``off`` argument).
RK45_EXTRA_OFF = 3
CHEB_OFF_RK45_DISK = 12            # [9]=r_in [10]=r_out [11]=spare, tail
CHEB_OFF_RK45_VOL = CHEB_OFF_VOL + RK45_EXTRA_OFF     # = 19
# Starlight single-scattering block (planar vol kernels, round 5): when the
# compile-time ``scatter`` flag is on, 27 scalars ride between the vol
# block and the metric tail — [tint_r, tint_g, tint_b] (the tint folds
# in-kernel because scattered sky light is colored, so grayscale tint-mode
# accumulators no longer suffice) followed by 3 x (SCATTER_DEG+1) monomial
# coefficients of kappa_s * albedo_c * Ebar_c(t), t = 2 (r_cyl - r_in) /
# (r_out - r_in) - 1 (the azimuth/face-averaged starlight map profile).
# The Chebyshev metric tail shifts up by SCATTER_BLOCK.
SCATTER_DEG = 7
SCATTER_BLOCK = 3 + 3 * (SCATTER_DEG + 1)             # = 27
# Kerr vol rows are width 20 with or without rk45 (fixed: 10 base + 8
# slots + 2 spare; rk45: 10 base + 8 slots + dt_max/dt_min), so the Kerr
# scatter block rides at a single offset in both kernels (round 5: the
# in-gas starlight source for the BL family)
KERR_SCATTER_OFF = VOL_BLOCK_KERR + len(VOL_SLOT) + 2  # = 20


def _atan_poly(x):
    """Branchless arctan: Cephes atanf range reduction + degree-4
    polynomial in x^2, ~1-2 ulp in f32.  All branches computed, selected
    with where (finite everywhere thanks to the guarded reciprocal).  The
    Triton route lowers atan; the polynomial stays so that the kernels and
    their XLA twins (which share this code) keep one set of numerics."""
    sign = jnp.sign(x)
    ax = jnp.abs(x)
    t3 = ax > 2.414213562373095        # tan(3*pi/8)
    t1 = ax > 0.4142135623730950       # tan(pi/8)
    safe_ax = jnp.maximum(ax, 1e-30)
    xr = jnp.where(t3, -1.0 / safe_ax,
                   jnp.where(t1, (ax - 1.0) / (ax + 1.0), ax))
    base = jnp.where(t3, jnp.pi / 2, jnp.where(t1, jnp.pi / 4, 0.0))
    z = xr * xr
    poly = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
             + 1.99777106478e-1) * z - 3.33329491539e-1) * z * xr + xr
    return sign * (base + poly)


def _shape_fns(kind: str, cheb_off: int = CHEB_OFF_COMPACT):
    """Inlined (r2, r_deriv_over_r3) for each metric family.

    Returns f(params, l) -> (r2, dr_over_r3) where dr_over_r3 = r'(l)/r(l)^3,
    the only combination the planar RHS needs.  params is the scalar row.

    ``kind='cheb{K}'`` is the USER-METRIC path (metrics/table.py): degree-K
    Chebyshev tables of the compactified shape remainders, appended to the
    row at slot ``cheb_off`` (each kernel family passes where its own
    extras end) — Clenshaw evaluation, ~8 + 4K flops per step.
    """
    if kind.startswith("cheb"):
        from curvis_tpu.metrics.table import poly_eval
        K = int(kind[4:-1])
        basis = "horner" if kind.endswith("h") else "clenshaw"

        def fns(pr, l):
            s2 = pr[0, 2]
            w = 1.0 / jnp.sqrt(l * l + s2)
            t = l * w
            w2 = w * w
            c1 = [pr[0, cheb_off + i] for i in range(K + 1)]
            c2 = [pr[0, cheb_off + K + 1 + i] for i in range(K + 1)]
            return (w2 * poly_eval(c1, t, basis),
                    w2 * w * poly_eval(c2, t, basis))
        return fns
    if kind == "ellis":
        def fns(pr, l):
            rho = pr[0, 2]
            r2 = rho * rho + l * l
            inv = 1.0 / r2
            # r' / r^3 = (l / r) / r^3 = l / r2^2
            return inv, l * inv * inv
        return fns
    if kind == "flat":
        def fns(pr, l):
            r2 = l * l
            inv = 1.0 / r2
            r = jnp.sqrt(r2)
            return inv, inv / r                 # r' = 1 -> r'/r^3 = 1/r^3
        return fns
    if kind == "interstellar":
        def fns(pr, l):
            m, a, rho = pr[0, 2], pr[0, 3], pr[0, 4]
            # Lean DNEG shape, round-3 budgeted form: ONE divide, ONE log,
            # one degree-6 poly (~30 flops vs the round-2 ~43).  The old
            # degree-9 ln1p poly paid ~10 flops NEXT TO a hardware log
            # that costs one op-equivalent (NEXT.md latency measurements);
            # and the branch-split log collapses exactly —
            # (1+v^2)*max(x,1)^2 == 1+x^2 in both branches — so
            # L = log(1+x^2) directly (f32 abs err <= ~1e-7 in L ->
            # ~1e-8*m in r).  atan keeps a poly (shared with the XLA twin),
            # refit at degree 6: 1.2e-6 abs in f32 Horner — measured, and
            # ~3 decades under the p99 3e-3 rad deflection budget.
            c = 2.0 / (jnp.pi * m)       # scalar, loop-invariant
            u = jnp.abs(l)
            # inside-throat clamp replaces the outside-select: at x = 0,
            # G = atan = 0 gives r = rho, r' = 0 exactly (metrics.rs:461-487)
            x = jnp.maximum(c * (u - a), 0.0)
            v = jnp.minimum(x, 1.0 / jnp.maximum(x, 1.0))   # in [0, 1]
            z = v * v
            # the 2/pi of r' is folded INTO the poly (atx2 = (2/pi)atan(x),
            # its pi/2 big-branch offset rescaling to exactly 1), and the
            # m*pi/2 factor that restores x*atan(x) hoists into a scalar
            pa = _ATAN6[-1] * (2.0 / jnp.pi)
            for k in range(len(_ATAN6) - 2, -1, -1):
                pa = pa * z + _ATAN6[k] * (2.0 / jnp.pi)
            av = v * pa                                  # (2/pi) atan(v)
            atx2 = jnp.where(x > 1.0, 1.0 - av, av)      # (2/pi) atan(x)
            L = jnp.log(1.0 + x * x)
            r = (rho + (0.5 * jnp.pi * m) * (x * atx2)) - (0.5 * m) * L
            dr = jnp.where(l < 0, -atx2, atx2)
            ir = 1.0 / r
            inv = ir * ir
            return inv, dr * inv * ir                    # r'/r^3
        return fns
    raise NotImplementedError(f"pallas march: unsupported metric kind {kind!r}")


# Degree-6 Chebyshev-fitted coefficients (increasing order) for
# atan(sqrt(z))/sqrt(z) on z in [0, 1]; 1.2e-6 measured max abs error of
# the full f32 Horner atan(v) — ~3 decades under the p99 3e-3 rad
# deflection budget the far-accel mode already accepts.
_ATAN6 = (0.9999983985602714, -0.33323850415643685, 0.1986180494015639,
          -0.13427489049705943, 0.08302167871342245, -0.03645597268332047,
          0.0077305593796934136)


def _deriv_fns(kind: str, cheb_off: int = CHEB_OFF_COMPACT):
    """Full planar derivative triple f(pr, l, p_l, b, b2) -> (dl, dpsi, dpl).

    Unit-lapse metrics (the reference family) use the shape-function form;
    'schwarzschild' inlines the general static system with A = 1 - 2M/l:
        dl = A p_l;  dpsi = b/l^2;  dpl = -A'/2 (1/A^2 + p_l^2) + b^2/l^3
    """
    if kind == "schwarzschild":
        def fns(pr, l, p_l, b, b2):
            M = pr[0, 2]
            invl = 1.0 / l
            invl2 = invl * invl
            A = 1.0 - 2.0 * M * invl
            invA = 1.0 / A
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-M * invl2) * (invA * invA + p_l * p_l) + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    if kind == "rn":
        # Reissner-Nordstrom: A = 1 - 2M/l + Q^2/l^2, -A'/2 = -(M - Q^2/l)/l^2
        # (outside the outer horizon A < 1, so the sprint-phase speed bound
        # sqrt(1 - A b^2/r^2) <= 1 still holds; capture sits above r_+)
        def fns(pr, l, p_l, b, b2):
            M, q2 = pr[0, 2], pr[0, 3]
            invl = 1.0 / l
            invl2 = invl * invl
            A = 1.0 - (2.0 * M - q2 * invl) * invl
            invA = 1.0 / A
            dl = A * p_l
            dpsi = b * invl2
            dpl = (-(M - q2 * invl) * invl2) * (invA * invA + p_l * p_l) \
                + b2 * invl2 * invl
            return dl, dpsi, dpl
        return fns
    shape = _shape_fns(kind, cheb_off)

    def fns(pr, l, p_l, b, b2):
        inv, dr_r3 = shape(pr, l)
        return p_l, b * inv, b2 * dr_r3
    return fns


_NO_CAPTURE = -1e30      # sentinel capture radius (never reached)


def _vol_param_slots(disk):
    """The 8 emission scalars every volumetric kernel reads by FIXED index
    (after its r_in/r_out pair): [h^2, inv_norm, kappa, tau_max, t_peak,
    emissivity_index, spin_sign, t_scale].  One definition so the slot
    order _vol_emission/_kerr_vol_emission hardcode cannot desynchronize
    across the planar-vol, Kerr-RK4-vol and Kerr-RK45-vol rows."""
    h2 = disk.h_rel * disk.h_rel
    inv_norm = 1.0 / (float(np.sqrt(2.0 * np.pi)) * disk.h_rel)
    rp = (49.0 / 36.0) * disk.r_inner       # Shakura-Sunyaev peak radius
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    return [h2, inv_norm, disk.kappa, disk.tau_max, disk.t_peak,
            disk.emissivity_index, disk.spin_sign, disk.t_peak / f_peak]


def _metric_kind_and_params(metric: Metric, dt, escape_radius, dtype):
    """(kind, (1, 10) scalar row):
    [dt, R, p0, p1, p2, capture_radius, rtol, atol, dt_max, 0].
    Built with jnp so traced metric parameters stay traced (no recompiles
    when retuning dt / R / params under jit)."""
    def row(vals, capture=_NO_CAPTURE):
        vals = list(vals) + [0.0] * (5 - len(vals))
        vals = vals + [capture]
        vals = [jnp.asarray(v, dtype=dtype) for v in vals]
        vals += [jnp.zeros((), dtype=dtype)] * (CHEB_OFF_COMPACT - len(vals))
        return jnp.stack(vals).reshape(1, CHEB_OFF_COMPACT)
    if isinstance(metric, EllisMetric):
        return "ellis", row([dt, escape_radius, metric.rho])
    if isinstance(metric, InterstellarMetric):
        return "interstellar", row([dt, escape_radius, metric.m, metric.a,
                                    metric.rho])
    if isinstance(metric, FlatSphericalMetric):
        return "flat", row([dt, escape_radius])
    if isinstance(metric, SchwarzschildMetric):
        return "schwarzschild", row([dt, escape_radius, metric.m],
                                    capture=metric.capture_radius)
    if isinstance(metric, ReissnerNordstromMetric):
        return "rn", row([dt, escape_radius, metric.m, metric.q * metric.q],
                         capture=metric.capture_radius)
    from curvis_tpu.metrics.table import TabulatedMetric
    if isinstance(metric, TabulatedMetric):
        # user-defined metric via Chebyshev table (metrics/table.py): the
        # base row carries s^2 in the metric-param slot; the coefficient
        # tail rides after slot 10 (wrappers that splice their own extras
        # into 6:10 re-append params[:, 10:], keeping the tail's offset a
        # per-kernel constant — see _shape_fns cheb_off)
        base = row([dt, escape_radius, metric.s * metric.s])
        tail = jnp.concatenate([metric.c1, metric.c2]).astype(dtype)
        suffix = "h" if metric.basis == "horner" else "c"
        return (f"cheb{metric.degree}{suffix}",
                jnp.concatenate([base, tail.reshape(1, -1)], axis=1))
    raise NotImplementedError(
        f"pallas march: unsupported metric {type(metric).__name__}")


def _march_kernel(kind: str, max_steps: int, unroll: int,
                  params_ref, l_ref, psi_ref, pl_ref, b_ref,
                  ol_ref, opsi_ref, opl_ref, osign_ref, osteps_ref):
    """Lean masked Euler march.

    Frozen rays are masked *arithmetically* (per-ray effective dt of 0) —
    x += 0 * dx is exact for finite values, so frozen state is untouched
    without select chains.  The escape sign is accumulated as a float
    (sign += alive * ((l > R) - (l < -R))), which latches at +-1 on the first
    crossing and zeroes `alive` from the next sub-step on.  ~13 flops per
    ray-step vs ~25 for the select-based formulation.  ``max_steps`` must be
    a multiple of ``unroll`` (enforced by the wrapper) so the iteration cap
    is exact.
    """
    deriv = _deriv_fns(kind)
    dt = params_ref[0, 0]
    R = params_ref[0, 1]
    r_cap = params_ref[0, 5]

    l = l_ref[:]
    psi = psi_ref[:]
    p_l = pl_ref[:]
    b = b_ref[:]
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    sign = jnp.zeros_like(l)

    # Phase 1 — maskless sprint.  Null normalization bounds the coordinate
    # speed: |dl/dlambda| = sqrt(1 - A b^2/r^2) <= 1 (unit-lapse metrics
    # have A = 1), so |l| moves at most dt per step: no ray can escape or
    # be captured before min(R - max|l|, min l - r_cap)/dt steps.  Run that
    # prefix with the bare step (no masking, no checks); semantics identical
    # since dt*1.0 masking is exact for active rays.
    # 5% margin: Euler drift lets the speed exceed 1 by O(1e-3); the sprint
    # must provably end before any ray can terminate.
    m0 = jnp.max(jnp.abs(l))
    d_free = jnp.minimum(R - m0, jnp.min(l) - r_cap)
    k_free = jnp.floor(d_free / (dt * 1.05) - 2.0).astype(jnp.int32)
    k_free = jnp.clip(k_free, 0, max_steps)
    k_free = (k_free // unroll) * unroll

    def sprint(i, c):
        l, psi, p_l = c
        for _ in range(unroll):
            dl, dpsi, dpl = deriv(params_ref, l, p_l, b, b2)
            l = l + dt * dl
            psi = psi + dt * dpsi
            p_l = p_l + dt * dpl
        return l, psi, p_l

    l, psi, p_l = lax.fori_loop(0, k_free // unroll, sprint, (l, psi, p_l))
    steps = jnp.zeros_like(l) + k_free.astype(l.dtype)

    # Phase 2 — masked stepping with per-step termination checks (exact
    # reference escape semantics + capture) until the tile fully terminates.
    def cond(c):
        _, _, _, sign, _, it = c
        return (it < max_steps) & any_alive(sign)

    def body(c):
        l, psi, p_l, sign, steps, it = c
        for _ in range(unroll):
            alive = jnp.where(sign == 0.0, one, zero)
            dte = dt * alive
            dl, dpsi, dpl = deriv(params_ref, l, p_l, b, b2)
            l = l + dte * dl
            psi = psi + dte * dpsi
            p_l = p_l + dte * dpl
            sign = sign + alive * (jnp.where(l > R, one, zero)
                                   - jnp.where(l < -R, one, zero)
                                   + 2.0 * jnp.where(l < r_cap, one, zero))
            steps = steps + alive
        return l, psi, p_l, sign, steps, it + unroll

    l, psi, p_l, sign, steps, _ = lax.while_loop(
        cond, body, (l, psi, p_l, sign, steps, k_free))

    ol_ref[:] = l
    opsi_ref[:] = psi
    opl_ref[:] = p_l
    osign_ref[:] = sign.astype(jnp.int32)
    osteps_ref[:] = steps.astype(jnp.int32)


def march_planar_pallas(metric: Metric, rays: PlanarRays, *, dt, max_steps,
                        escape_radius, stepper="euler") -> PlanarResult:
    """Pallas planar march with the same contract as march_planar_tiled."""
    if stepper != "euler":
        raise NotImplementedError("pallas march currently implements the "
                                  "(reference-parity) Euler stepper")
    kind, params = _metric_kind_and_params(metric, dt, escape_radius,
                                           rays.l.dtype)
    unroll = UNROLL
    # The kernel's masked phase gates only on sign, so the iteration bound
    # must hit max_steps exactly: shrink unroll to a divisor rather than
    # rounding the cap up (an overshoot would let a ray escape with sign +-1
    # where the while/scan backends report 0 — pinned by
    # tests/test_planar.py::test_backends_agree_at_step_cap).
    while max_steps % unroll:
        unroll //= 2

    shape = rays.l.shape
    l, psi, p_l, b = (jnp.broadcast_to(a, shape).reshape(-1)
                      for a in (rays.l, rays.psi, rays.p_l, rays.b))
    outs = _march_call(kind, max_steps, unroll, params, l, psi, p_l, b)
    l, psi, p_l, sign, steps = (a.reshape(shape) for a in outs)
    return PlanarResult(l, psi, p_l, sign, steps)


# Euler steps per iteration of the block's step loop.  Chosen by the
# sweeps of benchmarks/kernel_vs_twin.py on the H100 (CHANGES.md): it buys
# the Euler march a few percent; the disk, volume and Kerr kernels, swept
# the same way, run as fast with Triton's own loop, and take one step per
# iteration.
UNROLL = 8


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _march_call(kind, max_steps, unroll, params, l, psi, p_l, b):
    f, i32 = l.dtype, jnp.int32
    return launch(functools.partial(_march_kernel, kind, max_steps, unroll),
                  params, [l, psi, p_l, b], [f, f, f, i32, i32],
                  name="planar_euler")


# ---------------------------------------------------------------------------
# Adaptive RK45 kernel (quality mode): Dormand-Prince 5(4), per-ray dt,
# accept/reject, escape interpolation to |l| = R (integrate/rk45.py semantics,
# register-resident).
# ---------------------------------------------------------------------------

_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40]


def _rk45_kernel(kind: str, max_steps: int, max_iters: int,
                 track_disk: bool, vol: bool, blackbody: bool,
                 redshift: bool, doppler: bool, scatter: bool,
                 params_ref, *refs):
    """Adaptive planar DP5(4) march (integrate/rk45.py semantics).

    Compile-time variants (round-4: the planar stepper x surface matrix is
    now complete — VERDICT round-3 next-step #2):
      * ``track_disk``: records the first two equatorial-crossing
        (radius, p_l, psi) triples on accepted steps — inputs gain
        (c1, c2), outputs gain (h1, h1p, h1s, h2, h2p, h2s);
        render/disk.py + render/starlight.py shading contract.
      * ``vol``: per-accepted-step radiative transfer through the flared
        Gaussian gas disk (_vol_emission, weighted by each ray's accepted
        dt) — inputs gain (c1, c2, nz), outputs gain (tau, em_rgb).
    Row layouts per the module-top contract: both variants keep the bare
    controller slots ([6]=rtol [7]=atol [8]=dt_max) and append
    (r_in, r_out) at 9/10 (+ the 8 _vol_param_slots for vol), shifting the
    Chebyshev tail to CHEB_OFF_RK45_DISK / CHEB_OFF_RK45_VOL."""
    n_in = 4 + (2 if (track_disk or vol) else 0) + (1 if vol else 0)
    in_refs = refs[:n_in]
    out_refs = refs[n_in:]
    l_ref, psi_ref, pl_ref, b_ref = in_refs[:4]
    scatter_off = CHEB_OFF_RK45_VOL if (vol and scatter) else None
    cheb_off = (CHEB_OFF_RK45_VOL + (SCATTER_BLOCK if scatter else 0) if vol
                else CHEB_OFF_RK45_DISK if track_disk else CHEB_OFF_COMPACT)
    deriv = _deriv_fns(kind, cheb_off)
    R = params_ref[0, 1]
    dt0 = params_ref[0, 0]
    r_cap = params_ref[0, 5]
    rtol = params_ref[0, 6]
    atol = params_ref[0, 7]
    dt_max = params_ref[0, 8]
    if track_disk or vol:
        r_in = params_ref[0, 9]
        r_out = params_ref[0, 10]
    if vol:
        V = VOL_BLOCK_PLANAR + RK45_EXTRA_OFF
        tau_max = params_ref[0, V + VOL_SLOT["tau_max"]]
        # NB not `h2s`: the track_disk branch of body() assigns a local of
        # that name (hit-2 psi), which would shadow this closure cell in
        # EVERY body() path (Python locals are static per function)
        h2_slab = params_ref[0, V + VOL_SLOT["h2"]]

    l = l_ref[:]
    psi = psi_ref[:]
    p_l = pl_ref[:]
    b = b_ref[:]
    if track_disk or vol:
        c1 = in_refs[4][:]
        c2 = in_refs[5][:]
    nz = in_refs[6][:] if vol else None
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    dt = jnp.full_like(l, 1.0) * dt0
    sign = jnp.zeros_like(l)
    steps = jnp.zeros_like(l)
    extras0 = ()
    if track_disk or vol:
        zq0 = c1 * jnp.cos(psi) + c2 * jnp.sin(psi)
        extras0 = (zq0,) + tuple(jnp.zeros_like(l) for _ in
                                 range(6 if track_disk else 4))
        # disk: (zq, h1, h1p, h1s, h2, h2p, h2s);
        # vol:  (zq, tau, em_r, em_g, em_b)

    def rhs(li, pli):
        return deriv(params_ref, li, pli, b, b2)

    def cond(c):
        sign = c[4]
        it = c[-1]
        return (it < max_iters) & any_alive(sign)

    def body(c):
        l, psi, p_l, dt, sign, steps = c[:6]
        ex = c[6:-2]
        itersv = c[-2]
        it = c[-1]
        alive = jnp.where((sign == 0.0) & (steps < max_steps), one, zero)
        # counts accepted AND rejected iterations while live — the
        # checkpointed-recompute adjoint replays exactly this many
        # iterations per ray (integrate/rk45_adjoint_planar.py)
        itersv = itersv + alive
        ks = []
        for i in range(7):
            li = l
            pli = p_l
            for j, a in enumerate(_DP_A[i]):
                li = li + dt * a * ks[j][0]
                pli = pli + dt * a * ks[j][2]
            ks.append(rhs(li, pli))

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
                          jnp.maximum(ec(e_p, psi, psi5),
                                      ec(e_pl, p_l, pl5)))
        accept = alive * jnp.where(err <= 1.0, one, zero)

        esc_pos = accept * jnp.where(l5 > R, one, zero)
        esc_neg = accept * jnp.where(l5 < -R, one, zero)
        esc = esc_pos + esc_neg
        target = jnp.where(esc_pos > 0, R, -R)
        denom = l5 - l
        denom = jnp.where(jnp.abs(denom) < 1e-30, one, denom)
        frac = jnp.clip((target - l) / denom, 0.0, 1.0)
        frac = jnp.where(esc > 0, frac, one)

        l_prev = l
        psi_prev = psi
        pl_prev = p_l
        l = l + accept * frac * (l5 - l)
        psi = psi + accept * frac * (psi5 - psi)
        p_l = p_l + accept * frac * (pl5 - p_l)
        acc_b = accept > 0.5
        if track_disk or vol:
            zq_prev = ex[0]
            # rejected/frozen rays keep psi, so zq_new == zq_prev there
            zq_new = c1 * jnp.cos(psi) + c2 * jnp.sin(psi)
        if track_disk:
            _, h1, h1p, h1s, h2, h2p, h2s = ex
            crossed = acc_b & (zq_prev * zq_new < 0.0)
            cden = jnp.abs(zq_prev) + jnp.abs(zq_new)
            cfrac = jnp.abs(zq_prev) / jnp.maximum(cden, 1e-30)
            # SIGNED hit coordinate: |lh| is the radius, sign(lh) the
            # SHEET (wormholes have a disk on both sides of the throat;
            # the two-sheet starlight map selects per hit) — consumers
            # take jnp.abs() for shading
            lh = l_prev + cfrac * (l - l_prev)
            r_hit = jnp.abs(lh)
            pl_hit = pl_prev + cfrac * (p_l - pl_prev)
            psi_hit = psi_prev + cfrac * (psi - psi_prev)
            in_disk = crossed & (r_hit >= r_in) & (r_hit <= r_out)
            new1 = in_disk & (h1 == 0.0)
            new2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
            h1 = jnp.where(new1, lh, h1)
            h1p = jnp.where(new1, pl_hit, h1p)
            h1s = jnp.where(new1, psi_hit, h1s)
            h2 = jnp.where(new2, lh, h2)
            h2p = jnp.where(new2, pl_hit, h2p)
            h2s = jnp.where(new2, psi_hit, h2s)
            ex = (zq_new, h1, h1p, h1s, h2, h2p, h2s)
        if vol:
            _, tau, emr, emg, emb = ex
            # emission at the post-step state weighted by the accepted dt
            # with the PRE-update tau (the Euler vol kernel's quadrature)
            dtau, dr_, dg_, db_ = _vol_emission(
                kind, blackbody, redshift, doppler, params_ref,
                l, p_l, b, zq_new, tau, nz, cheb_off, RK45_EXTRA_OFF,
                scatter_off=scatter_off)
            emr = emr + jnp.where(acc_b, dt * dr_, zero)
            emg = emg + jnp.where(acc_b, dt * dg_, zero)
            emb = emb + jnp.where(acc_b, dt * db_, zero)
            tau = tau + jnp.where(acc_b, dt * dtau, zero)
            ex = (zq_new, tau, emr, emg, emb)
        capd = accept * jnp.where((l < r_cap) & (sign == 0.0), one, zero)
        sign = sign + esc_pos - esc_neg + 2.0 * capd
        if vol:
            # tau_max freeze: OPAQUE == CAPTURED == 2 (render/disk.py)
            still = jnp.where(sign == 0.0, one, zero)
            sign = sign + still * 2.0 * jnp.where(tau > tau_max, one, zero)
        steps = steps + accept

        # a reject at the dt floor can never pass (the controller cannot
        # shrink further) -> freeze as blowup instead of spinning the tile
        # to max_iters (same provable-termination rule as the Kerr kernel
        # and both XLA twins; NaN err lands here too)
        stalled = ((alive > 0) & ~(err <= 1.0) & (dt <= 1e-6 * 1.01)
                   & (sign == 0.0))
        sign = jnp.where(stalled, 3.0, sign)
        err_s = jnp.maximum(err, 1e-10)
        # clip(0.9 * err^-0.2, 0.2, 5.0) without pow: err^-0.2 via
        # exp(-0.2 ln err).  The NaN guard (factor > 0.0 is False for NaN)
        # is load-bearing for termination: without it a non-finite trial
        # state makes dt itself NaN, the dt-floor stall test above compares
        # False forever, and one ray spins its whole tile to max_iters
        # (same guard as _kerr_rk45_kernel).
        factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
        factor = jnp.where(factor > 0.0, factor, 0.2)
        newdt = jnp.clip(dt * factor, 1e-6, dt_max)
        dt = jnp.where((alive > 0) & (esc == 0.0) & (sign == 0.0), newdt, dt)
        if track_disk or vol:
            # surface-resolution clamps (the Kerr rk45 kernel's rules in
            # planar geometry): a multi-unit adaptive step can straddle a
            # full psi oscillation the crossing detector cannot see, and
            # the gas quadrature is first-order in ds
            if vol:
                # ANTICIPATORY slab-distance clamp: inside/approaching the
                # gas, dt <= max(dt0, half the larger of the radial gap to
                # the r_out + 2 cylinder and the vertical gap to the
                # 5-sigma density shell).  |dl/dlambda| = |p_l| <= 1, so a
                # step can never leap from dt_max across the gas.
                if kind in ("schwarzschild", "rn"):
                    rl = l
                else:
                    inv_r2, _ = _shape_fns(kind, cheb_off)(params_ref, l)
                    rl = lax.rsqrt(jnp.maximum(inv_r2, 1e-30))
                s2v = jnp.clip(1.0 - zq_new * zq_new, 1e-12, 1.0)
                r_cyl = rl * jnp.sqrt(s2v)
                gap_r = r_cyl - (r_out + 2.0)
                h_rel5 = 5.0 * jnp.sqrt(h2_slab)
                gap_z = rl * jnp.abs(zq_new) - h_rel5 * r_cyl
                dt_gas = jnp.maximum(dt0, 0.5 * jnp.maximum(gap_r, gap_z))
                dt = jnp.where(sign == 0.0, jnp.minimum(dt, dt_gas), dt)
            else:
                # ANTICIPATORY plane-distance clamp: the crossing
                # surface is zq = 0 at vertical distance |z| ~ r |zq|,
                # and |dz/dlambda| = |r' dl/dlam zq + r dzq/dlam| <= ~2
                # (the psi term contributes ~b/r ~ 1) — so with dt <=
                # max(dt0, 0.2 r |zq|) a clamp-active step moves z by
                # <= 0.4 |z| and can never REACH the plane: every
                # crossing step starts with small |zq| and small dt,
                # keeping the linear-in-step r_hit interpolation at the
                # Euler kernel's accuracy while off-plane segments stay
                # adaptive (a 0.5 factor let steps land crossings from
                # far off-plane: measured 26% of pixels off at 1024x576).
                # Outside the radial band no crossing lands in
                # [r_in, r_out].
                near = jnp.abs(l) < (r_out + 2.0)
                dt_pl = jnp.maximum(dt0, 0.2 * jnp.abs(l) * jnp.abs(zq_new))
                dt = jnp.where(near & (sign == 0.0),
                               jnp.minimum(dt, dt_pl), dt)
        # rays that hit the step cap freeze with a sentinel
        capped = (sign == 0.0) & (steps >= max_steps)
        sign = jnp.where(capped, -128.0, sign)
        return (l, psi, p_l, dt, sign, steps) + ex + (itersv, it + 1)

    out = lax.while_loop(cond, body, (l, psi, p_l, dt, sign, steps)
                         + extras0 + (jnp.zeros_like(l), jnp.int32(0)))
    l, psi, p_l, dt, sign, steps = out[:6]
    ex = out[6:-2]
    itersv = out[-2]
    sign = jnp.where(sign == -128.0, zero, sign)
    out_refs[0][:] = l
    out_refs[1][:] = psi
    out_refs[2][:] = p_l
    out_refs[3][:] = sign.astype(jnp.int32)
    out_refs[4][:] = steps.astype(jnp.int32)
    if track_disk or vol:
        for i, v in enumerate(ex[1:]):         # h1,h1p,h2,h2p | tau,em_rgb
            out_refs[5 + i][:] = v
    out_refs[-1][:] = itersv.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=tuple(range(10)))
def _rk45_call(kind, max_steps, max_iters, track_disk, vol, blackbody,
               redshift, doppler, scatter, n_out, params, *rays):
    f, i32 = rays[0].dtype, jnp.int32
    kernel = functools.partial(_rk45_kernel, kind, max_steps, max_iters,
                               track_disk, vol, blackbody, redshift, doppler,
                               scatter)
    return launch(kernel, params, list(rays),
                  [f, f, f, i32, i32] + [f] * n_out + [i32],
                  name="planar_rk45")


def march_planar_rk45_pallas(metric: Metric, rays: PlanarRays, *,
                             escape_radius, max_steps=10_000, max_iters=None,
                             rtol=1e-5, atol=1e-7, dt0=0.05, dt_max=10.0,
                             c1=None, c2=None, nz=None,
                             disk=None, vol_disk=None, vol_row=None,
                             scatter_block=None, return_iters=False):
    """Pallas adaptive RK45 march (integrate/rk45.py semantics on-device).

    ``disk=(r_in, r_out)`` (+ per-ray plane coefficients ``c1, c2``)
    records the first two equatorial-crossing (radius, p_l, psi) triples
    and returns ``(PlanarResult, (h1, h1p, h1s), (h2, h2p, h2s))`` — the
    march_planar_disk_pallas contract.  ``vol_disk`` (DiskParams with
    volumetric=True, + ``c1, c2, nz``) instead runs in-kernel radiative
    transfer and returns ``(PlanarResult, tau, (em_r, em_g, em_b))`` —
    the march_planar_disk_volumetric_pallas contract.  ``return_iters``
    appends the per-ray lock-step iteration count (accepted + rejected
    while live) — the checkpointed-recompute adjoint's replay bound
    (integrate/rk45_adjoint_planar.py)."""
    vol = vol_disk is not None
    if vol and disk is not None:
        raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not both")
    track_disk = disk is not None
    kind, params = _metric_kind_and_params(metric, dt0, escape_radius,
                                           rays.l.dtype)
    extra = [rtol, atol, dt_max]
    if track_disk:
        extra += [disk[0], disk[1], 0.0]
        assert 6 + len(extra) == CHEB_OFF_RK45_DISK
    elif vol:
        if vol_row is None:
            extra += [vol_disk.r_inner, vol_disk.r_outer]
            extra += _vol_param_slots(vol_disk)
        else:
            extra += [vol_row[i] for i in range(10)]
        assert 6 + len(extra) == CHEB_OFF_RK45_VOL
        if scatter_block is not None:
            extra = extra + [scatter_block[i] for i in range(SCATTER_BLOCK)]
    else:
        extra += [0.0]
        assert 6 + len(extra) == CHEB_OFF_COMPACT
    params = jnp.concatenate(
        [params[:, :6],
         jnp.asarray([extra], params.dtype),
         params[:, CHEB_OFF_COMPACT:]], axis=1)

    def prep(a):
        return jnp.broadcast_to(a, rays.l.shape).reshape(-1)

    arrs = [prep(rays.l), prep(rays.psi), prep(rays.p_l), prep(rays.b)]
    if track_disk or vol:
        arrs += [prep(c1), prep(c2)]
    if vol:
        arrs += [prep(nz)]
    outs = _rk45_call(
        kind, max_steps,
        4 * max_steps if max_iters is None else int(max_iters),
        track_disk, vol, vol and vol_disk.color_mode == "blackbody",
        vol and vol_disk.redshift, vol and vol_disk.doppler,
        scatter_block is not None,
        6 if track_disk else 4 if vol else 0, params, *arrs)
    outs = [a.reshape(rays.l.shape) for a in outs]
    res = PlanarResult(*outs[:5])
    ret = [res]
    if track_disk:
        h1, h1p, h1s, h2, h2p, h2s = outs[5:11]
        ret += [(h1, h1p, h1s), (h2, h2p, h2s)]
    if vol:
        tau, emr, emg, emb = outs[5:9]
        ret += [tau, (emr, emg, emb)]
    if return_iters:
        ret.append(outs[-1])               # iteration count is always last
    return tuple(ret) if len(ret) > 1 else res


# ---------------------------------------------------------------------------
# Disk-march kernel: planar march + equatorial-plane crossing capture
# (render/disk.py semantics, register-resident).  Tracks z = r(l)(c1 cos psi +
# c2 sin psi) with an incrementally rotated (cos psi, sin psi) pair and
# records the first two crossing (radius, p_l) pairs.
# ---------------------------------------------------------------------------

def _disk_kernel(kind: str, max_steps: int,
                 params_ref, l_ref, psi_ref, pl_ref, b_ref, c1_ref, c2_ref,
                 ol_ref, opsi_ref, opl_ref, osign_ref, osteps_ref,
                 oh1_ref, oh1p_ref, oh1s_ref, oh2_ref, oh2p_ref, oh2s_ref):
    deriv = _deriv_fns(kind)
    dt = params_ref[0, 0]
    R = params_ref[0, 1]
    r_cap = params_ref[0, 5]
    r_in = params_ref[0, 6]
    r_out = params_ref[0, 7]

    l = l_ref[:]
    psi = psi_ref[:]
    p_l = pl_ref[:]
    b = b_ref[:]
    c1 = c1_ref[:]
    c2 = c2_ref[:]
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    sign = jnp.zeros_like(l)
    steps = jnp.zeros_like(l)
    u = jnp.cos(psi)
    v = jnp.sin(psi)
    # z / r(l): crossing detection only needs the sign, and c1 u + c2 v
    # avoids recomputing r(l) for z
    zq = c1 * u + c2 * v
    h1 = jnp.zeros_like(l)
    h1p = jnp.zeros_like(l)
    h1s = jnp.zeros_like(l)
    h2 = jnp.zeros_like(l)
    h2p = jnp.zeros_like(l)
    h2s = jnp.zeros_like(l)

    def cond(c):
        sign = c[7]
        it = c[14]
        return (it < max_steps) & any_alive(sign)

    def body(c):
        l, psi, p_l, u, v, zq, steps, sign, h1, h1p, h1s, h2, h2p, h2s, \
            it = c
        alive = jnp.where(sign == 0.0, one, zero)
        dte = dt * alive
        dl, dpsi, dpl = deriv(params_ref, l, p_l, b, b2)
        l1 = l + dte * dl
        pl1 = p_l + dte * dpl
        du = dte * dpsi
        u1 = u - v * du
        v1 = v + u * du
        zq1 = c1 * u1 + c2 * v1
        # crossing: sign change of z (r > 0 so zq sign == z sign)
        crossed = alive * jnp.where(zq * zq1 < 0.0, one, zero)
        denom = jnp.abs(zq) + jnp.abs(zq1)
        frac = jnp.abs(zq) / jnp.maximum(denom, 1e-30)
        # SIGNED hit coordinate (sheet = sign; see _rk45_kernel)
        lh = l + frac * (l1 - l)
        r_hit = jnp.abs(lh)
        in_disk = crossed * jnp.where(r_hit >= r_in, one, zero) \
            * jnp.where(r_hit <= r_out, one, zero)
        pl_hit = p_l + frac * (pl1 - p_l)
        psi_hit = psi + frac * du
        new1 = in_disk * jnp.where(h1 == 0.0, one, zero)
        new2 = in_disk * jnp.where(h1 != 0.0, one, zero) \
            * jnp.where(h2 == 0.0, one, zero)
        h1 = h1 + new1 * lh
        h1p = h1p + new1 * pl_hit
        h1s = h1s + new1 * psi_hit
        h2 = h2 + new2 * lh
        h2p = h2p + new2 * pl_hit
        h2s = h2s + new2 * psi_hit
        l = l1
        psi = psi + dte * dpsi
        p_l = pl1
        u = u1
        v = v1
        zq = zq1
        sign = sign + alive * (jnp.where(l > R, one, zero)
                               - jnp.where(l < -R, one, zero)
                               + 2.0 * jnp.where(l < r_cap, one, zero))
        steps = steps + alive
        return l, psi, p_l, u, v, zq, steps, sign, h1, h1p, h1s, h2, h2p, \
            h2s, it + 1

    out = lax.while_loop(cond, body, (l, psi, p_l, u, v, zq, steps, sign,
                                      h1, h1p, h1s, h2, h2p, h2s,
                                      jnp.int32(0)))
    l, psi, p_l, _, _, _, steps, sign, h1, h1p, h1s, h2, h2p, h2s, _ = out
    ol_ref[:] = l
    opsi_ref[:] = psi
    opl_ref[:] = p_l
    osign_ref[:] = sign.astype(jnp.int32)
    osteps_ref[:] = steps.astype(jnp.int32)
    oh1_ref[:] = h1
    oh1p_ref[:] = h1p
    oh1s_ref[:] = h1s
    oh2_ref[:] = h2
    oh2p_ref[:] = h2p
    oh2s_ref[:] = h2s


@functools.partial(jax.jit, static_argnums=(0, 1))
def _disk_call(kind, max_steps, params, *rays):
    f, i32 = rays[0].dtype, jnp.int32
    return launch(functools.partial(_disk_kernel, kind, max_steps),
                  params, list(rays), [f, f, f, i32, i32] + [f] * 6,
                  name="planar_disk")


def march_planar_disk_pallas(metric: Metric, rays: PlanarRays, c1, c2, *, dt,
                             max_steps, escape_radius, r_inner, r_outer):
    """Pallas counterpart of render/disk.march_planar_disk."""
    kind, params = _metric_kind_and_params(metric, dt, escape_radius,
                                           rays.l.dtype)
    params = jnp.concatenate(
        [params[:, :6],
         jnp.asarray([[r_inner, r_outer, 0.0, 0.0]], params.dtype),
         params[:, CHEB_OFF_COMPACT:]], axis=1)   # extras fill 6:10 exactly

    arrs = [jnp.broadcast_to(a, rays.l.shape).reshape(-1)
            for a in (rays.l, rays.psi, rays.p_l, rays.b, c1, c2)]
    outs = _disk_call(kind, max_steps, params, *arrs)
    outs = [a.reshape(rays.l.shape) for a in outs]
    l, psi, p_l, sign, steps, h1, h1p, h1s, h2, h2p, h2s = outs
    return (PlanarResult(l, psi, p_l, sign, steps),
            (h1, h1p, h1s), (h2, h2p, h2s))


# ---------------------------------------------------------------------------
# Volumetric disk kernel: the planar march with per-step radiative transfer
# through the flared Gaussian disk (render/disk.py:march_planar_disk_volumetric
# is the XLA reference implementation; per-step semantics kept identical —
# emission at the post-step state with the PRE-update tau, accumulators and
# tau masked by the per-ray dte, termination checks after accumulation).
# Blackbody chromaticity is evaluated in log space with the expm1-free
# identity ln(e^x - 1) = x + ln(1 - e^-x), valid here because x = c2/(lam T)
# >= ~2.3 for T <= 1.5 t_peak at the bluest sample wavelength.
# ---------------------------------------------------------------------------

# compile-time per-channel constants: c2 / lambda_c and -5 ln lambda_c
_VOL_BB_K = tuple(1.4388e-2 / lam for lam in (610e-9, 550e-9, 465e-9))
_VOL_BB_L5 = tuple(-5.0 * float(np.log(lam))
                   for lam in (610e-9, 550e-9, 465e-9))


def _vol_emission(kind: str, blackbody: bool, redshift: bool, doppler: bool,
                  pr, l, p_l, b, zq, tau, nz, cheb_off=CHEB_OFF_VOL,
                  off=0, scatter_off=None):
    """SoA per-step volumetric emission — (dtau, demr, demg, demb).

    Mirrors render/disk.py:step_emission exactly (same clips, same guards);
    scalars come from the widened scalar row (layout contract at the top of
    this module: the 8 _vol_param_slots ride at VOL_BLOCK_PLANAR, so a
    table metric's coefficient tail rides at CHEB_OFF_VOL — NOT the
    compact kernels' CHEB_OFF_COMPACT).

    ``scatter_off``: slot offset of the 27-scalar starlight scattering
    block (module-top contract) — adds the single-scattering source
    trans * rho * kappa_s albedo_c Ebar_c(r_cyl) per channel, the in-gas
    twin of the thin-disk surface reflection (VERDICT round-4 #3a); in
    tint mode the emission picks up the tint per channel in-kernel."""
    V = VOL_BLOCK_PLANAR + off
    r_in = pr[0, 6 + off]
    r_out = pr[0, 7 + off]
    h2 = pr[0, V + VOL_SLOT["h2"]]
    inv_norm = pr[0, V + VOL_SLOT["inv_norm"]]
    kappa = pr[0, V + VOL_SLOT["kappa"]]
    t_peak = pr[0, V + VOL_SLOT["t_peak"]]
    emis_q = pr[0, V + VOL_SLOT["emis_q"]]
    spin_sign = pr[0, V + VOL_SLOT["spin_sign"]]

    if kind in ("schwarzschild", "rn"):
        r = l
    else:
        inv_r2, _ = _shape_fns(kind, cheb_off)(pr, l)
        r = jax.lax.rsqrt(inv_r2)
    zq2 = zq * zq
    s2 = jnp.clip(1.0 - zq2, 1e-12, 1.0)
    r_cyl = r * jnp.sqrt(s2)
    dens = jnp.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
    w_edge = r_out - r_in
    edge_in = jnp.clip((r_cyl - r_in) / (0.1 * w_edge), 0.0, 1.0)
    edge_out = jnp.clip((r_out - r_cyl) / (0.3 * w_edge), 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = jnp.maximum(r_cyl, r_in)
    g = jnp.ones_like(r_cyl)
    if kind in ("schwarzschild", "rn") and (redshift or doppler):
        M = pr[0, 2]
        if kind == "rn":
            q2 = pr[0, 3]
            A = jnp.clip(1.0 - (2.0 * M - q2 / rr) / rr, 1e-3, 1.0)
            vsq = (M - q2 / rr) / rr       # r A'/2: circular-orbit speed^2
        else:
            A = jnp.clip(1.0 - 2.0 * M / rr, 1e-3, 1.0)
            vsq = M / rr
        sqA = jnp.sqrt(A)
        if redshift:
            g = sqA
        if doppler:
            v = jnp.clip(jnp.sqrt(vsq) / sqA, 0.0, 0.99)
            gamma = jax.lax.rsqrt(1.0 - v * v)
            u_l = p_l * sqA
            u_psi = b / rr
            inv = jax.lax.rsqrt(u_l * u_l + u_psi * u_psi + 1e-30)
            cos_xi = (u_psi * inv) * nz * spin_sign
            g = g / (gamma * (1.0 - v * cos_xi))
    trans = jnp.exp(-tau)
    dtau = kappa * base
    scat = None
    if scatter_off is not None:
        # scattered-starlight source: Horner in the compactified radius
        # per channel, clipped at 0 (a least-squares fit may undershoot)
        t = jnp.clip(2.0 * (r_cyl - r_in) / (r_out - r_in) - 1.0,
                     -1.0, 1.0)
        sw = trans * base
        scat = []
        for c in range(3):
            c0 = scatter_off + 3 + c * (SCATTER_DEG + 1)
            acc = pr[0, c0 + SCATTER_DEG]
            for k in range(SCATTER_DEG - 1, -1, -1):
                acc = acc * t + pr[0, c0 + k]
            scat.append(sw * jnp.maximum(acc, 0.0))
    if blackbody:
        # Shakura-Sunyaev T(rr), normalized to peak t_peak (disk.py:86-95)
        sq = jnp.sqrt(r_in / rr)
        ln_r = jnp.log(rr)
        f = jnp.exp(-0.75 * ln_r + 0.25 * jnp.log(jnp.maximum(1.0 - sq,
                                                              1e-20)))
        # t_peak / f_peak, precomputed host-side
        t_scale = pr[0, VOL_BLOCK_PLANAR + off + VOL_SLOT["t_scale"]]
        t_obs = g * t_scale * f
        rel_sq = t_obs / t_peak
        rel = rel_sq * rel_sq
        rel = rel * rel                                    # (t_obs/t_peak)^4
        # Planck chromaticity, log space (disk.py:blackbody_rgb semantics)
        inv_T = 1.0 / jnp.maximum(t_obs, 1.0)
        logs = []
        for k_c, l5 in zip(_VOL_BB_K, _VOL_BB_L5):
            x = k_c * inv_T
            # ln(expm1 x) = x + ln(1 - e^-x); for huge x the log term is 0
            log_denom = x + jnp.log(jnp.maximum(1.0 - jnp.exp(-x), 1e-30))
            logs.append(l5 - log_denom)
        m = jnp.maximum(logs[0], jnp.maximum(logs[1], logs[2]))
        w = trans * base * rel
        out = [w * jnp.exp(logs[0] - m), w * jnp.exp(logs[1] - m),
               w * jnp.exp(logs[2] - m)]
        if scat is not None:
            out = [o + sc for o, sc in zip(out, scat)]
        return (dtau, out[0], out[1], out[2])
    # tint mode: grayscale energy (the tint color is applied at shade time)
    emis = jnp.exp(emis_q * jnp.log(r_in / rr))
    w = trans * base * emis * jnp.clip(g, 0.0, 4.0) ** 3
    if scat is not None:
        # scattered light is COLORED: fold the tint in-kernel per channel
        # (the shader then skips its grayscale tint scaling)
        return (dtau, w * pr[0, scatter_off] + scat[0],
                w * pr[0, scatter_off + 1] + scat[1],
                w * pr[0, scatter_off + 2] + scat[2])
    return dtau, w, w, w


def _disk_vol_kernel(kind: str, blackbody: bool, redshift: bool,
                     doppler: bool, scatter: bool, max_steps: int,
                     params_ref, l_ref, psi_ref, pl_ref, b_ref, c1_ref,
                     c2_ref, nz_ref, ol_ref, opsi_ref, opl_ref, osign_ref,
                     osteps_ref, otau_ref, oemr_ref, oemg_ref, oemb_ref):
    # the vol row carries 16 named slots (6-15 = disk/emission params), so
    # a table metric's Chebyshev tail rides at CHEB_OFF_VOL — the compact
    # default would read kappa/tau_max/... as coefficients (garbage
    # trajectories; the round-3 bug class the layout contract pins).
    # The optional 27-slot scattering block pushes the tail up.
    scatter_off = CHEB_OFF_VOL if scatter else None
    cheb_off = CHEB_OFF_VOL + (SCATTER_BLOCK if scatter else 0)
    deriv = _deriv_fns(kind, cheb_off)
    dt = params_ref[0, 0]
    R = params_ref[0, 1]
    r_cap = params_ref[0, 5]
    tau_max = params_ref[0, VOL_BLOCK_PLANAR + VOL_SLOT["tau_max"]]

    l = l_ref[:]
    psi = psi_ref[:]
    p_l = pl_ref[:]
    b = b_ref[:]
    c1 = c1_ref[:]
    c2 = c2_ref[:]
    nz = nz_ref[:]
    b2 = b * b
    one = jnp.ones_like(l)
    zero = jnp.zeros_like(l)
    sign = jnp.zeros_like(l)
    steps = jnp.zeros_like(l)
    u = jnp.cos(psi)
    v = jnp.sin(psi)
    tau = jnp.zeros_like(l)
    emr = jnp.zeros_like(l)
    emg = jnp.zeros_like(l)
    emb = jnp.zeros_like(l)

    def cond(c):
        sign = c[9]
        it = c[11]
        return (it < max_steps) & any_alive(sign)

    def body(c):
        l, psi, p_l, u, v, tau, emr, emg, emb, sign, steps, it = c
        alive = jnp.where(sign == 0.0, one, zero)
        dte = dt * alive
        dl, dpsi, dpl = deriv(params_ref, l, p_l, b, b2)
        l = l + dte * dl
        psi = psi + dte * dpsi
        p_l = p_l + dte * dpl
        du = dte * dpsi
        u, v = u - v * du, v + u * du
        zq = c1 * u + c2 * v
        dtau, dr_, dg_, db_ = _vol_emission(
            kind, blackbody, redshift, doppler, params_ref,
            l, p_l, b, zq, tau, nz, cheb_off=cheb_off,
            scatter_off=scatter_off)
        emr = emr + dte * dr_
        emg = emg + dte * dg_
        emb = emb + dte * db_
        tau = tau + dte * dtau
        sign = sign + alive * (jnp.where(l > R, one, zero)
                               - jnp.where(l < -R, one, zero)
                               + 2.0 * jnp.where(l < r_cap, one, zero))
        # tau_max freeze: OPAQUE_SIGN == CAPTURED == 2 (render/disk.py)
        still = jnp.where(sign == 0.0, one, zero)
        sign = sign + still * 2.0 * jnp.where(tau > tau_max, one, zero)
        steps = steps + alive
        return l, psi, p_l, u, v, tau, emr, emg, emb, sign, steps, it + 1

    out = lax.while_loop(cond, body, (l, psi, p_l, u, v, tau, emr, emg, emb,
                                      sign, steps, jnp.int32(0)))
    l, psi, p_l, _, _, tau, emr, emg, emb, sign, steps, _ = out
    ol_ref[:] = l
    opsi_ref[:] = psi
    opl_ref[:] = p_l
    osign_ref[:] = sign.astype(jnp.int32)
    osteps_ref[:] = steps.astype(jnp.int32)
    otau_ref[:] = tau
    oemr_ref[:] = emr
    oemg_ref[:] = emg
    oemb_ref[:] = emb


@functools.partial(jax.jit, static_argnums=tuple(range(6)))
def _disk_vol_call(kind, blackbody, redshift, doppler, scatter, max_steps,
                   params, *rays):
    f, i32 = rays[0].dtype, jnp.int32
    kernel = functools.partial(_disk_vol_kernel, kind, blackbody, redshift,
                               doppler, scatter, max_steps)
    return launch(kernel, params, list(rays), [f, f, f, i32, i32] + [f] * 4,
                  name="planar_disk_vol")


def march_planar_disk_volumetric_pallas(metric: Metric, rays: PlanarRays,
                                        c1, c2, nz, *, dt, max_steps,
                                        escape_radius, disk, vol_row=None,
                                        scatter_block=None):
    """Pallas counterpart of render/disk.march_planar_disk_volumetric.

    ``disk`` is a render.disk.DiskParams with volumetric=True; returns
    (PlanarResult, tau, (em_r, em_g, em_b)).  ``vol_row``: traced (10,)
    (r_in, r_out, 8 slots) override — see march_kerr_pallas.
    ``scatter_block``: traced (SCATTER_BLOCK,) starlight-scattering
    coefficients (module-top contract) enabling the in-gas source term.
    """
    kind, params = _metric_kind_and_params(metric, dt, escape_radius,
                                           rays.l.dtype)
    extra = ([disk.r_inner, disk.r_outer] + _vol_param_slots(disk)
             if vol_row is None else [vol_row[i] for i in range(10)])
    assert 6 + 2 == VOL_BLOCK_PLANAR and 6 + len(extra) == CHEB_OFF_VOL
    if scatter_block is not None:
        extra = extra + [scatter_block[i] for i in range(SCATTER_BLOCK)]
    params = jnp.concatenate(
        [params[:, :6],
         jnp.asarray([extra], params.dtype),
         params[:, CHEB_OFF_COMPACT:]], axis=1)  # (1, CHEB_OFF_VOL) + tail

    arrs = [jnp.broadcast_to(a, rays.l.shape).reshape(-1)
            for a in (rays.l, rays.psi, rays.p_l, rays.b, c1, c2, nz)]
    outs = _disk_vol_call(kind, disk.color_mode == "blackbody",
                          disk.redshift, disk.doppler,
                          scatter_block is not None, max_steps, params,
                          *arrs)
    outs = [a.reshape(rays.l.shape) for a in outs]
    l, psi, p_l, sign, steps, tau, emr, emg, emb = outs
    return (PlanarResult(l, psi, p_l, sign, steps), tau, (emr, emg, emb))


# ---------------------------------------------------------------------------
# Kerr kernel: 5-state Boyer-Lindquist march (r, theta, phi, p_r, p_theta)
# with per-ray conserved (E, L), RK4 in registers.  The RHS is the hand-inlined
# Hamiltonian flow of 2*Sigma*H = Delta p_r^2 + p_th^2
#   + (L - a E sin^2)^2/sin^2 - ((r^2+a^2)E - a L)^2/Delta
# including the off-shell W * d(1/2Sigma) term, so it is algebraically
# identical to the autodiff marcher (physics/hamiltonian.py) — the ~50x win
# is register residency + no per-step carry traffic, not a different flow.
# Capture at r < r_cap (sign 2), escape at r > R (sign 1), per-step masked.
# ---------------------------------------------------------------------------

def _kerr_rhs(M, a, q2, E, L, r, th, p_r, p_th):
    s = jnp.sin(th)
    c = jnp.cos(th)
    u = jnp.maximum(s * s, 1e-12)   # axis guard (metrics/kerr.py:_bl_pieces)
    invu = 1.0 / u
    ac = a * c
    sigma = r * r + ac * ac
    inv_sigma = 1.0 / sigma
    # Kerr-Newman: the charge enters the photon flow ONLY through Delta
    # (dDelta/dr is unchanged); q2 = 0 folds back to Kerr bit-for-bit
    delta = r * (r - 2.0 * M) + a * a + q2
    inv_delta = 1.0 / delta
    P = (r * r + a * a) * E - a * L
    G = L - a * E * u
    W = (delta * p_r * p_r + p_th * p_th + G * G * invu
         - P * P * inv_delta)
    dDelta = 2.0 * r - 2.0 * M
    dWdr = (dDelta * p_r * p_r - 4.0 * r * E * P * inv_delta
            + P * P * dDelta * inv_delta * inv_delta)
    sin2t = 2.0 * s * c
    aE = a * E
    dWdth = (aE * aE - L * L * invu * invu) * sin2t
    half = 0.5 * inv_sigma
    dr = delta * p_r * inv_sigma
    dth = p_th * inv_sigma
    dph = (G * invu + a * P * inv_delta) * inv_sigma
    dpr = (-dWdr + W * (2.0 * r) * inv_sigma) * half
    dpth = (-dWdth - W * (a * a * sin2t) * inv_sigma) * half
    return dr, dth, dph, dpr, dpth


def _kerr_vol_emission(blackbody: bool, beaming: bool, pr, r, th, b_ph, tau,
                       scatter_off=None):
    """Volumetric disk emission at a BL state — (dtau, demr, demg, demb).

    Mirrors render/kerr.py:march_kerr_volumetric.step_emission (same clips
    and guards); the vertical direction cosine is zq = cos(theta) exactly,
    and the g-factor is the circular-orbit formula with rr^1.5 = rr sqrt(rr)
    (no pow).  Scalars from the widened (1, 20) scalar row (the 8
    _vol_param_slots at VOL_BLOCK_KERR — layout contract, module top).

    ``scatter_off``: slot offset of the 27-scalar starlight scattering
    block (KERR_SCATTER_OFF) — adds the in-gas single-scattering source,
    the BL twin of the planar _vol_emission's (identical algebra, with
    r_cyl = r sin(theta))."""
    V = VOL_BLOCK_KERR
    M = pr[0, 2]
    a = pr[0, 3]
    q2 = pr[0, 4]
    r_in = pr[0, 6]
    r_out = pr[0, 7]
    h2 = pr[0, V + VOL_SLOT["h2"]]
    inv_norm = pr[0, V + VOL_SLOT["inv_norm"]]
    kappa = pr[0, V + VOL_SLOT["kappa"]]
    t_peak = pr[0, V + VOL_SLOT["t_peak"]]
    emis_q = pr[0, V + VOL_SLOT["emis_q"]]
    s_spin = pr[0, V + VOL_SLOT["spin_sign"]]
    t_scale = pr[0, V + VOL_SLOT["t_scale"]]

    ct = jnp.cos(th)
    zq2 = ct * ct
    s2 = jnp.clip(1.0 - zq2, 1e-12, 1.0)
    r_cyl = r * jnp.sqrt(s2)
    dens = jnp.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
    w_edge = r_out - r_in
    edge_in = jnp.clip((r_cyl - r_in) / (0.1 * w_edge), 0.0, 1.0)
    edge_out = jnp.clip((r_out - r_cyl) / (0.3 * w_edge), 0.0, 1.0)
    base = dens * edge_in * edge_out
    rr = jnp.maximum(r_cyl, r_in)
    if beaming:
        # Kerr-Newman circular-orbit g, the exact algebraic form of
        # render/kerr.py:_kerr_circular_g (q2 = 0 for Kerr)
        sq = jnp.sqrt(jnp.maximum(M * rr - q2, 1e-12))
        rr2 = rr * rr
        omega = s_spin * sq / (rr2 + s_spin * a * sq)
        under = jnp.clip(1.0 - (3.0 * M - 2.0 * q2 / rr) / rr
                         + 2.0 * s_spin * a * sq / rr2, 1e-3, None)
        g = jnp.sqrt(under) / jnp.clip(1.0 - omega * b_ph, 0.2, 5.0)
    else:
        g = jnp.ones_like(rr)
    trans = jnp.exp(-tau)
    dtau = kappa * base
    scat = None
    if scatter_off is not None:
        # scattered-starlight source (the planar _vol_emission's exact
        # form): Horner in the compactified cylindrical radius per channel
        t = jnp.clip(2.0 * (r_cyl - r_in) / (r_out - r_in) - 1.0,
                     -1.0, 1.0)
        sw = trans * base
        scat = []
        for c in range(3):
            c0 = scatter_off + 3 + c * (SCATTER_DEG + 1)
            acc = pr[0, c0 + SCATTER_DEG]
            for k in range(SCATTER_DEG - 1, -1, -1):
                acc = acc * t + pr[0, c0 + k]
            scat.append(sw * jnp.maximum(acc, 0.0))
    if blackbody:
        sq = jnp.sqrt(r_in / rr)
        f = jnp.exp(-0.75 * jnp.log(rr)
                    + 0.25 * jnp.log(jnp.maximum(1.0 - sq, 1e-20)))
        t_obs = g * t_scale * f
        rel = (t_obs / t_peak) ** 2
        rel = rel * rel                                    # (t_obs/t_peak)^4
        inv_T = 1.0 / jnp.maximum(t_obs, 1.0)
        logs = []
        for k_c, l5 in zip(_VOL_BB_K, _VOL_BB_L5):
            x = k_c * inv_T
            log_denom = x + jnp.log(jnp.maximum(1.0 - jnp.exp(-x), 1e-30))
            logs.append(l5 - log_denom)
        m = jnp.maximum(logs[0], jnp.maximum(logs[1], logs[2]))
        w = trans * base * rel
        out = [w * jnp.exp(logs[0] - m), w * jnp.exp(logs[1] - m),
               w * jnp.exp(logs[2] - m)]
        if scat is not None:
            out = [o + sc for o, sc in zip(out, scat)]
        return (dtau, out[0], out[1], out[2])
    emis = jnp.exp(emis_q * jnp.log(r_in / rr))
    w = trans * base * emis * jnp.clip(g, 0.0, 4.0) ** 3
    if scat is not None:
        # scattered light is COLORED: fold the tint in-kernel per channel
        # (the shader then skips its grayscale tint scaling — the planar
        # scatter contract)
        return (dtau, w * pr[0, scatter_off] + scat[0],
                w * pr[0, scatter_off + 1] + scat[1],
                w * pr[0, scatter_off + 2] + scat[2])
    return dtau, w, w, w


def _kerr_kernel(max_steps: int, track_disk: bool, vol: bool,
                 scatter: bool,
                 blackbody: bool, beaming: bool,
                 params_ref, r_ref, th_ref, ph_ref, pr_ref, pth_ref,
                 E_ref, L_ref, *out_refs):
    dt = params_ref[0, 0]
    R = params_ref[0, 1]
    M = params_ref[0, 2]
    a = params_ref[0, 3]
    q2 = params_ref[0, 4]                # Kerr-Newman charge^2 (0 for Kerr)
    r_cap = params_ref[0, 5]
    r_in = params_ref[0, 6]
    r_out = params_ref[0, 7]

    r = r_ref[:]
    th = th_ref[:]
    ph = ph_ref[:]
    p_r = pr_ref[:]
    p_th = pth_ref[:]
    E = E_ref[:]
    L = L_ref[:]
    one = jnp.ones_like(r)
    zero = jnp.zeros_like(r)
    sign = jnp.zeros_like(r)
    steps = jnp.zeros_like(r)
    ct_prev = jnp.cos(th)
    h1 = jnp.zeros_like(r)
    h1f = jnp.zeros_like(r)
    h1d = jnp.zeros_like(r)
    h2 = jnp.zeros_like(r)
    h2f = jnp.zeros_like(r)
    h2d = jnp.zeros_like(r)
    if vol:
        tau_max = params_ref[0, VOL_BLOCK_KERR + VOL_SLOT["tau_max"]]
        b_ph = L / E                       # per-ray impact parameter L/E
        tau = jnp.zeros_like(r)
        emr = jnp.zeros_like(r)
        emg = jnp.zeros_like(r)
        emb = jnp.zeros_like(r)

    def cond(c):
        return (c[-1] < max_steps) & any_alive(c[5])

    ax_u0 = params_ref[0, 8]
    far_r0 = params_ref[0, 9]          # far-field accel radius (1e30 = off)

    def body(c):
        r, th, ph, p_r, p_th, sign, steps, ct_prev = c[:8]
        k0 = 8
        if track_disk:
            h1, h1f, h1d, h2, h2f, h2d = c[8:14]
            k0 = 14
        if vol:
            tau, emr, emg, emb = c[k0:k0 + 4]
        it = c[-1]
        # the steps < max_steps term stops each ray exactly at the cap
        alive = jnp.where((sign == 0.0) & (steps < max_steps), one, zero)
        # polar-axis step control: the theta-equation stiffens as
        # 1/sin^2 near theta = 0/pi; shrink dt up to 16x inside the
        # sin^2(theta) < ax_u0 band (ax_u0 = 0 disables via the guarded
        # ratio -> clip to 1).  Same rule in the XLA marchers.
        s_ax = jnp.sin(th)
        scale = jnp.clip((s_ax * s_ax + 1e-12)
                         / jnp.maximum(ax_u0, 1e-12), 1.0 / 16.0, 1.0)
        # far-field acceleration (ham.far_dt_scale — same algebra, so
        # XLA/pallas parity holds; disabled encodes as r/1e30 -> 1)
        fscale = jnp.clip(r / jnp.maximum(far_r0, 1e-12), 1.0, 8.0)
        dte = dt * alive * scale * fscale
        k1 = _kerr_rhs(M, a, q2, E, L, r, th, p_r, p_th)
        k2 = _kerr_rhs(M, a, q2, E, L, r + 0.5 * dte * k1[0],
                       th + 0.5 * dte * k1[1], p_r + 0.5 * dte * k1[3],
                       p_th + 0.5 * dte * k1[4])
        k3 = _kerr_rhs(M, a, q2, E, L, r + 0.5 * dte * k2[0],
                       th + 0.5 * dte * k2[1], p_r + 0.5 * dte * k2[3],
                       p_th + 0.5 * dte * k2[4])
        k4 = _kerr_rhs(M, a, q2, E, L, r + dte * k3[0], th + dte * k3[1],
                       p_r + dte * k3[3], p_th + dte * k3[4])
        w = dte * (1.0 / 6.0)
        live = alive > 0.5
        r1 = r + w * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
        th1 = th + w * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
        ph1 = ph + w * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
        pr1 = p_r + w * (k1[3] + 2.0 * (k2[3] + k3[3]) + k4[3])
        pth1 = p_th + w * (k1[4] + 2.0 * (k2[4] + k3[4]) + k4[4])
        if track_disk:
            ct = jnp.cos(th1)
            crossed = alive * jnp.where(ct_prev * ct < 0.0, one, zero)
            den = jnp.abs(ct_prev) + jnp.abs(ct)
            frac = jnp.abs(ct_prev) / jnp.maximum(den, 1e-30)
            r_hit = r + frac * (r1 - r)
            # BL azimuth at the crossing + approach side (sign of
            # cos theta just before) — the Kerr starlight-map lookup
            # coordinates (render/starlight.py contract in BL form)
            ph_hit = ph + frac * (ph1 - ph)
            side = jnp.where(ct_prev > 0.0, one, -one)
            in_disk = crossed * jnp.where(r_hit >= r_in, one, zero) \
                * jnp.where(r_hit <= r_out, one, zero)
            new1 = in_disk * jnp.where(h1 == 0.0, one, zero)
            new2 = in_disk * jnp.where(h1 != 0.0, one, zero) \
                * jnp.where(h2 == 0.0, one, zero)
            # select, not h += new*r_hit: a NaN r_hit (blown-up ray,
            # new = 0) would otherwise poison h via 0 * NaN
            h1 = jnp.where(new1 > 0.5, r_hit, h1)
            h1f = jnp.where(new1 > 0.5, ph_hit, h1f)
            h1d = jnp.where(new1 > 0.5, side, h1d)
            h2 = jnp.where(new2 > 0.5, r_hit, h2)
            h2f = jnp.where(new2 > 0.5, ph_hit, h2f)
            h2d = jnp.where(new2 > 0.5, side, h2d)
            ct_prev = jnp.where(live, ct, ct_prev)
        # select-gated writeback, not unconditional assignment: a frozen
        # ray (dte = 0) whose state sits where _kerr_rhs overflows
        # (Delta underflowing near the horizon) would otherwise compute
        # 0 * inf = NaN and overwrite its frozen exit state — the XLA
        # marchers where-mask the state, so this keeps backend
        # exit-state parity for captured rays (ADVICE round-2).
        r = jnp.where(live, r1, r)
        th = jnp.where(live, th1, th)
        ph = jnp.where(live, ph1, ph)
        p_r = jnp.where(live, pr1, p_r)
        p_th = jnp.where(live, pth1, p_th)
        # blowup guard: horizon-skimming / polar-axis rays can go
        # inf/NaN in f32 — freeze them with sign 3 (rendered black) so
        # they stop burning steps; NaN compares false to everything, so
        # `not (|r| <= BIG)` catches both inf and NaN.  The XLA marchers
        # use the identical predicate (render/kerr.py, hamiltonian.py).
        # full-state blowup check: a ray can escape with finite r but
        # NaN theta/phi/momenta (axis 1/sin^2 spikes), which would leak
        # NaN into the readout; the abs-sum catches NaN and inf in any
        # component (NaN compares false; overflowing sum is bad anyway)
        m_chk = (jnp.abs(r) + jnp.abs(th) + jnp.abs(ph)
                 + jnp.abs(p_r) + jnp.abs(p_th))
        ok = jnp.where(m_chk <= 1e8, one, zero)
        if vol:
            # emission at the post-step state, select-gated on the
            # finiteness check (0 * NaN = NaN: a multiplicative mask
            # cannot stop a blown-up state from poisoning tau/em)
            dtau, dr_, dg_, db_ = _kerr_vol_emission(
                blackbody, beaming, params_ref, r, th, b_ph, tau,
                scatter_off=KERR_SCATTER_OFF if scatter else None)
            gate = (alive * ok) > 0.5
            emr = emr + jnp.where(gate, dte * dr_, zero)
            emg = emg + jnp.where(gate, dte * dg_, zero)
            emb = emb + jnp.where(gate, dte * db_, zero)
            tau = tau + jnp.where(gate, dte * dtau, zero)
        sign = sign + alive * (ok * (jnp.where(r > R, one, zero)
                                     + 2.0 * jnp.where(r < r_cap, one,
                                                       zero))
                               + 3.0 * (one - ok))
        if vol:
            # tau_max freeze: OPAQUE == CAPTURED == 2 (render/disk.py)
            still = jnp.where(sign == 0.0, one, zero)
            sign = sign + still * 2.0 * jnp.where(tau > tau_max, one,
                                                  zero)
        steps = steps + alive
        ret = (r, th, ph, p_r, p_th, sign, steps, ct_prev)
        if track_disk:
            ret = ret + (h1, h1f, h1d, h2, h2f, h2d)
        if vol:
            ret = ret + (tau, emr, emg, emb)
        return ret + (it + 1,)

    carry0 = (r, th, ph, p_r, p_th, sign, steps, ct_prev)
    if track_disk:
        carry0 = carry0 + (h1, h1f, h1d, h2, h2f, h2d)
    if vol:
        carry0 = carry0 + (tau, emr, emg, emb)
    out = lax.while_loop(cond, body, carry0 + (jnp.int32(0),))
    r, th, ph, p_r, p_th, sign, steps = out[:7]
    out_refs[0][:] = r
    out_refs[1][:] = th
    out_refs[2][:] = ph
    out_refs[3][:] = p_r
    out_refs[4][:] = p_th
    out_refs[5][:] = sign.astype(jnp.int32)
    out_refs[6][:] = steps.astype(jnp.int32)
    if track_disk:
        for i in range(6):                   # h1, h1f, h1d, h2, h2f, h2d
            out_refs[7 + i][:] = out[8 + i]
    if vol:
        tau, emr, emg, emb = out[8:12]
        out_refs[7][:] = tau
        out_refs[8][:] = emr
        out_refs[9][:] = emg
        out_refs[10][:] = emb


def _kerr_outs(dtype, track_disk, vol):
    f, i32 = dtype, jnp.int32
    outs = [f, f, f, f, f, i32, i32]
    if track_disk:
        outs += [f] * 6                      # (r, phi, side) x two hits
    if vol:
        outs += [f] * 4                      # tau, em_r, em_g, em_b
    return outs


@functools.partial(jax.jit, static_argnums=tuple(range(6)))
def _kerr_call(max_steps, track_disk, vol, scatter, blackbody, beaming,
               params, *rays):
    kernel = functools.partial(_kerr_kernel, max_steps, track_disk,
                               vol, scatter, blackbody, beaming)
    return launch(kernel, params, list(rays),
                  _kerr_outs(rays[0].dtype, track_disk, vol),
                  name="kerr_rk4")


def march_kerr_pallas(metric, x0, p0, *, dt, max_steps, escape_radius,
                      capture_radius=None, disk=None, vol_disk=None,
                      vol_row=None, scatter_block=None, axis_u0=0.01,
                      far_r0=None):
    """Pallas Kerr march with the autodiff marcher's contract.

    ``x0`` (N, 4) contravariant BL position, ``p0`` (N, 4) covariant
    momentum; returns (x, p, sign, steps[, extra]) with the final t
    component zeroed (rendering never reads it).  ``disk=(r_in, r_out)``
    additionally records the first two equatorial-crossing (radius, BL
    azimuth, approach side) triples (extra = ((h1, h1f, h1d), (h2, h2f,
    h2d)); side = sign of cos theta just before the crossing — the Kerr
    starlight-map lookup coordinates).  ``vol_disk`` (a
    render.disk.DiskParams with volumetric=True) instead accumulates
    per-step volumetric radiative transfer through the flared gas disk
    (render/kerr.py:march_kerr_volumetric semantics; extra = (tau,
    (em_r, em_g, em_b))).
    """
    dtype = x0.dtype
    if capture_radius is None:
        capture_radius = metric.capture_radius
    vol = vol_disk is not None
    if vol:
        if disk is not None:
            raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not "
                             "both: thin-disk crossing tracking and "
                             "volumetric transfer share the kernel's extra "
                             "output slots")
        r_in, r_out = vol_disk.r_inner, vol_disk.r_outer
    else:
        r_in, r_out = disk if disk is not None else (0.0, 0.0)
    q = getattr(metric, "q", 0.0)        # Kerr-Newman charge (0 for Kerr)
    if far_r0 is None:
        far_r0 = 1e30                    # disabled: r/1e30 clips to 1 exact
    if vol and vol_row is not None:
        # adjoint path: (r_in, r_out, 8 _vol_param_slots) supplied as one
        # traced (10,) vector so the forward scalar row and the backward
        # replay consume bit-identical (possibly differentiated) values
        r_in, r_out = vol_row[0], vol_row[1]
    vals = [dt, escape_radius, metric.m, metric.a, q * q, capture_radius,
            r_in, r_out, axis_u0, far_r0]
    assert len(vals) == VOL_BLOCK_KERR          # layout contract, module top
    if vol:
        slots = (_vol_param_slots(vol_disk) if vol_row is None
                 else [vol_row[2 + i] for i in range(8)])
        vals += slots + [0.0, 0.0]
        if scatter_block is not None:
            # in-gas starlight source: 27 scalars at KERR_SCATTER_OFF
            assert len(vals) == KERR_SCATTER_OFF
            vals += [scatter_block[i] for i in range(SCATTER_BLOCK)]
    width = len(vals)
    params = jnp.stack([jnp.asarray(v, dtype) for v in vals]
                       ).reshape(1, width)

    outs = _kerr_call(
        max_steps, disk is not None and not vol, vol,
        vol and scatter_block is not None,
        vol and vol_disk.color_mode == "blackbody",
        vol and (vol_disk.redshift or vol_disk.doppler), params,
        x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2], -p0[:, 0],
        p0[:, 3])
    r, th, ph, p_r, p_th, sign, steps = outs[:7]
    zero = jnp.zeros_like(r)
    x = jnp.stack([zero, r, th, ph], axis=-1)
    E = -p0[:, 0]
    L = p0[:, 3]
    p = jnp.stack([-E, p_r, p_th, L], axis=-1)
    if vol:
        return x, p, sign, steps, (outs[7], (outs[8], outs[9], outs[10]))
    if disk is not None:
        return x, p, sign, steps, ((outs[7], outs[8], outs[9]),
                                   (outs[10], outs[11], outs[12]))
    return x, p, sign, steps


# ---------------------------------------------------------------------------
# Adaptive Kerr kernel: Dormand-Prince 5(4) on the 5-state BL flow with
# per-ray dt and accept/reject — error-controlled stepping instead of the
# fixed-RK4 kernel's hand-tuned axis/far heuristics (VERDICT round-2
# next-step #5).  Same tableau, error norm and controller as the XLA twin
# (integrate/rk45.py:march_kerr_rk45), so cross-backend parity is by
# construction; same escape/capture/blowup sentinels as _kerr_kernel.
# ---------------------------------------------------------------------------

def _kerr_rk45_kernel(max_steps: int, max_iters: int,
                      track_disk: bool, vol: bool, scatter: bool,
                      blackbody: bool, beaming: bool,
                      params_ref, r_ref, th_ref, ph_ref, pr_ref, pth_ref,
                      E_ref, L_ref, *out_refs):
    R = params_ref[0, 1]
    M = params_ref[0, 2]
    a = params_ref[0, 3]
    q2 = params_ref[0, 4]
    r_cap = params_ref[0, 5]
    r_in = params_ref[0, 6]
    r_out = params_ref[0, 7]
    rtol = params_ref[0, 8]
    atol = params_ref[0, 9]
    # vol widens the scalar row to the fixed kernel's emission layout (the 8
    # _vol_param_slots at VOL_BLOCK_KERR), pushing the controller bounds to
    # KERR_RK45_BOUNDS[True] (+1); non-vol keeps the compact 12-slot row
    dt_max = params_ref[0, KERR_RK45_BOUNDS[vol]]
    dt_min = params_ref[0, KERR_RK45_BOUNDS[vol] + 1]

    r = r_ref[:]
    th = th_ref[:]
    ph = ph_ref[:]
    p_r = pr_ref[:]
    p_th = pth_ref[:]
    E = E_ref[:]
    L = L_ref[:]
    one = jnp.ones_like(r)
    zero = jnp.zeros_like(r)
    sign = jnp.zeros_like(r)
    steps = jnp.zeros_like(r)
    itersv = jnp.zeros_like(r)         # per-ray lock-step iteration count
    dt = jnp.full_like(r, 1.0) * params_ref[0, 0]
    ct_prev = jnp.cos(th)
    h1 = jnp.zeros_like(r)
    h1f = jnp.zeros_like(r)
    h1d = jnp.zeros_like(r)
    h2 = jnp.zeros_like(r)
    h2f = jnp.zeros_like(r)
    h2d = jnp.zeros_like(r)
    if vol:
        tau_max = params_ref[0, VOL_BLOCK_KERR + VOL_SLOT["tau_max"]]
        b_ph = L / E                       # per-ray impact parameter L/E
        tau = jnp.zeros_like(r)
        emr = jnp.zeros_like(r)
        emg = jnp.zeros_like(r)
        emb = jnp.zeros_like(r)

    def cond(c):
        return (c[-1] < max_iters) & any_alive(c[6])

    def body(c):
        r, th, ph, p_r, p_th, dt, sign, steps, ct_prev = c[:9]
        k0 = 9
        if track_disk:
            h1, h1f, h1d, h2, h2f, h2d = c[9:15]
            k0 = 15
        if vol:
            tau, emr, emg, emb = c[k0:k0 + 4]
        itersv = c[-2]
        it = c[-1]
        alive = sign == 0.0
        # counts accepted AND rejected iterations while live — the
        # checkpointed-recompute adjoint replays exactly this many
        # iterations per ray (integrate/rk45_adjoint.py)
        itersv = itersv + jnp.where(alive, one, zero)
        ks = []
        for i in range(7):
            ri, ti, pri, pti = r, th, p_r, p_th
            for j, aa in enumerate(_DP_A[i]):
                ri = ri + dt * aa * ks[j][0]
                ti = ti + dt * aa * ks[j][1]
                pri = pri + dt * aa * ks[j][3]
                pti = pti + dt * aa * ks[j][4]
            ks.append(_kerr_rhs(M, a, q2, E, L, ri, ti, pri, pti))

        def comb(w, comp):
            acc = zero
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

        def ec(ei, y0, y1):
            return jnp.abs(dt * ei) / (atol + rtol * jnp.maximum(
                jnp.abs(y0), jnp.abs(y1)))

        err = jnp.maximum(
            jnp.maximum(ec(e[0], r, r1), ec(e[1], th, th1)),
            jnp.maximum(ec(e[2], p_r, pr1), ec(e[3], p_th, pth1)))
        accept = alive & (err <= 1.0)
        # boundary-stepping at escape (same rule as the XLA twin): a
        # grossly overshooting trial is REJECTED and retried with dt
        # scaled to land just past R, keeping full DP5 accuracy on the
        # final step instead of reading the direction several M out.
        # A trial landing within R*1e-3 PAST R is never "gross" and is
        # accepted whatever frac says: once f32 rounding parks r exactly
        # ON R, frac == 0 for every later escaping trial (including the
        # dt_min retry, which lands at R + ~1e-5), and a frac-only rule
        # would over-reject forever — one such ray spins its whole tile
        # to max_iters.
        esc_i = accept & (r1 > R)
        den = r1 - r
        den = jnp.where(jnp.abs(den) < 1e-30, one, den)
        frac = (R - r) / den
        over = esc_i & (frac < 0.9) & (r1 > R * (1.0 + 1e-3))
        accept = accept & ~over
        esc_i = esc_i & ~over

        if track_disk:
            # NB: local names must not shadow the boundary-stepping
            # (den, frac) above — dt_b below still reads them
            ct = jnp.cos(th1)
            crossed = jnp.where(accept & (ct_prev * ct < 0.0), one, zero)
            cden = jnp.abs(ct_prev) + jnp.abs(ct)
            cfrac = jnp.abs(ct_prev) / jnp.maximum(cden, 1e-30)
            r_hit = r + cfrac * (r1 - r)
            ph_hit = ph + cfrac * (ph1 - ph)
            side = jnp.where(ct_prev > 0.0, one, -one)
            in_disk = crossed * jnp.where(r_hit >= r_in, one, zero) \
                * jnp.where(r_hit <= r_out, one, zero)
            new1 = in_disk * jnp.where(h1 == 0.0, one, zero)
            new2 = in_disk * jnp.where(h1 != 0.0, one, zero) \
                * jnp.where(h2 == 0.0, one, zero)
            h1 = jnp.where(new1 > 0.5, r_hit, h1)
            h1f = jnp.where(new1 > 0.5, ph_hit, h1f)
            h1d = jnp.where(new1 > 0.5, side, h1d)
            h2 = jnp.where(new2 > 0.5, r_hit, h2)
            h2f = jnp.where(new2 > 0.5, ph_hit, h2f)
            h2d = jnp.where(new2 > 0.5, side, h2d)
            ct_prev = jnp.where(accept, ct, ct_prev)

        # select-gated writeback (frozen/rejected rays keep their state;
        # 0 * inf safety, same invariant as the fixed-step kernel)
        r = jnp.where(accept, r1, r)
        th = jnp.where(accept, th1, th)
        ph = jnp.where(accept, ph1, ph)
        p_r = jnp.where(accept, pr1, p_r)
        p_th = jnp.where(accept, pth1, p_th)

        m_chk = (jnp.abs(r) + jnp.abs(th) + jnp.abs(ph)
                 + jnp.abs(p_r) + jnp.abs(p_th))
        ok = jnp.where(m_chk <= 1e8, one, zero)
        acc_f = jnp.where(accept, one, zero)
        esc_f = jnp.where(esc_i, one, zero)
        if vol:
            # radiative transfer on ACCEPTED steps: emission at the
            # post-step state weighted by the accepted dt (the exact
            # quadrature the fixed kernel runs at its uniform dte);
            # select-gated on the finiteness check — 0 * NaN = NaN, a
            # multiplicative mask cannot stop a blown-up state from
            # poisoning tau/em
            dtau, dr_, dg_, db_ = _kerr_vol_emission(
                blackbody, beaming, params_ref, r, th, b_ph, tau,
                scatter_off=KERR_SCATTER_OFF if scatter else None)
            gate = accept & (ok > 0.5)
            emr = emr + jnp.where(gate, dt * dr_, zero)
            emg = emg + jnp.where(gate, dt * dg_, zero)
            emb = emb + jnp.where(gate, dt * db_, zero)
            tau = tau + jnp.where(gate, dt * dtau, zero)
        sign = sign + acc_f * (ok * (esc_f
                                     + 2.0 * jnp.where(r < r_cap, one,
                                                       zero))
                               + 3.0 * (one - ok))
        if vol:
            # tau_max freeze: OPAQUE == CAPTURED == 2 (render/disk.py)
            still = jnp.where(sign == 0.0, one, zero)
            sign = sign + still * 2.0 * jnp.where(tau > tau_max, one,
                                                  zero)
        # a reject at dt_min can never pass -> blowup freeze (the XLA
        # twin's 'stalled' rule; NaN err rejects land here too).  Over-
        # rejects are INCLUDED: their retry dt_b <= 0.945*dt shrinks
        # toward dt_min, and an over-reject AT dt_min would retry the
        # identical trial forever — with this rule every reject path
        # provably terminates.
        stalled = alive & ~accept & (dt <= dt_min * 1.01)
        sign = jnp.where(stalled, 3.0, sign)
        steps = steps + acc_f

        err_s = jnp.maximum(err, 1e-10)
        factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(err_s)), 0.2, 5.0)
        factor = jnp.where(factor > 0.0, factor, 0.2)   # NaN err -> 0.2
        dt_b = jnp.clip(dt * frac * 1.05, dt_min, dt_max)
        live = alive & (sign == 0.0)
        dt = jnp.where(live, jnp.clip(dt * factor, dt_min, dt_max), dt)
        dt = jnp.where(over & (sign == 0.0), dt_b, dt)
        if track_disk or vol:
            # thin-disk crossings / gas quadrature need base resolution
            # inside the disk region: a multi-unit adaptive step can
            # contain a FULL theta oscillation (plane crossed in and
            # out, same-sign cos(theta) endpoints) that the crossing
            # detector cannot see, and the volumetric emission is a
            # first-order quadrature whose resolution the error control
            # does not bound.  The GAS region is a cylinder (emission
            # is exactly zero for r sin(theta) > r_out via the edge
            # clip), so vol clamps on the CYLINDRICAL radius — a
            # spherical r guard would leave off-plane gas (r up to
            # r_out/sin(theta)) marched at dt_max, a measured 5% flux
            # error at inclination 0.3.  Crossing tracking only matters
            # near the equator, where the spherical guard is the same.
            if vol:
                # ANTICIPATORY clamp on distance to the gas SLAB:
                # inside it dt <= dt0; approaching it, dt <= half the
                # larger of the radial gap (to the r_out + 2M cylinder)
                # and the vertical gap (to the 5-sigma density shell
                # |z| ~ 5 h_rel r_cyl, where dens ~ e^-12.5) —
                # |dr/dlambda|, |dz/dlambda| <= ~1 for E ~ 1 photons,
                # so a step can never leap from dt_max straight across
                # the gas (a reactive clamp leaves the ENTRY step
                # unresolved: measured 5% flux error), while zero-
                # emission polar rays inside the cylinder keep adaptive
                # steps instead of being pinned to dt0
                s_th = jnp.abs(jnp.sin(th))
                r_cyl = r * s_th
                gap_r = r_cyl - (r_out + 2.0 * M)
                h_rel5 = 5.0 * jnp.sqrt(
                    params_ref[0, VOL_BLOCK_KERR + VOL_SLOT["h2"]])
                gap_z = r * jnp.abs(jnp.cos(th)) - h_rel5 * r_cyl
                dt_gas = jnp.maximum(params_ref[0, 0],
                                     0.5 * jnp.maximum(gap_r, gap_z))
                dt = jnp.where(sign == 0.0, jnp.minimum(dt, dt_gas), dt)
            else:
                near = r < (r_out + 2.0 * M)
                dt = jnp.where(near & (sign == 0.0),
                               jnp.minimum(dt, params_ref[0, 0]), dt)
        # step-cap freeze with the planar-rk45 sentinel (iterations !=
        # steps here, so the cond cannot bound steps by itself)
        sign = jnp.where((sign == 0.0) & (steps >= max_steps), -128.0,
                         sign)
        ret = (r, th, ph, p_r, p_th, dt, sign, steps, ct_prev)
        if track_disk:
            ret = ret + (h1, h1f, h1d, h2, h2f, h2d)
        if vol:
            ret = ret + (tau, emr, emg, emb)
        return ret + (itersv, it + 1)

    carry0 = (r, th, ph, p_r, p_th, dt, sign, steps, ct_prev)
    if track_disk:
        carry0 = carry0 + (h1, h1f, h1d, h2, h2f, h2d)
    if vol:
        carry0 = carry0 + (tau, emr, emg, emb)
    out = lax.while_loop(cond, body, carry0 + (itersv, jnp.int32(0)))
    r, th, ph, p_r, p_th, _, sign, steps, _ = out[:9]
    itersv = out[-2]
    sign = jnp.where(sign == -128.0, 0.0, sign)
    out_refs[0][:] = r
    out_refs[1][:] = th
    out_refs[2][:] = ph
    out_refs[3][:] = p_r
    out_refs[4][:] = p_th
    out_refs[5][:] = sign.astype(jnp.int32)
    out_refs[6][:] = steps.astype(jnp.int32)
    if track_disk:
        for i in range(6):                   # h1, h1f, h1d, h2, h2f, h2d
            out_refs[7 + i][:] = out[9 + i]
    if vol:
        tau, emr, emg, emb = out[9:13]
        out_refs[7][:] = tau
        out_refs[8][:] = emr
        out_refs[9][:] = emg
        out_refs[10][:] = emb
    out_refs[-1][:] = itersv.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=tuple(range(7)))
def _kerr_rk45_call(max_steps, max_iters, track_disk, vol, scatter,
                    blackbody, beaming, params, *rays):
    kernel = functools.partial(_kerr_rk45_kernel, max_steps, max_iters,
                               track_disk, vol, scatter, blackbody, beaming)
    return launch(kernel, params, list(rays),
                  _kerr_outs(rays[0].dtype, track_disk, vol) + [jnp.int32],
                  name="kerr_rk45")


def march_kerr_rk45_pallas(metric, x0, p0, *, dt0=0.1, max_steps=4_000,
                           max_iters=None, escape_radius, rtol=1e-4,
                           atol=1e-7, dt_min=1e-5, dt_max=None,
                           capture_radius=None, disk=None, vol_disk=None,
                           vol_row=None, scatter_block=None,
                           return_iters=False):
    """Error-controlled Pallas Kerr/KN march — the kernel twin of
    integrate/rk45.py:march_kerr_rk45 (same contract as march_kerr_pallas;
    ``steps`` counts accepted steps).  ``vol_disk`` (DiskParams with
    volumetric=True) accumulates in-kernel radiative transfer on accepted
    steps, weighted by each ray's accepted dt (extra = (tau, (em_r, em_g,
    em_b))); inside r_out + 2M the step is clamped to dt0 so the gas
    quadrature keeps the fixed kernel's resolution."""
    dtype = x0.dtype
    if capture_radius is None:
        capture_radius = metric.capture_radius
    if dt_max is None:
        dt_max = escape_radius / 8.0        # traced-safe (rides the scalar row)
    if max_iters is None:
        max_iters = 4 * max_steps
    vol = vol_disk is not None
    if vol:
        if disk is not None:
            raise ValueError("pass disk=(r_in, r_out) OR vol_disk, not "
                             "both: thin-disk crossing tracking and "
                             "volumetric transfer share the kernel's extra "
                             "output slots")
        r_in, r_out = vol_disk.r_inner, vol_disk.r_outer
    else:
        r_in, r_out = disk if disk is not None else (0.0, 0.0)
    q = getattr(metric, "q", 0.0)
    if vol and vol_row is not None:
        # adjoint path: traced (10,) (r_in, r_out, slots) vector — see
        # march_kerr_pallas
        r_in, r_out = vol_row[0], vol_row[1]
    vals = [dt0, escape_radius, metric.m, metric.a, q * q, capture_radius,
            r_in, r_out, rtol, atol]
    assert len(vals) == VOL_BLOCK_KERR          # layout contract, module top
    if vol:
        # the 8 _vol_param_slots mirror the fixed kernel's emission layout
        # (read by index in _kerr_vol_emission); controller bounds move up
        vals += (_vol_param_slots(vol_disk) if vol_row is None
                 else [vol_row[2 + i] for i in range(8)])
    assert len(vals) == KERR_RK45_BOUNDS[vol]
    vals += [dt_max, dt_min]
    if vol and scatter_block is not None:
        assert len(vals) == KERR_SCATTER_OFF
        vals += [scatter_block[i] for i in range(SCATTER_BLOCK)]
    params = jnp.stack([jnp.asarray(v, dtype) for v in vals]
                       ).reshape(1, len(vals))

    outs = _kerr_rk45_call(
        max_steps, int(max_iters), disk is not None and not vol, vol,
        vol and scatter_block is not None,
        vol and vol_disk.color_mode == "blackbody",
        vol and (vol_disk.redshift or vol_disk.doppler), params,
        x0[:, 1], x0[:, 2], x0[:, 3], p0[:, 1], p0[:, 2], -p0[:, 0],
        p0[:, 3])
    r, th, ph, p_r, p_th, sign, steps = outs[:7]
    zero = jnp.zeros_like(r)
    x = jnp.stack([zero, r, th, ph], axis=-1)
    E = -p0[:, 0]
    L = p0[:, 3]
    p = jnp.stack([-E, p_r, p_th, L], axis=-1)
    ret = [x, p, sign, steps]
    if vol:
        ret.append((outs[7], (outs[8], outs[9], outs[10])))
    elif disk is not None:
        ret.append(((outs[7], outs[8], outs[9]),
                    (outs[10], outs[11], outs[12])))
    if return_iters:
        ret.append(outs[-1])               # iteration count is always last
    return tuple(ret)
