"""On-chip Pallas-vs-XLA parity gates for every kernel family.

The CPU test suite runs every kernel in interpret mode — that validates
the *traced math* but not the GPU compile: a miscompile, or an operation
the Triton route lowers differently, would sail through the tests and only
corrupt images on the card.  These gates close that hole: each kernel
family runs compiled on the card against its XLA twin, and the comparison
uses mismatch-fraction bounds (f32 kernel vs f32 XLA; bitwise equality is
impossible for chaos-adjacent rays — CLAUDE.md invariant).

``run_gates(full=True)`` runs them at the frame sizes the README renders:
1024^2 for the planar Euler / RK45 families, 512x288 for the disk,
volume and Kerr families (chip_smoke.py phase 3); the default small
bundles keep the CPU tests (tests/test_parity_gates.py) fast.  Each result
carries the kernel side's compile time and ``memory_analysis()``.

Families: euler (Ellis + DNEG shape paths), rk45, fused (spawn, march and
readout in one kernel; Euler and DP5(4)), disk, volumetric, kerr, kn,
kerr_rk45 (bare, disk, volume, scatter), table (Chebyshev user metrics).
"""
from __future__ import annotations

import time

import numpy as np

# gate sizes: (planar frame, disk/Kerr frame) — small for the CPU tests,
# the README's frame sizes on the card
_SMALL = {"planar": (32, 16), "disk": (24, 12), "kerr": 128}
_FULL = {"planar": (1024, 1024), "disk": (512, 288), "kerr": 512 * 288}
_SIZE = _SMALL
_STATS: dict = {}


def _kernel(fn, *args):
    """Compile ``fn`` (the kernel side of a gate) explicitly, record its
    compile time and memory analysis for the running gate, and run it."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    _STATS["compile_s"] = round(time.perf_counter() - t0, 3)
    mem = compiled.memory_analysis()
    if mem is not None:
        _STATS["memory"] = {k: int(getattr(mem, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)}
    return compiled(*args)


def _bundle(metric, cam_pos, face, res, dtype):
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.camera.camera import pixel_rays_world
    from curvis_tpu.physics import planar as pl2
    cam = cv.make_camera(cam_pos, face, [0.0, 0.0, 1.0], 15.0, 43.0,
                         res[0], res[1], dtype=dtype)
    rays = pl2.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    return pl2.PlanarRays(*(a.astype(jnp.float32) for a in rays))


def _escape_mismatch(res_a, res_b, tol=1e-3):
    """(sign-agreement fraction, fraction of escaped rays with |dpsi|>tol)."""
    sa, sb = np.asarray(res_a.sign), np.asarray(res_b.sign)
    agree = (sa == sb).mean()
    esc = (sa == sb) & ((sa == 1) | (sa == -1))
    if esc.sum() == 0:
        return float(agree), 1.0
    dpsi = np.abs(np.asarray(res_a.psi)[esc] - np.asarray(res_b.psi)[esc])
    return float(agree), float((dpsi > tol).mean())


def gate_euler(kind="ellis"):
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.base import EllisMetric, InterstellarMetric
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    from curvis_tpu.physics import planar as pl2
    if kind == "ellis":
        metric = EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    else:
        metric = InterstellarMetric(m=jnp.asarray(0.1, jnp.float32),
                                    a=jnp.asarray(1e-4, jnp.float32),
                                    rho=jnp.asarray(1.0, jnp.float32))
    rays = _bundle(metric, [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                   _SIZE["planar"], jnp.float32)
    kw = dict(dt=0.05, max_steps=8000, escape_radius=30.0)
    a = jax.jit(lambda m, r: pl2.march_planar_while(m, r, **kw))(metric, rays)
    b = _kernel(lambda m, r: march_planar_pallas(m, r, **kw), metric, rays)
    agree, mm = _escape_mismatch(a, b, tol=1e-3 if kind == "ellis" else 1e-2)
    return {"sign_agree": round(agree, 4), "psi_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.97 and mm <= 0.05)}


def gate_rk45():
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.base import EllisMetric
    from curvis_tpu.integrate.rk45 import march_planar_rk45
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    metric = EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    rays = _bundle(metric, [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                   _SIZE["planar"], jnp.float32)
    kw = dict(escape_radius=50.0, rtol=1e-5, atol=1e-7)
    a = jax.jit(lambda m, r: march_planar_rk45(m, r, **kw))(metric, rays)
    b = _kernel(lambda m, r: march_planar_rk45_pallas(m, r, **kw), metric, rays)
    agree, mm = _escape_mismatch(a, b, tol=2e-3)
    return {"sign_agree": round(agree, 4), "psi_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.97 and mm <= 0.05)}


def gate_fused(stepper="euler"):
    """The fused render kernel (ops/render_fused.py) vs the same frame
    with XLA spawn, march and readout, on a smooth sky: the share of
    pixels more than 0.02 apart, and the median difference."""
    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.render.fast import render_planar_fused
    metric = cv.EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    yy, xx = np.mgrid[0:32, 0:64]
    smooth = np.stack([np.sin(2 * np.pi * xx / 64) * 0.5 + 0.5, yy / 32,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / 32)],
                      -1).astype("float32")
    bgp = cv.make_spherical_image(smooth)
    bgn = cv.make_spherical_image(smooth[::-1].copy())
    res = _SIZE["planar"]
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05],
                         [0.0, 0.0, 1.0], 15.0, 43.0, res[0], res[1],
                         dtype=jnp.float32)
    kw = dict(dt=0.05, escape_radius=50.0, filtering="bilinear",
              stepper=stepper)
    kw.update(dict(max_steps=2000, rtol=1e-4) if stepper == "rk45"
              else dict(max_steps=8000))

    def render(backend):
        return lambda m, c, p, n: render_planar_fused(m, c, p, n,
                                                      backend=backend, **kw)

    args = (metric, cam, bgp, bgn)
    a = np.asarray(jax.jit(render("tiled"))(*args))
    b = np.asarray(_kernel(render("pallas"), *args))
    d = np.abs(a - b).max(-1)
    mm = float((d > 0.02).mean())
    med = float(np.median(d))
    return {"mismatch_2pct": round(mm, 5), "median": round(med, 6),
            "finite": bool(np.isfinite(b).all()),
            "ok": bool(mm < 0.02 and med < 1e-3 and np.isfinite(b).all())}


def _disk_setup(metric=None):
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.metrics.base import SchwarzschildMetric
    from curvis_tpu.physics import planar as pl2
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa
    if metric is None:
        metric = SchwarzschildMetric(m=jnp.asarray(1.0, jnp.float32))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, *_SIZE["disk"], dtype=jnp.float32)
    dx, dy, dz = _pixel_dirs_soa(cam, False)
    (l, psi, p_l, b), r_hat, e2 = _spawn_planar_soa(metric, cam, dx, dy, dz)
    c1 = jnp.broadcast_to(r_hat[2], l.shape).astype(jnp.float32)
    c2 = e2[2].astype(jnp.float32)
    nz = (r_hat[0] * e2[1] - r_hat[1] * e2[0]).astype(jnp.float32)
    rays = pl2.PlanarRays(*(a.astype(jnp.float32) for a in (l, psi, p_l, b)),
                          jnp.zeros((1, 3), jnp.float32),
                          jnp.zeros((1, 3), jnp.float32))
    return metric, rays, c1, c2, nz


def gate_disk():
    import jax
    from curvis_tpu.ops.march_pallas import march_planar_disk_pallas
    from curvis_tpu.render.disk import march_planar_disk
    metric, rays, c1, c2, _ = _disk_setup()
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0,
              r_inner=5.2, r_outer=13.0)
    res_a, (h1a, _, s1a), _ = jax.jit(
        lambda m, r, a, b: march_planar_disk(m, r, a, b, **kw))(
            metric, rays, c1, c2)
    res_b, (h1b, _, s1b), _ = _kernel(
        lambda m, r, a, b: march_planar_disk_pallas(m, r, a, b, **kw), metric, rays, c1, c2)
    sign_agree = float((np.asarray(res_a.sign) == np.asarray(res_b.sign))
                       .mean())
    hit_a, hit_b = np.asarray(h1a) > 0, np.asarray(h1b) > 0
    hit_agree = float((hit_a == hit_b).mean())
    both = hit_a & hit_b
    rel = (np.abs(np.asarray(h1a)[both] - np.asarray(h1b)[both])
           / np.maximum(np.asarray(h1a)[both], 1e-6)) if both.any() else \
        np.zeros(1)
    # psi-at-crossing (starlight shading input, round 4): same crossings
    # -> the interpolated psi must agree to the same f32 tolerance
    psi_err = (np.abs(np.asarray(s1a)[both] - np.asarray(s1b)[both])
               if both.any() else np.zeros(1))
    return {"sign_agree": round(sign_agree, 4),
            "hit_agree": round(hit_agree, 4),
            "hit_r_relmax": round(float(rel.max()), 5),
            "hit_psi_max": round(float(psi_err.max()), 5),
            "ok": bool(sign_agree >= 0.97 and hit_agree >= 0.95
                       and rel.max() < 1e-2 and psi_err.max() < 1e-2)}


def gate_volumetric():
    import jax
    from curvis_tpu.ops.march_pallas import \
        march_planar_disk_volumetric_pallas
    from curvis_tpu.render.disk import (DiskParams,
                                        march_planar_disk_volumetric)
    metric, rays, c1, c2, nz = _disk_setup()
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0)
    disk = DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                      h_rel=0.08, kappa=3.0, color_mode="tint",
                      t_peak=7000.0)
    _, tau_a, _ = jax.jit(lambda m, r, a, b, n: march_planar_disk_volumetric(
        m, r, a, b, n, params=disk, **kw))(metric, rays, c1, c2, nz)
    _, tau_b, _ = _kernel(
        lambda m, r, a, b, n: march_planar_disk_volumetric_pallas(
            m, r, a, b, n, disk=disk, **kw), metric, rays, c1, c2, nz)
    ta, tb = np.asarray(tau_a), np.asarray(tau_b)
    rel = np.abs(ta - tb) / np.maximum(np.abs(ta), 1e-4)
    mm = float((rel > 1e-2).mean())
    return {"tau_mismatch": round(mm, 4), "ok": bool(mm <= 0.05)}


def gate_rk45_disk():
    """Planar rk45 x thin-disk (round 4: the planar stepper x surface
    matrix) — compiled kernel vs the XLA twin.  Chaos-adjacent decision
    flips relocate isolated crossings (a flipped accept near the photon
    sphere changes the whole downstream trajectory), so crossing radii are
    bounded by mismatch FRACTION, not max."""
    import jax
    from curvis_tpu.integrate.rk45 import march_planar_rk45
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    metric, rays, c1, c2, _ = _disk_setup()
    kw = dict(escape_radius=60.0, rtol=1e-5, atol=1e-7, dt0=0.05,
              max_steps=20_000)
    res_a, (h1a, _, _s1a), _ = jax.jit(lambda m, r, a, b: march_planar_rk45(
        m, r, c1=a, c2=b, disk=(5.2, 13.0), **kw))(metric, rays, c1, c2)
    res_b, (h1b, _, _s1b), _ = _kernel(
        lambda m, r, a, b: march_planar_rk45_pallas(
            m, r, c1=a, c2=b, disk=(5.2, 13.0),
            **kw), metric, rays, c1, c2)
    sign_agree = float((np.asarray(res_a.sign) == np.asarray(res_b.sign))
                       .mean())
    hit_a, hit_b = np.asarray(h1a) > 0, np.asarray(h1b) > 0
    hit_agree = float((hit_a == hit_b).mean())
    both = hit_a & hit_b
    rel = (np.abs(np.asarray(h1a)[both] - np.asarray(h1b)[both])
           / np.maximum(np.asarray(h1a)[both], 1e-6)) if both.any() else \
        np.zeros(1)
    mm = float((rel > 1e-2).mean())
    return {"sign_agree": round(sign_agree, 4),
            "hit_agree": round(hit_agree, 4),
            "hit_r_mismatch": round(mm, 4),
            "ok": bool(sign_agree >= 0.97 and hit_agree >= 0.95
                       and mm <= 0.08)}


def gate_rk45_vol():
    """Planar rk45 x volumetric — compiled kernel vs the XLA twin (both
    evaluate the SAME _vol_emission, so tau/emission agree to f32
    accumulation noise)."""
    import jax
    from curvis_tpu.integrate.rk45 import march_planar_rk45
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    from curvis_tpu.render.disk import DiskParams
    metric, rays, c1, c2, nz = _disk_setup()
    disk = DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                      h_rel=0.08, kappa=3.0, color_mode="tint",
                      t_peak=7000.0)
    kw = dict(escape_radius=60.0, rtol=1e-5, atol=1e-7, dt0=0.05,
              max_steps=20_000)
    ra, tau_a, em_a = jax.jit(lambda m, r, a, b, n: march_planar_rk45(
        m, r, c1=a, c2=b, nz=n, vol_disk=disk, **kw))(metric, rays, c1,
                                                      c2, nz)
    rb, tau_b, em_b = _kernel(
        lambda m, r, a, b, n: march_planar_rk45_pallas(
            m, r, c1=a, c2=b, nz=n, vol_disk=disk,
            **kw), metric, rays, c1, c2, nz)
    agree = float((np.asarray(ra.sign) == np.asarray(rb.sign)).mean())
    ta, tb = np.asarray(tau_a), np.asarray(tau_b)
    d_tau = float(np.abs(ta - tb).sum() / max(np.abs(ta).sum(), 1e-6))
    ea = np.stack([np.asarray(c) for c in em_a])
    eb = np.stack([np.asarray(c) for c in em_b])
    d_em = float(np.abs(ea - eb).sum() / max(np.abs(ea).sum(), 1e-6))
    return {"sign_agree": round(agree, 4), "tau_rel_l1": round(d_tau, 5),
            "em_rel_l1": round(d_em, 5),
            "ok": bool(agree >= 0.95 and d_tau <= 0.02 and d_em <= 0.02)}


def _kerr_bundle(metric):
    import jax.numpy as jnp
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(0)
    n = _SIZE["kerr"]
    ths = np.pi / 2 + 0.4 * rng.standard_normal(n)
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 30.0), ths,
                               np.zeros(n)], -1), jnp.float32)
    dirs = rng.standard_normal((n, 3))
    dirs[:, 0] = -np.abs(dirs[:, 0]) - 0.5
    d = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
                    jnp.float32)
    p0 = ham.spawn_photon(metric, x0, d)
    return x0, p0


def gate_kerr(charged=False):
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.kerr import KerrMetric, KerrNewmanMetric
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.physics import hamiltonian as ham
    if charged:
        metric = KerrNewmanMetric(m=jnp.asarray(1.0, jnp.float32),
                                  a=jnp.asarray(0.7, jnp.float32),
                                  q=jnp.asarray(0.4, jnp.float32))
    else:
        metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                            a=jnp.asarray(0.9, jnp.float32))
    x0, p0 = _kerr_bundle(metric)
    kw = dict(dt=0.1, max_steps=20_000, escape_radius=60.0)
    res = jax.jit(lambda m, x, p: ham.march_hamiltonian(
        m, x, p, capture_radius=m.capture_radius, **kw))(metric, x0, p0)
    x_k, _, sign_k, _ = _kernel(lambda m, x, p: march_kerr_pallas(
        m, x, p, **kw), metric, x0, p0)
    sa, sk = np.asarray(res.sign), np.asarray(sign_k)
    agree = float((sa == sk).mean())
    esc = (sa == sk) & (sa == 1)
    if esc.sum():
        dth = np.abs(np.asarray(res.x[:, 2])[esc]
                     - np.asarray(x_k[:, 2])[esc])
        mm = float((dth > 1e-2).mean())
    else:
        mm = 1.0
    return {"sign_agree": round(agree, 4), "theta_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.95 and mm <= 0.05)}


def gate_kerr_rk45():
    """Error-controlled BL march: the Pallas DP5(4) kernel (compiled) vs
    its XLA twin — same tableau/norm/controller, so accepted-step counts
    must agree ray-for-ray up to f32 round-off flips at the accept
    threshold; escape states compared by mismatch fraction."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.integrate.rk45 import march_kerr_rk45
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
    from curvis_tpu.physics import hamiltonian as ham
    metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.9, jnp.float32))
    x0, p0 = _kerr_bundle(metric)
    kw = dict(escape_radius=60.0, rtol=1e-4, atol=1e-7, max_steps=4_000)
    res = jax.jit(lambda m, x, p: march_kerr_rk45(
        m, x, p, capture_radius=m.capture_radius, **kw))(metric, x0, p0)
    x_k, _, sign_k, _ = _kernel(lambda m, x, p: march_kerr_rk45_pallas(
        m, x, p, **kw), metric, x0, p0)
    sa, sk = np.asarray(res.sign), np.asarray(sign_k)
    agree = float((sa == sk).mean())
    esc = (sa == sk) & (sa == 1)
    if esc.sum():
        dth = np.abs(np.asarray(res.x[:, 2])[esc]
                     - np.asarray(x_k[:, 2])[esc])
        mm = float((dth > 1e-2).mean())
    else:
        mm = 1.0
    return {"sign_agree": round(agree, 4), "theta_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.95 and mm <= 0.05)}


def gate_kerr_rk45_vol():
    """Volumetric rk45 (round 3): the DP5(4) kernel's in-kernel radiative
    transfer (compiled) vs the fixed-step XLA volumetric oracle.  Cross-
    stepper, so bounds are quadrature-level, not ulp-level: the rk45 gas
    clamp pins dt to dt0 inside/approaching the gas cylinder, making the
    two quadratures near-identical there (measured: 0.3% of image pixels
    >0.1 apart at 512x288; here tau/aggregate-emission agreement on the
    probe bundle)."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import march_kerr_volumetric
    metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.9, jnp.float32))
    x0, p0 = _kerr_bundle(metric)
    disk = DiskParams(r_inner=2.5, r_outer=9.0, volumetric=True, h_rel=0.08,
                      kappa=3.0, color_mode="tint", t_peak=7000.0)
    _, _, sa, tau_a, em_a = jax.jit(lambda m, x, p: march_kerr_volumetric(
        m, x, p, dt=0.1, max_steps=20_000, escape_radius=60.0,
        params=disk))(metric, x0, p0)
    _, _, sb, _, (tau_b, em_b) = _kernel(
        lambda m, x, p: march_kerr_rk45_pallas(
            m, x, p, dt0=0.1, max_steps=8_000, escape_radius=60.0,
            rtol=1e-4, atol=1e-7, vol_disk=disk), metric, x0, p0)
    agree = float((np.asarray(sa) == np.asarray(sb)).mean())
    ta, tb = np.asarray(tau_a), np.asarray(tau_b)
    d_tau = float(np.abs(ta - tb).sum() / max(np.abs(ta).sum(), 1e-6))
    ea = np.stack([np.asarray(c) for c in em_a])
    eb = np.stack([np.asarray(c) for c in em_b])
    d_em = float(np.abs(ea - eb).sum() / max(np.abs(ea).sum(), 1e-6))
    return {"sign_agree": round(agree, 4), "tau_rel_l1": round(d_tau, 4),
            "em_rel_l1": round(d_em, 4),
            "ok": bool(agree >= 0.93 and d_tau <= 0.05 and d_em <= 0.05)}


def gate_kerr_scatter():
    """Kerr in-gas starlight scattering (round 5): the fixed BL kernel
    with the 27-scalar scatter tail at KERR_SCATTER_OFF (compiled) vs the
    XLA RK4 twin with the identical block — same stepper and quadrature,
    so bounds are the f32 chaotic-band class, not quadrature-level."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import march_kerr_volumetric
    from curvis_tpu.render.starlight import (StarlightMap,
                                             starlight_scatter_block)
    metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.9, jnp.float32))
    x0, p0 = _kerr_bundle(metric)
    disk = DiskParams(r_inner=2.5, r_outer=9.0, volumetric=True, h_rel=0.08,
                      kappa=3.0, color_mode="tint", albedo=(0.5, 0.3, 0.2),
                      starlight_scatter=0.7, tint=(1.0, 0.7, 0.4))
    n_r = 10
    rng = np.random.default_rng(5)
    smap = StarlightMap(
        jnp.linspace(2.5, 9.0, n_r),
        jnp.asarray(0.2 + 0.6 * rng.random((2, n_r, 8, 3)), jnp.float32))
    blk = starlight_scatter_block(smap, disk, jnp.float32)
    _, _, sa, tau_a, em_a = jax.jit(lambda m, x, p, b: march_kerr_volumetric(
        m, x, p, dt=0.1, max_steps=20_000, escape_radius=60.0,
        params=disk, scatter_block=b))(metric, x0, p0, blk)
    _, _, sb, _, (tau_b, em_b) = _kernel(
        lambda m, x, p, b: march_kerr_pallas(
            m, x, p, dt=0.1, max_steps=20_000, escape_radius=60.0,
            vol_disk=disk, scatter_block=b, far_r0=None), metric, x0, p0, blk)
    agree = float((np.asarray(sa) == np.asarray(sb)).mean())
    ta, tb = np.asarray(tau_a), np.asarray(tau_b)
    d_tau = float(np.abs(ta - tb).sum() / max(np.abs(ta).sum(), 1e-6))
    ea = np.stack([np.asarray(c) for c in em_a])
    eb = np.stack([np.asarray(c) for c in em_b])
    d_em = float(np.abs(ea - eb).sum() / max(np.abs(ea).sum(), 1e-6))
    return {"sign_agree": round(agree, 4), "tau_rel_l1": round(d_tau, 4),
            "em_rel_l1": round(d_em, 4),
            "ok": bool(agree >= 0.93 and d_tau <= 0.05 and d_em <= 0.05)}


def gate_table():
    """User-metric kernel path (metrics/table.py): the Chebyshev-table
    Pallas march (kind 'cheb{K}', compiled) vs the XLA while marcher
    evaluating the *same* TabulatedMetric — identical polynomials, so any
    disagreement is a compile issue, not fit error."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.table import tabulate_metric
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    from curvis_tpu.physics import planar as pl2

    def r_fn(l):
        rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)     # asymmetric Bell wormhole
        return jnp.sqrt(rho * rho + l * l)

    tab, _ = tabulate_metric(r_fn, degree=16, tol=5e-4)
    tab = jax.tree.map(lambda a: a.astype(jnp.float32), tab)
    rays = _bundle(tab, [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                   _SIZE["planar"], jnp.float32)
    kw = dict(dt=0.05, max_steps=8000, escape_radius=30.0)
    a = jax.jit(lambda m, r: pl2.march_planar_while(m, r, **kw))(tab, rays)
    b = _kernel(lambda m, r: march_planar_pallas(
        m, r, **kw), tab, rays)
    agree, mm = _escape_mismatch(a, b, tol=1e-3)
    return {"sign_agree": round(agree, 4), "psi_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.97 and mm <= 0.05)}


def _table_metric():
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.table import tabulate_metric

    def r_fn(l):
        rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)     # asymmetric Bell wormhole
        return jnp.sqrt(rho * rho + l * l)

    tab, _ = tabulate_metric(r_fn, degree=16, tol=5e-4)
    return jax.tree.map(lambda a: a.astype(jnp.float32), tab)


def gate_table_rk45():
    """cheb x rk45 combo compiled for the card (round-3 VERDICT weak #4:
    the table-metric kernel combos were interpret-tested only, and the
    cheb tail offset is exactly the bug class that shipped twice).

    tol 6e-3, not the analytic families' 2e-3: BOTH twins sit ~1.7e-3
    median / 4e-3 max from a tight-tolerance oracle — the f32 degree-16
    table evaluation noise amplified through throat-grazing deflection
    (each twin rounds the Clenshaw chain differently, and the
    controller's accept flips decorrelate them).  A layout bug
    (the class this gate exists for) produces O(1) garbage, far above
    this floor."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.integrate.rk45 import march_planar_rk45
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    tab = _table_metric()
    rays = _bundle(tab, [0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                   _SIZE["planar"], jnp.float32)
    kw = dict(escape_radius=30.0, rtol=1e-5, atol=1e-7)
    a = jax.jit(lambda m, r: march_planar_rk45(m, r, **kw))(tab, rays)
    b = _kernel(lambda m, r: march_planar_rk45_pallas(
        m, r, **kw), tab, rays)
    agree, mm = _escape_mismatch(a, b, tol=6e-3)
    return {"sign_agree": round(agree, 4), "psi_mismatch": round(mm, 4),
            "ok": bool(agree >= 0.97 and mm <= 0.05)}


def gate_table_disk():
    """cheb x thin-disk crossing-capture combo compiled for the card."""
    import jax
    from curvis_tpu.ops.march_pallas import march_planar_disk_pallas
    from curvis_tpu.render.disk import march_planar_disk
    metric, rays, c1, c2, _ = _disk_setup(_table_metric())
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0,
              r_inner=3.0, r_outer=13.0)
    res_a, (h1a, _, _s1a), _ = jax.jit(
        lambda m, r, a, b: march_planar_disk(m, r, a, b, **kw))(
            metric, rays, c1, c2)
    res_b, (h1b, _, _s1b), _ = _kernel(
        lambda m, r, a, b: march_planar_disk_pallas(
            m, r, a, b, **kw), metric, rays, c1, c2)
    sign_agree = float((np.asarray(res_a.sign) == np.asarray(res_b.sign))
                       .mean())
    hit_a, hit_b = np.asarray(h1a) > 0, np.asarray(h1b) > 0
    hit_agree = float((hit_a == hit_b).mean())
    both = hit_a & hit_b
    rel = (np.abs(np.asarray(h1a)[both] - np.asarray(h1b)[both])
           / np.maximum(np.asarray(h1a)[both], 1e-6)) if both.any() else \
        np.zeros(1)
    return {"sign_agree": round(sign_agree, 4),
            "hit_agree": round(hit_agree, 4),
            "hit_r_relmax": round(float(rel.max()), 5),
            "ok": bool(sign_agree >= 0.97 and hit_agree >= 0.95
                       and rel.max() < 1e-2)}


def gate_table_vol():
    """cheb x volumetric combo compiled for the card — the exact
    combination whose scalar-row tail offset (CHEB_OFF_VOL) was mis-spliced
    in round 3."""
    import jax
    from curvis_tpu.ops.march_pallas import \
        march_planar_disk_volumetric_pallas
    from curvis_tpu.render.disk import (DiskParams,
                                        march_planar_disk_volumetric)
    metric, rays, c1, c2, nz = _disk_setup(_table_metric())
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0)
    disk = DiskParams(r_inner=3.0, r_outer=13.0, volumetric=True,
                      h_rel=0.08, kappa=3.0, color_mode="tint",
                      t_peak=7000.0)
    _, tau_a, _ = jax.jit(lambda m, r, a, b, n: march_planar_disk_volumetric(
        m, r, a, b, n, params=disk, **kw))(metric, rays, c1, c2, nz)
    _, tau_b, _ = _kernel(
        lambda m, r, a, b, n: march_planar_disk_volumetric_pallas(
            m, r, a, b, n, disk=disk, **kw), metric, rays, c1, c2, nz)
    ta, tb = np.asarray(tau_a), np.asarray(tau_b)
    rel = np.abs(ta - tb) / np.maximum(np.abs(ta), 1e-4)
    mm = float((rel > 1e-2).mean())
    return {"tau_mismatch": round(mm, 4), "ok": bool(mm <= 0.05)}


def gate_kerr_disk():
    """Fixed-step Kerr DISK kernel (crossing (r, phi, side) triples, round
    5) vs the XLA disk twin: fates equal, hit triples allclose on stable
    rays (crossing interpolation is chaos-amplified on ring-grazers, so a
    small mismatch fraction is physics, not a miscompile)."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.render.kerr import march_kerr_disk
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(3)
    n = max(512, _SIZE["kerr"])
    th0 = np.pi / 2 - 0.5
    pos = jnp.asarray(np.stack([np.zeros(n), np.full(n, 18.0),
                                np.full(n, th0), np.zeros(n)], -1),
                      jnp.float32)
    dirs = np.stack([-np.ones(n), 0.25 * rng.standard_normal(n),
                     -0.25 - 0.4 * rng.random(n)], -1)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
                       jnp.float32)
    metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.7, jnp.float32))
    p0 = ham.spawn_photon(metric, pos, dirs)
    kw = dict(dt=0.1, max_steps=2000, escape_radius=25.0)
    xk, pk_, sk, _, (h1k, h2k) = _kernel(
        lambda m, x, p: march_kerr_pallas(m, x, p, disk=(2.0, 12.0), **kw), metric, pos, p0)
    xd, pd, sd, (h1x, h2x) = jax.jit(
        lambda m, x, p: march_kerr_disk(m, x, p, r_inner=2.0, r_outer=12.0,
                                        **kw))(metric, pos, p0)
    sign_eq = float((np.asarray(sk) == np.asarray(sd)).mean())
    hk = np.asarray(h1k[0])
    hx = np.asarray(h1x[0])
    hit_agree = float(((hk > 0) == (hx > 0)).mean())
    both = (hk > 0) & (hx > 0)
    dr = np.abs(hk[both] - hx[both])
    dphi = np.abs(np.asarray(h1k[1])[both] - np.asarray(h1x[1])[both])
    dside = np.abs(np.asarray(h1k[2])[both] - np.asarray(h1x[2])[both])
    frac_r = float((dr > 1e-2).mean()) if both.any() else 0.0
    return {"sign_eq": round(sign_eq, 4), "hit_agree": round(hit_agree, 4),
            "r_mismatch_frac": round(frac_r, 4),
            "phi_max": round(float(dphi.max() if both.any() else 0), 5),
            "side_max": round(float(dside.max() if both.any() else 0), 5),
            "n_hits": int(both.sum()),
            "ok": bool(sign_eq > 0.98 and hit_agree > 0.97
                       and frac_r < 0.05 and both.sum() > 50
                       and (not both.any() or dside.max() == 0.0))}


def gate_vol_scatter():
    """Starlight single-scattering source riding the planar vol kernel's
    scalar row (round 5): Pallas (compiled) vs the XLA twin on (tau, em),
    plus the uniform-sky closed form I_sc = (ks a L / kappa)(1 - e^-tau)
    against the kernel's own tau output (quadrature-level tolerance)."""
    import jax
    import jax.numpy as jnp
    from curvis_tpu.metrics.base import EllisMetric
    from curvis_tpu.physics import planar as pl
    from curvis_tpu.render.disk import (DiskParams,
                                        march_planar_disk_volumetric)
    from curvis_tpu.render.starlight import (StarlightMap,
                                             starlight_scatter_block)
    from curvis_tpu.ops.march_pallas import \
        march_planar_disk_volumetric_pallas
    rng = np.random.default_rng(4)
    n = max(256, _SIZE["kerr"])
    met = EllisMetric(rho=jnp.asarray(0.05, jnp.float32))
    disk = DiskParams(r_inner=3.0, r_outer=9.0, volumetric=True,
                      h_rel=0.12, kappa=2.0, tau_max=30.0, redshift=False,
                      doppler=False, albedo=(0.5, 0.3, 0.2),
                      starlight_scatter=0.7)
    l0 = jnp.full((n,), 15.0, jnp.float32)
    alpha = jnp.asarray(np.pi - (0.15 + 0.45 * rng.random(n)), jnp.float32)
    rays = pl.PlanarRays(l0, jnp.zeros((n,), jnp.float32), jnp.cos(alpha),
                         met.r(l0) * jnp.sin(alpha),
                         jnp.zeros((1, 3), jnp.float32),
                         jnp.zeros((1, 3), jnp.float32))
    ang = rng.random(n) * 2 * np.pi
    c1 = jnp.asarray(0.5 * np.cos(ang), jnp.float32)
    c2 = jnp.asarray(0.6 * np.sin(ang) + 0.1, jnp.float32)
    nz = jnp.asarray(0.4 + 0.4 * rng.random(n), jnp.float32)
    L = 0.6
    smap = StarlightMap(jnp.linspace(3.0, 9.0, 10),
                        jnp.full((2, 10, 8, 3), L, jnp.float32))
    blk = starlight_scatter_block(smap, disk, jnp.float32)
    kw = dict(dt=0.03, max_steps=2048, escape_radius=18.0)
    res_t, tau_t, em_t = jax.jit(
        lambda m, r: march_planar_disk_volumetric(
            m, r, c1, c2, nz, params=disk, scatter_block=blk, **kw))(
        met, rays)
    res_k, tau_k, em_k = _kernel(
        lambda m, r: march_planar_disk_volumetric_pallas(
            m, r, c1, c2, nz, disk=disk, scatter_block=blk, **kw), met, rays)
    tau_rel = float(np.max(np.abs(np.asarray(tau_t) - np.asarray(tau_k))
                           / np.maximum(np.asarray(tau_t), 1e-3)))
    em_rel = float(np.max(np.abs(np.asarray(em_t[2]) - np.asarray(em_k[2]))
                          / np.maximum(np.asarray(em_t[2]), 1e-3)))
    # closed form on the kernel's own outputs: subtract the emission-only
    # march (grayscale w) to isolate the scattered channel
    _, tau_o, em_o = _kernel(
        lambda m, r: march_planar_disk_volumetric_pallas(
            m, r, c1, c2, nz, disk=disk, **kw), met, rays)
    ks = disk.starlight_scatter * disk.kappa
    expect = (ks * 0.2 * L / disk.kappa                 # albedo_b = 0.2
              * (1.0 - np.exp(-np.asarray(tau_k))))
    tint_b = disk.tint[2]
    sc = np.asarray(em_k[2]) - tint_b * np.asarray(em_o[0])
    mask = expect > 1e-3
    form = float(np.median(np.abs(sc[mask] - expect[mask])
                           / expect[mask])) if mask.any() else 0.0
    return {"tau_rel": round(tau_rel, 6), "em_rel": round(em_rel, 6),
            "closed_form_med": round(form, 4), "n_gas": int(mask.sum()),
            "ok": bool(tau_rel < 1e-3 and em_rel < 1e-3 and form < 0.05
                       and mask.sum() > 30)}


GATES = {
    "euler_ellis": lambda: gate_euler("ellis"),
    "euler_dneg": lambda: gate_euler("dneg"),
    "rk45": gate_rk45,
    "rk45_disk": gate_rk45_disk,
    "rk45_vol": gate_rk45_vol,
    "fused_euler": lambda: gate_fused("euler"),
    "fused_rk45": lambda: gate_fused("rk45"),
    "disk": gate_disk,
    "volumetric": gate_volumetric,
    "kerr": lambda: gate_kerr(False),
    "kn": lambda: gate_kerr(True),
    "kerr_rk45": gate_kerr_rk45,
    "kerr_rk45_vol": gate_kerr_rk45_vol,
    "kerr_scatter": gate_kerr_scatter,
    "table": gate_table,
    "table_rk45": gate_table_rk45,
    "table_disk": gate_table_disk,
    "table_vol": gate_table_vol,
    "kerr_disk": gate_kerr_disk,
    "vol_scatter": gate_vol_scatter,
}


def run_gates(only=None, full=False):
    """Run every (or the named) gate; returns {family: result-dict}.  A
    gate that raises is reported as ok=False with the error string, so one
    broken family does not hide the verdicts of the others; callers fail
    on any ok=False.  ``full=True``: the README's frame sizes (module
    docstring)."""
    global _SIZE
    _SIZE = _FULL if full else _SMALL
    out = {}
    for name, fn in GATES.items():
        if only and name not in only:
            continue
        _STATS.clear()
        try:
            out[name] = dict(fn(), **_STATS)
        except Exception as e:                       # pragma: no cover
            out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return out


if __name__ == "__main__":
    import json
    print(json.dumps(run_gates(), indent=1))
