"""Kerr geodesics via the autodiff Hamiltonian: limits + frame dragging."""
import jax.numpy as jnp
import numpy as np
import pytest

from curvis_tpu.metrics.kerr import KerrMetric, make_kerr
from curvis_tpu.metrics.base import SchwarzschildMetric
from curvis_tpu.physics import hamiltonian as ham
from curvis_tpu.physics import planar as pl


def test_metric_inverse_consistency():
    """Closed-form inverse really inverts g, on and off the equator."""
    metric = make_kerr(m=1.0, a=0.8)
    for r, th in ((5.0, np.pi / 2), (3.0, 1.0), (10.0, 2.5)):
        x = jnp.asarray([0.0, r, th, 0.3])
        g = np.asarray(metric.metric(x))
        ginv = np.asarray(metric.inverse_metric(x))
        np.testing.assert_allclose(g @ ginv, np.eye(4), atol=1e-10)


def test_tetrad_orthonormal():
    metric = make_kerr(m=1.0, a=0.9)
    x = jnp.asarray([0.0, 6.0, 1.1, 0.4])
    tet = np.asarray(ham.static_tetrad(metric, x))
    g = np.asarray(metric.metric(x))
    eta = tet @ g @ tet.T
    np.testing.assert_allclose(eta, np.diag([-1.0, 1.0, 1.0, 1.0]),
                               atol=1e-10)


def test_spawn_photon_null():
    metric = make_kerr(m=1.0, a=0.7)
    x = jnp.asarray([[0.0, 8.0, 1.3, 0.2]])
    d = jnp.asarray([[0.5, -0.3, 0.81]])
    p = ham.spawn_photon(metric, x, d)
    H = float(ham.hamiltonian(metric, x[0], p[0]))
    assert abs(H) < 1e-12


def _equatorial_fate(metric, b, l0=200.0, dt=0.05, max_steps=200_000):
    """Launch an equatorial photon inward with impact parameter b (sign =
    orbital sense relative to the spin); returns final sign (1 escaped,
    2 captured)."""
    x = jnp.asarray([[0.0, l0, np.pi / 2, 0.0]])
    # local direction: mostly inward radial, transverse component sets b.
    # With E measured in the static frame, b = L/E; solve the transverse
    # fraction numerically from the spawned momentum.
    def spawn(frac):
        d = jnp.asarray([[-(1.0 - frac * frac) ** 0.5, 0.0, frac]])
        p = ham.spawn_photon(metric, x, d)
        E = -p[0, 0]
        L = p[0, 3]
        return p, float(L / E)

    # bisect frac to hit the requested b (monotone)
    lo, hi = -0.999, 0.999
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        _, bm = spawn(mid)
        if bm < b:
            lo = mid
        else:
            hi = mid
    p, b_got = spawn(0.5 * (lo + hi))
    assert abs(b_got - b) < 1e-6 * max(1.0, abs(b))
    res = ham.march_hamiltonian(
        metric, x, p, dt=dt, max_steps=max_steps, escape_radius=1.05 * l0,
        capture_radius=float(metric.capture_radius))
    return int(res.sign[0])


def test_a0_reduces_to_schwarzschild_critical_b():
    """Kerr with a -> 0 reproduces the Schwarzschild shadow threshold."""
    metric = make_kerr(m=1.0, a=1e-6)
    b_c = 3.0 * np.sqrt(3.0)
    assert _equatorial_fate(metric, b_c * 0.97) == 2
    assert _equatorial_fate(metric, b_c * 1.03) == 1
    # closed-form critical b matches too
    np.testing.assert_allclose(float(metric.critical_impact_parameter(True)),
                               b_c, rtol=1e-5)


def test_frame_dragging_asymmetric_capture():
    """The signature Kerr effect: prograde photons survive closer approaches
    than retrograde ones (b_pro < b_retro), at the Bardeen thresholds."""
    metric = make_kerr(m=1.0, a=0.9)
    b_pro = float(metric.critical_impact_parameter(prograde=True))
    b_ret = -float(metric.critical_impact_parameter(prograde=False))
    # sanity on the closed form itself
    assert 0 < b_pro < 3 * np.sqrt(3) < -b_ret
    # prograde side (b > 0 with our spawn convention = same sense as spin)
    assert _equatorial_fate(metric, b_pro * 0.96) == 2
    assert _equatorial_fate(metric, b_pro * 1.04) == 1
    # retrograde side
    assert _equatorial_fate(metric, b_ret * 0.96) == 2
    assert _equatorial_fate(metric, b_ret * 1.04) == 1


def test_kerr_equator_vs_planar_schwarzschild():
    """a=0 Kerr trajectories match the planar Schwarzschild marcher."""
    kerr = make_kerr(m=1.0, a=1e-8)
    sch = SchwarzschildMetric(m=jnp.asarray(1.0))
    b = 8.0
    l0 = 100.0
    # planar Schwarzschild
    A0 = float(sch.lapse(jnp.asarray(l0)))
    sin_a = b * np.sqrt(A0) / l0
    alpha = np.pi - np.arcsin(sin_a)
    rays = pl.PlanarRays(l=jnp.asarray([l0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([np.cos(alpha) / A0]),
                         b=jnp.asarray([np.sin(alpha) * l0 / np.sqrt(A0)]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))
    res_p = pl.march_planar_while(sch, rays, dt=0.02, max_steps=400_000,
                                  escape_radius=110.0)
    beta_p = float(pl.escape_angle_beta(sch, res_p, rays.b)[0])
    # Kerr Hamiltonian march with the same spawn
    x = jnp.asarray([[0.0, l0, np.pi / 2, 0.0]])
    d = jnp.asarray([[np.cos(alpha), 0.0, np.sin(alpha)]])
    p = ham.spawn_photon(kerr, x, d)
    res_h = ham.march_hamiltonian(kerr, x, p, dt=0.02, max_steps=400_000,
                                  escape_radius=110.0,
                                  capture_radius=2.1)
    assert int(res_h.sign[0]) == 1 and int(res_p.sign[0]) == 1
    # compare in-plane escape direction angles
    xf = res_h.x[0]
    pf = res_h.p[0]
    ginv = kerr.inverse_metric(xf)
    pup = np.asarray(ginv @ pf)
    r = float(xf[1])
    u_r = pup[1]
    u_ph = pup[3] * r
    beta_h = float(xf[3]) + np.arctan2(u_ph, u_r)
    assert abs((beta_h - beta_p + np.pi) % (2 * np.pi) - np.pi) < 5e-3


def test_kerr_shadow_asymmetry_image(rng):
    """High-spin shadow is displaced toward the retrograde side (the
    D-shaped-shadow signature), unlike the centered a~0 shadow."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr

    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    cam = cv.make_camera([0.0, 30.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 18.0, 43.0, 48, 27,
                         dtype=jnp.float64)

    def shadow_centroid(a):
        metric = make_kerr(m=1.0, a=a)
        img = np.asarray(render_kerr(metric, cam, bg, dt=0.1,
                                     max_steps=20_000))
        black = img.sum(-1) == 0
        assert 0.005 < black.mean() < 0.5
        xs = np.where(black)[1]
        return xs.mean() - (img.shape[1] - 1) / 2

    c_slow = shadow_centroid(1e-4)
    c_fast = shadow_centroid(0.95)
    assert abs(c_slow) < 1.0                   # centered (up to grid offset)
    assert abs(c_fast - c_slow) > 1.2          # visibly displaced by spin


def test_kerr_pallas_kernel_matches_autodiff():
    """The hand-inlined Pallas Kerr RHS is the same Hamiltonian flow as the
    autodiff marcher: identical signs/steps, state to ~1e-12 (f64 interpret),
    including the disk-crossing variant."""
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    metric = make_kerr(m=1.0, a=0.9)
    rng = np.random.default_rng(0)
    n = 16
    ths = np.concatenate([np.full(8, np.pi / 2),
                          np.pi / 2 + 0.4 * rng.standard_normal(8)])
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 30.0), ths,
                               np.zeros(n)], -1))
    dirs = rng.standard_normal((n, 3))
    dirs[:, 0] = -np.abs(dirs[:, 0]) - 0.5
    d = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    p0 = ham.spawn_photon(metric, x0, d)
    kw = dict(dt=0.1, max_steps=20_000, escape_radius=60.0)
    res = ham.march_hamiltonian(metric, x0, p0,
                                capture_radius=float(metric.capture_radius),
                                **kw)
    x_k, p_k, sign_k, steps_k = march_kerr_pallas(metric, x0, p0,
                                                  **kw)
    np.testing.assert_array_equal(np.asarray(res.sign), np.asarray(sign_k))
    np.testing.assert_array_equal(np.asarray(res.steps), np.asarray(steps_k))
    esc = np.asarray(res.sign) == 1
    np.testing.assert_allclose(np.asarray(res.x[:, 1:])[esc],
                               np.asarray(x_k[:, 1:])[esc], atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.p)[esc],
                               np.asarray(p_k)[esc], atol=1e-12)
    # disk variant agrees with the XLA disk marcher's crossing
    # (radius, azimuth, side) triples
    from curvis_tpu.render.kerr import march_kerr_disk
    xd, pd, sd, (h1x, h2x) = march_kerr_disk(metric, x0, p0, r_inner=3.0,
                                             r_outer=20.0, **kw)
    _, _, sk, _, (h1k, h2k) = march_kerr_pallas(metric, x0, p0,
                                                disk=(3.0, 20.0),
                                                **kw)
    np.testing.assert_array_equal(np.asarray(sd), np.asarray(sk))
    for comp in range(3):                     # r, phi, side per hit
        np.testing.assert_allclose(np.asarray(h1x[comp]),
                                   np.asarray(h1k[comp]), atol=1e-10)
        np.testing.assert_allclose(np.asarray(h2x[comp]),
                                   np.asarray(h2k[comp]), atol=1e-10)
    # recorded sides are sane where hits exist (this config may record none)
    hit = np.asarray(h1x[0]) > 0
    assert np.isin(np.asarray(h1x[2])[hit], (1.0, -1.0)).all()


def test_kerr_pallas_odd_step_cap_exact():
    """Odd max_steps: the per-ray steps gate makes the cap exact — capped
    rays stop at exactly max_steps with sign 0, matching the XLA marcher
    ray for ray (ADVICE round-2)."""
    from curvis_tpu.ops import march_pallas as mp
    metric = make_kerr(m=1.0, a=0.9)
    rng = np.random.default_rng(1)
    n = 64
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 20.0),
                               np.full(n, np.pi / 2 - 0.2),
                               np.zeros(n)], -1))
    dirs = rng.standard_normal((n, 3))
    d = jnp.asarray(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    p0 = ham.spawn_photon(metric, x0, d)
    kw = dict(dt=0.2, max_steps=333, escape_radius=40.0)    # odd cap
    res = ham.march_hamiltonian(metric, x0, p0,
                                capture_radius=float(metric.capture_radius),
                                **kw)
    _, _, sign_k, steps_k = mp.march_kerr_pallas(metric, x0, p0, **kw)
    sign_k, steps_k = np.asarray(sign_k), np.asarray(steps_k)
    np.testing.assert_array_equal(np.asarray(res.sign), sign_k)
    np.testing.assert_array_equal(np.asarray(res.steps), steps_k)
    capped = sign_k == 0
    assert capped.any(), "config must leave some rays at the step cap"
    assert (steps_k[capped] == 333).all()


def test_kerr_pallas_bardeen_thresholds():
    """Physics oracle straight through the kernel: capture/escape flips at
    the Bardeen critical impact parameters (prograde AND retrograde)."""
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    metric = make_kerr(m=1.0, a=0.9)

    def fate(b):
        l0 = 200.0
        x = jnp.asarray([[0.0, l0, np.pi / 2, 0.0]])
        lo, hi = -0.999, 0.999
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            dd = jnp.asarray([[-(1.0 - mid * mid) ** 0.5, 0.0, mid]])
            p = ham.spawn_photon(metric, x, dd)
            if float(p[0, 3] / -p[0, 0]) < b:
                lo = mid
            else:
                hi = mid
        mid = 0.5 * (lo + hi)
        dd = jnp.asarray([[-(1.0 - mid * mid) ** 0.5, 0.0, mid]])
        p = ham.spawn_photon(metric, x, dd)
        _, _, sign, _ = march_kerr_pallas(metric, x, p, dt=0.05,
                                          max_steps=200_000,
                                          escape_radius=1.05 * l0)
        return int(sign[0])

    b_pro = float(metric.critical_impact_parameter(prograde=True))
    b_ret = -float(metric.critical_impact_parameter(prograde=False))
    assert fate(b_pro * 0.96) == 2
    assert fate(b_pro * 1.04) == 1
    assert fate(b_ret * 0.96) == 2
    assert fate(b_ret * 1.04) == 1


def test_polar_axis_camera_robustness(rng):
    """Regression for the round-1 'polar-axis seam' (NEXT.md): a camera near
    the BL axis of a fast-spinning hole renders finite, with the adaptive
    axis step control keeping numerical-blowup rays (sign 3) essentially
    absent, in both marcher backends."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr
    from curvis_tpu.render.fast import _pixel_dirs_soa
    from curvis_tpu.geometry.rotations import frame_matrix

    metric = make_kerr(m=1.0, a=0.9)
    th0 = 0.12                       # 7 degrees off the spin axis
    cam = cv.make_camera([0.0, 25.0, th0, 0.0],
                         [-np.sin(th0), 0.0, -np.cos(th0)], [1.0, 0.0, 0.0],
                         20.0, 43.0, 48, 32, dtype=jnp.float64)
    img = np.asarray(render_kerr(metric, cam, cv.make_spherical_image(
        0.5 + 0.0 * rng.random((8, 16, 3)), dtype=jnp.float64),
        dt=0.1, max_steps=20_000, backend="xla"))
    assert np.isfinite(img).all()
    # the shadow is visible and the rest of the frame is lit
    black = img.sum(-1) == 0
    assert 0.003 < black.mean() < 0.5

    # ray-level check on both backends: rays aimed past the axis
    pos = cam.position
    dx_, dy_, dz_ = _pixel_dirs_soa(cam, False)
    comps = jnp.stack([dx_, dy_, dz_], -1) @ frame_matrix(pos[2], pos[3])
    n = comps.shape[0]
    x0 = jnp.broadcast_to(pos, (n, 4))
    p0 = ham.spawn_photon(metric, x0, comps)
    res = ham.march_hamiltonian(metric, x0, p0, dt=0.1, max_steps=20_000,
                                escape_radius=50.0,
                                capture_radius=float(metric.capture_radius))
    sign = np.asarray(res.sign)
    assert (sign == 3).mean() < 0.002          # blowups essentially gone
    assert (sign == 0).mean() < 0.002          # and no stuck rays
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    _, _, sk, _ = march_kerr_pallas(metric, x0, p0, dt=0.1,
                                    max_steps=20_000, escape_radius=50.0)
    sk = np.asarray(sk)
    assert (sk == 3).mean() < 0.002
    assert (sign == sk).mean() > 0.99          # backends agree per ray


def test_kerr_weak_field_deflection():
    """Weak-field oracle through the Pallas kernel: equatorial deflection
    |4M/b| with the frame-dragging correction -+ 4Ma/b^2 (prograde rays bend
    LESS).  Independent closed-form check, not a backend comparison."""
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    M, a = 1.0, 0.9
    metric = make_kerr(m=M, a=a)
    l0 = 4000.0
    x = jnp.asarray([[0.0, l0, np.pi / 2, 0.0]])
    defl = {}
    for b in (60.0, -60.0):                      # prograde / retrograde
        frac = b / l0                            # weak field: sin ~ b/r
        d = jnp.asarray([[-(1.0 - frac * frac) ** 0.5, 0.0, frac]])
        p = ham.spawn_photon(metric, x, d)
        xf, pf, sg, _ = march_kerr_pallas(metric, x, p, dt=0.5,
                                          max_steps=200_000,
                                          escape_radius=1.5 * l0)
        assert int(sg[0]) == 1
        ginv = metric.inverse_metric(xf[0])
        pup = np.asarray(ginv @ pf[0])
        r = float(xf[0, 1])
        beta = float(xf[0, 3]) + np.arctan2(pup[3] * r, pup[1])
        # undeflected straight-line direction angle: pi - arcsin(b/l0);
        # signed deflection (positive = bent toward +phi for b > 0)
        straight = np.pi - np.arcsin(frac)
        dfl = (beta - straight + np.pi) % (2.0 * np.pi) - np.pi
        expected = np.sign(b) * 4.0 * M / abs(b) - 4.0 * M * a / (b * b)
        np.testing.assert_allclose(dfl, expected, rtol=0.08)
        defl[b] = abs(dfl)
    # frame dragging: prograde (b > 0, same sense as the spin) bends less
    assert defl[60.0] < defl[-60.0]


def test_kerr_frames_batched_matches_single(rng):
    """render_kerr_frames_batched == per-frame render_kerr (one flat march
    bundle per batch; CPU f64, xla backend, shadow + disk modes)."""
    import curvis_tpu as cv
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr, render_kerr_frames_batched

    metric = make_kerr(m=1.0, a=0.9)
    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    th = np.pi / 2 - 0.2
    cams = [cv.make_camera([0.0, r0, th, ph],
                           [-np.sin(th) * np.cos(ph), -np.sin(th) * np.sin(ph),
                            -np.cos(th)],
                           [0.0, 0.0, 1.0], 24.0, 43.0, 24, 14,
                           dtype=jnp.float64)
            for r0, ph in [(28.0, 0.0), (30.0, 0.5)]]
    for disk in (None, DiskParams(r_inner=2.6, r_outer=12.0, doppler=True)):
        batch = np.asarray(render_kerr_frames_batched(
            metric, cams, bg, dt=0.25, max_steps=2000, escape_radius=64.0,
            disk=disk, backend="xla"))
        assert batch.shape == (2, 14, 24, 3)
        for f, cam in enumerate(cams):
            single = np.asarray(render_kerr(metric, cam, bg, dt=0.25,
                                            max_steps=2000,
                                            escape_radius=64.0, disk=disk,
                                            backend="xla"))
            np.testing.assert_allclose(batch[f], single, rtol=0, atol=1e-12)


def test_kerr_volumetric_pallas_matches_xla():
    """Pallas Kerr volumetric kernel (interpret) vs the XLA RK4 marcher:
    identical per-step semantics -> signs equal, tau/em tight in f32; a
    blown-up ray (sign 3) must leave finite accumulators (the emission
    increments are select-gated on the finiteness predicate)."""
    import curvis_tpu as cv
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import _spawn_kerr_rays, march_kerr_volumetric
    m = make_kerr(1.0, 0.85)
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 24.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 24, 12, dtype=jnp.float32)
    x0, p0 = _spawn_kerr_rays(m, cam)
    kw = dict(dt=0.1, max_steps=4000, escape_radius=50.0)
    for mode in ("tint", "blackbody"):
        disk = DiskParams(r_inner=3.2, r_outer=12.0, volumetric=True,
                          h_rel=0.1, kappa=3.0, color_mode=mode,
                          t_peak=7000.0)
        xa, pa, sa, tau_a, em_a = march_kerr_volumetric(m, x0, p0,
                                                        params=disk, **kw)
        xb, pb, sb, _, (tau_b, em_b) = march_kerr_pallas(
            m, x0, p0, vol_disk=disk, **kw)
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        np.testing.assert_allclose(np.asarray(tau_a), np.asarray(tau_b),
                                   rtol=2e-3, atol=1e-5)
        for ea, eb in zip(em_a, em_b):
            assert np.isfinite(np.asarray(ea)).all()
            np.testing.assert_allclose(np.asarray(ea), np.asarray(eb),
                                       rtol=5e-3, atol=1e-5)


def test_kerr_volumetric_a0_matches_planar_schwarzschild():
    """Physics oracle: at a -> 0 the Kerr volumetric render (5-state BL RK4,
    conserved (E, L), circular-orbit g in the (1 - Omega L/E) form) must
    reproduce the planar Schwarzschild volumetric render (orbital-plane
    reduction, Euler, local static-frame Doppler g) — two independent
    formulations of the same integral, agreeing up to discretization."""
    import curvis_tpu as cv
    from curvis_tpu.render.disk import (DiskParams, render_blackhole_disk)
    from curvis_tpu.render.kerr import render_kerr
    th = np.pi / 2 - 0.25
    cam = cv.make_camera([0.0, 24.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 48, 27, dtype=jnp.float32)
    bg = cv.make_spherical_image(np.full((8, 16, 3), 0.05, np.float32),
                                 dtype=jnp.float32)
    disk = DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                      h_rel=0.08, kappa=3.0, color_mode="blackbody",
                      t_peak=7000.0)
    img_k = np.asarray(render_kerr(
        make_kerr(1.0, 1e-6), cam, bg, dt=0.02, max_steps=15000,
        escape_radius=50.0, disk=disk, backend="xla"))
    img_s = np.asarray(render_blackhole_disk(
        SchwarzschildMetric(m=jnp.asarray(1.0, jnp.float32)), cam, bg,
        dt=0.02, max_steps=15000, escape_radius=50.0, disk=disk,
        backend="while"))
    assert np.isfinite(img_k).all() and np.isfinite(img_s).all()
    # total disk luminance within a few percent
    lk, ls = img_k.mean(), img_s.mean()
    assert abs(lk - ls) / ls < 0.05, (lk, ls)
    # pointwise: only shadow-edge / photon-ring pixels may disagree
    frac = (np.abs(img_k - img_s).max(axis=-1) > 0.08).mean()
    assert frac < 0.03, frac


def test_kerr_adaptive_antialiasing(rng):
    """Edge-adaptive supersampler: refines at most refine_frac of the
    pixels, leaves the rest bitwise-identical to the base render, targets
    the contrast edges (shadow rim), and lowers total variation there."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr, render_kerr_adaptive
    m = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                   a=jnp.asarray(0.9, jnp.float32))
    th = np.pi / 2 - 0.2
    cam = cv.make_camera([0.0, 20.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 48, 28, dtype=jnp.float32)
    bg = cv.make_spherical_image(rng.random((16, 32, 3)).astype("float32"),
                                 dtype=jnp.float32)
    kw = dict(dt=0.1, max_steps=4000, escape_radius=45.0, backend="xla")
    base = np.asarray(render_kerr(m, cam, bg, **kw))
    ad = np.asarray(render_kerr_adaptive(m, cam, bg, refine_frac=0.15,
                                         supersample=3, **kw))
    assert ad.shape == base.shape
    assert np.isfinite(ad).all()
    changed = np.abs(ad - base).max(-1) > 0.0
    assert changed.mean() <= 0.15 + 1e-9
    # un-refined pixels are EXACTLY the base render (scatter touches only
    # the top-k rows)
    assert np.array_equal(ad[~changed], base[~changed])
    # the shadow rim is the contrast maximum: refined set must include it
    black = base.sum(-1) == 0
    rim = black ^ np.roll(black, 1, axis=1)
    rim[:, 0] = False
    assert (changed & rim).sum() >= 0.5 * rim.sum()
    # and antialiasing reduces total variation
    tv = lambda im: (np.abs(np.diff(im, axis=0)).sum()
                     + np.abs(np.diff(im, axis=1)).sum())
    assert tv(ad) < tv(base)


def test_kerr_adaptive_with_disk_and_velocity(rng):
    """Adaptive path composes with the volumetric disk and a moving
    camera (smoke + finiteness)."""
    import curvis_tpu as cv
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr_adaptive
    m = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                   a=jnp.asarray(0.8, jnp.float32))
    th = np.pi / 2 - 0.25
    cam = cv.make_camera([0.0, 20.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 24, 14, dtype=jnp.float32)
    bg = cv.make_spherical_image(np.full((8, 16, 3), 0.05, np.float32),
                                 dtype=jnp.float32)
    disk = DiskParams(r_inner=3.0, r_outer=10.0, volumetric=True, h_rel=0.1,
                      kappa=3.0, color_mode="blackbody", t_peak=7000.0)
    img = np.asarray(render_kerr_adaptive(
        m, cam, bg, dt=0.1, max_steps=3000, escape_radius=45.0,
        backend="xla", disk=disk, refine_frac=0.2, supersample=2,
        camera_velocity=[0.0, 0.3, 0.0]))
    assert img.shape == (14, 24, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_kerr_far_accel_parity_and_accuracy():
    """Far-field step acceleration (ham.far_dt_scale): the Pallas kernel and
    the XLA marcher implement the identical rule (tight f64 agreement with
    far_r0 set), and against the dense march the accelerated escape
    directions differ by < 5e-3 rad (sub-texel) while cutting mean steps
    >= 2x."""
    import curvis_tpu as cv
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.render.kerr import _spawn_kerr_rays
    m = make_kerr(1.0, 0.9)
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 30.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         24.0, 43.0, 24, 12, dtype=jnp.float64)
    x0, p0 = _spawn_kerr_rays(m, cam)
    kw = dict(dt=0.1, max_steps=32_000, escape_radius=60.0)
    cap = float(m.capture_radius)
    dense = ham.march_hamiltonian(m, x0, p0, capture_radius=cap, **kw)
    fast = ham.march_hamiltonian(m, x0, p0, capture_radius=cap,
                                 far_r0=8.0, **kw)
    xk, pk, sk, stk = march_kerr_pallas(m, x0, p0, far_r0=8.0,
                                        **kw)
    # identical rule in kernel and XLA marcher
    np.testing.assert_array_equal(np.asarray(fast.sign), np.asarray(sk))
    ok = np.asarray(fast.sign) > 0
    np.testing.assert_allclose(np.asarray(fast.x)[ok, 1:],
                               np.asarray(xk)[ok, 1:], rtol=1e-9, atol=1e-9)
    # >= 2x fewer steps
    assert float(fast.steps.mean()) < 0.5 * float(dense.steps.mean())
    # sub-texel escape-direction error vs the dense march

    def dirs(x, p):
        ginv = m.inverse_metric(x)
        pup = jnp.einsum("nij,nj->ni", ginv, p)
        r = x[:, 1]
        st = jnp.maximum(jnp.sin(x[:, 2]), 1e-6)
        u = jnp.stack([pup[:, 1], pup[:, 2] * r, pup[:, 3] * r * st], -1)
        return u / jnp.linalg.norm(u, axis=-1, keepdims=True)

    esc = (np.asarray(dense.sign) == 1) & (np.asarray(fast.sign) == 1)
    da = np.asarray(dirs(dense.x, dense.p))[esc]
    db = np.asarray(dirs(fast.x, fast.p))[esc]
    ang = np.arccos(np.clip((da * db).sum(-1), -1.0, 1.0))
    assert np.percentile(ang, 99) < 5e-3, np.percentile(ang, 99)


def test_kerr_render_far_accel_default_close_to_dense(rng):
    """render_kerr defaults to far_accel=True; the image matches the dense
    (far_accel=False) render away from the chaotic shadow edge."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr
    m = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                   a=jnp.asarray(0.9, jnp.float32))
    th = np.pi / 2 - 0.2
    cam = cv.make_camera([0.0, 24.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 48, 28, dtype=jnp.float32)
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)],
                      -1).astype(np.float32)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float32)
    kw = dict(dt=0.1, max_steps=16_000, escape_radius=50.0, backend="xla")
    fast = np.asarray(render_kerr(m, cam, bg, **kw))
    dense = np.asarray(render_kerr(m, cam, bg, far_accel=False, **kw))
    assert np.isfinite(fast).all()
    frac = (np.abs(fast - dense).max(-1) > 0.05).mean()
    assert frac < 0.05, frac


def test_near_extremal_spin_renders_finite(rng):
    """a = 0.998 (the Thorne limit): horizon 1.063M, prograde photon orbit
    grazes r ~ 1.1M — the stiffest configuration the renderer meets.
    Pallas (interpret) and XLA must agree on fates and produce finite
    images with the expected D-shaped (displaced) shadow."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr
    m = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                   a=jnp.asarray(0.998, jnp.float32))
    th = np.pi / 2 - 0.2
    cam = cv.make_camera([0.0, 20.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 48, 28, dtype=jnp.float32)
    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float32)
    img = np.asarray(render_kerr(m, cam, bg, dt=0.05, max_steps=30_000,
                                 escape_radius=45.0, backend="xla"))
    assert np.isfinite(img).all()
    black = img.sum(-1) == 0
    assert 0.01 < black.mean() < 0.5            # a real shadow, not a wash
    # frame dragging displaces the shadow off-center toward the
    # retrograde side: compare black-pixel counts left/right of center
    left = black[:, :24].sum()
    right = black[:, 24:].sum()
    assert left != right
    # Bardeen prograde critical b at a ~ M approaches 2M (vs 3sqrt(3)M):
    np.testing.assert_allclose(
        float(m.critical_impact_parameter(True)), 2.0, atol=0.15)


@pytest.mark.parametrize("charged", [False, True])
def test_kerr_rk45_kernel_matches_xla_twin(charged):
    """Error-controlled BL march: the Pallas DP5(4) kernel and its XLA twin
    (integrate/rk45.py:march_kerr_rk45) implement the identical tableau,
    norm and controller — per-ray ACCEPTED-STEP COUNTS must be equal and
    the states agree to f64 accumulation round-off.  Charged case: the
    Kerr-Newman q^2 rides the same scalar-row slot as the fixed-step kernel."""
    from curvis_tpu.integrate.rk45 import march_kerr_rk45
    from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
    if charged:
        from curvis_tpu.metrics.kerr import make_kerr_newman
        m = make_kerr_newman(1.0, 0.7, 0.5)
    else:
        m = make_kerr(1.0, 0.9)
    rng = np.random.default_rng(0)
    n = 128
    ths = np.pi / 2 + 0.4 * rng.standard_normal(n)
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 30.0), ths,
                               np.zeros(n)], -1))
    dirs = rng.standard_normal((n, 3))
    dirs[:, 0] = -np.abs(dirs[:, 0]) - 0.5
    p0 = ham.spawn_photon(m, x0, jnp.asarray(
        dirs / np.linalg.norm(dirs, axis=1, keepdims=True)))
    kw = dict(escape_radius=60.0, rtol=1e-5, atol=1e-8, max_steps=20_000)
    res = march_kerr_rk45(m, x0, p0, **kw)
    xk, pk, sk, stk = march_kerr_rk45_pallas(m, x0, p0,
                                             **kw)
    np.testing.assert_array_equal(np.asarray(res.sign), np.asarray(sk))
    np.testing.assert_array_equal(np.asarray(res.steps), np.asarray(stk))
    esc = np.asarray(res.sign) == 1
    np.testing.assert_allclose(np.asarray(res.x)[esc, 1:],
                               np.asarray(xk)[esc, 1:], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.p)[esc, 1:3],
                               np.asarray(pk)[esc, 1:3], rtol=1e-6,
                               atol=1e-6)
    assert esc.sum() > 0.5 * n and (np.asarray(res.sign) == 2).sum() > 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_kerr_rk45_boundary_parked_ray_escapes(backend):
    """Regression: a ray whose f32 state rounds to EXACTLY r == R enters a
    permanent over-reject loop under a frac-only boundary-stepping rule —
    (R - r) == 0 makes frac == 0 (< 0.9) for every escaping trial, including
    the dt_min retry that lands at R + ~1e-5, so the ray never freezes and
    spins its block to max_iters (about one such ray per ~150k at
    512x288).  The absolute-overshoot tolerance (r1 <= R*(1 +
    1e-3) is never a 'gross' overshoot) must let it escape within a few
    iterations in BOTH twins."""
    from curvis_tpu.integrate.rk45 import march_kerr_rk45
    from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
    m = make_kerr(1.0, 0.9)
    R = 45.0
    n = 8
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, R),
                               np.full(n, np.pi / 2 - 0.2), np.zeros(n)],
                              -1))
    dirs = np.tile(np.asarray([1.0, 0.3, 0.1]) / np.linalg.norm(
        [1.0, 0.3, 0.1]), (n, 1))
    p0 = ham.spawn_photon(m, x0, jnp.asarray(dirs))
    # max_iters small: the old rule returned sign == 0 after spinning it out
    kw = dict(escape_radius=R, max_steps=100, max_iters=40, rtol=1e-4)
    res = march_kerr_rk45(m, x0, p0, **kw)
    assert (np.asarray(res.sign) == 1).all(), np.asarray(res.sign)
    # the escape state is read essentially AT the boundary
    assert (np.asarray(res.x)[:, 1] <= R * (1 + 1e-3) + 1e-6).all()
    if backend == "pallas":
        _, _, sk, _ = march_kerr_rk45_pallas(m, x0, p0,
                                             **kw)
        assert (np.asarray(sk) == 1).all(), np.asarray(sk)


def test_kerr_rk45_dt_halving_convergence():
    """Order anchor for the error-controlled stepping (VERDICT round-2
    next-step #5): fixed RK4 escape-direction error shrinks ~16x per dt
    halving (4th order) against an 8x-finer reference, and the adaptive
    DP5(4) at rtol=1e-6 lands at-or-below the finest fixed error with
    several-fold fewer accepted steps.  Smooth equatorial bundle (impact
    parameters well above critical) so truncation — not chaos — dominates."""
    from curvis_tpu.integrate.rk45 import march_kerr_rk45
    m = make_kerr(1.0, 0.9)
    n = 24
    bs = np.linspace(3.2, 6.5, n)                 # b_c: 2.56 (pro), 5.89 —
    # close enough to critical that truncation dominates the f64 floor
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 30.0),
                               np.full(n, np.pi / 2), np.zeros(n)], -1))
    # equatorial aim: direction in the (r_hat, phi_hat) plane with
    # sin(angle) = b / r  ->  impact parameter b exactly as r -> inf
    sa = bs / 30.0
    dirs = np.stack([-np.sqrt(1.0 - sa * sa), np.zeros(n), sa], -1)
    p0 = ham.spawn_photon(m, x0, jnp.asarray(dirs))
    cap = float(m.capture_radius)
    R = 60.0

    def direction(x, p):
        # WORLD-frame (Cartesian) propagation direction — constant along
        # the straight exit path, so integrators that overshoot R by
        # different amounts are still compared apples-to-apples (the local
        # [r_hat, th_hat, ph_hat] components alone rotate with position)
        from curvis_tpu.geometry.rotations import frame_matrix
        ginv = m.inverse_metric(x)
        pup = jnp.einsum("nij,nj->ni", ginv, p)
        r = x[:, 1]
        st = jnp.maximum(jnp.sin(x[:, 2]), 1e-6)
        u = jnp.stack([pup[:, 1], pup[:, 2] * r, pup[:, 3] * r * st], -1)
        u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
        Fe = frame_matrix(x[:, 2], x[:, 3])
        return np.asarray(jnp.einsum("nij,nj->ni", Fe, u))

    def err_of(res, wref):
        w = direction(res.x, res.p)
        return np.arccos(np.clip((w * wref).sum(-1), -1.0, 1.0))

    ref = ham.march_hamiltonian(m, x0, p0, dt=0.025, max_steps=40_000,
                                escape_radius=R, capture_radius=cap)
    assert (np.asarray(ref.sign) == 1).all()
    wref = direction(ref.x, ref.p)
    errs, steps = [], []
    for dt in (0.8, 0.4):
        res = ham.march_hamiltonian(m, x0, p0, dt=dt, max_steps=10_000,
                                    escape_radius=R, capture_radius=cap)
        errs.append(np.median(err_of(res, wref)))
        steps.append(float(np.asarray(res.steps).mean()))
    ratio = errs[0] / errs[1]
    assert 6.0 < ratio < 50.0, (errs, ratio)      # ~16x per halving (RK4)

    ad = march_kerr_rk45(m, x0, p0, rtol=1e-6, atol=1e-9, dt0=0.4,
                         max_steps=20_000, escape_radius=R)
    assert (np.asarray(ad.sign) == 1).all()
    assert np.median(err_of(ad, wref)) <= 2.0 * errs[1], (
        np.median(err_of(ad, wref)), errs)
    assert float(np.asarray(ad.steps).mean()) < steps[1] / 3.0


def test_kerr_rk45_render_matches_rk4(rng):
    """render_kerr(stepper='rk45'): same image as the fixed-RK4 default
    away from the chaotic shadow edge, bare and thin-disk variants (the
    disk variant runs the kernel's crossing tracker in interpret mode)."""
    import curvis_tpu as cv
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr
    m = KerrMetric(m=jnp.asarray(1.0, jnp.float64),
                   a=jnp.asarray(0.9, jnp.float64))
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 20.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 48, 28, dtype=jnp.float64)
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    kw = dict(escape_radius=45.0, backend="xla")
    a4 = np.asarray(render_kerr(m, cam, bg, dt=0.1, max_steps=20_000, **kw))
    a45 = np.asarray(render_kerr(m, cam, bg, dt=0.1, max_steps=4_000,
                                 stepper="rk45", **kw))
    assert np.isfinite(a45).all()
    assert (np.abs(a4 - a45).max(-1) > 0.1).mean() < 0.02
    disk = DiskParams(r_inner=2.5, r_outer=9.0)
    d4 = np.asarray(render_kerr(m, cam, bg, dt=0.1, max_steps=20_000,
                                disk=disk, **kw))
    d45 = np.asarray(render_kerr(m, cam, bg, dt=0.05, max_steps=8_000,
                                 disk=disk, stepper="rk45", rtol=1e-5, **kw))
    assert np.isfinite(d45).all()
    assert (np.abs(d4 - d45).max(-1) > 0.1).mean() < 0.03


def test_kerr_rk45_volumetric_matches_rk4(rng):
    """stepper='rk45' through the VOLUMETRIC gas disk (round-3: the last
    missing cell of the stepper x surface matrix): in-kernel radiative
    transfer on accepted steps, dt clamped to dt0 inside r_out + 2M so the
    quadrature keeps the fixed kernel's resolution.  Against the fixed-RK4
    volumetric render at tight rtol: same shadow/opacity structure, total
    flux within a few percent, few mismatched pixels (trajectory chaos at
    the shadow rim only)."""
    import curvis_tpu as cv
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr
    m = make_kerr(1.0, 0.85)
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 24.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 40, 22, dtype=jnp.float64)
    hgt, wid = 16, 32
    yy, xx = np.mgrid[0:hgt, 0:wid]
    smooth = np.stack([np.sin(2 * np.pi * xx / wid) * 0.5 + 0.5, yy / hgt,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / hgt)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    kw = dict(escape_radius=50.0, backend="xla")
    for mode in ("tint", "blackbody"):
        disk = DiskParams(r_inner=3.2, r_outer=12.0, volumetric=True,
                          h_rel=0.1, kappa=3.0, color_mode=mode,
                          t_peak=7000.0)
        v4 = np.asarray(render_kerr(m, cam, bg, dt=0.1, max_steps=20_000,
                                    disk=disk, **kw))
        v45 = np.asarray(render_kerr(m, cam, bg, dt=0.1, max_steps=8_000,
                                     disk=disk, stepper="rk45", rtol=1e-5,
                                     **kw))
        assert np.isfinite(v45).all()
        # vs a dt=0.025 anchor the rk45 render is MORE accurate than this
        # rk4 one (0 mismatched px / 0.7% flux vs 0.1% px / 0.9% flux),
        # so the cross-stepper bounds here are dominated by rk4's error
        assert (np.abs(v4 - v45).max(-1) > 0.1).mean() < 0.02
        f4, f45 = v4.sum(), v45.sum()
        assert abs(f45 - f4) / f4 < 0.02


def test_kerr_rk45_threads_through_batched_and_adaptive(rng):
    """stepper='rk45' reaches the frames-batched and adaptive-AA Kerr
    renderers (round-3 wiring): batched == per-frame exactly (same march
    bundle), adaptive-AA stays finite and close to its rk4 twin."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import (render_kerr, render_kerr_adaptive,
                                        render_kerr_frames_batched)
    metric = make_kerr(m=1.0, a=0.9)
    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    th = np.pi / 2 - 0.2
    cams = [cv.make_camera([0.0, r0, th, ph],
                           [-np.sin(th) * np.cos(ph), -np.sin(th) * np.sin(ph),
                            -np.cos(th)],
                           [0.0, 0.0, 1.0], 24.0, 43.0, 24, 14,
                           dtype=jnp.float64)
            for r0, ph in [(28.0, 0.0), (30.0, 0.5)]]
    kw = dict(dt=0.25, max_steps=2000, escape_radius=64.0, backend="xla",
              stepper="rk45", rtol=1e-5)
    batch = np.asarray(render_kerr_frames_batched(metric, cams, bg, **kw))
    for f, cam in enumerate(cams):
        single = np.asarray(render_kerr(metric, cam, bg, **kw))
        np.testing.assert_allclose(batch[f], single, rtol=0, atol=1e-12)
    aa = np.asarray(render_kerr_adaptive(metric, cams[0], bg,
                                         refine_frac=0.05, **kw))
    assert np.isfinite(aa).all() and aa.shape == (14, 24, 3)
    base = np.asarray(render_kerr(metric, cams[0], bg, **kw))
    assert (np.abs(aa - base).max(-1) > 0.2).mean() < 0.1


def test_shadow_outline_analytic_limits():
    """shadow_outline (Bardeen critical curve): equatorial alpha extremes
    equal the analytic prograde/retrograde critical impact parameters; the
    a -> 0 limit is the sqrt(27)M circle; the charged a -> 0 limit matches
    the Reissner-Nordstrom critical b = r_ph / sqrt(A(r_ph))."""
    from curvis_tpu.metrics.kerr import (KerrNewmanMetric, make_kerr,
                                         shadow_outline)
    m = make_kerr(1.0, 0.9)
    al, be = (np.asarray(v) for v in shadow_outline(m, np.pi / 2, n=8192))
    fin = np.isfinite(be)
    b_pro = float(m.critical_impact_parameter(True))
    b_ret = float(m.critical_impact_parameter(False))
    # alpha = -xi/sin(i): the prograde (xi > 0) rim sits at negative alpha
    np.testing.assert_allclose(-np.nanmin(al), b_pro, rtol=2e-3)
    np.testing.assert_allclose(np.nanmax(al), b_ret, rtol=2e-3)
    assert fin.mean() > 0.3

    tiny = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(1e-6))
    al, be = (np.asarray(v) for v in shadow_outline(tiny, 1.0, n=4096))
    rr = al ** 2 + be ** 2
    np.testing.assert_allclose(rr[np.isfinite(rr)], 27.0, rtol=1e-4)

    kn = KerrNewmanMetric(m=jnp.asarray(1.0), a=jnp.asarray(1e-6),
                          q=jnp.asarray(0.5))
    r_ph = (3.0 + np.sqrt(9.0 - 8.0 * 0.25)) / 2.0
    b_rn = r_ph / np.sqrt(1.0 - 2.0 / r_ph + 0.25 / r_ph ** 2)
    al, be = (np.asarray(v) for v in shadow_outline(kn, 1.0, n=4096))
    rr = al ** 2 + be ** 2
    np.testing.assert_allclose(rr[np.isfinite(rr)], b_rn ** 2, rtol=1e-4)


def test_shadow_outline_march_oracle():
    """The critical curve against the actual BL marcher, OFF-equator: for
    each photon-shell radius, a photon constructed from the Carter
    constants (E=1, L=xi, Q=eta) is captured when eta shrinks by 2e-3
    (radial potential R(r) > 0 all the way in) and escapes when eta grows
    by 2e-3 (a turning point appears) — dR/deta = -Delta < 0.  This pins
    the non-equatorial Carter-constant physics of the 3-D march, which the
    equatorial Bardeen threshold tests cannot see."""
    from curvis_tpu.integrate.rk45 import march_kerr_rk45
    from curvis_tpu.metrics.kerr import photon_shell_constants
    m = make_kerr(1.0, 0.9)
    inc = np.pi / 3
    r0 = 200.0
    # shell radii visible at inclination pi/3 with healthily positive eta
    r_p = np.linspace(1.9, 3.8, 10)
    xi, eta = (np.asarray(v, np.float64)
               for v in photon_shell_constants(m, jnp.asarray(r_p)))
    si, ci = np.sin(inc), np.cos(inc)
    keep = (eta > 0.3) & (eta + (0.9 * ci) ** 2 - (xi * ci / si) ** 2 > 0.05)
    xi, eta = xi[keep], eta[keep]
    assert keep.sum() >= 6

    def march(eta_scale):
        et = eta * eta_scale
        n = len(xi)
        x0 = np.stack([np.zeros(n), np.full(n, r0), np.full(n, inc),
                       np.zeros(n)], -1)
        delta = r0 ** 2 - 2.0 * r0 + 0.81
        R = ((r0 ** 2 + 0.81 - 0.9 * xi) ** 2
             - delta * ((xi - 0.9) ** 2 + et))
        p_th = np.sqrt(et - ci ** 2 * (xi ** 2 / si ** 2 - 0.81))
        p0 = np.stack([-np.ones(n), -np.sqrt(R) / delta, p_th, xi], -1)
        # construction check: exactly null
        H = jnp.einsum("nij,ni,nj->n", m.inverse_metric(jnp.asarray(x0)),
                       jnp.asarray(p0), jnp.asarray(p0))
        np.testing.assert_allclose(np.asarray(H), 0.0, atol=1e-9)
        res = march_kerr_rk45(m, jnp.asarray(x0), jnp.asarray(p0),
                              escape_radius=1.05 * r0, rtol=1e-9,
                              atol=1e-12, dt0=0.5, max_steps=200_000,
                              max_iters=1_000_000)
        return np.asarray(res.sign)
    np.testing.assert_array_equal(march(1.0 - 2e-3), 2)   # all captured
    np.testing.assert_array_equal(march(1.0 + 2e-3), 1)   # all escape


def test_shadow_rim_fit_recovers_parameters():
    """Differentiable rim fitting (examples/inverse_problem.py part 4):
    (M, a, i) by Adam through the analytic shadow_outline with a symmetric
    soft-chamfer loss on noisy rim points.  M and a recover tightly;
    inclination sits on the rim's shallow (a, i) ridge — the known
    near-degeneracy of shadow-only fits — so its tolerance is looser."""
    import jax
    import optax
    from curvis_tpu.metrics.kerr import shadow_outline

    def outline(m_, a_, inc, n=384):
        al, be = shadow_outline(KerrMetric(m=m_, a=a_), inc, n=n)
        fin = jnp.isfinite(be)
        far = jnp.asarray(1e3, al.dtype)
        al = jnp.where(fin, al, far)
        be = jnp.where(fin, be, far)
        return (jnp.concatenate([al, al]), jnp.concatenate([be, -be]),
                jnp.concatenate([fin, fin]))

    rng = np.random.default_rng(4)
    f64 = jnp.float64
    ao, bo, _ = outline(jnp.asarray(1.0, f64), jnp.asarray(0.9, f64),
                        jnp.asarray(1.15, f64))
    keep = np.abs(np.asarray(ao)) < 100.0
    obs = tuple(jnp.asarray(np.asarray(v)[keep]
                            + 5e-3 * rng.standard_normal(int(keep.sum())),
                            f64) for v in (ao, bo))

    def rim_loss(prm, tau):
        ap, bp, fin = outline(*prm)
        d2 = ((obs[0][:, None] - ap[None, :]) ** 2
              + (obs[1][:, None] - bp[None, :]) ** 2)
        l_ob = jnp.mean(-tau * jax.nn.logsumexp(-d2 / tau, axis=1))
        w = jax.lax.stop_gradient(fin.astype(d2.dtype))
        l_po = (jnp.sum(w * (-tau * jax.nn.logsumexp(-d2 / tau, axis=0)))
                / jnp.sum(w))
        return l_ob + l_po

    vg = jax.jit(jax.value_and_grad(rim_loss))
    opt = optax.adam(1e-2)
    prm = jnp.asarray([0.7, 0.5, 0.8], f64)
    st = opt.init(prm)
    for i in range(400):
        tau = jnp.asarray(max(5e-4, 0.02 * 0.97 ** i), f64)
        _, g = vg(prm, tau)
        up, st = opt.update(g, st)
        prm = prm + up
        prm = jnp.asarray([jnp.clip(prm[0], 0.2, 3.0),
                           jnp.clip(prm[1], 0.05, 0.998 * prm[0]),
                           jnp.clip(prm[2], 0.1, np.pi / 2 - 1e-3)])
    m_f, a_f, i_f = (float(v) for v in prm)
    assert abs(m_f - 1.0) < 0.01, prm
    assert abs(a_f - 0.9) < 0.02, prm
    assert abs(i_f - 1.15) < 0.12, prm
