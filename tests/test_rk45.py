"""Adaptive RK45 planar march: accuracy, step economy, renderer integration."""
import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.integrate.rk45 import march_planar_rk45
from curvis_tpu.metrics.base import EllisMetric
from curvis_tpu.physics import planar as pl


def _dirs(metric, rays, res):
    w = np.array(pl.planar_world_directions(metric, rays, res))
    return w / np.linalg.norm(w, axis=-1, keepdims=True)


def test_rk45_accuracy_and_step_economy():
    """RK45 must beat the reference Euler config by orders of magnitude in
    both accuracy and RHS evaluations (BASELINE config #2)."""
    metric = EllisMetric(rho=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 24, 14,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))

    truth = pl.march_planar_while(metric, rays, dt=0.001,
                                  max_steps=2_000_000, escape_radius=100.0,
                                  stepper="rk4")
    bt = _dirs(metric, rays, truth)

    res = march_planar_rk45(metric, rays, escape_radius=100.0, rtol=1e-6,
                            atol=1e-9)
    np.testing.assert_array_equal(np.asarray(truth.sign), np.asarray(res.sign))
    ang = np.arccos(np.clip((bt * _dirs(metric, rays, res)).sum(-1), -1, 1))
    steps = np.asarray(res.steps)
    assert ang.max() < 1e-3
    assert np.median(ang) < 2e-4
    assert steps.mean() < 100          # vs ~2000 for Euler dt=0.05
    assert steps.max() < 500

    eul = pl.march_planar_while(metric, rays, dt=0.05, max_steps=40_000,
                                escape_radius=100.0)
    ang_e = np.arccos(np.clip((bt * _dirs(metric, rays, eul)).sum(-1), -1, 1))
    # RK45 is both more accurate (median) and ~20x cheaper
    assert np.median(ang) < 0.1 * np.median(ang_e)
    assert steps.mean() < 0.05 * np.asarray(eul.steps).mean()


def test_rk45_escape_interpolation_lands_on_radius():
    metric = EllisMetric(rho=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [1.0, 0.3, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 8, 6,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    res = march_planar_rk45(metric, rays, escape_radius=50.0)
    l = np.asarray(res.l)
    s = np.asarray(res.sign)
    np.testing.assert_allclose(np.abs(l[s != 0]), 50.0, rtol=1e-12)


def test_rk45_not_escaped_cap():
    """Rays that cannot escape within max_steps report sign 0."""
    metric = EllisMetric(rho=jnp.asarray(1.0))
    rays = pl.PlanarRays(l=jnp.asarray([5.0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([1.0]), b=jnp.asarray([0.0]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))
    res = march_planar_rk45(metric, rays, escape_radius=1e9, max_steps=50)
    assert int(res.sign[0]) == 0
    assert int(res.steps[0]) == 50


def test_rk45_renderer_matches_euler_renderer(rng):
    """stepper='rk45' through the fast renderer: same image as the Euler
    path up to integration error (smooth bg, bilinear)."""
    from curvis_tpu.render.fast import render_planar_fast
    metric = EllisMetric(rho=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 48, 27,
                         dtype=jnp.float64)
    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx / w, yy / h, 0.5 + 0 * xx], -1)
    bgp = cv.make_spherical_image(smooth, dtype=jnp.float64)
    bgn = cv.make_spherical_image(smooth[::-1].copy(), dtype=jnp.float64)
    kw = dict(dt=0.05, max_steps=40_000, escape_radius=100.0,
              filtering="bilinear", backend="tiled")
    a = np.asarray(render_planar_fast(metric, cam, bgp, bgn, **kw))
    kw["backend"] = "auto"
    b = np.asarray(render_planar_fast(metric, cam, bgp, bgn,
                                      stepper="rk45", **{k: v for k, v in
                                                         kw.items()
                                                         if k != "backend"}))
    d = np.abs(a - b).max(-1)
    # Euler's own error dominates; differences stay in the chaotic band
    assert (d > 0.05).mean() < 0.05
    assert np.median(d) < 5e-3


def test_pallas_rk45_interpret_matches_xla():
    """The Pallas RK45 kernel vs the XLA implementation (CPU interpret)."""
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    metric = EllisMetric(rho=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 8,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    rays = pl.PlanarRays(*(a.astype(jnp.float32) for a in rays))
    kw = dict(escape_radius=50.0, rtol=1e-5, atol=1e-7)
    a = march_planar_rk45(metric, rays, **kw)
    b = march_planar_rk45_pallas(metric, rays, **kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(b.sign))
    assert np.abs(np.asarray(a.psi) - np.asarray(b.psi)).max() < 1e-3
    # step counts agree closely (identical control flow, f32 rounding only)
    assert np.abs(np.asarray(a.steps) - np.asarray(b.steps)).max() <= 2

def test_rk45_nonfinite_ray_freezes_not_spins():
    """Termination regression: a ray whose state goes non-finite makes err
    = NaN; without the NaN guard on the controller factor, dt itself goes
    NaN, the dt-floor stall test compares False forever, and the single ray
    spins the whole march (or its Pallas tile) to max_iters with sign 0.
    Both twins must freeze it as sign 3 (blowup) and leave healthy rays
    untouched."""
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    metric = EllisMetric(rho=jnp.asarray(1.0))
    n = 8
    l = jnp.full((n,), 5.0).at[3].set(jnp.nan)          # one poisoned ray
    psi = jnp.zeros((n,))
    alpha = jnp.asarray(np.linspace(0.3, 1.0, n))
    rays = pl.PlanarRays(l, psi, -jnp.cos(alpha), 5.0 * jnp.sin(alpha),
                         jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    # max_iters small: the pre-fix code burned all 4 * max_steps iterations
    kw = dict(escape_radius=30.0, max_steps=400, rtol=1e-5, atol=1e-7)
    a = march_planar_rk45(metric, rays, max_iters=200, **kw)
    sa = np.asarray(a.sign)
    assert sa[3] == 3, sa
    assert (sa[np.arange(n) != 3] == 1).all(), sa       # others escape fine
    b = march_planar_rk45_pallas(metric, rays, **kw)
    sb = np.asarray(b.sign)
    assert sb[3] == 3, sb
    assert (sb[np.arange(n) != 3] == 1).all(), sb


# ---------------------------------------------------------------------------
# Round 4: planar rk45 x {thin disk, volumetric} (VERDICT round-3 #2) —
# the error-controlled stepper against the Euler surface oracles, f64.
# ---------------------------------------------------------------------------

def _disk_scene(dtype=jnp.float64):
    from curvis_tpu.metrics.base import SchwarzschildMetric
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa
    metric = SchwarzschildMetric(m=jnp.asarray(1.0, dtype))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 24, 12, dtype=dtype)
    dx, dy, dz = _pixel_dirs_soa(cam, False)
    (l, psi, p_l, b), r_hat, e2 = _spawn_planar_soa(metric, cam, dx, dy, dz)
    c1 = jnp.broadcast_to(r_hat[2], l.shape).astype(dtype)
    c2 = e2[2].astype(dtype)
    nz = (r_hat[0] * e2[1] - r_hat[1] * e2[0]).astype(dtype)
    rays = pl.PlanarRays(l, psi, p_l, b, jnp.zeros((1, 3), dtype),
                         jnp.zeros((1, 3), dtype))
    return metric, rays, c1, c2, nz


def test_rk45_disk_crossings_match_fine_euler_oracle():
    """Crossing radii from the adaptive march agree with a fine-dt Euler
    disk march — the surfaces see the same geometry regardless of the
    stepper (linear-in-step interpolation bounds the residual)."""
    from curvis_tpu.render.disk import march_planar_disk
    metric, rays, c1, c2, _ = _disk_scene()
    r_io = dict(r_inner=5.2, r_outer=13.0)
    res_e, (h1e, _, _se), _ = march_planar_disk(
        metric, rays, c1, c2, dt=0.01, max_steps=100_000,
        escape_radius=60.0, **r_io)
    res_a, (h1a, _, _sa), _ = march_planar_rk45(
        metric, rays, c1=c1, c2=c2, disk=(5.2, 13.0), escape_radius=60.0,
        rtol=1e-8, atol=1e-11, dt0=0.05, max_steps=40_000)
    hit_e, hit_a = np.asarray(h1e) > 0, np.asarray(h1a) > 0
    assert (hit_e == hit_a).mean() > 0.97
    both = hit_e & hit_a
    rel = np.abs(np.asarray(h1a)[both] - np.asarray(h1e)[both]) \
        / np.asarray(h1e)[both]
    # Euler at dt=0.01 carries its own O(dt) crossing jitter; the adaptive
    # march is the more accurate of the two
    assert np.median(rel) < 2e-3
    assert (rel > 2e-2).mean() <= 0.05


def test_rk45_disk_step_economy():
    """The adaptive thin-disk march needs far fewer accepted steps than
    the Euler march takes fixed ones, at equal-or-better crossing
    accuracy."""
    from curvis_tpu.render.disk import march_planar_disk
    metric, rays, c1, c2, _ = _disk_scene()
    res_e, _, _ = march_planar_disk(metric, rays, c1, c2, dt=0.05,
                                    max_steps=20_000, escape_radius=60.0,
                                    r_inner=5.2, r_outer=13.0)
    res_a, _, _ = march_planar_rk45(
        metric, rays, c1=c1, c2=c2, disk=(5.2, 13.0), escape_radius=60.0,
        rtol=1e-6, atol=1e-9, dt0=0.05, max_steps=40_000)
    esc = np.asarray(res_a.sign) != 0
    assert np.median(np.asarray(res_a.steps)[esc]) < \
        0.5 * np.median(np.asarray(res_e.steps)[esc])


def test_rk45_volumetric_matches_euler_quadrature():
    """Optical depth / emission from the adaptive vol march vs the Euler
    volumetric oracle: the in-disk dt clamp pins both quadratures to the
    same base resolution, so tau agrees at the percent level."""
    from curvis_tpu.render.disk import (DiskParams,
                                        march_planar_disk_volumetric)
    metric, rays, c1, c2, nz = _disk_scene()
    disk = DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                      h_rel=0.08, kappa=3.0, color_mode="tint",
                      t_peak=7000.0)
    _, tau_e, em_e = march_planar_disk_volumetric(
        metric, rays, c1, c2, nz, params=disk, dt=0.05, max_steps=20_000,
        escape_radius=60.0)
    _, tau_a, em_a = march_planar_rk45(
        metric, rays, c1=c1, c2=c2, nz=nz, vol_disk=disk,
        escape_radius=60.0, rtol=1e-6, atol=1e-9, dt0=0.05,
        max_steps=40_000)
    ta, te = np.asarray(tau_a), np.asarray(tau_e)
    assert np.abs(ta - te).sum() / max(np.abs(te).sum(), 1e-9) < 0.03
    ea = np.stack([np.asarray(c) for c in em_a])
    ee = np.stack([np.asarray(c) for c in em_e])
    assert np.abs(ea - ee).sum() / max(np.abs(ee).sum(), 1e-9) < 0.03


def test_render_disk_stepper_rk45_images_match():
    """render_blackhole_disk(stepper='rk45') e2e: thin and volumetric
    images agree with their Euler counterparts at image level."""
    from curvis_tpu.render.disk import DiskParams, render_blackhole_disk
    rng = np.random.default_rng(3)
    bg = cv.make_spherical_image(rng.random((32, 64, 3)))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 32, 18)
    from curvis_tpu.metrics.base import SchwarzschildMetric
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    for disk in (DiskParams(r_inner=5.2, r_outer=13.0),
                 DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                            h_rel=0.08, kappa=3.0, color_mode="tint",
                            t_peak=7000.0)):
        img_e = render_blackhole_disk(metric, cam, bg, dt=0.05,
                                      max_steps=20_000, escape_radius=60.0,
                                      disk=disk, backend="while")
        img_a = render_blackhole_disk(metric, cam, bg, dt=0.05,
                                      max_steps=20_000, escape_radius=60.0,
                                      disk=disk, backend="while",
                                      stepper="rk45", rtol=1e-6)
        d = np.abs(np.asarray(img_e) - np.asarray(img_a)).max(-1)
        # texel seams flip isolated pixels; the images must agree almost
        # everywhere (CLAUDE.md comparison invariant)
        assert (d > 0.1).mean() < 0.03, (disk.volumetric, (d > 0.1).mean())


def test_rk45_cap_boundary_ray_keeps_escape_fate():
    """A ray whose max_steps-th ACCEPTED step also escapes must report
    sign=1, not be clobbered to NotEscaped by the step-cap freeze — the
    Pallas twin tests the CURRENT sign and the XLA twin must match
    (regression: the freeze used the start-of-body active mask)."""
    metric = EllisMetric(rho=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 12, 8,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    full = march_planar_rk45(metric, rays, escape_radius=100.0, rtol=1e-6,
                             atol=1e-9)
    steps = np.asarray(full.steps)
    sign = np.asarray(full.sign)
    assert (sign != 0).all()
    smin = int(steps[sign == 1].min())
    capped = march_planar_rk45(metric, rays, escape_radius=100.0,
                               rtol=1e-6, atol=1e-9, max_steps=smin)
    boundary = (steps == smin) & (sign == 1)
    assert boundary.any()
    np.testing.assert_array_equal(np.asarray(capped.sign)[boundary],
                                  sign[boundary])
    # everyone needing more accepted steps is capped (sign 0)
    assert (np.asarray(capped.sign)[steps > smin] == 0).all()
