"""Accretion-disk rendering: crossing detection oracle + image structure."""
import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.metrics.base import SchwarzschildMetric
from curvis_tpu.physics import planar as pl
from curvis_tpu.render.disk import (DiskParams, march_planar_disk,
                                    render_blackhole_disk)


def test_flat_space_disk_crossing_radius():
    """Analytic oracle: a straight ray in flat space from (l0, z-plane tilt)
    crosses z=0 at a computable radius."""
    metric = cv.make_metric("flat")
    # ray in a plane tilted so e1=(x toward origin-ish), launch geometry:
    # start at l0 on +x axis (e1 = x_hat), plane with e2 = (0, s, c) so the
    # z-component of e2 is c; ray direction alpha from e1.
    l0 = 20.0
    alpha = 2.6           # mostly inward, some transverse
    c1, c2 = -0.3, 0.8    # z-components of (e1, e2); start above the plane,
    #                        heading down through it
    rays = pl.PlanarRays(l=jnp.asarray([l0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([np.cos(alpha)]),
                         b=jnp.asarray([np.sin(alpha) * l0]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))
    res, (h1, _h1p, _h1s), _h2 = march_planar_disk(
        metric, rays, jnp.asarray([c1]), jnp.asarray([c2]), dt=0.002,
        max_steps=100_000, escape_radius=60.0, r_inner=0.1, r_outer=60.0)
    # analytic: straight line P(t) = l0 e1 + t d, d = cos(a) e1 + sin(a) e2
    # z(t) = (l0 + t cos a) c1 + t sin a c2 = 0
    t_cross = -l0 * c1 / (np.cos(alpha) * c1 + np.sin(alpha) * c2)
    x1 = l0 + t_cross * np.cos(alpha)
    x2 = t_cross * np.sin(alpha)
    r_expected = np.hypot(x1, x2)
    assert t_cross > 0
    np.testing.assert_allclose(float(h1[0]), r_expected, rtol=1e-3)


def test_blackhole_disk_image(rng):
    """Image structure: shadow, bright disk band, lensed far side above the
    hole (a disk hit where the geometric disk is edge-on/behind)."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    # camera slightly above the disk plane, aimed at the hole: the classic
    # "Gargantua" framing
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 96, 54, dtype=jnp.float64)
    bg = cv.make_spherical_image(0.02 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    img = np.asarray(render_blackhole_disk(
        metric, cam, bg, dt=0.05, max_steps=40_000, escape_radius=80.0,
        disk=DiskParams(r_inner=5.2, r_outer=13.0, brightness=2.2,
                        opacity=0.95)))
    H, W = img.shape[:2]
    assert img.shape == (54, 96, 3)
    lum = img.sum(-1)
    # a substantial bright disk against the dim background
    assert (lum > 0.5).mean() > 0.08
    # the shadow (dark) sits just above center
    center = lum[H // 2 - 8:H // 2, W // 2 - 4:W // 2 + 4]
    assert center.min() < 0.05
    # bright emission above AND below the shadow: the lensed far side
    assert (lum[: H // 4] > 0.5).any()
    assert (lum[3 * H // 4:] > 0.3).any()


def test_doppler_beaming_asymmetry(rng):
    """Relativistic beaming brightens the approaching side; flipping the
    disk spin flips the asymmetry."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 96, 54, dtype=jnp.float64)
    bg = cv.make_spherical_image(0.02 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)

    def lum_halves(spin):
        img = np.asarray(render_blackhole_disk(
            metric, cam, bg, dt=0.05, max_steps=40_000, escape_radius=80.0,
            disk=DiskParams(r_inner=5.2, r_outer=13.0, brightness=1.2,
                            doppler=True, spin_sign=spin)))
        lum = img.sum(-1)
        W = lum.shape[1]
        return lum[:, : W // 2].sum(), lum[:, W // 2:].sum()

    l_pos, r_pos = lum_halves(+1.0)
    l_neg, r_neg = lum_halves(-1.0)
    ratio_pos = l_pos / r_pos
    ratio_neg = l_neg / r_neg
    # one side clearly brighter, and the spin flip inverts it (up to the
    # pixel-corner grid asymmetry)
    assert ratio_pos < 0.5 and ratio_neg > 2.0
    np.testing.assert_allclose(ratio_pos * ratio_neg, 1.0, rtol=0.1)


def test_disk_pallas_kernel_interpret_matches_while():
    """The Pallas disk kernel (interpret mode) vs the XLA disk march."""
    from curvis_tpu.ops.march_pallas import march_planar_disk_pallas
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 24, 12, dtype=jnp.float64)
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa
    dx, dy, dz = _pixel_dirs_soa(cam, False)
    (l, psi, p_l, b), r_hat, e2 = _spawn_planar_soa(metric, cam, dx, dy, dz)
    from curvis_tpu.physics import planar as pl2
    c1 = jnp.broadcast_to(r_hat[2], l.shape).astype(jnp.float32)
    c2 = e2[2].astype(jnp.float32)
    rays32 = pl2.PlanarRays(*(a.astype(jnp.float32) for a in
                              (l, psi, p_l, b)),
                            jnp.zeros((1, 3), jnp.float32),
                            jnp.zeros((1, 3), jnp.float32))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0,
              r_inner=5.2, r_outer=13.0)
    from curvis_tpu.render.disk import march_planar_disk
    res_a, (h1a, p1a, s1a), (h2a, p2a, s2a) = march_planar_disk(
        metric, rays32, c1, c2, **kw)
    res_b, (h1b, p1b, s1b), (h2b, p2b, s2b) = march_planar_disk_pallas(
        metric, rays32, c1, c2, **kw)
    np.testing.assert_array_equal(np.asarray(res_a.sign),
                                  np.asarray(res_b.sign))
    hit_a = np.asarray(h1a) > 0
    hit_b = np.asarray(h1b) > 0
    assert (hit_a == hit_b).mean() > 0.97        # f32 edge flips only
    both = hit_a & hit_b
    np.testing.assert_allclose(np.asarray(h1a)[both], np.asarray(h1b)[both],
                               rtol=1e-3)
    # psi-at-crossing (the starlight shading input) twin parity: the while
    # twin interpolates psi within the step, the kernel uses psi + frac*du
    # — same first-order rule, so the agreement is tight off edge flips
    np.testing.assert_allclose(np.asarray(s1a)[both], np.asarray(s1b)[both],
                               rtol=1e-3, atol=1e-3)


def test_blackbody_rgb_chromaticity():
    """Planck colors: red-dominant at 2000 K, near-white ~6600 K,
    blue-dominant at 15000 K; smooth and normalized."""
    from curvis_tpu.render.disk import blackbody_rgb
    rgb = np.asarray(blackbody_rgb(jnp.asarray([2000.0, 6600.0, 15000.0])))
    np.testing.assert_allclose(rgb.max(axis=1), 1.0)
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    assert r[0] > g[0] > b[0]            # glowing red-orange
    assert b[0] < 0.25
    assert min(r[1], g[1], b[1]) > 0.6   # whitish
    assert b[2] >= r[2]                  # blue-white
    # monotone blue fraction with temperature
    T = jnp.linspace(1500.0, 20000.0, 64)
    frac_b = np.asarray(blackbody_rgb(T))[:, 2]
    assert (np.diff(frac_b) > -1e-6).all()


def test_disk_temperature_profile():
    """Shakura-Sunyaev profile: zero at the inner edge, peak t_peak at
    r = 49/36 r_in, decays outward."""
    from curvis_tpu.render.disk import disk_temperature
    p = DiskParams(r_inner=6.0, r_outer=30.0, t_peak=9000.0)
    r = jnp.linspace(6.0, 30.0, 2001)
    T = np.asarray(disk_temperature(r, p))
    assert abs(T[0]) < 1e-6
    ipk = T.argmax()
    np.testing.assert_allclose(T[ipk], 9000.0, rtol=1e-4)
    np.testing.assert_allclose(float(r[ipk]), 49.0 / 36.0 * 6.0, rtol=2e-2)
    assert T[-1] < T[ipk]


def test_blackbody_disk_doppler_color_asymmetry(rng):
    """The chromatic shift: the approaching (Doppler-boosted) side of a
    blackbody disk is both brighter AND bluer than the receding side."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 96, 54, dtype=jnp.float64)
    bg = cv.make_spherical_image(np.zeros((16, 32, 3)), dtype=jnp.float64)
    disk = DiskParams(r_inner=5.2, r_outer=13.0, doppler=True, redshift=True,
                      color_mode="blackbody", t_peak=7000.0)
    img = np.asarray(render_blackhole_disk(
        metric, cam, bg, dt=0.05, max_steps=40_000, escape_radius=80.0,
        backend="while", disk=disk))
    H, W = img.shape[:2]
    left = img[:, : W // 3]
    right = img[:, 2 * W // 3:]
    lum_l, lum_r = left.sum(), right.sum()
    bright, dim = (left, right) if lum_l > lum_r else (right, left)
    assert max(lum_l, lum_r) > 3.0 * min(lum_l, lum_r)   # beaming
    # blue fraction of the disk light: approaching side hotter -> bluer
    def blue_frac(side):
        lit = side.sum(-1) > 0.05
        return side[..., 2][lit].sum() / side[lit].sum()
    assert blue_frac(bright) > blue_frac(dim) + 0.02


def test_blackbody_rgb_cold_temperature_finite():
    """Regression: the naive 1/expm1 Planck form overflowed to 0/0 = NaN
    below ~300 K in f32; the log-space form stays finite at any T."""
    from curvis_tpu.render.disk import blackbody_rgb
    T = jnp.asarray([0.0, 1.0, 10.0, 100.0, 300.0, 1e6], jnp.float32)
    rgb = np.asarray(blackbody_rgb(T))
    assert np.isfinite(rgb).all()
    np.testing.assert_allclose(rgb.max(axis=1), 1.0, rtol=1e-5)
    assert rgb[1, 0] == 1.0 and rgb[1, 2] < 1e-6    # cold = pure red ratio


def test_finite_thickness_slab_shading(rng):
    """Finite-thickness mode: thickness=0 is bit-identical to the thin
    model, thickness>0 only ever adds light/opacity (chord >= 1), grazing
    geometry brightens more than face-on, and the chord cap holds."""
    from curvis_tpu.render.disk import _disk_rgb
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 96, 54, dtype=jnp.float64)
    bg = cv.make_spherical_image(0.02 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    kw = dict(dt=0.05, max_steps=40_000, escape_radius=80.0, backend="while")
    base = DiskParams(r_inner=5.2, r_outer=13.0, brightness=1.2)
    thin = np.asarray(render_blackhole_disk(metric, cam, bg, disk=base, **kw))
    # dataclasses.replace keeps every other knob identical
    import dataclasses as dc
    zero = np.asarray(render_blackhole_disk(
        metric, cam, bg, disk=dc.replace(base, thickness=0.0), **kw))
    np.testing.assert_array_equal(thin, zero)     # bit-exact thin limit
    slab = np.asarray(render_blackhole_disk(
        metric, cam, bg, disk=dc.replace(base, thickness=0.15), **kw))
    # the slab never darkens the disk: per-pixel luminance >= thin wherever
    # the image differs meaningfully (composite can dim bg-dominated pixels
    # by at most the added alpha of a dim far-side crossing)
    lum_t, lum_s = thin.sum(-1), slab.sum(-1)
    assert lum_s.sum() > lum_t.sum() * 1.02       # net brightening
    assert (lum_s >= lum_t - 0.05).mean() > 0.995
    # unit-level: alpha and rgb are monotone in thickness, chord capped
    r_hit = jnp.asarray([6.5, 9.0, 12.0])
    pl_hit = jnp.asarray([0.4, -0.2, 0.05])
    b = jnp.asarray([4.0, -6.0, 0.3])             # last: nearly radial ->
    nz = jnp.asarray([0.9, 0.9, 0.02])            # near-grazing chord
    rgb0, a0 = _disk_rgb(metric, r_hit, pl_hit, b, nz, base, jnp.float64)
    p_thick = dc.replace(base, thickness=0.15)
    rgb1, a1 = _disk_rgb(metric, r_hit, pl_hit, b, nz, p_thick, jnp.float64)
    assert (np.asarray(a1) >= np.asarray(a0) - 1e-12).all()
    assert (np.asarray(rgb1) >= np.asarray(rgb0) - 1e-12).all()
    assert np.asarray(a1).max() <= base.opacity * 8 + 1e-9   # cap ~ 8x
    # fat slab (aspect >= 1): chord pinned to 1 -> thin values to fp error
    p_fat = dc.replace(base, thickness=2.0)
    rgb2, a2 = _disk_rgb(metric, r_hit, pl_hit, b, nz, p_fat, jnp.float64)
    np.testing.assert_allclose(np.asarray(rgb2), np.asarray(rgb0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a0), rtol=1e-12)


def test_volumetric_transfer_flat_space_oracle():
    """Volumetric radiative transfer oracle: in flat space the ray is a
    straight line, so tau and the emission integral have an independent
    numpy-quadrature answer along the analytic path."""
    from curvis_tpu.render.disk import march_planar_disk_volumetric
    metric = cv.make_metric("flat")
    l0 = 20.0
    alpha = 2.6
    c1, c2 = -0.3, 0.8
    nzv = 0.0                       # flat space: no doppler/redshift anyway
    p = DiskParams(r_inner=2.0, r_outer=30.0, volumetric=True, h_rel=0.1,
                   kappa=1.5, brightness=1.0, emissivity_index=2.0,
                   redshift=False, doppler=False)
    rays = pl.PlanarRays(l=jnp.asarray([l0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([np.cos(alpha)]),
                         b=jnp.asarray([np.sin(alpha) * l0]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))
    dt = 0.005
    res, tau, em = march_planar_disk_volumetric(
        metric, rays, jnp.asarray([c1]), jnp.asarray([c2]),
        jnp.asarray([nzv]), dt=dt, max_steps=400_000, escape_radius=60.0,
        params=p)
    assert int(res.sign[0]) == 1
    # independent quadrature: P(t) = l0 e1 + t d (unit speed, straight line)
    t = np.arange(1, int(res.steps[0]) + 1) * dt   # post-step sample points
    x1 = l0 + t * np.cos(alpha)
    x2 = t * np.sin(alpha)
    z = x1 * c1 + x2 * c2
    r2 = x1 * x1 + x2 * x2
    r_cyl = np.sqrt(np.maximum(r2 - z * z, 1e-30))
    H = p.h_rel * r_cyl
    dens = np.exp(-z * z / (2 * H * H)) / (np.sqrt(2 * np.pi) * H)
    w = p.r_outer - p.r_inner
    edge = (np.clip((r_cyl - p.r_inner) / (0.1 * w), 0, 1)
            * np.clip((p.r_outer - r_cyl) / (0.3 * w), 0, 1))
    base = dens * edge
    dtau = p.kappa * base * dt
    tau_before = np.concatenate([[0.0], np.cumsum(dtau)[:-1]])
    emis = (p.r_inner / np.maximum(r_cyl, p.r_inner)) ** 2
    em_expected = np.sum(np.exp(-tau_before) * base * emis * dt)
    tau_expected = dtau.sum()
    np.testing.assert_allclose(float(tau[0]), tau_expected, rtol=2e-3)
    np.testing.assert_allclose(float(em[0][0]), em_expected, rtol=2e-3)
    assert float(tau[0]) > 0.3          # the ray really went through gas


def test_volumetric_blackhole_disk_image(rng):
    """Volumetric Schwarzschild disk: same scene as the thin-disk test —
    shadow + bright band + lensed far side, soft edges, finite everywhere;
    total light comparable to the thin model."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 96, 54, dtype=jnp.float64)
    bg = cv.make_spherical_image(0.02 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    import dataclasses as dc
    base = DiskParams(r_inner=5.2, r_outer=13.0, brightness=2.2,
                      opacity=0.95)
    kw = dict(dt=0.05, max_steps=40_000, escape_radius=80.0, backend="while")
    thin = np.asarray(render_blackhole_disk(metric, cam, bg, disk=base, **kw))
    volp = dc.replace(base, volumetric=True, h_rel=0.08,
                      kappa=3.0)          # ~ -ln(1 - 0.95)
    volu = np.asarray(render_blackhole_disk(metric, cam, bg, disk=volp, **kw))
    assert np.isfinite(volu).all()
    lum_t, lum_v = thin.sum(-1), volu.sum(-1)
    H, W = lum_v.shape
    # same gross structure: bright band, dark shadow center
    assert (lum_v > 0.5).mean() > 0.05
    center = lum_v[H // 2 - 8:H // 2, W // 2 - 4:W // 2 + 4]
    assert center.min() < 0.05
    assert (lum_v[: H // 4] > 0.3).any()       # lensed far side above
    # total energy within 3x of the thin model (same brightness semantics)
    assert 1 / 3 < lum_v.sum() / lum_t.sum() < 3.0
    # volumetric edges are SOFT: the histogram of disk-band luminances has
    # more intermediate values than the thin model's near-binary alpha
    inter_v = ((lum_v > 0.1) & (lum_v < 0.45)).mean()
    inter_t = ((lum_t > 0.1) & (lum_t < 0.45)).mean()
    assert inter_v > inter_t


def test_volumetric_pallas_kernel_interpret_matches_while():
    """The Pallas volumetric kernel (interpret mode) vs the XLA volumetric
    march — identical per-step semantics, so f32 agreement should be tight
    (smooth integrands, no chaotic-crossing amplification in tau/em)."""
    from curvis_tpu.ops.march_pallas import \
        march_planar_disk_volumetric_pallas
    from curvis_tpu.render.disk import march_planar_disk_volumetric
    import dataclasses as dc
    metric = SchwarzschildMetric(m=jnp.asarray(1.0, jnp.float32))
    th = np.pi / 2 - 0.22
    cam = cv.make_camera([0.0, 28.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 24, 12, dtype=jnp.float32)
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa
    dx, dy, dz = _pixel_dirs_soa(cam, False)
    (l, psi, p_l, b), r_hat, e2 = _spawn_planar_soa(metric, cam, dx, dy, dz)
    c1 = jnp.broadcast_to(r_hat[2], l.shape).astype(jnp.float32)
    c2 = e2[2].astype(jnp.float32)
    nz = (r_hat[0] * e2[1] - r_hat[1] * e2[0]).astype(jnp.float32)
    rays = pl.PlanarRays(*(a.astype(jnp.float32) for a in (l, psi, p_l, b)),
                         jnp.zeros((1, 3), jnp.float32),
                         jnp.zeros((1, 3), jnp.float32))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0)
    for mode in ("tint", "blackbody"):
        disk = DiskParams(r_inner=5.2, r_outer=13.0, volumetric=True,
                          h_rel=0.08, kappa=3.0, color_mode=mode,
                          t_peak=7000.0)
        res_a, tau_a, em_a = march_planar_disk_volumetric(
            metric, rays, c1, c2, nz, params=disk, **kw)
        res_b, tau_b, em_b = march_planar_disk_volumetric_pallas(
            metric, rays, c1, c2, nz, disk=disk,
            **kw)
        np.testing.assert_array_equal(np.asarray(res_a.sign),
                                      np.asarray(res_b.sign))
        np.testing.assert_allclose(np.asarray(tau_a), np.asarray(tau_b),
                                   rtol=2e-3, atol=1e-5)
        for ea, eb in zip(em_a, em_b):
            np.testing.assert_allclose(np.asarray(ea), np.asarray(eb),
                                       rtol=5e-3, atol=1e-5)
