"""Charged black holes: Reissner-Nordstrom (planar reduction) and
Kerr-Newman (Boyer-Lindquist marchers).

Oracles are reductions and cross-formulations, not ported numbers:
  * RN(q=0) is Schwarzschild BIT-FOR-BIT (the lapse reduces exactly);
  * the RN shadow edge is the analytic b_c = r_ph / sqrt(A(r_ph)),
    r_ph = (3M + sqrt(9M^2 - 8Q^2))/2;
  * KN(q=0) is Kerr bit-for-bit (Delta picks up +0.0);
  * KN(a -> 0) must reproduce the planar RN volumetric render — two
    independent formulations (5-state BL RK4 + circular-orbit g vs
    orbital-plane reduction + static-frame Doppler g) of the same image.

These metrics are pure upgrades — the reference supports neither charge nor
spin (/root/reference/README.md:111).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.metrics.base import (ReissnerNordstromMetric,
                                     SchwarzschildMetric, make_metric)
from curvis_tpu.metrics.kerr import (KerrNewmanMetric, make_kerr,
                                     make_kerr_newman)
from curvis_tpu.physics import hamiltonian as ham
from curvis_tpu.physics import planar as pl


def _rn(m=1.0, q=0.6):
    return ReissnerNordstromMetric(m=jnp.asarray(m), q=jnp.asarray(q))


def _ray(metric, b, l0=500.0):
    """Inward planar photon with asymptotic impact parameter b (same spawn
    as tests/test_schwarzschild.py:_ray; B = 1/A for both families)."""
    A0 = float(metric.lapse(jnp.asarray(l0)))
    alpha = np.pi - np.arcsin(b * np.sqrt(A0) / l0)
    return pl.PlanarRays(l=jnp.asarray([l0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([np.cos(alpha) / A0]),
                         b=jnp.asarray([np.sin(alpha) * l0 / np.sqrt(A0)]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))


def _fate(metric, b):
    res = pl.march_planar_while(metric, _ray(metric, b), dt=0.02,
                                max_steps=200_000, escape_radius=520.0)
    return int(res.sign[0])


# ---------------------------------------------------------------------------
# Reissner-Nordstrom (planar reduction)
# ---------------------------------------------------------------------------

def test_rn_q0_is_schwarzschild_bitwise():
    """At q = 0 the RN lapse folds to the Schwarzschild lapse exactly
    (0.0/l = 0.0, x - 0.0 = x), so the whole march agrees bit-for-bit."""
    rn = _rn(q=0.0)
    sch = SchwarzschildMetric(m=jnp.asarray(1.0))
    rays = _ray(sch, 7.0)
    kw = dict(dt=0.05, max_steps=50_000, escape_radius=520.0)
    a = pl.march_planar_while(rn, rays, **kw)
    b = pl.march_planar_while(sch, rays, **kw)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_rn_shadow_critical_impact_parameter():
    """Capture/escape brackets the analytic b_c; charge shrinks the shadow
    monotonically from 3 sqrt(3) M."""
    b_sch = 3.0 * np.sqrt(3.0)
    prev = b_sch
    for q in (0.3, 0.6, 0.9):
        metric = _rn(q=q)
        b_c = float(metric.critical_impact_parameter)
        assert b_c < prev                     # shadow shrinks with charge
        prev = b_c
        r_ph = float(metric.photon_sphere_radius)
        # photon sphere: 2 A(r) = r A'(r) there
        np.testing.assert_allclose(
            2.0 * float(metric.lapse(jnp.asarray(r_ph))),
            r_ph * float(metric.lapse_deriv(jnp.asarray(r_ph))), rtol=1e-12)
        assert _fate(metric, b_c * 0.97) == pl.CAPTURED
        assert _fate(metric, b_c * 1.03) == 1
    np.testing.assert_allclose(float(_rn(q=0.0).critical_impact_parameter),
                               b_sch, rtol=1e-12)


def test_rn_pallas_interpret_matches_while():
    """The 'rn' Pallas deriv branch against the generic XLA planar march."""
    from curvis_tpu.camera.camera import pixel_rays_world
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    metric = ReissnerNordstromMetric(m=jnp.asarray(1.0, jnp.float32),
                                     q=jnp.asarray(0.6, jnp.float32))
    cam = cv.make_camera([0.0, 30.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 8,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    rays = pl.PlanarRays(*(a.astype(jnp.float32) for a in rays))
    kw = dict(dt=0.02, max_steps=40_000, escape_radius=60.0)
    a = pl.march_planar_while(metric, rays, **kw)
    b = march_planar_pallas(metric, rays, **kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(b.sign))
    escaped = np.asarray(a.sign) == 1
    assert np.abs(np.asarray(a.psi) - np.asarray(b.psi))[escaped].max() < 1e-3


def test_rn_shadow_smaller_than_schwarzschild_image(rng):
    """Image-level: same camera, the q = 0.9 shadow disk has fewer black
    pixels than the q = 0 one."""
    from curvis_tpu.render.fast import render_planar_fast
    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    cam = cv.make_camera([0.0, 30.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 64, 36,
                         dtype=jnp.float64)
    kw = dict(dt=0.02, max_steps=100_000, escape_radius=100.0,
              backend="tiled", filtering="bilinear")
    blacks = []
    for q in (0.0, 0.9):
        img = np.asarray(render_planar_fast(_rn(q=q), cam, bg, bg, **kw))
        black = img.sum(-1) == 0
        assert black[18, 32]                   # shadow at center
        blacks.append(int(black.sum()))
    assert blacks[1] < blacks[0]


# ---------------------------------------------------------------------------
# Kerr-Newman (Boyer-Lindquist)
# ---------------------------------------------------------------------------

def test_kn_metric_inverse_consistency():
    metric = make_kerr_newman(m=1.0, a=0.6, q=0.5)
    for r, th in ((5.0, np.pi / 2), (3.0, 1.0), (10.0, 2.5)):
        x = jnp.asarray([0.0, r, th, 0.3])
        g = np.asarray(metric.metric(x))
        ginv = np.asarray(metric.inverse_metric(x))
        np.testing.assert_allclose(g @ ginv, np.eye(4), atol=1e-10)
    np.testing.assert_allclose(float(metric.horizon_radius),
                               1.0 + np.sqrt(1.0 - 0.36 - 0.25), rtol=1e-12)


def test_kn_q0_matches_kerr_bitwise():
    """q = 0 Kerr-Newman marches identically to Kerr (Delta + 0.0)."""
    kn = KerrNewmanMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.8),
                          q=jnp.asarray(0.0))
    kerr = make_kerr(m=1.0, a=0.8)
    x = jnp.asarray([[0.0, 20.0, np.pi / 2 - 0.3, 0.0]] * 3)
    d = jnp.asarray([[-0.9, 0.1, 0.42], [-0.8, -0.2, 0.55], [-1.0, 0.0, 0.1]])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    p_kn = ham.spawn_photon(kn, x, d)
    p_k = ham.spawn_photon(kerr, x, d)
    np.testing.assert_array_equal(np.asarray(p_kn), np.asarray(p_k))
    kw = dict(dt=0.1, max_steps=5_000, escape_radius=50.0,
              capture_radius=float(kerr.capture_radius))
    a = ham.march_hamiltonian(kn, x, p_kn, **kw)
    b = ham.march_hamiltonian(kerr, x, p_k, **kw)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_kn_pallas_matches_xla():
    """Pallas BL kernel (q^2 param slot) vs the autodiff marcher, f64
    interpret — identical flow, so tight agreement."""
    from curvis_tpu.ops.march_pallas import march_kerr_pallas
    from curvis_tpu.render.kerr import _spawn_kerr_rays
    metric = make_kerr_newman(m=1.0, a=0.7, q=0.5)
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 20.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, 16, 8, dtype=jnp.float64)
    x0, p0 = _spawn_kerr_rays(metric, cam)
    kw = dict(dt=0.1, max_steps=3_000, escape_radius=45.0)
    a = ham.march_hamiltonian(metric, x0, p0,
                              capture_radius=float(metric.capture_radius),
                              **kw)
    x, p, sign, steps = march_kerr_pallas(metric, x0, p0,
                                          **kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(sign))
    ok = np.asarray(a.sign) > 0
    np.testing.assert_allclose(np.asarray(a.x)[ok, 1:],
                               np.asarray(x)[ok, 1:], rtol=1e-9, atol=1e-9)


def test_kn_equatorial_fates_reduce_to_rn_and_kerr():
    """Equatorial capture thresholds: KN(a -> 0, q) brackets the analytic RN
    b_c; charge shrinks both prograde and retrograde Kerr shadows."""
    from test_kerr import _equatorial_fate
    rn_bc = float(_rn(q=0.6).critical_impact_parameter)
    kn = make_kerr_newman(m=1.0, a=1e-6, q=0.6)
    assert _equatorial_fate(kn, rn_bc * 0.97) == 2
    assert _equatorial_fate(kn, rn_bc * 1.03) == 1
    # spinning + charged: thresholds sit strictly inside the Kerr ones
    kerr = make_kerr(m=1.0, a=0.7)
    knq = make_kerr_newman(m=1.0, a=0.7, q=0.5)
    b_pro = float(kerr.critical_impact_parameter(True))
    b_ret = float(kerr.critical_impact_parameter(False))
    assert _equatorial_fate(knq, b_pro * 0.99) == 1       # Kerr-captured -> escapes
    assert _equatorial_fate(knq, -(b_ret * 0.99)) == 1
    assert _equatorial_fate(knq, b_pro * 0.80) == 2       # deep inside: captured
    assert _equatorial_fate(knq, -(b_ret * 0.80)) == 2


def test_kn_a0_volumetric_matches_planar_rn():
    """Cross-formulation image oracle: KN(a -> 0, q) through the BL RK4
    volumetric march equals the planar RN volumetric render (blackbody +
    Doppler), up to shadow-edge pixels — the charged analogue of
    tests/test_kerr.py:test_kerr_volumetric_a0_matches_planar_schwarzschild."""
    from curvis_tpu.render.disk import DiskParams, render_blackhole_disk
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
    kn = KerrNewmanMetric(m=jnp.asarray(1.0, jnp.float32),
                          a=jnp.asarray(1e-6, jnp.float32),
                          q=jnp.asarray(0.6, jnp.float32))
    rn = ReissnerNordstromMetric(m=jnp.asarray(1.0, jnp.float32),
                                 q=jnp.asarray(0.6, jnp.float32))
    img_k = np.asarray(render_kerr(kn, cam, bg, dt=0.02, max_steps=15_000,
                                   escape_radius=50.0, disk=disk,
                                   backend="xla"))
    img_s = np.asarray(render_blackhole_disk(rn, cam, bg, dt=0.02,
                                             max_steps=15_000,
                                             escape_radius=50.0, disk=disk,
                                             backend="while"))
    assert np.isfinite(img_k).all() and np.isfinite(img_s).all()
    lk, ls = img_k.mean(), img_s.mean()
    assert abs(lk - ls) / ls < 0.05, (lk, ls)
    frac = (np.abs(img_k - img_s).max(axis=-1) > 0.08).mean()
    assert frac < 0.03, frac


# ---------------------------------------------------------------------------
# Construction / config surface
# ---------------------------------------------------------------------------

def test_make_metric_and_settings_dispatch():
    m = make_metric("rn", m=1.0, q=0.4)
    assert isinstance(m, ReissnerNordstromMetric)
    m = make_metric("reissner-nordstrom", m=2.0, q=0.0)
    assert float(m.critical_impact_parameter) == pytest.approx(
        2.0 * 3.0 * np.sqrt(3.0))
    with pytest.raises(ValueError):
        make_metric("rn", m=1.0, q=1.0)                   # extremal
    with pytest.raises(ValueError):
        make_kerr_newman(m=1.0, a=0.8, q=0.7)             # a^2+q^2 >= m^2
    from curvis_tpu.config.settings import MetricSettings, SettingsError
    s = MetricSettings(kind="kerr-newman", m=1.0, a=0.5, q=0.5)
    assert isinstance(s.validate().make(), KerrNewmanMetric)
    s = MetricSettings(kind="rn", m=1.0, q=0.3)
    assert isinstance(s.validate().make(), ReissnerNordstromMetric)
    with pytest.raises(SettingsError):
        MetricSettings(kind="rn", m=1.0, q=1.2).validate()
    with pytest.raises(SettingsError):
        MetricSettings(kind="kn", m=1.0, a=0.9, q=0.9).validate()
