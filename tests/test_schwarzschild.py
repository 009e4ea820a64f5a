"""Schwarzschild black hole — the reference's #1 wishlist item, delivered.

Physics pins: weak-field deflection 4M/b, shadow critical impact parameter
b_c = 3*sqrt(3) M, and the rendered shadow disk.
"""
import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.integrate.rk45 import march_planar_rk45
from curvis_tpu.metrics.base import SchwarzschildMetric
from curvis_tpu.physics import planar as pl

B_CRIT = 3.0 * np.sqrt(3.0)        # for M = 1


def _ray(metric, b, l0=500.0):
    """Inward photon with asymptotic impact parameter b (for large l0,
    b = r sin(alpha)/sqrt(A) ~ impact parameter)."""
    A0 = float(metric.lapse(jnp.asarray(l0)))
    sin_a = b * np.sqrt(A0) / l0
    alpha = np.pi - np.arcsin(sin_a)
    p_l = np.cos(alpha) * np.sqrt(1.0) / A0      # sqrt(B/A) = 1/A
    return pl.PlanarRays(l=jnp.asarray([l0]), psi=jnp.asarray([0.0]),
                         p_l=jnp.asarray([p_l]),
                         b=jnp.asarray([np.sin(alpha) * l0 / np.sqrt(A0)]),
                         r_hat=jnp.zeros((1, 3)), e2=jnp.zeros((1, 3)))


def _deflection(metric, b, l0=500.0, R=520.0):
    rays = _ray(metric, b, l0)
    res = march_planar_rk45(metric, rays, escape_radius=R, rtol=1e-10,
                            atol=1e-12, dt0=0.1, dt_max=50.0,
                            max_steps=400_000)
    sign = int(res.sign[0])
    if sign != 1:
        return None, sign
    beta = float(pl.escape_angle_beta(metric, res, rays.b)[0])
    alpha = np.pi - np.arcsin(b * np.sqrt(float(metric.lapse(
        jnp.asarray(l0)))) / l0)
    delta = (beta - alpha + np.pi) % (2 * np.pi) - np.pi
    return delta, sign


def test_weak_field_deflection_4M_over_b():
    """The classical GR light-bending series
    delta = 4M/b + (15 pi / 4) (M/b)^2 + O((M/b)^3)."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    l0, R = 500.0, 520.0
    for b, tol in ((30.0, 0.012), (60.0, 0.01), (120.0, 0.01)):
        delta, sign = _deflection(metric, b, l0=l0, R=R)
        assert sign == 1
        # the march starts at l0 and stops at R, missing the asymptotic
        # bending tails ~ M b / r^2 per side
        tails = b / l0 ** 2 + b / R ** 2
        # Keeton-Petters series in the impact parameter
        expected = (4.0 / b + (15.0 * np.pi / 4.0) / b ** 2
                    + (128.0 / 3.0) / b ** 3)
        np.testing.assert_allclose(abs(delta) + tails, expected, rtol=tol)


def test_shadow_critical_impact_parameter():
    """b < 3*sqrt(3) M is captured (sign CAPTURED); b above it escapes."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    _, s_in = _deflection(metric, B_CRIT * 0.98)
    _, s_out = _deflection(metric, B_CRIT * 1.02)
    assert s_in == pl.CAPTURED
    assert s_out == 1


def test_capture_insensitive_to_capture_radius_placement():
    """Any capture radius in (2M, 3M) yields the same capture set."""
    import dataclasses
    m1 = SchwarzschildMetric(m=jnp.asarray(1.0))
    for b in (B_CRIT * 0.9, B_CRIT * 1.1):
        _, s = _deflection(m1, b)
        # euler marcher with different (implicit) capture radius property is
        # fixed at 2.5M; verify via the while marcher too
        rays = _ray(m1, b)
        res = pl.march_planar_while(m1, rays, dt=0.02, max_steps=200_000,
                                    escape_radius=520.0)
        assert int(res.sign[0]) == s


def test_shadow_renders_black_disk(rng):
    """Image-level: the black-hole shadow is a centered black disk with lit
    surroundings; no 'negative universe' pixels exist."""
    from curvis_tpu.render.fast import render_planar_fast
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 30.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 64, 36,
                         dtype=jnp.float64)
    bg = cv.make_spherical_image(0.5 + 0.5 * rng.random((16, 32, 3)),
                                 dtype=jnp.float64)
    img = np.asarray(render_planar_fast(metric, cam, bg, bg, dt=0.02,
                                        max_steps=100_000,
                                        escape_radius=100.0,
                                        backend="tiled",
                                        filtering="bilinear"))
    H, W = img.shape[:2]
    black = img.sum(-1) == 0
    assert black[H // 2, W // 2]                # shadow at center
    assert not black[H // 2, 2]                 # edges lit
    assert 0.005 < black.mean() < 0.5           # a disk, not the whole image
    # shadow angular radius ~ asin(b_c sqrt(A)/r0) -> diameter in pixels
    # (sanity: the disk is wider than 2 pixels and roughly round)
    row = black[H // 2]
    col = black[:, W // 2]
    assert abs(int(row.sum()) - int(col.sum())) <= max(3, row.sum() // 3)


def test_schwarzschild_pallas_interpret_matches_while():
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    cam = cv.make_camera([0.0, 30.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 8,
                         dtype=jnp.float64)
    from curvis_tpu.camera.camera import pixel_rays_world
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    rays = pl.PlanarRays(*(a.astype(jnp.float32) for a in rays))
    kw = dict(dt=0.02, max_steps=40_000, escape_radius=60.0)
    a = pl.march_planar_while(metric, rays, **kw)
    b = march_planar_pallas(metric, rays, **kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(b.sign))
    escaped = np.asarray(a.sign) == 1
    d = np.abs(np.asarray(a.psi) - np.asarray(b.psi))[escaped]
    assert d.max() < 1e-3


def test_fused_kernel_schwarzschild_interpret(rng):
    """render_planar_fused's Schwarzschild path through the fused kernel
    (interpret mode; lapse spawn/readout + capture) vs the SoA fast path on
    the XLA march; differences confined to the shadow-edge chaos band."""
    from curvis_tpu.render.fast import render_planar_fast
    from curvis_tpu.render.fast import render_planar_fused
    metric = SchwarzschildMetric(m=jnp.asarray(1.0, jnp.float32))
    cam = cv.make_camera([0.0, 28.0, np.pi / 2 - 0.2, 0.0],
                         [-1.0, 0.0, -0.2], [0.0, 0.0, 1.0], 30.0, 43.0,
                         24, 12, dtype=jnp.float32)
    bgp = cv.make_spherical_image(rng.random((32, 64, 3)).astype("float32"))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0)
    a = np.asarray(render_planar_fast(metric, cam, bgp, bgp,
                                      backend="tiled", **kw))
    b = np.asarray(render_planar_fused(metric, cam, bgp, bgp,
                                       backend="pallas", **kw))
    d = np.abs(a - b).max(-1)
    assert (d > 1e-6).mean() < 0.05
