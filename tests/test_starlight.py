"""Starlight on the disk (render/starlight.py): the symmetry-collapsed
illumination map, the psi-at-crossing recording it shades from, and the
end-to-end render wiring."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.metrics.base import (FlatSphericalMetric,
                                     SchwarzschildMetric)
from curvis_tpu.physics import planar as pl
from curvis_tpu.render.disk import DiskParams, march_planar_disk, \
    render_blackhole_disk
from curvis_tpu.render.starlight import (compute_disk_starlight_map,
                                         hit_phi_side, starlight_lookup)


def _uniform_bg(value=0.5, shape=(8, 16)):
    tex = jnp.full(shape + (3,), value)
    return SphericalImage(texture=tex, rotation=jnp.eye(3))


def _disk_scene(n=96):
    """Inward Schwarzschild fan from r=28 with a tilted orbital plane."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    alpha = jnp.asarray(np.linspace(2.0, 3.0, n))
    l = jnp.full((n,), 28.0)
    rays = pl.PlanarRays(
        l, jnp.zeros((n,)), jnp.cos(alpha),
        jnp.sin(alpha) * metric.r(l) / jnp.sqrt(metric.lapse(l)),
        jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    c1 = jnp.full((n,), -0.25)
    c2 = jnp.full((n,), 0.65)
    return metric, rays, c1, c2


def test_psi_hit_lies_on_crossing_surface():
    """The recorded psi at each crossing satisfies the crossing equation
    c1 cos psi + c2 sin psi = 0 to interpolation accuracy — the invariant
    the world-position reconstruction rests on."""
    metric, rays, c1, c2 = _disk_scene()
    res, h1, h2 = march_planar_disk(
        metric, rays, c1, c2, dt=0.02, max_steps=100_000,
        escape_radius=60.0, r_inner=5.2, r_outer=13.0)
    for h in (h1, h2):
        hit = np.asarray(h[0]) > 0
        if not hit.any():
            continue
        zq = np.asarray(c1) * np.cos(np.asarray(h[2])) \
            + np.asarray(c2) * np.sin(np.asarray(h[2]))
        # linear-in-step interpolation: error O(dpsi^2); second crossings
        # near the hole take the largest dpsi per step (~1e-5 at dt=0.02)
        assert np.abs(zq[hit]).max() < 1e-4
    assert (np.asarray(h1[0]) > 0).any()


def test_hit_side_matches_launch_side():
    """For the FIRST recorded crossing of a wide annulus (so no unrecorded
    crossings precede it) the analytic side equals sign(z at launch)."""
    metric, rays, c1, c2 = _disk_scene()
    # wide annulus: every plane crossing inside the escape sphere records
    res, h1, _ = march_planar_disk(
        metric, rays, c1, c2, dt=0.02, max_steps=100_000,
        escape_radius=60.0, r_inner=0.1, r_outer=59.0)
    hit = np.asarray(h1[0]) > 0
    assert hit.sum() > 10
    e1 = (jnp.ones_like(rays.l), jnp.zeros_like(rays.l),
          jnp.zeros_like(rays.l))
    e2v = (jnp.zeros_like(rays.l), jnp.zeros_like(rays.l),
           jnp.ones_like(rays.l))
    _, side = hit_phi_side(h1[0], h1[2], rays.b, c1, c2, e1, e2v)
    z0 = np.asarray(c1) * np.cos(0.0) + np.asarray(c2) * np.sin(0.0)
    np.testing.assert_array_equal(np.asarray(side)[hit],
                                  np.sign(z0)[hit] * np.ones(hit.sum()))


def test_hit_world_position_flat_space():
    """Flat space: the reconstructed world hit position matches the
    straight-line crossing point analytically."""
    metric = FlatSphericalMetric()
    l0, alpha = 10.0, 2.6
    c1v, c2v = -0.3, 0.8
    rays = pl.PlanarRays(jnp.asarray([l0]), jnp.asarray([0.0]),
                         jnp.asarray([np.cos(alpha)]),
                         jnp.asarray([np.sin(alpha) * l0]),
                         jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    _, h1, _ = march_planar_disk(
        metric, rays, jnp.asarray([c1v]), jnp.asarray([c2v]), dt=0.002,
        max_steps=100_000, escape_radius=60.0, r_inner=0.1, r_outer=60.0)
    # orthonormal world basis with the prescribed z-components
    e1w = np.array([np.sqrt(1 - c1v ** 2), 0.0, c1v])
    f = -c1v * c2v / np.sqrt(1 - c1v ** 2)
    e2w = np.array([f, np.sqrt(1 - c2v ** 2 - f * f), c2v])
    assert abs(e1w @ e2w) < 1e-12
    t_cross = -l0 * c1v / (np.cos(alpha) * c1v + np.sin(alpha) * c2v)
    p_true = l0 * e1w + t_cross * (np.cos(alpha) * e1w + np.sin(alpha) * e2w)
    assert abs(p_true[2]) < 1e-12
    e1 = tuple(jnp.asarray([v]) for v in e1w)
    e2 = tuple(jnp.asarray([v]) for v in e2w)
    phi, _ = hit_phi_side(h1[0], h1[2], rays.b, jnp.asarray([c1v]),
                          jnp.asarray([c2v]), e1, e2)
    r_hit = float(h1[0][0])
    assert r_hit > 0
    p_rec = r_hit * np.array([np.cos(float(phi[0])),
                              np.sin(float(phi[0])), 0.0])
    np.testing.assert_allclose(p_rec[:2], p_true[:2], atol=5e-3)


def test_map_uniform_sky_flat_space_exact():
    """Uniform sky of radiance L in flat space -> map == L on both faces
    everywhere (cosine-weighted estimator normalization is exactly
    mean(L))."""
    smap = compute_disk_starlight_map(
        FlatSphericalMetric(), _uniform_bg(0.37), r_inner=5.0,
        r_outer=12.0, escape_radius=50.0, dt=0.05, max_steps=3000,
        n_r=4, n_phi=6, n_samples=32)
    np.testing.assert_allclose(np.asarray(smap.values), 0.37, rtol=1e-6)


def test_map_hemisphere_sky_separates_faces():
    """Bright upper / dark lower sky in flat space: the +z face integrates
    only the bright hemisphere, the -z face only the dark one — exact,
    because straight cosine-weighted rays from a face never cross the
    plane outward."""
    H, W = 16, 32
    tex = np.zeros((H, W, 3))
    tex[:H // 2] = 1.0                     # v < 0.5 <=> world z > 0
    bg = SphericalImage(texture=jnp.asarray(tex), rotation=jnp.eye(3))
    smap = compute_disk_starlight_map(
        FlatSphericalMetric(), bg, r_inner=5.0, r_outer=12.0,
        escape_radius=50.0, dt=0.05, max_steps=3000, n_r=4, n_phi=6,
        n_samples=64, filtering="nearest")
    v = np.asarray(smap.values)
    np.testing.assert_allclose(v[0], 1.0, atol=1e-12)   # +z face
    np.testing.assert_allclose(v[1], 0.0, atol=1e-12)   # -z face


def test_map_schwarzschild_shadow_dims_inner_radii():
    """Uniform sky around a black hole: capture removes sky from the
    hemisphere, monotonically more so closer in; far out the map
    approaches the sky value."""
    smap = compute_disk_starlight_map(
        SchwarzschildMetric(m=jnp.asarray(1.0)), _uniform_bg(1.0),
        r_inner=4.0, r_outer=24.0, escape_radius=60.0, dt=0.02,
        max_steps=100_000, n_r=8, n_phi=4, n_samples=64, blueshift=False)
    prof = np.asarray(smap.values)[0, :, 0, 0]
    assert prof[0] < 0.85                  # shadowed near the hole
    assert prof[-1] > 0.97                 # ~full sky far out
    assert np.all(np.diff(prof) > -1e-6)   # monotone recovery


def test_map_blueshift_boost():
    """The A^-2 Liouville boost brightens the inner map (and only scales
    with radius)."""
    kw = dict(r_inner=4.0, r_outer=24.0, escape_radius=60.0, dt=0.02,
              max_steps=100_000, n_r=6, n_phi=4, n_samples=32)
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    off = compute_disk_starlight_map(m, _uniform_bg(1.0), blueshift=False,
                                     **kw)
    on = compute_disk_starlight_map(m, _uniform_bg(1.0), blueshift=True,
                                    **kw)
    A = np.asarray(jnp.clip(m.lapse(off.radii), 1e-3, 1.0))
    np.testing.assert_allclose(np.asarray(on.values),
                               np.asarray(off.values)
                               / (A * A)[None, :, None, None], rtol=1e-6)


def test_map_self_shadow_attenuates():
    """An opaque annulus between the launch radii and part of the sky
    strictly dims the map vs the unshadowed one, and never brightens it."""
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    shadow = DiskParams(r_inner=4.0, r_outer=24.0, opacity=0.95,
                        brightness=5.0)
    kw = dict(r_inner=4.0, r_outer=24.0, escape_radius=60.0, dt=0.02,
              max_steps=100_000, n_r=6, n_phi=4, n_samples=64,
              blueshift=False)
    clear = compute_disk_starlight_map(m, _uniform_bg(1.0),
                                       shadow_params=None, **kw)
    dark = compute_disk_starlight_map(m, _uniform_bg(1.0),
                                      shadow_params=shadow, **kw)
    c, d = np.asarray(clear.values), np.asarray(dark.values)
    assert (d <= c + 1e-12).all()
    assert d.sum() < 0.995 * c.sum()


def test_map_wormhole_two_universes():
    """Disk around an Ellis throat: secondary rays that dive through the
    throat fetch the NEGATIVE universe's sky.  With sky(+)=1, sky(-)=0 the
    map sits strictly between, dimmer near the throat (larger solid angle
    leads through); with both skies = 1 it is exactly 1 (no capture in a
    wormhole — every secondary ray escapes somewhere)."""
    from curvis_tpu.metrics.base import EllisMetric
    m = EllisMetric(rho=jnp.asarray(1.0))
    kw = dict(r_inner=2.0, r_outer=10.0, escape_radius=40.0, dt=0.05,
              max_steps=20_000, n_r=6, n_phi=4, n_samples=64)
    both = compute_disk_starlight_map(m, _uniform_bg(1.0), _uniform_bg(1.0),
                                      **kw)
    np.testing.assert_allclose(np.asarray(both.values), 1.0, rtol=1e-6)
    split = compute_disk_starlight_map(m, _uniform_bg(1.0),
                                       _uniform_bg(0.0), **kw)
    prof = np.asarray(split.values)[0, :, 0, 0]
    assert 0.3 < prof[0] < 1.0                 # throat leaks to the dark side
    assert prof[0] < prof[-1] <= 1.0 + 1e-9    # more leakage closer in


def test_starlight_lookup_bilinear_and_wrap():
    """Lookup interpolates the radial axis and wraps the phi axis."""
    n_r, n_phi = 4, 8
    vals = np.zeros((2, n_r, n_phi, 3))
    vals[0, :, :, 0] = np.linspace(1.0, 4.0, n_r)[:, None]   # radial ramp
    vals[1, :, :, 1] = 7.0
    smap_vals = jnp.asarray(vals)
    from curvis_tpu.render.starlight import StarlightMap
    smap = StarlightMap(radii=jnp.linspace(5.0, 11.0, n_r),
                        values=smap_vals)
    r = jnp.asarray([5.0, 8.0, 11.0, 6.0])
    phi = jnp.asarray([0.0, 0.1, -0.1, 2 * np.pi - 1e-6])
    side = jnp.asarray([1.0, 1.0, 1.0, -1.0])
    out = np.asarray(starlight_lookup(smap, r, phi, side))
    np.testing.assert_allclose(out[0, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(out[1, 0], 2.5, atol=1e-6)    # midpoint
    np.testing.assert_allclose(out[2, 0], 4.0, atol=1e-6)
    np.testing.assert_allclose(out[3], [0.0, 7.0, 0.0], atol=1e-6)
    # phi wrap: phi and phi + 2 pi read the same texel
    a = np.asarray(starlight_lookup(smap, r[:1], jnp.asarray([1.3]),
                                    side[:1]))
    b = np.asarray(starlight_lookup(smap, r[:1],
                                    jnp.asarray([1.3 + 2 * np.pi]),
                                    side[:1]))
    np.testing.assert_allclose(a, b, atol=1e-6)


def _cam(width=32, height=18):
    th = np.pi / 2 - 0.3
    return cv.make_camera([0.0, 28.0, th, 0.0],
                          [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                          30.0, 43.0, width, height, dtype=jnp.float64)


def _sky(seed=0):
    rng = np.random.default_rng(seed)
    tex = jnp.asarray(rng.uniform(0.2, 0.8, (16, 32, 3)))
    return SphericalImage(texture=tex, rotation=jnp.eye(3))


def test_render_starlight_only_brightens_disk_pixels():
    """starlight=True changes only pixels whose ray crosses the disk, and
    with a gray sky + gray albedo it only ADDS light there."""
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    base = DiskParams(r_inner=5.2, r_outer=13.0, brightness=0.3)
    star = DiskParams(r_inner=5.2, r_outer=13.0, brightness=0.3,
                      starlight=True, albedo=(0.6, 0.6, 0.6),
                      starlight_samples=32, starlight_grid=(12, 16))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0,
              backend="while")
    bg = _sky()
    img0 = np.asarray(render_blackhole_disk(m, _cam(), bg, disk=base, **kw))
    img1 = np.asarray(render_blackhole_disk(m, _cam(), bg, disk=star, **kw))
    d = img1 - img0
    changed = np.abs(d).max(axis=-1) > 1e-9
    assert changed.any()
    assert (d >= -1e-9).all()              # additive only (pre-clip range)
    assert np.isfinite(img1).all()


def test_render_starlight_backend_parity():
    """while vs pallas(interpret) with starlight on: same images to f64
    interpret tolerance."""
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    star = DiskParams(r_inner=5.2, r_outer=13.0, brightness=0.3,
                      starlight=True, albedo=(0.5, 0.5, 0.5),
                      starlight_samples=32, starlight_grid=(10, 12))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0)
    bg = _sky(1)
    a = np.asarray(render_blackhole_disk(m, _cam(24, 12), bg, disk=star,
                                         backend="while", **kw))
    b = np.asarray(render_blackhole_disk(m, _cam(24, 12), bg, disk=star,
                                         backend="pallas",
                                         **kw))
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_render_starlight_rk45_stepper():
    """The rk45 stepper records psi too — starlight composes with
    error-controlled marching end to end."""
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    star = DiskParams(r_inner=5.2, r_outer=13.0, brightness=0.3,
                      starlight=True, albedo=(0.5, 0.5, 0.5),
                      starlight_samples=16, starlight_grid=(8, 8))
    img = np.asarray(render_blackhole_disk(
        m, _cam(24, 12), _sky(2), disk=star, stepper="rk45", rtol=1e-6,
        dt=0.05, max_steps=4_000, escape_radius=60.0, backend="while"))
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_precomputed_map_matches_inline():
    """render(starlight_map=precomputed) matches the inline recompute to
    fusion-reassociation ulps — the video amortization path changes cost,
    not pixels."""
    from curvis_tpu.render.disk import compute_starlight_map
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    star = DiskParams(r_inner=5.2, r_outer=13.0, brightness=0.3,
                      starlight=True, albedo=(0.5, 0.5, 0.5),
                      starlight_samples=32, starlight_grid=(10, 12))
    kw = dict(dt=0.05, max_steps=20_000, escape_radius=60.0,
              backend="while")
    bg = _sky(4)
    smap = compute_starlight_map(m, bg, star, **kw)
    a = np.asarray(render_blackhole_disk(m, _cam(24, 12), bg, disk=star,
                                         **kw))
    b = np.asarray(render_blackhole_disk(m, _cam(24, 12), bg, disk=star,
                                         starlight_map=smap, **kw))
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_render_starlight_volumetric_now_supported():
    """Round 5: volumetric + starlight is the in-gas scattering source
    (tests/test_starlight_scatter.py).  The DIFFERENTIABLE combination
    works too (late session — the scatter block rides the adjoint theta,
    tests/test_starlight_grad.py) but requires a PRECOMPUTED map: tracing
    through the map's own construction would reverse through its
    while-loop marches, so a clear ValueError asks for starlight_map=."""
    m = SchwarzschildMetric(m=jnp.asarray(1.0))
    combo = DiskParams(volumetric=True, starlight=True,
                       starlight_grid=(6, 8), starlight_samples=16)
    img = render_blackhole_disk(m, _cam(8, 4), _sky(), disk=combo,
                                backend="while", dt=0.05, max_steps=100,
                                escape_radius=60.0)
    assert np.isfinite(np.asarray(img)).all()
    with pytest.raises(ValueError, match="precomputed"):
        render_blackhole_disk(m, _cam(8, 4), _sky(), disk=combo,
                              backend="while", dt=0.05, max_steps=100,
                              escape_radius=60.0, differentiable="scan")
    from curvis_tpu.render.starlight import compute_disk_starlight_map
    smap = compute_disk_starlight_map(m, _sky(), r_inner=combo.r_inner,
                                      r_outer=combo.r_outer,
                                      escape_radius=60.0, dt=0.1,
                                      max_steps=4000, n_r=6, n_phi=8,
                                      n_samples=16)
    img2 = render_blackhole_disk(m, _cam(8, 4), _sky(), disk=combo,
                                 backend="while", dt=0.05, max_steps=100,
                                 escape_radius=60.0, starlight_map=smap,
                                 differentiable="scan")
    assert np.isfinite(np.asarray(img2)).all()
