"""Kerr volumetric starlight scattering (round 5): the in-gas
single-scattering source in the Boyer-Lindquist family — the BL twin of
the planar scatter term (tests/test_starlight_scatter.py), riding the
Kerr kernels' scalar row at KERR_SCATTER_OFF.

Regression anchor: before round 5's late session, ``DiskParams(
volumetric=True, starlight=True)`` SILENTLY ignored starlight for Kerr
(the planar family scattered, the BL family didn't) — pinned here by the
on-vs-off test.

Closed-form oracle (identical to the planar one): source and absorption
share the density, so for a uniform sky L the scattered channel
integrates to I_sc_c = (kappa_s albedo_c L / kappa)(1 - e^-tau_final).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.metrics.kerr import KerrMetric
from curvis_tpu.render.disk import DiskParams
from curvis_tpu.render.kerr import march_kerr_volumetric, render_kerr
from curvis_tpu.render.starlight import (StarlightMap,
                                         starlight_scatter_block)

_DISK = DiskParams(r_inner=3.0, r_outer=9.0, volumetric=True, h_rel=0.12,
                   kappa=2.0, tau_max=30.0, redshift=False, doppler=False,
                   albedo=(0.5, 0.3, 0.2), starlight_scatter=0.7,
                   tint=(1.0, 0.7, 0.4))
_KERR = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.7))


def _bundle(n=48, seed=3):
    """Inward BL rays from r=18 at varied inclinations/impact params."""
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(seed)
    th0 = np.pi / 2 - 0.25 + 0.5 * rng.random(n)
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 18.0), th0,
                               rng.random(n) * 2 * np.pi], -1))
    dirs = np.stack([-np.ones(n), 0.35 * (rng.random(n) - 0.5),
                     0.35 * (rng.random(n) - 0.5)], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    p0 = ham.spawn_photon(_KERR, x0, jnp.asarray(dirs))
    return x0, p0


def _uniform_block(L, dtype=jnp.float64):
    n_r = 10
    smap = StarlightMap(jnp.linspace(_DISK.r_inner, _DISK.r_outer, n_r),
                        jnp.full((2, n_r, 8, 3), L))
    return starlight_scatter_block(smap, _DISK, dtype)


_KW = dict(dt=0.05, max_steps=3000, escape_radius=20.0)


def test_uniform_sky_closed_form_kerr():
    x0, p0 = _bundle()
    L = 0.6
    blk = _uniform_block(L)
    x_a, p_a, s_a, tau0, em_off = march_kerr_volumetric(
        _KERR, x0, p0, params=_DISK, **_KW)
    x_b, p_b, s_b, tau1, em_on = march_kerr_volumetric(
        _KERR, x0, p0, params=_DISK, scatter_block=blk, **_KW)
    # scattering is a pure source: the march itself is untouched
    np.testing.assert_array_equal(np.asarray(tau0), np.asarray(tau1))
    np.testing.assert_array_equal(np.asarray(s_a), np.asarray(s_b))
    ks = _DISK.starlight_scatter * _DISK.kappa

    def errs(c):
        expect = (ks * _DISK.albedo[c] * L
                  * (1.0 - np.exp(-np.asarray(tau0))) / _DISK.kappa)
        sc = np.asarray(em_on[c]) - _DISK.tint[c] * np.asarray(em_off[0])
        return np.abs(sc - expect) / np.maximum(np.abs(expect), 1e-6)

    hit = np.asarray(tau0) > 1e-3
    assert hit.sum() > 10
    for c in range(3):
        assert float(errs(c)[hit].max()) < 0.05


@pytest.mark.parametrize("stepper", ["rk4", "rk45"])
def test_twin_matches_kernel_kerr(stepper):
    x0, p0 = _bundle(n=32)
    blk = _uniform_block(0.6)
    if stepper == "rk4":
        from curvis_tpu.ops.march_pallas import march_kerr_pallas
        _, _, s_t, tau_t, em_t = march_kerr_volumetric(
            _KERR, x0, p0, params=_DISK, scatter_block=blk, **_KW)
        _, _, s_k, _, (tau_k, em_k) = march_kerr_pallas(
            _KERR, x0, p0, vol_disk=_DISK, scatter_block=blk, **_KW)
        tol = dict(rtol=1e-6, atol=1e-9)
    else:
        # the rk45 XLA twin with scatter IS the adjoint forward
        from curvis_tpu.integrate.kerr_surface_adjoint import (
            march_kerr_rk45_vol_adjoint)
        from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
        kw = dict(dt0=0.05, max_steps=1500, escape_radius=20.0, rtol=1e-8)
        _, _, s_t, _, tau_t, em_t = march_kerr_rk45_vol_adjoint(
            _KERR, x0, p0, _DISK, scatter_block=blk, backend="xla", **kw)
        _, _, s_k, _, (tau_k, em_k), _ = march_kerr_rk45_pallas(
            _KERR, x0, p0, vol_disk=_DISK, scatter_block=blk, return_iters=True, **kw)
        tol = dict(rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tau_t), np.asarray(tau_k), **tol)
    for c in range(3):
        np.testing.assert_allclose(np.asarray(em_t[c]),
                                   np.asarray(em_k[c]), **tol)
    assert float(np.asarray(em_t[2]).max()) > 1e-4


def _scene():
    yy, xx = np.mgrid[0:16, 0:32]
    sky = np.clip(np.stack([0.4 + 0.3 * np.sin(2 * np.pi * xx / 32),
                            0.3 + 0.3 * (yy / 16),
                            np.full_like(yy, 0.5, dtype=float)], -1), 0, 1)
    bg = cv.make_spherical_image(sky, dtype=jnp.float64)
    th = np.pi / 2 - 0.35
    f = np.array([-np.sin(th), 0.0, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0, 0, 1],
                         30.0, 43.0, 48, 27, dtype=jnp.float64)
    from curvis_tpu.render.starlight import compute_kerr_starlight_map
    smap = compute_kerr_starlight_map(
        _KERR, bg, r_inner=3.0, r_outer=9.0, escape_radius=25.0, dt=0.1,
        max_steps=10000, n_r=8, n_phi=12, n_samples=16, backend="xla")
    return bg, cam, smap


def test_render_kerr_vol_starlight_on_vs_off():
    """The silent-no-op regression: starlight must CHANGE the image."""
    bg, cam, smap = _scene()
    kw = dict(dt=0.1, max_steps=600, escape_radius=20.0, backend="xla")
    d_on = DiskParams(r_inner=3.0, r_outer=9.0, volumetric=True,
                      h_rel=0.12, kappa=2.0, starlight=True)
    d_off = DiskParams(r_inner=3.0, r_outer=9.0, volumetric=True,
                       h_rel=0.12, kappa=2.0)
    i_on = np.asarray(render_kerr(_KERR, cam, bg, disk=d_on,
                                  starlight_map=smap, **kw))
    i_off = np.asarray(render_kerr(_KERR, cam, bg, disk=d_off, **kw))
    assert np.isfinite(i_on).all()
    assert float(np.abs(i_on - i_off).max()) > 1e-3
    # scattering only ADDS light before the final clip
    assert float((i_on - i_off).min()) > -1e-9
    # and a precomputed map is REQUIRED (no silent inline recompute)
    with pytest.raises(ValueError, match="precomputed"):
        render_kerr(_KERR, cam, bg, disk=d_on, **kw)


@pytest.mark.parametrize("stepper", ["rk4", "rk45"])
def test_kerr_scatter_grads_match_fd(stepper, ):
    bg, cam, smap = _scene()
    d_on = DiskParams(r_inner=3.0, r_outer=9.0, volumetric=True,
                      h_rel=0.12, kappa=2.0, starlight=True)

    def loss(kap):
        kw = dict(dt=0.1, max_steps=600, escape_radius=20.0,
                  backend="scan", starlight_map=smap,
                  disk_theta={"kappa": kap})
        if stepper == "rk45":
            kw.update(stepper="rk45", rtol=1e-6, max_steps=300)
        img = render_kerr(_KERR, cam, bg, disk=d_on, **kw)
        return jnp.mean(img)

    kap = jnp.asarray(2.0)
    v, g = jax.value_and_grad(loss)(kap)
    assert np.isfinite(float(v))
    eps = 1e-5
    fd = (float(loss(kap + eps)) - float(loss(kap - eps))) / (2 * eps)
    # FD noise floor: the f64 quadrature through a ~600-step BL march
    # leaves O(1e-5) relative curvature error at this eps
    np.testing.assert_allclose(float(g), fd, rtol=1e-4)
