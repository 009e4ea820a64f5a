"""Differentiable disk & volumetric Kerr rendering
(integrate/kerr_surface_adjoint.py — VERDICT round-4 #1).

The checkpointed-recompute adjoint extended with crossing-tracker and
radiative-transfer carries: gradients through THIN-DISK and VOLUMETRIC
images for both steppers, including captured rays' hits (the
disk-in-front-of-shadow signal) and the disk parameters themselves.

FD traps (NEXT.md): march-level sum losses use eps = 1e-6 (flip-free on
these bundles, f64); render-level mean losses use eps = 1e-7 and the
documented tolerances (boundary terms from the discrete in-band gate are
~3e-3 on the thin rk4 spin knob; everything smooth is < 1e-4).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.integrate.kerr_surface_adjoint import (
    build_vol_row, march_kerr_disk_adjoint, march_kerr_rk45_disk_adjoint,
    march_kerr_rk45_vol_adjoint, march_kerr_vol_adjoint)
from curvis_tpu.metrics.kerr import KerrMetric
from curvis_tpu.physics import hamiltonian as ham
from curvis_tpu.render.disk import DiskParams
from curvis_tpu.render.kerr import render_kerr

_KW = dict(dt=0.1, max_steps=1500, escape_radius=25.0)
_KW45 = dict(dt0=0.1, max_steps=400, escape_radius=25.0, rtol=1e-9,
             atol=1e-12, dt_min=1e-7)
_VDISK = DiskParams(r_inner=3.0, r_outer=12.0, volumetric=True, h_rel=0.1,
                    kappa=2.0, tau_max=8.0)


def _bundle(n=48, seed=5):
    """Inclined fan aimed at the hole: ~10% of rays capture AFTER crossing
    the disk band — the inclusion-policy test case."""
    rng = np.random.default_rng(seed)
    th0 = np.pi / 2 - 0.5
    pos = jnp.asarray(np.stack([np.zeros(n), np.full(n, 18.0),
                                np.full(n, th0), np.zeros(n)], -1))
    dirs = np.stack([-np.ones(n), 0.25 * rng.standard_normal(n),
                     -0.25 - 0.4 * rng.random(n)], -1)
    return pos, jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1,
                                                  keepdims=True))


def _fd(f, args, i, eps):
    ap = list(args)
    am = list(args)
    ap[i] = ap[i] + eps
    am[i] = am[i] - eps
    return (float(f(*ap)) - float(f(*am))) / (2 * eps)


# ---------------------------------------------------------------------------
# fixed-step thin disk
# ---------------------------------------------------------------------------

def test_disk_forward_matches_production_twin():
    pos, dirs = _bundle()
    metric = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.7))
    p0 = ham.spawn_photon(metric, pos, dirs)
    from curvis_tpu.render.kerr import march_kerr_disk
    x, p, sign, steps, (h1, h2) = march_kerr_disk_adjoint(
        metric, pos, p0, r_inner=2.0, r_outer=12.0, backend="xla", **_KW)
    xr, pr, sr, (h1r, h2r) = march_kerr_disk(metric, pos, p0, r_inner=2.0,
                                             r_outer=12.0, **_KW)
    np.testing.assert_array_equal(np.asarray(sign), np.asarray(sr))
    for c in range(3):
        np.testing.assert_allclose(np.asarray(h1[c]), np.asarray(h1r[c]),
                                   atol=1e-9)
    s = np.asarray(sign)
    hit = np.asarray(h1[0]) > 0
    assert (hit & (s == 2)).sum() >= 3, "need captured rays with disk hits"


def _disk_loss(m, a, pos, dirs, backend, rk45=False):
    met = KerrMetric(m=m, a=a)
    p0 = ham.spawn_photon(met, pos, dirs)
    if rk45:
        _, _, sg, _, (H1, H2) = march_kerr_rk45_disk_adjoint(
            met, pos, p0, r_inner=2.0, r_outer=12.0, backend=backend,
            **_KW45)
    else:
        _, _, sg, _, (H1, H2) = march_kerr_disk_adjoint(
            met, pos, p0, r_inner=2.0, r_outer=12.0, backend=backend, **_KW)
    w = jnp.where(H1[0] > 0, 1.0, 0.0)    # captured rays' hits included
    return jnp.sum(w * jnp.sin(H1[0]) * jnp.cos(H1[1]))


@pytest.mark.parametrize("rk45", [False, True])
def test_disk_grad_matches_fd(rk45):
    pos, dirs = _bundle()
    m0, a0 = jnp.asarray(1.0), jnp.asarray(0.7)
    f = jax.jit(partial(_disk_loss, pos=pos, dirs=dirs, backend="xla",
                        rk45=rk45))
    g = jax.jit(jax.grad(f, argnums=(0, 1)))(m0, a0)
    # rk45's exact-controller gradient agrees with FD at the documented
    # ~6e-5 level (integrate/rk45_adjoint.py); fixed-step is exact
    tol = 2e-4 if rk45 else 1e-6
    for i in (0, 1):
        fd = _fd(f, (m0, a0), i, 1e-6)
        assert abs(float(g[i]) - fd) / max(abs(fd), 1e-12) < tol, \
            (i, float(g[i]), fd)


@pytest.mark.parametrize("rk45", [False, True])
def test_disk_pallas_pair_matches_xla_pair(rk45):
    pos, dirs = _bundle()
    m0, a0 = jnp.asarray(1.0), jnp.asarray(0.7)
    gx = jax.grad(lambda a: _disk_loss(m0, a, pos, dirs, "xla", rk45))(a0)
    gp = jax.grad(lambda a: _disk_loss(m0, a, pos, dirs,
                                       "pallas", rk45))(a0)
    assert abs(float(gx) - float(gp)) / max(abs(float(gx)), 1e-12) < 1e-7


def test_captured_rays_carry_hit_gradient():
    """A loss reading ONLY captured rays' first hits must still produce an
    FD-matching gradient — the widened fate policy this module exists for."""
    pos, dirs = _bundle()
    m0, a0 = jnp.asarray(1.0), jnp.asarray(0.7)

    def loss(a):
        met = KerrMetric(m=m0, a=a)
        p0 = ham.spawn_photon(met, pos, dirs)
        _, _, sg, _, (H1, _h2) = march_kerr_disk_adjoint(
            met, pos, p0, r_inner=2.0, r_outer=12.0, backend="xla", **_KW)
        w = jnp.where((H1[0] > 0) & (sg == 2), 1.0, 0.0)
        return jnp.sum(w * jnp.sin(H1[0]))

    g = float(jax.jit(jax.grad(loss))(a0))
    fd = _fd(jax.jit(loss), (a0,), 0, 1e-6)
    assert abs(fd) > 1e-6, "config must have captured rays with hits"
    assert abs(g - fd) / abs(fd) < 1e-6, (g, fd)


# ---------------------------------------------------------------------------
# volumetric
# ---------------------------------------------------------------------------

def test_vol_forward_matches_production_twin():
    pos, dirs = _bundle()
    metric = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.7))
    p0 = ham.spawn_photon(metric, pos, dirs)
    from curvis_tpu.render.kerr import march_kerr_volumetric
    x, p, sign, steps, tau, em = march_kerr_vol_adjoint(
        metric, pos, p0, _VDISK, backend="xla", **_KW)
    xr, pr, sr, taur, emr = march_kerr_volumetric(metric, pos, p0,
                                                  params=_VDISK, **_KW)
    np.testing.assert_array_equal(np.asarray(sign), np.asarray(sr))
    np.testing.assert_allclose(np.asarray(tau), np.asarray(taur), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(em[0]), np.asarray(emr[0]),
                               rtol=1e-9)


def _vol_loss(m, a, kappa, r_in, h_rel, pos, dirs, backend, rk45=False):
    met = KerrMetric(m=m, a=a)
    p0 = ham.spawn_photon(met, pos, dirs)
    dth = {"kappa": kappa, "r_inner": r_in, "h_rel": h_rel}
    march = march_kerr_rk45_vol_adjoint if rk45 else march_kerr_vol_adjoint
    kw = _KW45 if rk45 else _KW
    _, _, sg, _, tt, ee = march(met, pos, p0, _VDISK, backend=backend,
                                disk_theta=dth, **kw)
    return jnp.sum(ee[0] + 0.5 * ee[1]) + jnp.sum(jnp.exp(-tt))


@pytest.mark.parametrize("rk45", [False, True])
def test_vol_grad_matches_fd(rk45):
    """Gradients flow to (m, a) AND the disk parameters (kappa, r_inner,
    h_rel) through the in-march radiative-transfer quadrature."""
    pos, dirs = _bundle()
    args = [jnp.asarray(v) for v in (1.0, 0.7, 2.0, 3.0, 0.1)]
    f = jax.jit(partial(_vol_loss, pos=pos, dirs=dirs, backend="xla",
                        rk45=rk45))
    g = jax.jit(jax.grad(f, argnums=tuple(range(5))))(*args)
    tol = 2e-4 if rk45 else 1e-6
    for i in range(5):
        fd = _fd(f, args, i, 1e-6)
        assert abs(float(g[i]) - fd) / max(abs(fd), 1e-9) < tol, \
            (i, float(g[i]), fd)


@pytest.mark.parametrize("rk45", [False, True])
def test_vol_pallas_pair_matches_xla_pair(rk45):
    pos, dirs = _bundle()
    args = [jnp.asarray(v) for v in (1.0, 0.7, 2.0, 3.0, 0.1)]
    gx = jax.grad(lambda k: _vol_loss(args[0], args[1], k, args[3],
                                      args[4], pos, dirs, "xla", rk45)
                  )(args[2])
    gp = jax.grad(lambda k: _vol_loss(args[0], args[1], k, args[3],
                                      args[4], pos, dirs,
                                      "pallas", rk45))(args[2])
    assert abs(float(gx) - float(gp)) / max(abs(float(gx)), 1e-12) < 1e-7


def test_build_vol_row_validates_keys():
    with pytest.raises(ValueError, match="disk_theta"):
        build_vol_row(_VDISK, {"volumetric": True})
    # shading-only keys are accepted (consumed by DiskView, not the row)
    row = build_vol_row(_VDISK, {"brightness": jnp.asarray(2.0)})
    assert row.shape == (10,)


# ---------------------------------------------------------------------------
# render-level: the full image pipeline is differentiable
# ---------------------------------------------------------------------------

def _scene():
    w, h = 48, 27
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.4
    fwd = np.array([-np.sin(th), 0.0, -np.cos(th)])
    fwd /= np.linalg.norm(fwd)
    cam = cv.make_camera([0.0, 18.0, th, 0.0], list(fwd), [0.0, 0.0, 1.0],
                         30.0, 43.0, w, h, dtype=jnp.float64)
    return cam, bg


@pytest.mark.parametrize("stepper,vol", [("rk4", False), ("rk4", True),
                                         ("rk45", False), ("rk45", True)])
def test_render_kerr_disk_grads_match_fd(stepper, vol):
    """render_kerr(disk=..., backend='scan') image gradients vs FD for the
    spin AND a traced shading knob, thin + volumetric, both steppers —
    the guard this replaces raised NotImplementedError through round 4."""
    cam, bg = _scene()
    d = _VDISK if vol else DiskParams(r_inner=3.0, r_outer=12.0)

    def loss(a, br):
        m = KerrMetric(m=jnp.asarray(1.0), a=a)
        img = render_kerr(m, cam, bg, dt=0.15,
                          max_steps=300 if stepper == "rk45" else 3000,
                          escape_radius=25.0, disk=d, backend="scan",
                          stepper=stepper, rtol=1e-6,
                          disk_theta={"brightness": br})
        return jnp.mean(img)

    a0, b0 = jnp.asarray(0.7), jnp.asarray(1.0)
    f = jax.jit(loss)
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(a0, b0)
    fd_a = _fd(f, (a0, b0), 0, 1e-7)
    fd_b = _fd(f, (a0, b0), 1, 1e-7)
    # the thin disk's in-band gate contributes a small boundary term to the
    # fixed-step spin FD (measured 3.4e-3); smooth channels are < 1e-4
    tol_a = 1e-2 if (stepper == "rk4" and not vol) else 1e-3
    assert abs(float(g[0]) - fd_a) / max(abs(fd_a), 1e-12) < tol_a, \
        (float(g[0]), fd_a)
    assert abs(float(g[1]) - fd_b) / max(abs(fd_b), 1e-12) < 1e-6, \
        (float(g[1]), fd_b)
