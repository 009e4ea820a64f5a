"""Differentiable error-controlled PLANAR marching
(integrate/rk45_adjoint_planar.py): the planar twin of the Kerr rk45
adjoint, completing the stepper x gradient matrix for the reference's own
metric family.

Reference context: /root/reference has neither adaptive stepping nor
gradients; its rigid recurrence (src/metrics.rs:283-297) is the map both
upgrades generalize — these tests pin that they compose for the planar
system too.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.integrate.rk45 import march_planar_rk45
from curvis_tpu.integrate.rk45_adjoint_planar import (
    _forward_xla_planar_rk45, _planar_rk45_step, _theta_of,
    march_planar_rk45_adjoint)
from curvis_tpu.metrics.base import EllisMetric, SchwarzschildMetric
from curvis_tpu.ops.march_pallas import _NO_CAPTURE, _metric_kind_and_params
from curvis_tpu.physics import planar as pl


def _bundle(metric, n_x=12, n_y=6, r0=5.0, aim=(-1.0, 0.25, 0.1)):
    cam = cv.make_camera([0.0, r0, np.pi / 2, 0.0], list(aim),
                         [0.0, 0.0, 1.0], 15.0, 43.0, n_x, n_y,
                         dtype=jnp.float64)
    return pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))


_KW = dict(dt0=0.05, max_steps=400, escape_radius=25.0, rtol=1e-9,
           atol=1e-12)


def _loss(metric, rays, backend, **extra):
    l, psi, p_l, sign, _ = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, backend=backend,
        **_KW, **extra)
    esc = (sign == 1) | (sign == -1)
    return jnp.mean(jnp.where(esc, jnp.sin(psi) + 0.3 * p_l * l / 25.0, 0.0))


def test_replay_reproduces_forward_bitwise():
    """The masked scan replay (what the backward differentiates) must BE
    the lock-step forward trajectory — the exactness invariant the whole
    checkpointed-recompute design rests on."""
    from curvis_tpu.integrate.ckpt import march_masked
    metric = EllisMetric(rho=jnp.asarray(1.0))
    rays = _bundle(metric)
    cs = (1e-9, 1e-12, 1e-6, 10.0, 25.0, _NO_CAPTURE)
    kind, row = _metric_kind_and_params(metric, 0.05, 25.0, rays.l.dtype)
    theta = _theta_of(kind, row, rays.b)
    (l, psi, p_l, sign, steps), iters = _forward_xla_planar_rk45(
        kind, cs, theta, (rays.l, rays.psi, rays.p_l), 0.05, 400, 1600)
    y0 = (rays.l, rays.psi, rays.p_l, jnp.full_like(rays.l, 0.05))
    y = march_masked(partial(_planar_rk45_step, kind, cs), theta, y0, iters,
                     max_steps=1600, segment=40)
    np.testing.assert_array_equal(np.asarray(y[0]), np.asarray(l))
    np.testing.assert_array_equal(np.asarray(y[1]), np.asarray(psi))
    np.testing.assert_array_equal(np.asarray(y[2]), np.asarray(p_l))


def test_forward_value_matches_rk45_twin_semantics():
    """The adjoint's lock-step forward and integrate/rk45.march_planar_rk45
    implement the same controller on algebraically-identical RHS forms —
    escape fates must agree exactly and escape states to integrator ulps."""
    metric = EllisMetric(rho=jnp.asarray(1.0))
    rays = _bundle(metric)
    l, psi, p_l, sign, steps = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, backend="xla", **_KW)
    res = march_planar_rk45(metric, rays, escape_radius=_KW["escape_radius"],
                            max_steps=_KW["max_steps"], rtol=_KW["rtol"],
                            atol=_KW["atol"], dt0=_KW["dt0"])
    assert (np.asarray(sign) == np.asarray(res.sign)).all()
    esc = np.asarray(sign) != 0
    assert esc.any()
    np.testing.assert_allclose(np.asarray(psi)[esc],
                               np.asarray(res.psi)[esc], atol=1e-7)
    # escape interpolation lands exactly on |l| = R in both
    np.testing.assert_allclose(np.abs(np.asarray(l)[esc]), 25.0, rtol=1e-12)


def test_pallas_forward_matches_xla_forward():
    """backend='pallas' marches the production kernel (interpret); the XLA
    twin was built op-for-op on the kernel's iteration — states must agree
    to ulps and fates exactly (the backward replays the XLA map over the
    KERNEL's iteration counts, so this parity is load-bearing)."""
    metric = EllisMetric(rho=jnp.asarray(1.0))
    rays = _bundle(metric)
    ox = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, backend="xla", **_KW)
    op = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b,
        backend="pallas", **_KW)
    np.testing.assert_array_equal(np.asarray(ox[3]), np.asarray(op[3]))
    np.testing.assert_array_equal(np.asarray(ox[4]), np.asarray(op[4]))
    np.testing.assert_allclose(np.asarray(ox[0]), np.asarray(op[0]),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(ox[1]), np.asarray(op[1]),
                               atol=1e-12)


def test_grad_rho_matches_fd():
    rays = _bundle(EllisMetric(rho=jnp.asarray(1.0)))

    def f(rho):
        return _loss(EllisMetric(rho=rho), rays, "xla")

    g = float(jax.jit(jax.grad(f))(jnp.asarray(1.0)))
    eps = 1e-6
    fd = (float(jax.jit(f)(jnp.asarray(1.0 + eps)))
          - float(jax.jit(f)(jnp.asarray(1.0 - eps)))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-3, (g, fd)


def test_grad_mass_matches_fd_with_captured_rays():
    """Schwarzschild: the bundle includes captured rays (zero cotangent,
    zeroed replay); escaping rays carry exact gradients."""
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    rays = _bundle(metric, aim=(-1.0, 0.45, 0.0))

    def f(m):
        return _loss(SchwarzschildMetric(m=m), rays, "xla")

    # the bundle must actually exercise the capture branch
    _, _, _, sign, _ = march_planar_rk45_adjoint(
        metric, (rays.l, rays.psi, rays.p_l), rays.b, backend="xla", **_KW)
    assert (np.asarray(sign) == 2).any()
    assert (np.asarray(sign) == 1).any()

    g = float(jax.jit(jax.grad(f))(jnp.asarray(1.0)))
    # m is a strong knob: accept decisions flip INSIDE the FD interval even
    # when the +-eps endpoints agree, injecting O(rtol * state) jumps into
    # f — measured FD noise floor ~1e-10 abs (0.2-0.8% of this gradient),
    # shrinking with rtol (1e-11 -> 9e-4 rel).  Same trap as the Kerr mass
    # test; tolerance sized to the measured noise, not the adjoint.
    eps = 1e-5
    fd = (float(jax.jit(f)(jnp.asarray(1.0 + eps)))
          - float(jax.jit(f)(jnp.asarray(1.0 - eps)))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-2, (g, fd)


def test_pallas_pair_matches_xla_pair():
    """Pallas(interpret) checkpoint kernel pair vs the XLA checkpointed
    scan — same frozen map, so gradients agree to summation-order ulps."""
    rays = _bundle(EllisMetric(rho=jnp.asarray(1.0)))
    gx = float(jax.jit(jax.grad(
        lambda r: _loss(EllisMetric(rho=r), rays, "xla")))(jnp.asarray(1.0)))
    gp = float(jax.jit(jax.grad(
        lambda r: _loss(EllisMetric(rho=r), rays, "pallas")))
        (jnp.asarray(1.0)))
    assert abs(gp - gx) / max(abs(gx), 1e-12) < 1e-6, (gp, gx)


def test_state_and_b_gradients_flow():
    metric = EllisMetric(rho=jnp.asarray(1.0))
    rays = _bundle(metric)

    def f(b):
        l, psi, p_l, sign, _ = march_planar_rk45_adjoint(
            metric, (rays.l, rays.psi, rays.p_l), b, backend="xla", **_KW)
        esc = sign != 0
        return jnp.sum(jnp.where(esc, psi, 0.0))

    g = jax.jit(jax.grad(f))(rays.b)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.max(jnp.abs(g))) > 0.0
    i = int(np.argmax(np.abs(np.asarray(g))))
    eps = 1e-7
    bp = rays.b.at[i].add(eps)
    bm = rays.b.at[i].add(-eps)
    fd = (float(jax.jit(f)(bp)) - float(jax.jit(f)(bm))) / (2 * eps)
    assert abs(float(g[i]) - fd) / abs(fd) < 1e-3, (float(g[i]), fd)


def test_table_shape_gradient_matches_fd():
    """d image / d shape-of-r(l) THROUGH the error-controlled march: the
    differentiable-tabulation capability (metrics/table.py) composed with
    rk45 — gradients reach the Chebyshev coefficients of a user metric."""
    import dataclasses

    from curvis_tpu.metrics.table import tabulate_metric
    tab, _ = tabulate_metric(EllisMetric(rho=jnp.asarray(1.0)), degree=10,
                             dtype=jnp.float64)
    rays = _bundle(tab)

    def f(c1):
        return _loss(dataclasses.replace(tab, c1=c1), rays, "xla")

    g = jax.jit(jax.grad(f))(tab.c1)
    assert np.isfinite(np.asarray(g)).all()
    k = int(np.argmax(np.abs(np.asarray(g))))
    eps = 1e-6
    fd = (float(jax.jit(f)(tab.c1.at[k].add(eps)))
          - float(jax.jit(f)(tab.c1.at[k].add(-eps)))) / (2 * eps)
    assert abs(float(g[k]) - fd) / abs(fd) < 1e-3, (float(g[k]), fd)


def test_render_direct_rk45_adjoint():
    """render_direct(differentiable='adjoint', stepper='rk45'): the full
    planar render pipeline is differentiable through the error-controlled
    march (mirrors the Kerr-side test_render_kerr_rk45_adjoint_backend)."""
    from curvis_tpu.render.direct import render_direct
    rng = np.random.default_rng(0)
    w, h = 16, 8
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(np.asarray(smooth))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.25, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, w, h,
                         dtype=jnp.float64)

    def loss(rho):
        img = render_direct(EllisMetric(rho=rho), cam, bg, bg, dt=0.05,
                            max_steps=400, escape_radius=25.0,
                            stepper="rk45", differentiable="adjoint",
                            filtering="bilinear")
        return jnp.mean(img)

    v, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(1.0))
    assert np.isfinite(float(v)) and np.isfinite(float(g))
    assert float(g) != 0.0
    eps = 1e-5
    fl = jax.jit(loss)
    fd = (float(fl(jnp.asarray(1.0 + eps)))
          - float(fl(jnp.asarray(1.0 - eps)))) / (2 * eps)
    assert np.sign(fd) == np.sign(float(g))
    assert abs(float(g) - fd) / max(abs(fd), 1e-12) < 0.3


def test_freeze_controller_mode_runs_and_differs():
    """freeze_controller=True treats step sizes as data but keeps the
    escape interpolation differentiable; unlike the Kerr family (landing
    overshoot) the planar escape state is exactly on |l| = R, so both modes
    are consistent estimators — they differ only through the dt-chain
    sensitivity, which is small but nonzero on a generic loss."""
    rays = _bundle(EllisMetric(rho=jnp.asarray(1.0)))
    g = float(jax.jit(jax.grad(
        lambda r: _loss(EllisMetric(rho=r), rays, "xla")))(jnp.asarray(1.0)))
    gf = float(jax.jit(jax.grad(
        lambda r: _loss(EllisMetric(rho=r), rays, "xla",
                        freeze_controller=True)))(jnp.asarray(1.0)))
    assert np.isfinite(gf) and gf != g
    # frozen-controller drops only the controller chain: same sign, close
    assert np.sign(gf) == np.sign(g)
    assert abs(gf - g) / abs(g) < 0.1, (gf, g)
