"""Differentiable error-controlled marching (integrate/rk45_adjoint.py —
VERDICT round-3 next-step #1): the checkpointed-recompute adjoint composed
with the DP5(4) controller, per-ray iteration sequences replayed as data.

Reference context: /root/reference has neither adaptive stepping nor
gradients; its rigid recurrence (src/metrics.rs:283-297) is the map both
upgrades generalize — these tests pin that they now compose.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from curvis_tpu.integrate.rk45 import march_kerr_rk45
from curvis_tpu.integrate.rk45_adjoint import (_forward_xla_rk45,
                                               _rk45_step,
                                               march_kerr_rk45_adjoint)
from curvis_tpu.metrics.kerr import KerrMetric
from curvis_tpu.physics import hamiltonian as ham


def _bundle(n=48, r0=15.0, seed=1):
    rng = np.random.default_rng(seed)
    th0 = np.pi / 2 - 0.3
    pos = jnp.asarray(np.stack([np.zeros(n), np.full(n, r0),
                                np.full(n, th0), np.zeros(n)], -1))
    dirs = np.stack([-np.ones(n), 1.3 + 0.3 * rng.standard_normal(n),
                     0.3 * rng.standard_normal(n)], -1)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    return pos, dirs


_KW = dict(dt0=0.1, max_steps=400, escape_radius=25.0, rtol=1e-9,
           atol=1e-12, dt_min=1e-7)


def _loss(a, m, pos, dirs, backend, **extra):
    metric = KerrMetric(m=m, a=a)
    p0 = ham.spawn_photon(metric, pos, dirs)
    x, p, sign, _ = march_kerr_rk45_adjoint(metric, pos, p0,
                                            backend=backend, **_KW, **extra)
    return jnp.mean(jnp.where(sign == 1,
                              jnp.sin(x[:, 3]) * p[:, 1] + jnp.cos(x[:, 2]),
                              0.0))


def test_replay_reproduces_forward_bitwise():
    """The masked scan replay (what the backward differentiates) must BE
    the lock-step forward trajectory — this is the exactness invariant the
    whole checkpointed-recompute design rests on."""
    from curvis_tpu.integrate.ckpt import march_masked
    pos, dirs = _bundle()
    metric = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.8))
    p0 = ham.spawn_photon(metric, pos, dirs)
    R = 25.0
    cs = (1e-9, 1e-12, 1e-7, R / 8.0, R, float(metric.capture_radius))
    x, p, sign, steps, iters = _forward_xla_rk45(cs, metric, pos, p0, 0.1,
                                                 400, 800)
    theta = (metric.m, metric.a, jnp.zeros(()), -p0[:, 0], p0[:, 3])
    y0 = (pos[:, 1], pos[:, 2], pos[:, 3], p0[:, 1], p0[:, 2],
          jnp.full_like(pos[:, 1], 0.1))
    y = march_masked(partial(_rk45_step, cs), theta, y0, iters,
                     max_steps=800, segment=28)
    np.testing.assert_array_equal(np.asarray(y[0]), np.asarray(x[:, 1]))
    np.testing.assert_array_equal(np.asarray(y[1]), np.asarray(x[:, 2]))
    np.testing.assert_array_equal(np.asarray(y[3]), np.asarray(p[:, 1]))
    np.testing.assert_array_equal(np.asarray(y[4]), np.asarray(p[:, 2]))


def test_forward_value_matches_rk45_twin_semantics():
    """The adjoint's lock-step forward and integrate/rk45.march_kerr_rk45
    implement the same controller on algebraically-identical RHS forms —
    escape fates must agree exactly and escape states to integrator ulps."""
    pos, dirs = _bundle()
    metric = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.8))
    p0 = ham.spawn_photon(metric, pos, dirs)
    x, p, sign, steps = march_kerr_rk45_adjoint(metric, pos, p0,
                                                backend="xla", **_KW)
    res = march_kerr_rk45(metric, pos, p0,
                          capture_radius=metric.capture_radius,
                          escape_radius=_KW["escape_radius"],
                          max_steps=_KW["max_steps"], rtol=_KW["rtol"],
                          atol=_KW["atol"], dt0=_KW["dt0"],
                          dt_min=_KW["dt_min"])
    assert (np.asarray(sign) == np.asarray(res.sign)).all()
    esc = np.asarray(sign) == 1
    np.testing.assert_allclose(np.asarray(x[:, 2])[esc],
                               np.asarray(res.x[:, 2])[esc], atol=1e-7)


def test_grad_spin_matches_fd():
    pos, dirs = _bundle()
    a0 = jnp.asarray(0.8)
    m0 = jnp.asarray(1.0)
    f = jax.jit(lambda a: _loss(a, m0, pos, dirs, "xla"))
    g = float(jax.jit(jax.grad(lambda a: _loss(a, m0, pos, dirs, "xla")))
              (a0))
    eps = 1e-4
    fd = (float(f(a0 + eps)) - float(f(a0 - eps))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-3, (g, fd)


def test_grad_mass_matches_fd_flip_free_eps():
    """m is a strong knob: eps=1e-4 flips accept decisions on ~5% of rays
    and corrupts central FD (measured +0.15 vs the true -0.025); eps=1e-5
    is flip-free on this bundle and pins the adjoint to <1e-2."""
    pos, dirs = _bundle()
    a0 = jnp.asarray(0.8)
    f = jax.jit(lambda m: _loss(a0, m, pos, dirs, "xla"))
    g = float(jax.jit(jax.grad(lambda m: _loss(a0, m, pos, dirs, "xla")))
              (jnp.asarray(1.0)))
    eps = 1e-5
    fd = (float(f(jnp.asarray(1.0 + eps)))
          - float(f(jnp.asarray(1.0 - eps)))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-2, (g, fd)


def test_pallas_pair_matches_xla_pair():
    """Pallas(interpret) checkpoint kernel pair vs the XLA checkpointed
    scan — same frozen map, so gradients agree to summation-order ulps."""
    pos, dirs = _bundle()
    a0 = jnp.asarray(0.8)
    m0 = jnp.asarray(1.0)
    gx = float(jax.jit(jax.grad(lambda a: _loss(a, m0, pos, dirs, "xla")))
               (a0))
    gp = float(jax.jit(jax.grad(
        lambda a: _loss(a, m0, pos, dirs, "pallas")))(a0))
    assert abs(gp - gx) / max(abs(gx), 1e-12) < 1e-5, (gp, gx)


def test_freeze_controller_mode_runs_and_differs():
    """freeze_controller=True drops the landing-overshoot dt-sensitivity —
    documented as a systematic difference on escape-state losses (the
    exact mode is the default precisely because of it)."""
    pos, dirs = _bundle()
    a0 = jnp.asarray(0.8)
    m0 = jnp.asarray(1.0)
    g = float(jax.jit(jax.grad(lambda a: _loss(a, m0, pos, dirs, "xla")))
              (a0))
    gf = float(jax.jit(jax.grad(
        lambda a: _loss(a, m0, pos, dirs, "xla", freeze_controller=True)))
        (a0))
    assert np.isfinite(gf) and gf != g


def test_render_kerr_rk45_adjoint_backend():
    """render_kerr(stepper='rk45', backend='scan'/'adjoint') — the round-3
    guard (render/kerr.py:339-341) is gone; the full render pipeline is
    differentiable through the error-controlled march."""
    import curvis_tpu as cv
    from curvis_tpu.render.kerr import render_kerr
    rng = np.random.default_rng(0)
    w, h = 24, 12
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(np.asarray(smooth))
    th = np.pi / 2 - 0.3
    f = np.array([-np.sin(th), 1.3, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                         35.0, 43.0, w, h)

    def loss(a, backend):
        m = KerrMetric(m=jnp.asarray(1.0), a=a)
        img = render_kerr(m, cam, bg, dt=0.1, max_steps=400,
                          escape_radius=25.0, stepper="rk45", rtol=1e-6,
                          backend=backend)
        return jnp.mean(img)

    a0 = jnp.asarray(0.7)
    v, g = jax.jit(jax.value_and_grad(lambda a: loss(a, "scan")))(a0)
    assert np.isfinite(float(v)) and np.isfinite(float(g))
    assert float(g) != 0.0
    eps = 3e-4
    fl = jax.jit(lambda a: loss(a, "scan"))
    fd = (float(fl(a0 + eps)) - float(fl(a0 - eps))) / (2 * eps)
    # image-mean loss over few pixels: bilinear texture kinks + decision
    # flips bound FD fidelity; the gradient direction must still agree
    assert np.sign(fd) == np.sign(float(g))
    assert abs(float(g) - fd) / max(abs(fd), 1e-12) < 0.3


def test_thin_disk_rk45_scan_no_longer_guarded():
    """Round 4 raised NotImplementedError for rk45 + disk gradient
    backends; round 5's surface adjoints support the combination — the
    old guard must stay gone and the render must be differentiable."""
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr
    import curvis_tpu as cv
    bg = cv.make_spherical_image(np.random.default_rng(0).random((8, 16, 3)))
    cam = cv.make_camera([0.0, 15.0, np.pi / 2 - 0.3, 0.0],
                         [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0], 35.0, 43.0,
                         8, 4)

    def loss(a):
        img = render_kerr(KerrMetric(m=jnp.asarray(1.0), a=a),
                          cam, bg, dt=0.1, max_steps=200,
                          escape_radius=25.0, stepper="rk45",
                          backend="scan",
                          disk=DiskParams(r_inner=3.0, r_outer=8.0))
        return jnp.mean(img)

    v, g = jax.value_and_grad(loss)(jnp.asarray(0.5))
    assert np.isfinite(float(v)) and np.isfinite(float(g))


def test_odd_max_iters_matches_even_on_pallas_pair():
    """An odd iteration cap binds the kernel forward exactly: no ray
    records more than max_iters iterations (the backward replays exactly
    max_iters), and the kernel-forward pair agrees with the XLA pair at
    the cap, capped rays included (a forward that overshot the cap would
    silently truncate their gradient)."""
    from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
    pos, dirs = _bundle()
    m0 = jnp.asarray(1.0)
    kw = dict(dt0=0.1, max_steps=30, escape_radius=25.0, rtol=1e-9,
              atol=1e-12, dt_min=1e-7)

    def loss(a, max_iters, backend):
        metric = KerrMetric(m=m0, a=a)
        p0 = ham.spawn_photon(metric, pos, dirs)
        x, p, sign, _ = march_kerr_rk45_adjoint(
            metric, pos, p0, backend=backend, max_iters=max_iters, **kw)
        smooth = (sign == 0) | (sign == 1)        # capped rays included
        return jnp.mean(jnp.where(smooth,
                                  jnp.sin(x[:, 3]) * p[:, 1]
                                  + jnp.cos(x[:, 2]), 0.0))

    a0 = jnp.asarray(0.8)
    metric = KerrMetric(m=m0, a=a0)
    *_, iters = march_kerr_rk45_pallas(
        metric, pos, ham.spawn_photon(metric, pos, dirs), max_iters=21,
        return_iters=True, **kw)
    assert int(np.asarray(iters).max()) == 21
    v_p, g_p = jax.value_and_grad(loss)(a0, 21, "pallas")
    v_x, g_x = jax.value_and_grad(loss)(a0, 21, "xla")
    np.testing.assert_allclose(float(v_p), float(v_x), rtol=1e-8)
    assert abs(float(g_p) - float(g_x)) / max(abs(float(g_x)), 1e-12) \
        < 1e-5, (g_p, g_x)
    assert np.isfinite(float(g_p))
