"""Differentiable rendering: gradients vs finite differences + inverse
rendering (the axis the Rust reference does not have — BASELINE config #3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.metrics.base import EllisMetric


KW = dict(dt=0.05, max_steps=2000, escape_radius=20.0)


def _scene(rng, res=(24, 16)):
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         [0.0, 0.0, 1.0], 15.0, 43.0, res[0], res[1],
                         dtype=jnp.float64)
    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5,
                       yy / h, 0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg_p = cv.make_spherical_image(smooth, dtype=jnp.float64)
    bg_n = cv.make_spherical_image(smooth[::-1].copy(), dtype=jnp.float64)
    return cam, bg_p, bg_n


def _loss_fn(cam, bg_p, bg_n):
    def loss(rho, position):
        metric = EllisMetric(rho=rho)
        camera = jax.tree_util.tree_map(lambda x: x, cam)
        camera = cv.Camera(position=position, forward=cam.forward, up=cam.up,
                           focal_length=cam.focal_length,
                           sensor_diagonal=cam.sensor_diagonal,
                           resolution_x=cam.resolution_x,
                           resolution_y=cam.resolution_y)
        img = cv.render_direct(metric, camera, bg_p, bg_n, method="planar",
                               filtering="bilinear", differentiable=True,
                               **KW)
        # weighted mean keeps the loss sensitive to geometry, not just color
        w = jnp.linspace(0.5, 1.5, img.shape[0])[:, None, None]
        return jnp.mean(img * w)
    return loss


def test_grad_rho_matches_finite_differences(rng):
    cam, bg_p, bg_n = _scene(rng)
    loss = _loss_fn(cam, bg_p, bg_n)
    pos = cam.position
    rho0 = jnp.asarray(1.0)
    g = jax.grad(loss, argnums=0)(rho0, pos)
    eps = 1e-5
    fd = (loss(rho0 + eps, pos) - loss(rho0 - eps, pos)) / (2 * eps)
    assert np.isfinite(float(g))
    assert abs(float(g)) > 1e-7          # genuinely nonzero
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-3)


def test_grad_camera_position_matches_finite_differences(rng):
    cam, bg_p, bg_n = _scene(rng)
    loss = _loss_fn(cam, bg_p, bg_n)
    rho0 = jnp.asarray(1.0)
    g = jax.grad(loss, argnums=1)(rho0, cam.position)
    # radial coordinate l (index 1) and phi (index 3)
    for idx in (1, 3):
        eps = 1e-5
        dp = jnp.zeros(4).at[idx].set(eps)
        fd = (loss(rho0, cam.position + dp)
              - loss(rho0, cam.position - dp)) / (2 * eps)
        assert np.isfinite(float(g[idx]))
        # FD picks up O(dt) jumps when a ray's discrete escape step flips
        # under the perturbation; AD differentiates the piecewise branch.
        # ~2% agreement is the expected envelope at dt=0.05.
        np.testing.assert_allclose(float(g[idx]), float(fd), rtol=3e-2,
                                   atol=1e-9)


def test_inverse_rendering_recovers_rho(rng):
    """Flagship differentiability demo: recover the throat radius from a
    target image by gradient descent.

    Uses a weak-deflection viewpoint (camera looking away from the throat):
    rays that cross the throat make the loss landscape fractally rough (the
    deflection map is chaotic there), trapping descent in micro-minima even
    though the AD gradient is exact — outward rays bend smoothly with rho.
    """
    _, bg_p, bg_n = _scene(rng)
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [1.0, 0.6, 0.3],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 32, 20,
                         dtype=jnp.float64)

    def render(rho):
        return cv.render_direct(EllisMetric(rho=rho), cam, bg_p, bg_n,
                                method="planar", filtering="bilinear",
                                differentiable=True, **KW)

    rho_true = jnp.asarray(1.6)
    target = render(rho_true)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda r: jnp.mean((render(r) - target) ** 2)))

    rho = jnp.asarray(1.0)
    loss0 = None
    for i in range(60):
        loss, g = value_and_grad(rho)
        if loss0 is None:
            loss0 = float(loss)
        # normalized step with cap: robust to the tiny loss scale
        rho = rho - jnp.clip(2e4 * g, -0.05, 0.05)
    assert abs(float(rho) - 1.6) < 0.05, float(rho)
    assert float(value_and_grad(rho)[0]) < 0.05 * loss0


def test_grad_through_dneg_params(rng):
    cam, bg_p, bg_n = _scene(rng)

    def loss(m, a, rho):
        metric = cv.make_metric("interstellar", m=1.0, a=1.0, rho=1.0)
        metric = type(metric)(m=m, a=a, rho=rho)
        img = cv.render_direct(metric, cam, bg_p, bg_n, method="planar",
                               filtering="bilinear", differentiable=True,
                               **KW)
        return jnp.mean(img)

    g = jax.grad(loss, argnums=(0, 2))(jnp.asarray(0.5), jnp.asarray(0.01),
                                       jnp.asarray(1.0))
    assert all(np.isfinite(float(x)) for x in g)
    eps = 1e-5
    fd = (loss(jnp.asarray(0.5 + eps), jnp.asarray(0.01), jnp.asarray(1.0))
          - loss(jnp.asarray(0.5 - eps), jnp.asarray(0.01),
                 jnp.asarray(1.0))) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), float(fd), rtol=1e-2, atol=1e-10)


def test_adjoint_gradients_match_scan(rng):
    """O(1)-memory adjoint VJP vs the exact checkpointed-scan gradients."""
    from curvis_tpu.camera.camera import pixel_rays_world
    from curvis_tpu.integrate.adjoint import march_planar_adjoint_rays
    from curvis_tpu.physics import planar as pl
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 10,
                         dtype=jnp.float64)

    def mkloss(marcher):
        def loss(rho, l_shift):
            metric = EllisMetric(rho=rho)
            rays = pl.spawn_planar(metric, cam.position,
                                   pixel_rays_world(cam))
            rays = rays._replace(l=rays.l + l_shift)
            res = marcher(metric, rays, **KW)
            beta = res.psi + jnp.arctan2(rays.b / metric.r(res.l), res.p_l)
            return jnp.mean(jnp.where(res.sign != 0, jnp.sin(beta), 0.0))
        return loss

    args = (jnp.asarray(1.0), jnp.asarray(0.0))
    v1, g1 = jax.value_and_grad(mkloss(pl.march_planar_scan),
                                argnums=(0, 1))(*args)
    v2, g2 = jax.value_and_grad(mkloss(march_planar_adjoint_rays),
                                argnums=(0, 1))(*args)
    assert float(v1) == float(v2)           # identical forward
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)


def test_adjoint_render_gradient(rng):
    """differentiable='adjoint' through the full renderer."""
    cam, bg_p, bg_n = _scene(rng, res=(16, 10))

    def loss(rho, mode):
        metric = EllisMetric(rho=rho)
        img = cv.render_direct(metric, cam, bg_p, bg_n, method="planar",
                               filtering="bilinear", differentiable=mode,
                               **KW)
        return jnp.mean(img)

    g_scan = jax.grad(lambda r: loss(r, True))(jnp.asarray(1.0))
    g_adj = jax.grad(lambda r: loss(r, "adjoint"))(jnp.asarray(1.0))
    np.testing.assert_allclose(float(g_adj), float(g_scan), rtol=1e-3)


def test_kerr_spin_gradient_matches_fd():
    """Reverse-mode through the BL march (march_hamiltonian_scan): the
    gradient of a Kerr image w.r.t. the SPIN matches finite differences.
    The while-loop marcher has no transpose; backend='scan' is the
    checkpointed differentiable path."""
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5,
                       yy / h, 0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 15.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         35.0, 43.0, 16, 10, dtype=jnp.float64)

    def loss(a):
        metric = KerrMetric(m=jnp.asarray(1.0, jnp.float64), a=a)
        img = render_kerr(metric, cam, bg, dt=0.1, max_steps=800,
                          escape_radius=20.0, backend="scan")
        wgt = jnp.linspace(0.5, 1.5, img.shape[0])[:, None, None]
        return jnp.mean(img * wgt)

    a0 = jnp.asarray(0.7, jnp.float64)
    g = jax.grad(loss)(a0)
    assert np.isfinite(float(g)) and abs(float(g)) > 1e-7
    eps = 1e-5
    fd = (loss(a0 + eps) - loss(a0 - eps)) / (2 * eps)
    # shadow-edge pixels flip discretely under FD; the interior band is
    # smooth — a few-percent envelope like the camera-pose test above
    np.testing.assert_allclose(float(g), float(fd), rtol=5e-2)


def test_inverse_rendering_recovers_kerr_spin():
    """'Measure a black hole's spin from the lensing of background stars':
    gradient descent on the spin through the differentiable BL march
    recovers a_true from a target frame — no spherical symmetry, no
    closed-form deflection map, just AD through 800 RK4 steps.

    The camera is tilted so the SHADOW IS OUTSIDE the field of view: rays
    skim the hole at moderate impact parameters, where the frame-dragged
    deflection is a smooth monotone function of the spin and descent
    converges cleanly.  (With the shadow in view the loss landscape is
    microscopically fractal — photon-ring scattering is chaotic — which is
    physics, not an AD defect; the FD-match test above covers that regime.)
    """
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5,
                       yy / h, 0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.3
    f = np.array([-np.sin(th), 1.3, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                         35.0, 43.0, 20, 12, dtype=jnp.float64)

    def render(a):
        return render_kerr(KerrMetric(m=jnp.asarray(1.0, jnp.float64), a=a),
                           cam, bg, dt=0.1, max_steps=800,
                           escape_radius=20.0, backend="scan")

    a_true = 0.85
    target = render(jnp.asarray(a_true, jnp.float64))
    assert float((target.sum(-1) == 0).mean()) == 0.0   # shadow out of view
    vg = jax.jit(jax.value_and_grad(
        lambda a: jnp.mean((render(a) - target) ** 2)))
    a = jnp.asarray(0.2, jnp.float64)
    loss0 = None
    for _ in range(40):
        loss, g = vg(a)
        if loss0 is None:
            loss0 = float(loss)
        a = jnp.clip(a - jnp.clip(2e2 * g, -0.08, 0.08), 0.0, 0.99)
    assert abs(float(a) - a_true) < 0.01, float(a)
    assert float(vg(a)[0]) < 1e-3 * loss0


def test_joint_mass_spin_recovery_two_viewpoints():
    """The (M, a) degeneracy of one-sided lensing breaks with viewpoints on
    OPPOSITE sides of the hole (frame dragging is odd under the swap, the
    mass deflection even): annealed descent on the combined loss recovers
    both parameters."""
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.3
    cams = []
    for side in (+1.3, -1.3):
        f = np.array([-np.sin(th), side, -np.cos(th)])
        f /= np.linalg.norm(f)
        cams.append(cv.make_camera([0.0, 15.0, th, 0.0], list(f),
                                   [0.0, 0.0, 1.0], 35.0, 43.0, 16, 10,
                                   dtype=jnp.float64))

    def render(m_, a_, cam):
        return render_kerr(KerrMetric(m=m_, a=a_), cam, bg, dt=0.1,
                           max_steps=800, escape_radius=20.0,
                           backend="scan")

    targets = [render(jnp.asarray(1.0), jnp.asarray(0.85), c) for c in cams]
    vg = jax.jit(jax.value_and_grad(lambda p: sum(
        jnp.mean((render(p[0], p[1], c) - t) ** 2)
        for c, t in zip(cams, targets))))
    p = jnp.asarray([0.7, 0.3])
    for i in range(60):
        _, g = vg(p)
        cap = 0.05 * (0.93 ** max(0, i - 15))
        p = p - jnp.clip(2e2 * g, -cap, cap)
        p = jnp.asarray([jnp.clip(p[0], 0.2, 3.0),
                         jnp.clip(p[1], 0.0, 0.99 * p[0])])
    assert abs(float(p[0]) - 1.0) < 0.02, np.asarray(p)
    assert abs(float(p[1]) - 0.85) < 0.05, np.asarray(p)


# ---------------------------------------------------------------------------
# Kernel-speed gradients (VERDICT round-2 next-step #1) — the adjoint pair
# whose forward is the production Pallas kernel (interpret mode here) and
# whose backward is the XLA checkpointed recompute.
# ---------------------------------------------------------------------------

def _kerr_smooth_scene():
    """Camera aimed so the shadow is OUT of view (the inverse-problem
    regime: smooth monotone frame-dragged lensing, no photon-ring chaos)."""
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5,
                       yy / h, 0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.3
    f = np.array([-np.sin(th), 1.3, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                         35.0, 43.0, 20, 12, dtype=jnp.float64)
    return cam, bg


def test_kerr_adjoint_matches_scan_smooth_regime():
    """march_kerr_adjoint (checkpointed-recompute backward) == the exact
    checkpointed-scan gradients to machine precision (both differentiate
    exact RK4 of the same flow; E/L conservation is exact in each), and
    matches finite differences through its own forward."""
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    cam, bg = _kerr_smooth_scene()

    def loss(a, backend):
        m = KerrMetric(m=jnp.asarray(1.0, jnp.float64), a=a)
        img = render_kerr(m, cam, bg, dt=0.1, max_steps=800,
                          escape_radius=20.0, backend=backend)
        wgt = jnp.linspace(0.5, 1.5, img.shape[0])[:, None, None]
        return jnp.mean(img * wgt)

    a0 = jnp.asarray(0.7, jnp.float64)
    g_scan = jax.grad(lambda a: loss(a, "scan"))(a0)
    g_adj = jax.grad(lambda a: loss(a, "adjoint"))(a0)
    np.testing.assert_allclose(float(g_adj), float(g_scan), rtol=1e-8)
    eps = 1e-5
    fd = (loss(a0 + eps, "adjoint") - loss(a0 - eps, "adjoint")) / (2 * eps)
    np.testing.assert_allclose(float(g_adj), float(fd), rtol=1e-3)


def test_kerr_adjoint_pallas_backward_matches_xla():
    """backend='pallas' (kernel forward, interpret mode, + the XLA
    checkpointed-recompute backward) computes the identical adjoint to the
    all-XLA pair — Kerr and Kerr-Newman (q gradient)."""
    from curvis_tpu.integrate.kerr_adjoint import march_kerr_adjoint
    from curvis_tpu.metrics.kerr import KerrMetric, KerrNewmanMetric
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(0)
    n = 48
    th0 = np.pi / 2 - 0.3
    pos = jnp.stack([jnp.zeros(n), jnp.full(n, 15.0), jnp.full(n, th0),
                     jnp.zeros(n)], -1)
    dirs = np.stack([-np.ones(n), 1.3 + 0.3 * rng.standard_normal(n),
                     0.3 * rng.standard_normal(n)], -1)
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))
    KWk = dict(dt=0.1, max_steps=600, escape_radius=25.0)

    def mkloss(backend, mk):
        def loss(v):
            metric = mk(v)
            p0 = ham.spawn_photon(metric, pos, dirs)
            x, p, sign, _ = march_kerr_adjoint(metric, pos, p0,
                                               backend=backend, **KWk)
            return jnp.mean(jnp.where(sign == 1,
                                      jnp.sin(x[:, 3]) * p[:, 1]
                                      + jnp.cos(x[:, 2]), 0.0))
        return loss

    mk_kerr = lambda a: KerrMetric(m=jnp.asarray(1.0), a=a)        # noqa
    gx = jax.grad(mkloss("xla", mk_kerr))(jnp.asarray(0.8))
    gp = jax.grad(mkloss("pallas", mk_kerr))(jnp.asarray(0.8))
    np.testing.assert_allclose(float(gp), float(gx), rtol=1e-12)

    mk_kn = lambda q: KerrNewmanMetric(m=jnp.asarray(1.0),         # noqa
                                       a=jnp.asarray(0.6), q=q)
    gxq = jax.grad(mkloss("xla", mk_kn))(jnp.asarray(0.4))
    gpq = jax.grad(mkloss("pallas", mk_kn))(jnp.asarray(0.4))
    np.testing.assert_allclose(float(gpq), float(gxq), rtol=1e-12)


def test_kerr_adjoint_chaotic_regime_is_finite():
    """With the shadow IN view (photon-ring rays, capture boundary in
    frame), the adjoint gradient stays finite: captured rays are excluded
    from the backward (renderer masks them anyway) and escaped rays'
    recompute never touches an overflowing state."""
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    h, w = 16, 32
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(smooth, dtype=jnp.float64)
    th = np.pi / 2 - 0.3
    cam = cv.make_camera([0.0, 15.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         35.0, 43.0, 16, 10, dtype=jnp.float64)

    def loss(a):
        m = KerrMetric(m=jnp.asarray(1.0, jnp.float64), a=a)
        img = render_kerr(m, cam, bg, dt=0.1, max_steps=800,
                          escape_radius=20.0, backend="adjoint")
        return jnp.mean(img)

    g = jax.grad(loss)(jnp.asarray(0.7, jnp.float64))
    assert np.isfinite(float(g))


def test_planar_adjoint_pallas_pair_matches_scan(rng):
    """Planar Pallas forward (interpret) + XLA checkpointed-recompute
    backward vs the exact checkpointed scan, Ellis and DNEG.  Forward
    values agree to ~1e-7 (the DNEG kernel's degree-6 _atan_poly vs
    jnp.arctan — 1.2e-6 abs fit error, see march_pallas.py — keeps this
    from being bitwise); gradients to 1e-6."""
    from curvis_tpu.camera.camera import pixel_rays_world
    from curvis_tpu.integrate.adjoint import march_planar_adjoint_rays
    from curvis_tpu.metrics.base import InterstellarMetric
    from curvis_tpu.physics import planar as pl
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 10,
                         dtype=jnp.float64)

    def mkloss(marcher, mk):
        def loss(v, l_shift):
            metric = mk(v)
            rays = pl.spawn_planar(metric, cam.position,
                                   pixel_rays_world(cam))
            rays = rays._replace(l=rays.l + l_shift)
            res = marcher(metric, rays, **KW)
            beta = res.psi + jnp.arctan2(rays.b / metric.r(res.l), res.p_l)
            return jnp.mean(jnp.where(res.sign != 0, jnp.sin(beta), 0.0))
        return loss

    pallas_marcher = lambda m, r, **k: march_planar_adjoint_rays(   # noqa
        m, r, backend="pallas", **k)
    for mk, v in [(lambda r: EllisMetric(rho=r), 1.0),
                  (lambda m: InterstellarMetric(m=m, a=jnp.asarray(1e-4),
                                                rho=jnp.asarray(1.0)), 0.1)]:
        args = (jnp.asarray(v), jnp.asarray(0.0))
        g1 = jax.value_and_grad(mkloss(pl.march_planar_scan, mk),
                                argnums=(0, 1))(*args)
        g2 = jax.value_and_grad(mkloss(pallas_marcher, mk),
                                argnums=(0, 1))(*args)
        # rtol floor set by the DNEG degree-6 atan refit (round 3): the
        # kernel's shape readout differs from jnp.arctan by up to ~1.2e-6
        # abs, ~1e-7 relative after the image mean
        np.testing.assert_allclose(float(g1[0]), float(g2[0]), rtol=5e-7)
        for a, b in zip(g1[1], g2[1]):
            np.testing.assert_allclose(float(a), float(b), rtol=2e-6)

def test_table_metric_adjoint_pallas_matches_xla():
    """The adjoint differentiates TABULATED user metrics — the segment VJP
    yields cotangents of the Chebyshev table itself (d image /
    d shape-of-r(l)).  Kernel forward (interpret) + XLA backward vs the
    all-XLA pair on every leaf (c1, c2, s), plus a finite-difference anchor
    on one coefficient."""
    from curvis_tpu.camera.camera import pixel_rays_world
    from curvis_tpu.integrate.adjoint import march_planar_adjoint_rays
    from curvis_tpu.metrics.table import tabulate_metric
    from curvis_tpu.physics import planar as pl

    def r_fn(l):
        rho = 1.0 + 0.3 * jnp.tanh(l / 1.5)
        return jnp.sqrt(rho * rho + l * l)

    tab0, _ = tabulate_metric(r_fn, degree=8, tol=5e-3, dtype=jnp.float64)
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 12, 8,
                         dtype=jnp.float64)

    def mkloss(backend):
        def loss(tab):
            rays = pl.spawn_planar(tab, cam.position, pixel_rays_world(cam))
            res = march_planar_adjoint_rays(tab, rays, backend=backend, **KW)
            beta = res.psi + jnp.arctan2(rays.b / tab.r(res.l), res.p_l)
            return jnp.mean(jnp.where(res.sign != 0, jnp.sin(beta), 0.0))
        return loss

    vx, gx = jax.value_and_grad(mkloss("xla"))(tab0)
    vp, gp = jax.value_and_grad(mkloss("pallas"))(tab0)
    np.testing.assert_allclose(float(vx), float(vp), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gx.c1), np.asarray(gp.c1),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gx.c2), np.asarray(gp.c2),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(gx.s), float(gp.s), rtol=1e-6)
    assert float(jnp.abs(gx.c1).max()) > 0          # gradients actually flow

    # FD anchor on the largest-|grad| c1 coefficient
    import dataclasses
    k = int(np.abs(np.asarray(gx.c1)).argmax())
    eps = 1e-6
    def at(dv):
        c1 = tab0.c1.at[k].add(dv)
        return float(mkloss("pallas")(
            dataclasses.replace(tab0, c1=c1)))
    fd = (at(eps) - at(-eps)) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(gp.c1)[k]), fd, rtol=2e-4)

def test_shape_recovery_from_deflection_data():
    """Compact twin of examples/shape_recovery.py: reconstruct r(l) of an
    unknown asymmetric wormhole from two-sided noisy deflection fans by
    gradient descent through the march, with the table fit applied as a
    fixed linear operator to autodiff (r, r') values (differentiable
    tabulation).  Recovery to <0.5% median proves the whole chain
    data -> march -> table coefficients -> shape parameters is exact."""
    import optax
    from curvis_tpu.integrate.adjoint import march_planar_adjoint
    from curvis_tpu.metrics.table import TabulatedMetric, tabulate_metric

    def r_true(l):
        rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)
        return jnp.sqrt(rho * rho + l * l)

    W, S, DEG, M = 1.5, 1.0, 10, 4
    nt = np.cos(np.pi * (np.arange(96) + 0.5) / 96)
    V = np.polynomial.chebyshev.chebvander(nt, DEG)
    C2M = np.zeros((DEG + 1, DEG + 1))
    for j in range(DEG + 1):
        e = np.zeros(DEG + 1)
        e[j] = 1.0
        p = np.polynomial.chebyshev.cheb2poly(e)
        C2M[:len(p), j] = p
    FIT = jnp.asarray(C2M @ np.linalg.pinv(V))
    LN = jnp.asarray(S * nt / np.sqrt(1.0 - nt * nt))

    def r_of(theta, l):
        u = jnp.tanh(l / W)
        b1 = jnp.zeros_like(u)
        b2 = jnp.zeros_like(u)
        for k in range(M, 0, -1):
            b1, b2 = theta[k] + 2.0 * u * b1 - b2, b1
        rho = jnp.exp(theta[0] + u * b1 - b2)
        return jnp.sqrt(rho * rho + l * l)

    def tabulate_diff(theta):
        r = r_of(theta, LN)
        rp = jax.vmap(jax.grad(lambda l: r_of(theta, l)))(LN)
        ls2 = LN * LN + S * S
        return TabulatedMetric(c1=FIT @ (ls2 / (r * r)),
                               c2=FIT @ (ls2 ** 1.5 * rp / r ** 3),
                               s=jnp.asarray(S), basis="horner")

    L0, R = 6.0, 40.0

    def deflection(tab, alphas, side):
        l = side * L0
        p_l = -side * jnp.cos(alphas)
        b = tab.r(l) * jnp.sin(alphas)
        lf, psif, plf, sign, _ = march_planar_adjoint(
            tab, (l, jnp.zeros_like(alphas), p_l), b, jnp.asarray(0.04),
            3000, R, backend="xla")
        return psif + jnp.arctan2(b / tab.r(lf), plf), sign

    al = jnp.asarray(np.linspace(0.25, 1.35, 12))
    alphas = jnp.concatenate([al, al])
    side = jnp.concatenate([jnp.ones(12), -jnp.ones(12)])
    tab_true, _ = tabulate_metric(r_true, degree=DEG, tol=1e-2,
                                  dtype=jnp.float64)
    beta_true, sign_t = deflection(tab_true, alphas, side)
    rng = np.random.default_rng(0)
    beta_obs = beta_true + 1e-3 * jnp.asarray(
        rng.standard_normal(alphas.shape))

    def loss(theta):
        beta, sign = deflection(tabulate_diff(theta), alphas, side)
        w = jnp.where(sign == sign_t, 1.0, 0.0)
        return jnp.sum(w * (beta - beta_obs) ** 2) \
            / jnp.maximum(jnp.sum(w), 1.0)

    theta = jnp.zeros(M + 1)
    opt = optax.adam(4e-2)
    state = opt.init(theta)
    vg = jax.jit(jax.value_and_grad(loss))
    for _ in range(150):
        v, g = vg(theta)
        up, state = opt.update(g, state)
        theta = optax.apply_updates(theta, up)

    lg = np.linspace(-5.0, 5.0, 101)
    rel = np.abs(np.asarray(r_of(theta, jnp.asarray(lg)))
                 - np.asarray(r_true(jnp.asarray(lg)))) \
        / np.asarray(r_true(jnp.asarray(lg)))
    assert float(v) < 5e-5, float(v)
    assert np.median(rel) < 5e-3, np.median(rel)
    # the asymmetry (different asymptotic rho on each side) was recovered:
    # true r(+5) - r(-5) = 5.1800 - 5.0424 = 0.1376 (the rho gap of 0.7 is
    # diluted quadratically in r = sqrt(rho^2 + l^2))
    r_fit = np.asarray(r_of(theta, jnp.asarray(np.array([-5.0, 5.0]))))
    np.testing.assert_allclose(r_fit[1] - r_fit[0], 0.1376, atol=0.03)


def test_ckpt_degenerate_inputs():
    """max_steps=0 (and n=0) return the exact degenerate gradient of the
    checkpointed recompute (d_y0 = cot, d_theta = 0)."""
    import jax.numpy as jnp
    from curvis_tpu.integrate.ckpt import ckpt_adjoint_backward

    def step(theta, y):
        return (y[0] + theta[0] * 0.1,)

    y0 = (jnp.arange(6.0),)
    theta = (jnp.ones(6),)
    steps = jnp.zeros(6, jnp.int32)
    cot = (jnp.linspace(1.0, 2.0, 6),)
    g, lam = ckpt_adjoint_backward(step, theta, y0, steps, cot,
                                   max_steps=0, segment=4)
    np.testing.assert_array_equal(np.asarray(lam[0]), np.asarray(cot[0]))
    np.testing.assert_array_equal(np.asarray(g[0]), np.zeros(6))

    empty = jnp.zeros((0,))
    g0, lam0 = ckpt_adjoint_backward(step, (empty,), (empty,),
                                     jnp.zeros((0,), jnp.int32), (empty,),
                                     max_steps=4, segment=2)
    assert lam0[0].shape == (0,) and g0[0].shape == (0,)
