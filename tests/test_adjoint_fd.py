"""The production gradient path — kernel forward (interpret mode here) +
XLA checkpointed-recompute backward — against central finite differences
of the same forward, one case per adjoint family (float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.physics import planar as pl


def _planar_rays(metric):
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 12, 8,
                         dtype=jnp.float64)
    return pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))


def _planar_loss(march, mk):
    def loss(v):
        metric = mk(v)
        rays = _planar_rays(metric)
        res = march(metric, rays)
        beta = res.psi + jnp.arctan2(rays.b / metric.r(res.l), res.p_l)
        return jnp.mean(jnp.where(res.sign != 0, jnp.sin(beta), 0.0))
    return loss


def _euler(metric, rays):
    from curvis_tpu.integrate.adjoint import march_planar_adjoint_rays
    return march_planar_adjoint_rays(metric, rays, dt=0.05, max_steps=1500,
                                     escape_radius=20.0, backend="pallas")


def _rk45(metric, rays):
    from curvis_tpu.integrate.rk45_adjoint_planar import (
        march_planar_rk45_adjoint_rays)
    return march_planar_rk45_adjoint_rays(
        metric, rays, dt0=0.05, max_steps=300, escape_radius=20.0,
        rtol=1e-9, atol=1e-12, backend="pallas")


def _kerr_loss(rk45):
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(0)
    n = 24
    th0 = np.pi / 2 - 0.3
    pos = jnp.stack([jnp.zeros(n), jnp.full(n, 15.0), jnp.full(n, th0),
                     jnp.zeros(n)], -1)
    d = np.stack([-np.ones(n), 1.3 + 0.3 * rng.standard_normal(n),
                  0.3 * rng.standard_normal(n)], -1)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))

    def loss(a):
        metric = KerrMetric(m=jnp.asarray(1.0), a=a)
        p0 = ham.spawn_photon(metric, pos, d)
        if rk45:
            from curvis_tpu.integrate.rk45_adjoint import (
                march_kerr_rk45_adjoint)
            x, p, sign, _ = march_kerr_rk45_adjoint(
                metric, pos, p0, dt0=0.1, max_steps=300,
                escape_radius=25.0, rtol=1e-9, atol=1e-12,
                backend="pallas")
        else:
            from curvis_tpu.integrate.kerr_adjoint import march_kerr_adjoint
            x, p, sign, _ = march_kerr_adjoint(
                metric, pos, p0, dt=0.1, max_steps=600, escape_radius=25.0,
                backend="pallas")
        return jnp.mean(jnp.where(sign == 1, jnp.sin(x[:, 3]) * p[:, 1]
                                  + jnp.cos(x[:, 2]), 0.0))
    return loss


CASES = {
    "planar_euler_ellis": (lambda: _planar_loss(
        _euler, lambda r: cv.EllisMetric(rho=r)), 1.0, 1e-6),
    "planar_euler_dneg": (lambda: _planar_loss(
        _euler, lambda m: cv.InterstellarMetric(m=m, a=jnp.asarray(1e-4),
                                                rho=jnp.asarray(1.0))),
        0.1, 1e-6),
    "planar_rk45_ellis": (lambda: _planar_loss(
        _rk45, lambda r: cv.EllisMetric(rho=r)), 1.0, 1e-6),
    "kerr_rk4": (lambda: _kerr_loss(False), 0.8, 1e-5),
    "kerr_rk45": (lambda: _kerr_loss(True), 0.8, 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_forward_gradient_matches_fd(case):
    make, v0, eps = CASES[case]
    loss = make()
    v0 = jnp.asarray(v0, jnp.float64)
    g = float(jax.grad(loss)(v0))
    fd = (float(loss(v0 + eps)) - float(loss(v0 - eps))) / (2 * eps)
    assert np.isfinite(g) and abs(g) > 0
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-9)
