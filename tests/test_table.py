"""User-defined metrics at kernel speed: the Chebyshev tabulation path
(metrics/table.py + ops/march_pallas kind 'cheb{K}{h|c}').

The reference's whole extensibility surface is a 3-method trait
(/root/reference/src/metrics.rs:42-44); these tests pin that an arbitrary
user r(l) reaches every backend INCLUDING the Pallas kernels (VERDICT
round-2 next-step #2), with measured fit accuracy and cross-backend parity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import curvis_tpu as cv
from curvis_tpu.camera.camera import pixel_rays_world
from curvis_tpu.metrics.base import EllisMetric, InterstellarMetric, _register
from curvis_tpu.metrics.table import tabulate_metric
from curvis_tpu.physics import planar as pl


@_register
@dataclasses.dataclass(frozen=True)
class BellWormhole:
    """Asymmetric smooth wormhole: rho(l) = rho0 (1 + eps tanh(l/w)) — the
    examples/custom_metric.py spacetime."""
    rho0: jax.Array
    eps: jax.Array
    w: jax.Array

    def _rho(self, l):
        return self.rho0 * (1.0 + self.eps * jnp.tanh(l / self.w))

    def r(self, l):
        return jnp.sqrt(self.r_squared(l))

    def r_squared(self, l):
        rho = self._rho(l)
        return rho * rho + l * l

    def r_derivative(self, l):
        rho = self._rho(l)
        sech2 = 1.0 - jnp.tanh(l / self.w) ** 2
        drho = self.rho0 * self.eps * sech2 / self.w
        return (rho * drho + l) / self.r(l)


def _bell():
    return BellWormhole(rho0=jnp.asarray(1.0), eps=jnp.asarray(0.35),
                        w=jnp.asarray(1.5))


def test_fit_accuracy_ellis_spectral():
    """Analytic metrics converge spectrally: Ellis at degree 14 fits to
    ~1e-13 (the table is exact for practical purposes)."""
    tab, rep = tabulate_metric(EllisMetric(rho=jnp.asarray(1.0)), degree=14)
    assert rep["err_inv_rel"] < 1e-10 and rep["err_dr3_rel"] < 1e-10
    l = jnp.linspace(-20.0, 20.0, 101)
    np.testing.assert_allclose(np.asarray(tab.r(l)),
                               np.sqrt(1.0 + np.asarray(l) ** 2), rtol=1e-5)


def test_fit_reports_basis_and_meets_tol():
    tab, rep = tabulate_metric(_bell(), degree=20)
    assert rep["basis"] in ("horner", "clenshaw")
    assert tab.basis == rep["basis"]
    assert max(rep["err_inv_rel"], rep["err_dr3_rel"]) < 1e-4


def test_fit_raises_on_insufficient_degree_and_r_zero():
    with pytest.raises(ValueError, match="exceeds tol"):
        tabulate_metric(_bell(), degree=8)
    # DNEG's C^1 throat kink defeats a global polynomial — explicit failure,
    # not silent inaccuracy (DNEG has its own hand-written kernel kind)
    with pytest.raises(ValueError, match="exceeds tol"):
        tabulate_metric(InterstellarMetric(m=jnp.asarray(0.5),
                                           a=jnp.asarray(0.3),
                                           rho=jnp.asarray(1.0)), degree=16)
    with pytest.raises(ValueError, match="wormhole-class"):
        tabulate_metric(lambda l: jnp.abs(l), degree=8)   # flat: r(0)=0


def test_callable_front_door():
    """A bare r(l) lambda works (derivative via autodiff)."""
    tab, rep = tabulate_metric(lambda l: jnp.sqrt(1.0 + l * l), degree=14)
    assert rep["err_inv_rel"] < 1e-10        # this IS Ellis rho=1


def _march_all_backends(metric, kw):
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 24, 12,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(metric, cam.position, pixel_rays_world(cam))
    rays32 = pl.PlanarRays(*(a.astype(jnp.float32) for a in rays))
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    a = pl.march_planar_while(metric, rays32, **kw)
    b = march_planar_pallas(metric, rays32, **kw)
    return a, b


@pytest.mark.parametrize("basis", ["clenshaw", "horner"])
def test_pallas_kernel_matches_xla_on_table(basis):
    """The cheb kernel kind == the XLA while-march on the SAME table
    (identical polynomial algebra, f32): signs equal, psi to f32 march
    accumulation error."""
    tab, _ = tabulate_metric(_bell(), degree=20, basis=basis)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=20.0)
    a, b = _march_all_backends(tab, kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(b.sign))
    esc = np.abs(np.asarray(a.sign)) == 1
    assert np.abs(np.asarray(a.psi) - np.asarray(b.psi))[esc].max() < 1e-4


def test_table_matches_original_metric():
    """Marching the table == marching the user's exact r(l) (XLA both) to
    the fit tolerance: the tabulation is faithful, not just self-consistent."""
    bell = _bell()
    tab, _ = tabulate_metric(bell, degree=20)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=20.0)
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.05],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 24, 12,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(bell, cam.position, pixel_rays_world(cam))
    res_e = pl.march_planar_while(bell, rays, **kw)
    rays_t = pl.spawn_planar(tab, cam.position, pixel_rays_world(cam))
    res_t = pl.march_planar_while(tab, rays_t, **kw)
    agree = (np.asarray(res_e.sign) == np.asarray(res_t.sign))
    assert agree.mean() > 0.97
    esc = agree & (np.abs(np.asarray(res_e.sign)) == 1)
    dpsi = np.abs(np.asarray(res_e.psi) - np.asarray(res_t.psi))[esc]
    assert np.median(dpsi) < 1e-3 and (dpsi > 1e-2).mean() < 0.05


def test_render_and_gradient_through_table():
    """Full render with a TabulatedMetric + jax.grad w.r.t. the COEFFICIENT
    table through the adjoint backward (the 'optimize the spacetime shape'
    axis — no named parameters needed)."""
    tab, _ = tabulate_metric(_bell(), degree=16, tol=1e-3)
    rng = np.random.default_rng(0)
    bg = cv.make_spherical_image(rng.random((16, 32, 3)), dtype=jnp.float64)
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 10,
                         dtype=jnp.float64)
    tab64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), tab)

    def loss(t):
        img = cv.render_direct(t, cam, bg, bg, method="planar",
                               filtering="bilinear",
                               differentiable="adjoint", dt=0.05,
                               max_steps=2000, escape_radius=15.0)
        return jnp.mean(img ** 2)

    v, g = jax.value_and_grad(loss)(tab64)
    assert np.isfinite(float(v))
    assert np.isfinite(np.asarray(g.c1)).all()
    assert float(jnp.abs(g.c1).max()) > 0      # gradient actually flows
    # FD check on one coefficient
    eps = 1e-6
    k = 2
    bump = tab64.c1.at[k].add(eps)
    v2 = loss(dataclasses.replace(tab64, c1=bump))
    fd = (float(v2) - float(v)) / eps
    np.testing.assert_allclose(float(g.c1[k]), fd, rtol=1e-3, atol=1e-12)


def test_rk45_kernel_supports_table():
    """The adaptive RK45 kernel takes the cheb kind through its spliced
    param row (tail preservation)."""
    from curvis_tpu.integrate.rk45 import march_planar_rk45
    from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
    tab, _ = tabulate_metric(EllisMetric(rho=jnp.asarray(1.0)), degree=12)
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.1, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 16, 8,
                         dtype=jnp.float64)
    rays = pl.spawn_planar(tab, cam.position, pixel_rays_world(cam))
    rays = pl.PlanarRays(*(a.astype(jnp.float32) for a in rays))
    kw = dict(escape_radius=50.0, rtol=1e-5, atol=1e-7)
    a = march_planar_rk45(tab, rays, **kw)
    b = march_planar_rk45_pallas(tab, rays, **kw)
    np.testing.assert_array_equal(np.asarray(a.sign), np.asarray(b.sign))
    assert np.abs(np.asarray(a.psi) - np.asarray(b.psi)).max() < 1e-3

def test_volumetric_kernel_supports_table():
    """Regression: the volumetric kernel's widened 16-slot scalar row parks a
    table metric's Chebyshev tail at offset 16 — the kernel read it from the
    compact kernels' offset 10 (kappa/tau_max/... as coefficients), giving
    garbage trajectories (final-l off by the whole escape radius), and the
    hardcoded (1, 16) row spec truncated the tail entirely.  The Pallas
    march must match the XLA volumetric marcher on the SAME table."""
    from curvis_tpu.ops.march_pallas import march_planar_disk_volumetric_pallas
    from curvis_tpu.render.disk import DiskParams, march_planar_disk_volumetric
    tab, _ = tabulate_metric(lambda l: jnp.sqrt(1.0 + l * l), degree=10,
                             tol=1e-3, dtype=jnp.float64)
    n = 64
    alpha = jnp.asarray(np.linspace(0.1, 0.8, n))
    l = jnp.full((n,), 20.0)
    rays = pl.PlanarRays(l, jnp.zeros((n,)), -jnp.cos(alpha),
                         tab.r(l) * jnp.sin(alpha),
                         jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    c1 = jnp.full((n,), 0.2)
    c2 = jnp.full((n,), 0.6)
    nz = jnp.full((n,), 0.77)
    disk = DiskParams(r_inner=3.0, r_outer=10.0, volumetric=True, h_rel=0.1,
                      kappa=3.0, color_mode="tint", t_peak=7000.0)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=40.0)
    res_a, tau_a, em_a = march_planar_disk_volumetric(tab, rays, c1, c2, nz,
                                                      params=disk, **kw)
    res_b, tau_b, em_b = march_planar_disk_volumetric_pallas(
        tab, rays, c1, c2, nz, disk=disk, **kw)
    np.testing.assert_array_equal(np.asarray(res_a.sign),
                                  np.asarray(res_b.sign))
    assert float(jnp.abs(res_a.l - res_b.l).max()) < 1e-9
    assert float(tau_a.max()) > 1.0          # rays actually cross the gas
    np.testing.assert_allclose(np.asarray(tau_a), np.asarray(tau_b),
                               rtol=1e-10, atol=1e-12)
    for ea, eb in zip(em_a, em_b):
        np.testing.assert_allclose(np.asarray(ea), np.asarray(eb),
                                   rtol=1e-10, atol=1e-12)

def test_disk_kernel_supports_table():
    """Thin-disk kernel + table metric: the disk row splices (r_in, r_out,
    0, 0) into slots 6:10, keeping the Chebyshev tail at the compact
    kernels' offset 10 — crossing radii must match the XLA disk marcher
    (to trajectory-divergence level: the XLA path reaches (inv, dr3) via
    r_derivative's extra multiply/divide round trip, an ulp-level
    difference the march amplifies to ~1e-5 over 4k steps)."""
    from curvis_tpu.ops.march_pallas import march_planar_disk_pallas
    from curvis_tpu.render.disk import march_planar_disk
    tab, _ = tabulate_metric(lambda l: jnp.sqrt(1.0 + l * l), degree=10,
                             tol=1e-3, dtype=jnp.float64)
    n = 64
    alpha = jnp.asarray(np.linspace(0.1, 0.8, n))
    l = jnp.full((n,), 20.0)
    rays = pl.PlanarRays(l, jnp.zeros((n,)), -jnp.cos(alpha),
                         tab.r(l) * jnp.sin(alpha),
                         jnp.zeros((1, 3)), jnp.zeros((1, 3)))
    c1 = jnp.full((n,), 0.2)
    c2 = jnp.full((n,), 0.6)
    kw = dict(dt=0.05, max_steps=4000, escape_radius=40.0,
              r_inner=3.0, r_outer=10.0)
    res_a, (h1a, h2a, _s1a), _ = march_planar_disk(tab, rays, c1, c2, **kw)
    res_b, (h1b, h2b, _s1b), _ = march_planar_disk_pallas(
        tab, rays, c1, c2, **kw)
    np.testing.assert_array_equal(np.asarray(res_a.sign),
                                  np.asarray(res_b.sign))
    assert (np.asarray(h1a) > 0).any()       # rays actually hit the disk
    np.testing.assert_allclose(np.asarray(h1a), np.asarray(h1b),
                               rtol=5e-4, atol=1e-9)
    np.testing.assert_allclose(np.asarray(h2a), np.asarray(h2b),
                               rtol=5e-4, atol=1e-9)


def test_tabulate_metric_diff_basis_auto_gate():
    """tabulate_metric_diff cannot MEASURE Horner conversion error (traced
    values), so basis='auto' gates on degree: <=16 keeps Horner (matches
    the measured gate's choice on smooth shapes), above switches to the
    cancellation-free Clenshaw basis — high-degree diff tables must not
    silently ship catastrophically-cancelled monomial coefficients."""
    from curvis_tpu.metrics.table import tabulate_metric_diff

    r_fn = lambda l: jnp.sqrt(1.0 + l * l)                    # noqa: E731
    low = tabulate_metric_diff(r_fn, degree=12)
    high = tabulate_metric_diff(r_fn, degree=24)
    assert low.basis == "horner"
    assert high.basis == "clenshaw"

    # both evaluate the same shape: r and 1/r^2 agree with truth
    l = jnp.asarray(np.linspace(-8.0, 8.0, 101))
    for tab in (low, high):
        np.testing.assert_allclose(np.asarray(tab.r(l)),
                                   np.asarray(r_fn(l)), rtol=5e-5)
    # explicit basis override still works and matches auto at high degree
    h24 = tabulate_metric_diff(r_fn, degree=24, basis="clenshaw")
    np.testing.assert_array_equal(np.asarray(h24.c1), np.asarray(high.c1))
