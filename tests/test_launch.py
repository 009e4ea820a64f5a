"""The one kernel launcher (curvis_tpu/ops/launch.py) in interpret mode:
ray counts that are not a block multiple, the padded scalar row, block
validation, and block-size independence of every kernel family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from curvis_tpu.ops import launch as launch_mod
from curvis_tpu.ops.launch import _pow2, launch


def _probe(row, x_ref, y_ref, o_ref, n_ref):
    # o = x * row[0, 0] + y + row[0, width-1]; n = rays of the block alive
    o_ref[:] = x_ref[:] * row[0, 0] + y_ref[:] + row[0, 12]
    n_ref[:] = jnp.zeros_like(x_ref[:], jnp.int32) + x_ref.shape[0]


@pytest.mark.parametrize("n", [1, 127, 128, 129, 300])
def test_ray_count_not_a_block_multiple(n, kernel_constant):
    kernel_constant(launch_mod, "BLOCK", 128)
    x = jnp.arange(n, dtype=jnp.float64)
    y = jnp.ones(n, jnp.float64) * 0.5
    row = jnp.arange(13, dtype=jnp.float64) + 2.0        # width 13 -> 16
    o, blk = launch(_probe, row, [x, y], [jnp.float64, jnp.int32],
                    name="probe")
    assert o.shape == (n,) and blk.shape == (n,)
    np.testing.assert_array_equal(np.asarray(o), np.arange(n) * 2.0 + 0.5
                                  + 14.0)
    assert (np.asarray(blk) == 128).all()


@pytest.mark.parametrize("width,padded", [(1, 1), (10, 16), (16, 16),
                                          (33, 64)])
def test_scalar_row_padding(width, padded):
    assert _pow2(width) == padded


def test_block_must_be_a_power_of_two(kernel_constant):
    kernel_constant(launch_mod, "BLOCK", 96)
    with pytest.raises(ValueError):
        launch(_probe, jnp.zeros(13), [jnp.zeros(4), jnp.zeros(4)],
               [jnp.float32, jnp.int32], name="probe")


def _planar_bundle(n=150):
    from curvis_tpu.physics import planar as pl
    rng = np.random.default_rng(0)
    alpha = jnp.asarray(np.pi - 0.2 - 2.5 * rng.random(n))
    l0 = jnp.full((n,), 6.0)
    c1 = jnp.asarray(0.3 * rng.standard_normal(n))
    c2 = jnp.asarray(0.5 + 0.3 * rng.random(n))
    nz = jnp.asarray(0.4 + 0.4 * rng.random(n))
    z = jnp.zeros((1, 3))
    rays = pl.PlanarRays(l0, jnp.zeros(n), jnp.cos(alpha),
                         6.0 * jnp.sin(alpha), z, z)
    return rays, c1, c2, nz


def _kerr_bundle(n=150):
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.physics import hamiltonian as ham
    rng = np.random.default_rng(1)
    metric = KerrMetric(m=jnp.asarray(1.0), a=jnp.asarray(0.8))
    th = np.pi / 2 - 0.3
    x0 = jnp.asarray(np.stack([np.zeros(n), np.full(n, 15.0),
                               np.full(n, th), np.zeros(n)], -1))
    d = np.stack([-np.ones(n), 0.5 * rng.standard_normal(n),
                  -0.2 - 0.3 * rng.random(n)], -1)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return metric, x0, ham.spawn_photon(metric, x0, d)


def _fused(name):
    import curvis_tpu as cv
    from curvis_tpu.metrics.base import EllisMetric
    from curvis_tpu.ops.render_fused import render_fused_pallas
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.2, 0.1],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 15, 10,
                         dtype=jnp.float32)            # 150 rays
    metric = EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    if name == "fused_rk45":
        return render_fused_pallas(metric, cam, dt=0.05, max_steps=300,
                                   escape_radius=20.0,
                                   rk45=(1e-5, 1e-8, 10.0, 1200))
    return render_fused_pallas(metric, cam, dt=0.05, max_steps=800,
                               escape_radius=20.0)


def _family(name):
    from curvis_tpu.metrics.base import SchwarzschildMetric
    from curvis_tpu.ops import march_pallas as mp
    from curvis_tpu.render.disk import DiskParams
    vol = DiskParams(r_inner=3.0, r_outer=10.0, volumetric=True,
                     h_rel=0.1, kappa=2.0)
    if name.startswith("fused"):
        return _fused(name)
    if name.startswith("kerr"):
        metric, x0, p0 = _kerr_bundle()
        kw = dict(escape_radius=25.0)
        if name == "kerr_rk4":
            return mp.march_kerr_pallas(metric, x0, p0, dt=0.2,
                                        max_steps=300, disk=(3.0, 10.0),
                                        **kw)
        return mp.march_kerr_rk45_pallas(metric, x0, p0, max_steps=200,
                                         vol_disk=vol, **kw)
    metric = SchwarzschildMetric(m=jnp.asarray(1.0))
    rays, c1, c2, nz = _planar_bundle()
    kw = dict(escape_radius=20.0)
    if name == "planar_euler":
        return mp.march_planar_pallas(metric, rays, dt=0.05, max_steps=800,
                                      **kw)
    if name == "planar_rk45":
        return mp.march_planar_rk45_pallas(metric, rays, max_steps=300,
                                           c1=c1, c2=c2, disk=(3.0, 10.0),
                                           **kw)
    if name == "planar_disk":
        return mp.march_planar_disk_pallas(metric, rays, c1, c2, dt=0.05,
                                           max_steps=800, r_inner=3.0,
                                           r_outer=10.0, **kw)
    return mp.march_planar_disk_volumetric_pallas(
        metric, rays, c1, c2, nz, dt=0.05, max_steps=800, disk=vol, **kw)


@pytest.mark.parametrize("name", ["planar_euler", "planar_rk45",
                                  "fused_euler", "fused_rk45",
                                  "planar_disk", "planar_disk_vol",
                                  "kerr_rk4", "kerr_rk45_vol"])
def test_family_is_block_size_independent(name, kernel_constant):
    """Every ray's result is its own: block size (and so which rays share
    a block's early exit) does not change any output."""
    kernel_constant(launch_mod, "BLOCK", 128)
    a = jax.tree_util.tree_leaves(_family(name))
    kernel_constant(launch_mod, "BLOCK", 256)
    b = jax.tree_util.tree_leaves(_family(name))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
