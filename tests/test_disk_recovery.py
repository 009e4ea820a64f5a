"""Inverse problem from a DISK IMAGE (VERDICT round-4 #1 'Done' item):
recover physical parameters from the one observable real instruments
produce — an EHT-like picture of the accretion disk — via the volumetric
surface adjoint (everything smooth: no crossing gates in the loss path).

Full 5-parameter (M, a, inclination, r_in, r_out) multi-start recovery is
examples/disk_image_recovery.py (GPU-scale); this CPU test pins the
mechanism on the (spin, inner-edge) pair, which is the physically
canonical disk measurement (ISCO radius tracks spin).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.fit import fit
from curvis_tpu.metrics.kerr import KerrMetric
from curvis_tpu.render.disk import DiskParams
from curvis_tpu.render.kerr import render_kerr


def test_recover_spin_and_inner_edge_from_noisy_disk_image():
    w, h = 32, 18
    yy, xx = np.mgrid[0:64, 0:128]
    sky = np.stack([0.1 + 0.1 * np.sin(6 * np.pi * xx / 128), 0.1 + yy / 320,
                    0.2 + 0.1 * np.cos(4 * np.pi * yy / 64)], -1)
    bg = cv.make_spherical_image(np.clip(sky, 0, 1), dtype=jnp.float64)
    th = np.pi / 2 - 0.4
    cam = cv.make_camera([0.0, 18.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, w, h, dtype=jnp.float64)
    vdisk = DiskParams(r_inner=3.0, r_outer=12.0, volumetric=True,
                       h_rel=0.1, kappa=2.0, tau_max=8.0)

    def render(p):
        m = KerrMetric(m=jnp.asarray(1.0), a=p["a"])
        return render_kerr(m, cam, bg, dt=0.25, max_steps=700,
                           escape_radius=25.0, disk=vdisk, backend="scan",
                           disk_theta={"r_inner": p["r_in"]})

    true = {"a": jnp.asarray(0.7), "r_in": jnp.asarray(3.5)}
    rng = np.random.default_rng(0)
    target = render(true)
    target = jnp.clip(target + 0.01 * rng.standard_normal(target.shape),
                      0, 1)

    def loss_fn(p):
        return jnp.mean((render(p) - target) ** 2)

    init = {"a": jnp.asarray(0.35), "r_in": jnp.asarray(4.8)}

    def project(p):
        return {"a": jnp.clip(p["a"], 0.0, 0.95),
                "r_in": jnp.clip(p["r_in"], 2.2, 6.0)}

    res = fit(loss_fn, init, iters=70, lr=0.04, project=project)
    a_f = float(res.params["a"])
    r_f = float(res.params["r_in"])
    # directional recovery: both knobs descend into the truth basin,
    # cutting their initial error by > 2x; loss drops well below init
    assert float(res.history[-1]) < 0.3 * float(res.history[0])
    assert abs(a_f - 0.7) < 0.15, a_f                  # init error 0.35
    assert abs(r_f - 3.5) < 0.5, r_f                   # init error 1.3
    assert np.isfinite(res.history).all()
