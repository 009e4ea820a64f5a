#!/usr/bin/env python
"""Showcase renders: Ellis and Interstellar/DNEG wormholes against
procedural starfield backgrounds.

    python examples/render_wormholes.py [outdir] [--res 960x540] [--f64]

Produces:
    ellis.png          direct renderer, adaptive RK45, bilinear
    interstellar.png   same for the DNEG metric
    ellis_parity.png   symmetric renderer at the reference's exact defaults
                       (Euler dt=0.05, nearest lookup, black seam)
"""
import argparse
import sys
from pathlib import Path

import numpy as np


def starfield(h, w, seed, tint):
    """Procedural equirect sky: gaussian stars + nebula tint."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    # nebula: smooth low-frequency color field
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for k, amp in ((1, 0.5), (2, 0.25), (5, 0.12)):
        phase = rng.uniform(0, 2 * np.pi, size=3)
        for c in range(3):
            img[..., c] += amp * tint[c] * (
                0.5 + 0.5 * np.sin(2 * np.pi * k * xx / w + phase[c])
                * np.sin(np.pi * k * yy / h + phase[(c + 1) % 3]))
    img *= 0.35
    # stars: density weighted by sin(theta) so the sphere is uniform
    n_stars = h * w // 180
    theta = np.arccos(rng.uniform(-1, 1, n_stars))
    phi = rng.uniform(0, 2 * np.pi, n_stars)
    ys = np.clip((theta / np.pi * h).astype(int), 0, h - 1)
    xs = np.clip((phi / (2 * np.pi) * w).astype(int), 0, w - 1)
    mag = rng.power(3.0, n_stars)
    col = 0.6 + 0.4 * rng.random((n_stars, 3))
    for y, x, m, c in zip(ys, xs, mag, col):
        img[y, x] = np.minimum(img[y, x] + m * c, 1.0)
        if m > 0.8:          # bright stars bleed into neighbors
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                img[(y + dy) % h, (x + dx) % w] = np.minimum(
                    img[(y + dy) % h, (x + dx) % w] + 0.3 * m * c, 1.0)
    return np.clip(img, 0, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="examples/out", type=Path)
    ap.add_argument("--res", default="960x540")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args(argv)
    W, H = (int(v) for v in args.res.split("x"))
    args.outdir.mkdir(parents=True, exist_ok=True)

    import jax
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.render.fast import render_planar_fast
    from curvis_tpu.render.symmetric import render_symmetric

    dtype = jnp.float64 if args.f64 else jnp.float32
    bg_pos = cv.make_spherical_image(starfield(512, 1024, 1,
                                               (1.0, 0.6, 0.3)), dtype=dtype)
    bg_neg = cv.make_spherical_image(starfield(512, 1024, 2,
                                               (0.3, 0.5, 1.0)), dtype=dtype)
    camera = cv.make_camera([0.0, 6.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0], 15.0, 43.0, W, H, dtype=dtype)

    scenes = [
        ("ellis", cv.make_metric("ellis", rho=1.0), camera),
        ("interstellar", cv.make_metric("interstellar", m=0.5, a=0.5,
                                        rho=1.0), camera),
        ("schwarzschild", cv.make_metric("schwarzschild", m=1.0),
         cv.make_camera([0.0, 25.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0], 15.0, 43.0, W, H, dtype=dtype)),
    ]
    for name, metric, camx in scenes:
        img = render_planar_fast(metric, camx, bg_pos, bg_neg, dt=0.05,
                                 max_steps=20_000, escape_radius=100.0,
                                 stepper="rk45", filtering="bilinear")
        out = args.outdir / f"{name}.png"
        cv.save_image(np.asarray(img), out)
        print(f"saved {out}")

    # the Gargantua shot: Schwarzschild + Doppler-beamed accretion disk
    from curvis_tpu.render.disk import DiskParams, render_blackhole_disk
    from curvis_tpu.metrics.base import SchwarzschildMetric
    import jax
    th = np.pi / 2 - 0.22
    bh = SchwarzschildMetric(m=jnp.asarray(1.0, dtype))
    cam_bh = cv.make_camera([0.0, 28.0, th, 0.0],
                            [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                            30.0, 43.0, W, H, dtype=dtype)
    dim_bg = cv.make_spherical_image(0.25 * starfield(512, 1024, 3,
                                                      (0.5, 0.55, 0.8)),
                                     dtype=dtype)
    img = jax.jit(lambda m, c, b: render_blackhole_disk(
        m, c, b, dt=0.05, max_steps=40_000, escape_radius=80.0,
        disk=DiskParams(r_inner=5.2, r_outer=13.0, brightness=1.3,
                        opacity=0.95, doppler=True,
                        spin_sign=-1.0)))(bh, cam_bh, dim_bg)
    out = args.outdir / "gargantua_doppler.png"
    cv.save_image(np.asarray(img), out)
    print(f"saved {out}")

    img = render_symmetric(cv.make_metric("ellis", rho=1.0), camera, bg_pos,
                           bg_neg, dt=0.05, max_steps=40_000,
                           escape_radius=100.0, alpha_nums=100,
                           max_iterations_sampling=50,
                           filtering="nearest", seam="exact")
    out = args.outdir / "ellis_parity.png"
    cv.save_image(np.asarray(img), out)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
