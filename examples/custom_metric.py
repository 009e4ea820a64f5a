#!/usr/bin/env python
"""Define your own spacetime in ~15 lines and render it with every backend.

The metric protocol (metrics/base.py:Metric) is three scalar shape
functions r(l), r^2(l), r'(l) on a frozen dataclass pytree — the planar
reduction, all integrators (Euler/RK4/RK45), the XLA backends, gradients
and the sharded renderers work with ANY such metric, unmodified.  (The
reference hard-codes its metric menu in a Rust enum; here a user spacetime
is a first-class citizen.  Only the fused Pallas kernels key on concrete
types and fall back to the XLA path.)

This example builds an asymmetric "bell" wormhole,

    r(l) = sqrt(rho(l)^2 + l^2),   rho(l) = rho0 (1 + eps tanh(l / w)),

whose throat radius differs between the two universes (eps > 0: the
negative-l side is narrower), renders it, and — because parameters are
pytree leaves — takes d(image)/d(eps) by plain jax.grad.

It then COMPILES the metric for the Pallas kernels with
cv.tabulate_metric (metrics/table.py: Chebyshev tables on a compactified
coordinate, measured fit error reported) and renders the same scene
through the production kernel march — user spacetimes run at the same
VPU-saturated speed as the built-ins, on every backend.

    python examples/custom_metric.py [outdir]
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    outdir = Path(argv[0]) if argv else Path(__file__).parent / "out"
    outdir.mkdir(parents=True, exist_ok=True)

    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.metrics.base import _register
    from curvis_tpu.render.fast import render_planar_fast

    @_register
    @dataclasses.dataclass(frozen=True)
    class BellWormhole:
        """Asymmetric wormhole: rho(l) = rho0 (1 + eps tanh(l/w))."""
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

    metric = BellWormhole(rho0=jnp.asarray(1.0, jnp.float32),
                          eps=jnp.asarray(0.35, jnp.float32),
                          w=jnp.asarray(2.0, jnp.float32))

    sys.path.insert(0, str(Path(__file__).parent))
    from render_wormholes import starfield
    bg_p = cv.make_spherical_image(starfield(512, 1024, 3, (0.75, 0.8, 1.0)))
    bg_n = cv.make_spherical_image(starfield(512, 1024, 5, (1.0, 0.75, 0.6)))
    cam = cv.make_camera([0.0, 6.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, 960, 540,
                         dtype=jnp.float32)
    img = render_planar_fast(metric, cam, bg_p, bg_n, dt=0.05,
                             max_steps=40_000, escape_radius=100.0,
                             filtering="bilinear", backend="tiled")
    out = outdir / "custom_bell_wormhole.png"
    cv.save_image(np.asarray(img), out)
    print(f"wrote {out}")

    # ------------------------------------------------------------------
    # Kernel-speed path: compile the user metric into a Chebyshev table
    # and march it through the Pallas kernel (the 'auto' backend on the
    # GPU; the XLA 'tiled' march elsewhere runs the identical table
    # algebra).  The fit error is measured, not assumed; a higher degree
    # fits better and costs more flops per step — dial degree/tol to
    # taste.
    # ------------------------------------------------------------------
    tab, rep = cv.tabulate_metric(metric, degree=16, tol=5e-4)
    print(f"tabulated: degree={rep['degree']} basis={rep['basis']} "
          f"err(1/r^2)={rep['err_inv_rel']:.1e} "
          f"err(r'/r^3)={rep['err_dr3_rel']:.1e}")
    img_t = render_planar_fast(tab, cam, bg_p, bg_n, dt=0.05,
                               max_steps=40_000, escape_radius=100.0,
                               filtering="bilinear")
    out_t = outdir / "custom_bell_wormhole_tabulated.png"
    cv.save_image(np.asarray(img_t), out_t)
    mm = float((np.abs(np.asarray(img_t) - np.asarray(img)).max(-1)
                > 0.1).mean())
    print(f"wrote {out_t}  (pixel mismatch vs exact r(l): {mm:.2%})")

    # the custom parameter is differentiable like any built-in one
    # (checkpointed-scan march via differentiable=True).  A smooth texture
    # + row-weighted loss keeps the demo gradient geometry-sensitive (the
    # plain mean of a sparse starfield is warp-insensitive).
    h, w = 32, 64
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)],
                      -1).astype(np.float32)
    sm_p = cv.make_spherical_image(smooth, dtype=jnp.float32)
    sm_n = cv.make_spherical_image(smooth[::-1].copy(), dtype=jnp.float32)
    small = cv.make_camera([0.0, 6.0, np.pi / 2, 0.0], [-1.0, 0.35, 0.2],
                           [0.0, 0.0, 1.0], 15.0, 43.0, 48, 27,
                           dtype=jnp.float32)
    wgt = jnp.linspace(0.5, 1.5, 27)[:, None, None]

    # bilinear filtering matters: the parity-default nearest lookup is
    # piecewise constant in the escape direction, so its true gradient is
    # zero almost everywhere
    g = jax.grad(lambda eps: jnp.mean(wgt * cv.render_direct(
        dataclasses.replace(metric, eps=eps), small, sm_p, sm_n,
        method="planar", differentiable=True, filtering="bilinear",
        dt=0.05, max_steps=1500,
        escape_radius=20.0)))(jnp.asarray(0.35, jnp.float32))
    print(f"d(weighted mean image)/d(eps) = {float(g):+.3e}")
    assert float(g) != 0.0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
