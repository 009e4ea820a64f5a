"""Recover the gas's absorption + reflectance spectrum from a starlit image.

Round-5 closer: the in-gas scattered starlight is differentiable (the
27-scalar scatter block rides the surface adjoints' theta), so the
radiative properties of the gas — how much it absorbs (kappa) and its
reflectance SPECTRUM (per-channel albedo) — can be FIT from one
photograph of a frame-dragged accretion flow.  kappa is identifiable
through the absorption signature (background transmission through the
gas) even though it also scales the scattering coefficient; albedo and
starlight_scatter, by contrast, enter ONLY as the per-channel product
albedo_c * starlight_scatter, so they are exactly degenerate — the fit
recovers the reflectance spectrum with the scattering strength known
(fitting the product is the honest parameterization; see the gradient
tests for the single-knob derivatives).

The illumination map is treated as DATA (camera-independent, precomputed
once; none of the fitted knobs enter its construction — albedo and
kappa_s are applied in the scatter block, not the map), so the gradients
are exact for this parameterization.

Run on the GPU (backend='adjoint': the kernel forward + the XLA
checkpointed-recompute backward); --fast is a small float64 preset
(backend='scan').
"""
import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="small preset (f64, backend='scan')")
    args = ap.parse_args()

    import jax
    if args.fast:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.fit import fit
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr
    from curvis_tpu.render.starlight import compute_kerr_starlight_map

    dtype = jnp.float64 if args.fast else jnp.float32
    W, H = (48, 27) if args.fast else (128, 72)
    backend = "scan" if args.fast else "adjoint"
    max_steps = 400 if args.fast else 800

    kerr = KerrMetric(m=jnp.asarray(1.0, dtype), a=jnp.asarray(0.85, dtype))
    yy, xx = np.mgrid[0:64, 0:128]
    sky = np.clip(np.stack([0.5 + 0.4 * np.sin(2 * np.pi * xx / 128),
                            0.3 + 0.3 * (yy / 64),
                            np.full_like(yy, 0.55, dtype=float)], -1), 0, 1)
    bg = cv.make_spherical_image(sky, dtype=dtype)
    th = np.pi / 2 - 0.3
    f = np.array([-np.sin(th), 0.0, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0, 0, 1],
                         30.0, 43.0, W, H, dtype=dtype)
    disk = DiskParams(r_inner=2.6, r_outer=9.0, volumetric=True,
                      h_rel=0.1, kappa=2.0, starlight=True)
    smap = compute_kerr_starlight_map(
        kerr, bg, r_inner=2.6, r_outer=9.0, escape_radius=25.0, dt=0.1,
        max_steps=10_000, n_r=12, n_phi=24, n_samples=32,
        backend="xla" if args.fast else "pallas", boost="orbit")

    true = {"kappa": 2.0, "albedo": (0.6, 0.45, 0.3)}

    def render(kappa, albedo):
        return render_kerr(
            kerr, cam, bg, dt=0.1, max_steps=max_steps, escape_radius=20.0,
            disk=disk, backend=backend, starlight_map=smap,
            disk_theta={"kappa": kappa, "albedo": albedo})

    target = render(jnp.asarray(true["kappa"], dtype),
                    jnp.asarray(true["albedo"], dtype))
    rng = np.random.default_rng(0)
    target = jnp.asarray(np.asarray(target)
                         + rng.normal(0, 2e-3, target.shape), dtype)
    print(f"target: {W}x{H} starlit volumetric image, noise sigma 2e-3")

    def loss(p):
        img = render(p["kappa"], p["albedo"])
        return jnp.mean((img - target) ** 2)

    def sampler(r, _i):
        return {"kappa": jnp.asarray(r.uniform(0.8, 4.0), dtype),
                "albedo": jnp.asarray(r.uniform(0.2, 0.9, 3), dtype)}

    def project(p):
        return {"kappa": jnp.clip(p["kappa"], 0.1, 8.0),
                "albedo": jnp.clip(p["albedo"], 0.02, 1.0)}

    res = fit(loss, None, iters=120 if args.fast else 200, lr=3e-2,
              n_starts=4, init_sampler=sampler, project=project, seed=1)
    kap = float(res.params["kappa"])
    alb = np.asarray(res.params["albedo"])
    print("recovered vs true:")
    print(f"  kappa   {kap:.4f}  (true {true['kappa']})")
    print(f"  albedo  {np.round(alb, 4)}  (true {true['albedo']})")
    assert abs(kap - true["kappa"]) / true["kappa"] < 0.1, kap
    for c in range(3):
        assert abs(alb[c] - true["albedo"][c]) < 0.06, (c, alb[c])
    print("absorption + reflectance spectrum recovered — OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
