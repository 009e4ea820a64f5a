#!/usr/bin/env python
"""Headline benchmark: Ellis-wormhole direct render throughput on one GPU.

Config (BASELINE.json "Mrays/s/chip (Ellis 1024^2)"): Ellis rho=1, camera at
l=5 facing the wormhole, default CurVis optics (diag 43 / f 15), forward-Euler
dt=0.05, escape radius 100, max 40k steps — the reference's default simulation
settings (settings/defaults/simulation_settings.toml) at 1024x1024.

Baseline: the reference cannot be compiled here (no Rust toolchain), so the
measured stand-in is native/refbench.cc — a -O3 C++ port of the reference's
exact inner loop (f64, single thread, same camera/metric/stepper), measured at
2.0e4 rays/s on one core of the development host's CPU (see BASELINE.md).

Rows (each is one JSON field; a failing row fails the run):
  * the headline: 4 camera poses per device call, median over REPS with
    the per-rep times, IQR and min-time throughput;
  * ``quality``: the fused adaptive DP5(4) render at rtol 1e-3;
  * ``parity``: the Pallas-vs-XLA gates of every kernel family
    (benchmarks/parity_gates.py); CURVIS_BENCH_PARITY=0 skips;
  * ``kerr_grad``: one Kerr spin value_and_grad step, backend='scan' vs
    'adjoint' (kernel forward + XLA checkpointed backward);
    CURVIS_BENCH_GRAD=0 skips;
  * ``symmetric_ok``: the symmetric renderer's on-device sampler.

Runs only on a GPU: it prints nvidia-smi's name and power limit and JAX's
device header first, and exits non-zero when JAX finds no GPU.  Prints ONE
JSON line last: {"metric", "value", "unit", "vs_baseline", ...extras}.
"""
import json
import os
import sys
import time

import numpy as np

REFERENCE_PROXY_RAYS_PER_S = 2.0e4   # native/refbench.cc, 1024 res, 1 core
RES = 1024
# the headline reports median + IQR + min over the per-rep times (all
# persisted in the JSON line)
REPS = 11


def _grad_bench(jax, jnp, cv):
    """Median wall-clock of one jitted Kerr spin value_and_grad step,
    backend='scan' (checkpointed XLA) vs 'adjoint' (kernel forward + XLA
    checkpointed-recompute backward), at 64x36 and 256x144; the 'adjoint'
    forward alone is timed too, so the backward's share shows."""
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr

    def run(w, h, reps):
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                           0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
        bg = cv.make_spherical_image(np.asarray(smooth, np.float32))
        th = np.pi / 2 - 0.3
        f = np.array([-np.sin(th), 1.3, -np.cos(th)])
        f /= np.linalg.norm(f)
        cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                             35.0, 43.0, w, h, dtype=jnp.float32)
        res = {}
        a0 = jnp.asarray(0.7, jnp.float32)
        for backend in ("scan", "adjoint"):
            def loss(a, _backend=backend):
                m = KerrMetric(m=jnp.asarray(1.0, jnp.float32), a=a)
                img = render_kerr(m, cam, bg, dt=0.1, max_steps=800,
                                  escape_radius=20.0, backend=_backend)
                return jnp.mean(img)
            ts = _times(jax.jit(jax.value_and_grad(loss)), a0, reps)
            res[backend + "_ms"] = round(float(np.median(ts)) * 1e3, 3)
            res[backend + "_ms_min"] = round(float(min(ts)) * 1e3, 3)
            if backend == "adjoint":
                tf = _times(jax.jit(loss), a0, reps)
                res["adjoint_fwd_ms"] = round(float(np.median(tf)) * 1e3, 3)
        res["speedup"] = round(res["scan_ms"] / res["adjoint_ms"], 2)
        return res

    out = run(64, 36, 5)
    big = run(256, 144, 3)
    out["speedup_256x144"] = big["speedup"]
    out["scan_ms_256x144"] = big["scan_ms"]
    out["adjoint_ms_256x144"] = big["adjoint_ms"]
    out["adjoint_fwd_ms_256x144"] = big["adjoint_fwd_ms"]

    # differentiable ERROR-CONTROLLED marching — value_and_grad through
    # stepper='rk45' (exact adjoint with the per-ray iteration sequence
    # replayed as data), scan = XLA pair, adjoint = kernel forward + XLA
    # checkpointed backward.  rk45 needs ~10x fewer steps than the
    # fixed-RK4 rows above.
    def run45(w, h, reps):
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                           0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
        bg = cv.make_spherical_image(np.asarray(smooth, np.float32))
        th = np.pi / 2 - 0.3
        f = np.array([-np.sin(th), 1.3, -np.cos(th)])
        f /= np.linalg.norm(f)
        cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                             35.0, 43.0, w, h, dtype=jnp.float32)
        res = {}
        a0 = jnp.asarray(0.7, jnp.float32)
        for backend in ("scan", "adjoint"):
            def loss(a, _backend=backend):
                # max_steps bounds the backward replay (2*max_steps masked
                # iterations); 200 is ~3x the per-ray iteration max at this
                # config (same gradient as 400)
                m = KerrMetric(m=jnp.asarray(1.0, jnp.float32), a=a)
                img = render_kerr(m, cam, bg, dt=0.1, max_steps=200,
                                  escape_radius=30.0, stepper="rk45",
                                  rtol=1e-4, backend=_backend)
                return jnp.mean(img)
            ts = _times(jax.jit(jax.value_and_grad(loss)), a0, reps)
            res[backend + "_ms"] = round(float(np.median(ts)) * 1e3, 3)
            res[backend + "_ms_min"] = round(float(min(ts)) * 1e3, 3)
            if backend == "adjoint":
                tf = _times(jax.jit(loss), a0, reps)
                res["adjoint_fwd_ms"] = round(float(np.median(tf)) * 1e3, 3)
        res["speedup"] = round(res["scan_ms"] / res["adjoint_ms"], 2)
        return res

    r45 = run45(256, 144, 3)
    out["rk45_scan_ms_256x144"] = r45["scan_ms"]
    out["rk45_adjoint_ms_256x144"] = r45["adjoint_ms"]
    out["rk45_speedup_256x144"] = r45["speedup"]
    out["rk45_adjoint_fwd_ms_256x144"] = r45["adjoint_fwd_ms"]

    # differentiable DISK rendering (VERDICT round-4 #1) —
    # value_and_grad through render_kerr(disk=...) with the surface
    # adjoints (integrate/kerr_surface_adjoint.py): 12-state crossing-
    # tracking pair, captured rays' hit gradients included.
    def run_disk(w, h, reps):
        from curvis_tpu.render.disk import DiskParams
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                           0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
        bg = cv.make_spherical_image(np.asarray(smooth, np.float32))
        th = np.pi / 2 - 0.4
        f = np.array([-np.sin(th), 0.0, -np.cos(th)])
        f /= np.linalg.norm(f)
        cam = cv.make_camera([0.0, 18.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                             35.0, 43.0, w, h, dtype=jnp.float32)
        disk = DiskParams(r_inner=3.0, r_outer=10.0)
        res = {}
        a0 = jnp.asarray(0.7, jnp.float32)
        for backend in ("scan", "adjoint"):
            def loss(a, _backend=backend):
                m = KerrMetric(m=jnp.asarray(1.0, jnp.float32), a=a)
                img = render_kerr(m, cam, bg, dt=0.1, max_steps=800,
                                  escape_radius=25.0, disk=disk,
                                  backend=_backend)
                return jnp.mean(img)
            ts = _times(jax.jit(jax.value_and_grad(loss)), a0, reps)
            res[backend + "_ms"] = round(float(np.median(ts)) * 1e3, 3)
            if backend == "adjoint":
                tf = _times(jax.jit(loss), a0, reps)
                res["adjoint_fwd_ms"] = round(float(np.median(tf)) * 1e3, 3)
        res["speedup"] = round(res["scan_ms"] / res["adjoint_ms"], 2)
        return res

    rd = run_disk(256, 144, 3)
    out["disk_scan_ms_256x144"] = rd["scan_ms"]
    out["disk_adjoint_ms_256x144"] = rd["adjoint_ms"]
    out["disk_speedup_256x144"] = rd["speedup"]
    out["disk_adjoint_fwd_ms_256x144"] = rd["adjoint_fwd_ms"]
    return out


def _times(fn, arg, reps):
    """Per-rep wall times of ``fn(arg)`` after one compiling call, each
    waited for with jax.block_until_ready."""
    import jax
    jax.block_until_ready(fn(arg))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        ts.append(time.perf_counter() - t0)
    return ts


def main():
    import jax
    from curvis_tpu.utils.cache import enable_compile_cache
    from curvis_tpu.utils.device import header_lines
    for line in header_lines(enable_compile_cache()):
        print(line, flush=True)
    import jax.numpy as jnp
    import curvis_tpu as cv

    metric = cv.EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    cam = cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0], 15.0, 43.0, RES, RES,
                         dtype=jnp.float32)
    rng = np.random.default_rng(0)
    bgp = cv.make_spherical_image(rng.random((512, 1024, 3), dtype=np.float32))
    bgn = cv.make_spherical_image(rng.random((512, 1024, 3), dtype=np.float32))

    from curvis_tpu.render.fast import render_planar_fused

    @jax.jit
    def render(metric, cam, bgp, bgn):
        # nearest filtering = the reference's lookup semantics (images.rs:115)
        return render_planar_fused(metric, cam, bgp, bgn, dt=0.05,
                                   max_steps=40_000, escape_radius=100.0,
                                   filtering="nearest")

    # Sustained-throughput variant: FRAMES distinct camera poses rendered in
    # one device call (the video-workload shape), amortizing dispatch.
    FRAMES = 4
    cams = [cv.make_camera([0.0, 5.0, np.pi / 2, 0.001 * k], [-1.0, 0.0, 0.0],
                           [0.0, 0.0, 1.0], 15.0, 43.0, RES, RES,
                           dtype=jnp.float32) for k in range(FRAMES)]

    @jax.jit
    def render_batch(metric, cams, bgp, bgn):
        out = jnp.zeros((), jnp.float32)
        for cam in cams:
            out = out + jnp.mean(render_planar_fused(
                metric, cam, bgp, bgn, dt=0.05, max_steps=40_000,
                escape_radius=100.0, filtering="nearest"))
        return out

    # warmup/compile + correctness gate on the full image
    img = np.asarray(render(metric, cam, bgp, bgn))
    assert (img.sum(-1) > 0).mean() > 0.9, "render produced mostly black"
    jax.block_until_ready(render_batch(metric, cams, bgp, bgn))

    rays = FRAMES * RES * RES

    def measure(fn):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(metric, cams, bgp, bgn))
            ts.append(time.perf_counter() - t0)
        return ts

    times = measure(render_batch)
    secs = float(np.median(times))
    q1, q3 = (float(np.percentile(times, q)) for q in (25, 75))
    mrays = rays / secs / 1e6
    out = {
        "metric": "Mrays/s/chip (Ellis 1024^2, Euler dt=0.05, 40k steps)",
        "unit": "Mrays/s",
        "median_over": REPS,
        "value": mrays,
        "vs_baseline": mrays * 1e6 / REFERENCE_PROXY_RAYS_PER_S,
        "spread_pct": 100.0 * (max(times) - min(times)) / secs,
        "rep_times_ms": [t * 1e3 for t in times],
        "iqr_pct": 100.0 * (q3 - q1) / secs,
        "mrays_min_time": rays / min(times) / 1e6,
    }

    # Quality-mode row (VERDICT round-4 #6): the fused adaptive DP5(4)
    # pipeline (spawn + error-controlled march + readout) under the
    # headline conditions.  At rtol=1e-3 its image error is *below* Euler
    # dt=0.05 parity (1024^2 vs a dt=0.01 anchor: mean |dRGB| 7.5e-4 vs
    # 2.1e-3, p99 0.015 vs 0.036; BASELINE.md "quality ceiling").
    # CURVIS_BENCH_QUALITY=0 skips.
    if os.environ.get("CURVIS_BENCH_QUALITY", "1") != "0":
        @jax.jit
        def render_batch45(metric, cams, bgp, bgn):
            acc = jnp.zeros((), jnp.float32)
            for cam in cams:
                acc = acc + jnp.mean(render_planar_fused(
                    metric, cam, bgp, bgn, dt=0.05, max_steps=4_000,
                    escape_radius=100.0, filtering="nearest",
                    stepper="rk45", rtol=1e-3))
            return acc

        jax.block_until_ready(render_batch45(metric, cams, bgp, bgn))
        t45 = measure(render_batch45)
        m45 = rays / float(np.median(t45)) / 1e6
        out["quality"] = {
            "fused_rk45_rtol1e-3_mrays": m45,
            "fused_rk45_mrays_min_time": rays / min(t45) / 1e6,
            "vs_euler_parity": m45 / out["value"],
        }

    if os.environ.get("CURVIS_BENCH_PARITY", "1") != "0":
        import pathlib
        sys.path.insert(0, str(pathlib.Path(__file__).parent / "benchmarks"))
        from parity_gates import run_gates
        parity = run_gates()
        out["parity"] = {k: v.get("ok") for k, v in parity.items()}
        bad = {k: v for k, v in parity.items() if not v.get("ok")}
        if bad:
            raise SystemExit(f"parity gates failed: {bad}")

    if os.environ.get("CURVIS_BENCH_GRAD", "1") != "0":
        out["kerr_grad"] = _grad_bench(jax, jnp, cv)

    # the symmetric (reference-production-path) renderer: its on-device
    # sampler is the one pipeline the rows above do not cover
    from curvis_tpu.render.symmetric import render_symmetric
    simg = render_symmetric(
        metric, cv.make_camera([0.0, 5.0, np.pi / 2, 0.0],
                               [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                               15.0, 43.0, 192, 108, dtype=jnp.float32),
        bgp, bgn, dt=0.05, max_steps=40_000, escape_radius=100.0,
        alpha_nums=100, max_iterations_sampling=50,
        sampling_convergence_threshold_1=1e-5,
        sampling_convergence_threshold_2=1e-5)
    out["symmetric_ok"] = bool(np.isfinite(float(jnp.mean(simg))))
    if not out["symmetric_ok"]:
        raise SystemExit("symmetric render is not finite")

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
