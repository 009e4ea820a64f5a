#!/usr/bin/env python
"""Each hand-written kernel against its plain XLA twin, end to end on the GPU.

    python benchmarks/kernel_vs_twin.py [--only NAME ...] [--reps N]

Every row renders through a normal entry point twice — once with the
kernel backend, once with the XLA twin (for K3, the fused kernel, the
composition it replaces: K1/K2 with XLA spawn and readout) — at the
README's frame sizes
(1024^2 for the planar Euler / RK45 families, 512x288 for the
disk, volume and Kerr families) and reports the median wall time of each
(compile excluded, every call waited for with jax.block_until_ready).
Sweep rows re-run one family with another block size, warp count or
step-loop unroll.  Prints the device header first and one JSON
object per row; the rows also go to chiprun_out/kernel_vs_twin.jsonl.
Runs only on a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out" / "kernel_vs_twin.jsonl"


def _timed(fn, args, reps):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"ms": float(np.median(ts)) * 1e3, "ms_min": min(ts) * 1e3,
            "ms_max": max(ts) * 1e3, "first_call_s": first}


def _timed_pair(fns, args, reps):
    """Kernel and twin timed in alternating order (kernel, twin, twin,
    kernel, ...), so that a drift of the card's clock meets both sides."""
    import jax
    first, ts = {}, {side: [] for side in fns}
    for side, fn in fns.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        first[side] = time.perf_counter() - t0
    sides = list(fns)
    for r in range(reps):
        for side in (sides if r % 2 == 0 else sides[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[side](*args))
            ts[side].append(time.perf_counter() - t0)
    return {side: {"ms": float(np.median(t)) * 1e3,
                   "ms_p25": float(np.percentile(t, 25)) * 1e3,
                   "ms_p75": float(np.percentile(t, 75)) * 1e3,
                   "ms_min": min(t) * 1e3, "ms_max": max(t) * 1e3,
                   "first_call_s": first[side]}
            for side, t in ts.items()}


def _skies(h=512, w=1024, seed=0):
    import curvis_tpu as cv
    rng = np.random.default_rng(seed)
    return (cv.make_spherical_image(rng.random((h, w, 3), dtype=np.float32)),
            cv.make_spherical_image(rng.random((h, w, 3), dtype=np.float32)))


def _planar_cam(res):
    import jax.numpy as jnp
    import curvis_tpu as cv
    return cv.make_camera([0.0, 5.0, np.pi / 2, 0.0], [-1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0], 15.0, 43.0, res[0], res[1],
                          dtype=jnp.float32)


def _metric(kind):
    import jax.numpy as jnp
    import curvis_tpu as cv
    f = lambda v: jnp.asarray(v, jnp.float32)          # noqa: E731
    if kind == "ellis":
        return cv.EllisMetric(rho=f(1.0))
    return cv.InterstellarMetric(m=f(0.1), a=f(1e-4), rho=f(1.0))


PLANAR = dict(dt=0.05, max_steps=40_000, escape_radius=100.0,
              filtering="nearest")


def row_planar(kind, stepper="euler", res=(1024, 1024)):
    """K1 (euler) / K2 (rk45): render_planar_fast, kernel vs XLA twin."""
    import jax
    from curvis_tpu.render.fast import render_planar_fast
    metric, cam = _metric(kind), _planar_cam(res)
    bgp, bgn = _skies()
    kw = dict(PLANAR, stepper=stepper)
    if stepper == "rk45":
        kw.update(max_steps=4_000)

    def mk(backend):
        return jax.jit(lambda m, c, p, n: render_planar_fast(
            m, c, p, n, backend=backend, **kw))
    return {"kernel": mk("pallas"), "twin": mk("tiled")}, \
        (metric, cam, bgp, bgn)


def row_fused(kind, stepper="euler", res=(1024, 1024)):
    """K3: render_planar_fused (spawn, march and readout in one kernel)
    against the composition it replaces — render_planar_fast through K1/K2
    with XLA spawn and readout — at the same dt, caps and tolerances."""
    import jax
    from curvis_tpu.render.fast import render_planar_fast, render_planar_fused
    metric, cam = _metric(kind), _planar_cam(res)
    bgp, bgn = _skies()
    kw = dict(PLANAR, stepper=stepper)
    fused_kw = {}
    if stepper == "rk45":
        kw.update(max_steps=4_000)
        # render_planar_fast's DP5(4) controller (march_planar_rk45_pallas)
        fused_kw = dict(rtol=1e-5, atol=1e-7, dt_max=10.0)
    kernel = jax.jit(lambda m, c, p, n: render_planar_fused(
        m, c, p, n, backend="pallas", **kw, **fused_kw))
    composition = jax.jit(lambda m, c, p, n: render_planar_fast(
        m, c, p, n, backend="pallas", **kw))
    return {"kernel": kernel, "twin": composition}, (metric, cam, bgp, bgn)


def _disk_scene(res=(512, 288)):
    import jax.numpy as jnp
    import curvis_tpu as cv
    th = np.pi / 2 - 0.12
    cam = cv.make_camera([0.0, 30.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, res[0], res[1], dtype=jnp.float32)
    metric = cv.SchwarzschildMetric(m=jnp.asarray(1.0, jnp.float32))
    return metric, cam


def row_disk(vol=False):
    """K4 (thin disk) / K5 (volumetric): render_blackhole_disk."""
    import jax
    from curvis_tpu.render.disk import DiskParams, render_blackhole_disk
    metric, cam = _disk_scene()
    bg, _ = _skies()
    disk = (DiskParams(r_inner=6.0, r_outer=15.0, volumetric=True,
                       h_rel=0.08) if vol
            else DiskParams(r_inner=6.0, r_outer=15.0))
    kw = dict(dt=0.02, max_steps=100_000, escape_radius=100.0, disk=disk)

    def mk(backend):
        return jax.jit(lambda m, c, b: render_blackhole_disk(
            m, c, b, backend=backend, **kw))
    return {"kernel": mk("pallas"), "twin": mk("while")}, (metric, cam, bg)


def _kerr_scene(res=(512, 288)):
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.metrics.kerr import KerrMetric
    th = np.pi / 2 - 0.15
    cam = cv.make_camera([0.0, 30.0, th, 0.0],
                         [-np.sin(th), 0.0, -np.cos(th)], [0.0, 0.0, 1.0],
                         30.0, 43.0, res[0], res[1], dtype=jnp.float32)
    metric = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.9, jnp.float32))
    return metric, cam


def row_kerr(stepper="rk4", vol=False):
    """K6 (rk4) / K7 (rk45): render_kerr, kernel vs XLA twin.  K7's
    volumetric variant has no rk45 XLA twin: it is timed against the XLA
    fixed-step volumetric march (march_kerr_volumetric)."""
    import jax
    from curvis_tpu.render.disk import DiskParams
    from curvis_tpu.render.kerr import render_kerr
    metric, cam = _kerr_scene()
    bg, _ = _skies()
    disk = (DiskParams(r_inner=2.5, r_outer=12.0, volumetric=True,
                       h_rel=0.08, kappa=3.0) if vol else None)
    kw = dict(dt=0.1, max_steps=20_000, escape_radius=60.0, disk=disk)

    def mk(backend, st):
        extra = dict(max_steps=4_000) if st == "rk45" else {}
        return jax.jit(lambda m, c, b: render_kerr(
            m, c, b, backend=backend, stepper=st, **{**kw, **extra}))
    twin_stepper = "rk4" if vol else stepper
    return {"kernel": mk("pallas", stepper),
            "twin": mk("xla", twin_stepper)}, (metric, cam, bg)


ROWS = {
    "K1_euler_ellis": lambda: row_planar("ellis"),
    "K1_euler_dneg": lambda: row_planar("dneg"),
    "K2_rk45_ellis": lambda: row_planar("ellis", "rk45"),
    "K3_fused_euler_ellis": lambda: row_fused("ellis"),
    "K3_fused_euler_dneg": lambda: row_fused("dneg"),
    "K3_fused_rk45_ellis": lambda: row_fused("ellis", "rk45"),
    "K4_disk": lambda: row_disk(False),
    "K5_disk_vol": lambda: row_disk(True),
    "K6_kerr_rk4": lambda: row_kerr("rk4"),
    "K6_kerr_rk4_vol": lambda: row_kerr("rk4", vol=True),
    "K7_kerr_rk45": lambda: row_kerr("rk45"),
    "K7_kerr_rk45_vol": lambda: row_kerr("rk45", vol=True),
}


def sweep_launch(reps, blocks=(128, 256, 512), warps=(4, 8)):
    """Block size x warps on K1 Ellis and K7 bare (one jit cache each)."""
    import jax
    from curvis_tpu.ops import launch
    shipped = launch.BLOCK, launch.NUM_WARPS
    out = []
    for name in ("K1_euler_ellis", "K7_kerr_rk45"):
        for b in blocks:
            for w in warps:
                launch.BLOCK, launch.NUM_WARPS = b, w
                jax.clear_caches()
                fns, args = ROWS[name]()
                r = _timed(fns["kernel"], args, reps)
                out.append(dict(row=f"sweep_{name}", block=b, num_warps=w,
                                **r))
                _emit(out[-1])
    launch.BLOCK, launch.NUM_WARPS = shipped
    jax.clear_caches()
    return out


def sweep_unroll(reps, unrolls=(1, 2, 4, 8, 16)):
    """The Euler step-loop unroll (ops/march_pallas.UNROLL), end to end
    through K1 Ellis.  (The disk, volume and Kerr kernels were swept the
    same way and take one step per iteration: CHANGES.md.)"""
    from curvis_tpu.ops import march_pallas
    shipped = march_pallas.UNROLL
    out = []
    for u in unrolls:
        march_pallas.UNROLL = u
        fns, args = ROWS["K1_euler_ellis"]()
        out.append(dict(row="sweep_unroll_K1_euler_ellis", unroll=u,
                        shipped=shipped,
                        **_timed(fns["kernel"], args, reps)))
        _emit(out[-1])
    march_pallas.UNROLL = shipped
    return out


def grad_rows():
    """bench.py's Kerr value_and_grad rows (kernel forward + XLA backward
    vs the checkpointed scan) at 256x144."""
    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    sys.path.insert(0, str(ROOT))
    import bench
    r = bench._grad_bench(jax, jnp, cv)
    _emit(dict(row="kerr_grad", **r))
    return [r]


def _emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help=f"rows among {sorted(ROWS)} and sweep_launch, "
                         "sweep_unroll, grad")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    from curvis_tpu.utils.cache import enable_compile_cache
    from curvis_tpu.utils.device import header_lines
    for line in header_lines(enable_compile_cache()):
        print(line, flush=True)
    only = args.only
    for name, make in ROWS.items():
        if only is not None and name not in only:
            continue
        fns, fargs = make()
        rec = {"row": name}
        for side, r in _timed_pair(fns, fargs, args.reps).items():
            rec.update({f"{side}_{k}": v for k, v in r.items()})
        rec["twin_over_kernel"] = rec["twin_ms"] / rec["kernel_ms"]
        _emit(rec)
    extra = {"sweep_launch": lambda: sweep_launch(args.reps),
             "sweep_unroll": lambda: sweep_unroll(args.reps),
             "grad": grad_rows}
    for name, fn in extra.items():
        if only is not None and name in only:
            fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
