#!/usr/bin/env python
"""Smoke run of the render path on the GPU: the quickest proof that the
system still starts on the card, with every kernel compiled for it.

    python chip_smoke.py           # one card: phases 1-5
    python chip_smoke.py --four    # four cards: the multi-card paths only

Phases (one card):
  1. header   — nvidia-smi name and power limit, JAX version and devices,
                XLA_FLAGS, the compile-cache directory;
  2. cli      — ``python -m curvis_tpu.cli image`` (in this process) with
                the packaged defaults (960x540, dt 0.05, 40k steps, R 100,
                camera at l=5) for Ellis and the Interstellar metric, with
                the symmetric and the direct renderer, on two seeded
                2048x1024 PNG skies.  Checks: no black pixel, Ellis
                negative-universe share in [3 %, 5 %], and the direct
                render's escape directions against the XLA twin;
  3. kernels  — every parity gate (benchmarks/parity_gates.py) at the
                README's frame sizes, with compile time and memory
                analysis per family;
  4. video    — render/video.py, a 4-frame orbit at 960x540 with
                frames_per_batch=4, PNGs written;
  5. gradient — one value_and_grad of Kerr spin through
                render_kerr(backend='adjoint') at 256x144 against central
                finite differences.
``--four`` runs render_frames_shardmap on a 4-card ('frames', 'rays') mesh
and make_kerr_train_step on 4 cards, each against one card, and the
multi-process render as 4 processes with one card each.

Any failure exits non-zero.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.  Outputs go
to chiprun_out/smoke/ in the checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "smoke"
DEFAULTS = ROOT / "curvis_tpu" / "config" / "defaults"
SKY = (1024, 2048)                       # (H, W) of each seeded background


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(name):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"== {name}: ok in {time.perf_counter() - t0:.1f} s")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def make_skies(out, seed=0, shape=SKY):
    """Two seeded skies whose origin a pixel's color tells: the positive
    side red-dominant, the negative side blue-dominant."""
    from curvis_tpu.utils.png import write_png
    rng = np.random.default_rng(seed)
    h, w = shape
    hi = rng.integers(128, 256, (h, w), dtype=np.uint8)
    lo = rng.integers(0, 64, (h, w), dtype=np.uint8)
    mid = rng.integers(32, 160, (h, w), dtype=np.uint8)
    pos, neg = out / "sky_positive.png", out / "sky_negative.png"
    write_png(pos, np.stack([hi, mid, lo], -1))
    write_png(neg, np.stack([lo, mid, hi], -1))
    return pos, neg


def cli_render(bg1, bg2, out, metric_toml, renderer):
    from curvis_tpu.cli import main as cli_main
    from curvis_tpu.utils.png import read_png
    out.mkdir(parents=True, exist_ok=True)
    rc = cli_main(["image", str(bg1), str(bg2), str(out), "-m",
                   str(metric_toml), "--renderer", renderer])
    check(rc == 0, f"cli exited {rc}")
    return read_png(out / "output_image.png")


def direct_vs_twin(metric_toml, res=(960, 540)):
    """Escape directions of the direct render's kernel against the XLA
    twin, on the packaged camera: the gate bounds of parity_gates.py."""
    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.config.settings import (ImageSettings, MetricSettings,
                                            SimulationSettings)
    from curvis_tpu.ops.march_pallas import march_planar_pallas
    from curvis_tpu.physics import planar as pl
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from parity_gates import _escape_mismatch
    metric = MetricSettings.from_toml(metric_toml).make()
    metric = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), metric)
    img = ImageSettings.from_toml(DEFAULTS / "image_settings.toml")
    sim = SimulationSettings.from_toml(DEFAULTS / "simulation_settings.toml")
    cam = cv.make_camera(img.position, img.forward, img.up, 15.0, 43.0,
                         res[0], res[1], dtype=jnp.float32)
    dx, dy, dz = _pixel_dirs_soa(cam, False)
    (l, psi, p_l, b), _, _ = _spawn_planar_soa(metric, cam, dx, dy, dz)
    rays = pl.PlanarRays(l, psi, p_l, b, jnp.zeros((1, 3), jnp.float32),
                         jnp.zeros((1, 3), jnp.float32))
    kw = dict(dt=sim.ray_integration_step,
              max_steps=sim.ray_integration_max_iterations,
              escape_radius=sim.escape_radius)
    a = jax.jit(lambda m, r: pl.march_planar_while(m, r, **kw))(metric,
                                                                rays)
    k = jax.jit(lambda m, r: march_planar_pallas(m, r, **kw))(
        metric, rays)
    agree, mm = _escape_mismatch(a, k, tol=1e-3)
    log(f"   direct vs XLA twin: sign agreement {agree}, escaped rays "
        f"with |dpsi| > 1e-3: {mm}")
    check(agree >= 0.97 and mm <= 0.05, "direct render disagrees with the "
          "XLA twin beyond the gate bounds")


def cli_phase(out, res=(960, 540)):
    bg1, bg2 = make_skies(out)
    metrics = {"ellis": DEFAULTS / "ellis_metric_settings.toml",
               "interstellar": DEFAULTS / "interstellar_metric_settings.toml"}
    for name, toml in metrics.items():
        for renderer in ("symmetric", "direct"):
            t0 = time.perf_counter()
            img = cli_render(bg1, bg2, out / f"{name}_{renderer}", toml,
                             renderer).astype(np.int32)
            black = int((img.sum(-1) == 0).sum())
            neg = float((img[..., 2] > img[..., 0]).mean())
            log(f"   {name} {renderer}: {img.shape[1]}x{img.shape[0]} in "
                f"{time.perf_counter() - t0:.1f} s (compile included), "
                f"black pixels {black}, negative-universe share {neg:.4f}")
            check(img.shape[:2] == (res[1], res[0]), "wrong image size")
            check(black == 0, f"{name} {renderer}: {black} black pixels")
            if name == "ellis":
                check(0.03 <= neg <= 0.05, f"Ellis negative share {neg}")
        direct_vs_twin(toml, res)


def gates_phase(full=True):
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from parity_gates import run_gates
    res = run_gates(full=full)
    for name, r in res.items():
        log(f"   {name}: {json.dumps(r)}")
    bad = [k for k, v in res.items() if not v.get("ok")]
    check(not bad, f"parity gates failed: {bad}")


def video_phase(out, res=(960, 540), frames=4):
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.camera.path import CameraPath, generate_orbit_path
    from curvis_tpu.render.video import render_video_frames
    from curvis_tpu.utils.png import read_png
    orbit = generate_orbit_path(l=5.0, period=60.0, n=1000)
    keep = orbit.positions[:, 0] <= (frames + 0.6) / 30.0
    path = CameraPath(orbit.positions[keep], orbit.forwards[keep],
                      orbit.ups[keep])
    bg1, bg2 = out / "sky_positive.png", out / "sky_negative.png"
    bgp = cv.load_spherical_image(bg1, dtype=jnp.float32)
    bgn = cv.load_spherical_image(bg2, dtype=jnp.float32)
    t0 = time.perf_counter()
    written = render_video_frames(
        cv.make_metric("ellis", rho=1.0), path, bgp, bgn, out / "video",
        frame_rate=30.0, resolution=res, renderer="symmetric",
        frames_per_batch=frames, clean=True, progress=False)
    log(f"   {len(written)} frames in {time.perf_counter() - t0:.1f} s "
        f"(compile included)")
    check(len(written) == frames, f"{len(written)} frames, want {frames}")
    for p in written:
        img = read_png(p)
        check(img.shape[:2] == (res[1], res[0]), f"{p}: wrong size")
        check(int((img.sum(-1) == 0).sum()) == 0, f"{p}: black pixels")


def grad_phase(res=(256, 144), eps=1e-2, rtol=2e-2):
    """d mean(image) / d spin through render_kerr(backend='adjoint') (the
    kernel forward with the XLA backward) vs a central difference of the
    same forward.  Tolerance 2 %: float32 forward, eps = 1e-2 (truncation
    ~eps^2, round-off ~1e-7 / eps), and per-ray step counts that move
    discretely with the spin."""
    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.metrics.kerr import KerrMetric
    from curvis_tpu.render.kerr import render_kerr
    w, h = res
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([np.sin(2 * np.pi * xx / w) * 0.5 + 0.5, yy / h,
                       0.3 + 0.4 * np.cos(2 * np.pi * yy / h)], -1)
    bg = cv.make_spherical_image(np.asarray(smooth, np.float32))
    th = np.pi / 2 - 0.3
    f = np.array([-np.sin(th), 1.3, -np.cos(th)])
    f /= np.linalg.norm(f)
    cam = cv.make_camera([0.0, 15.0, th, 0.0], list(f), [0.0, 0.0, 1.0],
                         35.0, 43.0, w, h, dtype=jnp.float32)

    def loss(a):
        m = KerrMetric(m=jnp.asarray(1.0, jnp.float32), a=a)
        img = render_kerr(m, cam, bg, dt=0.1, max_steps=800,
                          escape_radius=20.0, backend="adjoint")
        return jnp.mean(img)

    a0 = jnp.asarray(0.7, jnp.float32)
    vg = jax.jit(jax.value_and_grad(loss))
    v, g = vg(a0)
    lo, hi = (float(jax.jit(loss)(a0 + s * eps)) for s in (-1.0, 1.0))
    fd = (hi - lo) / (2 * eps)
    rel = abs(float(g) - fd) / max(abs(fd), 1e-12)
    log(f"   loss {float(v):.6f}, adjoint grad {float(g):.6f}, central "
        f"difference {fd:.6f} (eps {eps}), relative error {rel:.4f} "
        f"(tolerance {rtol})")
    check(np.isfinite(float(g)) and rel <= rtol, "gradient check failed")


def four_phase(out):
    """The multi-card paths, each against one card."""
    import jax
    import jax.numpy as jnp
    import curvis_tpu as cv
    from curvis_tpu.parallel.mesh import make_mesh, make_mesh_2d
    from curvis_tpu.parallel.sharded import (make_kerr_train_step,
                                             render_frames_shardmap)
    from curvis_tpu.render.fast import render_planar_fast
    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 cards, JAX sees {len(devs)}")
    bgp = cv.load_spherical_image(out / "sky_positive.png")
    bgn = cv.load_spherical_image(out / "sky_negative.png")
    metric = cv.EllisMetric(rho=jnp.asarray(1.0, jnp.float32))
    cams = [cv.make_camera([0.0, 5.0, np.pi / 2, 0.02 * k], [-1.0, 0.0, 0.0],
                           [0.0, 0.0, 1.0], 15.0, 43.0, 960, 540,
                           dtype=jnp.float32) for k in range(4)]
    kw = dict(dt=0.05, max_steps=40_000, escape_radius=100.0,
              filtering="nearest")
    with phase("four: render_frames_shardmap on a (2 frames x 2 rays) mesh"):
        mesh2 = make_mesh_2d(2, 2)
        f4 = jax.jit(lambda m, bp, bn: render_frames_shardmap(
            m, cams, bp, bn, mesh2, **kw))(metric, bgp, bgn)
        one = jax.jit(lambda m, c, bp, bn: render_planar_fast(
            m, c, bp, bn, **kw))
        ref = np.stack([np.asarray(one(metric, c, bgp, bgn)) for c in cams])
        d = np.abs(np.asarray(f4) - ref).max(-1)
        mm = float((d > 0.02).mean())
        log(f"   4-card vs 1-card frames: shape {f4.shape}, pixels > 0.02 "
            f"apart {mm:.5f}")
        check(f4.shape == (4, 540, 960, 3) and mm < 0.01,
              "4-card frames disagree with one card")
    with phase("four: make_kerr_train_step on 4 cards vs 1"):
        from curvis_tpu.metrics.kerr import KerrMetric
        th = float(np.pi / 2 - 0.25)
        gcams = [cv.make_camera([0.0, 15.0, th, 0.0],
                                [-np.sin(th), 1.3, -np.cos(th)],
                                [0.0, 0.0, 1.0], 35.0, 43.0, 256, 144,
                                dtype=jnp.float32)]
        yy, xx = np.mgrid[0:144, 0:256]
        smooth = np.stack([np.sin(2 * np.pi * xx / 256) * 0.5 + 0.5,
                           yy / 144, 0.3 + 0.4 * np.cos(2 * np.pi * yy / 144)],
                          -1)
        bg = cv.make_spherical_image(np.asarray(smooth, np.float32))
        k0 = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.5, jnp.float32))
        kt = KerrMetric(m=jnp.asarray(1.0, jnp.float32),
                        a=jnp.asarray(0.8, jnp.float32))
        from curvis_tpu.render.kerr import render_kerr
        target = jax.jit(lambda m: render_kerr(
            m, gcams[0], bg, dt=0.2, max_steps=400,
            escape_radius=30.0))(kt)[None]
        got = {}
        for n in (4, 1):
            mesh = make_mesh(n)
            step = jax.jit(make_kerr_train_step(
                mesh, dt=0.2, max_steps=400, escape_radius=30.0, lr=5.0,
                use_pallas=True))
            k1, loss = step(k0, gcams, bg, target)
            got[n] = (float(loss), float(k1.a))
        log(f"   loss, updated spin: 4 cards {got[4]}, 1 card {got[1]}")
        check(all(np.isfinite(got[4])) and got[4][1] != 0.5,
              "4-card train step did not move the spin")
        check(abs(got[4][0] - got[1][0]) <= 1e-4 * max(abs(got[1][0]), 1e-6)
              and abs(got[4][1] - got[1][1]) <= 1e-3,
              "4-card train step disagrees with one card")


def four_multiproc(out):
    """4 processes with one card each (this process stays off the cards
    until they exit)."""
    from curvis_tpu.parallel.multiproc import run_multiprocess_render
    stats = run_multiprocess_render(out / "multiproc", n_processes=4,
                                    platform="gpu", timeout=600)
    for s in stats:
        log(f"   {s}")
    check(all(s["process_count"] == 4 and s["local_devices"] == 1
              and sorted(s["allgather"]) == [0, 1, 2, 3] for s in stats),
          "process group did not form over 4 cards")


def four_multiproc_check(out):
    from curvis_tpu.parallel.distributed import assemble_tiles
    from curvis_tpu.parallel.multiproc import (DEMO_RES,
                                               render_demo_single_process)
    img = assemble_tiles(out / "multiproc", DEMO_RES[0], DEMO_RES[1])
    ref = render_demo_single_process()
    mm = float((np.abs(img - ref).max(-1) > 0.02).mean())
    log(f"   4-process assembly vs 1 process: pixels > 0.02 apart {mm}")
    check(img.shape == ref.shape and mm < 0.01,
          "4-process assembly disagrees with one process")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)
    from curvis_tpu.utils.device import nvidia_smi_line
    log(nvidia_smi_line())
    if args.four:
        with phase("four: multiprocess render, 4 processes x 1 card"):
            make_skies(OUT)
            four_multiproc(OUT)
    from curvis_tpu.utils.cache import enable_compile_cache
    from curvis_tpu.utils.device import header_lines, require_gpu
    with phase("header"):
        for line in header_lines(enable_compile_cache())[1:]:
            log(line)
    device = require_gpu()
    if args.four:
        four_multiproc_check(OUT)
        four_phase(OUT)
    else:
        with phase("cli"):
            cli_phase(OUT)
        with phase("kernels"):
            gates_phase()
        with phase("video"):
            video_phase(OUT)
        with phase("gradient"):
            grad_phase()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
