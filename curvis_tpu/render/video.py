"""Video rendering pipeline: camera-path playback to per-frame PNGs.

Re-design of the reference VideoRenderingSystem (rendering.rs:170-328) with
the fixes/upgrades called out in SURVEY.md section 5:

  - frames are *idempotent checkpoints*: existing frames are skipped on
    restart (the reference deletes tmp/ and restarts from scratch,
    rendering.rs:276-287) and a manifest records progress;
  - frame timestamps come from an integer grid (no accumulated float error /
    last-frame panic, README.md:107);
  - the per-frame sampling thresholds are wired correctly (the reference
    passes threshold_1 twice, rendering.rs:305-306);
  - frames can be rendered in device-side batches (the frame axis is the
    natural extra parallel axis, SURVEY.md section 2) with the direct, disk
    and symmetric renderers — the symmetric batch runs all frames' adaptive
    refinements in lock-step inside one jitted program.

Video assembly (frames -> mp4/gif) lives in utils/assemble.py — the reference
leaves assembly to an out-of-repo OpenCV script (rendering.rs:318-319,
utils/video_merge.py).
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

import curvis_tpu as cv
from curvis_tpu.camera.path import CameraPath
from curvis_tpu.env.spherical_image import SphericalImage, save_image
from curvis_tpu.metrics.base import Metric
from curvis_tpu.utils.log import get_logger


def _kerr_video_smap(metric, bg, disk, dt, max_steps, escape_radius):
    """Once-per-clip Kerr starlight map (camera-independent) for starlit
    BL video frames — thin-disk reflection and in-gas scattering both
    require it precomputed."""
    from curvis_tpu.render.starlight import compute_kerr_starlight_map
    return compute_kerr_starlight_map(
        metric, bg, r_inner=disk.r_inner, r_outer=disk.r_outer,
        escape_radius=escape_radius, dt=max(0.05, dt), max_steps=max_steps,
        n_r=disk.starlight_grid[0], n_phi=disk.starlight_grid[1],
        n_samples=disk.starlight_samples, boost="orbit")

log = get_logger("video")


def render_video_frames(metric: Metric, path: CameraPath,
                        bg_positive: SphericalImage,
                        bg_negative: SphericalImage, output_folder, *,
                        frame_rate=30.0, resolution=(960, 540),
                        focal_length=15.0, sensor_diagonal=43.0,
                        dt=0.05, max_steps=40_000, escape_radius=100.0,
                        renderer="symmetric", filtering="nearest",
                        alpha_nums=100, max_iterations_sampling=50,
                        sampling_convergence_threshold_1=1e-5,
                        sampling_convergence_threshold_2=1e-5,
                        seam="exact", resume=True, clean=False,
                        dtype=jnp.float32, progress=True,
                        frames_per_batch=1, stepper="euler", disk=None):
    """Render every frame of the camera path into <output_folder>/tmp/.

    Returns the list of frame file paths.  ``resume=True`` skips frames whose
    PNG already exists; ``clean=True`` reproduces the reference behavior of
    deleting any pre-existing tmp folder first.
    """
    out = Path(output_folder)
    tmp = out / "tmp"
    if clean and tmp.exists():
        import shutil
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    manifest_path = out / "manifest.json"

    times = path.frame_times(frame_rate)
    frames = []
    manifest = {"frame_rate": frame_rate, "n_frames": len(times),
                "resolution": list(resolution), "frames": {}}
    if resume and manifest_path.exists():
        try:
            manifest.update(json.loads(manifest_path.read_text()))
        except Exception:
            pass

    log.info("rendering %d frames at %s fps -> %s", len(times), frame_rate,
             tmp)
    if renderer in ("direct", "disk", "symmetric", "kerr") \
            and frames_per_batch > 1:
        return _render_frames_device_batched(
            metric, path, bg_positive, bg_negative, times, tmp, manifest,
            manifest_path, frames_per_batch, resolution, focal_length,
            sensor_diagonal, dt, max_steps, escape_radius, filtering, resume,
            dtype, progress, renderer=renderer, stepper=stepper, disk=disk,
            alpha_nums=alpha_nums,
            max_iterations_sampling=max_iterations_sampling,
            thr1=sampling_convergence_threshold_1,
            thr2=sampling_convergence_threshold_2, seam=seam)
    smap = None
    if renderer == "disk" and disk is not None and disk.starlight:
        # camera-independent: one illumination integral for the whole video
        from curvis_tpu.render.disk import compute_starlight_map
        smap = compute_starlight_map(
            metric, bg_positive, disk, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, filtering=filtering)
    elif renderer == "kerr" and disk is not None and disk.starlight:
        smap = _kerr_video_smap(metric, bg_positive, disk, dt, max_steps,
                                escape_radius)
    for i, t in enumerate(times):
        frame_path = tmp / f"frame_{i}.png"
        frames.append(frame_path)
        if resume and frame_path.exists():
            continue
        pos, fwd, up = path.interpolate(float(t))
        camera = cv.make_camera(pos, fwd, up, focal_length, sensor_diagonal,
                                resolution[0], resolution[1], dtype=dtype)
        t0 = time.time()
        if renderer == "symmetric":
            from curvis_tpu.render.symmetric import render_symmetric
            img = render_symmetric(
                metric, camera, bg_positive, bg_negative, dt=dt,
                max_steps=max_steps, escape_radius=escape_radius,
                alpha_nums=alpha_nums,
                max_iterations_sampling=max_iterations_sampling,
                sampling_convergence_threshold_1=sampling_convergence_threshold_1,
                sampling_convergence_threshold_2=sampling_convergence_threshold_2,
                filtering=filtering, seam=seam)
        elif renderer == "direct":
            from curvis_tpu.render.fast import render_planar_fast
            img = render_planar_fast(metric, camera, bg_positive, bg_negative,
                                     dt=dt, max_steps=max_steps,
                                     escape_radius=escape_radius,
                                     filtering=filtering, stepper=stepper)
        elif renderer == "disk":
            from curvis_tpu.render.disk import render_blackhole_disk
            img = render_blackhole_disk(metric, camera, bg_positive,
                                        dt=dt, max_steps=max_steps,
                                        escape_radius=escape_radius,
                                        filtering=filtering, disk=disk,
                                        starlight_map=smap)
        elif renderer == "kerr":
            from curvis_tpu.render.kerr import render_kerr
            img = render_kerr(metric, camera, bg_positive, dt=dt,
                              max_steps=max_steps,
                              escape_radius=escape_radius,
                              filtering=filtering, disk=disk,
                              starlight_map=smap,
                              stepper="rk45" if stepper == "rk45" else "rk4")
        else:
            raise ValueError(f"unknown renderer {renderer!r}")
        save_image(np.asarray(img), frame_path)
        manifest["frames"][str(i)] = {"t": float(t),
                                      "secs": round(time.time() - t0, 3)}
        manifest_path.write_text(json.dumps(manifest, indent=1))
        if progress:
            log.info("frame %d/%d (t=%.3f) in %.2fs", i + 1, len(times),
                     t, time.time() - t0)
    return frames


def _render_frames_device_batched(metric, path, bg_positive, bg_negative,
                                  times, tmp, manifest, manifest_path,
                                  frames_per_batch, resolution, focal_length,
                                  sensor_diagonal, dt, max_steps,
                                  escape_radius, filtering, resume, dtype,
                                  progress, renderer="direct",
                                  stepper="euler", disk=None, alpha_nums=100,
                                  max_iterations_sampling=50, thr1=1e-5,
                                  thr2=1e-5, seam="exact"):
    """Direct, disk or symmetric renderer, ``frames_per_batch`` poses per
    device call — the frame axis batched into one march bundle
    (render/fast.py + render/disk.py) or one lock-step adaptive refinement
    (render/symmetric.py); supports the rk45 stepper (direct)."""
    import jax
    from curvis_tpu.render.fast import render_frames_batched

    frames = [tmp / f"frame_{i}.png" for i in range(len(times))]
    if renderer == "symmetric":
        from curvis_tpu.render.symmetric import \
            render_symmetric_frames_batched

        def jit_batch(m, cams, bp, bn):
            return render_symmetric_frames_batched(
                m, cams, bp, bn, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, alpha_nums=alpha_nums,
                max_iterations_sampling=max_iterations_sampling,
                sampling_convergence_threshold_1=thr1,
                sampling_convergence_threshold_2=thr2,
                filtering=filtering, seam=seam, stepper=stepper)
    elif renderer == "disk":
        from curvis_tpu.render.disk import (compute_starlight_map,
                                            render_disk_frames_batched)
        # the starlight map is camera-independent: one compute for the
        # whole video (instead of one per batch inside the call)
        smap = compute_starlight_map(
            metric, bg_positive, disk, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, filtering=filtering) \
            if (disk is not None and disk.starlight) else None

        def jit_batch(m, cams, bp, bn):
            return render_disk_frames_batched(
                m, cams, bp, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, filtering=filtering, disk=disk,
                starlight_map=smap)
    elif renderer == "kerr":
        from curvis_tpu.render.kerr import render_kerr_frames_batched
        # Kerr starlight map: camera-independent, hoisted once per clip
        # (same contract as the planar hoist above)
        smap = _kerr_video_smap(metric, bg_positive, disk, dt, max_steps,
                                escape_radius) \
            if (disk is not None and disk.starlight) else None

        def jit_batch(m, cams, bp, bn):
            return render_kerr_frames_batched(
                m, cams, bp, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, filtering=filtering, disk=disk,
                starlight_map=smap,
                stepper="rk45" if stepper == "rk45" else "rk4")
    else:
        jit_batch = jax.jit(lambda m, cams, bp, bn: render_frames_batched(
            m, cams, bp, bn, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, filtering=filtering,
            stepper=stepper))
    for start in range(0, len(times), frames_per_batch):
        idxs = [i for i in range(start, min(start + frames_per_batch,
                                            len(times)))
                if not (resume and frames[i].exists())]
        if not idxs:
            continue
        # pad the final partial batch with repeats to keep one compiled shape
        padded = idxs + [idxs[-1]] * (frames_per_batch - len(idxs))
        cams = []
        for i in padded:
            pos, fwd, up = path.interpolate(float(times[i]))
            cams.append(cv.make_camera(pos, fwd, up, focal_length,
                                       sensor_diagonal, resolution[0],
                                       resolution[1], dtype=dtype))
        t0 = time.time()
        imgs = np.asarray(jit_batch(metric, cams, bg_positive, bg_negative))
        secs = time.time() - t0
        for k, i in enumerate(idxs):
            save_image(imgs[k], frames[i])
            manifest["frames"][str(i)] = {
                "t": float(times[i]),
                "secs": round(secs / len(idxs), 3)}
        manifest_path.write_text(json.dumps(manifest, indent=1))
        if progress:
            log.info("frames %s in %.2fs (batched)", idxs, secs)
    return frames
