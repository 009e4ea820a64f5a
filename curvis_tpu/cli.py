"""Command-line interface — the reference CLI surface on the JAX renderer.

Mirrors the reference command shape (cli.rs:3-25):

    curvis-tpu image  BG1 BG2 [OUTPUT_FOLDER] [-i IMAGE.toml] [-m METRIC.toml]
                      [-c CAMERA.toml] [-s SIM.toml] [--renderer ...]
    curvis-tpu video  BG1 BG2 [OUTPUT_FOLDER] [-v VIDEO.toml] [-m ...] ...
    curvis-tpu custom

plus additions: --renderer {symmetric,direct}, --filtering, --f64, --seam,
--gif.  Settings TOMLs fall back to packaged defaults when flags are
absent (cli.rs:211-281 semantics).

Run as `python -m curvis_tpu.cli ...` or via the `curvis-tpu` entry point.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="curvis-tpu",
                                description=__doc__.splitlines()[0])

    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("background_image_1", type=Path,
                        help="equirect background for the positive-l side")
        sp.add_argument("background_image_2", type=Path,
                        help="equirect background for the negative-l side")
        sp.add_argument("output_folder", type=Path, nargs="?",
                        default=Path.cwd())
        sp.add_argument("--settings", type=Path, default=None,
                        help="ONE all-in-one TOML with [image] [video] "
                             "[camera] [simulation] [metric] sections (any "
                             "subset; the reference's wishlist item). "
                             "Per-category flags below override their "
                             "section.")
        sp.add_argument("-m", "--metric-settings", type=Path, default=None)
        sp.add_argument("-c", "--camera-settings", type=Path, default=None)
        sp.add_argument("-s", "--simulation-settings", type=Path,
                        default=None)
        sp.add_argument("--renderer", choices=["symmetric", "direct"],
                        default="symmetric",
                        help="symmetric = the reference's efficient 1-D "
                             "reduction; direct = per-pixel march")
        sp.add_argument("--filtering", choices=["nearest", "bilinear"],
                        default="nearest")
        sp.add_argument("--seam", choices=["exact", "nearest_side"],
                        default="exact",
                        help="exact = reference black seam parity")
        sp.add_argument("--stepper", choices=["euler", "rk4", "rk45"],
                        default="euler",
                        help="euler = reference parity; rk45 = adaptive "
                             "quality mode (direct renderer)")
        sp.add_argument("--disk", action="store_true",
                        help="render an accretion disk (black-hole metrics)")
        sp.add_argument("--disk-color", choices=["tint", "blackbody"],
                        default="tint",
                        help="disk shading: tint = power-law emissivity x "
                             "fixed tint; blackbody = Shakura-Sunyaev T(r) "
                             "with Planck colors + chromatic Doppler shift")
        sp.add_argument("--disk-thickness", type=float, default=0.0,
                        help="finite-thickness slab shading (slab aspect; "
                             "0 = thin-disk model, planar renderers only)")
        sp.add_argument("--disk-volumetric", action="store_true",
                        help="true volumetric radiative transfer through a "
                             "flared Gaussian gas disk (per-step "
                             "emission/absorption; soft edges, "
                             "self-obscuration; planar renderers only)")
        sp.add_argument("--disk-h", type=float, default=0.08,
                        help="volumetric disk scale height H / r")
        sp.add_argument("--disk-starlight", action="store_true",
                        help="Lambertian reflection of the lensed sky off "
                             "the disk surface (shadowing by the hole and "
                             "the annulus, gravitational blueshift; "
                             "thin-crossing planar renderers)")
        sp.add_argument("--disk-albedo", type=float, nargs=3,
                        default=(0.4, 0.4, 0.4), metavar=("R", "G", "B"),
                        help="disk surface albedo for --disk-starlight")
        sp.add_argument("--camera-velocity", type=float, nargs=3,
                        default=None, metavar=("VX", "VY", "VZ"),
                        help="camera 3-velocity (fraction of c, world "
                             "frame): special-relativistic aberration + "
                             "Doppler brightness of the received field "
                             "(direct and kerr renderers)")
        sp.add_argument("--supersample", type=int, default=1,
                        help="k x k rays per pixel, box-filtered (direct "
                             "renderer anti-aliasing)")
        sp.add_argument("--adaptive-aa", type=float, default=0.0,
                        metavar="FRAC",
                        help="edge-adaptive antialiasing: re-render the "
                             "FRAC highest-contrast pixels at 3x3 sub-rays "
                             "(direct and kerr renderers; ~1+9*FRAC cost "
                             "vs 9x for --supersample 3)")
        sp.add_argument("--f64", action="store_true",
                        help="double precision (the XLA marches, on "
                             "whatever device is present)")
        sp.add_argument("--bg1-orient", type=float, nargs=6, default=None,
                        metavar=("FX", "FY", "FZ", "UX", "UY", "UZ"),
                        help="forward+up orientation of background 1 — "
                             "fixes the reference's 'backgrounds cannot be "
                             "rotated' limitation (README.md:106)")
        sp.add_argument("--bg2-orient", type=float, nargs=6, default=None,
                        metavar=("FX", "FY", "FZ", "UX", "UY", "UZ"),
                        help="forward+up orientation of background 2")
        sp.add_argument("--flip-negative", action="store_true",
                        help="mirror the negative-l background horizontally, "
                             "compensating the reference's known "
                             "negative-side flip (README.md:105)")

    img = sub.add_parser("image", help="render a single image")
    common(img)
    img.add_argument("-i", "--image-settings", type=Path, default=None)

    vid = sub.add_parser("video", help="render camera-path video frames")
    common(vid)
    vid.add_argument("-v", "--video-settings", type=Path, default=None)
    vid.add_argument("--gif", action="store_true",
                     help="assemble frames into a GIF when done")
    vid.add_argument("--clean", action="store_true",
                     help="delete pre-existing frames first (reference "
                          "behavior); default resumes")
    vid.add_argument("--frames-per-batch", type=int, default=1,
                     help="device-batch this many frames per dispatch "
                          "(direct/disk/symmetric renderers)")

    sub.add_parser("custom", help="custom-script hook (stub, like the "
                                  "reference's custom.rs)")
    return p


def _disk_params(args):
    """DiskParams from the --disk-* CLI knobs."""
    from curvis_tpu.render.disk import DiskParams
    return DiskParams(color_mode=args.disk_color,
                      thickness=args.disk_thickness,
                      volumetric=args.disk_volumetric, h_rel=args.disk_h,
                      starlight=args.disk_starlight,
                      albedo=tuple(args.disk_albedo))


def _load_common(args):
    import jax.numpy as jnp
    import curvis_tpu as cvt
    from curvis_tpu.config.settings import (CameraSettings, MetricSettings,
                                            SimulationSettings)

    for bg in (args.background_image_1, args.background_image_2):
        if not bg.exists():
            raise SystemExit(f"error: background image {bg} does not exist")
    dtype = jnp.float64 if args.f64 else jnp.float32
    if args.f64:
        import jax
        jax.config.update("jax_enable_x64", True)
    def orient(o):
        return (o[:3], o[3:]) if o else (None, None)

    f1, u1 = orient(args.bg1_orient)
    f2, u2 = orient(args.bg2_orient)
    bgp = cvt.load_spherical_image(args.background_image_1, forward=f1,
                                   up=u1, dtype=dtype)
    bgn = cvt.load_spherical_image(args.background_image_2, forward=f2,
                                   up=u2, dtype=dtype)
    if args.flip_negative:
        from curvis_tpu.env.spherical_image import SphericalImage
        bgn = SphericalImage(texture=bgn.texture[:, ::-1],
                             rotation=bgn.rotation)
    # one-file settings (wishlist): per-category flags override sections
    allinone = None
    if args.settings is not None:
        from curvis_tpu.config.settings import load_settings
        allinone = load_settings(args.settings)
    metric = (MetricSettings.from_toml(args.metric_settings)
              if args.metric_settings or allinone is None
              else allinone.metric).make()
    camera_s = (CameraSettings.from_toml(args.camera_settings)
                if args.camera_settings or allinone is None
                else allinone.camera)
    sim = (SimulationSettings.from_toml(args.simulation_settings)
           if args.simulation_settings or allinone is None
           else allinone.simulation)
    args.output_folder.mkdir(parents=True, exist_ok=True)
    return cvt, metric, bgp, bgn, camera_s, sim, dtype, allinone


def image_main(args) -> int:
    cvt, metric, bgp, bgn, camera_s, sim, dtype, allinone = _load_common(args)
    from curvis_tpu.config.settings import ImageSettings
    img_s = (ImageSettings.from_toml(args.image_settings)
             if args.image_settings or allinone is None else allinone.image)
    camera = cvt.make_camera(img_s.position, img_s.forward, img_s.up,
                             camera_s.focal_length, camera_s.diagonal,
                             camera_s.resolution_x, camera_s.resolution_y,
                             dtype=dtype)
    kw = dict(dt=sim.ray_integration_step,
              max_steps=sim.ray_integration_max_iterations,
              escape_radius=sim.escape_radius, filtering=args.filtering)
    from curvis_tpu.metrics.kerr import KerrMetric, KerrNewmanMetric
    if isinstance(metric, (KerrMetric, KerrNewmanMetric)):
        # Kerr has one exterior universe; bg2 is unused
        from curvis_tpu.render.kerr import render_kerr
        from curvis_tpu.render.disk import DiskParams
        kerr_kw = dict(dt=max(0.05, kw["dt"]), max_steps=kw["max_steps"],
                       escape_radius=kw["escape_radius"],
                       disk=_disk_params(args) if args.disk else None,
                       filtering=args.filtering,
                       camera_velocity=args.camera_velocity,
                       # BL marches have no Euler form: euler/rk4 -> fixed
                       # RK4, rk45 -> the error-controlled DP5(4) kernel
                       stepper="rk45" if args.stepper == "rk45" else "rk4")
        dp = kerr_kw["disk"]
        if dp is not None and dp.starlight:
            # the Kerr starlight map is camera-independent: compute it
            # once here (thin-disk reflection AND volumetric in-gas
            # scattering both require it precomputed)
            from curvis_tpu.render.starlight import (
                compute_kerr_starlight_map)
            kerr_kw["starlight_map"] = compute_kerr_starlight_map(
                metric, bgp, r_inner=dp.r_inner, r_outer=dp.r_outer,
                escape_radius=kw["escape_radius"],
                dt=kerr_kw["dt"], max_steps=kw["max_steps"],
                n_r=dp.starlight_grid[0], n_phi=dp.starlight_grid[1],
                n_samples=dp.starlight_samples, boost="orbit")
        if args.adaptive_aa > 0:
            from curvis_tpu.render.kerr import render_kerr_adaptive
            img = render_kerr_adaptive(metric, camera, bgp,
                                       refine_frac=args.adaptive_aa,
                                       **kerr_kw)
        else:
            img = render_kerr(metric, camera, bgp, **kerr_kw)
    elif args.disk:
        from curvis_tpu.render.disk import DiskParams, render_blackhole_disk
        img = render_blackhole_disk(metric, camera, bgp,
                                    disk=_disk_params(args), **kw)
    elif args.renderer == "symmetric":
        from curvis_tpu.render.symmetric import render_symmetric
        img = render_symmetric(
            metric, camera, bgp, bgn, alpha_nums=sim.sampling_initial_nums,
            max_iterations_sampling=sim.sampling_max_iterations,
            sampling_convergence_threshold_1=sim.sampling_convergence_threshold_1,
            sampling_convergence_threshold_2=sim.sampling_convergence_threshold_2,
            seam=args.seam, **kw)
    else:
        from curvis_tpu.render.fast import render_planar_fast
        if args.adaptive_aa > 0:
            from curvis_tpu.render.fast import render_planar_adaptive
            img = render_planar_adaptive(metric, camera, bgp, bgn,
                                         stepper=args.stepper,
                                         refine_frac=args.adaptive_aa,
                                         camera_velocity=args.camera_velocity,
                                         **kw)
        else:
            img = render_planar_fast(metric, camera, bgp, bgn,
                                     stepper=args.stepper,
                                     supersample=args.supersample,
                                     camera_velocity=args.camera_velocity,
                                     **kw)
    out = args.output_folder / f"{img_s.image_name}.png"
    cvt.save_image(np.asarray(img), out)
    print(f"saved {out}")
    return 0


def video_main(args) -> int:
    cvt, metric, bgp, bgn, camera_s, sim, dtype, allinone = _load_common(args)
    from curvis_tpu.config.settings import VideoSettings
    from curvis_tpu.camera.path import load_path
    from curvis_tpu.render.video import render_video_frames
    from curvis_tpu.render.disk import DiskParams
    vid_s = (VideoSettings.from_toml(args.video_settings)
             if args.video_settings or allinone is None else allinone.video)
    from curvis_tpu.metrics.kerr import KerrMetric, KerrNewmanMetric
    if isinstance(metric, (KerrMetric, KerrNewmanMetric)):
        args.renderer = "kerr"   # no symmetry reduction; bg2 unused
    elif args.disk:
        args.renderer = "disk"   # disk video mode
    if not vid_s.filepath_to_camera_path:
        raise SystemExit("error: video settings must provide "
                         "filepath_to_camera_path")
    path = load_path(vid_s.filepath_to_camera_path)
    frames = render_video_frames(
        metric, path, bgp, bgn, args.output_folder,
        frame_rate=vid_s.frame_rate,
        resolution=(camera_s.resolution_x, camera_s.resolution_y),
        focal_length=camera_s.focal_length,
        sensor_diagonal=camera_s.diagonal,
        dt=sim.ray_integration_step,
        max_steps=sim.ray_integration_max_iterations,
        escape_radius=sim.escape_radius, renderer=args.renderer,
        filtering=args.filtering,
        alpha_nums=sim.sampling_initial_nums,
        max_iterations_sampling=sim.sampling_max_iterations,
        sampling_convergence_threshold_1=sim.sampling_convergence_threshold_1,
        sampling_convergence_threshold_2=sim.sampling_convergence_threshold_2,
        seam=args.seam, resume=not args.clean, clean=args.clean, dtype=dtype,
        stepper=args.stepper, frames_per_batch=args.frames_per_batch,
        disk=_disk_params(args) if args.disk else None)
    print(f"rendered {len(frames)} frames into {args.output_folder / 'tmp'}")
    if args.gif:
        from curvis_tpu.utils.assemble import assemble_gif
        gif = assemble_gif(args.output_folder / "tmp",
                           args.output_folder / f"{vid_s.video_name}.gif",
                           vid_s.frame_rate)
        print(f"assembled {gif}")
    return 0


def custom_main(args) -> int:
    # parity with the reference stub (custom.rs:4-8)
    print("error: custom_main() is not implemented. Modify "
          "curvis_tpu/cli.py:custom_main to use it.", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from curvis_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.command == "image":
        return image_main(args)
    if args.command == "video":
        return video_main(args)
    return custom_main(args)


if __name__ == "__main__":
    sys.exit(main())
