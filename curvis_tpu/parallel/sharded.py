"""Multi-device rendering and differentiable training steps.

The ray bundle (H*W pixels) is sharded across the mesh's 'rays' axis; the
march runs embarrassingly parallel per shard (XLA GSPMD — no communication in
the forward pass), and in gradient mode the parameter gradients are
all-reduced (psum over ICI) automatically by GSPMD when the loss reduces over
the sharded axis.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from curvis_tpu.camera.camera import Camera, pixel_rays_world
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.parallel.mesh import pad_to_multiple, shard_rays
from curvis_tpu.physics import planar as pl
from curvis_tpu.render.direct import shade
from curvis_tpu.geometry.rotations import normalize


def render_direct_sharded(metric, camera: Camera, bg_positive: SphericalImage,
                          bg_negative: SphericalImage, mesh: Mesh, *, dt,
                          max_steps, escape_radius, stepper="euler",
                          filtering="nearest", differentiable=False):
    """Planar direct render with the ray axis sharded over ``mesh``.

    Jit-compatible; call under ``jax.jit`` (GSPMD partitions the march).
    """
    n_dev = mesh.devices.size
    d_world = pixel_rays_world(camera)                     # (N, 3)
    rays = pl.spawn_planar(metric, camera.position, d_world)
    n_rays = rays.l.shape[0]
    padded = jax.tree_util.tree_map(
        lambda a: pad_to_multiple(a, n_dev, axis=0)[0], rays)
    padded = pl.PlanarRays(*shard_rays(tuple(padded), mesh))
    marcher = pl.march_planar_scan if differentiable else pl.march_planar_while
    res = marcher(metric, padded, dt=dt, max_steps=max_steps,
                  escape_radius=escape_radius, stepper=stepper)
    w = normalize(pl.planar_world_directions(metric, padded, res))
    colors = shade(bg_positive, bg_negative, w, res.sign, filtering=filtering)
    colors = colors[:n_rays]
    W, H = camera.resolution_x, camera.resolution_y
    return colors.reshape(W, H, 3).transpose(1, 0, 2)


def render_direct_shardmap(metric, camera: Camera,
                           bg_positive: SphericalImage,
                           bg_negative: SphericalImage, mesh: Mesh, *, dt,
                           max_steps, escape_radius, filtering="nearest",
                           stepper="euler", use_pallas="auto"):
    """Explicit-collectives variant: `shard_map` over the ray axis with the
    *Pallas kernel running per shard* — the production multi-card path
    (GSPMD cannot partition a pallas_call; shard_map gives each device its
    own kernel launch over its ray shard).  ``use_pallas='auto'`` follows
    the dispatch rule (curvis_tpu/dispatch.py); on the CPU a forced kernel
    runs in interpret mode (virtual-mesh testing).
    """
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from jax.sharding import PartitionSpec as P
    from curvis_tpu.dispatch import use_kernel
    from curvis_tpu.render.fast import (_pixel_dirs_soa,
                                        _spawn_planar_soa)

    if use_pallas == "auto":
        use_pallas = use_kernel(camera.position.dtype)
    n_dev = mesh.devices.size
    dx, dy, dz = _pixel_dirs_soa(camera)
    (l, psi, p_l, b), r_hat, e2 = _spawn_planar_soa(metric, camera, dx, dy,
                                                    dz)
    n = l.shape[0]
    l, _ = pad_to_multiple(l, n_dev)
    psi, _ = pad_to_multiple(psi, n_dev)
    p_l, _ = pad_to_multiple(p_l, n_dev)
    b, _ = pad_to_multiple(b, n_dev)

    def _march_shard(metric, l, psi, p_l, b):
        rays = pl.PlanarRays(l, psi, p_l, b, jnp.zeros((1, 3), l.dtype),
                             jnp.zeros((1, 3), l.dtype))
        if use_pallas and stepper == "euler":
            from curvis_tpu.ops.march_pallas import march_planar_pallas
            res = march_planar_pallas(metric, rays, dt=dt,
                                      max_steps=max_steps,
                                      escape_radius=escape_radius)
        else:
            res = pl.march_planar_while(metric, rays, dt=dt,
                                        max_steps=max_steps,
                                        escape_radius=escape_radius,
                                        stepper=stepper)
        return res.l, res.psi, res.p_l, res.sign, res.steps

    marched = _shard_map(
        _march_shard, mesh=mesh,
        in_specs=(P(), P("rays"), P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"),) * 5,
        check_vma=False)
    lo, psio, plo, sign, steps = marched(metric, l, psi, p_l, b)
    lo, psio, plo, sign = (a[:n] for a in (lo, psio, plo, sign))
    res = pl.PlanarResult(lo, psio, plo, sign, steps[:n])
    # readout + shade on the (replicated) tail of the pipeline
    return _finish_from_result(metric, camera, bg_positive, bg_negative,
                               res, b[:n], r_hat, e2, filtering)


def render_frames_sharded(metric, cameras, bg_positive: SphericalImage,
                          bg_negative: SphericalImage, mesh: Mesh, *, dt,
                          max_steps, escape_radius, stepper="euler",
                          filtering="nearest"):
    """Video-workload sharding: F frames on a 2-D ('frames', 'rays') mesh
    (parallel.mesh.make_mesh_2d) -> (F, H, W, 3).

    Each frame's ray bundle is split over the 'rays' axis while whole frames
    spread over 'frames' — the two natural parallel axes of the reference's
    video loop (rendering.rs:291-316).  Forward pass is collective-free;
    jit-compatible.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from curvis_tpu.parallel.mesh import FRAMES, RAYS
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa

    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    states = []
    for cam in cams:
        dx, dy, dz = _pixel_dirs_soa(cam)
        states.append(_spawn_planar_soa(metric, cam, dx, dy, dz))
    F = len(cams)
    n = W * H

    def stack_state(i):
        return jnp.stack([s[0][i] for s in states])          # (F, N)

    l, psi, p_l, b = (stack_state(i) for i in range(4))
    sh = NamedSharding(mesh, P(FRAMES, RAYS))
    l, psi, p_l, b = (jax.lax.with_sharding_constraint(a, sh)
                      for a in (l, psi, p_l, b))
    rays = pl.PlanarRays(l, psi, p_l, b, jnp.zeros((1, 3), l.dtype),
                         jnp.zeros((1, 3), l.dtype))
    res = pl.march_planar_while(metric, rays, dt=dt, max_steps=max_steps,
                                escape_radius=escape_radius, stepper=stepper)
    # per-frame scalar bases broadcast to their ray blocks, then flatten
    def chain(idx, comp):
        return jnp.stack([jnp.broadcast_to(s[idx][comp], (n,))
                          for s in states]).reshape(-1)

    flat = pl.PlanarResult(*(a.reshape(-1) for a in res))
    img = _finish_from_result(metric, cams[0], bg_positive, bg_negative,
                              flat, b.reshape(-1),
                              (chain(1, 0), chain(1, 1), chain(1, 2)),
                              (chain(2, 0), chain(2, 1), chain(2, 2)),
                              filtering, n_frames=F)
    return img


def render_frames_shardmap(metric, cameras, bg_positive: SphericalImage,
                           bg_negative: SphericalImage, mesh: Mesh, *, dt,
                           max_steps, escape_radius, filtering="nearest",
                           use_pallas="auto"):
    """Multi-card video path: ('frames', 'rays') mesh with ONE Pallas
    kernel launch per device over its (local frames x local rays) block —
    the shard_map twin of :func:`render_frames_sharded`.  GSPMD cannot
    partition a ``pallas_call``, so the GSPMD variant marches at XLA speed
    while this one keeps every card on the kernel (same rule as
    render_direct_shardmap / the Kerr wrappers).

    Reference context: the video loop renders frames serially on one
    thread (/root/reference/src/rendering.rs:291-316); here F frames x N
    rays spread over both mesh axes with a collective-free forward.
    ``F`` must divide evenly over the 'frames' axis; the ray axis is
    padded."""
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from jax.sharding import PartitionSpec as P
    from curvis_tpu.dispatch import use_kernel
    from curvis_tpu.parallel.mesh import FRAMES, RAYS
    from curvis_tpu.render.fast import _pixel_dirs_soa, _spawn_planar_soa

    cams = list(cameras)
    if use_pallas == "auto":
        use_pallas = use_kernel(cams[0].position.dtype)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    F = len(cams)
    nf_dev = mesh.shape[FRAMES]
    nr_dev = mesh.shape[RAYS]
    if F % nf_dev:
        raise ValueError(f"{F} frames do not divide the {nf_dev}-way "
                         f"'frames' mesh axis")
    states = []
    for cam in cams:
        dx, dy, dz = _pixel_dirs_soa(cam)
        states.append(_spawn_planar_soa(metric, cam, dx, dy, dz))
    n = W * H
    n_pad = -(-n // nr_dev) * nr_dev

    def stack_state(i):
        a = jnp.stack([s[0][i] for s in states])             # (F, N)
        return jnp.concatenate(
            [a, jnp.broadcast_to(a[:, :1], (F, n_pad - n))], axis=1)

    l, psi, p_l, b = (stack_state(i) for i in range(4))

    def _march_block(metric, l, psi, p_l, b):
        blk = l.shape                       # (F/nf_dev, n_pad/nr_dev)
        flat = tuple(a.reshape(-1) for a in (l, psi, p_l, b))
        rays = pl.PlanarRays(*flat, jnp.zeros((1, 3), l.dtype),
                             jnp.zeros((1, 3), l.dtype))
        if use_pallas:
            from curvis_tpu.ops.march_pallas import march_planar_pallas
            res = march_planar_pallas(metric, rays, dt=dt,
                                      max_steps=max_steps,
                                      escape_radius=escape_radius)
        else:
            res = pl.march_planar_while(metric, rays, dt=dt,
                                        max_steps=max_steps,
                                        escape_radius=escape_radius)
        return tuple(jnp.reshape(a, blk) for a in
                     (res.l, res.psi, res.p_l, res.sign, res.steps))

    marched = _shard_map(
        _march_block, mesh=mesh,
        in_specs=(P(),) + (P(FRAMES, RAYS),) * 4,
        out_specs=(P(FRAMES, RAYS),) * 5,
        check_vma=False)
    lo, psio, plo, sign, steps = marched(metric, l, psi, p_l, b)
    lo, psio, plo, sign, steps = (a[:, :n].reshape(-1)
                                  for a in (lo, psio, plo, sign, steps))
    flat = pl.PlanarResult(lo, psio, plo, sign, steps)

    def chain(idx, comp):
        return jnp.stack([jnp.broadcast_to(s[idx][comp], (n,))
                          for s in states]).reshape(-1)

    return _finish_from_result(metric, cams[0], bg_positive, bg_negative,
                               flat, b[:, :n].reshape(-1),
                               (chain(1, 0), chain(1, 1), chain(1, 2)),
                               (chain(2, 0), chain(2, 1), chain(2, 2)),
                               filtering, n_frames=F)


def _finish_from_result(metric, camera, bg_positive, bg_negative, res, b,
                        r_hat, e2, filtering, n_frames=1):
    from curvis_tpu.render.fast import _filter_lookup, _texture_uv
    rx, ry, rz = r_hat
    e2x, e2y, e2z = e2
    beta = res.psi + jnp.arctan2(b / metric.r(res.l), res.p_l)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    wx = cb * rx + sb * e2x
    wy = cb * ry + sb * e2y
    wz = cb * rz + sb * e2z
    sign = res.sign
    up, vp = _texture_uv(bg_positive, wx, wy, wz)
    un, vn = _texture_uv(bg_negative, wx, wy, wz)
    neg = sign < 0
    u = jnp.where(neg, un, up)
    v = jnp.where(neg, vn, vp)
    H, W = bg_positive.height, bg_positive.width
    rows = jnp.concatenate([bg_positive.texture.reshape(-1, 3),
                            bg_negative.texture.reshape(-1, 3)])
    base = jnp.where(neg, H * W, 0)
    colors = _filter_lookup(rows, base, u, v, W, H, filtering)
    # only escaped rays are lit (captured/not-escaped render black, matching
    # render/fast.py semantics)
    lit = (sign == 1) | (sign == -1)
    colors = jnp.where(lit[:, None], colors, jnp.zeros_like(colors))
    W, H = camera.resolution_x, camera.resolution_y
    if n_frames == 1:
        return colors.reshape(W, H, 3).transpose(1, 0, 2)
    return colors.reshape(n_frames, W, H, 3).transpose(0, 2, 1, 3)


def make_train_step(mesh: Mesh, *, dt, max_steps, escape_radius,
                    stepper="euler", filtering="bilinear", lr=1e-3):
    """Full differentiable training step: render -> L2 loss vs target image ->
    grads w.r.t. (metric params, camera pose) -> SGD update.

    Gradients flow through the checkpointed-scan march; the mean over the
    sharded ray axis makes GSPMD emit the cross-device psum for the parameter
    gradients (the only collective this workload needs, SURVEY.md section 5).
    """

    def loss_fn(metric, camera, bg_positive, bg_negative, target):
        img = render_direct_sharded(metric, camera, bg_positive, bg_negative,
                                    mesh, dt=dt, max_steps=max_steps,
                                    escape_radius=escape_radius,
                                    stepper=stepper, filtering=filtering,
                                    differentiable=True)
        return jnp.mean((img - target) ** 2)

    def train_step(metric, camera, bg_positive, bg_negative, target):
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            metric, camera, bg_positive, bg_negative, target)
        g_metric, g_camera = grads
        metric = jax.tree_util.tree_map(lambda p, g: p - lr * g, metric,
                                        g_metric)
        camera = jax.tree_util.tree_map(lambda p, g: p - lr * g, camera,
                                        g_camera)
        return metric, camera, loss

    return train_step


def render_kerr_sharded(metric, cameras, bg: SphericalImage, mesh: Mesh, *,
                        dt, max_steps, escape_radius=None, disk=None,
                        filtering="bilinear", far_accel=True,
                        backend="xla", stepper="rk4", rtol=1e-4,
                        starlight_map=None):
    """Sharded Kerr/Kerr-Newman video rendering -> (F, H, W, 3).

    Every stage of the BL pipeline (tetrad spawn, RK4 march, asymptotic
    readout, disk shading) is per-ray, so F frames concatenate into one
    (F*N, 4) bundle whose leading axis shards over the mesh's 'rays' axis —
    the sharding constraint at the spawn output is the only annotation;
    GSPMD propagates it through the whole march with no collectives in the
    forward pass (render/kerr.py:render_kerr_frames_batched is the
    single-device counterpart — same math, agreeing to fusion-order ulps)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from curvis_tpu.parallel.mesh import RAYS
    from curvis_tpu.render.kerr import (_kerr_march_and_shade,
                                        _spawn_kerr_rays)
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    if escape_radius is None:
        escape_radius = 2.0 * max(float(c.position[1]) for c in cams)
    bundles = [_spawn_kerr_rays(metric, c) for c in cams]
    x0 = jnp.concatenate([b[0] for b in bundles])
    p0 = jnp.concatenate([b[1] for b in bundles])
    sh = NamedSharding(mesh, P(RAYS, None))
    x0 = jax.lax.with_sharding_constraint(x0, sh)
    p0 = jax.lax.with_sharding_constraint(p0, sh)
    colors = _kerr_march_and_shade(
        metric, x0, p0, bg, jnp.asarray(dt, x0.dtype), max_steps=max_steps,
        escape_radius=escape_radius, disk=disk, filtering=filtering,
        backend=backend, far_accel=far_accel, stepper=stepper, rtol=rtol,
        starlight_map=starlight_map)
    return colors.reshape(len(cams), W, H, 3).transpose(0, 2, 1, 3)


def march_kerr_shardmap(metric, x0, p0, mesh: Mesh, *, dt, max_steps,
                        escape_radius, stepper="rk4", rtol=1e-4,
                        far_r0=None, differentiable=False, segment=None):
    """Per-device Kerr KERNEL launches under ``mesh`` — the production
    multi-card path for the Boyer-Lindquist marchers.

    GSPMD cannot partition a ``pallas_call``, so each device gets its own
    kernel launch over its ray shard via ``shard_map``:

      * forward: ops/march_pallas.march_kerr_pallas (``stepper='rk4'``) or
        march_kerr_rk45_pallas (``'rk45'``);
      * ``differentiable=True``: the checkpointed-recompute custom-VJP
        pairs (integrate/kerr_adjoint.py / integrate/rk45_adjoint.py) with
        backend='pallas' — the kernel forward and the XLA backward run
        per-shard, and the transpose of the replicated ``metric`` input
        psums the (m, a, q) cotangents across devices automatically.

    On the CPU the kernels run in interpret mode (virtual-mesh testing).
    Returns ``(x, p, sign, steps)`` on the original ray count (the bundle
    is edge-padded to a devices multiple internally)."""
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from jax.sharding import PartitionSpec as P
    from curvis_tpu.parallel.mesh import RAYS
    n_dev = mesh.devices.size
    n = x0.shape[0]
    x0p, _ = pad_to_multiple(x0, n_dev)
    p0p, _ = pad_to_multiple(p0, n_dev)
    backend = "pallas"

    def _march(metric, x0s, p0s):
        if differentiable:
            if stepper == "rk45":
                from curvis_tpu.integrate.rk45_adjoint import (
                    march_kerr_rk45_adjoint)
                return march_kerr_rk45_adjoint(
                    metric, x0s, p0s, dt0=dt, max_steps=max_steps,
                    escape_radius=escape_radius, rtol=rtol,
                    atol=rtol * 1e-3, backend=backend, segment=segment)
            from curvis_tpu.integrate.kerr_adjoint import march_kerr_adjoint
            return march_kerr_adjoint(
                metric, x0s, p0s, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, far_r0=far_r0,
                backend=backend, segment=segment)
        if stepper == "rk45":
            from curvis_tpu.ops.march_pallas import march_kerr_rk45_pallas
            return march_kerr_rk45_pallas(
                metric, x0s, p0s, dt0=dt, max_steps=max_steps,
                escape_radius=escape_radius, rtol=rtol, atol=rtol * 1e-3)
        from curvis_tpu.ops.march_pallas import march_kerr_pallas
        return march_kerr_pallas(
            metric, x0s, p0s, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, far_r0=far_r0)

    out = _shard_map(_march, mesh=mesh,
                     in_specs=(P(), P(RAYS, None), P(RAYS, None)),
                     out_specs=(P(RAYS, None), P(RAYS, None), P(RAYS),
                                P(RAYS)),
                     check_vma=False)(metric, x0p, p0p)
    return tuple(a[:n] for a in out)


def render_kerr_shardmap(metric, cameras, bg: SphericalImage, mesh: Mesh, *,
                        dt, max_steps, escape_radius=None, stepper="rk4",
                        rtol=1e-4, filtering="bilinear", far_r0=None):
    """Kerr frames with per-device KERNEL launches (march_kerr_shardmap)
    -> (F, H, W, 3): the explicit-collectives twin of render_kerr_sharded
    for bare-shadow renders — march per shard, readout/shade on the
    sharded bundle (gathers from the replicated background)."""
    from curvis_tpu.render.kerr import _kerr_shade, _spawn_kerr_rays
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    if escape_radius is None:
        escape_radius = 2.0 * max(float(c.position[1]) for c in cams)
    bundles = [_spawn_kerr_rays(metric, c) for c in cams]
    x0 = jnp.concatenate([b[0] for b in bundles])
    p0 = jnp.concatenate([b[1] for b in bundles])
    x, p, sign, steps = march_kerr_shardmap(
        metric, x0, p0, mesh, dt=dt, max_steps=max_steps,
        escape_radius=escape_radius, stepper=stepper, rtol=rtol,
        far_r0=far_r0)
    colors = _kerr_shade(metric, x0, p0, bg, x, p, sign, None, filtering,
                         False, None, None, None, None)
    return colors.reshape(len(cams), W, H, 3).transpose(0, 2, 1, 3)


def make_kerr_train_step(mesh: Mesh, *, dt, max_steps, escape_radius,
                         lr=0.05, use_pallas="auto", stepper="rk4",
                         rtol=1e-4):
    """Differentiable Kerr/KN training step across the ray-sharded mesh:
    render -> L2 loss vs target frames -> grads w.r.t. the metric pytree
    (m, a, q) -> SGD update.  The loss mean over the sharded ray axis
    psums the parameter gradients across devices — the spin-recovery
    inverse problem at cluster scale (dryrun phase 4).

    ``use_pallas=True`` routes the march through
    :func:`march_kerr_shardmap` (differentiable=True): per-device kernel
    forward + XLA checkpointed-recompute backward — the production
    multi-card gradient path (``stepper='rk45'`` for the error-controlled
    pair; on the CPU the kernel runs in interpret mode).
    ``use_pallas=False`` renders through GSPMD with the XLA adjoint pair
    (render_kerr_sharded backend='adjoint').  ``'auto'`` follows the
    dispatch rule (curvis_tpu/dispatch.py)."""
    if use_pallas == "auto":
        from curvis_tpu.dispatch import use_kernel
        use_pallas = use_kernel()

    if use_pallas:
        from curvis_tpu.render.kerr import _kerr_shade, _spawn_kerr_rays

        def loss_fn(metric, cams, bg, target):
            bundles = [_spawn_kerr_rays(metric, c) for c in cams]
            x0 = jnp.concatenate([b[0] for b in bundles])
            p0 = jnp.concatenate([b[1] for b in bundles])
            x, p, sign, _ = march_kerr_shardmap(
                metric, x0, p0, mesh, dt=dt, max_steps=max_steps,
                escape_radius=escape_radius, stepper=stepper, rtol=rtol,
                differentiable=True)
            colors = _kerr_shade(metric, x0, p0, bg, x, p, sign, None,
                                 "bilinear", False, None, None, None, None)
            W, H = cams[0].resolution_x, cams[0].resolution_y
            imgs = colors.reshape(len(cams), W, H, 3).transpose(0, 2, 1, 3)
            return jnp.mean((imgs - target) ** 2)
    else:
        def loss_fn(metric, cams, bg, target):
            imgs = render_kerr_sharded(metric, cams, bg, mesh, dt=dt,
                                       max_steps=max_steps,
                                       escape_radius=escape_radius,
                                       backend="adjoint")
            return jnp.mean((imgs - target) ** 2)

    def train_step(metric, cams, bg, target):
        loss, g_metric = jax.value_and_grad(loss_fn)(metric, cams, bg,
                                                     target)
        metric = jax.tree_util.tree_map(lambda p, g: p - lr * g, metric,
                                        g_metric)
        return metric, loss

    return train_step
