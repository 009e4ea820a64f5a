"""Multi-host rendering: process groups, deterministic work partitioning,
per-host tile outputs with resume.

Multi-host design (SURVEY.md section 5, "Distributed communication
backend"): `jax.distributed.initialize` forms the process group (ICI within a
slice, DCN across hosts); the *render* workload needs no cross-host
communication at all — the pixel space is partitioned deterministically into
row-band tiles, each host renders its own bands with its local devices and
writes idempotent tile files + a manifest, and any host (or a later process)
assembles the image.  Restarts are free: finished tiles are skipped (the
failure-recovery model the reference lacks — it restarts renders from
scratch).

On a single host this degrades gracefully (host 0 owns everything), which is
how the partitioning logic is tested here.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Form the multi-host process group (no-op when single-host)."""
    import jax
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def host_info():
    import jax
    return jax.process_index(), jax.process_count()


def partition_rows(height: int, n_bands: int):
    """Deterministic row-band partition: list of (y0, y1) half-open bands."""
    edges = np.linspace(0, height, n_bands + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])
            if b > a]


def bands_for_host(bands, host_id: int, n_hosts: int):
    """Round-robin assignment of bands to hosts (stable under restart)."""
    return [b for i, b in enumerate(bands) if i % n_hosts == host_id]


def render_tiled(metric, camera, bg_positive, bg_negative, out_dir, *,
                 dt, max_steps, escape_radius, bands=None, filtering="nearest",
                 stepper="euler", resume=True, host_id=None, n_hosts=None):
    """Render a (possibly huge) image as row-band tiles with resume.

    Each band is rendered as an independent device call on a band-cropped
    camera (the pinhole geometry is separable in pixel rows) and written to
    ``out_dir/tile_<y0>_<y1>.npy``; a manifest records completion.  With
    multiple hosts, each host renders only its own bands.  Returns the list
    of this host's tile paths.
    """
    import jax
    from curvis_tpu.camera.camera import Camera
    from curvis_tpu.render.fast import render_planar_fast

    if host_id is None or n_hosts is None:
        host_id, n_hosts = host_info()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    H = camera.resolution_y
    if bands is None:
        bands = partition_rows(H, max(n_hosts * 4, 8))
    mine = bands_for_host(bands, host_id, n_hosts)

    manifest_path = out / f"manifest_host{host_id}.json"
    manifest = {"bands": [list(b) for b in bands], "host": host_id,
                "n_hosts": n_hosts, "resolution":
                    [camera.resolution_x, camera.resolution_y], "done": {}}
    if resume and manifest_path.exists():
        try:
            manifest.update(json.loads(manifest_path.read_text()))
        except Exception:
            pass

    tiles = []
    for (y0, y1) in mine:
        tile_path = out / f"tile_{y0}_{y1}.npy"
        tiles.append(tile_path)
        if resume and tile_path.exists():
            continue
        sub = _band_camera(camera, y0, y1)
        img = jax.jit(lambda m, c, bp, bn: render_planar_fast(
            m, c, bp, bn, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, filtering=filtering,
            stepper=stepper))(metric, sub, bg_positive, bg_negative)
        np.save(tile_path, np.asarray(img))
        manifest["done"][f"{y0}_{y1}"] = True
        manifest_path.write_text(json.dumps(manifest, indent=1))
    return tiles


def _band_camera(camera, y0: int, y1: int):
    """A camera that renders only pixel rows [y0, y1) of the full image.

    The per-pixel ray formula (cameras.rs:150-164) depends on y only through
    h = 0.5 - y/H_full, so a band is the full camera evaluated at its row
    subset (render/fast.py honors row_offset / full_resolution_y).
    """
    return _BandCamera(camera, y0, y1)


class _BandCamera:
    """Duck-typed Camera view exposing a row band. Matches the attribute
    surface used by render/fast.py."""

    def __init__(self, camera, y0, y1):
        self._camera = camera
        self._y0 = y0
        self._y1 = y1

    def __getattr__(self, name):
        return getattr(self._camera, name)

    @property
    def resolution_y(self):
        return self._y1 - self._y0

    @property
    def row_offset(self):
        return self._y0

    @property
    def full_resolution_y(self):
        return self._camera.resolution_y


def _register_band_camera():
    import jax
    jax.tree_util.register_pytree_node(
        _BandCamera,
        lambda bc: ((bc._camera,), (bc._y0, bc._y1)),
        lambda aux, children: _BandCamera(children[0], aux[0], aux[1]))


_register_band_camera()


def assemble_tiles(out_dir, resolution_x, resolution_y):
    """Stitch all tiles (from all hosts) into one (H, W, 3) array."""
    out = Path(out_dir)
    img = np.zeros((resolution_y, resolution_x, 3), dtype=np.float32)
    seen = np.zeros(resolution_y, dtype=bool)
    for tile in out.glob("tile_*.npy"):
        y0, y1 = (int(v) for v in tile.stem.split("_")[1:3])
        img[y0:y1] = np.load(tile)
        seen[y0:y1] = True
    if not seen.all():
        missing = int((~seen).sum())
        raise RuntimeError(f"{missing} image rows missing tiles in {out}")
    return img
