"""Camera-path playback: CSV schema + time interpolation.

Re-design of the reference's csv.rs + interpolation.rs: the path is loaded
into numpy column arrays and interpolation is *vectorized over time* — a whole
batch of frame timestamps lerps in one call (the frame axis is a first-class
batch axis on the device), instead of the reference's per-call linear scan
(interpolation.rs:63-91).

CSV schema (csv.rs:5-11): header line (ignored), then rows
    t, l, theta, phi, fx, fy, fz, ux, uy, uz
with (t, l, theta, phi) the camera 4-position and f/u the tangent-space
forward/up vectors.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraPath:
    positions: np.ndarray        # (N, 4)
    forwards: np.ndarray         # (N, 3)
    ups: np.ndarray              # (N, 3)

    def __post_init__(self):
        t = self.positions[:, 0]
        if len(t) < 2:
            raise ValueError("camera path needs at least two waypoints")
        if not np.all(np.diff(t) > 0):
            raise ValueError("camera path times must be strictly increasing")

    @property
    def min_time(self) -> float:
        return float(self.positions[0, 0])      # interpolation.rs:53-55

    @property
    def max_time(self) -> float:
        return float(self.positions[-1, 0])     # interpolation.rs:57-59

    def interpolate(self, times):
        """Piecewise-linear (position, forward, up) at ``times`` (scalar or
        (F,) array) — interpolation.rs:93-106 semantics, vectorized.

        Raises ValueError outside [min_time, max_time] (the reference panics,
        interpolation.rs:66-71).
        """
        t = np.atleast_1d(np.asarray(times, dtype=np.float64))
        if (t < self.min_time).any() or (t > self.max_time).any():
            raise ValueError(
                f"interpolation time outside [{self.min_time}, "
                f"{self.max_time}]")
        ts = self.positions[:, 0]
        cols = [np.interp(t, ts, self.positions[:, k]) for k in range(4)]
        fcols = [np.interp(t, ts, self.forwards[:, k]) for k in range(3)]
        ucols = [np.interp(t, ts, self.ups[:, k]) for k in range(3)]
        pos = np.stack(cols, axis=-1)
        fwd = np.stack(fcols, axis=-1)
        up = np.stack(ucols, axis=-1)
        if np.isscalar(times) or np.ndim(times) == 0:
            return pos[0], fwd[0], up[0]
        return pos, fwd, up

    def frame_times(self, frame_rate: float) -> np.ndarray:
        """Frame timestamps min..max at 1/frame_rate spacing.

        Computed as min + k/fps for integer k (no accumulated float error —
        fixes the reference's occasional last-frame panic from accumulating
        t += dt past max_time; rendering.rs:224-238, README.md:107).
        """
        n = int(np.ceil((self.max_time - self.min_time) * frame_rate
                        - 1e-12))
        k = np.arange(max(n, 1))
        times = self.min_time + k / frame_rate
        return times[times < self.max_time - 1e-12] if n > 1 else times


def load_path(path) -> CameraPath:
    """Parse the camera-path CSV (csv.rs:24-61)."""
    rows = []
    with open(Path(path)) as f:
        for index, line in enumerate(f):
            if index == 0:
                continue                       # header skipped (csv.rs:34-37)
            line = line.strip()
            if not line:
                continue
            vals = [float(v) for v in line.split(",")]
            if len(vals) != 10:
                raise ValueError(
                    f"camera path row {index}: expected 10 values, "
                    f"got {len(vals)}")
            rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64)
    return CameraPath(positions=arr[:, 0:4], forwards=arr[:, 4:7],
                      ups=arr[:, 7:10])


def generate_orbit_path(l=3.0, period=60.0, n=1000) -> CameraPath:
    """Circular orbit at radius l on the equatorial plane, camera fixed
    toward -x (paths/generate_path_orbit.py)."""
    t = np.linspace(0.0, period, n)
    phi = 2.0 * np.pi * t / period
    pos = np.stack([t, np.full(n, l), np.full(n, np.pi / 2), phi], -1)
    fwd = np.tile([-1.0, 0.0, 0.0], (n, 1))
    up = np.tile([0.0, 0.0, 1.0], (n, 1))
    return CameraPath(pos, fwd, up)


def generate_through_path(l0=4.0, duration=20.0, b_max=3.0, n=1000) -> CameraPath:
    """Pass through the wormhole from l=-l0 to l=+l0 with forward-vector
    steering via an impact-parameter bell curve
    (paths/generate_path_through.py)."""
    t = np.linspace(0.0, duration, n)
    l = -l0 + 2.0 * l0 * t / duration
    b = b_max * np.exp(-10.0 * (l / l0) ** 2)
    alpha = np.pi - np.arctan2(b, l)
    pos = np.stack([t, l, np.full(n, np.pi / 2), np.zeros(n)], -1)
    fwd = np.stack([np.cos(alpha), np.zeros(n), np.sin(alpha)], -1)
    up = np.tile([0.0, 0.0, 1.0], (n, 1))
    return CameraPath(pos, fwd, up)


def save_path(path_obj: CameraPath, file_path):
    """Write the CSV schema back out (inverse of load_path)."""
    header = "t,l,theta,phi,fx,fy,fz,ux,uy,uz"
    data = np.concatenate([path_obj.positions, path_obj.forwards,
                           path_obj.ups], axis=1)
    np.savetxt(file_path, data, delimiter=",", header=header, comments="")
