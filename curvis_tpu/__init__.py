"""curvis_tpu — a differentiable curved-spacetime renderer (JAX, GPU).

A from-scratch JAX/XLA/Pallas framework with the capabilities of the CurVis
reference (a single-threaded CPU Rust raytracer of traversable wormholes,
O. James et al. 2015): per-pixel null-geodesic integration through diagonal
spherically symmetric metrics (Ellis, Interstellar/DNEG), equirectangular
two-sided backgrounds, image and video rendering — re-designed for
accelerators: batched ray marching in Pallas GPU kernels, shardable over
device meshes,
and differentiable w.r.t. metric parameters and camera pose.
"""

from curvis_tpu.metrics.base import (
    EllisMetric,
    FlatSphericalMetric,
    InterstellarMetric,
    ReissnerNordstromMetric,
    SchwarzschildMetric,
    make_metric,
)
from curvis_tpu.metrics.table import TabulatedMetric, tabulate_metric
from curvis_tpu.camera.camera import Camera, make_camera
from curvis_tpu.env.spherical_image import (
    SphericalImage,
    load_spherical_image,
    make_spherical_image,
    save_image,
)
from curvis_tpu.integrate.march import MarchResult, march, compute_trajectory
from curvis_tpu.fit import FitResult, fit
from curvis_tpu.render.direct import render_direct
from curvis_tpu.render.scene import Scene

__version__ = "0.3.0"

__all__ = [
    "Camera",
    "Scene",
    "EllisMetric",
    "FitResult",
    "FlatSphericalMetric",
    "InterstellarMetric",
    "MarchResult",
    "ReissnerNordstromMetric",
    "SchwarzschildMetric",
    "SphericalImage",
    "TabulatedMetric",
    "compute_trajectory",
    "fit",
    "load_spherical_image",
    "make_camera",
    "make_metric",
    "make_spherical_image",
    "march",
    "render_direct",
    "save_image",
    "tabulate_metric",
]
