"""Scene — the RelativisticSystem equivalent (systems.rs:60-73).

Bundles a metric, the two background spheres and a camera, and exposes the
reference's rendering entry points under familiar names:

  - ``render_image``          : per-pixel integration (systems.rs:307-330,
                                here the batched direct renderer)
  - ``render_image_efficient``: the 1-D symmetry reduction
                                (systems.rs:333-527)
  - ``compute_escape_angle(s)``: deflection-function probes
                                (systems.rs:203-281)
  - ``compute_photon_trajectory``: path recording (systems.rs:77-92)

The scene is a pytree, so it can be passed through jit/grad whole.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from curvis_tpu.camera.camera import Camera
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.metrics.base import Metric


@dataclasses.dataclass(frozen=True)
class Scene:
    metric: Metric
    background_positive: SphericalImage
    background_negative: SphericalImage
    camera: Camera

    # -- rendering ---------------------------------------------------------
    def render_image(self, *, dt=0.05, max_steps=40_000, escape_radius=100.0,
                     stepper="euler", filtering="nearest", **kw):
        """Per-pixel direct render -> (H, W, 3)."""
        from curvis_tpu.render.fast import render_planar_fast
        return render_planar_fast(self.metric, self.camera,
                                  self.background_positive,
                                  self.background_negative, dt=dt,
                                  max_steps=max_steps,
                                  escape_radius=escape_radius,
                                  stepper=stepper, filtering=filtering, **kw)

    def render_image_efficient(self, *, dt=0.05, max_steps=40_000,
                               escape_radius=100.0, alpha_nums=100,
                               max_iterations_sampling=50,
                               sampling_convergence_threshold_1=1e-5,
                               sampling_convergence_threshold_2=1e-5,
                               filtering="nearest", **kw):
        """Symmetry-reduction render -> (H, W, 3)."""
        from curvis_tpu.render.symmetric import render_symmetric
        return render_symmetric(
            self.metric, self.camera, self.background_positive,
            self.background_negative, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, alpha_nums=alpha_nums,
            max_iterations_sampling=max_iterations_sampling,
            sampling_convergence_threshold_1=sampling_convergence_threshold_1,
            sampling_convergence_threshold_2=sampling_convergence_threshold_2,
            filtering=filtering, **kw)

    # -- science probes ----------------------------------------------------
    def compute_escape_angle(self, alpha, *, dt=0.05, max_steps=40_000,
                             escape_radius=100.0, **kw):
        from curvis_tpu.render.symmetric import compute_escape_angles
        a, s = compute_escape_angles(self.metric, self.camera.position[1],
                                     jnp.atleast_1d(jnp.asarray(alpha)),
                                     dt=dt, max_steps=max_steps,
                                     escape_radius=escape_radius, **kw)
        return a, s

    compute_escape_angles_range = compute_escape_angle

    def compute_photon_trajectory(self, direction3, *, dt=0.05, n_steps=1000,
                                  stepper="euler"):
        from curvis_tpu.integrate.march import compute_trajectory
        from curvis_tpu.physics import geodesic
        x0 = self.camera.position
        p0 = geodesic.new_photon(self.metric, x0, jnp.asarray(direction3))
        return compute_trajectory(self.metric, x0, p0, dt=dt,
                                  n_steps=n_steps, stepper=stepper)


jax.tree_util.register_dataclass(
    Scene,
    data_fields=["metric", "background_positive", "background_negative",
                 "camera"],
    meta_fields=[])
