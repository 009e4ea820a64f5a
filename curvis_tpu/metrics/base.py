"""Metric abstraction for diagonal, spherically symmetric spacetimes.

Data-parallel re-design of the reference trait `DiagonalSphericalMetric`
(/root/reference/src/metrics.rs:40-156): a metric is a small *parameter pytree*
(a frozen dataclass registered with JAX) exposing three scalar shape functions
``r(l)``, ``r_squared(l)``, ``r_derivative(l)``.  Everything else — metric
components, frame fields, index gymnastics, geodesic right-hand sides — is
derived in :mod:`curvis_tpu.physics.geodesic` as pure batched jnp functions of
``(metric, x, p)``.

Because the parameters are pytree leaves, every downstream quantity (including
full rendered images) is differentiable w.r.t. them by construction — the axis
the Rust reference does not have.

Coordinates are (t, l, theta, phi); the line element is
    ds^2 = -dt^2 + dl^2 + r(l)^2 (dtheta^2 + sin^2(theta) dphi^2)
(metrics.rs:49-68).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import jax
import jax.numpy as jnp


@runtime_checkable
class Metric(Protocol):
    """Structural protocol every metric pytree satisfies (metrics.rs:42-44)."""

    def r(self, l): ...
    def r_squared(self, l): ...
    def r_derivative(self, l): ...


def _register(cls):
    """Register a frozen dataclass of array leaves as a JAX pytree."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_register
@dataclasses.dataclass(frozen=True)
class EllisMetric:
    """Ellis wormhole: r(l) = sqrt(rho^2 + l^2)  (metrics.rs:399-421)."""

    rho: jax.Array

    def r(self, l):
        return jnp.sqrt(self.r_squared(l))

    def r_squared(self, l):
        return self.rho * self.rho + l * l

    def r_derivative(self, l):
        return l / self.r(l)


@_register
@dataclasses.dataclass(frozen=True)
class InterstellarMetric:
    """DNEG (Interstellar movie) wormhole, James et al. 2015 eq. (5)
    (metrics.rs:431-487).

    Parameters: mass ``m``, throat half-length ``a``, throat radius ``rho``.
    Outside the throat (|l| > a), with x = 2(|l| - a) / (pi m):
        r   = rho + m (x atan x - 0.5 ln(1 + x^2))
        r'  = (2/pi) sign(l) atan x
    Inside the throat r = rho, r' = 0.  The branch is a `jnp.where` over two
    everywhere-finite expressions, so it is jit/grad safe.
    """

    m: jax.Array
    a: jax.Array
    rho: jax.Array

    def _x(self, l):
        return 2.0 * (jnp.abs(l) - self.a) / (jnp.pi * self.m)

    def r(self, l):
        x = self._x(l)
        outside = self.rho + self.m * (x * jnp.arctan(x) - 0.5 * jnp.log1p(x * x))
        return jnp.where(jnp.abs(l) > self.a, outside, self.rho)

    def r_squared(self, l):
        r = self.r(l)
        return r * r

    def r_derivative(self, l):
        x = self._x(l)
        outside = (2.0 / jnp.pi) * jnp.sign(l) * jnp.arctan(x)
        return jnp.where(jnp.abs(l) > self.a, outside, jnp.zeros_like(outside))


@_register
@dataclasses.dataclass(frozen=True)
class FlatSphericalMetric:
    """Flat 3-space in polar coordinates: r(l) = l (metrics.rs:492-505).

    Straight-line photon propagation; the analytic end-to-end oracle for the
    renderer (an image rendered in flat space must equal the background sampled
    along the camera rays).
    """

    _placeholder: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros(()))

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return jnp.ones_like(l)


@_register
@dataclasses.dataclass(frozen=True)
class SchwarzschildMetric:
    """Schwarzschild black hole — the reference README's #1 wishlist item
    ("Black holes!"), out of reach of its fixed diag(-1, 1, r^2, ...) metric
    family (README.md:113, metrics.rs:49-68).

    Line element (areal radius coordinate l = r, exterior chart):
        ds^2 = -A dt^2 + dl^2/A + l^2 dOmega^2,    A(l) = 1 - 2M/l
    i.e. lapse A != 1 and B = 1/A; the general planar null-geodesic system
    (physics/planar.py) handles this via the `unit_lapse = False` branch.

    Photons whose trajectory sinks below ``capture_radius`` (placed between
    the horizon 2M and the photon sphere 3M, where infall is irreversible)
    terminate as *captured* (sign +2) and render black — the shadow.  The
    critical impact parameter is b_c = 3*sqrt(3) M.
    """

    m: jax.Array
    unit_lapse = False

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return jnp.ones_like(l)

    def lapse(self, l):
        return 1.0 - 2.0 * self.m / l

    def lapse_deriv(self, l):
        return 2.0 * self.m / (l * l)

    def radial_B(self, l):
        return 1.0 / self.lapse(l)

    @property
    def capture_radius(self):
        return 2.5 * self.m        # in (2M, 3M): capture set exact there


@_register
@dataclasses.dataclass(frozen=True)
class ReissnerNordstromMetric:
    """Reissner-Nordstrom (charged, non-rotating) black hole.

    Line element (areal radius l = r, exterior chart):
        ds^2 = -A dt^2 + dl^2/A + l^2 dOmega^2,
        A(l) = 1 - 2M/l + Q^2/l^2
    — static and spherically symmetric, so it runs through the same planar
    reduction / `unit_lapse = False` branch as Schwarzschild
    (physics/planar.py), Pallas kernels included.  Another metric family
    outside the reference's fixed unit-lapse form (metrics.rs:49-68).

    Analytic targets (tests/test_charged.py): horizon
    r_+ = M + sqrt(M^2 - Q^2); photon sphere
    r_ph = (3M + sqrt(9 M^2 - 8 Q^2)) / 2; shadow edge (critical impact
    parameter) b_c = r_ph / sqrt(A(r_ph)).  Q -> 0 recovers Schwarzschild
    (b_c -> 3 sqrt(3) M); the a -> 0 Kerr-Newman BL march is the
    cross-formulation oracle.
    """

    m: jax.Array
    q: jax.Array
    unit_lapse = False

    def r(self, l):
        return l

    def r_squared(self, l):
        return l * l

    def r_derivative(self, l):
        return jnp.ones_like(l)

    def lapse(self, l):
        return 1.0 - (2.0 * self.m - self.q * self.q / l) / l

    def lapse_deriv(self, l):
        return (2.0 * self.m - 2.0 * self.q * self.q / l) / (l * l)

    def radial_B(self, l):
        return 1.0 / self.lapse(l)

    @property
    def horizon_radius(self):
        return self.m + jnp.sqrt(jnp.maximum(self.m ** 2 - self.q ** 2, 0.0))

    @property
    def photon_sphere_radius(self):
        return 0.5 * (3.0 * self.m
                      + jnp.sqrt(9.0 * self.m ** 2 - 8.0 * self.q ** 2))

    @property
    def critical_impact_parameter(self):
        r_ph = self.photon_sphere_radius
        return r_ph / jnp.sqrt(self.lapse(r_ph))

    @property
    def capture_radius(self):
        # midway between horizon and photon sphere: infall is irreversible
        return 0.5 * (self.horizon_radius + self.photon_sphere_radius)


_REGISTRY = {
    "ellis": EllisMetric,
    "interstellar": InterstellarMetric,
    "dneg": InterstellarMetric,
    "flat": FlatSphericalMetric,
    "schwarzschild": SchwarzschildMetric,
    "reissner-nordstrom": ReissnerNordstromMetric,
    "rn": ReissnerNordstromMetric,
}


def make_metric(kind: str, **params) -> Metric:
    """Build a metric by name with validated positive parameters.

    Mirrors the constructor checks of the reference (metrics.rs:407-414,
    443-459) — but at Python construction time, outside jit.
    """
    kind = kind.lower()
    if kind not in _REGISTRY:
        raise ValueError(f"Unknown metric {kind!r}; known: {sorted(_REGISTRY)}")
    cls = _REGISTRY[kind]
    if cls is EllisMetric:
        rho = float(params.get("rho", 1.0))
        if rho <= 0:
            raise ValueError("Ellis metric requires rho > 0.")
        return EllisMetric(rho=jnp.asarray(rho))
    if cls is InterstellarMetric:
        m = float(params.get("m", 0.1))
        a = float(params.get("a", 1e-4))
        rho = float(params.get("rho", 1.0))
        for name, v in (("m", m), ("a", a), ("rho", rho)):
            if v <= 0:
                raise ValueError(f"Interstellar metric requires {name} > 0.")
        return InterstellarMetric(m=jnp.asarray(m), a=jnp.asarray(a),
                                  rho=jnp.asarray(rho))
    if cls is SchwarzschildMetric:
        m = float(params.get("m", 1.0))
        if m <= 0:
            raise ValueError("Schwarzschild metric requires m > 0.")
        return SchwarzschildMetric(m=jnp.asarray(m))
    if cls is ReissnerNordstromMetric:
        m = float(params.get("m", 1.0))
        q = float(params.get("q", 0.5))
        if m <= 0:
            raise ValueError("Reissner-Nordstrom metric requires m > 0.")
        if abs(q) >= m:
            raise ValueError(
                "Reissner-Nordstrom metric requires |q| < m (sub-extremal).")
        return ReissnerNordstromMetric(m=jnp.asarray(m), q=jnp.asarray(q))
    return FlatSphericalMetric()
