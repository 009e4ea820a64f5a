"""Kerr (rotating) black hole in Boyer-Lindquist coordinates.

The reference README names rotating black holes as exactly what its
spherically-symmetric architecture cannot do (README.md:111).  Here the Kerr
metric is just another parameter pytree; the geodesic equations are
autodiff-generated from the Hamiltonian (physics/hamiltonian.py), so no
Christoffel symbols are derived by hand.

Coordinates x = (t, r, theta, phi).  With
    Sigma = r^2 + a^2 cos^2(theta)
    Delta = r^2 - 2 M r + a^2
the covariant metric is
    g_tt      = -(1 - 2 M r / Sigma)
    g_rr      = Sigma / Delta
    g_thth    = Sigma
    g_phph    = (r^2 + a^2 + 2 M r a^2 sin^2/Sigma) sin^2
    g_tph     = -2 M a r sin^2 / Sigma
Horizon r_+ = M + sqrt(M^2 - a^2).  Equatorial photon-orbit critical impact
parameters: b_pm = -/+ a + 6 M cos[(1/3) arccos(-/+ a/M)] (prograde/retro) —
the validation targets for the tests.

Kerr-Newman (charged + rotating) is the same Boyer-Lindquist form with
    Delta -> r^2 - 2 M r + a^2 + Q^2,    2 M r -> 2 M r - Q^2
everywhere the mass term appears coupled to Sigma; photons are uncharged, so
their geodesics see the charge only through these two substitutions.  Both
classes share the closed forms below via ``_bl_components``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _bl_pieces(m, a, q2, x):
    """Common Boyer-Lindquist scalars: (r, sin^2 th (guarded), Sigma, Delta,
    hmr = 2 M r - Q^2 — the 'effective mass' numerator)."""
    r = x[..., 1]
    th = x[..., 2]
    ct = jnp.cos(th)
    st2 = jnp.maximum(jnp.sin(th) ** 2, 1e-12)
    sigma = r * r + a * a * ct * ct
    delta = r * r - 2.0 * m * r + a * a + q2
    hmr = 2.0 * m * r - q2
    return r, st2, sigma, delta, hmr


def _bl_metric(m, a, q2, x):
    """Covariant g_{mu nu} -> (..., 4, 4) for Kerr(-Newman)."""
    r, st2, sigma, delta, hmr = _bl_pieces(m, a, q2, x)
    g_tt = -(1.0 - hmr / sigma)
    g_rr = sigma / delta
    g_thth = sigma
    g_phph = (r * r + a * a + hmr * a * a * st2 / sigma) * st2
    g_tph = -hmr * a * st2 / sigma
    z = jnp.zeros_like(r)
    row_t = jnp.stack([g_tt, z, z, g_tph], axis=-1)
    row_r = jnp.stack([z, g_rr, z, z], axis=-1)
    row_th = jnp.stack([z, z, g_thth, z], axis=-1)
    row_ph = jnp.stack([g_tph, z, z, g_phph], axis=-1)
    return jnp.stack([row_t, row_r, row_th, row_ph], axis=-2)


def _bl_components(m, a, q2, x):
    """The 5 independent contravariant components as SoA arrays
    (g^tt, g^rr, g^thth, g^phph, g^tph) — avoids (N, 4, 4) layouts in
    the hot march.
    g^tph = -a (r^2 + a^2 - Delta) / (Delta Sigma), and
    r^2 + a^2 - Delta = 2 M r - Q^2 = hmr for Kerr-Newman."""
    r, st2, sigma, delta, hmr = _bl_pieces(m, a, q2, x)
    A = (r * r + a * a) ** 2 - delta * a * a * st2
    inv_ds = 1.0 / (delta * sigma)
    g_tt = -A * inv_ds
    g_rr = delta / sigma
    g_thth = 1.0 / sigma
    g_phph = (delta - a * a * st2) * inv_ds / st2
    g_tph = -hmr * a * inv_ds
    return g_tt, g_rr, g_thth, g_phph, g_tph


def _bl_inverse_metric(m, a, q2, x):
    """Contravariant g^{mu nu} -> (..., 4, 4) (closed form)."""
    g_tt, g_rr, g_thth, g_phph, g_tph = _bl_components(m, a, q2, x)
    z = jnp.zeros_like(g_tt)
    row_t = jnp.stack([g_tt, z, z, g_tph], axis=-1)
    row_r = jnp.stack([z, g_rr, z, z], axis=-1)
    row_th = jnp.stack([z, z, g_thth, z], axis=-1)
    row_ph = jnp.stack([g_tph, z, z, g_phph], axis=-1)
    return jnp.stack([row_t, row_r, row_th, row_ph], axis=-2)


@dataclasses.dataclass(frozen=True)
class KerrMetric:
    m: jax.Array
    a: jax.Array

    def metric(self, x):
        """Covariant g_{mu nu} -> (..., 4, 4)."""
        return _bl_metric(self.m, self.a, 0.0, x)

    def inverse_metric(self, x):
        """Contravariant g^{mu nu} -> (..., 4, 4) (closed form)."""
        return _bl_inverse_metric(self.m, self.a, 0.0, x)

    def inverse_components(self, x):
        """SoA contravariant components (see ``_bl_components``)."""
        return _bl_components(self.m, self.a, 0.0, x)

    @property
    def horizon_radius(self):
        return self.m + jnp.sqrt(jnp.maximum(self.m ** 2 - self.a ** 2, 0.0))

    @property
    def capture_radius(self):
        return 1.05 * self.horizon_radius

    def critical_impact_parameter(self, prograde: bool):
        """Equatorial photon-orbit critical |b| = |L/E| (Bardeen):
        b_pm = s a + 6 M cos[(1/3) arccos(s a / M)], s = -1 prograde /
        +1 retrograde.  Checks: a=0 -> 3 sqrt(3) M; a=M -> 2M / 7M."""
        s = -1.0 if prograde else 1.0
        return (s * self.a + 6.0 * self.m
                * jnp.cos(jnp.arccos(s * self.a / self.m) / 3.0))


jax.tree_util.register_dataclass(KerrMetric, data_fields=["m", "a"],
                                 meta_fields=[])


@dataclasses.dataclass(frozen=True)
class KerrNewmanMetric:
    """Kerr-Newman (charged, rotating) black hole — photons are uncharged,
    so their geodesics are the Kerr flow with Delta -> Delta + Q^2 and
    2 M r -> 2 M r - Q^2.  Another family beyond the reference's
    spherically-symmetric architecture (README.md:111); renders through the
    same BL marchers (autodiff RK4 and the Pallas kernel, which reads Q^2
    from a params slot)."""

    m: jax.Array
    a: jax.Array
    q: jax.Array

    def metric(self, x):
        """Covariant g_{mu nu} -> (..., 4, 4)."""
        return _bl_metric(self.m, self.a, self.q * self.q, x)

    def inverse_metric(self, x):
        """Contravariant g^{mu nu} -> (..., 4, 4) (closed form)."""
        return _bl_inverse_metric(self.m, self.a, self.q * self.q, x)

    def inverse_components(self, x):
        """SoA contravariant components (see ``_bl_components``)."""
        return _bl_components(self.m, self.a, self.q * self.q, x)

    @property
    def horizon_radius(self):
        return self.m + jnp.sqrt(jnp.maximum(
            self.m ** 2 - self.a ** 2 - self.q ** 2, 0.0))

    @property
    def capture_radius(self):
        return 1.05 * self.horizon_radius


jax.tree_util.register_dataclass(KerrNewmanMetric,
                                 data_fields=["m", "a", "q"], meta_fields=[])


def make_kerr(m=1.0, a=0.6) -> KerrMetric:
    m, a = float(m), float(a)
    if m <= 0:
        raise ValueError("Kerr metric requires m > 0")
    if not (0 <= abs(a) < m):
        raise ValueError("Kerr metric requires |a| < m (sub-extremal)")
    return KerrMetric(m=jnp.asarray(m), a=jnp.asarray(a))


def make_kerr_newman(m=1.0, a=0.6, q=0.4) -> KerrNewmanMetric:
    m, a, q = float(m), float(a), float(q)
    if m <= 0:
        raise ValueError("Kerr-Newman metric requires m > 0")
    if a * a + q * q >= m * m:
        raise ValueError(
            "Kerr-Newman metric requires a^2 + q^2 < m^2 (sub-extremal)")
    return KerrNewmanMetric(m=jnp.asarray(m), a=jnp.asarray(a),
                            q=jnp.asarray(q))


def photon_shell_constants(metric, r):
    """(xi, eta) = (L/E, Q/E^2) of the spherical photon orbit at BL radius
    ``r`` — the Bardeen (1973) critical constants, generalized to
    Kerr-Newman (the charge enters only through Delta).

    Spherical orbits satisfy R(r) = R'(r) = 0 with the radial potential
    R = [E(r^2+a^2) - a L]^2 - Delta [(L - a E)^2 + Q]; eliminating the
    bracket between the two conditions gives the closed form

        (r^2 + a^2) - a xi = 4 r Delta / Delta'
        eta = (4 r Delta / Delta')^2 / Delta - (xi - a)^2

    with Delta = r^2 - 2 M r + a^2 + q^2.  Differentiable in every input
    (pytree metric params + r).  Degenerate at a = 0 (xi ~ 1/a): for
    non-rotating holes the shadow is the circle |b| =
    ``critical_impact_parameter`` instead.
    """
    m, a = metric.m, metric.a
    q = getattr(metric, "q", None)
    q2 = q * q if q is not None else jnp.zeros_like(m)
    delta = r * r - 2.0 * m * r + a * a + q2
    w = 4.0 * r * delta / (2.0 * r - 2.0 * m)
    xi = (r * r + a * a - w) / a
    eta = w * w / delta - (xi - a) ** 2
    return xi, eta


def shadow_outline(metric, inclination, n=512):
    """Analytic black-hole shadow boundary seen by a distant observer at
    polar ``inclination`` (radians from the spin axis) -> (alpha, beta).

    Celestial impact parameters of the critical curve (Bardeen 1973):
    alpha = -xi / sin i (displacement parallel to the equator, positive
    away from the approaching/prograde side), beta = +sqrt(eta +
    a^2 cos^2 i - xi^2 cot^2 i) (parallel to the spin axis); the closed
    curve is (alpha, +-beta).  Shell radii whose orbits are not visible at
    this inclination (negative radicand) return NaN — callers plot/use the
    finite segment.  Works for Kerr and Kerr-Newman (a != 0; the a = 0
    shadow is the ``critical_impact_parameter`` circle).

    The reference renders no black holes at all (its README lists them as
    "explicitly impossible"); this is the standard observable for
    comparing rendered shadows against theory (EHT-style analyses) and is
    differentiable end-to-end for fitting (m, a, q, i) to an observed rim.
    """
    m = metric.m
    r_h = metric.horizon_radius
    # the photon shell lies strictly between the horizon and the
    # retrograde equatorial orbit (<= 4M, shrinking with charge)
    r = jnp.linspace(r_h * (1.0 + 1e-4), 4.0 * m + 0.5 * jnp.abs(metric.a),
                     n)
    xi, eta = photon_shell_constants(metric, r)
    si = jnp.sin(inclination)
    ci = jnp.cos(inclination)
    rad = eta + (metric.a * ci) ** 2 - (xi * ci / si) ** 2
    alpha = -xi / si
    beta = jnp.sqrt(jnp.where(rad >= 0.0, rad, jnp.nan))
    alpha = jnp.where(rad >= 0.0, alpha, jnp.nan)
    return alpha, beta
