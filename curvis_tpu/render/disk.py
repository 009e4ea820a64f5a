"""Accretion-disk rendering — the signature black-hole visual.

A thin, luminous disk in the world equatorial plane (z = 0) between inner
and outer radii.  During the planar march each ray tracks its world
z-coordinate z = r(l) (c1 cos psi + c2 sin psi) with (cos psi, sin psi)
advanced incrementally (2 fused ops/step, no per-step trig); a sign change
of z between steps is a disk-plane crossing, and the crossing radius is
linearly interpolated within the step.  The first two hits inside
[r_inner, r_outer] are recorded — the second is the far side of the disk
seen lensed above/below the hole, which is what produces the iconic
"Interstellar" look.

Shading: emissivity ~ (r_in / r)^q with smooth edge fades, optional
gravitational redshift factor A(r)^{1/2} (photons from deeper in the well
arrive dimmer/redder), alpha-composited over the lensed background.

This goes beyond the reference (no disks, no black holes) and beyond its
wishlist.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from curvis_tpu.camera.camera import Camera
from curvis_tpu.env.spherical_image import SphericalImage
from curvis_tpu.metrics.base import Metric
from curvis_tpu.physics import planar as pl
from curvis_tpu.render.fast import (_finish_render, _pixel_dirs_soa,
                                    _spawn_planar_soa)


@dataclasses.dataclass(frozen=True)
class DiskParams:
    r_inner: float = 6.0          # ~ISCO for M=1
    r_outer: float = 14.0
    emissivity_index: float = 2.0
    brightness: float = 1.0
    tint: tuple = (1.0, 0.71, 0.42)     # hot thermal white-orange
    opacity: float = 0.85               # per crossing
    redshift: bool = True
    doppler: bool = True                # relativistic beaming (g^3)
    spin_sign: float = 1.0              # disk rotation sense
    # 'tint': power-law emissivity times a fixed tint, intensity ~ g^3.
    # 'blackbody': Shakura-Sunyaev temperature profile, Planck colors, and
    # the full chromatic shift: observed T = g * T_emit, luminance ~ T_obs^4
    # (so Doppler blue-shifts the approaching side toward white-blue and
    # red-dims the receding side — physical color, not just intensity).
    color_mode: str = "tint"
    t_peak: float = 9000.0              # peak emitted temperature [K]
    # Finite-thickness slab shading (0 disables, bit-exact with the thin
    # model): emission/absorption scale with the chord length through the
    # slab, 1/|cos xi| for crossing obliquity xi — grazing rays see more
    # material (limb brightening + higher optical depth) while face-on views
    # are unchanged.  Pure shading: the crossing geometry already determines
    # the chord, so the march is untouched.  Planar renderers only (the Kerr
    # kernel records crossing radii, not obliquities).
    thickness: float = 0.0              # slab aspect (chord cap ~ 8x)
    # True volumetric transfer (DNGR-style): per-step emission/absorption
    # through a flared Gaussian gas distribution
    #     rho(r_cyl, z) = exp(-z^2 / 2 H^2) / (sqrt(2 pi) H),  H = h_rel r_cyl
    # integrated along the ray inside the march (I = int j e^{-tau} ds,
    # dtau = kappa rho ds).  The vertical column integrates to 1, so a
    # face-on crossing deposits ~kappa of optical depth and ~(thin glow) of
    # emission — `brightness` and the radial profiles mean the same thing in
    # both models, and kappa ~ -ln(1 - opacity) reproduces the thin disk's
    # per-crossing alpha in the face-on limit.  Replaces the two-crossing
    # model entirely when enabled (soft edges, self-obscuration, grazing
    # limb brightening all emerge from the integral).
    volumetric: bool = False
    h_rel: float = 0.08                 # disk scale height H / r_cyl
    kappa: float = 2.0                  # absorption per vertical column
    tau_max: float = 12.0               # stop marching once this opaque
    # Starlight on the disk (render/starlight.py): Lambertian reflection of
    # the LENSED background sky off the disk surface — light bent around
    # the hole illuminates the far side, the horizon casts its shadow onto
    # the disk, the annulus can shadow itself, and infalling starlight is
    # gravitationally blueshifted.  The illumination integral is collapsed
    # by spherical symmetry to one (n_r x n_samples) reduced-ray march
    # (independent of image resolution and camera pose — video batches
    # amortize it to ~zero).  Thin-crossing shading only (volumetric gas
    # scattering is a different transfer problem).
    starlight: bool = False
    albedo: tuple = (0.4, 0.4, 0.4)     # Lambertian surface albedo (RGB)
    starlight_samples: int = 128        # hemisphere rays per map texel row
    starlight_grid: tuple = (48, 128)   # (n_r, n_phi) map resolution
    starlight_blueshift: bool = True    # A^-2 infall boost (Liouville)
    starlight_self_shadow: bool = True  # annulus attenuates its own sky
    # Volumetric starlight: single-scattering of the lensed sky IN the gas
    # (render/starlight.starlight_scatter_block): kappa_s =
    # starlight_scatter * kappa; 0 disables the source term
    starlight_scatter: float = 1.0
    # Two-sheet map for asymmetric (tabulated) wormholes: a second table
    # for the l -> -l mirrored metric with the skies swapped; hits select
    # their sheet by the sign of the recorded crossing coordinate
    # (render/starlight.py round-5 — symmetric shapes don't need it)
    starlight_two_sheet: bool = False


# Numeric DiskParams fields a differentiable render may override with
# traced scalars (smooth knobs only — mode switches like color_mode /
# volumetric / starlight / thickness stay static).
DIFF_DISK_KEYS = frozenset({
    "r_inner", "r_outer", "h_rel", "kappa", "t_peak", "emissivity_index",
    "spin_sign", "brightness", "opacity", "tint", "albedo",
    "starlight_scatter"})


class DiskView:
    """Duck-typed DiskParams view with traced numeric overrides.

    The static ``DiskParams`` stays the jit cache key (mode flags, the
    march's recording band); a ``disk_theta`` dict of traced scalars
    overrides the smooth shading/emission knobs so inverse problems can
    differentiate d(image)/d(disk params).  For the THIN disk the march
    records crossings in the static [r_inner, r_outer] band while the
    shader's traced edges move within it (set the static band with margin);
    the volumetric march consumes the traced values directly (see
    integrate/kerr_surface_adjoint.build_vol_row)."""

    __slots__ = ("_base", "_over")

    def __init__(self, base, over):
        bad = set(over) - DIFF_DISK_KEYS
        if bad:
            raise ValueError(f"disk_theta: non-differentiable or unknown "
                             f"keys {sorted(bad)}; allowed: "
                             f"{sorted(DIFF_DISK_KEYS)}")
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_over", dict(over))

    def __getattr__(self, name):
        over = object.__getattribute__(self, "_over")
        if name in over:
            return over[name]
        return getattr(object.__getattribute__(self, "_base"), name)


def disk_view(params, disk_theta=None):
    """``params`` unless ``disk_theta`` overrides apply (then a DiskView)."""
    if not disk_theta:
        return params
    return DiskView(params, disk_theta)


_BB_C2 = 1.4388e-2                      # Planck c2 = h c / k_B  [m K]
_BB_LAMBDA = (610e-9, 550e-9, 465e-9)   # RGB sample wavelengths [m]


def blackbody_rgb(T):
    """Linear-RGB chromaticity of a Planck radiator: Planck's law sampled at
    610/550/465 nm, normalized to max channel 1 per element.  Computed in
    log space so arbitrarily cold temperatures stay finite (the naive
    1/expm1 form overflows to 0/0 = NaN below ~300 K in f32); smooth and
    differentiable from deep red through blue-white."""
    T = jnp.maximum(T, 1.0)
    lams = jnp.asarray(_BB_LAMBDA, T.dtype)
    x = _BB_C2 / (lams * T[..., None])
    # ln(expm1(x)) ~ x for large x; the min() keeps expm1 finite everywhere
    log_denom = jnp.where(x < 20.0,
                          jnp.log(jnp.expm1(jnp.minimum(x, 20.0))), x)
    log_i = -5.0 * jnp.log(lams) - log_denom
    log_i = log_i - jnp.max(log_i, axis=-1, keepdims=True)
    return jnp.exp(log_i)


def disk_temperature(r, params: DiskParams):
    """Thin-disk (Shakura-Sunyaev) effective temperature profile
    T(r) ~ r^{-3/4} (1 - sqrt(r_in/r))^{1/4}, normalized so the peak (at
    r = 49/36 r_in) is ``t_peak``; zero at the inner edge (cold ISCO)."""
    r_in = params.r_inner
    r = jnp.maximum(r, r_in)
    f = r ** -0.75 * (1.0 - jnp.sqrt(r_in / r)) ** 0.25
    rp = (49.0 / 36.0) * r_in
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25   # 1 - sqrt(36/49) = 1/7
    return params.t_peak * f / f_peak


def _emission_rgb(r_hit, g, params: DiskParams, dtype, path=None,
                  starlight=None):
    """Shared disk emission (planar + Kerr shaders): color and alpha of a
    crossing at radius r_hit (0 = no hit) with total shift factor g.

    ``path`` (finite-thickness mode, `params.thickness` > 0): per-ray chord
    length through the slab in units of the vertical thickness (>= 1).
    Emission scales with the column (saturating under the filmic exposure in
    blackbody mode), and absorption follows Beer's law — alpha =
    1 - (1 - alpha_thin)^path, which reduces EXACTLY to the thin model at
    path = None (the thin formula is used verbatim, not path = 1 through
    pow, so thickness = 0 stays bit-identical).

    ``starlight``: (N, 3) albedo-weighted reflected-sky radiance at the hit
    (render/starlight.py).  Added to the emission with the surface-presence
    edge fades and the same g^3 beaming as the tint emission (a moving
    reflector beams exactly like a moving emitter); it does not change
    alpha (opacity is a property of the material, not its illumination)."""
    hit = r_hit > 0.0
    w = params.r_outer - params.r_inner
    edge_in = jnp.clip((r_hit - params.r_inner) / (0.1 * w), 0.0, 1.0)
    edge_out = jnp.clip((params.r_outer - r_hit) / (0.3 * w), 0.0, 1.0)
    column = 1.0 if path is None else path
    if params.color_mode == "blackbody":
        t_obs = g * disk_temperature(r_hit, params)
        rel = (t_obs / params.t_peak) ** 4         # Stefan-Boltzmann
        lum = 1.0 - jnp.exp(-params.brightness * rel * column)   # filmic
        glow = lum * edge_out                      # T profile fades the
        rgb = blackbody_rgb(t_obs) * glow[:, None]  # inner edge physically
    else:
        rr = jnp.maximum(r_hit, params.r_inner)
        emis = (params.r_inner / rr) ** params.emissivity_index
        glow = params.brightness * emis * edge_in * edge_out * column
        glow = glow * jnp.clip(g, 0.0, 4.0) ** 3
        tint = jnp.asarray(params.tint, dtype)
        rgb = glow[:, None] * tint[None, :]
    if starlight is not None:
        beam = (edge_in * edge_out * jnp.clip(g, 0.0, 4.0) ** 3)
        rgb = rgb + starlight * beam[:, None]
    alpha_thin = params.opacity * jnp.clip(glow, 0.25, 1.0)
    if path is not None:
        alpha_thin = 1.0 - (1.0 - alpha_thin) ** path
    alpha = jnp.where(hit, alpha_thin, 0.0)
    return rgb, alpha


def march_planar_disk(metric: Metric, rays: pl.PlanarRays, c1, c2, *, dt,
                      max_steps, escape_radius, r_inner, r_outer):
    """While-loop planar march that also records the first two disk-plane
    crossings with radius inside [r_inner, r_outer].

    ``c1``, ``c2``: per-ray z-components of the orbital-plane basis
    (e1_z, e2_z) so that z = r(l) (c1 cos psi + c2 sin psi).
    Returns (PlanarResult, (hit1_r, hit1_pl, hit1_psi),
    (hit2_r, hit2_pl, hit2_psi)) with r = 0.0 marking "no hit"; pl is the
    radial momentum at the crossing (Doppler shading) and psi the in-plane
    angle at the crossing, from which the shader reconstructs the WORLD
    hit position r_hit (e1 cos psi + e2 sin psi) and the approach side
    sign(z_before) = -sign(b) sign(c2 cos psi - c1 sin psi) (psi is
    monotone with sign(b), so z just before the crossing sits opposite the
    zq derivative) — the starlight shading contract (render/starlight.py).
    """
    dtype = rays.l.dtype
    dt = jnp.asarray(dt, dtype)
    r_cap = pl._capture_radius(metric)

    l0 = rays.l
    u0 = jnp.cos(rays.psi)
    v0 = jnp.sin(rays.psi)
    z0 = metric.r(l0) * (c1 * u0 + c2 * v0)
    zeros = jnp.zeros_like(l0)
    state0 = (rays.l, rays.psi, rays.p_l, u0, v0, z0,
              zeros, zeros, zeros, zeros, zeros, zeros,
              jnp.zeros(l0.shape, jnp.int32), jnp.zeros(l0.shape, jnp.int32),
              jnp.int32(0))

    def cond(c):
        sign = c[12]
        it = c[14]
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        l, psi, p_l, u, v, z, h1, h1p, h1s, h2, h2p, h2s, sign, steps, it = c
        active = sign == 0
        # geodesic step + incremental rotation of (cos psi, sin psi)
        dl, dpsi, dpl = pl.planar_rhs(metric, l, psi, p_l, rays.b)
        l1 = l + dt * dl
        psi1 = psi + dt * dpsi
        pl1 = p_l + dt * dpl
        du = dt * dpsi
        u1 = u - v * du
        v1 = v + u * du
        z1 = metric.r(l1) * (c1 * u1 + c2 * v1)
        # disk crossing: z changes sign within the step
        crossed = active & (z * z1 < 0.0)
        frac = jnp.abs(z) / jnp.maximum(jnp.abs(z) + jnp.abs(z1), 1e-30)
        lh = l + frac * (l1 - l)      # SIGNED: |lh| = radius, sign = sheet
        r_hit = jnp.abs(lh)
        in_disk = crossed & (r_hit >= r_inner) & (r_hit <= r_outer)
        pl_hit = p_l + frac * (pl1 - p_l)
        psi_hit = psi + frac * (psi1 - psi)
        new_h1 = in_disk & (h1 == 0.0)
        new_h2 = in_disk & (h1 != 0.0) & (h2 == 0.0)
        h1 = jnp.where(new_h1, lh, h1)
        h1p = jnp.where(new_h1, pl_hit, h1p)
        h1s = jnp.where(new_h1, psi_hit, h1s)
        h2 = jnp.where(new_h2, lh, h2)
        h2p = jnp.where(new_h2, pl_hit, h2p)
        h2s = jnp.where(new_h2, psi_hit, h2s)

        l = jnp.where(active, l1, l)
        psi = jnp.where(active, psi1, psi)
        p_l = jnp.where(active, pl1, p_l)
        u = jnp.where(active, u1, u)
        v = jnp.where(active, v1, v)
        z = jnp.where(active, z1, z)
        sign = jnp.where(active & (l > escape_radius), 1,
                         jnp.where(active & (l < -escape_radius), -1, sign))
        if r_cap is not None:
            sign = jnp.where(active & (l < r_cap), pl.CAPTURED, sign)
        steps = steps + active.astype(jnp.int32)
        return (l, psi, p_l, u, v, z, h1, h1p, h1s, h2, h2p, h2s, sign,
                steps, it + 1)

    out = lax.while_loop(cond, body, state0)
    l, psi, p_l, _, _, _, h1, h1p, h1s, h2, h2p, h2s, sign, steps, _ = out
    return (pl.PlanarResult(l, psi, p_l, sign, steps),
            (h1, h1p, h1s), (h2, h2p, h2s))


# Rays frozen by the tau_max cutoff: rendered with their accumulated
# emission only (transmittance <= e^-tau_max makes any background invisible).
# Shares the CAPTURED black-background readout semantics.
OPAQUE_SIGN = pl.CAPTURED


def march_planar_disk_volumetric(metric: Metric, rays: pl.PlanarRays, c1, c2,
                                 nz, *, dt, max_steps, escape_radius,
                                 params: DiskParams, scatter_block=None):
    """Planar march with per-step volumetric radiative transfer through the
    flared Gaussian disk (see DiskParams.volumetric).

    Per step (ds = dt, the affine step — unit coordinate speed for the
    reference's unit-lapse metrics): optical depth dtau = kappa rho ds and
    emission dI = e^{-tau} w(r_cyl, g) rho ds are accumulated, where w is the
    same radial/spectral weight the thin-disk shader uses per crossing
    (tint: emis(r_cyl) g^3 brightness; blackbody: (g T(r_cyl)/t_peak)^4 with
    the Planck chromaticity folded into 3 channels).  The vertical Gaussian
    needs no sqrt: with zq = z / r(l), z^2 / 2H^2 = zq^2 / (2 h_rel^2
    (1 - zq^2)).  A ray is frozen (sign = OPAQUE_SIGN) once tau > tau_max.

    Returns (PlanarResult, tau, (em_r, em_g, em_b)) — em_* are
    pre-transmittance-weighted linear emission accumulators (tint mode:
    grayscale energy replicated later by the tint; the shader applies the
    filmic curve / tint at the end).
    """
    dtype = rays.l.dtype
    dt = jnp.asarray(dt, dtype)
    r_cap = pl._capture_radius(metric)
    general = not pl._unit_lapse(metric)
    blackbody = params.color_mode == "blackbody"
    h2 = params.h_rel * params.h_rel
    inv_norm = float(1.0 / (np.sqrt(2.0 * np.pi) * params.h_rel))
    w_edge = params.r_outer - params.r_inner

    def step_emission(l, p_l, zq, r, tau):
        """(dtau, demr, demg, demb) at the post-step state (frac of ds=dt
        applied by the caller)."""
        zq2 = zq * zq
        s2 = jnp.clip(1.0 - zq2, 1e-12, 1.0)
        r_cyl = r * jnp.sqrt(s2)
        dens = jnp.exp(-zq2 / (2.0 * h2 * s2)) * (inv_norm / r_cyl)
        edge_in = jnp.clip((r_cyl - params.r_inner) / (0.1 * w_edge), 0., 1.)
        edge_out = jnp.clip((params.r_outer - r_cyl) / (0.3 * w_edge), 0., 1.)
        base = dens * edge_in * edge_out
        rr = jnp.maximum(r_cyl, params.r_inner)
        g = jnp.ones_like(r_cyl)
        if general:
            A = jnp.clip(metric.lapse(rr), 1e-3, 1.0)
            sqA = jnp.sqrt(A)
            if params.redshift:
                g = sqA
            if params.doppler:
                M = metric.m
                q = getattr(metric, "q", None)      # Reissner-Nordstrom
                vsq = (M - q * q / rr) / rr if q is not None else M / rr
                v = jnp.clip(jnp.sqrt(vsq) / sqA, 0.0, 0.99)
                gamma = jax.lax.rsqrt(1.0 - v * v)
                u_l = p_l * sqA
                u_psi = rays.b / rr
                inv = jax.lax.rsqrt(u_l * u_l + u_psi * u_psi + 1e-30)
                cos_xi = (u_psi * inv) * nz * params.spin_sign
                g = g / (gamma * (1.0 - v * cos_xi))
        trans = jnp.exp(-tau)
        dtau = params.kappa * base
        scat = None
        if scatter_block is not None:
            # starlight single-scattering source (the kernel's exact form,
            # ops/march_pallas._vol_emission scatter branch)
            from curvis_tpu.ops.march_pallas import SCATTER_DEG
            t = jnp.clip(2.0 * (r_cyl - params.r_inner)
                         / (params.r_outer - params.r_inner) - 1.0,
                         -1.0, 1.0)
            sw = trans * base
            scat = []
            for c in range(3):
                c0 = 3 + c * (SCATTER_DEG + 1)
                acc = scatter_block[c0 + SCATTER_DEG]
                for k in range(SCATTER_DEG - 1, -1, -1):
                    acc = acc * t + scatter_block[c0 + k]
                scat.append(sw * jnp.maximum(acc, 0.0))
        if blackbody:
            t_obs = g * disk_temperature(rr, params)
            rel = (t_obs / params.t_peak) ** 4
            chroma = blackbody_rgb(t_obs)          # (..., 3)
            w = trans * base * rel
            out = [w * chroma[..., 0], w * chroma[..., 1],
                   w * chroma[..., 2]]
            if scat is not None:
                out = [o + sc for o, sc in zip(out, scat)]
            return dtau, out[0], out[1], out[2]
        emis = (params.r_inner / rr) ** params.emissivity_index
        w = trans * base * emis * jnp.clip(g, 0.0, 4.0) ** 3
        if scat is not None:
            # colored scattering: fold the tint per channel in-march
            return (dtau, w * scatter_block[0] + scat[0],
                    w * scatter_block[1] + scat[1],
                    w * scatter_block[2] + scat[2])
        return dtau, w, w, w

    l0 = rays.l
    u0 = jnp.cos(rays.psi)
    v0 = jnp.sin(rays.psi)
    zq0 = c1 * u0 + c2 * v0
    zeros = jnp.zeros_like(l0)
    state0 = (rays.l, rays.psi, rays.p_l, u0, v0, zq0,
              zeros, zeros, zeros, zeros,
              jnp.zeros(l0.shape, jnp.int32), jnp.zeros(l0.shape, jnp.int32),
              jnp.int32(0))

    def cond(c):
        sign = c[10]
        it = c[12]
        return (it < max_steps) & jnp.any(sign == 0)

    def body(c):
        l, psi, p_l, u, v, zq, tau, emr, emg, emb, sign, steps, it = c
        active = sign == 0
        dte = jnp.where(active, dt, 0.0)
        dl, dpsi, dpl = pl.planar_rhs(metric, l, psi, p_l, rays.b)
        l = l + dte * dl
        psi = psi + dte * dpsi
        p_l = p_l + dte * dpl
        du = dte * dpsi
        u, v = u - v * du, v + u * du
        zq = c1 * u + c2 * v
        dtau, dr_, dg_, db_ = step_emission(l, p_l, zq, metric.r(l), tau)
        emr = emr + dte * dr_
        emg = emg + dte * dg_
        emb = emb + dte * db_
        tau = tau + dte * dtau
        sign = jnp.where(active & (l > escape_radius), 1,
                         jnp.where(active & (l < -escape_radius), -1, sign))
        if r_cap is not None:
            sign = jnp.where(active & (l < r_cap), pl.CAPTURED, sign)
        # escape/capture this step wins over the opacity freeze (kernel
        # parity: ops/march_pallas.py:_disk_vol_kernel)
        sign = jnp.where((sign == 0) & (tau > params.tau_max), OPAQUE_SIGN,
                         sign)
        steps = steps + active.astype(jnp.int32)
        return l, psi, p_l, u, v, zq, tau, emr, emg, emb, sign, steps, it + 1

    out = lax.while_loop(cond, body, state0)
    l, psi, p_l, _, _, _, tau, emr, emg, emb, sign, steps, _ = out
    return pl.PlanarResult(l, psi, p_l, sign, steps), tau, (emr, emg, emb)


def _volumetric_rgb(tau, em, params: DiskParams, dtype, scatter=False):
    """Final color+transmittance of the volumetric integral: filmic exposure
    (blackbody) or tint scaling (tint mode) on the accumulated linear
    emission; transmittance e^{-tau} weights the background.  ``scatter``:
    the march already folded the tint per channel (colored scattered
    starlight rides the accumulators), so tint mode scales channels
    directly."""
    emr, emg, emb = em
    if params.color_mode == "blackbody":
        rgb = 1.0 - jnp.exp(-params.brightness
                            * jnp.stack([emr, emg, emb], axis=-1))
    elif scatter:
        rgb = jnp.clip(params.brightness
                       * jnp.stack([emr, emg, emb], axis=-1), 0.0, 1.0)
    else:
        tint = jnp.asarray(params.tint, dtype)
        rgb = jnp.clip(params.brightness * emr, 0.0, 1.0)[:, None] * tint
    return rgb, jnp.exp(-tau)


def _disk_rgb(metric, r_hit, pl_hit, b, nz, params: DiskParams, dtype,
              starlight=None):
    """Emission color+alpha of a disk crossing at radius r_hit (0 = none).

    Doppler beaming: disk material orbits at v = sqrt(M/r)/sqrt(1-2M/r)
    (local static-frame speed of a circular geodesic).  The cosine between
    the photon's local direction and the flow reduces to u_psi_hat * n_z
    where n_z is the photon plane normal's z-component (the plane meets the
    equatorial plane along the radial direction at the hit, so the
    projection of the photon's transverse direction onto phi_hat is exactly
    n.z — a per-ray constant).  Total g = sqrt(A) / (gamma (1 - v cos_xi)),
    intensity scaled by g^3.
    """
    r_hit = jnp.abs(r_hit)      # planar hits are SIGNED (sheet = sign)
    rr = jnp.maximum(r_hit, params.r_inner)
    g = jnp.ones_like(r_hit)
    general = not pl._unit_lapse(metric)
    A = jnp.clip(metric.lapse(rr), 1e-3, 1.0) if general \
        else jnp.ones_like(rr)
    if general and (params.redshift or params.doppler):
        if params.redshift:
            g = jnp.sqrt(A)
        if params.doppler:
            M = metric.m
            q = getattr(metric, "q", None)          # Reissner-Nordstrom
            vsq = (M - q * q / rr) / rr if q is not None else M / rr
            v = jnp.sqrt(vsq) / jnp.sqrt(A)
            v = jnp.clip(v, 0.0, 0.99)
            gamma = jax.lax.rsqrt(1.0 - v * v)
            # photon local direction components at the crossing
            u_l = pl_hit * jnp.sqrt(A)
            u_psi = b / rr
            inv = jax.lax.rsqrt(u_l * u_l + u_psi * u_psi + 1e-30)
            cos_xi = (u_psi * inv) * nz * params.spin_sign
            g = g / (gamma * (1.0 - v * cos_xi))
    path = None
    if params.thickness > 0.0:
        # chord through the flared slab, in units of its thickness:
        # 1/|cos xi_z| with xi_z the angle between the photon direction and
        # the vertical at the crossing.  The crossing's z-velocity is purely
        # transverse (z = 0 kills the radial term), u_psi * t_hat_z, and the
        # transverse basis vector's z-component there is sqrt(1 - nz^2)
        # (z-column of the orthonormal [e1 e2 n] frame has unit norm) — all
        # per-ray constants, so thickness costs nothing in the march.
        u_l = pl_hit * jnp.sqrt(A)
        u_psi = b / rr
        speed = jnp.sqrt(u_l * u_l + u_psi * u_psi)
        tz = jnp.sqrt(jnp.clip(1.0 - nz * nz, 0.0, 1.0))
        zvel = jnp.abs(u_psi) * tz
        # the chord cap is the slab's in-plane extent over its height,
        # ~ 1/aspect: grazing rays through a fat slab saturate sooner
        cap = float(np.clip(1.0 / params.thickness, 1.0, 8.0))
        path = jnp.clip(speed / jnp.maximum(zvel, 1e-30), 1.0, cap)
    return _emission_rgb(r_hit, g, params, dtype, path=path,
                         starlight=starlight)


def render_blackhole_disk(metric: Metric, camera: Camera,
                          bg: SphericalImage, *, dt=0.02, max_steps=100_000,
                          escape_radius=100.0, disk: DiskParams = None,
                          filtering="bilinear", backend="auto",
                          stepper="euler", rtol=1e-5,
                          starlight_map=None, differentiable=None,
                          disk_theta=None):
    """(H, W, 3): lensed background + shadow + two-crossing accretion disk.

    ``backend='auto'`` uses the Pallas disk kernel on the GPU (block-level
    early exit), the XLA while-loop elsewhere (curvis_tpu/dispatch.py).
    Self-jitting: eager calls reuse a cached compiled bundle.

    ``stepper='rk45'`` switches the march (thin-crossing AND volumetric)
    to the error-controlled DP5(4) pair with per-ray adaptive dt bounded
    by ``rtol`` (``dt`` becomes the initial step; near/inside the disk the
    step clamps to ``dt`` so crossing capture and the gas quadrature keep
    base resolution) — the planar stepper x surface matrix is complete
    (round 4; max_steps then counts ACCEPTED steps, so pass rk45-scale
    values ~1000-2000, not the Euler 100k).

    ``starlight_map``: a precomputed render/starlight.StarlightMap.  The
    map depends only on (metric, background, disk), never on the camera —
    compute it once with ``compute_starlight_map`` and reuse it for every
    frame of a video (None recomputes it inside this call).

    ``differentiable='scan'|'adjoint'`` switches the march to the planar
    surface adjoints (integrate/planar_surface_adjoint.py, round 5): exact
    checkpointed-recompute gradients through the thin-disk crossings or the
    volumetric radiative transfer, for BOTH steppers — 'scan' is the XLA
    pair, 'adjoint' the kernel forward with the XLA backward.  ``disk_theta`` (a dict
    of traced scalars, see render/disk.DIFF_DISK_KEYS) overrides smooth
    disk parameters so d(image)/d(r_inner, kappa, brightness, ...) flows;
    with the volumetric model the overrides enter the march itself."""
    disk = disk or DiskParams()
    if backend == "auto":
        backend = _auto_backend(camera.position.dtype)
    return _render_disk_jit(metric, (camera,), bg, jnp.asarray(dt),
                            jnp.asarray(escape_radius), starlight_map,
                            disk_theta,
                            max_steps=max_steps,
                            disk=disk, filtering=filtering, backend=backend,
                            stepper=stepper, rtol=rtol,
                            differentiable=differentiable)[0]


def render_disk_frames_batched(metric: Metric, cameras, bg: SphericalImage,
                               *, dt=0.02, max_steps=100_000,
                               escape_radius=100.0, disk: DiskParams = None,
                               filtering="bilinear", backend="auto",
                               stepper="euler", rtol=1e-5,
                               starlight_map=None, differentiable=None,
                               disk_theta=None):
    """Several disk frames in ONE device call -> (F, H, W, 3): the video
    workload's frame axis batched into a single march bundle (same scheme as
    render/fast.render_frames_batched).  ``starlight_map``: see
    render_blackhole_disk (precompute once per video)."""
    disk = disk or DiskParams()
    cameras = tuple(cameras)
    if backend == "auto":
        backend = _auto_backend(cameras[0].position.dtype)
    return _render_disk_jit(metric, cameras, bg, jnp.asarray(dt),
                            jnp.asarray(escape_radius), starlight_map,
                            disk_theta,
                            max_steps=max_steps,
                            disk=disk, filtering=filtering, backend=backend,
                            stepper=stepper, rtol=rtol,
                            differentiable=differentiable)


def compute_starlight_map(metric: Metric, bg: SphericalImage,
                          disk: DiskParams, *, dt=0.02, max_steps=100_000,
                          escape_radius=100.0, filtering="bilinear",
                          backend="auto", stepper="euler", rtol=1e-5):
    """The camera-independent starlight map for ``disk`` around ``metric``
    under sky ``bg`` — precompute once and pass as ``starlight_map=`` to
    the disk renderers to amortize the illumination integral across a
    whole video (it is by far the dominant part of the starlight overhead).
    Jitted; reuses the same march backend/stepper knobs as the renderers."""
    if backend == "auto":
        backend = _auto_backend(bg.texture.dtype)
    return _starlight_map_jit(metric, bg, jnp.asarray(dt),
                              jnp.asarray(escape_radius),
                              max_steps=max_steps, disk=disk,
                              filtering=filtering, backend=backend,
                              stepper=stepper, rtol=rtol)


def _auto_backend(dtype):
    from curvis_tpu.dispatch import use_kernel
    return "pallas" if use_kernel(dtype) else "while"


def _starlight_map_impl(metric, bg, dt, escape_radius, *, max_steps, disk,
                        filtering, backend, stepper, rtol):
    from curvis_tpu.render.starlight import compute_disk_starlight_map
    n_r_s, n_phi_s = disk.starlight_grid
    return compute_disk_starlight_map(
        metric, bg, bg, r_inner=disk.r_inner, r_outer=disk.r_outer,
        escape_radius=escape_radius, dt=dt, max_steps=max_steps,
        n_r=n_r_s, n_phi=n_phi_s, n_samples=disk.starlight_samples,
        filtering=filtering, backend=backend, stepper=stepper, rtol=rtol,
        blueshift=disk.starlight_blueshift,
        shadow_params=disk if disk.starlight_self_shadow else None,
        two_sheet=disk.starlight_two_sheet)


_starlight_map_jit = jax.jit(
    lambda *a, **k: _starlight_map_impl(*a, **k),
    static_argnames=("max_steps", "disk", "filtering", "backend",
                     "stepper", "rtol"))


def _render_disk_impl(metric, cameras, bg, dt, escape_radius, smap=None,
                      disk_theta=None, *,
                      max_steps, disk, filtering, backend, stepper="euler",
                      rtol=1e-5, differentiable=None):
    cams = list(cameras)
    W, H = cams[0].resolution_x, cams[0].resolution_y
    if any((c.resolution_x, c.resolution_y) != (W, H) for c in cams):
        raise ValueError("all cameras in a batch must share a resolution")
    F = len(cams)
    n = W * H
    per = []
    for cam in cams:
        dx, dy, dz = _pixel_dirs_soa(cam, False)
        per.append(_spawn_planar_soa(metric, cam, dx, dy, dz))
    l = jnp.concatenate([p[0][0] for p in per])
    psi = jnp.concatenate([p[0][1] for p in per])
    p_l = jnp.concatenate([p[0][2] for p in per])
    b = jnp.concatenate([p[0][3] for p in per])

    def chain(idx, comp):
        return jnp.concatenate([jnp.broadcast_to(p[idx][comp], (n,))
                                for p in per])

    r_hat = (chain(1, 0), chain(1, 1), chain(1, 2))
    e2 = (chain(2, 0), chain(2, 1), chain(2, 2))
    # world z-components of each ray's in-plane basis: e1 = r_hat (per-frame
    # camera direction), e2 per-ray
    c1 = r_hat[2]
    c2 = e2[2]
    rays = pl.PlanarRays(l, psi, p_l, b, jnp.zeros((1, 3), l.dtype),
                         jnp.zeros((1, 3), l.dtype))
    # photon plane normal z-component: n = e1 x e2 -> n_z = e1x e2y - e1y e2x
    nz = r_hat[0] * e2[1] - r_hat[1] * e2[0]
    vol = disk.volumetric
    scatter_block = None
    if disk.starlight and vol:
        # in-gas single scattering of the lensed sky (VERDICT round-4 #3a):
        # the starlight map's radial profile rides the scalar row as a
        # monomial tail; the kernels add trans * rho * kappa_s albedo_c
        # Ebar_c per accepted step
        if differentiable and smap is None:
            raise ValueError(
                "differentiable volumetric starlight needs a precomputed "
                "starlight_map= (the illumination map is treated as data; "
                "tracing gradients through its own construction would "
                "differentiate through the map marches — compute it once "
                "with compute_disk_starlight_map)")
        from curvis_tpu.render.starlight import starlight_scatter_block
        if smap is None:
            smap = _starlight_map_impl(
                metric, bg, dt, escape_radius, max_steps=max_steps,
                disk=disk, filtering=filtering, backend=backend,
                stepper=stepper, rtol=rtol)
        scatter_block = starlight_scatter_block(
            smap, disk_view(disk, disk_theta), l.dtype)
    if differentiable:
        # round 5: the planar surface adjoints — exact checkpointed-
        # recompute gradients through thin-disk crossings / volumetric
        # transfer for both steppers ('scan' = XLA pair, 'adjoint' =
        # kernel forward + XLA backward); traced disk params ride disk_theta
        from curvis_tpu.integrate.planar_surface_adjoint import (
            march_planar_disk_adjoint, march_planar_vol_adjoint)
        mb = "xla" if differentiable == "scan" else "auto"
        kwd = dict(dt=dt, max_steps=max_steps, escape_radius=escape_radius,
                   stepper=stepper, backend=mb)
        if stepper == "rk45":
            kwd["rtol"] = rtol
            kwd["atol"] = rtol * 1e-3
        if vol:
            out = march_planar_vol_adjoint(
                metric, (l, psi, p_l), b, c1, c2, nz, disk,
                disk_theta=disk_theta, scatter_block=scatter_block, **kwd)
            res = pl.PlanarResult(*out[:5])
            tau, em = out[5]
        else:
            out = march_planar_disk_adjoint(
                metric, (l, psi, p_l), b, c1, c2, r_inner=disk.r_inner,
                r_outer=disk.r_outer, **kwd)
            res = pl.PlanarResult(*out[:5])
            h1, h2 = out[5]
    elif stepper == "rk45":
        kw45 = dict(dt0=dt, max_steps=max_steps,
                    escape_radius=escape_radius, rtol=rtol,
                    atol=rtol * 1e-3)
        if backend == "pallas":
            from curvis_tpu.ops.march_pallas import march_planar_rk45_pallas
            if vol:
                res, tau, em = march_planar_rk45_pallas(
                    metric, rays, c1=c1, c2=c2, nz=nz, vol_disk=disk,
                    scatter_block=scatter_block, **kw45)
            else:
                res, h1, h2 = march_planar_rk45_pallas(
                    metric, rays, c1=c1, c2=c2,
                    disk=(disk.r_inner, disk.r_outer), **kw45)
        else:
            from curvis_tpu.integrate.rk45 import march_planar_rk45
            if vol:
                res, tau, em = march_planar_rk45(
                    metric, rays, c1=c1, c2=c2, nz=nz, vol_disk=disk,
                    scatter_block=scatter_block, **kw45)
            else:
                res, h1, h2 = march_planar_rk45(
                    metric, rays, c1=c1, c2=c2,
                    disk=(disk.r_inner, disk.r_outer), **kw45)
    elif vol and backend == "pallas":
        from curvis_tpu.ops.march_pallas import \
            march_planar_disk_volumetric_pallas
        res, tau, em = march_planar_disk_volumetric_pallas(
            metric, rays, c1, c2, nz, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, disk=disk,
            scatter_block=scatter_block)
    elif vol:
        res, tau, em = march_planar_disk_volumetric(
            metric, rays, c1, c2, nz, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, params=disk,
            scatter_block=scatter_block)
    elif backend == "pallas":
        from curvis_tpu.ops.march_pallas import march_planar_disk_pallas
        res, h1, h2 = march_planar_disk_pallas(
            metric, rays, c1, c2, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, r_inner=disk.r_inner,
            r_outer=disk.r_outer)
    else:
        res, h1, h2 = march_planar_disk(
            metric, rays, c1, c2, dt=dt, max_steps=max_steps,
            escape_radius=escape_radius, r_inner=disk.r_inner,
            r_outer=disk.r_outer)
    # background color via the standard readout/shade tail
    imgs_bg = _finish_render(metric, cams[0], bg, bg,
                             (res.l, res.psi, res.p_l, b), r_hat, e2,
                             dt=dt, max_steps=max_steps,
                             escape_radius=escape_radius, filtering=filtering,
                             backend="precomputed", stepper="euler",
                             n_frames=F, precomputed=res)
    if F == 1:
        imgs_bg = imgs_bg[None]
    bg_colors = imgs_bg.transpose(0, 2, 1, 3).reshape(-1, 3)
    if vol:
        rgb, trans = _volumetric_rgb(tau, em, disk_view(disk, disk_theta),
                                     l.dtype,
                                     scatter=scatter_block is not None)
        out = jnp.clip(rgb + trans[:, None] * bg_colors, 0.0, 1.0)
        return out.reshape(F, W, H, 3).transpose(0, 2, 1, 3)
    shade = disk_view(disk, disk_theta)
    star1 = star2 = None
    if disk.starlight:
        from curvis_tpu.render.starlight import (hit_phi_side,
                                                 starlight_lookup)
        if smap is None:
            smap = _starlight_map_impl(
                metric, bg, dt, escape_radius, max_steps=max_steps,
                disk=disk, filtering=filtering, backend=backend,
                stepper=stepper, rtol=rtol)
        albedo = jnp.asarray(shade.albedo, l.dtype)[None, :]
        phi1, side1 = hit_phi_side(h1[0], h1[2], b, c1, c2, r_hat, e2)
        phi2, side2 = hit_phi_side(h2[0], h2[2], b, c1, c2, r_hat, e2)
        star1 = albedo * starlight_lookup(smap, h1[0], phi1, side1)
        star2 = albedo * starlight_lookup(smap, h2[0], phi2, side2)
    rgb1, a1 = _disk_rgb(metric, h1[0], h1[1], b, nz, shade, l.dtype,
                         starlight=star1)
    rgb2, a2 = _disk_rgb(metric, h2[0], h2[1], b, nz, shade, l.dtype,
                         starlight=star2)
    # composite: hit1 over hit2 over background
    behind = rgb2 * a2[:, None] + bg_colors * (1.0 - a2[:, None])
    out = rgb1 * a1[:, None] + behind * (1.0 - a1[:, None])
    out = jnp.clip(out, 0.0, 1.0)
    return out.reshape(F, W, H, 3).transpose(0, 2, 1, 3)


_render_disk_jit = jax.jit(
    lambda *a, **k: _render_disk_impl(*a, **k),
    static_argnames=("max_steps", "disk", "filtering", "backend",
                     "stepper", "rtol", "differentiable"))
