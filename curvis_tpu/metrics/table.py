"""Kernel-speed USER-DEFINED metrics: Chebyshev tabulation on a compactified
coordinate.

The reference's extensibility story is a three-method trait
(/root/reference/src/metrics.rs:42-44) — any r(l) is a first-class metric,
but every metric pays the same (slow, CPU) march.  Here the XLA backends
already accept any ``Metric`` pytree (autodiff does the rest); this module
closes the remaining gap — the *Pallas kernels* hard-code their metric menu
(ops/march_pallas._shape_fns) — by compiling an arbitrary user r(l) into a
fixed-size coefficient table the kernels evaluate at full VPU speed
(VERDICT round-2 next-step #2).

Representation.  The planar RHS needs two shape functions,
``inv = 1/r^2(l)`` and ``dr3 = r'(l)/r^3(l)``.  Both decay like powers of
1/l, so raw polynomial fits over l in [-R, R] are hopeless.  Compactify:

    w = 1/sqrt(l^2 + s^2),   t = l * w  in (-1, 1)

(s ~ the throat scale).  Then the *known* asymptotics factor out exactly —
``w^2 = (1-t^2)/s^2`` carries the 1/l^2 tail — leaving bounded, smooth
remainders on t in [-1, 1]:

    inv(l) = w^2 * H1(t),    H1 = (l^2 + s^2) / r^2          -> 1 at t = +-1
    dr3(l) = w^3 * H2(t),    H2 = (l^2 + s^2)^{3/2} r' / r^3 -> +-1

H1/H2 are fitted with Chebyshev interpolation (numpy, f64 accumulation) and
evaluated with either the Clenshaw recurrence (~4 VPU ops/degree, stable in
f32 at any degree) or a converted monomial Horner (~2 ops/degree, subject
to cancellation).  ``basis='auto'`` (default) MEASURES the f32 Horner
round-off of the converted coefficients on a dense grid at fit time and
keeps Horner only when it stays within the error budget — the empirical
choice, not a heuristic.  Per-step kernel cost: ~8 + (2 or 4)*degree VPU
ops; a degree-20 Horner table costs ~half of the hand-written DNEG shape.

Requirements on the user metric: asymptotically flat (r ~ |l| + O(1)) and
r(l) >= r_min > 0 everywhere (wormhole-like; validated at fit time — a
horizon needs a capture radius and its own kind).

Gradients: a TabulatedMetric is an ordinary pytree whose *leaves are the
coefficients*, so jax.grad through the XLA backends differentiates the
rendered image w.r.t. the table — and via the fit's linearity, w.r.t. the
shape of r(l) itself.  The adjoint covers tables too (integrate/adjoint.py
backend='pallas': the kernel forward marches the table, the XLA backward
yields the coefficients' cotangents).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

def cheb_eval(coeffs, t):
    """Clenshaw evaluation of a Chebyshev series; ``coeffs`` is any indexable
    of scalars (a jnp array, or scalar-row reads inside a kernel)."""
    b1 = t * 0.0
    b2 = t * 0.0
    two_t = 2.0 * t
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = coeffs[k] + two_t * b1 - b2, b1
    return coeffs[0] + t * b1 - b2


def horner_eval(coeffs, t):
    """Horner evaluation of a monomial series (same indexable contract)."""
    acc = coeffs[-1] + t * 0.0
    for k in range(len(coeffs) - 2, -1, -1):
        acc = acc * t + coeffs[k]
    return acc


def poly_eval(coeffs, t, basis):
    return horner_eval(coeffs, t) if basis == "horner" else \
        cheb_eval(coeffs, t)


@dataclasses.dataclass(frozen=True)
class TabulatedMetric:
    """Chebyshev-tabulated wormhole-class metric (module docstring).

    Implements the full Metric protocol *from the table* — every backend
    (XLA while/scan/tiled, RK45, adjoint, sharded) and the Pallas kernels
    evaluate the identical polynomials, so cross-backend parity holds by
    construction rather than by re-deriving the user's r(l)."""

    c1: jax.Array        # (K+1,) coeffs of H1 (in ``basis``)
    c2: jax.Array        # (K+1,) coeffs of H2
    s: jax.Array         # compactification scale
    basis: str = "clenshaw"   # static: "clenshaw" (Chebyshev) or "horner"

    def _tw(self, l):
        w = 1.0 / jnp.sqrt(l * l + self.s * self.s)
        return l * w, w

    def shape_fns(self, l):
        """(inv, dr3) = (1/r^2, r'/r^3) — the planar RHS pair; the Pallas
        kernel kind 'cheb{K}' inlines exactly this algebra."""
        t, w = self._tw(l)
        w2 = w * w
        return (w2 * poly_eval(self.c1, t, self.basis),
                w2 * w * poly_eval(self.c2, t, self.basis))

    def r_squared(self, l):
        t, w = self._tw(l)
        return 1.0 / ((w * w) * poly_eval(self.c1, t, self.basis))

    def r(self, l):
        return jnp.sqrt(self.r_squared(l))

    def r_derivative(self, l):
        inv, dr3 = self.shape_fns(l)
        r2 = 1.0 / inv
        return dr3 * r2 * jnp.sqrt(r2)

    @property
    def degree(self):
        return self.c1.shape[0] - 1


jax.tree_util.register_dataclass(TabulatedMetric,
                                 data_fields=["c1", "c2", "s"],
                                 meta_fields=["basis"])


def tabulate_metric(metric, *, degree=12, s=None, dtype=jnp.float32,
                    check_range=30.0, tol=1e-4, basis="auto"):
    """Fit ``metric`` (any object with r / r_squared / r_derivative, or a
    plain callable r(l)) into a :class:`TabulatedMetric`.

    Returns ``(tab, report)`` where report carries the measured max relative
    errors of 1/r^2 and r'/r^3 over |l| <= check_range (r' error is
    absolute-normalized by 1/r^2·r, i.e. relative to the function scale)
    and the chosen basis.  ``basis``: 'clenshaw' (stable, ~4 ops/degree),
    'horner' (fast, ~2 ops/degree), or 'auto' — measure the f32 Horner
    round-off of the converted coefficients and take the fast path only
    when it stays below both tol/4 and the fit error.  Raises if the metric
    is not wormhole-class (r <= 0 detected) or the fit misses ``tol``.
    """
    if callable(metric) and not hasattr(metric, "r"):
        r_fn = metric
        m = _FnMetric(r_fn)
    else:
        m = metric

    def exact(l):
        l = jnp.asarray(l, jnp.float64 if jax.config.jax_enable_x64
                        else jnp.float32)
        r = m.r(l)
        rp = m.r_derivative(l)
        return np.asarray(r, np.float64), np.asarray(rp, np.float64)

    if s is None:
        s = float(np.asarray(m.r(jnp.asarray(0.0))))
        if not np.isfinite(s) or s <= 0:
            s = 1.0
    s = float(s)

    # Chebyshev-Gauss nodes in t (interior — no infinities); the map gives
    # |l| up to ~s*N/pi, far beyond any escape radius
    N = max(8 * (degree + 1), 512)
    t = np.cos(np.pi * (np.arange(N) + 0.5) / N)
    l_nodes = s * t / np.sqrt(1.0 - t * t)
    r, rp = exact(l_nodes)
    r_probe, _ = exact(np.linspace(-4.0 * s, 4.0 * s, 257))  # includes l=0,
    if not (np.isfinite(r).all() and (r > 0).all()           # which the
            and np.isfinite(r_probe).all() and (r_probe > 0).all()):  # Gauss
        raise ValueError(                                    # nodes skip
            "tabulate_metric needs r(l) > 0 everywhere (wormhole-class); "
            f"got min r = {min(np.nanmin(r), np.nanmin(r_probe))}")
    ls2 = l_nodes * l_nodes + s * s
    H1 = ls2 / (r * r)
    H2 = ls2 ** 1.5 * rp / r ** 3
    c1 = np.polynomial.chebyshev.chebfit(t, H1, degree)
    c2 = np.polynomial.chebyshev.chebfit(t, H2, degree)

    # basis choice: measure, don't guess (module docstring)
    tg_dense = np.cos(np.pi * (np.arange(4001) + 0.5) / 4001)
    chosen = basis
    if basis in ("auto", "horner"):
        err_h = 0.0
        for c in (c1, c2):
            p = np.polynomial.chebyshev.cheb2poly(c)
            acc = np.full_like(tg_dense, p[-1], np.float32)
            t32 = tg_dense.astype(np.float32)
            for k in range(len(p) - 2, -1, -1):
                acc = acc * t32 + np.float32(p[k])
            ref = np.polynomial.chebyshev.chebval(tg_dense, c)
            err_h = max(err_h, float(np.max(np.abs(acc - ref))
                                     / max(np.max(np.abs(ref)), 1e-30)))
        if basis == "horner" or err_h < tol / 4:
            chosen = "horner"
            c1 = np.polynomial.chebyshev.cheb2poly(c1)
            c2 = np.polynomial.chebyshev.cheb2poly(c2)
        else:
            chosen = "clenshaw"

    tab = TabulatedMetric(c1=jnp.asarray(c1, dtype),
                          c2=jnp.asarray(c2, dtype),
                          s=jnp.asarray(s, dtype), basis=chosen)

    # accuracy report on a dense uniform grid of the marching range
    lg = np.linspace(-check_range, check_range, 4001)
    r, rp = exact(lg)
    inv_e, dr3_e = 1.0 / (r * r), rp / r ** 3
    tg = lg / np.sqrt(lg * lg + s * s)
    wg2 = (1.0 - tg * tg) / (s * s)
    ev = (np.polynomial.polynomial.polyval if chosen == "horner"
          else np.polynomial.chebyshev.chebval)
    inv_f = wg2 * ev(tg, np.asarray(c1))
    dr3_f = wg2 ** 1.5 * ev(tg, np.asarray(c2))
    err_inv = float(np.max(np.abs(inv_f - inv_e) / np.abs(inv_e)))
    scale = np.abs(inv_e) * r            # = 1/r^2 * r = function scale of dr3
    err_dr3 = float(np.max(np.abs(dr3_f - dr3_e) / np.maximum(scale, 1e-30)))
    report = {"err_inv_rel": err_inv, "err_dr3_rel": err_dr3,
              "degree": degree, "s": s, "basis": chosen}
    if not (err_inv <= tol and err_dr3 <= tol):       # NaN-safe: NaN fails
        raise ValueError(
            f"tabulate_metric: degree-{degree} fit error "
            f"{max(err_inv, err_dr3):.2e} exceeds tol={tol:g}; raise the "
            f"degree (cost ~4 VPU ops each) or loosen tol. {report}")
    return tab, report


import functools


@functools.lru_cache(maxsize=16)
def _diff_fit_operator(degree: int, n_nodes: int, s: float, basis: str):
    """(FIT matrix, node l values): the Chebyshev-Gauss collocation fit as
    one fixed linear operator from node values to coefficients in ``basis``
    ('horner' = monomial via cheb2poly, 'clenshaw' = Chebyshev) —
    host-side numpy, cached per (degree, nodes, s, basis)."""
    t = np.cos(np.pi * (np.arange(n_nodes) + 0.5) / n_nodes)
    l_nodes = s * t / np.sqrt(1.0 - t * t)
    V = np.polynomial.chebyshev.chebvander(t, degree)
    FIT = np.linalg.pinv(V)
    if basis == "horner":
        C2M = np.zeros((degree + 1, degree + 1))
        for j in range(degree + 1):
            e = np.zeros(degree + 1)
            e[j] = 1.0
            pcoef = np.polynomial.chebyshev.cheb2poly(e)
            C2M[:len(pcoef), j] = pcoef
        FIT = C2M @ FIT
    return FIT, l_nodes


def tabulate_metric_diff(r_fn, *, degree=12, s=1.0, n_nodes=128,
                         basis="auto"):
    """DIFFERENTIABLE twin of :func:`tabulate_metric` for parameterized
    shapes: ``r_fn(l)`` may close over traced parameters, and the returned
    :class:`TabulatedMetric` carries their gradients.

    The Chebyshev collocation fit is a *fixed linear operator* on the node
    values of (1/r^2, r'/r^3) (compactified), so tabulation under autodiff
    is one matrix-vector product per table — the key idea behind the
    round-3 shape-recovery capability (examples/shape_recovery.py), now a
    package API consumed by curvis_tpu.fit inverse problems.  ``r'`` comes
    from ``jax.grad`` of ``r_fn``.  No accuracy report / tol gate (the
    traced values cannot be checked host-side): validate the final fitted
    shape once with :func:`tabulate_metric` if needed.

    ``basis``: unlike :func:`tabulate_metric`, the Horner-conversion error
    cannot be MEASURED here (the node values are traced), so 'auto' picks
    by degree alone — 'horner' up to degree 16 (where the measured gate
    picks it for every smooth shape tried), 'clenshaw' (cancellation-free
    Chebyshev recurrence, ~2x the eval cost) above.  Both bases ride the
    kernels (kinds 'cheb{K}h' / 'cheb{K}c')."""
    if basis == "auto":
        basis = "horner" if degree <= 16 else "clenshaw"
    if basis not in ("horner", "clenshaw"):
        raise ValueError(f"basis must be horner|clenshaw|auto, got {basis}")
    FIT, l_nodes = _diff_fit_operator(int(degree), int(n_nodes), float(s),
                                      basis)
    FITj = jnp.asarray(FIT)
    LN = jnp.asarray(l_nodes)
    r = r_fn(LN)
    rp = jax.vmap(jax.grad(lambda l: jnp.reshape(r_fn(l), ())))(LN)
    ls2 = LN * LN + s * s
    return TabulatedMetric(c1=FITj @ (ls2 / (r * r)),
                          c2=FITj @ (ls2 ** 1.5 * rp / r ** 3),
                          s=jnp.asarray(s, r.dtype), basis=basis)


class _FnMetric:
    """Adapter: a bare r(l) callable -> Metric protocol via autodiff."""

    def __init__(self, r_fn):
        self._r = r_fn

    def r(self, l):
        return self._r(l)

    def r_squared(self, l):
        r = self._r(l)
        return r * r

    def r_derivative(self, l):
        return jax.vmap(jax.grad(self._r))(jnp.atleast_1d(l)).reshape(
            jnp.shape(l))
