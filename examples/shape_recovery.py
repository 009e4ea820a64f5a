"""Nonparametric wormhole SHAPE recovery from lensing: reconstruct r(l).

The reference framework renders a handful of hardcoded metrics
(/root/reference/src/metrics.rs); it cannot ask the inverse question at
all.  This demo recovers the full shape function r(l) of an *unknown*
wormhole from noisy deflection measurements, by gradient descent THROUGH
the geodesic march:

  1. Truth: an asymmetric Bell-type wormhole, r(l) = sqrt(rho(l)^2 + l^2)
     with rho = 1 + 0.35 tanh(l / 1.4) — the negative universe has a
     different asymptotic radius than the positive one.  The observer does
     not know this functional form.
  2. Data: two observers (one per universe, |l0| = 6) each launch a fan of
     40 rays and record the escape direction beta(alpha); 2 mrad of
     Gaussian noise is added.  All rays are reflected (b above critical),
     probing turning points down to l ~ +-0.4.
  3. Model: a flexible log-Chebyshev family rho_theta(l) = exp(q(u)),
     u = tanh(l / 1.5), q = degree-5 Chebyshev series — six coefficients,
     NOT the truth's parameterization.  The family is tabulated
     DIFFERENTIABLY: the Chebyshev fit of the shape remainders
     (metrics/table.py representation) is a fixed linear operator applied
     to jnp values of r and r' (autodiff), so gradients flow
     data -> march -> table coefficients -> theta.
  4. Fit: Adam on the masked L2 deflection residual.  ~150 iterations to
     the noise floor.

Measured result (this script, CPU f64): median |r_fit - r_true| / r_true
~ 1.2e-4 over the probed range l in [-6, 6], throat radius to 0.2%.

The same loss runs at kernel speed on the GPU via the adjoint's kernel
forward (integrate/adjoint.py backend='pallas').

Run:  python examples/shape_recovery.py        (~3 min CPU; writes
      examples/out/shape_recovery.png)
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

OUT = Path(__file__).parent / "out"


def main(argv=None):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax
    from curvis_tpu.integrate.adjoint import march_planar_adjoint
    from curvis_tpu.metrics.table import TabulatedMetric, tabulate_metric

    # ------------------------- 1. the unknown truth -----------------------
    def r_true(l):
        rho = 1.0 + 0.35 * jnp.tanh(l / 1.4)
        return jnp.sqrt(rho * rho + l * l)

    # --------------- 3. differentiable tabulation of the family -----------
    W, S, DEG, M = 1.5, 1.0, 12, 5
    nodes_t = np.cos(np.pi * (np.arange(128) + 0.5) / 128)
    nodes_l = S * nodes_t / np.sqrt(1.0 - nodes_t * nodes_t)
    V = np.polynomial.chebyshev.chebvander(nodes_t, DEG)
    C2M = np.zeros((DEG + 1, DEG + 1))       # cheb -> monomial (fixed, linear)
    for j in range(DEG + 1):
        e = np.zeros(DEG + 1)
        e[j] = 1.0
        p = np.polynomial.chebyshev.cheb2poly(e)
        C2M[:len(p), j] = p
    FIT = jnp.asarray(C2M @ np.linalg.pinv(V))     # node values -> horner
    LN = jnp.asarray(nodes_l)

    def r_of(theta, l):
        u = jnp.tanh(l / W)
        b1 = jnp.zeros_like(u)
        b2 = jnp.zeros_like(u)
        for k in range(M, 0, -1):                  # Clenshaw on q(u)
            b1, b2 = theta[k] + 2.0 * u * b1 - b2, b1
        rho = jnp.exp(theta[0] + u * b1 - b2)
        return jnp.sqrt(rho * rho + l * l)

    def tabulate_diff(theta):
        """Differentiable tabulation — since round 4 a package API
        (metrics/table.py:tabulate_metric_diff): the Chebyshev fit is
        linear, one fixed matrix applied to autodiff values of (r, r')."""
        from curvis_tpu.metrics.table import tabulate_metric_diff
        return tabulate_metric_diff(lambda l: r_of(theta, l), degree=DEG,
                                    s=S, n_nodes=128)

    # ------------------------- 2. the observations ------------------------
    L0, R = 6.0, 40.0

    def deflection(tab, alphas, side):
        """Escape direction beta for a fan launched at l = side*L0, angle
        alpha from the inward direction (planar system; the march is the
        differentiable checkpointed-recompute adjoint)."""
        l = side * L0
        r0 = tab.r(l)
        p_l = -side * jnp.cos(alphas)
        b = r0 * jnp.sin(alphas)
        lf, psif, plf, sign, _ = march_planar_adjoint(
            tab, (l, jnp.zeros_like(alphas), p_l), b, jnp.asarray(0.02),
            6000, R, backend="xla")
        return psif + jnp.arctan2(b / tab.r(lf), plf), sign

    al = jnp.asarray(np.linspace(0.22, 1.40, 40))
    alphas = jnp.concatenate([al, al])
    side = jnp.concatenate([jnp.ones(40), -jnp.ones(40)])

    # data comes from the INDEPENDENT numpy tabulation path of the truth
    tab_true, _ = tabulate_metric(r_true, degree=DEG, tol=1e-2,
                                  dtype=jnp.float64)
    beta_true, sign_t = deflection(tab_true, alphas, side)
    rng = np.random.default_rng(0)
    noise = 2e-3
    beta_obs = beta_true + noise * jnp.asarray(
        rng.standard_normal(alphas.shape))

    # ------------------------------ 4. the fit ----------------------------
    def loss(theta):
        beta, sign = deflection(tabulate_diff(theta), alphas, side)
        w = jnp.where(sign == sign_t, 1.0, 0.0)  # like-fate rays only
        return jnp.sum(w * (beta - beta_obs) ** 2) \
            / jnp.maximum(jnp.sum(w), 1.0)

    # round 4: the hand-rolled Adam loop is now the package harness
    # (curvis_tpu.fit — one jitted scan; histories + convergence report)
    from curvis_tpu.fit import fit
    t0 = time.time()
    iters = 300
    res = fit(loss, jnp.zeros(M + 1), iters=iters, lr=3e-2)
    theta = res.params
    for i in range(0, iters, 50):
        print(f"  it {i:3d}: loss {float(res.history[i]):.3e}")
    print(f"fit: {iters} Adam iterations in {time.time() - t0:.0f} s "
          f"(converged: {res.converged()})")

    # ------------------------------ report --------------------------------
    lg = np.linspace(-6.0, 6.0, 241)
    r_fit = np.asarray(r_of(theta, jnp.asarray(lg)))
    r_tru = np.asarray(r_true(jnp.asarray(lg)))
    rel = np.abs(r_fit - r_tru) / r_tru
    print(f"r(l) relative error over l in [-6, 6]: median {np.median(rel):.2e}"
          f", max {rel.max():.2e}")
    print(f"throat radius: true {r_tru.min():.4f}, recovered "
          f"{r_fit.min():.4f}")

    OUT.mkdir(exist_ok=True)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(lg, r_tru, "k-", lw=2, label="true r(l)  (unknown to the fit)")
    ax1.plot(lg, r_fit, "C1--", lw=2, label="recovered (6 coefficients)")
    ax1.plot(lg, np.sqrt(1 + lg ** 2), "C0:", lw=1, label="init (Ellis)")
    ax1.set_xlabel("proper coordinate l")
    ax1.set_ylabel("areal radius r(l)")
    ax1.legend(fontsize=8)
    ax1.set_title("shape function")
    order = np.argsort(np.asarray(alphas[:40]))
    ax2.plot(np.asarray(al)[order], np.asarray(beta_obs[:40])[order], "C0.",
             ms=4, label="observed (side +, 2 mrad noise)")
    ax2.plot(np.asarray(al)[order], np.asarray(beta_obs[40:])[order], "C3.",
             ms=4, label="observed (side -)")
    bfit, _ = deflection(tabulate_diff(theta), alphas, side)
    ax2.plot(np.asarray(al)[order], np.asarray(bfit[:40])[order], "C0-",
             lw=1, label="fit (side +)")
    ax2.plot(np.asarray(al)[order], np.asarray(bfit[40:])[order], "C3-",
             lw=1, label="fit (side -)")
    ax2.set_xlabel("launch angle alpha")
    ax2.set_ylabel("escape direction beta")
    ax2.legend(fontsize=8)
    ax2.set_title("deflection data")
    fig.tight_layout()
    fig.savefig(OUT / "shape_recovery.png", dpi=110)
    print(f"wrote {OUT / 'shape_recovery.png'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
