"""Scalar-row layout contract (VERDICT round-3 next-step #4).

Round 3 shipped the same bug class twice: a Chebyshev coefficient tail read
at the wrong row offset because the row layout was hardcoded independently
in the row builders and in each kernel.  The layout now lives in ONE set of
module constants (ops/march_pallas.py, module top) that both the kernels'
reads and the wrappers' splice asserts consume; this test pins the contract
itself — the slot ORDER of _vol_param_slots against the VOL_SLOT name map,
the arithmetic relations between the offsets, and the tail position that
_metric_kind_and_params actually emits — so any future drift fails here
before it can corrupt a trajectory.
"""
import jax.numpy as jnp
import numpy as np

from curvis_tpu.metrics.base import EllisMetric, SchwarzschildMetric
from curvis_tpu.ops.march_pallas import (CHEB_OFF_COMPACT, CHEB_OFF_VOL,
                                         KERR_RK45_BOUNDS,
                                         KERR_SCATTER_OFF, SCATTER_BLOCK,
                                         SCATTER_DEG, VOL_BLOCK_KERR,
                                         VOL_BLOCK_PLANAR, VOL_SLOT,
                                         _metric_kind_and_params,
                                         _vol_param_slots)
from curvis_tpu.render.disk import DiskParams


def test_offset_arithmetic():
    # the vol block is 8 named scalars; every tail/bound offset derives
    # from the block start — these equalities are what the kernels assume
    assert len(VOL_SLOT) == 8
    assert sorted(VOL_SLOT.values()) == list(range(8))
    assert CHEB_OFF_VOL == VOL_BLOCK_PLANAR + len(VOL_SLOT) == 16
    assert KERR_RK45_BOUNDS[True] == VOL_BLOCK_KERR + len(VOL_SLOT) == 18
    assert KERR_RK45_BOUNDS[False] == VOL_BLOCK_KERR == 10
    assert VOL_BLOCK_PLANAR == 6 + 2          # base[0:6] + (r_in, r_out)
    # round 5: the 27-scalar starlight-scattering block — tint RGB + a
    # degree-7 monomial per channel; BOTH Kerr vol rows are width 20
    # (fixed: +2 spare; rk45: +dt_max/dt_min), so one offset serves both
    assert SCATTER_BLOCK == 3 + 3 * (SCATTER_DEG + 1) == 27
    assert KERR_SCATTER_OFF == VOL_BLOCK_KERR + len(VOL_SLOT) + 2 == 20
    assert KERR_SCATTER_OFF == KERR_RK45_BOUNDS[True] + 2


def test_vol_param_slots_order_matches_name_map():
    # distinct sentinels for every independently-settable scalar; derived
    # slots (h2, inv_norm, t_scale) are checked against their formulas
    disk = DiskParams(r_inner=3.0, r_outer=17.0, emissivity_index=2.75,
                      spin_sign=-1.0, kappa=5.5, t_peak=6123.0,
                      volumetric=True, h_rel=0.11)
    slots = [float(v) for v in _vol_param_slots(disk)]
    assert len(slots) == len(VOL_SLOT)
    assert slots[VOL_SLOT["h2"]] == 0.11 * 0.11
    assert np.isclose(slots[VOL_SLOT["inv_norm"]],
                      1.0 / (np.sqrt(2 * np.pi) * 0.11))
    assert slots[VOL_SLOT["kappa"]] == 5.5
    assert slots[VOL_SLOT["tau_max"]] == disk.tau_max
    assert slots[VOL_SLOT["t_peak"]] == 6123.0
    assert slots[VOL_SLOT["emis_q"]] == 2.75
    assert slots[VOL_SLOT["spin_sign"]] == -1.0
    rp = (49.0 / 36.0) * 3.0
    f_peak = rp ** -0.75 * (1.0 / 7.0) ** 0.25
    assert np.isclose(slots[VOL_SLOT["t_scale"]], 6123.0 / f_peak)


def test_base_row_width_and_named_slots():
    metric = SchwarzschildMetric(m=jnp.asarray(1.25, jnp.float32))
    kind, row = _metric_kind_and_params(
        metric, dt=0.035, escape_radius=77.0, dtype=jnp.float32)
    assert kind == "schwarzschild"
    assert row.shape == (1, CHEB_OFF_COMPACT)
    row = np.asarray(row)
    assert row[0, 0] == np.float32(0.035)      # dt
    assert row[0, 1] == 77.0                   # escape radius
    assert row[0, 2] == 1.25                   # first metric param
    assert np.isclose(row[0, 5], float(metric.capture_radius))


def test_cheb_tail_rides_at_compact_offset():
    from curvis_tpu.metrics.table import tabulate_metric
    tab, _ = tabulate_metric(EllisMetric(rho=jnp.asarray(1.0)), degree=8,
                             tol=1e-2)
    kind, row = _metric_kind_and_params(tab, dt=0.05, escape_radius=30.0,
                                        dtype=jnp.float32)
    assert kind.startswith("cheb8")
    row = np.asarray(row)
    K = 8
    tail = np.concatenate([np.asarray(tab.c1), np.asarray(tab.c2)])
    assert row.shape[1] == CHEB_OFF_COMPACT + 2 * (K + 1)
    np.testing.assert_allclose(row[0, CHEB_OFF_COMPACT:],
                               tail.astype(np.float32), rtol=1e-6)
    # s^2 rides in the first metric-param slot (read by _shape_fns cheb)
    assert np.isclose(row[0, 2], float(tab.s) ** 2)
