"""Adaptive 1-D function sampling (reference parity).

Faithful re-implementation of the reference's `doubly_sample_function`
(/root/reference/src/sampling.rs:46-124) with one structural change: the
expensive function is evaluated in *batches* (a whole refinement generation of
midpoints per call) so the geodesic marches run as one jitted device bundle per
iteration instead of one CPU trajectory at a time.  The refinement bookkeeping
(Shoelace-area convergence scores, midpoint insertion, NaN cleaning) runs on
the host in numpy and matches the reference step for step, including its
quirks:

  - triples are scanned with the i+=2 skip after a refinement
    (sampling.rs:160-191),
  - the last one-two points of each pass are dropped (the reference never
    pushes them), so a pass that refines nothing *shrinks* the list and the
    loop breaks on `len < previous` (sampling.rs:98-103),
  - non-finite samples (NotEscaped rays) are removed between passes
    (sampling.rs:21-32),
  - a warning is printed when max_iterations is reached (sampling.rs:114-116).
"""
from __future__ import annotations

import numpy as np


def _clean(points: np.ndarray) -> np.ndarray:
    """Drop rows with non-finite entries (sampling.rs:21-32)."""
    return points[np.isfinite(points).all(axis=1)]


def _scores(p1, p2, p3):
    """Shoelace 2x-areas in (a, e) and (a, s) space (sampling.rs:198-245)."""
    a1 = np.abs((p1[:, 0] * p2[:, 1] + p2[:, 0] * p3[:, 1] + p3[:, 0] * p1[:, 1])
                - (p1[:, 1] * p2[:, 0] + p2[:, 1] * p3[:, 0] + p3[:, 1] * p1[:, 0]))
    a2 = np.abs((p1[:, 0] * p2[:, 2] + p2[:, 0] * p3[:, 2] + p3[:, 0] * p1[:, 2])
                - (p1[:, 2] * p2[:, 0] + p2[:, 2] * p3[:, 0] + p3[:, 2] * p1[:, 0]))
    return a1, a2


def doubly_sample_function(a_min, a_max, initial_points_number, max_iterations,
                           area_threshold_1, area_threshold_2, batch_fn,
                           verbose=False):
    """Sample ``batch_fn`` densely where it varies rapidly.

    ``batch_fn``: (n,) float64 array of alphas -> ((n,) escapes, (n,) signs).
    Returns (alphas, escapes, signs) as float64 arrays.
    """
    xs = np.linspace(a_min, a_max, initial_points_number)
    e, s = batch_fn(xs)
    pts = _clean(np.stack([xs, e, s], axis=1))

    iteration = 0
    while iteration < max_iterations:
        prev_n = len(pts)
        pts = _refine_pass(pts, area_threshold_1, area_threshold_2, batch_fn)
        if len(pts) < prev_n:
            break
        if len(pts) == prev_n:
            break
        iteration += 1
    if iteration == max_iterations:
        print(f"Warning: maximum number of iterations ({max_iterations}) "
              f"reached in sampling algorithm.")
    return pts[:, 0].copy(), pts[:, 1].copy(), pts[:, 2].copy()


def _refine_pass(pts, thr1, thr2, batch_fn):
    """One pass of evaluate_denser_bipoints (sampling.rs:144-195), with the
    new midpoints evaluated in a single batch."""
    pts = _clean(pts)
    if len(pts) < 3:
        raise ValueError("bipoints list has length < 3; cannot refine "
                        "(sampling.rs:156-158 panic)")
    # First walk the triple scan to decide, per position, keep vs refine —
    # identical control flow to the reference (i += 1 on ok, i += 2 after a
    # refinement), collecting midpoint alphas to evaluate in one batch.
    plan = []            # ('keep', i) or ('refine', i) entries
    mid_alphas = []
    i = 0
    n = len(pts)
    while i < n - 2:
        s1, s2 = _scores(pts[i:i + 1], pts[i + 1:i + 2], pts[i + 2:i + 3])
        if not (s1[0] > thr1 or s2[0] > thr2):
            plan.append(("keep", i))
            i += 1
        else:
            plan.append(("refine", i))
            mid_alphas.append(0.5 * (pts[i, 0] + pts[i + 1, 0]))
            mid_alphas.append(0.5 * (pts[i + 1, 0] + pts[i + 2, 0]))
            i += 2
    if mid_alphas:
        ma = np.asarray(mid_alphas)
        me, ms = batch_fn(ma)
        mids = np.stack([ma, me, ms], axis=1)
    else:
        mids = np.zeros((0, 3))
    out = []
    k = 0
    for op, i in plan:
        if op == "keep":
            out.append(pts[i])
        else:
            out.append(pts[i])
            out.append(mids[k])
            out.append(pts[i + 1])
            out.append(mids[k + 1])
            k += 2
    return _clean(np.asarray(out).reshape(-1, 3))
