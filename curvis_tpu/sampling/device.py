"""On-device adaptive sampler — `doubly_sample_function` as ONE XLA program.

The host-driven sampler (sampling/adaptive.py) re-dispatches a geodesic
bundle per refinement generation, and a 960x540 frame needs ~30
generations, so its frame time is bound by dispatch and host round trips.  This module runs the
*same* control flow as the reference's adaptive sampler
(/root/reference/src/sampling.rs:46-124) — the triple scan with the i+=2
skip after a refinement, the dropped tail points, the between-pass NaN
cleaning, and the shrink/fixpoint termination — inside a single jitted
`lax.while_loop` over a fixed-capacity point buffer, so the whole adaptive
refinement is one device call.

Mechanics per pass (all static shapes):
  - Shoelace convergence scores for every consecutive triple, vectorized
    (sampling.rs:198-245 formula, identical operation order to the host
    sampler so CPU f64 runs are bit-identical — pinned by
    tests/test_symmetric.py::test_device_sampler_matches_host).
  - The reference's sequential skip logic as a tiny lax.scan with a carry.
  - Buffer reconstruction via exclusive-cumsum offsets + scatters
    (mode='drop' doubles as the capacity guard).
  - New midpoints compacted into a fixed-width march bundle so every pass
    reuses one compiled geodesic kernel; lanes beyond the midpoint count
    march a dummy outward ray (alpha 0 escapes in (R - l0)/dt steps).

:func:`doubly_sample_on_device_frames` batches FRAMES through the same
refinement: per-frame (F, C) buffers advance in lock-step under one
while_loop (a frame that terminates is frozen by `where`, exactly the
single-frame exit condition), and each pass marches all frames' midpoints
as ONE flat (F*M,) bundle — one device dispatch for a whole video batch.

Deviations from the host/reference (documented, not exercised in practice):
  - a pass on fewer than 3 points terminates instead of raising
    (panics don't exist inside jit; sampling.rs:156-158),
  - points beyond ``capacity`` are dropped and midpoints beyond
    ``march_width`` are left unrefined (default 4096/512 vs ~600 points for
    the default HD config); both raise the returned ``overflow`` flag so
    callers can warn — no silent quality loss.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _shoelace(a1, e1, s1, a2, e2, s2, a3, e3, s3):
    """Twice the triangle areas in (alpha, escape) and (alpha, space) space,
    with the exact operation order of sampling.rs:198-245 / the host sampler
    (bit-parity on CPU f64)."""
    t1 = jnp.abs((a1 * e2 + a2 * e3 + a3 * e1)
                 - (e1 * a2 + e2 * a3 + e3 * a1))
    t2 = jnp.abs((a1 * s2 + a2 * s3 + a3 * s1)
                 - (s1 * a2 + s2 * a3 + s3 * a1))
    return t1, t2


def _compact(valid, arrays, capacity):
    """Stable stream compaction of ``arrays`` rows where ``valid``; returns
    compacted arrays (zero-filled tails) + the new count."""
    pos = jnp.cumsum(valid) - valid.astype(jnp.int32)
    idx = jnp.where(valid, pos, capacity)          # capacity -> dropped
    outs = tuple(
        jnp.zeros((capacity,), a.dtype).at[idx].set(a, mode="drop")
        for a in arrays)
    return outs, jnp.sum(valid.astype(jnp.int32))


def _init_from_march(xs0, e0, s0, capacity):
    """Initial buffer fill + NaN clean from the uniform-grid march results
    (per frame).  ``xs0`` is the (n0,) launch grid; ``e0``/``s0`` the first
    ``n0`` lanes of the march."""
    C = int(capacity)
    n0 = xs0.shape[0]
    dtype = xs0.dtype
    i_c = jnp.arange(C)
    a_buf = jnp.zeros((C,), dtype).at[:n0].set(xs0)
    e_buf = jnp.zeros((C,), dtype).at[:n0].set(e0[:n0])
    s_buf = jnp.zeros((C,), dtype).at[:n0].set(s0[:n0])
    fin0 = ((i_c < n0) & jnp.isfinite(a_buf) & jnp.isfinite(e_buf)
            & jnp.isfinite(s_buf))
    return _compact(fin0, (a_buf, e_buf, s_buf), C)


def _plan_pass(a, e, s, n, thr1, thr2, capacity, march_width):
    """One refinement pass up to (but excluding) the midpoint march: returns
    the rebuilt point layout (na/ne/ns + validity/need masks + offsets) and
    the fixed-width (M,) bundle of midpoint alphas to march."""
    C = int(capacity)
    M = int(march_width)
    dtype = a.dtype
    i_c = jnp.arange(C)
    inr = i_c < (n - 2)
    a2, a3 = jnp.roll(a, -1), jnp.roll(a, -2)
    e2, e3 = jnp.roll(e, -1), jnp.roll(e, -2)
    s2, s3 = jnp.roll(s, -1), jnp.roll(s, -2)
    t1, t2 = _shoelace(a, e, s, a2, e2, s2, a3, e3, s3)
    raw = inr & ((t1 > thr1) | (t2 > thr2))

    # sampling.rs:160-191 scan: i += 1 on a kept triple, i += 2 after a
    # refinement (the next position is never scanned).
    def skip_step(skip, x):
        raw_i, inr_i = x
        scanned = inr_i & (skip == 0)
        refine = scanned & raw_i
        nskip = jnp.where(
            ~inr_i, skip,
            jnp.where(refine, 1, jnp.where(scanned, 0, skip - 1)))
        return nskip, (scanned, refine)

    _, (scanned, refine) = lax.scan(skip_step, jnp.int32(0), (raw, inr))
    keep = scanned & ~refine
    # keep emits [p_i]; refine emits [p_i, mid(i,i+1), p_{i+1},
    # mid(i+1,i+2)] (sampling.rs:168-186); unscanned positions emit
    # nothing — which also drops the reference's 1-2 tail points.
    emit = jnp.where(refine, 4, jnp.where(keep, 1, 0))
    off = jnp.cumsum(emit) - emit
    mid1 = 0.5 * (a + a2)
    mid2 = 0.5 * (a2 + a3)

    na = jnp.zeros((C,), dtype)
    ne = jnp.zeros((C,), dtype)
    ns = jnp.zeros((C,), dtype)
    nvalid = jnp.zeros((C,), bool)
    nneed = jnp.zeros((C,), bool)
    idx0 = jnp.where(emit > 0, off, C)
    idx1 = jnp.where(refine, off + 1, C)
    idx2 = jnp.where(refine, off + 2, C)
    idx3 = jnp.where(refine, off + 3, C)
    na = na.at[idx0].set(a, mode="drop").at[idx1].set(mid1, mode="drop") \
           .at[idx2].set(a2, mode="drop").at[idx3].set(mid2, mode="drop")
    ne = ne.at[idx0].set(e, mode="drop").at[idx2].set(e2, mode="drop")
    ns = ns.at[idx0].set(s, mode="drop").at[idx2].set(s2, mode="drop")
    t = jnp.ones((C,), bool)
    nvalid = nvalid.at[idx0].set(t, mode="drop") \
        .at[idx1].set(t, mode="drop").at[idx2].set(t, mode="drop") \
        .at[idx3].set(t, mode="drop")
    nneed = nneed.at[idx1].set(t, mode="drop").at[idx3].set(t, mode="drop")

    noff = jnp.cumsum(nneed) - nneed.astype(jnp.int32)
    midx = jnp.where(nneed, noff, M)
    march_a = jnp.zeros((M,), dtype).at[midx].set(na, mode="drop")
    # overflow: emitted points past ``capacity`` were dropped by the
    # mode='drop' scatters, or midpoints past ``march_width`` will not be
    # marched this pass (they are excluded from the merge, not kept as
    # zeros) — either way the refinement silently degraded.
    ovf = (jnp.sum(emit) > C) | (jnp.sum(nneed.astype(jnp.int32)) > M)
    return na, ne, ns, nvalid, nneed, noff, march_a, ovf


def _merge_pass(na, ne, ns, nvalid, nneed, noff, me, ms, capacity,
                march_width):
    """Fold the marched midpoints back into the layout, NaN-clean, compact."""
    C = int(capacity)
    M = int(march_width)
    got = nneed & (noff < M)
    g = jnp.clip(noff, 0, M - 1)
    ne = jnp.where(got, me[g], ne)
    ns = jnp.where(got, ms[g], ns)
    # un-marched midpoints (nneed but beyond march_width) must NOT survive
    # as valid points — their ne/ns still hold the 0.0 initialization, which
    # the finiteness filter would accept, silently injecting zero samples
    # into the deflection table.  Excluding them degrades overflow to
    # "not refined", like the documented capacity drop.
    fin = (nvalid & (~nneed | got)
           & jnp.isfinite(na) & jnp.isfinite(ne) & jnp.isfinite(ns))
    return _compact(fin, (na, ne, ns), C)


def _epsilon_tail(a, e, s, n, capacity):
    """Interp-safe tail: strictly-increasing epsilon continuation holding the
    last sample's values (same padding the host path applies)."""
    dtype = a.dtype
    i_c = jnp.arange(int(capacity))
    last = jnp.maximum(n - 1, 0)
    tail = a[last] + (i_c - last).astype(dtype) * jnp.asarray(1e-6, dtype)
    live = i_c < n
    return (jnp.where(live, a, tail), jnp.where(live, e, e[last]),
            jnp.where(live, s, s[last]))


def doubly_sample_on_device(march_fn, a_min, a_max, initial_points_number,
                            max_iterations, thr1, thr2, *, capacity=4096,
                            march_width=512, dtype=jnp.float32):
    """Jit-compatible adaptive sampling of ``march_fn`` (sampling.rs:46-124).

    ``march_fn``: (march_width,) alphas -> ((march_width,) escape angles,
    (march_width,) escape spaces); NotEscaped encoded as NaN.
    ``a_min``/``a_max``/``initial_points_number``/``max_iterations`` must be
    static; ``thr1``/``thr2`` may be traced scalars.

    Returns (alphas, escapes, spaces, n, overflow): (capacity,) buffers whose
    first n slots are the sample set; the tail is a strictly-increasing
    epsilon continuation of the last sample (safe under jnp.interp, never
    matched by clamped queries).  ``overflow`` is a scalar bool: True when
    any pass dropped points (emitted set exceeded ``capacity``, or more
    midpoints than ``march_width`` were requested) — the result is still a
    valid, merely less-refined sample set, but callers should warn.
    """
    C = int(capacity)
    M = int(march_width)
    n0 = int(initial_points_number)
    if n0 > M:
        raise ValueError(f"initial_points_number {n0} exceeds march_width {M}")
    if n0 > C:
        raise ValueError(f"initial_points_number {n0} exceeds capacity {C}")
    thr1 = jnp.asarray(thr1, dtype)
    thr2 = jnp.asarray(thr2, dtype)

    # Initial uniform grid, computed with np at trace time so the host
    # sampler (np.linspace) sees bit-identical launch angles.
    xs0 = np.linspace(float(a_min), float(a_max), n0)
    e0, s0 = march_fn(jnp.asarray(
        np.concatenate([xs0, np.zeros(M - n0)]), dtype))
    (a_buf, e_buf, s_buf), n = _init_from_march(
        jnp.asarray(xs0, dtype), e0, s0, C)

    def cond(c):
        _, _, _, n, it, done, _ = c
        return (it < max_iterations) & ~done & (n >= 3)

    def body(c):
        a, e, s, n, it, _, ovf = c
        na, ne, ns, nvalid, nneed, noff, march_a, ovf_p = _plan_pass(
            a, e, s, n, thr1, thr2, C, M)
        me, ms = march_fn(march_a)
        (a_n, e_n, s_n), n_n = _merge_pass(na, ne, ns, nvalid, nneed, noff,
                                           me, ms, C, M)
        return a_n, e_n, s_n, n_n, it + 1, n_n <= n, ovf | ovf_p

    a_buf, e_buf, s_buf, n, it, done, ovf = lax.while_loop(
        cond, body, (a_buf, e_buf, s_buf, n, jnp.int32(0),
                     jnp.asarray(False), jnp.asarray(False)))

    a_out, e_out, s_out = _epsilon_tail(a_buf, e_buf, s_buf, n, C)
    return a_out, e_out, s_out, n, ovf


def doubly_sample_on_device_frames(march_fn, a_min, a_max,
                                   initial_points_number, max_iterations,
                                   thr1, thr2, *, n_frames, capacity=4096,
                                   march_width=512, dtype=jnp.float32):
    """Frame-batched :func:`doubly_sample_on_device`: F independent adaptive
    refinements advance in lock-step under ONE `lax.while_loop`, and every
    pass marches all frames' midpoints as a single flat bundle.

    ``march_fn``: (n_frames * march_width,) flat alphas (frame-major) ->
    ((F*M,) escape angles, (F*M,) escape spaces).  Per-frame launch state
    (e.g. the camera's l0) is the caller's to encode in ``march_fn`` — see
    render/symmetric.py, which repeats l0 per lane.

    Returns ((F, capacity) alphas, escapes, spaces, (F,) counts, (F,)
    overflow flags — see :func:`doubly_sample_on_device`).  Each
    frame's refinement follows the exact single-frame control flow: a frame
    whose pass shrinks (or drops below 3 points) is frozen by `where` while
    the others continue, so per-frame refinement structure and counts are
    identical to F separate single-frame runs; sample values agree to ulp
    level (the flat F*M march fuses differently than a single-frame M march
    — tested to 1e-12 on CPU f64).
    """
    C = int(capacity)
    M = int(march_width)
    F = int(n_frames)
    n0 = int(initial_points_number)
    if n0 > M:
        raise ValueError(f"initial_points_number {n0} exceeds march_width {M}")
    if n0 > C:
        raise ValueError(f"initial_points_number {n0} exceeds capacity {C}")
    thr1 = jnp.asarray(thr1, dtype)
    thr2 = jnp.asarray(thr2, dtype)

    xs0 = np.linspace(float(a_min), float(a_max), n0)
    pad0 = np.concatenate([xs0, np.zeros(M - n0)])
    e0, s0 = march_fn(jnp.asarray(np.tile(pad0, F), dtype))
    xs0_j = jnp.asarray(xs0, dtype)
    (a, e, s), n = jax.vmap(
        lambda ef, sf: _init_from_march(xs0_j, ef, sf, C))(
            e0.reshape(F, M), s0.reshape(F, M))

    plan = jax.vmap(
        lambda af, ef, sf, nf: _plan_pass(af, ef, sf, nf, thr1, thr2, C, M))
    merge = jax.vmap(
        lambda *args: _merge_pass(*args, C, M))

    def cond(c):
        _, _, _, n, it, done, _ = c
        return (it < max_iterations) & jnp.any(~done & (n >= 3))

    def body(c):
        a, e, s, n, it, done, ovf = c
        active = ~done & (n >= 3)
        na, ne, ns, nvalid, nneed, noff, march_a, ovf_p = plan(a, e, s, n)
        me, ms = march_fn(march_a.reshape(F * M))
        (a2, e2, s2), n2 = merge(na, ne, ns, nvalid, nneed, noff,
                                 me.reshape(F, M), ms.reshape(F, M))
        keep = active[:, None]
        a = jnp.where(keep, a2, a)
        e = jnp.where(keep, e2, e)
        s = jnp.where(keep, s2, s)
        shrink = n2 <= n
        n = jnp.where(active, n2, n)
        done = done | (active & shrink)
        return a, e, s, n, it + 1, done, ovf | (active & ovf_p)

    a, e, s, n, it, done, ovf = lax.while_loop(
        cond, body, (a, e, s, n, jnp.int32(0), jnp.zeros((F,), bool),
                     jnp.zeros((F,), bool)))

    a_out, e_out, s_out = jax.vmap(
        lambda af, ef, sf, nf: _epsilon_tail(af, ef, sf, nf, C))(a, e, s, n)
    return a_out, e_out, s_out, n, ovf
