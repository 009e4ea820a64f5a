"""Profiling helpers: wall-clock stage timers + rays/s counters
(SURVEY.md section 5 — the reference's only instrumentation is println!).

Every timing ends in ``jax.block_until_ready``: JAX returns before the
device finishes, so a timing without it measures the enqueue.
"""
from __future__ import annotations

import contextlib
import json
import time

import jax


class StageTimer:
    """Accumulates named wall-clock stages; reports a JSON summary."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name, sync=True):
        """Time a stage. Yields a list: append device arrays produced inside
        and the clock stops when they are ready (``sync=True``)."""
        holder: list = []
        t0 = time.perf_counter()
        yield holder
        if sync and holder:
            jax.block_until_ready(holder)
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def record(self, name, seconds):
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self, rays=None):
        out = {k: round(v, 4) for k, v in self.stages.items()}
        total = sum(self.stages.values())
        out["total"] = round(total, 4)
        if rays and total > 0:
            out["Mrays_per_s"] = round(rays / total / 1e6, 3)
        return out

    def report(self, rays=None):
        return json.dumps(self.summary(rays))


def time_fn(fn, *args, iters=3, warmup=1):
    """Best-of-n wall time of a jitted callable, each call waited for with
    ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def trace(log_dir):
    """jax.profiler trace context for deep dives (view with TensorBoard or
    xprof)."""
    return jax.profiler.trace(str(log_dir))
