"""Numerical-debug helpers (SURVEY.md section 5: the accelerator analogue of the
reference's RUST_BACKTRACE=full, main.rs:211, is NaN checking + determinism
discipline)."""
from __future__ import annotations

import contextlib

import jax


def enable_nan_checks(on=True):
    """Raise on NaN production anywhere in jitted code (jax_debug_nans)."""
    jax.config.update("jax_debug_nans", bool(on))


@contextlib.contextmanager
def nan_checks():
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
