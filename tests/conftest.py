"""Test configuration: CPU with 8 virtual devices + float64, Pallas
kernels in interpret mode (the dispatch rule's choice on the CPU).

SURVEY.md section 4: multi-device logic is exercised on a virtual CPU mesh
via XLA_FLAGS=--xla_force_host_platform_device_count=8; physics oracles run
in f64.  Tests that need the card carry the ``gpu`` marker and the
``gpu_only`` fixture, which skips them here; run them on the GPU with
``python -m pytest tests -m gpu`` (without this conftest's CPU pin:
``CURVIS_TEST_PLATFORM=gpu``).
"""
import os

ON_CARD = os.environ.get("CURVIS_TEST_PLATFORM") == "gpu"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_only():
    """Skip unless JAX's platform is the GPU (decided here, at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run on the card with "
                    "CURVIS_TEST_PLATFORM=gpu -m gpu)")


@pytest.fixture
def kernel_constant(monkeypatch):
    """``set(module, name, value)``: set a kernel tuning constant (the
    launcher's ``BLOCK``) for one test.  Jitted wrappers do not key their
    caches on module constants, so the caches are dropped on every change
    and after the test."""
    def set_(module, name, value):
        monkeypatch.setattr(module, name, value)
        jax.clear_caches()
    yield set_
    monkeypatch.undo()
    jax.clear_caches()


# Full-suite runs accumulate thousands of compiled CPU executables in one
# process; past ~220 tests the XLA CPU backend_compile can hard-abort
# ("Fatal Python error: Aborted" inside backend_compile_and_load, observed
# at different tests on different runs — state-dependent, never
# reproducible for a file run alone).  Dropping JAX's compilation/tracing
# caches between modules bounds that state; per-module recompiles cost
# little since the suite mostly re-jits per module anyway.
@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()
