"""Tests that need the card: every kernel family compiled for the GPU and
checked against its XLA twin at the README's frame sizes (the parity
gates).  They skip on the CPU; run them on the GPU with
``CURVIS_TEST_PLATFORM=gpu python -m pytest tests/test_on_card.py -m gpu``."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))


@pytest.mark.gpu
def test_gates_compiled_for_the_card(gpu_only):
    from parity_gates import run_gates
    res = run_gates(full=True)
    bad = {k: v for k, v in res.items() if not v.get("ok")}
    assert not bad, bad
