"""The parity gates (benchmarks/parity_gates.py) in interpret mode:
validates the gate logic itself on CPU so a gate failure on the card can
only mean a GPU miscompile (the gates' whole purpose), never a broken
probe."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))


@pytest.mark.parametrize("family", ["euler_ellis", "rk45", "rk45_disk",
                                    "fused_euler", "fused_rk45",
                                    "rk45_vol", "kerr_rk45",
                                    "kerr_rk45_vol", "table", "table_rk45",
                                    "table_disk", "table_vol", "kerr",
                                    "disk", "volumetric"])
def test_gate_passes_on_cpu(family):
    from parity_gates import run_gates
    res = run_gates(only=[family])[family]
    assert res.get("ok"), res


def test_gate_error_is_reported_not_raised(monkeypatch):
    """A crashing probe must surface as ok=False, not kill the bench."""
    import parity_gates as pg

    def boom():
        raise RuntimeError("probe exploded")

    monkeypatch.setitem(pg.GATES, "euler_ellis", boom)
    res = pg.run_gates(only=["euler_ellis"])["euler_ellis"]
    assert res["ok"] is False and "probe exploded" in res["error"]
