"""Utility modules: assembly, profiling, logging, debug."""
from pathlib import Path

import numpy as np
import pytest

from curvis_tpu.utils.assemble import assemble_gif, sorted_frames
from curvis_tpu.utils.prof import StageTimer, time_fn
from curvis_tpu.utils.log import get_logger
from curvis_tpu.utils.debug import nan_checks


def test_sorted_frames_and_gif(tmp_path):
    from PIL import Image
    # deliberately out-of-order names incl. 2-digit indices
    for i in (0, 2, 10, 1):
        Image.new("RGB", (8, 6), (i * 20, 0, 0)).save(
            tmp_path / f"frame_{i}.png")
    (tmp_path / "not_a_frame.png").touch()
    frames = sorted_frames(tmp_path)
    assert [f.name for f in frames] == [
        "frame_0.png", "frame_1.png", "frame_2.png", "frame_10.png"]
    gif = assemble_gif(tmp_path, tmp_path / "out.gif", frame_rate=10)
    assert gif.exists() and gif.stat().st_size > 0
    with pytest.raises(FileNotFoundError):
        assemble_gif(tmp_path / "empty", tmp_path / "x.gif")


def test_assemble_mp4_missing_ffmpeg(tmp_path, monkeypatch):
    """Without ffmpeg the error is actionable, not a subprocess trace."""
    from curvis_tpu.utils import assemble
    monkeypatch.setattr(assemble.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg not available"):
        assemble.assemble_mp4(tmp_path, tmp_path / "out.mp4")


def test_assemble_mp4_concat_list(tmp_path, monkeypatch):
    """The concat list covers the real sorted frames (gapped, non-zero
    start — the resume scenario a frame_%d input pattern breaks on) and
    the ffmpeg invocation is well-formed; ffmpeg itself is faked."""
    from PIL import Image
    from curvis_tpu.utils import assemble
    for i in (3, 7, 12):                      # gapped, starts at 3
        Image.new("RGB", (8, 6), (i, 0, 0)).save(tmp_path / f"frame_{i}.png")
    seen = {}

    def fake_run(cmd, check, capture_output):
        seen["cmd"] = cmd
        lst = Path(cmd[cmd.index("-i") + 1])
        seen["list_text"] = lst.read_text()
        Path(cmd[-1]).write_bytes(b"mp4")
        return None

    monkeypatch.setattr(assemble.shutil, "which", lambda _: "/usr/bin/ffmpeg")
    monkeypatch.setattr(assemble.subprocess, "run", fake_run)
    out = assemble.assemble_mp4(tmp_path, tmp_path / "out.mp4",
                                frame_rate=24.0)
    assert out.exists()
    order = [ln.split("frame_")[1] for ln in seen["list_text"].splitlines()
             if ln.startswith("file ")]
    assert order == ["3.png'", "7.png'", "12.png'", "12.png'"]  # last held
    assert "duration 0.041" in seen["list_text"]                # 1/24 s
    assert not list(tmp_path.glob(".concat_frames.txt"))        # cleaned up
    with pytest.raises(FileNotFoundError):
        assemble.assemble_mp4(tmp_path / "empty", tmp_path / "x.mp4")


@pytest.mark.skipif(__import__("shutil").which("ffmpeg") is None,
                    reason="ffmpeg not installed")
def test_assemble_mp4_real(tmp_path):
    from PIL import Image
    from curvis_tpu.utils.assemble import assemble_mp4
    for i in range(4):
        Image.new("RGB", (16, 16), (i * 40, 0, 0)).save(
            tmp_path / f"frame_{i}.png")
    out = assemble_mp4(tmp_path, tmp_path / "out.mp4", frame_rate=8.0)
    assert out.exists() and out.stat().st_size > 0


def test_stage_timer():
    t = StageTimer()
    t.record("march", 0.1)
    t.record("march", 0.2)
    t.record("shade", 0.05)
    s = t.summary(rays=1_000_000)
    assert abs(s["march"] - 0.3) < 1e-9
    assert abs(s["total"] - 0.35) < 1e-9
    assert s["Mrays_per_s"] > 0
    assert "march" in t.report()


def test_time_fn_and_materialize():
    """Timings wait with jax.block_until_ready (pytrees with non-array
    leaves included), and StageTimer stops its clock on ready outputs."""
    import jax
    import jax.numpy as jnp
    out = jax.block_until_ready({"a": jnp.ones(4),
                                 "b": (jnp.zeros(2), "meta")})
    assert "a" in out
    t = StageTimer()
    with t.stage("ones") as held:
        held.append(jnp.ones(8) * 2)
    assert t.counts["ones"] == 1 and t.stages["ones"] >= 0
    t = time_fn(lambda x: (x * 2).sum(), jnp.arange(8.0), iters=1, warmup=1)
    assert t >= 0


def test_logger_and_nan_checks():
    log = get_logger("test")
    log.info("hello")
    import jax, jax.numpy as jnp
    with nan_checks():
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            float(jnp.log(jnp.asarray(-1.0)))
    assert not jax.config.jax_debug_nans
