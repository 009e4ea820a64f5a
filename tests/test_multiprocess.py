"""REAL multi-process jax.distributed execution (VERDICT round-4 #4).

Unlike tests/test_distributed.py (single-process degenerate case) and the
8-virtual-device suite, these tests spawn 2 OS processes x 4 virtual CPU
devices each via subprocess + a local coordinator, so
``jax.process_count() == 2`` is genuinely exercised: process-group
formation, a cross-process allgather, process_index-based band ownership,
and cross-process manifest/tile assembly.
"""
import numpy as np
import pytest

from curvis_tpu.parallel.multiproc import (render_demo_single_process,
                                           run_multiprocess_render,
                                           worker_env)


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_tiles")
    stats = run_multiprocess_render(out, n_processes=2, local_devices=4)
    return out, stats


def test_process_group_forms(mp_run):
    _, stats = mp_run
    assert [s["process_id"] for s in stats] == [0, 1]
    for s in stats:
        assert s["process_count"] == 2
        assert s["local_devices"] == 4
        assert s["global_devices"] == 8
        # the collective saw BOTH processes — cross-process data
        assert sorted(s["allgather"]) == [0, 1]


def test_band_ownership_is_disjoint_and_complete(mp_run):
    out, stats = mp_run
    # both processes rendered bands; neither rendered everything
    assert all(s["n_tiles"] > 0 for s in stats)
    tiles = sorted(out.glob("tile_*.npy"))
    rows = []
    for t in tiles:
        y0, y1 = (int(v) for v in t.stem.split("_")[1:3])
        rows.extend(range(y0, y1))
    from curvis_tpu.parallel.multiproc import DEMO_RES
    assert sorted(rows) == list(range(DEMO_RES[1]))   # no gap, no overlap
    # two manifests, one per host
    assert {(p.name) for p in out.glob("manifest_host*.json")} == {
        "manifest_host0.json", "manifest_host1.json"}


def test_assembled_image_matches_single_process(mp_run):
    out, _ = mp_run
    from curvis_tpu.parallel.distributed import assemble_tiles
    from curvis_tpu.parallel.multiproc import DEMO_RES
    img = assemble_tiles(out, DEMO_RES[0], DEMO_RES[1])
    ref = render_demo_single_process()
    # band decomposition is per-ray math: bit-identical assembly
    np.testing.assert_array_equal(img, ref)
    assert np.isfinite(ref).all() and (ref.sum(-1) > 0).mean() > 0.9


@pytest.mark.parametrize("visible,cards", [(None, ["0", "1", "2", "3"]),
                                           ("4,5,6,7", ["4", "5", "6", "7"]),
                                           ("GPU-a, GPU-b,GPU-c,GPU-d",
                                            ["GPU-a", "GPU-b", "GPU-c",
                                             "GPU-d"])])
def test_gpu_worker_takes_the_ith_visible_card(visible, cards):
    """One card per GPU worker, taken from the parent's visible list."""
    base = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    got = [worker_env(i, base, platform="gpu", local_devices=1)
           ["CUDA_VISIBLE_DEVICES"] for i in range(4)]
    assert got == cards
    assert "JAX_PLATFORMS" not in worker_env(0, base, platform="gpu",
                                             local_devices=1)


def test_gpu_worker_beyond_the_visible_cards_fails():
    with pytest.raises(ValueError):
        worker_env(2, {"CUDA_VISIBLE_DEVICES": "3,5"}, platform="gpu",
                   local_devices=1)


def test_cpu_worker_gets_virtual_devices():
    env = worker_env(1, {"CUDA_VISIBLE_DEVICES": "3"}, platform="cpu",
                     local_devices=4)
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "device_count=4" in env["XLA_FLAGS"]
