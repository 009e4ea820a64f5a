"""Packed-quad bilinear readout: bit-parity with the legacy 4-gather form.

Round-5 readout optimization: _filter_lookup's bilinear path packs each
texel's pole/wrap-resolved 2x2 neighbourhood into one (P*(H+1)*W, 12) row
table so the readout is ONE gather of 12 contiguous floats per ray instead
of four.  The blend
arithmetic is unchanged, so results must match the legacy implementation
BIT-FOR-BIT — including rays whose bilinear footprint crosses a pole
(reference seam semantics, images.rs:115-167 lookup chain).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from curvis_tpu.render.fast import _filter_lookup, _filter_lookup_legacy


def _uv_cases(rng, n):
    u = rng.random(n)
    v = rng.random(n)
    # force pole-crossing footprints: v near 0 and near 1
    v[: n // 4] = rng.random(n // 4) * 0.4 / 64.0
    v[n // 4: n // 2] = 1.0 - rng.random(n // 4) * 0.4 / 64.0
    return jnp.asarray(u), jnp.asarray(v)


@pytest.mark.parametrize("pages", [1, 2])
@pytest.mark.parametrize("hw", [(8, 16), (64, 128), (33, 50)])
def test_bilinear_quad_matches_legacy_bitwise(pages, hw):
    H, W = hw
    rng = np.random.default_rng(7)
    rows = jnp.asarray(rng.random((pages * H * W, 3)))
    n = 4096
    u, v = _uv_cases(rng, n)
    base = jnp.asarray(rng.integers(0, pages, n) * (H * W), jnp.int32)
    got = _filter_lookup(rows, base, u, v, W, H, "bilinear")
    want = _filter_lookup_legacy(rows, base, u, v, W, H, "bilinear")
    assert got.shape == want.shape == (n, 3)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_nearest_matches_legacy_bitwise():
    H, W = 64, 128
    rng = np.random.default_rng(3)
    rows = jnp.asarray(rng.random((2 * H * W, 3)))
    n = 2048
    u, v = _uv_cases(rng, n)
    base = jnp.asarray(rng.integers(0, 2, n) * (H * W), jnp.int32)
    got = _filter_lookup(rows, base, u, v, W, H, "nearest")
    want = _filter_lookup_legacy(rows, base, u, v, W, H, "nearest")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bilinear_quad_exact_values_flat_texture():
    # a constant texture must bilinear-sample to exactly that constant,
    # pole rows included (weights sum to 1 by construction)
    H, W = 16, 32
    rows = jnp.full((H * W, 3), 0.625)
    rng = np.random.default_rng(11)
    u, v = _uv_cases(rng, 512)
    base = jnp.zeros(512, jnp.int32)
    out = _filter_lookup(rows, base, u, v, W, H, "bilinear")
    np.testing.assert_allclose(np.asarray(out), 0.625, rtol=0, atol=1e-15)
