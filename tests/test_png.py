"""The built-in PNG codec (curvis_tpu/utils/png.py) and the image IO that
uses it."""
import struct
import zlib

import numpy as np
import pytest

from curvis_tpu.utils import png


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered_png(img, ftype, color=2, palette=None):
    """Hand-built PNG with every scanline filtered by ``ftype`` (the
    spec's encoder side, independent of the codec under test)."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    rows = img.reshape(h, -1).astype(np.int32)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prior
        elif ftype == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
            f = cur - pred
        raw.append(ftype)
        raw.extend((f & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    out = png._SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                  color, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (out + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


@pytest.fixture
def img():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)


def test_round_trip_rgb(img):
    np.testing.assert_array_equal(png.decode_png(png.encode_png(img)), img)


def test_round_trip_gray(img):
    g = img[..., 0]
    out = png.decode_png(png.encode_png(g))
    np.testing.assert_array_equal(out, np.repeat(g[..., None], 3, -1))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_every_scanline_filter(img, ftype):
    np.testing.assert_array_equal(png.decode_png(_filtered_png(img, ftype)),
                                  img)


@pytest.mark.parametrize("ftype", [1, 4])
def test_rgba_drops_alpha(img, ftype):
    rgba = np.concatenate([img, img[..., :1]], -1)
    got = png.decode_png(_filtered_png(rgba, ftype, color=6))
    np.testing.assert_array_equal(got, img)


def test_palette(img):
    pal = np.random.default_rng(4).integers(0, 256, (256, 3))
    idx = img[..., 0]
    got = png.decode_png(_filtered_png(idx, 2, color=3, palette=pal))
    np.testing.assert_array_equal(got, pal[idx])


def test_refuses_16_bit(img):
    blob = bytearray(png.encode_png(img))
    blob[24] = 16                         # IHDR bit depth
    with pytest.raises(ValueError, match="8-bit"):
        png.decode_png(bytes(blob))


def test_save_and_load_spherical_image(tmp_path, img):
    import curvis_tpu as cv
    p = tmp_path / "sky.png"
    cv.save_image(img / 255.0, p)
    sky = cv.load_spherical_image(p)
    np.testing.assert_allclose(np.asarray(sky.texture), img / 255.0,
                               atol=1e-6)


def test_other_formats_name_the_format_without_pil(tmp_path, monkeypatch):
    import builtins
    from curvis_tpu.env.spherical_image import read_image
    p = tmp_path / "sky.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0 not a png")
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match=r"\.jpg images need PIL"):
        read_image(p)
