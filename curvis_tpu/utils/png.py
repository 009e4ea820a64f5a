"""A small PNG codec on the standard library (zlib, struct) and numpy.

Reads 8-bit, non-interlaced PNGs of every color type (gray, RGB, palette,
gray+alpha, RGBA) with all five scanline filters; writes 8-bit RGB (or
gray) with filter 0.  That covers what the renderer loads and saves, so the
main path needs no imaging library.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr) -> bytes:
    """(H, W, 3) or (H, W) uint8 array -> PNG bytes."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: expected (H, W) or (H, W, 3), got "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int):
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = int(data[pos])
        row = data[pos + 1:pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:          # Sub: running sum per channel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:          # Up
            cur = (row + prior) & 0xFF
        elif ftype in (3, 4):     # Average, Paeth: sequential along the row
            cur = row.copy()
            px = row.reshape(-1, bpp)
            up = prior.reshape(-1, bpp)
            cp = cur.reshape(-1, bpp)
            left = np.zeros(bpp, np.int32)
            ul = np.zeros(bpp, np.int32)
            for i in range(px.shape[0]):
                if ftype == 3:
                    v = (px[i] + ((left + up[i]) >> 1)) & 0xFF
                else:
                    p = left + up[i] - ul
                    pa, pb, pc = np.abs(p - left), np.abs(p - up[i]), \
                        np.abs(p - ul)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[i], ul))
                    v = (px[i] + pred) & 0xFF
                cp[i] = v
                left = v
                ul = up[i]
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur
        prior = cur.astype(np.int32)
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (gray and palette expanded, alpha
    dropped)."""
    if blob[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = None
    hdr = None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"PNG: only 8-bit non-interlaced images are "
                         f"supported (depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[color]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(data, h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def write_png(path, arr) -> None:
    Path(path).write_bytes(encode_png(arr))
