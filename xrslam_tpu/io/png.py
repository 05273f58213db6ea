"""PNG encode/decode with the standard library (zlib + struct) and numpy.

The renderer writes its 8-bit grayscale frames and 16-bit depth images
here; the reader decodes through the native runtime when it is built
(native/xr_host.cpp) and through `read` otherwise. Both decoders accept
the same subset: 8/16-bit gray, gray+alpha, RGB and RGBA, not
interlaced, all five scanline filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_gray(path: str, img: np.ndarray) -> None:
    """Write an (H,W) uint8 or uint16 array as a grayscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected (H,W) uint8/uint16, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2") if depth == 16 else img
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.view(np.uint8).reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_MAGIC + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG: image data size does not match the header")
    rows = rows.reshape(h, stride + 1)
    if not rows[:, 0].any():   # every scanline unfiltered (write_gray)
        return rows[:, 1:].copy()
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:   # Sub: running sum along each byte lane of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:   # Up
            cur = (line + prev) & 0xFF
        elif f in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {f}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read(path: str) -> np.ndarray:
    """Decode a PNG to its raw samples: (H,W,C) uint8 or uint16."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, hdr = 8, [], None
    while off + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[off:off + 8])
        data = buf[off + 8:off + 8 + n]
        if len(data) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        off += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return raw.reshape(h, w * ch * 2).view(">u2").astype(
            np.uint16).reshape(h, w, ch)
    return raw.reshape(h, w, ch)


def load_gray(path: str) -> np.ndarray:
    """(H,W) float32 grayscale in [0,1]; color is converted with the
    ITU-R 601 weights of cv::cvtColor (the native decoder's rule)."""
    px = read(path)
    x = px.astype(np.float32) / (255.0 if px.dtype == np.uint8 else 65535.0)
    if px.shape[2] >= 3:
        return (0.299 * x[..., 0] + 0.587 * x[..., 1]
                + 0.114 * x[..., 2]).astype(np.float32)
    return x[..., 0]
