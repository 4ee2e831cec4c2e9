"""PNG writing and reading with numpy and the standard library only — the
PyTorch port's copy of gsjax/utils/image.py."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path, img) -> None:
    """Write [H, W, 3] float (0-1) or uint8 to an 8-bit RGB PNG file."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    h, w = arr.shape[:2]

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as fh:
        fh.write(out)


def read_png(path) -> np.ndarray:
    """Minimal PNG reader for files written by write_png (8-bit RGB,
    no interlace)."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        ftype = raw[y * stride]
        line = np.frombuffer(raw[y * stride + 1 : (y + 1) * stride], np.uint8)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 2:  # Up
            cur = (line.astype(np.int16) + prev).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        rows.append(cur)
        prev = cur
    return np.stack(rows).reshape(h, w, 3)
