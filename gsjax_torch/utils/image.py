"""PNG writing with numpy and the standard library only."""

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
