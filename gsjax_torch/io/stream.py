"""Streamed scene ingest with progress callbacks — the PyTorch
counterpart of gsjax/io/stream.py.

The source is a path or any readable byte stream, seekable or not: rows
are decoded chunk by chunk on the host into arrays allocated up front,
so the extra memory is one chunk and its row carry, and the scene's
tensors are made once, at the end, on `device` (the card by default).

`on_progress(bytes_done, bytes_total)` fires once per chunk, bytes_done
never decreasing (bytes_total = -1 for a stream whose size is unknown).
"""

from __future__ import annotations

import io
import os

import numpy as np

from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.io.ply import (_assemble, empty_scene, fill_rows, parse_ply_header,
                                sh_count)
from gsjax_torch.io.splat import ROW_LENGTH, from_splat_arrays, parse_splat_bytes

DEFAULT_CHUNK = 16 * 1024 * 1024
_MAX_HEADER = 64 * 1024  # the progressive header search's bound
_SPLAT_SHAPES = {"positions": (3,), "scales": (3,), "rgb": (3,), "opacities": (),
                 "quats": (4,)}


def _open(src):
    """(stream, total_bytes, close_needed) for a path or a binary stream."""
    if hasattr(src, "read"):
        total = -1
        try:
            pos = src.tell()
            src.seek(0, io.SEEK_END)
            total = src.tell() - pos
            src.seek(pos)
        except (OSError, io.UnsupportedOperation):
            pass
        return src, total, False
    path = os.fspath(src)
    return open(path, "rb"), os.path.getsize(path), True


def _read_header(fh) -> bytes:
    """Read until the header's end_header line: the bytes read so far."""
    head = b""
    while b"end_header\n" not in head:
        if len(head) > _MAX_HEADER:
            raise ValueError("header_end_not_found: no end_header")
        b_ = fh.read(8192)
        if not b_:
            raise ValueError("header_end_not_found: stream ended")
        head += b_
    return head


def load_splat_streamed(src, on_progress=None, chunk_bytes: int = DEFAULT_CHUNK,
                        device="cuda") -> Gaussians:
    """Chunked .splat ingest: read → decode the chunk's whole rows →
    on_progress, until the stream ends."""
    fh, total, close = _open(src)
    try:
        n_rows = total // ROW_LENGTH if total >= 0 else None
        bufs = []
        out = None if n_rows is None else {
            k: np.empty((n_rows,) + s, np.float32) for k, s in _SPLAT_SHAPES.items()}
        done = row = 0
        carry = b""
        while True:
            chunk = fh.read(chunk_bytes)
            if not chunk:
                break
            done += len(chunk)
            data = carry + chunk
            n_full = len(data) // ROW_LENGTH
            carry = data[n_full * ROW_LENGTH:]
            if n_full:
                d = parse_splat_bytes(data[: n_full * ROW_LENGTH])
                if out is not None:
                    for k in out:
                        out[k][row: row + n_full] = d[k]
                else:
                    bufs.append(d)
                row += n_full
            if on_progress is not None:
                on_progress(done, total)
        if carry:
            raise ValueError(f".splat stream ends mid-row ({len(carry)} trailing bytes)")
        if out is None:
            out = {k: np.concatenate([b[k] for b in bufs]) if bufs else
                   np.zeros((0,) + s, np.float32) for k, s in _SPLAT_SHAPES.items()}
        return from_splat_arrays(out, device)
    finally:
        if close:
            fh.close()


def load_ply_streamed(src, on_progress=None, use_shs: bool = True, format: str = "",
                      chunk_bytes: int = DEFAULT_CHUNK, device="cuda") -> Gaussians:
    """Chunked plain-3DGS-PLY ingest: accumulate until `end_header`, then
    decode the complete vertex rows of each chunk into the preallocated
    arrays."""
    fh, total, close = _open(src)
    try:
        head = _read_header(fh)
        header = parse_ply_header(head)
        vert = next((e for e in header.elements if e.name == "vertex"), None)
        if vert is None:
            raise ValueError("PLY has no vertex element")
        if header.elements[0].name != "vertex":
            # rows are decoded from data_offset: the vertex element must
            # come first (as parse_ply assumes)
            raise ValueError(
                "streamed PLY ingest requires vertex as the first element "
                f"(file order: {[e.name for e in header.elements]})")
        names = {nm for nm, _t in vert.properties}
        dtype = np.dtype([(nm, t) for nm, t in vert.properties])
        n = vert.count
        d = empty_scene(n, sh_count(names, use_shs))

        # the first data rows came with the header
        carry = head[header.data_offset:]
        done = len(head)
        stride = dtype.itemsize
        row = 0
        while True:
            n_full = min(len(carry) // stride, n - row)
            if n_full:
                rows = np.frombuffer(carry, dtype=dtype, count=n_full)
                fill_rows(d, rows, slice(row, row + n_full), names, use_shs)
                row += n_full
                carry = carry[n_full * stride:]
            if on_progress is not None:
                on_progress(done, total)
            if row >= n:
                break
            chunk = fh.read(chunk_bytes)
            if not chunk:
                raise ValueError(f"PLY stream ended at row {row} of {n}")
            done += len(chunk)
            carry = carry + chunk
        # drain the trailing elements so the last report reaches bytes_total
        if on_progress is not None:
            while True:
                chunk = fh.read(chunk_bytes)
                if not chunk:
                    break
                done += len(chunk)
                on_progress(done, total)
            on_progress(done, total)
        return _assemble(d, format, device)
    finally:
        if close:
            fh.close()


def load_qply_streamed(src, on_progress=None, format: str = "", banded: bool = False,
                       chunk_bytes: int = DEFAULT_CHUNK, device="cuda"):
    """Chunked quantized-PLY ingest. The codebooks come after all vertex
    data, so decoding waits for the whole file; the u8 / i16 index rows
    (~8x smaller than the decoded scene) accumulate per group into
    preallocated structured arrays and decode once the codebooks arrive.
    The same scene as io.qply.parse_qply, bit for bit."""
    from gsjax_torch.io.qply import decode_qply, parse_qheader

    fh, total, close = _open(src)
    try:
        head = _read_header(fh)
        groups, cb_props, data_start = parse_qheader(head)
        rows_by_group = [np.empty(count, dtype) for _b, count, dtype in groups]
        fills = [0] * len(groups)
        gi = 0
        carry = head[data_start:]
        done = len(head)
        cb_bytes = 256 * len(cb_props) * 2
        cb_buf = b""
        while True:
            # the current group(s)' complete rows in the carry
            while gi < len(groups):
                _bands, count, dtype = groups[gi]
                need = count - fills[gi]
                if need == 0:
                    gi += 1
                    continue
                n_full = min(len(carry) // dtype.itemsize, need)
                if n_full:
                    rows_by_group[gi][fills[gi]: fills[gi] + n_full] = np.frombuffer(
                        carry, dtype=dtype, count=n_full)
                    fills[gi] += n_full
                    carry = carry[n_full * dtype.itemsize:]
                if fills[gi] < count:
                    break  # needs more bytes
                gi += 1
            if gi >= len(groups):
                cb_buf += carry
                carry = b""
                if len(cb_buf) >= cb_bytes:
                    break
            if on_progress is not None:
                on_progress(done, total)
            chunk = fh.read(chunk_bytes)
            if not chunk:
                raise ValueError(
                    f"quantized PLY stream ended early (group {gi}, "
                    f"row {fills[min(gi, len(groups) - 1)]})")
            done += len(chunk)
            carry += chunk
        if on_progress is not None:
            on_progress(done, total)
        cb_raw = np.frombuffer(cb_buf, dtype="<i2",
                               count=256 * len(cb_props)).reshape(256, len(cb_props))
        return decode_qply(groups, rows_by_group, cb_raw, cb_props, format, banded, device)
    finally:
        if close:
            fh.close()
