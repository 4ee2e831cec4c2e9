"""3D-Gaussian-Splatting .ply IO — the PyTorch counterpart of
gsjax/io/ply.py. The quantized-codebook variant lives in io/qply.py.

Parsing is on the host: the native C++ parser (io/native.py) for plain
all-float rows, else vectorized numpy; the scene's tensors are made once,
on `device` (the card by default), bit for bit from the parsed arrays.

Property semantics:
  scale_*   log-space → stored directly as log_scales
  opacity   logit → stored directly as opacity_logits
  rot_*     (w, x, y, z), unnormalized → normalized on use
  f_dc_*    SH degree-0 coefficients
  f_rest_*  the higher-order coefficients, channel-major in the file:
            f_rest_[0..14] = R coeffs 1..15, [15..29] = G, [30..44] = B
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from gsjax_torch.core.gaussians import SH_C0, Gaussians
from gsjax_torch.io.splat import to_host

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2",
    "ushort": "<u2", "uint16": "<u2",
    "float16": "<f2", "half": "<f2",
    "char": "<i1", "int8": "<i1",
    "uchar": "<u1", "uint8": "<u1",
}


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    properties: list  # [(name, numpy dtype str)]


@dataclasses.dataclass
class PlyHeader:
    elements: list
    data_offset: int


def parse_ply_header(buf: bytes) -> PlyHeader:
    end_tag = b"end_header\n"
    end = buf.find(end_tag)
    if not buf.startswith(b"ply") or end < 0:
        raise ValueError("Invalid PLY file")
    header = buf[:end].decode("ascii", errors="replace")
    if "binary_little_endian" not in header:
        raise ValueError("Only binary_little_endian PLY is supported")
    elements: list[PlyElement] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "element":
            elements.append(PlyElement(parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                raise ValueError("list properties are not supported")
            dt = _PLY_DTYPES.get(parts[1])
            if dt is None:
                raise ValueError(f"unsupported PLY property type {parts[1]}")
            elements[-1].properties.append((parts[2], dt))
    return PlyHeader(elements=elements, data_offset=end + len(end_tag))


def element_recarray(buf: bytes, header: PlyHeader, elem: PlyElement, offset: int):
    """One element's packed rows as a numpy structured array, its dtype
    in the header's property order and types; and the offset past them."""
    dtype = np.dtype([(n, t) for n, t in elem.properties])
    arr = np.frombuffer(buf, dtype=dtype, count=elem.count, offset=offset)
    return arr, offset + dtype.itemsize * elem.count


def sh_count(names, use_shs: bool) -> int:
    """K, the SH coefficients a row keeps: 1 + f_rest count / 3, down to
    the nearest degree's (1 without use_shs)."""
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    k = 1 + n_rest // 3 if use_shs else 1
    return k if k in (1, 4, 9, 16) else next(v for v in (16, 9, 4, 1) if v <= k)


def fill_rows(d: dict, rows, sl, names, use_shs: bool) -> None:
    """Decode structured vertex rows into the preallocated arrays of `d`
    at rows `sl` (means, log_scales, quats, opacity_logits, sh; a field
    the file lacks keeps its default)."""
    d["means"][sl] = np.stack([rows["x"], rows["y"], rows["z"]], -1).astype(np.float32)
    if "scale_0" in names:
        d["log_scales"][sl] = np.stack([rows[f"scale_{i}"] for i in range(3)],
                                       -1).astype(np.float32)
    if "rot_0" in names:
        d["quats"][sl] = np.stack([rows[f"rot_{i}"] for i in range(4)], -1).astype(np.float32)
    if "opacity" in names:
        d["opacity_logits"][sl] = rows["opacity"].astype(np.float32)
    if "f_dc_0" in names:
        for c in range(3):
            d["sh"][sl, 0, c] = rows[f"f_dc_{c}"]
    elif "red" in names:
        for c, nm in enumerate(("red", "green", "blue")):
            d["sh"][sl, 0, c] = (rows[nm].astype(np.float32) / 255.0 - 0.5) / SH_C0
    k = d["sh"].shape[1]
    if use_shs and k > 1:
        per_ch = sum(1 for nm in names if nm.startswith("f_rest_")) // 3
        for c in range(3):  # channel-major in the file → [N, coeff, channel]
            for j in range(k - 1):
                d["sh"][sl, 1 + j, c] = rows[f"f_rest_{c * per_ch + j}"]


def empty_scene(n: int, k: int) -> dict:
    """The arrays fill_rows decodes into, with the defaults of a field a
    file lacks: scale 0.01, the identity rotation, opacity logit 30."""
    return {"means": np.empty((n, 3), np.float32),
            "log_scales": np.full((n, 3), np.log(0.01), np.float32),
            "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
            "opacity_logits": np.full((n,), 30.0, np.float32),
            "sh": np.zeros((n, k, 3), np.float32)}


def load_ply(path_or_bytes, use_shs: bool = True, format: str = "",
             quantized: bool = False, use_native: bool = True, banded: bool = False,
             device="cuda"):
    """Load a 3DGS .ply (a path, or its bytes) into Gaussians on `device`
    (the card unless device="cpu" is passed). format="polycam" flips y and
    z. With quantized=True the codebook layout (io/qply.py); with
    banded=True too, a BandedGaussians keeping each band group's own SH
    size. use_native: the native parser where it takes the layout, else
    numpy."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(os.fspath(path_or_bytes), "rb") as fh:
            buf = fh.read()
    if quantized:
        from gsjax_torch.io.qply import parse_qply

        return parse_qply(buf, format=format, banded=banded, device=device)
    if banded:
        raise ValueError("banded=True requires quantized=True")
    if use_native:
        from gsjax_torch.io.native import parse_ply_native

        out = parse_ply_native(buf, use_shs=use_shs)
        if out is not None:
            return _assemble(out, format, device)
    return _parse_ply_numpy(buf, use_shs=use_shs, format=format, device=device)


def _parse_ply_numpy(buf: bytes, use_shs: bool, format: str, device="cuda") -> Gaussians:
    header = parse_ply_header(buf)
    vert = next((e for e in header.elements if e.name == "vertex"), None)
    if vert is None:
        raise ValueError("PLY has no vertex element")
    rows, _ = element_recarray(buf, header, vert, header.data_offset)
    names = {n for n, _ in vert.properties}
    d = empty_scene(vert.count, sh_count(names, use_shs))
    fill_rows(d, rows, slice(None), names, use_shs)
    return _assemble(d, format, device)


def save_ply(g: Gaussians, path=None) -> bytes:
    """Serialize to the standard 3DGS .ply layout (the inverse of
    load_ply's property semantics); written to `path` if given."""
    means, log_scales, quats, sh, opacity = (
        to_host(x) for x in (g.means, g.log_scales, g.quats, g.sh, g.opacity_logits))
    n, k = sh.shape[0], sh.shape[1]
    n_rest = 3 * (k - 1)
    props = (
        ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity", "scale_0", "scale_1", "scale_2"]
        + [f"rot_{i}" for i in range(4)]
    )
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    ).encode("ascii")
    out = np.zeros((n, len(props)), np.float32)
    out[:, 0:3] = means
    out[:, 6:9] = sh[:, 0, :]
    for c in range(3):  # channel-major f_rest, load_ply's read order
        out[:, 9 + c * (k - 1): 9 + (c + 1) * (k - 1)] = sh[:, 1:, c]
    base = 9 + n_rest
    out[:, base] = opacity
    out[:, base + 1: base + 4] = log_scales
    out[:, base + 4: base + 8] = quats
    blob = header + out.tobytes()
    if path is not None:
        with open(os.fspath(path), "wb") as fh:
            fh.write(blob)
    return blob


def _assemble(d: dict, format: str, device="cuda") -> Gaussians:
    means, quats = d["means"], d["quats"]
    if format == "polycam":
        # flip y/z of the positions and the matching quaternion components
        means = means * np.array([1, -1, -1], np.float32)
        quats = quats * np.array([1, 1, -1, -1], np.float32)
    return Gaussians.from_numpy(means, d["log_scales"], quats, d["sh"],
                                d["opacity_logits"], device=device)
