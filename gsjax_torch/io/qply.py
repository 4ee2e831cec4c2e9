"""Quantized-codebook PLY loader — the PyTorch counterpart of
gsjax/io/qply.py.

  - 4 vertex groups `element vertex_<i> <count>` (i = the group's active
    SH bands, 0..3), rows stored group after group;
  - positions as raw f16 (their int16 bit pattern);
  - every other attribute a u8 index into one of the 256-entry f16
    codebooks of `element codebook_centers 256` (stored after all vertex
    data, row-interleaved int16): scaling → log-scale, rotation_re/im →
    quaternion w / xyz, features_dc → SH DC, opacity → opacity logit,
    features_rest_<k> → SH band coefficient k (shared across channels;
    the file's f_rest columns are channel-major per group).

Decoding is vectorized numpy on the host; the header and decode helpers
are shared with io/stream.load_qply_streamed.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_SIZES = {"double": 8, "int": 4, "uint": 4, "float": 4, "short": 2, "ushort": 2,
          "uchar": 1}
_SH_STRIDE = {0: 0, 1: 3, 2: 8, 3: 15}


def parse_qheader(head: bytes):
    """Parse a quantized-PLY header (bytes through ``end_header``).

    Returns (groups, cb_props, data_start): groups in FILE order as
    (bands, count, numpy dtype); cb_props the codebook column names."""
    end_tag = b"end_header\n"
    hi = head.find(end_tag)
    if not head.startswith(b"ply") or hi < 0:
        raise ValueError("Unable to read .ply file header")
    header = head[:hi].decode("ascii", errors="replace")
    data_start = hi + len(end_tag)

    groups, cb_props = [], []
    for sec in re.split(r"\nelement ", "\n" + header):
        sec = sec.strip()
        if not sec or sec.startswith("ply") or sec.startswith("format"):
            continue
        first, *rest = sec.splitlines()
        m = re.match(r"vertex_(\d+)\s+(\d+)", first)
        props = [tuple(line.split()[1:3]) for line in rest if line.startswith("property ")]
        if m:
            dtype = np.dtype([(name, "<i2" if t == "short" else "<u1") for t, name in props])
            if dtype.itemsize != sum(_SIZES[t] for t, _n in props):
                raise ValueError("unsupported property type in quantized PLY")
            groups.append((int(m.group(1)), int(m.group(2)), dtype))
        elif first.startswith("codebook_centers"):
            cb_props = [name for _t, name in props]
    if len(groups) != 4:
        raise ValueError(f"expected 4 quantized vertex groups, got {len(groups)}")
    return groups, cb_props, data_start


def decode_qply(groups, rows_by_group, cb_raw, cb_props, format: str = "",
                banded: bool = False, device="cuda"):
    """Decode structured index rows + codebooks into the scene on
    `device`. groups / rows_by_group in file order; the groups come out
    band-ascending."""
    from gsjax_torch.core.banded import BandedGaussians
    from gsjax_torch.io.ply import _assemble

    codebooks = {name: cb_raw[:, j].view(np.float16).astype(np.float32)
                 for j, name in enumerate(cb_props)}
    parts = []
    for gi in sorted(range(len(groups)), key=lambda i: groups[i][0]):
        bands, count, dtype = groups[gi]
        if count == 0:
            continue
        rows = rows_by_group[gi]
        d = {
            "means": np.stack([rows[c].view(np.float16).astype(np.float32)
                               for c in ("x", "y", "z")], axis=-1),
            "log_scales": np.stack([codebooks["scaling"][rows[f"scale_{i}"]]
                                    for i in range(3)], axis=-1),
            "quats": np.stack([codebooks["rotation_re"][rows["rot_0"]]]
                              + [codebooks["rotation_im"][rows[f"rot_{i}"]]
                                 for i in (1, 2, 3)], axis=-1),
            "opacity_logits": codebooks["opacity"][rows["opacity"]],
        }
        # the group's own SH size, K = 1 + stride: a band-0 splat stores 12 B
        stride = _SH_STRIDE[bands]
        sh = np.zeros((count, 1 + stride, 3), np.float32)
        for c in range(3):
            sh[:, 0, c] = codebooks["features_dc"][rows[f"f_dc_{c}"]]
        rest_names = [n for n in dtype.names if n.startswith("f_rest_")]
        # f_rest_[c·stride + k] is channel c, coefficient k
        for c in range(3):
            for k in range(stride):
                sh[:, 1 + k, c] = codebooks[f"features_rest_{k}"][rows[rest_names[c * stride + k]]]
        d["sh"] = sh
        parts.append(_assemble(d, format, device))
    bg = BandedGaussians.from_groups(parts)
    if banded:
        return bg
    with torch.no_grad():  # fresh parameters, not a view of the groups
        return bg.to_gaussians()


def parse_qply(buf: bytes, format: str = "", banded: bool = False, device="cuda"):
    """Parse a quantized-codebook PLY on `device`.

    banded=False: one zero-padded Gaussians at the highest degree present
    in the file. banded=True: a BandedGaussians whose groups keep their
    own SH size (a band-0 splat stores 1 coefficient, not 16)."""
    groups, cb_props, data_start = parse_qheader(buf[: 1024 * 10])
    rows_by_group, offset = [], data_start
    for _bands, count, dtype in groups:
        rows_by_group.append(np.frombuffer(buf, dtype=dtype, count=count, offset=offset))
        offset += dtype.itemsize * count
    nb = len(cb_props)
    cb_raw = np.frombuffer(buf, dtype="<i2", count=256 * nb, offset=offset).reshape(256, nb)
    return decode_qply(groups, rows_by_group, cb_raw, cb_props, format, banded, device)
