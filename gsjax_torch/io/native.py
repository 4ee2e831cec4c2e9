"""The native PLY parser: `gsjax_parse_ply` of the repository's
native/loader.cpp, built with the host C++ compiler at first use and
called through ctypes.

The source is read where it is; the library goes into gsjax_torch/_build/
under a name that carries a hash of the source and the flags (as
gsjax_torch/kernels.py does for the CUDA kernels), so an edited source
rebuilds and an unchanged one loads the cached file. A build that fails
raises with the compiler's message; a file layout the parser does not
take (parse_ply_native returns None) goes to the numpy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "loader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
N_OFFSETS = 62  # loader.cpp's field-offset table
# the fields every row needs, in the order of the offset table's head
NEED = ("x", "y", "z", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2",
        "rot_3", "opacity", "f_dc_0", "f_dc_1", "f_dc_2")

_lib = None


def _cxx() -> str:
    cand = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cand:
        raise RuntimeError("no C++ compiler (c++, g++ or $CXX): the native PLY "
                           "parser cannot be built")
    return cand


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgsjax_torch_io_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile native/loader.cpp if its hashed library is missing (in a
    scratch directory, then renamed: a cut build leaves no half-written
    library); returns the library's path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        cmd = [_cxx(), *CXX_FLAGS, "-o", so, SOURCE]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the native PLY parser failed "
                               f"({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(so, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded parser library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        handle.gsjax_parse_ply.restype = ctypes.c_int
        handle.gsjax_parse_ply.argtypes = [
            ctypes.c_char_p,  # buf
            ctypes.c_size_t,  # nbytes
            ctypes.c_size_t,  # data offset
            ctypes.c_int,  # n vertices
            ctypes.c_int,  # row stride, bytes
            ctypes.POINTER(ctypes.c_int),  # field offsets [62]
            ctypes.c_int,  # SH K
            *[ctypes.c_void_p] * 5,  # means, log_scales, quats, sh, opacity out
        ]
        _lib = handle
    return _lib


def parse_ply_native(buf: bytes, use_shs: bool = True):
    """Parse a plain 3DGS PLY with the native library: the dict of numpy
    arrays ply._assemble takes, or None for a layout it does not take
    (a property that is not float32, a missing field, an SH count that
    is no degree)."""
    from gsjax_torch.io.ply import parse_ply_header

    header = parse_ply_header(buf)
    vert = next((e for e in header.elements if e.name == "vertex"), None)
    if vert is None:
        return None
    props, off = {}, 0
    for name, dt in vert.properties:
        if dt != "<f4":
            return None  # the native parser takes all-float rows only
        props[name] = off
        off += 4
    stride = off
    if any(nm not in props for nm in NEED):
        return None
    n_rest = sum(1 for nm in props if nm.startswith("f_rest_"))
    k = 1 + n_rest // 3 if use_shs else 1
    if k not in (1, 4, 9, 16):
        return None

    offsets = (ctypes.c_int * N_OFFSETS)(*([-1] * N_OFFSETS))
    for i, nm in enumerate(NEED):
        offsets[i] = props[nm]
    # loader.cpp's table: rest slot 14 + channel·15 + coeff (channel-major,
    # 15 slots a channel whatever the file's degree)
    per_ch = n_rest // 3
    for c in range(3):
        for j in range(min(per_ch, 15)):
            offsets[14 + c * 15 + j] = props.get(f"f_rest_{c * per_ch + j}", -1)

    n = vert.count
    out = {"means": np.empty((n, 3), np.float32),
           "log_scales": np.empty((n, 3), np.float32),
           "quats": np.empty((n, 4), np.float32),
           "sh": np.zeros((n, k, 3), np.float32),
           "opacity_logits": np.empty((n,), np.float32)}
    rc = lib().gsjax_parse_ply(
        buf, len(buf), header.data_offset, n, stride, offsets, k,
        *(out[f].ctypes.data_as(ctypes.c_void_p)
          for f in ("means", "log_scales", "quats", "sh", "opacity_logits")))
    return out if rc == 0 else None
