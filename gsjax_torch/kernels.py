"""Build, load and count the hand-written CUDA kernels.

The sources under gsjax_torch/csrc/ compile with nvcc, one process per
source and all at once, then link into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). There are two libraries: "path", the serving and training
path's kernels A-F and the projection pair (project.cu), and "probes",
the probes G-J and the empty launch that measures their launch floor
(gsjax_torch.tools, on no path), so that the path's first call never
compiles the probes. Each is built at its first use, into
gsjax_torch/_build/, under a file name that carries a hash of its
sources, headers and flags: an edited source rebuilds its library, an
unchanged one loads the cached file.

`-fmad=false` is load-bearing: the ellipse-cull quadratics of the repeat
and expansion kernels must round exactly as their plain PyTorch versions
do (an FMA-contracted `a·x·x + 2·b·x·y + c·y·y` flips borderline pairs),
and the blend kernels' `fexp` must be the reference polynomial op for op
(the backward kernel remakes the forward's include decisions from it;
its gradient products, where no decision depends on the bits, use
explicit fused multiply-adds).
Never build with --use_fast_math.

LAUNCHES counts, per kernel, the launches its wrapper made; a run zeroes
it with reset_launches() and reads it afterwards to show which kernels
the path went through. A module that keeps records of its own for a run
(gsjax_torch.trace) registers its reset with on_reset(), so a run has
one reset.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# library → its sources, and the headers they include
SOURCES = {"path": ("repeat.cu", "expand.cu", "stream_fwd.cu", "stream_bwd.cu",
                    "slots_fwd.cu", "slots_bwd.cu", "project.cu"),
           "probes": ("probe_mosaic.cu", "probe_compact.cu", "probe_scalars.cu",
                      "probe_chunk.cu", "probe_empty.cu")}
HEADERS = {"path": ("common.cuh", "blend.cuh"), "probes": ("common.cuh", "probe.cuh")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {"repeat": 0, "expand": 0, "stream_fwd": 0, "stream_bwd": 0,
            "stream_class_sum": 0, "slots_fwd": 0, "slots_bwd": 0, "project_fwd": 0,
            "project_bwd": 0, "probe_mosaic": 0,
            "probe_compact": 0, "probe_scalars": 0, "probe_chunk": 0, "probe_empty": 0}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# library → its C entry points: (argtypes); each returns
# cudaGetLastError() as an int
_SIGNATURES = {"path": {
    # src18, fb, fbe, thr, nf, n_copies (i64 on the card), fat_cap,
    # tiles_x, tiles_y, span, ts, tail, keys, stream
    "gsjax_repeat_fat_parents": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                                 _I, _P, _P, _P),
    # home_x, home_y, win, valid, mean2d, mean_stride, conic, conic_stride,
    # thr, dbits, dbits_stride, nh, ty0, band_rows, tiles_x, ts, span,
    # scratch, pid_live, key, stream
    "gsjax_expand_live_pairs": (_P, _P, _P, _P, _P, _L, _P, _L, _P, _P, _L, _I,
                                _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # att, pid, starts, n_tiles, ty0, tiles_x, ts, chunk, k_slots,
    # alpha_clamp, alpha_min, eps_T, out, stream
    "gsjax_stream_forward": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                             _F, _P, _P),
    # att, pid, starts, fwd, ct_img, ct_T, n_tiles, ty0, tiles_x, ts, chunk,
    # k_slots, alpha_clamp, alpha_min, eps_T, dpair, replayed, stream
    "gsjax_stream_backward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _F, _F, _F, _P, _P, _P),
    # dpair, replayed, nh, k_slots, d_home, stream
    "gsjax_stream_class_sum": (_P, _P, _I, _I, _P, _P),
    # att_al, starts, cbase, n_tiles, ty0, tiles_x, ts, chunk, alpha_clamp,
    # alpha_min, eps_T, out, stream
    "gsjax_slots_forward": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P,
                            _P),
    # att_al, starts, cbase, fwd, ct_img, ct_T, n_tiles, ty0, tiles_x, ts,
    # chunk, alpha_clamp, alpha_min, eps_T, datt, stream
    "gsjax_slots_backward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                             _F, _F, _P, _P),
    # means, log_scales, quats, sh, opacity_logits, cam, n, k, near_cull,
    # lowpass, radius_sigma, alpha_min, cx, cy, width, height, home, valid,
    # att, stream
    "gsjax_project_forward": (_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F,
                              _F, _F, _F, _P, _P, _P, _P),
    # means, log_scales, quats, sh, opacity_logits, cam, n, k, near_cull,
    # lowpass, radius_sigma, alpha_min, cx, cy, width, height, then (pointer,
    # row stride) for g_mean2d, g_depth, g_conic, g_rgb, g_opacity, masked,
    # d_means, d_log_scales, d_quats, d_sh, d_opacity_logits, d_cam_part,
    # d_cam, stream
    "gsjax_project_backward": (_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F,
                               _F, _F, _F, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
                               _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # n; returns the floats of the backward's d_cam_part for n rows
    "gsjax_project_cam_scratch": (_L,),
}, "probes": {
    # x, o, s, stream
    "gsjax_probe_mosaic": (_P, _P, _P, _P),
    # mask, vals, nh, classes, block_tot, block_off, out, cap, count, stream
    "gsjax_probe_compact": (_P, _P, _I, _I, _P, _P, _P, _L, _P, _P),
    # variant, stab, rows, g, lanes, out, stream
    "gsjax_probe_scalars": (_I, _P, _P, _I, _I, _P, _P),
    # variant, rows, band, g, out, stream
    "gsjax_probe_chunk": (_I, _P, _P, _I, _P, _P),
    # grid, block, smem, out, stream
    "gsjax_probe_empty": (_I, _I, _I, _P, _P),
}}

_libs: dict = {}


_ON_RESET: list = []


def on_reset(fn) -> None:
    """Have reset_launches() call fn() too."""
    _ON_RESET.append(fn)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for fn in _ON_RESET:
        fn()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def library_path(library: str = "path") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES[library] + HEADERS[library]:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libgsjax_torch_{library}_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> list:
    """Start every nvcc command at once, wait for all, raise on a failure;
    returns each command's standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
            )
        errs.append(err)
    return errs


def compile_library(csrc: str, sources, path: str) -> None:
    """Compile `sources` (files in the directory `csrc`) into the shared
    library `path`: one nvcc per source, all started together, then one
    link, in a scratch directory, so a concurrent or cut build never
    leaves a half-written library under the final name. ptxas's report
    (registers, stack frame, spills per kernel) goes to ptxas_log(path)."""
    build_dir = os.path.dirname(path)
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, f"{src}.o") for src in sources]
        errs = _run_all([[nvcc, *NVCC_FLAGS, "--ptxas-options=-v", "-c", "-o", obj,
                          os.path.join(csrc, src)] for src, obj in zip(sources, objs)])
        so = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
        with open(ptxas_log(path), "w") as fh:
            fh.write("".join(f"== {src}\n{err}" for src, err in zip(sources, errs)))
        os.replace(so, path)


def build(library: str = "path") -> str:
    """Compile the library ("path" or "probes") if its hashed file is
    missing; returns its path."""
    path = library_path(library)
    if not os.path.exists(path):
        compile_library(CSRC, SOURCES[library], path)
    return path


def ptxas_log(path: str) -> str:
    """The file beside a built library that holds ptxas's report."""
    return path[: -len(".so")] + ".ptxas.txt"


def load(path: str, signatures: dict) -> ctypes.CDLL:
    """The shared library at `path`, its entry points {name: argtypes}
    typed (each returns an int)."""
    handle = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


def lib(library: str = "path") -> ctypes.CDLL:
    """The loaded kernel library ("path" or "probes"), built on first use."""
    if library not in _libs:
        _libs[library] = load(build(library), _SIGNATURES[library])
    return _libs[library]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
