"""Hopper counterparts of the repo's four TPU probes (tools/probe_*.py):
micro-benchmarks of the constructs the blend and compaction kernels are
built from, each a hand-written CUDA kernel (gsjax_torch/csrc/probe_*.cu)
with a plain PyTorch version beside it. None of them is on the serving or
training path.

    python -m gsjax_torch.tools.probe_mosaic               # G
    python -m gsjax_torch.tools.probe_compact [--nh N]     # H
    python -m gsjax_torch.tools.probe_scalars              # I
    python -m gsjax_torch.tools.probe_chunk [v1,v2,...]    # J

Each runs on the card by default and prints device times taken between
CUDA events, beside the card's name and power limit; `--device cpu` runs
the plain versions and prints host-clock times, which say nothing of the
card. This module holds what the four share.

    python -m gsjax_torch.tools.blend_bwd_variants         # D, F variants
    python -m gsjax_torch.tools.blend_fwd_variants         # C, E variants
    python -m gsjax_torch.tools.layout_variants            # A, B variants

build edited copies of the blend backward (kernels D and F), the blend
forward (C and E) or the layout kernels (A and B) — other groupings,
ablations — and time them at the bonsai 1080p orbit's view 0, on the
card only;

    python -m gsjax_torch.tools.chunk_variants             # J's layouts, groupings

does the same for kernel J at its own shapes. The four share edit,
build_edited, loaded and ptxas_kernels below.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import os
import re
import subprocess
import time

import torch

from gsjax_torch import kernels

#: the copy budgets of the bonsai 1080p orbit: derive_caps over its 30 views
#: gives them (as the reference autotune did, BENCH_r05.json); the variant
#: tools measure at them, as chip_smoke.py's phases 1-12 do
BONSAI_ORBIT_CAPS = dict(fat_cap=2_342_912, fat_live_cap=1_617_920)

REPLAYS = 10  # graph replays per device timing


def device_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the kernel, the default) or cpu (the plain version)")
    ap.add_argument("--reps", type=int, default=20, help="timed calls per measurement")
    return ap


def open_device(name: str) -> torch.device:
    """The probe's device; on cuda, print the card's name and power limit
    first. Raises SystemExit without a card: there is no silent CPU run."""
    if name == "cpu":
        print("device: cpu (plain PyTorch versions; host-clock times, not device times)")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on the card, or pass --device cpu")
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card_line()}")
    return torch.device("cuda:0")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Mean time of one fn() call. On the card: the device time per call
    of a CUDA graph that holds `reps` calls, replayed between CUDA events
    (a probe kernel takes a few microseconds, less than the host needs to
    launch it from Python, so timing the calls themselves would time the
    host). On the CPU: the host clock over `reps` calls. One warm-up call
    first."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPLAYS):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (REPLAYS * reps)


def time_over_base_ms(fn, base_fn, device: torch.device, reps: int):
    """(time of fn, time of base_fn) as time_ms gives them, base_fn timed
    right before and right after fn and averaged: the difference is the
    cost of fn's work over base's, clear of the drift between
    measurements taken further apart."""
    before = time_ms(base_fn, device, reps)
    ms = time_ms(fn, device, reps)
    return ms, (before + time_ms(base_fn, device, reps)) / 2


def probe_empty(out: torch.Tensor, grid: int, block: int, smem: int = 0) -> torch.Tensor:
    """Launch the empty kernel (csrc/probe_empty.cu): `grid` blocks of
    `block` threads with `smem` bytes of dynamic shared memory each, of
    which only block 0's thread 0 does anything: out[0] = 0 (out: int32
    on the card). A measuring tool with no plain version: a CPU tensor
    raises (there is no fallback)."""
    if out.device.type != "cuda" or out.dtype != torch.int32 or out.numel() < 1:
        raise ValueError(f"probe_empty: expected an int32 tensor on cuda, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    err = kernels.lib("probes").gsjax_probe_empty(grid, block, smem, out.data_ptr(),
                                                  kernels.stream_ptr(out))
    kernels.check(err, "probe_empty")
    kernels.LAUNCHES["probe_empty"] += 1
    return out


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap-around (jnp's int32 sums
    wrap; torch's int32 sum widens to int64)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def edit(name: str, src: str, edits) -> str:
    """`src` with each (regex, replacement, matches expected) of `edits`
    applied in turn; raises ValueError when one matches another number of
    times, so an edited build never silently builds the shipped text."""
    for pattern, repl, want in edits:
        src, n = re.subn(pattern, repl, src)
        if n != want:
            raise ValueError(f"{name}: {pattern!r} matched {n} times, not {want}")
    return src


def build_edited(name: str, edited: dict, copied=()) -> str:
    """The library of an edited copy of gsjax_torch/csrc, built if missing
    under _build/variants/<name>_<hash>: the files in `edited` (file name
    → text) as given, the files named in `copied` as they are in csrc;
    its .cu files are compiled. The hash covers every file's name and text
    and nvcc's flags. Returns the library's path."""
    texts = dict(edited)
    for f in copied:
        with open(os.path.join(kernels.CSRC, f)) as fh:
            texts[f] = fh.read()
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for f in sorted(texts):
        h.update(f.encode() + b"\0" + texts[f].encode())
    d = os.path.join(kernels.BUILD_DIR, "variants", f"{name}_{h.hexdigest()[:12]}")
    path = os.path.join(d, "lib.so")
    if not os.path.exists(path):
        os.makedirs(d, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        kernels.compile_library(d, tuple(f for f in sorted(texts) if f.endswith(".cu")), path)
    return path


@contextlib.contextmanager
def loaded(library: str, path: str, entry_points):
    """Inside, the wrappers of `library` ("path" or "probes") launch
    `entry_points` from the library at `path`; the shipped library is
    restored on the way out."""
    shipped = kernels.lib(library)
    kernels._libs[library] = kernels.load(
        path, {n: kernels._SIGNATURES[library][n] for n in entry_points})
    try:
        yield
    finally:
        kernels._libs[library] = shipped


def ptxas_kernels(path: str) -> list:
    """[(mangled kernel name, dict(registers, stack, spill_stores,
    spill_loads))] in the order of the ptxas report beside the library at
    `path`."""
    with open(kernels.ptxas_log(path)) as fh:
        found = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                           r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                           r"Used (\d+) registers", fh.read(), re.S)
    return [(k, dict(registers=int(r), stack=int(s), spill_stores=int(st),
                     spill_loads=int(ld))) for k, s, st, ld, r in found]
