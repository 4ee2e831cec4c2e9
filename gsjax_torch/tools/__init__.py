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

builds edited copies of the blend backward (kernels D and F: other
groupings, ablations) and times them at the bonsai 1080p orbit's view 0,
on the card only.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

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


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap-around (jnp's int32 sums
    wrap; torch's int32 sum widens to int64)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)
