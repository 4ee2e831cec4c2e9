#!/usr/bin/env python3
"""Drive gsjax_torch's serving and training paths once on one CUDA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile the ten CUDA kernels from gsjax_torch/csrc: the
               path's library (A-F) and the probes' (G-J and the empty
               launch that measures their launch floor), side by side,
               every nvcc at once, each library's time printed; beside
               them the forward's `baseline` variant (tools/
               blend_fwd_variants: C and E with one pixel per thread, no
               strip cull and no warp stop: the full walk);
  3. scene   — bonsai_like(n=1,200,000, seed=0, sh_degree=0) on cuda:0;
  4. cameras — bench.py's 1080p orbit: 30 views over 30° of azimuth;
  5. config  — chunk 128, fat_cap 2,342,912, fat_live_cap 1,617,920 (the
               copy budgets an autotune pass measured for this orbit;
               autotune is not ported yet), backend stream — and the same
               with backend "pallas", the flat slot-stream path;
  6. kernels — on view 0, each kernel against its plain PyTorch version
               at the path's shapes: repeat (A: the tail table and its 4
               key rows) and expand (B: the live pairs in pid order and
               their sort keys; the plain version is the dense expansion
               and the compaction the kernel replaces) bit-equal, two
               launches of each bit-equal, the path's sorted pairs and
               tile starts equal to the old sort of the dense expansion,
               each one's launch alone timed beside its wrapper; the
               stream blend (C) within 2e-5 at the 99.9th percentile,
               and bit-equal to the baseline variant (rows 0-3 and 5; the
               exit C, row 4, wherever the baseline's is ≥ eps, below eps
               in both elsewhere); times; the forward's work at view 0 as
               the plain replay counts it under the kernel's warp
               rectangles ((warp, pair)s the strip cull keeps, pair-pixels
               evaluated, culled, skipped by the warps' stops) and the
               work the blend needs (live, eligible and included pair-
               pixels: C's and E's bounds count eligible and included);
  6c. kernel E — the flat blend on view 0's slot stream against its plain
               version with C's bounds, bit-equal to the baseline variant
               as C, and against C on the same pairs (max |Δ|, bit-equal
               or not); times, bound, slot counts;
  6b. edges  — small scenes with the cases the bonsai view lacks (empty
               tiles, an image that is no multiple of the tile size,
               counted fat overflow), both backends: the card's kernel
               path against the CPU's plain path, and C or E against the
               baseline variant on the scene's blend inputs as in 6; then
               the fat scene through the flat backend at every span B is
               built for (odd, 1-15), card against CPU, and B there
               bit-equal to its plain version and across two launches;
  7. serve   — zero the launch counters, render views 0-3 through
               render_trajectory, read the counters: A, B (one kernel, its
               live count read once) and C launched once per frame, no
               other kernel; frames finite; every
               overflow counter 0; view 0's mean(img²) = 0.41342 ± 0.1%
               (the reference's black-target loss of this view);
  7b. serve flat — the same through backend "pallas": A, B and E once per
               frame, no other kernel;
  8. timing  — median ms/frame and the per-stage split, both backends;
  9. kernel D — on view 0 at the path's shapes, with the cotangents of a
               real loss (the perturbed scene against the clean scene's
               render), the backward kernel against its plain version:
               per attribute column p99.9 |Δ|/peak ≤ 1e-4 and max ≤ 1e-1
               (each replays its own forward's decisions, and the kernel's
               sequential transmittance product and the plain version's
               cumprod round differently, so a pixel's include set may
               flip near eps), two launches bit-equal; times of both, the
               wrapper's zero of its row marks, blend kernel and class-
               sum kernel apart (the class sum against its plain
               version within 1e-6 of each column's peak, a kernels-line
               entry of its own), and the kernel's work at view 0 as the
               plain replay counts it under the kernel's grouping ((warp,
               pair)s with an included pixel, groups reduced, pair-pixels
               the warps' stops skip) beside the work the VJP needs (the
               eligible live and the included pair-pixels, which set the
               bounds of C, D, E and F);
  9c. kernel F — the flat backward against its plain version with the
               same cotangents and bounds, two launches bit-equal; then
               its gradient after the slot gather's VJP against D's (bit-
               equal or not); times;
  9b. gradients — the small scenes of phase 6b with a background (so
               ct_T ≠ 0), both backends: every field's gradient on the
               card against the CPU's plain path;
 10. train   — gsjax_torch.train on the bonsai 1080p orbit: perturb(g)
               trained toward the port's renders of the clean scene, one
               fwd + bwd + Adam(1e-3) step at each of views 0-3, then 8 at
               view 0; zero the launch counters before, read them after:
               kernels A-D (D's blend and class sum) once per step, E and
               F never; overflow 0,
               gradients finite, parameters changed, view 0's first loss
               within 5% of 0.00031 (bench.py's loss0 for this
               perturbation), the loss at view 0 falling; median ms/step,
               its split (forward, backward, optimizer) and peak device
               memory;
 10b. train flat — the same through backend "pallas", views 0-3 then 4
               steps at view 0: A, B, E and F once per step, C and D never;
 11. probes  — the Hopper counterparts of the TPU probes (gsjax_torch.tools,
               on no path: 0 launches in phases 7-10b), each against its
               plain version at the probe's full shapes, on the probe's
               inputs and random ones: G (mosaic) and I (scalars, 4
               variants, G = 8192) bit-equal; J (chunk, 17 variants, G =
               4096 blocks of one shape) value and checksum under the CPU
               tests' tolerances, also on its edge inputs; H
               (compact, nh = 2,398,208, classes 1, 3, 9) stream and count
               bit-equal; times (I and J also as ns per block over base, J's
               beside each variant's bound per block and its base; a
               J variant at or below base, but for the two whose work is
               nil by design, is flagged as suspect) and H's one boolean
               index. The counters, zeroed before each probe's comparison
               and before its timed run, show its kernel launched once per
               wrapper call and no other kernel. First, the empty launch
               (csrc/probe_empty.cu) is timed at each probe's launch
               shapes and at the least launch (1 × 32): a probe's bound is
               the sum over its launches of the larger of its roofline
               (bytes, operations) and that launch's floor, printed beside
               the floor, the roofline, the floor's part of the bound
               (its limit reads "launch" from a quarter up) and the bound
               and share against the least launch's floor in place of the
               probe's own grid's;
 12. lazy    — gsjax_torch.LazyTrainer on the bonsai 1080p orbit, perturb(g)
               toward g's renders as in phase 10: a resort at views 0-3 (A and
               B once each, C and D never, overflow 0), the lazy render
               after the first against the exact stream render (max |Δ| ≤
               2e-5), 16 lazy steps a view, each under CUDA's sync debug
               mode set to error (no host sync) launching C once and D's
               blend and class sum once, no other kernel; the first step's
               loss the exact path's (phase 10) within 1e-5 and bench.py's
               within 5%, view 0's loss falling, the home-order parameters
               finite, sync() changing the master; median ms per lazy
               step, ms per resort and its parts (fold, plan, extract),
               peak device memory.
Prints the kernels' JSON line (A-J and D's class sum, each with its
time, its plain version's, its bound and its launches: A-F in their
path's training run,
G-J in their probe's timed run in phase 11; a probe's times and bound
are summed over its variants or class counts, one launch of each; its
bound_by is its roofline's limit, and beside it roofline_ms, floor_ms,
floor_part, limit and least_floor_bound_ms), then
the card's name and power limit, then the result line {"ok": true,
"device": {...}} last.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

N_SPLATS = 1_200_000
WIDTH, HEIGHT = 1920, 1080
BLACK_LOSS0 = 0.41342  # mean(img²) of orbit view 0 in the reference
TRAIN_LOSS0 = 0.00031  # bench.py's loss0 for perturb(g) at view 0 (BENCH_r05.json)
SERVE_VIEWS = 4
TRAIN_VIEWS, FIXED_STEPS = 4, 8
LAZY_VIEWS, LAZY_STEPS = 4, 16  # phase 12: a resort at each view, bench.py's steps per view
FLAT_FIXED_STEPS = 4
# the kernels each path launches (LAUNCHES keys) serving, and besides
# those when training
SERVE_KERNELS = {"stream": ("repeat", "expand", "stream_fwd"),
                 "pallas": ("repeat", "expand", "slots_fwd")}
TRAIN_KERNELS = {"stream": ("stream_bwd", "stream_class_sum"), "pallas": ("slots_bwd",)}
# G-J (LAUNCHES keys = kernel-line names), on no path: phase 11 only
PROBE_KERNELS = ("probe_mosaic", "probe_compact", "probe_scalars", "probe_chunk")
# J variants whose work is a zero-trip loop and an untaken branch: their
# cost over base is ~0 by design (their checksums show they ran), so they
# are never flagged as suspect
J_NO_WORK = ("fori0", "when_f")
DEVICE = "cuda:0"

# the card's peaks (H100 SXM data sheet) and the work per unit, counted
# from the kernels' sources: every +, ×, compare, min / max, floor and
# conversion one operation, one pass over the work the data needs
# (recomputation is not work the function needs, nor are the pairs of a
# pixel past its C < eps). A and B are approximate (their bound is the
# bytes, by 10x or more)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_SLOT_A = 90  # block decode, window, home, the four-edge cull, keys
OPS_PER_CANDIDATE_B = 60  # window tests + the four-edge quadratic minimum
# the blends (C, E forward; D, F backward) per pair-pixel: α and the
# transmittance wherever the pixel's C ≥ eps before the pair (live) and
# the pair is eligible there (α ≥ α_min, power ≤ 0: a pair-pixel that is
# not changes nothing, and the forward's strip cull skips most of them),
# the colour or the gradients only where the pair is included
OPS_LIVE_PAIR_PIXEL = 39  # quadratic 9, fexp 20, α 2, tests 2, C 3, …
OPS_INCLUDED_PAIR_PIXEL_C = 6  # w and the rgb sums (E: the same)
OPS_INCLUDED_PAIR_PIXEL_D = 46  # v, U, dα, 9 gradients, 9 sums (F: the same)
ATT_BYTES = 9 * 4  # one pair's attribute row
# the probes G-J (approximate, as A and B: launches and barriers, not this
# work, set their times). G: the substage's 6 ops per element of [8, 2048],
# the loop and the sums. I: per block, by variant, the inputs it needs
# (six scalars or 128 ids) and its integer operations. J: by variant, the
# input bytes it needs (every block reads the same chunk) and its integer
# or fp32 operations per block; the gathers' on this run's ids
# (ops_per_block_j: a test per pair row and round, an add per element of
# a selected row), and a result that every row of acc (banddyn) or of
# scatter3's window repeats counted once. H: per lane and class.
OPS_MOSAIC = 8 * 2048 * 6 + 128 * 4 * 3
BYTES_PER_BLOCK_I = {"base": 0, "smem": 24, "vmem": 24, "reduce": 512}
OPS_PER_BLOCK_I = {"base": 0, "smem": 6, "vmem": 6, "reduce": 128 * 16 + 6}
BYTES_READ_J = {"roll": 1024, "swapaxes": 512, "decode": 512, "onehot3": 512,
                "scatter3": 512, "alpha": 1024, "hs_prod": 65536, "dots": 65536,
                "bwdsums": 65536, "fori0": 4, "when_f": 4, "banddyn": 24576 + 12,
                "gatherreal": 512, "dynread": 44, "flatgather": 552, "maskwalk": 532}
OPS_PER_BLOCK_J = {  # pixel variants: 128 rows × 256 pixels; the gathers: ops_per_block_j
    "base": 0, "roll": 256 * 2, "swapaxes": 128, "decode": 128 * 8,
    "scatter3": 128 * 3 * 5 + 384 * 3, "alpha": 128 * 256 * 26, "hs_prod": 128 * 256 * 4,
    "dots": 128 * 256 * 8, "bwdsums": 128 * 256 * 10, "fori0": 6, "when_f": 6,
    "banddyn": 32 * 384 + 32 * 3, "dynread": 20}
OPS_TEST_J = 5  # a gather's test of a pair row in a round: class, window offset, ands
OPS_PER_LANE_CLASS_H = 4  # test the bit, its ballot, popcounts, the position


RAW_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
# (name, small_scene kwargs, RenderConfig kwargs, (width, height)): a
# typical scene, fat splats on an image that is no multiple of the tile
# size, a sparse scene with empty tiles, and fat budgets that overflow
EDGE_CASES = (
    ("thin", dict(n=400, spread=1.3, z_range=(3.0, 9.0)), {}, (96, 64)),
    ("fat", dict(n=200, spread=1.0, z_range=(2.0, 6.0), log_scale_boost=2.0),
     dict(fat_max_blocks=64, fat_cap=2048), (100, 70)),
    ("sparse", dict(n=12, spread=1.0, z_range=(4.0, 8.0)), {}, (96, 64)),
    ("overflow", dict(n=64, spread=0.8, z_range=(2.0, 5.0), log_scale_boost=2.5),
     dict(fat_max_blocks=4, fat_cap=8, fat_live_cap=8), (96, 64)),
)


def small_scene(rng, n, spread, z_range, log_scale_boost=0.0):
    """A random scene in front of a camera at the origin looking down +z
    (the CPU tests' make_random_scene, on the CPU, SH degree 1)."""
    import numpy as np

    from gsjax_torch import Gaussians

    means = np.stack([rng.uniform(-spread, spread, n),
                      rng.uniform(-spread, spread, n),
                      rng.uniform(*z_range, n)], axis=-1)
    scales = rng.uniform(0.02, 0.12, (n, 3)) * np.exp(log_scale_boost)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, 4, 3)) * 0.3
    sh[:, 0, :] = rng.uniform(-0.5, 1.5, (n, 3))
    return Gaussians.from_activated(means=means, scales=scales, quats=quats,
                                    opacities=rng.uniform(0.3, 0.95, n), sh=sh,
                                    device="cpu")


def ops_per_block_j(variant: str, rows) -> int:
    """The operations per block J's variant needs on `rows`: a gather's
    window test of each pair row in each round, and an add for each of the
    32 elements of each row a round selects (probe_chunk.gather_
    selections); the others' OPS_PER_BLOCK_J."""
    from gsjax_torch.tools import probe_chunk as pj

    if variant in pj.GATHERS:
        rounds, selected = pj.gather_selections(variant, rows)
        return rounds * pj.CHUNK * OPS_TEST_J + selected * 32
    return OPS_PER_BLOCK_J[variant]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(n_bytes: float, n_ops: float, floor_ms: float = 0.0):
    """(bound_ms, limit): the least time for the work on the card, the
    larger of bytes over the memory rate and operations over the fp32
    rate, and of floor_ms, the empty launch's time at the work's launch
    shape (limit "launch" where that floor wins)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    if floor_ms > max(t_bytes, t_ops):
        return floor_ms, "launch"
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def probe_bound(launches, least_ms: float) -> dict:
    """A probe's bound over its launches [(bytes, operations, floor_ms)]:
    bound_ms, the sum of each launch's bound with its own floor;
    roofline_ms and bound_by, the same sum without the floors and the
    limit (bytes or operations) that holds the most of it; floor_ms, the
    floors' sum; floor_part, the share of bound_ms held by the launches
    whose floor wins; limit, "launch" where that share is a quarter or
    more, else bound_by; least_floor_bound_ms, the bound with the least
    launch's floor least_ms in place of each launch's own."""
    parts = [bound(*launch) for launch in launches]
    roof = [bound(b, o) for b, o, _ in launches]
    by = {}
    for t, limit in roof:
        by[limit] = by.get(limit, 0.0) + t
    bound_ms = sum(t for t, _ in parts)
    floor_part = sum(t for t, limit in parts if limit == "launch") / bound_ms
    bound_by = max(by, key=by.get)
    return dict(bound_ms=bound_ms, bound_by=bound_by, roofline_ms=sum(by.values()),
                floor_ms=sum(f for _, _, f in launches), floor_part=floor_part,
                limit="launch" if floor_part >= 0.25 else bound_by,
                least_floor_bound_ms=sum(bound(b, o, least_ms)[0] for b, o, _ in launches))


def needed_ops(work, ops_included: int, counted: str = "pair_pixels_eligible") -> int:
    """The operations a blend needs on this data, from the plain replay's
    counts (stream.blend_backward_plain's stats): OPS_LIVE_PAIR_PIXEL per
    eligible live pair-pixel (counted="pair_pixels_live": per live one,
    the earlier count), ops_included per included one."""
    return (OPS_LIVE_PAIR_PIXEL * work[counted]
            + ops_included * work["pair_pixels_included"])


def fwd_work_line(work) -> str:
    """The forward's work from the plain replay's counts: (warp, pair)s
    the strip cull keeps, pair-pixels evaluated, culled and stopped, and
    the pair-pixels the blend needs."""
    pp = max(1, work["pair_pixels"])
    return (f"(warp, pair)s the strip cull keeps {work['fwd_warp_pairs_kept']} of "
            f"{work['fwd_warp_pairs']} "
            f"({work['fwd_warp_pairs_kept'] / max(1, work['fwd_warp_pairs']):.3f}); of "
            f"{work['pair_pixels']} pair-pixels in the chunks run, evaluated "
            f"{work['fwd_pair_pixels_evaluated']} ({work['fwd_pair_pixels_evaluated'] / pp:.3f}), "
            f"culled {work['fwd_pair_pixels_culled']} "
            f"({work['fwd_pair_pixels_culled'] / pp:.3f}), skipped by the warps' stops "
            f"{work['fwd_pair_pixels_stopped']} ({work['fwd_pair_pixels_stopped'] / pp:.3f}); "
            f"live {work['pair_pixels_live']}, eligible {work['pair_pixels_eligible']}, "
            f"included {work['pair_pixels_included']}; eligible live pair-pixels the "
            f"forward would skip {work['fwd_eligible_skipped']}")


def check_baseline(what: str, base_path: str, fn, args, eps: float) -> str:
    """fn(*args), a forward wrapper (C's or E's), against the same call
    through the baseline variant's library: fail unless
    blend_fwd_variants.matches_baseline; returns what it found."""
    from gsjax_torch.tools import blend_fwd_variants

    out = fn(*args)
    with blend_fwd_variants.loaded(base_path):
        base = fn(*args)
    ok, detail = blend_fwd_variants.matches_baseline(out, base, eps)
    check(ok, f"{what}: differs from the baseline variant: {detail}")
    return detail


def replayed_pair_pixels(out, starts, cfg) -> int:
    """Pair-pixels of the chunks the blend ran (and the backward replays):
    Σ_tiles ts² · min(pairs, n_done · chunk)."""
    import torch

    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    n_done = out[:, 5, 0].to(torch.int64)
    return int(torch.minimum(counts, n_done * cfg.chunk).sum()) * cfg.tile_size ** 2


def blend_diff(out_k, out_p):
    """A blend kernel's output against its plain version's: (max |Δ| and
    p99.9 |Δ| over img and T_act, the tiles whose n_done differs, max |Δ|
    of the exit C)."""
    import torch

    d = (out_k[:, 0:4] - out_p[:, 0:4]).abs()
    p999 = float(torch.quantile(d.flatten()[:: max(1, d.numel() // 8_000_000)], 0.999))
    return (float(d.max()), p999, int((out_k[:, 5, 0] != out_p[:, 5, 0]).sum()),
            float((out_k[:, 4] - out_p[:, 4]).abs().max()))


GRAD_COLS = ("mx", "my", "ca", "cb", "cc", "r", "g", "b", "op")


def grad_diff(dk, dp):
    """A gradient [rows, 9] against its reference, over the rows some
    replayed pair reached (the rest are 0 in both): (per column p99.9
    |Δ|/peak, per column max |Δ|/peak, max |Δ|, rows)."""
    import torch

    diff = (dk - dp).abs()
    peak = dp.abs().amax(dim=0).clamp(min=1e-30)
    rel = (diff / peak)[(dp != 0).any(dim=1) | (dk != 0).any(dim=1)]
    p999 = torch.stack([torch.quantile(rel[:, c], 0.999) for c in range(9)])
    return p999, rel.amax(dim=0), float(diff.max()), rel.shape[0]


def fmt_cols(x) -> dict:
    return dict(zip(GRAD_COLS, [f"{v:.2e}" for v in x.tolist()]))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` calls, after one warm-up call,
    between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def check_launches(launches, backend: str, n: int, train: bool) -> None:
    """Every kernel of the backend's path (its forward ones when serving)
    launched n times, every other kernel never."""
    what = "training steps" if train else "frames"
    for name, count in launches.items():
        on_path = name in SERVE_KERNELS[backend] or (train and name in TRAIN_KERNELS[backend])
        want = n if on_path else 0
        check(count == want, f"{backend}: kernel {name} launched {count} times over "
              f"{n} {what} (want {want})")


def staged_render(g, cam, cfg):
    """pipeline.render, one stage at a time with a synchronize after
    each: (img, overflow and pair counters, {stage: ms}, (p, ph, layout,
    bins)). The flat backend's slot gather is a stage of its own."""
    import torch

    from gsjax_torch.render import flat
    from gsjax_torch.render.binning import build_tile_bins
    from gsjax_torch.render.composite import (assemble_band, att_table,
                                              clipped_pair_stream)
    from gsjax_torch.render.homesort import build_home_layout
    from gsjax_torch.render.project import project
    from gsjax_torch.render.stream import composite_tiles_stream

    ms = {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    p = project(g, cam, cfg)
    lap("project")
    ph, layout = build_home_layout(p, cam, cfg)
    lap("home_layout")
    bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    lap("bins_sort")
    if cfg.backend == "stream":
        img, aux = composite_tiles_stream(ph, layout, bins, cam, cfg)
    else:
        pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
        att_al, tile_of, cbase = flat.chunked_pair_attrs(
            att_table(ph), pid, starts, cfg, cfg.tile_span ** 2)
        lap("slot_gather")
        img_t, T_t = flat.blend_slots(att_al, starts, cbase, tile_of, bins.ty0,
                                      bins.tiles_x, bins.band_rows, cfg)
        img, _ = assemble_band(img_t, T_t, bins, cfg)
        aux = {"n_pairs": bins.n_pairs, "n_pair_overflow": n_dropped,
               "n_fat_overflow": layout.n_fat_overflow}
    lap("blend")
    return img[: cam.height, : cam.width], aux, ms, (p, ph, layout, bins)


def train_phase(g, g_train, cams, cfg, order, card) -> dict:
    """Train g_train toward g's renders of `cams` through the user's
    entry points (gsjax_torch.train.make_step_fn), one step per view in
    `order`, with the launch counters zeroed before and read after; check
    the launches (the backend's kernels once per step, no other kernel),
    overflow, gradients, parameters and losses; then time the step's
    split on three more steps at view 0. Returns the run's numbers."""
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch import train as gtrain

    backend = cfg.backend
    with torch.no_grad():
        targets = [gt.render(g, c, cfg) for c in cams]
        for v, c in enumerate(cams):
            aux = gt.render(g_train, c, cfg, return_aux=True)[1]
            ovf = {k: int(aux[k]) for k in aux if k.endswith("overflow")}
            check(all(x == 0 for x in ovf.values()),
                  f"train view {v} ({backend}): overflow {ovf}")
    params0 = {n: t.detach().clone() for n, t in g_train.named_parameters()}
    opt = torch.optim.Adam(g_train.parameters(), lr=1e-3)  # bench.py: optax.adam(1e-3)
    steps = [gtrain.make_step_fn(c, cfg, opt) for c in cams]
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for v in order:
        t0 = time.perf_counter()
        loss = steps[v](g_train, targets[v])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"# train ({backend}): {len(order)} steps (views {order}); launches "
          f"{launches}; losses {[f'{x:.6f}' for x in losses]}")
    check_launches(launches, backend, len(order), train=True)
    for n_, t in g_train.named_parameters():
        check(t.grad is not None and bool(torch.isfinite(t.grad).all()),
              f"train ({backend}): gradient of {n_} missing or non-finite")
        check(not torch.equal(t.detach(), params0[n_]),
              f"train ({backend}): {n_} did not change")
    rel0 = abs(losses[0] - TRAIN_LOSS0) / TRAIN_LOSS0
    print(f"# train ({backend}): view 0's first loss {losses[0]:.7f} (bench.py's "
          f"{TRAIN_LOSS0}, rel diff {rel0:.2e}); after the fixed steps {losses[-1]:.7f}")
    check(rel0 <= 0.05, f"train ({backend}): view 0's first loss {losses[0]} not "
          f"within 5% of {TRAIN_LOSS0}")
    check(losses[-1] < losses[0], f"train ({backend}): view 0's loss did not fall "
          f"({losses[0]} -> {losses[-1]})")

    # the step's split, on three more steps at view 0
    split_ms = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((gt.render(g_train, cams[0], cfg) - targets[0]) ** 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, (a, b) in zip(split_ms, ((t0, t1), (t1, t2), (t2, t3))):
            split_ms[k].append((b - a) * 1e3)
    split_t = {k: round(statistics.median(x), 3) for k, x in split_ms.items()}
    print(f"# train timing ({backend}) on {card}: median "
          f"{statistics.median(step_ms):.3f} ms per fwd + bwd + Adam step over "
          f"{len(step_ms)} steps (host clock, synchronize on both sides; all "
          f"{[round(x, 2) for x in step_ms]}); split (median of 3 staged steps, "
          f"ms) {split_t}; peak device memory {peak_gb:.2f} GiB")
    return dict(launches=launches, losses=losses, step_ms=step_ms,
                split_ms=split_ms, peak_gib=peak_gb)


def nonzero(launches: dict) -> dict:
    return {k: c for k, c in launches.items() if c}


def lazy_phase(g, cams, cfg, dev, card, exact) -> dict:
    """12. Lazy frame plans through gsjax_torch.LazyTrainer on the bonsai
    1080p orbit: perturb(g) trained toward g's renders of views
    0-(LAZY_VIEWS-1), a resort at each view, then LAZY_STEPS lazy steps.
    The resort at view 0 launches A and B once each and C and D never,
    with every overflow counter 0; a lazy render right after it is held
    to the exact stream render of the same parameters (max |Δ| ≤ 2e-5,
    tests/test_lazy.py:64-78's bound); the first lazy step's loss to the
    exact path's first loss at view 0 (`exact`: phase 10's run) within
    1e-5 relative and to bench.py's loss0 within 5%. Each lazy step runs
    with CUDA's sync debug mode set to error (a step that waits for the
    card fails) and launches C once and D (its blend and class sum) once,
    no other kernel (the counters, zeroed after each resort, read after
    the view's steps). The loss at view 0 falls, the home-order parameters
    stay finite, sync() changes the master. Returns the run's numbers:
    the ms of each lazy step (synchronised), of each resort and its parts
    (fold, plan, extract), peak device memory."""
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.run import perturb
    from gsjax_torch.render.composite import att_table
    from gsjax_torch.render.homesort import build_home_layout
    from gsjax_torch.render.lazy import lazy_cols
    from gsjax_torch.render.project import project

    cams_l = [c.to(dev) for c in cams[:LAZY_VIEWS]]
    with torch.no_grad():
        targets = [gt.render(g, c, cfg) for c in cams_l]
    g_train = perturb(g)
    tr = gt.LazyTrainer(g_train, cfg, torch.optim.Adam(g_train.parameters(), lr=1e-3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resorts = []

    def resort(cam):
        parts, t = {}, [time.perf_counter()]

        def lap(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            parts[name] = (now - t[0]) * 1e3
            t[0] = now

        kernels.reset_launches()
        plan = tr.resort(cam, lap)
        resorts.append(parts)
        return plan, dict(kernels.LAUNCHES)

    plan, launched = resort(cams_l[0])
    want = {k: int(k in ("repeat", "expand")) for k in launched}
    check(launched == want, f"lazy: the resort launched {launched} (want A and B once)")
    ovf = {k: int(v) for k, v in plan.ovf.items()}
    check(all(v == 0 for k, v in ovf.items() if k != "n_pairs"),
          f"lazy: the resort at view 0 overflowed {ovf}")
    with torch.no_grad():
        img_l = gt.lazy_render(tr.hp, cams_l[0], cfg, plan)
        img_e = gt.render(g_train, cams_l[0], cfg)
        d = (img_l - img_e).abs()
        d_max = float(d.max())
        d_p999 = float(torch.quantile(d.flatten()[:: max(1, d.numel() // 8_000_000)], 0.999))
        if d_max > 2e-5:  # find the rows: the lazy attributes against the exact home table
            ph, _ = build_home_layout(project(g_train, cams_l[0], cfg), cams_l[0], cfg)
            rows = torch.nonzero((lazy_cols(tr.hp, cams_l[0], cfg) != att_table(ph))
                                 .any(dim=1) & ph.valid).squeeze(1)
            print(f"# lazy: render differs from the exact one: p99.9 {d_p999:.3e} max "
                  f"{d_max:.3e}; {rows.numel()} live home rows whose attributes differ "
                  f"from the exact path's (first: {rows[:8].tolist()})")
        check(d_max <= 2e-5, f"lazy: the render after the resort differs from the exact "
              f"stream render by {d_max} > 2e-5 (p99.9 {d_p999})")
    print(f"# lazy: resort at view 0 on {card}: {plan.nh} home rows, "
          f"{int(plan.ovf['n_pairs'])} pairs, launches {nonzero(launched)}, overflow {ovf}; lazy "
          f"render against the exact stream render max |Δ| {d_max:.3e}, p99.9 "
          f"{d_p999:.3e}{', bit-equal' if torch.equal(img_l, img_e) else ''}")
    del img_l, img_e, d

    master0 = {n: t.detach().clone() for n, t in g_train.named_parameters()}
    step_ms, losses = [], []
    for v, cam in enumerate(cams_l):
        if v:
            plan, launched = resort(cam)
            ovf = {k: int(x) for k, x in plan.ovf.items() if k != "n_pairs"}
            check(launched == want and not any(ovf.values()),
                  f"lazy: the resort at view {v} launched {launched}, overflow {ovf}")
        kernels.reset_launches()
        losses.append([])
        for _ in range(LAZY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                loss = tr.step(targets[v], cam)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses[-1].append(float(loss))
        launched = dict(kernels.LAUNCHES)
        want_step = {k: LAZY_STEPS * int(k in ("stream_fwd", "stream_bwd", "stream_class_sum"))
                     for k in launched}
        check(launched == want_step, f"lazy: {LAZY_STEPS} steps at view {v} launched "
              f"{launched} (want C and D's two kernels once a step, nothing else)")
    for n_, t in tr.hp.named_parameters():
        check(bool(torch.isfinite(t).all()), f"lazy: home-order {n_} not finite")
    l0 = losses[0]
    rel_exact = abs(l0[0] - exact["losses"][0]) / exact["losses"][0]
    rel_bench = abs(l0[0] - TRAIN_LOSS0) / TRAIN_LOSS0
    print(f"# lazy: views 0-{LAZY_VIEWS - 1}, a resort and {LAZY_STEPS} steps each, "
          f"launches per view {nonzero(launched)}, no host sync in a step; view 0's losses "
          f"{l0[0]:.7f} -> {l0[-1]:.7f} (the exact path's first loss {exact['losses'][0]:.7f}, "
          f"rel diff {rel_exact:.2e}; bench.py's {TRAIN_LOSS0}, rel diff {rel_bench:.2e}); "
          f"last loss of each view {[f'{x[-1]:.7f}' for x in losses]}")
    check(rel_exact <= 1e-5, f"lazy: the first step's loss {l0[0]} is not the exact "
          f"path's {exact['losses'][0]} within 1e-5")
    check(rel_bench <= 0.05, f"lazy: the first step's loss {l0[0]} not within 5% of "
          f"{TRAIN_LOSS0}")
    check(l0[-1] < l0[0], f"lazy: view 0's loss did not fall ({l0[0]} -> {l0[-1]})")
    t0 = time.perf_counter()
    tr.sync()
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    moved = [n_ for n_, t in g_train.named_parameters() if not torch.equal(t, master0[n_])]
    check(len(moved) == len(master0), f"lazy: sync() changed only {moved}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    med = lambda k, rs=resorts[1:]: round(statistics.median(r[k] for r in rs), 3)
    print(f"# lazy timing on {card}: median {statistics.median(step_ms):.3f} ms per lazy "
          f"step over {len(step_ms)} (synchronised; all {[round(x, 2) for x in step_ms]}); "
          f"the exact step (phase 10) median {statistics.median(exact['step_ms']):.3f}; "
          f"resort at views 1-{LAZY_VIEWS - 1} median "
          f"{med('fold') + med('plan') + med('extract'):.3f} ms (fold {med('fold')}, plan "
          f"{med('plan')}, extract {med('extract')}; each "
          f"{[{k: round(x, 2) for k, x in r.items()} for r in resorts]}); the last sync "
          f"(fold) {sync_ms:.3f} ms; peak device memory {peak_gib:.2f} GiB")
    return dict(step_ms=step_ms, losses=losses, resort_ms=resorts, sync_ms=sync_ms,
                peak_gib=peak_gib)


class Counted:
    """A probe's wrapper that counts its calls since start(), which zeroes
    the launch counters; check() holds the kernel's counter to those calls
    (one launch per call, no other kernel launched) and returns it."""

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn
        self.start()

    def __call__(self, *args):
        self.n += 1
        return self.fn(*args)

    def start(self) -> None:
        from gsjax_torch import kernels

        kernels.reset_launches()
        self.n = 0

    def check(self) -> int:
        from gsjax_torch import kernels

        launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
        check(self.n > 0 and launched == {self.name: self.n},
              f"probe {self.name}: launches {launched} for {self.n} wrapper calls "
              f"(want one launch per call and no other kernel)")
        return self.n


def probes_phase(dev, card) -> tuple[list, dict]:
    """11. The probes G-J (gsjax_torch.tools), each kernel against its
    plain version at the probe's full shapes (and random inputs beside
    the probe's own), then the probe's run: timed as its tool times it, a
    kernel by the device time per launch in a CUDA graph of launches
    (gsjax_torch.tools.time_ms: a launch from Python takes longer than
    these kernels run), its plain version and H's boolean index between
    CUDA events around the calls (they sync with the host). The launch
    counters are zeroed before each probe's comparison and before its run
    and read after each: its kernel launched once per wrapper call and no
    other kernel launched. Returns their kernel-line entries (ms, plain_ms,
    library_ms and bound summed over the probe's variants or class counts:
    one launch of each; launches: the run's) and the per-variant numbers."""
    import numpy as np
    import torch

    from gsjax_torch.tools import probe_chunk as pj
    from gsjax_torch.tools import probe_compact as ph
    from gsjax_torch.tools import probe_mosaic as pg
    from gsjax_torch.tools import probe_scalars as pi
    from gsjax_torch.tools import probe_empty
    from gsjax_torch.tools import time_ms as device_ms
    from gsjax_torch.tools import time_over_base_ms

    results, detail = [], {}
    rng = np.random.default_rng(21)

    # the empty launch at each probe's launch shapes (grid, block, dynamic
    # shared memory): G one block of 1024 threads with its 64 KB stage; I
    # and J their grids of 128-thread blocks (J two pixels a thread); H
    # its count and write passes' blocks of 1024 lanes and its one-block
    # scan; and the least launch, one warp
    nh_h = 2_400_000 // ph.R * ph.R
    shapes = {"G": (1, 1024, 4 * pg.ROWS * pg.CAP), "I": (pi.G, pi.CHUNK, 0),
              "J": (pj.G, pj.N_PX // 2, 0), "H": (-(-nh_h // ph.BLOCK_LANES), ph.BLOCK_LANES, 0),
              "H scan": (1, ph.BLOCK_LANES, 0), "least": (1, 32, 0)}
    empty = Counted("probe_empty", probe_empty)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    floor = {k: device_ms(lambda: empty(flag, *shape), dev, 50) for k, shape in shapes.items()}
    empty.check()
    check(int(flag[0]) == 0, "the empty launch did not write its flag")
    detail["launch_floor_ms"] = floor
    print(f"# launch floors on {card} (the empty launch, device ms per launch in a CUDA "
          "graph; grid x block + dynamic shared memory): "
          + ", ".join(f"{k} {g}x{b}{f' + {m // 1024} KB' if m else ''} {floor[k]:.5f}"
                      for k, (g, b, m) in shapes.items()))

    # G: bit-equal on a random input with negative ints and on the probe's
    # (last: its s is printed)
    mosaic = Counted("probe_mosaic", pg.probe_mosaic)
    xs = [torch.from_numpy(rng.integers(-2**31, 2**31, (8, pg.CAP), dtype=np.int64)
                           .astype(np.int32)).to(dev), pg.probe_input(dev)]
    for x in xs:
        (o, s), (op, sp) = mosaic(x), pg.probe_mosaic_plain(x)
        check(torch.equal(o, op) and torch.equal(s, sp),
              f"probe G differs from its plain version: {(o - op).abs().max()}, {s} {sp}")
    mosaic.check()
    mosaic.start()
    ms_g = device_ms(lambda: mosaic(x), dev, 100)
    results.append(probe_line(
        "probe_mosaic", "tools/probe_mosaic.py:25", mosaic.check(), 0.0, ms_g,
        cuda_ms(lambda: pg.probe_mosaic_plain(x), 5), None,
        [(nbytes(x, o, s), OPS_MOSAIC, floor["G"])], floor["least"], card))
    print(f"# G probe_mosaic: o and s bit-equal on the probe's input and a random "
          f"one; s = {int(s[0])}; {ms_g:.4f} ms per launch")

    # I: out bit-equal for every variant; ns per block over base
    scalars = Counted("probe_scalars", pi.probe_scalars)
    g_i = pi.G
    stab, rows = pi.probe_inputs(g_i, dev)
    stab_r = torch.from_numpy(rng.integers(-2**31, 2**31, 6 * g_i, dtype=np.int64)
                              .astype(np.int32)).to(dev)
    rows_r = torch.from_numpy(rng.integers(-300, 300, (g_i, pi.LANES)).astype(np.int32)).to(dev)
    for v in pi.VARIANTS:
        for st, rw in ((stab, rows), (stab_r, rows_r)):
            check(torch.equal(scalars(v, st, rw), pi.probe_scalars_plain(v, st, rw)),
                  f"probe I ({v}) differs from its plain version")
    scalars.check()
    scalars.start()
    ms_i, plain_i, over_i, launches_i = {}, {}, {}, []
    for v in pi.VARIANTS:
        ms_i[v], base_ms = time_over_base_ms(lambda: scalars(v, stab, rows),
                                             lambda: scalars("base", stab, rows), dev, 50)
        over_i[v] = (ms_i[v] - base_ms) / g_i * 1e6
        plain_i[v] = cuda_ms(lambda: pi.probe_scalars_plain(v, stab, rows), 5)
        launches_i.append(((BYTES_PER_BLOCK_I[v] + 4) * g_i, OPS_PER_BLOCK_I[v] * g_i,
                           floor["I"]))
    results.append(probe_line(
        "probe_scalars", "tools/probe_scalars.py:33", scalars.check(), 0.0,
        sum(ms_i.values()), sum(plain_i.values()), None, launches_i, floor["least"], card))
    detail["probe_scalars"] = dict(ms=ms_i, plain_ms=plain_i, ns_per_block_over_base=over_i)
    print(f"# I probe_scalars on {card}: out bit-equal (4 variants, probe and random "
          f"inputs); G = {g_i} blocks, ms {_fmt(ms_i)}; ns per block over base (timed "
          f"beside it) {_fmt(over_i, 2)}")

    # J: value and checksum under the tests' tolerances on the probe's, the
    # random and the edge inputs; ns per block over base beside each
    # variant's bound per block
    chunk = Counted("probe_chunk", pj.probe_chunk)
    g_j = pj.G
    inputs = [pj.probe_inputs(dev), pj.random_inputs(dev), *pj.edge_inputs(dev)]
    err_j = 0.0
    for v in pj.VARIANTS:
        for rw, bd in inputs:
            k, p = chunk(v, rw, bd), pj.probe_chunk_plain(v, rw, bd)
            same = torch.equal(k, p) if v == "base" else torch.equal(k, k[:1].expand_as(k))
            check(same and pj.agree(v, k[-1], p[-1]),
                  f"probe J ({v}) differs from its plain version: {k[-1].tolist()} "
                  f"against {p[-1].tolist()}")
            err_j = max(err_j, float((k[-1] - p[-1]).abs().max()))
    chunk.check()
    chunk.start()
    ms_j, plain_j, over_j, base_j, bound_j, launches_j = {}, {}, {}, {}, {}, []
    for v in pj.VARIANTS:
        ms_j[v], base_j[v] = time_over_base_ms(lambda: chunk(v, *inputs[0]),
                                               lambda: chunk("base", *inputs[0]), dev, 50)
        over_j[v] = (ms_j[v] - base_j[v]) / g_j * 1e6
        plain_j[v] = cuda_ms(lambda: pj.probe_chunk_plain(v, *inputs[0]), 3)
        ops = ops_per_block_j(v, inputs[0][0]) * g_j
        launches_j.append((BYTES_READ_J.get(v, 0) + 8 * g_j, ops, floor["J"]))
        bound_j[v] = bound(BYTES_READ_J.get(v, 0) + 8 * g_j, ops)[0] / g_j * 1e6
    results.append(probe_line(
        "probe_chunk", "tools/probe_chunk.py:35", chunk.check(), err_j,
        sum(ms_j.values()), sum(plain_j.values()), None, launches_j, floor["least"], card))
    suspect = [v for v in pj.VARIANTS[1:] if v not in J_NO_WORK and over_j[v] <= 0]
    base_ms = statistics.mean(base_j.values())
    detail["probe_chunk"] = dict(ms=ms_j, plain_ms=plain_j, ns_per_block_over_base=over_j,
                                 bound_ns_per_block=bound_j, base_ms=base_ms, suspect=suspect)
    print(f"# J probe_chunk on {card}: 17 variants agree with their plain versions "
          f"(probe, random and both edge inputs, max |Δ| {err_j:.3e}); G = {g_j} blocks of "
          f"one shape, its base {base_ms:.4f} ms (mean of the {len(base_j)} timings "
          f"beside the variants, {min(base_j.values()):.4f}-{max(base_j.values()):.4f}); "
          f"ms {_fmt(ms_j)}")
    print(f"# J ns per block over base (timed beside it) / bound per block on {card}: "
          + ", ".join(f"{v} {over_j[v]:.2f} / {bound_j[v]:.2f}" for v in pj.VARIANTS[1:]))
    for v in suspect:
        print(f"# J SUSPECT: variant {v} takes {over_j[v]:.2f} ns per block over base "
              f"(at or below 0: was its work eliminated?)")

    # H: stream and count bit-equal for classes 1, 3, 9, on the probe's
    # input (vals = 1) and on random masks and values (the order shows)
    compact = Counted("probe_compact", ph.probe_compact)
    mask, vals = ph.probe_inputs(2_400_000, dev)
    nh = mask.numel()
    mask_r = torch.from_numpy(rng.integers(-2**31, 2**31, nh, dtype=np.int64)
                              .astype(np.int32)).to(dev)
    vals_r = torch.from_numpy(rng.normal(size=(8, nh)).astype(np.float32)).to(dev)
    counts = {}
    for c in ph.CLASSES:
        for m, vl in ((mask_r, vals_r), (mask, vals)):  # the probe's last: its count
            (sk, ck), (sp, cp) = compact(m, vl, c), ph.probe_compact_plain(m, vl, c)
            n = int(cp[0])
            check(torch.equal(ck, cp) and torch.equal(sk[:, :n], sp[:, :n]),
                  f"probe H (classes {c}) differs from its plain version: count "
                  f"{int(ck[0])} against {n}")
            del sk, sp
        counts[c] = n
    compact.check()
    compact.start()
    ms_h, plain_h, lib_h, launches_h = {}, {}, {}, []
    for c in ph.CLASSES:
        ms_h[c] = device_ms(lambda: compact(mask, vals, c), dev, 10)
        plain_h[c] = cuda_ms(lambda: ph.probe_compact_plain(mask, vals, c), 3)
        lib_h[c] = cuda_ms(lambda: ph.compact_index(mask, vals, c), 3)
        # a call's three launches: the count pass reads the mask, the scan
        # writes the count, the write pass reads the values and writes the
        # entries
        launches_h += [(4 * nh, 0, floor["H"]), (4, 0, floor["H scan"]),
                       (32 * nh + 32 * counts[c], OPS_PER_LANE_CLASS_H * nh * c, floor["H"])]
    results.append(probe_line(
        "probe_compact", "tools/probe_compact.py:59", compact.check(), 0.0,
        sum(ms_h.values()), sum(plain_h.values()), sum(lib_h.values()), launches_h,
        floor["least"], card))
    detail["probe_compact"] = dict(nh=nh, counts=counts, ms=ms_h, plain_ms=plain_h,
                                   library_ms=lib_h)
    print(f"# H probe_compact on {card}: stream and count bit-equal (classes 1, 3, 9; "
          f"the probe's input and random masks and values) at nh = {nh}; entries "
          f"{counts}; ms {_fmt(ms_h)}; ns per slot "
          f"{_fmt({c: ms_h[c] * 1e6 / (nh * c) for c in ph.CLASSES})}; plain "
          f"{_fmt(plain_h)}; one boolean index {_fmt(lib_h)}")
    detail["launches"] = {r["name"]: r["launches"] for r in results}
    return results, detail


def probe_line(name: str, replaces: str, launches: int, err: float, ms: float,
               plain_ms: float, library_ms, probe_launches, least_ms: float,
               card: str) -> dict:
    """A probe's kernels-line entry: its bound summed over its launches
    [(bytes, operations, floor_ms)] with each launch's floor (probe_bound),
    the roofline part beside it; prints the floor, the roofline, the bound
    and the share of it the probe's time reaches, against its own grid's
    floor and against the least launch's (least_ms a launch)."""
    b = probe_bound(probe_launches, least_ms)
    print(f"# {name} on {card}: {ms:.5f} ms over {len(probe_launches)} launches; launch "
          f"floor {b['floor_ms']:.5f} ms, roofline {b['roofline_ms']:.5f} ms ({b['bound_by']}),"
          f" bound {b['bound_ms']:.5f} ms ({b['limit']}; the floor holds "
          f"{b['floor_part']:.3f} of it): {b['bound_ms'] / ms:.3f} of it; with the least "
          f"launch's floor ({least_ms:.5f} ms) in place of its own grid's: bound "
          f"{b['least_floor_bound_ms']:.5f} ms, {b['least_floor_bound_ms'] / ms:.3f} of it")
    return dict(name=name, route="cuda", source=f"gsjax_torch/csrc/{name}.cu",
                replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, **b)


def _fmt(d: dict, digits: int = 4) -> dict:
    return {k: round(x, digits) for k, x in d.items()}


def main() -> int:
    import torch

    # 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.run import FAT_CAP, LIVE_CAP, orbit_cameras, perturb
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.render import binning, flat, homesort, stream
    from gsjax_torch.render.common import depth_bits
    from gsjax_torch.render.composite import (assemble_band, att_table,
                                              clipped_pair_stream)
    from gsjax_torch.tools import blend_fwd_variants

    torch.backends.cuda.matmul.allow_tf32 = False  # plain blend's einsum: f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    card = smi.splitlines()[0]
    print(f"# device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    dev = torch.device(DEVICE)

    # 2. build -------------------------------------------------------------
    # both libraries side by side (every nvcc at once), each timed: the
    # path's time is the cold start of a first render() or train step
    t0 = time.perf_counter()

    def build(library):
        path = (blend_fwd_variants.build_variant(library) if library == "baseline"
                else kernels.build(library))
        return os.path.relpath(path, ROOT), time.perf_counter() - t0

    libraries = tuple(kernels.SOURCES) + ("baseline",)
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        built = dict(zip(libraries, pool.map(build, libraries)))
    for library in kernels.SOURCES:
        kernels.lib(library)
    base_path = os.path.join(ROOT, built["baseline"][0])
    print(f"# build: {time.perf_counter() - t0:.2f} s; "
          + "; ".join(f"{library} library ready after {t:.2f} s -> {path}"
                      for library, (path, t) in built.items()))

    # 3-5. scene, cameras, config -------------------------------------------
    t0 = time.perf_counter()
    g = bonsai_like(n=N_SPLATS, seed=0, sh_degree=0, device=dev)
    cams = orbit_cameras(30, WIDTH, HEIGHT, device=dev)
    cfg = gt.RenderConfig(backend="stream", chunk=128, fat_cap=FAT_CAP,
                          fat_live_cap=LIVE_CAP)
    cfg_flat = dataclasses.replace(cfg, backend="pallas")
    configs = {"stream": cfg, "pallas": cfg_flat}
    torch.cuda.synchronize()
    print(f"# scene: {N_SPLATS} splats, {len(cams)} orbit views at "
          f"{WIDTH}x{HEIGHT}, set-up {time.perf_counter() - t0:.2f} s")

    # 6. kernels vs their plain versions on view 0 ---------------------------
    results = []
    with torch.no_grad():
        cam0 = cams[0].to(dev)
        _, aux0, _, (p, ph, layout, bins) = staged_render(g, cam0, cfg)
        tiles_x, tiles_y = cfg.tiles_x(WIDTH), cfg.tiles_y(HEIGHT)
        nh = ph.depth.shape[0]

        src18, fb, fbe, n_copies = homesort.fat_repeat_inputs(p, tiles_x, tiles_y, cfg)
        a_args = (src18, fb, fbe, n_copies, FAT_CAP, tiles_x, tiles_y,
                  cfg.tile_span, cfg.tile_size, cfg.alpha_min)
        tail_k, keys_k = homesort.repeat_fat_parents(*a_args)
        tail_k2, keys_k2 = homesort.repeat_fat_parents(*a_args)
        tail_p, keys_p = homesort.repeat_fat_parents_plain(*a_args)
        err_a = max(float((tail_k - tail_p).abs().max()),
                    float((keys_k - keys_p).abs().max()))
        check(torch.equal(tail_k, tail_p) and torch.equal(keys_k, keys_p),
              f"kernel A (repeat) differs from its plain version: {err_a}")
        check(torch.equal(tail_k, tail_k2) and torch.equal(keys_k, keys_k2),
              "kernel A (repeat): two launches differ")
        n_live_copies = int((keys_k[0] < tiles_x * tiles_y).sum())
        nf = int((fb < 2**30).sum())
        # the fat parents' rows (18 floats, fb, fbe, thr) read once, the
        # tail table and the 4 key rows written once; the earlier count
        # charged a 20-step search a slot and 8 key rows
        bound_a = bound(nf * 21 * 4 + nbytes(tail_k, keys_k), OPS_PER_SLOT_A * FAT_CAP)
        bound_a_old = bound(nf * 21 * 4 + nbytes(tail_k) + 8 * FAT_CAP * 4, 130 * FAT_CAP)
        print(f"# A repeat: fat parents {nf}, copy slots "
              f"{int(n_copies)} of {FAT_CAP}, live copies {n_live_copies} of "
              f"{LIVE_CAP}: bit-equal to the plain version, two launches bit-equal; "
              f"bound {bound_a[0]:.4f} ms ({bound_a[1]}; the earlier count, with a "
              f"search a slot and 8 key rows: {bound_a_old[0]:.4f})")
        launch_a = (src18, fb, fbe,
                    homesort.cull_threshold(src18[:, 6], cfg.alpha_min).contiguous(),
                    torch.as_tensor(n_copies, dtype=torch.int64, device=dev), FAT_CAP,
                    tiles_x, tiles_y, cfg.tile_span, cfg.tile_size)
        print(f"# A repeat: launch alone {cuda_ms(lambda: homesort.launch_repeat(*launch_a), 20):.4f} "
              f"ms (the wrapper adds the parents' cull thresholds)")
        results.append(dict(
            name="repeat_fat_parents", route="cuda",
            source="gsjax_torch/csrc/repeat.cu",
            replaces="gsjax/render/homesort.py:125",
            max_abs_err=err_a,
            ms=cuda_ms(lambda: homesort.repeat_fat_parents(*a_args), 20),
            plain_ms=cuda_ms(lambda: homesort.repeat_fat_parents_plain(*a_args), 5),
            bound_ms=bound_a[0], bound_by=bound_a[1], library_ms=None,
        ))

        # B: the live pairs in pid order and their keys, against the plain
        # version (the dense expansion, flattened in pid order, `nonzero`,
        # the key: the pipeline the kernel replaces), twice; then the sorted pairs
        # and tile starts of the path against the old sort of the dense
        # expansion
        b_args = (ph, layout, 0, tiles_y, tiles_x, cfg)
        pid_k, key_k = binning.expand_live_pairs(*b_args)
        pid_k2, key_k2 = binning.expand_live_pairs(*b_args)
        pid_p, key_p = binning.expand_live_pairs_plain(*b_args)
        same_b = pid_k.shape == pid_p.shape and bool(torch.equal(pid_k, pid_p)
                                                     and torch.equal(key_k, key_p))
        err_b = float((key_k - key_p).abs().max()) if pid_k.shape == pid_p.shape else None
        check(same_b, f"kernel B (expand) differs from its plain version: "
              f"{pid_k.shape[0]} against {pid_p.shape[0]} live pairs, max |Δ key| {err_b}")
        check(torch.equal(pid_k, pid_k2) and torch.equal(key_k, key_k2),
              "kernel B (expand): two launches differ")
        cols = binning.expand_cols(ph, layout, cfg)
        tile2d = binning.expand_pairs_plain(cols, 0, tiles_y, tiles_x, cfg.tile_size,
                                            cfg.tile_span)[0]
        tile_flat = tile2d.T.reshape(-1)
        live = torch.nonzero(tile_flat != binning.INVALID_TILE).squeeze(1)
        dbits_pad = torch.nn.functional.pad(depth_bits(ph.depth), (0, cols.shape[1] - nh))
        order = homesort.sort_perm(tile_flat[live], dbits_pad[live // cfg.tile_span ** 2])
        starts_old = torch.searchsorted(
            tile_flat[live][order],
            torch.arange(tiles_x * tiles_y + 1, dtype=torch.int32, device=dev),
            side="left").to(torch.int32)
        check(torch.equal(live[order].to(torch.int32), bins.pid_sorted)
              and torch.equal(starts_old, bins.tile_starts),
              "bins: pid_sorted or tile_starts differ from the old sort of the dense "
              "expansion")
        del cols, tile2d, tile_flat, live, dbits_pad, order, starts_old
        inputs_b = binning.expand_inputs(ph, layout, cfg)
        launch_b = (*inputs_b, 0, tiles_y, tiles_x, cfg.tile_size, cfg.tile_span)
        # each home row's fields read once (home tile, window, liveness,
        # mean, conic, cull threshold, depth bits), 12 bytes a live pair
        # written; the earlier count charged the 16-row column table and
        # two dense [K, NH_pad] i32 outputs
        nh_pad = -(-nh // 4096) * 4096
        bound_b = bound(nh * (4 + 4 + 16 + 1 + 8 + 12 + 4 + 4) + nbytes(pid_k, key_k),
                        OPS_PER_CANDIDATE_B * nh * cfg.tile_span ** 2)
        bound_b_old = bound(nh_pad * (16 + 2 * cfg.tile_span ** 2) * 4,
                            OPS_PER_CANDIDATE_B * nh_pad * cfg.tile_span ** 2)
        ms_b_launch = cuda_ms(lambda: binning.launch_expand(*launch_b), 20)
        print(f"# B expand: home rows {nh}, live pairs {pid_k.shape[0]} of "
              f"{nh * cfg.tile_span ** 2} candidates: pid_live and key bit-equal to the "
              f"plain version (the dense expansion and its compaction), two launches "
              f"bit-equal; the path's pid_sorted and tile_starts equal the old sort's; "
              f"launch alone {ms_b_launch:.4f} ms; bound {bound_b[0]:.4f} ms "
              f"({bound_b[1]}; the earlier count, with the column table and dense "
              f"outputs: {bound_b_old[0]:.4f})")
        results.append(dict(
            name="expand_pairs", route="cuda",
            source="gsjax_torch/csrc/expand.cu",
            replaces="gsjax/render/binning.py:51",
            max_abs_err=err_b,
            ms=cuda_ms(lambda: binning.expand_live_pairs(*b_args), 20),
            plain_ms=cuda_ms(lambda: binning.expand_live_pairs_plain(*b_args), 5),
            bound_ms=bound_b[0], bound_by=bound_b[1], library_ms=None,
        ))
        del pid_k, pid_k2, pid_p, key_k, key_k2, key_p, inputs_b, launch_b, launch_a

        att = att_table(ph).contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg)
        c_args = (att, pid, starts, 0, tiles_x, cfg)
        out_k = stream.stream_forward(*c_args)
        out_p = stream.stream_forward_plain(*c_args)
        err_c, p999, n_done_diff, c_diff = blend_diff(out_k, out_p)
        counts = starts[1:] - starts[:-1]
        pp_c = replayed_pair_pixels(out_k, starts, cfg)
        # the pair-pixels the blend needs (live, included), counted by the
        # plain replay of the same decisions
        work_c = {}
        ct0 = torch.zeros((out_k.shape[0], out_k.shape[2], 3), device=dev)
        stream.stream_backward_plain(att, pid, starts, out_k, ct0, ct0[..., 0], 0,
                                     tiles_x, cfg, stats=work_c)
        del ct0
        bound_c = bound(nbytes(att, pid, starts, out_k),
                        needed_ops(work_c, OPS_INCLUDED_PAIR_PIXEL_C))
        bound_c_live = bound(nbytes(att, pid, starts, out_k),
                             needed_ops(work_c, OPS_INCLUDED_PAIR_PIXEL_C, "pair_pixels_live"))
        eps = cfg.transmittance_eps
        base_c = check_baseline("kernel C", base_path, stream.stream_forward, c_args, eps)
        print(f"# C stream blend: {bins.pid_sorted.shape[0]} pairs over "
              f"{tiles_x * tiles_y} tiles (max {int(counts.max())} per tile, "
              f"{int((counts == 0).sum())} empty); |img, T_act| diff p99.9 "
              f"{p999:.3e} max {err_c:.3e}; C max diff {c_diff:.3e}; n_done "
              f"differs on {n_done_diff} tiles; mean chunks run "
              f"{float(out_k[:, 5, 0].mean()):.2f} of "
              f"{float((-(-counts // cfg.chunk)).float().mean()):.2f}; "
              f"{pp_c} pair-pixels run, {work_c['pair_pixels_live']} live (the pixel's "
              f"C ≥ eps before the pair), {work_c['pair_pixels_included']} included")
        print(f"# C against the baseline variant at view 0: {base_c}")
        print(f"# C's work at view 0 (the plain replay's count, the kernel's warp "
              f"rectangles: {stream.FWD_PIXELS} pixels a thread, "
              f"{stream.FWD_WARP_W} wide): {fwd_work_line(work_c)}")
        print(f"# C bound {bound_c[0]:.4f} ms ({bound_c[1]}; eligible live and included "
              f"pair-pixels); counting every live pair-pixel, the earlier count: "
              f"{bound_c_live[0]:.4f} ms ({bound_c_live[1]})")
        check(work_c["fwd_eligible_skipped"] == 0,
              f"the plain strip cull drops {work_c['fwd_eligible_skipped']} eligible "
              "live pair-pixels at view 0")
        check(p999 <= 2e-5, f"kernel C: p99.9 |diff| {p999} > 2e-5")
        check(err_c <= 5e-3, f"kernel C: max |diff| {err_c} > 5e-3")
        check(n_done_diff <= max(8, tiles_x * tiles_y // 1000),
              f"kernel C: n_done differs on {n_done_diff} tiles")
        results.append(dict(
            name="stream_forward", route="cuda",
            source="gsjax_torch/csrc/stream_fwd.cu",
            replaces="gsjax/render/pallas_stream.py:563",
            max_abs_err=err_c,
            ms=cuda_ms(lambda: stream.stream_forward(*c_args), 20),
            plain_ms=cuda_ms(lambda: stream.stream_forward_plain(*c_args), 2),
            bound_ms=bound_c[0], bound_by=bound_c[1], library_ms=None,
        ))

        # 6c. kernel E: the flat blend over view 0's slot stream
        att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg_flat,
                                                         cfg.tile_span ** 2)
        e_args = (att_al, starts, cbase, tile_of, 0, tiles_x, tiles_y, cfg_flat)
        out_e = flat.slots_forward(*e_args)
        out_ep = flat.slots_forward_plain(*e_args)
        err_e, p999, n_done_diff, c_diff = blend_diff(out_e, out_ep)
        e_vs_c = float((out_e - out_k).abs().max())
        e_equals_c = torch.equal(out_e, out_k)
        pp_e = replayed_pair_pixels(out_e, starts, cfg)
        # the slots up to n_done in each tile: their pairs' rows
        # the same pairs as C's: C's count of the work they need
        bound_e = bound(pp_e // cfg.tile_size ** 2 * ATT_BYTES + nbytes(starts, cbase, out_e),
                        needed_ops(work_c, OPS_INCLUDED_PAIR_PIXEL_C))
        base_e = check_baseline("kernel E", base_path, flat.slots_forward, e_args, eps)
        ms_e = cuda_ms(lambda: flat.slots_forward(*e_args), 20)
        ms_c = cuda_ms(lambda: stream.stream_forward(*c_args), 20)
        print(f"# E slot blend: {att_al.shape[0]} slots ({int(cbase[-1])} live, "
              f"{int(out_e[:, 5, 0].sum())} run), att_al {nbytes(att_al) / 1e6:.1f} MB; "
              f"vs plain |img, T_act| diff p99.9 {p999:.3e} max {err_e:.3e}; C max "
              f"diff {c_diff:.3e}; n_done differs on {n_done_diff} tiles; against "
              f"kernel C on the same pairs max |Δ| {e_vs_c:.3e}, "
              f"{'bit-equal' if e_equals_c else 'NOT bit-equal'}; E {ms_e:.3f} ms, "
              f"C {ms_c:.3f} ms (same call); bound {bound_e[0]:.3f} ms ({bound_e[1]}); "
              f"against the baseline variant: {base_e}")
        check(p999 <= 2e-5, f"kernel E: p99.9 |diff| {p999} > 2e-5")
        check(err_e <= 5e-3, f"kernel E: max |diff| {err_e} > 5e-3")
        check(n_done_diff <= max(8, tiles_x * tiles_y // 1000),
              f"kernel E: n_done differs on {n_done_diff} tiles")
        results.append(dict(
            name="slots_forward", route="cuda",
            source="gsjax_torch/csrc/slots_fwd.cu",
            replaces="gsjax/render/pallas_flat.py:122",
            max_abs_err=err_e, ms=ms_e,
            plain_ms=cuda_ms(lambda: flat.slots_forward_plain(*e_args), 2),
            bound_ms=bound_e[0], bound_by=bound_e[1], library_ms=None,
        ))
        del src18, fb, fbe, tail_k, tail_k2, tail_p, keys_k, keys_k2, keys_p, att_al
        del out_e, out_ep, e_args, tile_of, cbase, out_k, out_p, p, ph, layout, bins

        # 6b. edge cases the bonsai view lacks, at the CPU tests' small
        # shapes: the card's kernel path against the CPU's plain path on
        # the same raw parameters, both backends
        for (name, scene_kw, cfg_kw, (w, h)), backend in itertools.product(
                EDGE_CASES, configs):
            gc = small_scene(np.random.default_rng(7), **scene_kw)
            gg = gt.Gaussians.from_numpy(
                *(getattr(gc, f).detach().numpy() for f in RAW_FIELDS), device=dev
            )
            cam = gt.Camera.create(fx=80.0, fy=80.0, width=w, height=h, device="cpu")
            cfg_e = gt.RenderConfig(backend=backend, chunk=32, **cfg_kw)
            img_c, aux_c = gt.render(gc, cam, cfg_e, return_aux=True)
            img_g, aux_g = gt.render(gg, cam, cfg_e, return_aux=True)
            d = (img_g.cpu() - img_c).abs()
            counters = {k: (int(aux_g[k]), int(aux_c[k])) for k in
                        ("n_pairs", "n_fat_overflow", "n_pair_overflow")}
            print(f"# edge case {name} {w}x{h} ({backend}): |card - cpu| p99.9 "
                  f"{float(torch.quantile(d.flatten(), 0.999)):.3e} max "
                  f"{float(d.max()):.3e}; (card, cpu) {counters}")
            check(float(torch.quantile(d.flatten(), 0.999)) <= 2e-5 and
                  float(d.max()) <= 5e-3,
                  f"edge case {name} ({backend}): card vs cpu {float(d.max())}")
            check(all(a == b for a, b in counters.values()),
                  f"edge case {name} ({backend}): counters differ {counters}")
            # C or E against the baseline variant on the scene's blend inputs
            _, _, _, (_, ph_e, _, bins_e) = staged_render(gg, cam.to(dev), cfg_e)
            pid_e, starts_e, _ = clipped_pair_stream(bins_e, cfg_e)
            att_e = att_table(ph_e).contiguous()
            if backend == "stream":
                fwd, fwd_args = stream.stream_forward, (att_e, pid_e, starts_e, bins_e.ty0,
                                                        bins_e.tiles_x, cfg_e)
            else:
                al, tile_of_e, cbase_e = flat.chunked_pair_attrs(
                    att_e, pid_e, starts_e, cfg_e, cfg_e.tile_span ** 2)
                fwd, fwd_args = flat.slots_forward, (al, starts_e, cbase_e, tile_of_e,
                                                     bins_e.ty0, bins_e.tiles_x,
                                                     bins_e.band_rows, cfg_e)
            detail = check_baseline(f"edge case {name} ({backend})", base_path, fwd,
                                    fwd_args, cfg_e.transmittance_eps)
            print(f"# edge case {name} ({backend}) against the baseline variant: {detail}")
            if name == "overflow":
                check(counters["n_fat_overflow"][0] > 0, "overflow not counted")

        # 6b. kernel B at every span it is built for, on the fat edge
        # scene: the flat backend's render, card against CPU, and B's
        # live pairs against its plain version on the card, bit-equal, two
        # launches bit-equal
        _, scene_kw, cfg_kw, (w, h) = EDGE_CASES[1]
        gc = small_scene(np.random.default_rng(7), **scene_kw)
        gg = gt.Gaussians.from_numpy(
            *(getattr(gc, f).detach().numpy() for f in RAW_FIELDS), device=dev)
        cam = gt.Camera.create(fx=80.0, fy=80.0, width=w, height=h, device="cpu")
        span_pairs = {}
        for span in binning.EXPAND_ROWS:
            cfg_s = gt.RenderConfig(backend="pallas", chunk=32, tile_span=span, **cfg_kw)
            img_c = gt.render(gc, cam, cfg_s)
            img_g, _, _, (_, ph_s, lay_s, _) = staged_render(gg, cam.to(dev), cfg_s)
            d = (img_g.cpu() - img_c).abs()
            check(float(torch.quantile(d.flatten(), 0.999)) <= 2e-5 and float(d.max()) <= 5e-3,
                  f"span {span} (pallas): card vs cpu {float(d.max())}")
            bs_args = (ph_s, lay_s, 0, cfg_s.tiles_y(h), cfg_s.tiles_x(w), cfg_s)
            pid_s, key_s = binning.expand_live_pairs(*bs_args)
            pid_s2, key_s2 = binning.expand_live_pairs(*bs_args)
            pid_sp, key_sp = binning.expand_live_pairs_plain(*bs_args)
            check(pid_s.shape == pid_sp.shape and torch.equal(pid_s, pid_sp)
                  and torch.equal(key_s, key_sp),
                  f"kernel B at span {span} differs from its plain version")
            check(torch.equal(pid_s, pid_s2) and torch.equal(key_s, key_s2),
                  f"kernel B at span {span}: two launches differ")
            span_pairs[span] = (ph_s.depth.shape[0], pid_s.shape[0], float(d.max()))
        print("# B at every span it is built for (fat edge scene, pallas; span: home rows, "
              "live pairs, max |card - cpu| of the image): bit-equal to the plain version, "
              f"two launches bit-equal; {span_pairs}")

    # 7 / 7b. serve: the main path through the user's entry point, one
    # backend at a time ---------------------------------------------------
    frames, loss0 = {}, {}
    for backend, cfg_b in configs.items():
        gt.render_trajectory(g, cams[:1], cfg_b)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames[backend] = gt.render_trajectory(g, cams[:SERVE_VIEWS], cfg_b)
        serve_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        print(f"# serve ({backend}): render_trajectory({SERVE_VIEWS} views) "
              f"{serve_s * 1e3:.1f} ms ({serve_s * 1e3 / SERVE_VIEWS:.1f} ms/frame incl. "
              f"device-to-host copy); launches {launches}")
        check_launches(launches, backend, SERVE_VIEWS, train=False)
        print(f"# serve ({backend}): kernel A launched {launches['repeat']} and kernel B "
              f"(one kernel, its live count read once) {launches['expand']} times over "
              f"{SERVE_VIEWS} frames: once a frame")
        fr = frames[backend]
        check(fr.shape == (SERVE_VIEWS, HEIGHT, WIDTH, 3), f"frames {fr.shape}")
        check(bool(np.isfinite(fr).all()), f"{backend}: non-finite pixels")
        loss0[backend] = float(np.mean(fr[0].astype(np.float64) ** 2))
        rel = abs(loss0[backend] - BLACK_LOSS0) / BLACK_LOSS0
        print(f"# ({backend}) view 0 mean(img^2) = {loss0[backend]:.6f} (reference "
              f"{BLACK_LOSS0}, rel diff {rel:.2e})")
        check(rel <= 1e-3, f"{backend}: view 0 mean(img^2) {loss0[backend]} not "
              f"within 0.1% of {BLACK_LOSS0}")
    d_frames = float(np.abs(frames["pallas"] - frames["stream"]).max())
    print(f"# serve: flat frames against stream frames max |Δ| {d_frames:.3e}, "
          f"{'bit-equal' if np.array_equal(frames['pallas'], frames['stream']) else 'NOT bit-equal'}")
    os.makedirs(OUT_DIR, exist_ok=True)
    from gsjax_torch.utils.image import write_png

    write_png(os.path.join(OUT_DIR, "view0.png"), frames["stream"][0])
    del frames

    # 8. timing, both backends ---------------------------------------------
    frame_ms, stages, peak_gb = {}, {}, {}
    for backend, cfg_b in configs.items():
        frame_ms[backend], stages[backend] = [], {}
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for rep in range(2):
                for v in range(SERVE_VIEWS):
                    cam = cams[v].to(dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    gt.render(g, cam, cfg_b)
                    torch.cuda.synchronize()
                    frame_ms[backend].append((time.perf_counter() - t0) * 1e3)
                    img, aux, ms, _ = staged_render(g, cam, cfg_b)
                    for k, x in ms.items():
                        stages[backend].setdefault(k, []).append(x)
                    if rep == 0:
                        ovf = {k: int(aux[k]) for k in aux if k.startswith("n_") and
                               k.endswith("overflow")}
                        check(all(x == 0 for x in ovf.values()),
                              f"{backend} view {v}: overflow {ovf}")
                        check(bool(torch.isfinite(img).all()),
                              f"{backend} view {v}: non-finite")
        peak_gb[backend] = torch.cuda.max_memory_allocated() / 2**30
        split = {k: round(statistics.median(x), 3) for k, x in stages[backend].items()}
        print(f"# timing ({backend}) on {card}: median "
              f"{statistics.median(frame_ms[backend]):.3f} ms/frame over "
              f"{len(frame_ms[backend])} renders of views 0-{SERVE_VIEWS - 1} "
              f"(render() with synchronize); stage split (median ms) {split}; "
              f"peak device memory {peak_gb[backend]:.2f} GiB; overflow counters 0; "
              f"pairs view 0 {int(aux0['n_pairs'])}")

    # 9. kernel D vs its plain version on view 0 ----------------------------
    # the cotangents of a real loss: the perturbed scene against the clean
    # scene's render of the view
    cam0 = cams[0].to(dev)
    g_train = perturb(g)
    with torch.no_grad():
        target0 = gt.render(g, cam0, cfg)
        _, _, _, (p, ph, layout, bins) = staged_render(g_train, cam0, cfg)
        att = att_table(ph).contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg)
        out = stream.stream_forward(att, pid, starts, 0, tiles_x, cfg)
    img_t = out[:, 0:3].transpose(1, 2).contiguous().requires_grad_()
    T_t = out[:, 3].contiguous().requires_grad_()
    img, _ = assemble_band(img_t, T_t, bins, cfg)
    loss = torch.mean((img[:HEIGHT, :WIDTH] - target0) ** 2)
    ct_img, ct_T = torch.autograd.grad(loss, [img_t, T_t])
    d_args = (att, pid, starts, out, ct_img, ct_T, 0, tiles_x, cfg)
    with torch.no_grad():
        dk = stream.stream_backward(*d_args)
        dk2 = stream.stream_backward(*d_args)
        work = {}  # the kernel's work, counted by the plain replay
        dp = stream.stream_backward_plain(*d_args, stats=work)
        torch.cuda.synchronize()
        check(torch.equal(dk, dk2), "kernel D: two launches differ (not deterministic)")
        p999, rel_max, err_d, n_rows = grad_diff(dk, dp)
        print(f"# D stream backward: loss {float(loss):.6f}; per column "
              f"p99.9 |Δ|/peak {fmt_cols(p999)}, max {fmt_cols(rel_max)}; "
              f"max |Δ| {err_d:.3e} over {n_rows} home rows with a "
              f"gradient; two launches bit-equal")
        check(bool((p999 <= 1e-4).all()), f"kernel D: p99.9 |Δ|/peak {p999.tolist()} > 1e-4")
        check(bool((rel_max <= 1e-1).all()), f"kernel D: max |Δ|/peak {rel_max.tolist()} > 1e-1")
        check(bool(torch.isfinite(dk).all()), "kernel D: non-finite gradients")
        pp_d = replayed_pair_pixels(out, starts, cfg)
        bound_d = bound(nbytes(att, pid, starts, out, ct_img, ct_T, dk),
                        needed_ops(work, OPS_INCLUDED_PAIR_PIXEL_D))
        nh = att.shape[0]
        k_slots = cfg.tile_span ** 2
        # the wrapper's three parts apart: the zero of the row marks, the
        # blend kernel, the class-sum kernel (against its plain version)
        dpair = torch.empty((nh * k_slots, 9), device=dev)
        replayed = torch.zeros(nh * k_slots, dtype=torch.uint8, device=dev)
        zero_ms = cuda_ms(lambda: torch.zeros(nh * k_slots, dtype=torch.uint8,
                                              device=dev), 10)
        kern_ms = cuda_ms(lambda: stream.stream_backward_pairs(dpair, replayed, *d_args),
                          10)
        sum_ms = cuda_ms(lambda: stream.home_class_sum(dpair, replayed, nh, k_slots), 10)
        sum_k = stream.home_class_sum(dpair, replayed, nh, k_slots)
        sum_p = stream.home_class_sum_plain(dpair, replayed, nh, k_slots)
        sum_err = float(((sum_k - sum_p).abs().amax(dim=0)
                         / sum_p.abs().amax(dim=0).clamp(min=1e-30)).max())
        check(sum_err <= 1e-6, f"kernel D's class sum: max |Δ|/peak {sum_err} > 1e-6")
        n_marked = int(replayed.sum())
        # each mark read once, each marked row once, each home row written
        bound_s = bound(nbytes(replayed) + (n_marked + nh) * ATT_BYTES, 9 * n_marked)
        results.append(dict(
            name="stream_class_sum", route="cuda",
            source="gsjax_torch/csrc/stream_bwd.cu",
            replaces="gsjax/render/pallas_stream.py:685",
            max_abs_err=float((sum_k - sum_p).abs().max()), ms=sum_ms,
            plain_ms=cuda_ms(lambda: stream.home_class_sum_plain(dpair, replayed, nh,
                                                                 k_slots), 10),
            bound_ms=bound_s[0], bound_by=bound_s[1], library_ms=None,
        ))
        del dpair, replayed, sum_k, sum_p
        ms_d = cuda_ms(lambda: stream.stream_backward(*d_args), 10)
        plain_d = cuda_ms(lambda: stream.stream_backward_plain(*d_args), 2)
        results.append(dict(
            name="stream_backward", route="cuda",
            source="gsjax_torch/csrc/stream_bwd.cu",
            replaces="gsjax/render/pallas_stream.py:685",
            max_abs_err=err_d, ms=ms_d, plain_ms=plain_d,
            bound_ms=bound_d[0], bound_by=bound_d[1], library_ms=None,
        ))
        bound_d_live = bound(nbytes(att, pid, starts, out, ct_img, ct_T, dk),
                             needed_ops(work, OPS_INCLUDED_PAIR_PIXEL_D, "pair_pixels_live"))
        print(f"# D: {pp_d} pair-pixels replayed, {work['pair_pixels_live']} live, "
              f"{work['pair_pixels_eligible']} eligible, "
              f"{work['pair_pixels_included']} included; bound counting every live one "
              f"(the earlier count) {bound_d_live[0]:.4f} ms; {n_marked} rows marked; "
              f"wrapper {ms_d:.3f} ms = zero of the "
              f"row marks [{nh * k_slots}] {zero_ms:.3f} + blend kernel {kern_ms:.3f} + "
              f"class-sum kernel {sum_ms:.3f} (against its plain version max |Δ|/peak "
              f"{sum_err:.1e}); plain {plain_d:.3f} ms; bound {bound_d[0]:.3f} ms "
              f"({bound_d[1]}) on {card}")
        print(f"# D's work at view 0 (the plain replay's count, the kernel's grouping: "
              f"{stream.BWD_PAIRS} pairs reduced together, {stream.BWD_PIXELS} pixels a "
              f"thread): (warp, pair)s with an included pixel "
              f"{work['warp_pairs_included']} of {work['warp_pairs']} "
              f"({work['warp_pairs_included'] / work['warp_pairs']:.3f}); (warp, group)s "
              f"reduced {work['warp_groups_reduced']} of {work['warp_groups']} visited "
              f"({work['warp_groups_reduced'] / max(1, work['warp_groups']):.3f}); "
              f"pair-pixels the warps' stops skipped {work['pair_pixels_stopped']} of "
              f"{work['pair_pixels']} "
              f"({work['pair_pixels_stopped'] / max(1, work['pair_pixels']):.3f})")

        # 9c. kernel F: the flat backward with the same cotangents, from
        # kernel E's exit state
        att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg_flat, k_slots)
        out_e = flat.slots_forward(att_al, starts, cbase, tile_of, 0, tiles_x, tiles_y,
                                   cfg_flat)
        f_args = (att_al, starts, cbase, tile_of, 0, out_e, ct_img, ct_T, tiles_x,
                  tiles_y, cfg_flat)
        fk = flat.slots_backward(*f_args)
        fk2 = flat.slots_backward(*f_args)
        work_f = {}
        fp = flat.slots_backward_plain(*f_args, stats=work_f)
        torch.cuda.synchronize()
        check(torch.equal(fk, fk2), "kernel F: two launches differ (not deterministic)")
        p999, rel_max, err_f, n_rows = grad_diff(fk.view(-1, 9), fp.view(-1, 9))
        print(f"# F slot backward: E's exit state "
              f"{'bit-equal to' if torch.equal(out_e, out) else 'NOT bit-equal to'} "
              f"C's; per column p99.9 |Δ|/peak {fmt_cols(p999)}, max "
              f"{fmt_cols(rel_max)}; max |Δ| {err_f:.3e} over {n_rows} slot rows "
              f"with a gradient; two launches bit-equal")
        check(bool((p999 <= 1e-4).all()), f"kernel F: p99.9 |Δ|/peak {p999.tolist()} > 1e-4")
        check(bool((rel_max <= 1e-1).all()), f"kernel F: max |Δ|/peak {rel_max.tolist()} > 1e-1")
        check(bool(torch.isfinite(fk).all()), "kernel F: non-finite gradients")
        # F's slot gradients back to home rows through the gather's VJP,
        # against kernel D's home-row gradients
        with torch.enable_grad():
            att_g = att.detach().requires_grad_()
            (d_home,) = torch.autograd.grad(
                flat.chunked_pair_attrs(att_g, pid, starts, cfg_flat, k_slots)[0], att_g, fk)
        p999, rel_max, err_fd, _ = grad_diff(d_home, dk)
        print(f"# F after the slot gather's VJP against D: max |Δ| {err_fd:.3e}, "
              f"{'bit-equal' if torch.equal(d_home, dk) else 'NOT bit-equal'}; per "
              f"column p99.9 |Δ|/peak {fmt_cols(p999)}")
        check(bool((p999 <= 1e-4).all()) and bool((rel_max <= 1e-1).all()),
              f"flat home-row gradients differ from D's: {p999.tolist()}, {rel_max.tolist()}")
        pp_f = replayed_pair_pixels(out_e, starts, cfg)
        bound_f = bound(pp_f // cfg.tile_size ** 2 * ATT_BYTES
                        + nbytes(starts, cbase, out_e, ct_img, ct_T, fk),
                        needed_ops(work_f, OPS_INCLUDED_PAIR_PIXEL_D))
        ms_f = cuda_ms(lambda: flat.slots_backward(*f_args), 10)
        plain_f = cuda_ms(lambda: flat.slots_backward_plain(*f_args), 2)
        bound_f_live = bound(pp_f // cfg.tile_size ** 2 * ATT_BYTES
                             + nbytes(starts, cbase, out_e, ct_img, ct_T, fk),
                             needed_ops(work_f, OPS_INCLUDED_PAIR_PIXEL_D, "pair_pixels_live"))
        print(f"# F: {pp_f} pair-pixels replayed, {work_f['pair_pixels_live']} live, "
              f"{work_f['pair_pixels_eligible']} eligible, "
              f"{work_f['pair_pixels_included']} included (bound counting every live one, "
              f"the earlier count, {bound_f_live[0]:.4f} ms); F {ms_f:.3f} ms (its zeroed output "
              f"[{fk.shape[0]}, {cfg.chunk}, 9] included), D {ms_d:.3f} ms; plain "
              f"{plain_f:.3f} ms; bound {bound_f[0]:.3f} ms ({bound_f[1]}) on {card}")
        results.append(dict(
            name="slots_backward", route="cuda",
            source="gsjax_torch/csrc/slots_bwd.cu",
            replaces="gsjax/render/pallas_flat.py:195",
            max_abs_err=err_f, ms=ms_f, plain_ms=plain_f,
            bound_ms=bound_f[0], bound_by=bound_f[1], library_ms=None,
        ))
    del p, ph, layout, bins, att, pid, starts, out, img_t, T_t, img, dk, dk2, dp
    del ct_img, ct_T, att_al, out_e, fk, fk2, fp, d_home, att_g, f_args, d_args
    del tile_of, cbase
    del g_train, target0

    # 9b. gradients on the small scenes: card against the CPU's plain path,
    # with a background so the transmittance's cotangent is not zero, both
    # backends
    for (name, scene_kw, cfg_kw, (w, h)), backend in itertools.product(
            EDGE_CASES[:3], configs):
        grads = []
        for device in ("cpu", dev):
            gc = small_scene(np.random.default_rng(7), **scene_kw)
            gc = gt.Gaussians.from_numpy(
                *(getattr(gc, f).detach().numpy() for f in RAW_FIELDS), device=device)
            cam = gt.Camera.create(fx=80.0, fy=80.0, width=w, height=h, device=device)
            cfg_e = gt.RenderConfig(backend=backend, chunk=32,
                                    background=(0.2, 0.3, 0.5), **cfg_kw)
            tgt = torch.from_numpy(np.random.default_rng(8).uniform(
                0, 1, (h, w, 3)).astype(np.float32)).to(device)
            torch.mean((gt.render(gc, cam, cfg_e) - tgt) ** 2).backward()
            grads.append({f: getattr(gc, f).grad.cpu() for f in RAW_FIELDS})
        worst = {}
        for f in RAW_FIELDS:
            a, b = grads[0][f], grads[1][f]
            rel = (a - b).abs() / (a.abs().max() + 1e-12)
            worst[f] = (float(torch.quantile(rel.flatten(), 0.99)), float(rel.max()))
            check(worst[f][0] <= 5e-3 and worst[f][1] <= 1e-1 and
                  bool(torch.isfinite(b).all()),
                  f"gradients {name}.{f} ({backend}): card vs cpu p99 / max rel {worst[f]}")
        print(f"# gradients {name} {w}x{h} ({backend}): card vs cpu (p99, max) |Δ|/peak "
              f"{ {f: (f'{x:.1e}', f'{y:.1e}') for f, (x, y) in worst.items()} }")

    # 10 / 10b. train: the training path through the user's entry points,
    # one backend at a time ------------------------------------------------
    cams_t = [c.to(dev) for c in cams[:TRAIN_VIEWS]]
    train = {}
    for backend, fixed in (("stream", FIXED_STEPS), ("pallas", FLAT_FIXED_STEPS)):
        train[backend] = train_phase(g, perturb(g), cams_t, configs[backend],
                                     list(range(TRAIN_VIEWS)) + [0] * fixed, card)
        torch.cuda.empty_cache()
    # 11. probes: G-J against their plain versions, on no path; the
    # counters show that only this phase launched them ----------------------
    t0 = time.perf_counter()
    probe_results, probe_detail = probes_phase(dev, card)
    print(f"# probes: {time.perf_counter() - t0:.2f} s; launches in their runs "
          f"{probe_detail['launches']}")

    # 12. lazy frame plans: a resort a view, kernels C and D a step ----------
    t0 = time.perf_counter()
    lazy = lazy_phase(g, cams, cfg, dev, card, train["stream"])
    print(f"# lazy: {time.perf_counter() - t0:.2f} s")

    # A-F: kernel → the training run its launches are read from (A, B:
    # both); the probes G-J: their runs in phase 11
    key = {"repeat_fat_parents": ("stream", "repeat"), "expand_pairs": ("stream", "expand"),
           "stream_forward": ("stream", "stream_fwd"),
           "stream_backward": ("stream", "stream_bwd"),
           "stream_class_sum": ("stream", "stream_class_sum"),
           "slots_forward": ("pallas", "slots_fwd"), "slots_backward": ("pallas", "slots_bwd")}
    for r in results:
        backend, counter = key[r["name"]]
        r["launches"] = train[backend]["launches"][counter]
        r["run"] = "its path's training run"
    results.sort(key=lambda r: list(key).index(r["name"]))  # A-F, D's class sum after D
    probe_results.sort(key=lambda r: PROBE_KERNELS.index(r["name"]))  # G-J
    for r in probe_results:
        r["run"] = "its probe's run in phase 11"
    results += probe_results

    for r in results:
        print(f"# kernel {r['name']} on {card}: {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r.get('limit', r['bound_by'])}), max |err| {r['max_abs_err']:.3e}, "
              f"{r['launches']} launches in {r.pop('run')}")
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump(dict(card=card, kind=kind, kernels=results, frame_ms=frame_ms,
                       stages_ms=stages, peak_gib=peak_gb, loss0=loss0, train=train,
                       probes=probe_detail, lazy=lazy),
                  fh, indent=1)

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
