#!/usr/bin/env python3
"""Drive gsjax_torch's serving and training paths once on one CUDA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile the CUDA kernels from gsjax_torch/csrc: the
               path's library (A-F and the projection pair) and the
               probes' (G-J and the empty
               launch that measures their launch floor), side by side,
               every nvcc at once, each library's time printed; beside
               them the forward's `baseline` variant (tools/
               blend_fwd_variants: C and E with one pixel per thread, no
               strip cull and no warp stop: the full walk) and the native
               PLY parser (native/loader.cpp, the host C++ compiler);
  3. scene   — bonsai_like(n=1,200,000, seed=0, sh_degree=0) on cuda:0;
  4. cameras — bench.py's 1080p orbit: 30 views over 30° of azimuth;
  5. config  — chunk 128, fat_cap 2,342,912, fat_live_cap 1,617,920 (the
               copy budgets the reference's autotune derived for this
               orbit, BENCH_r05.json: phases 1-12 keep them, so their
               numbers compare with earlier runs; phase 14 derives them),
               backend stream — and the same with backend "pallas", the
               flat slot-stream path;
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
               step, ms per resort (synchronised), peak device memory;
 13. io      — bonsai_like(1,200,000, SH degree 3) written with save_ply
               (~298 MB) and read back through the native parser, the
               numpy parser and load_ply_streamed, each bit-equal to the
               saved tensors; save_splat, then load_splat and
               load_splat_streamed bit-equal to each other, within the
               format's u8 steps of the scene; each loader's MB/s; view 0
               of the loaded .ply bit-equal to the in-memory scene's,
               overflow 0; the in-repo scene.splat at 1080p (caps by
               autotune), both backends, card vs the CPU's plain path
               within C's gate; a
               4-group BandedGaussians (degrees 0-3, the quarters) vs its
               to_gaussians() within C's gate, one backward reaching every
               group's parameters, finite;
 14. autotune — derive_caps over the 30-view orbit at the scene-scaled
               base caps, one measuring pass a view (A and B once each,
               nothing of C-F): fat_cap and fat_live_cap BENCH_r05's,
               pair_cap and repack_rows within one rounding step (128
               pairs, one row) of its; each view's counts, the pass's time
               a view and in total;
 15. garden  — garden_like(5,000,000, SH degree 2), caps by bench.run's
               autotune over orbit views 0-3; view 0 rendered with every
               overflow counter 0; LazyTrainer on perturb(g) toward that
               render: two resorts (A, B once each, overflow 0), each
               followed by 16 lazy steps launching C, D, D's class sum once
               a step and nothing else; the loss falls; ms per lazy step,
               per resort, NH and the peak device memory;
 16. reference — the oracle and xla backends (plain PyTorch on the card;
               TF32 must be off) against stream and pallas on a 2,000-
               splat SH-3 scene at 256×192, exact mode, forward and
               backward, the counters zeroed before each and read after
               (every backend: the projection pair once, the camera's
               gradient too; xla: A and B once, C-F never): each
               image within 1e-4 of the oracle's, xla's gradients (every
               field and camera leaf) against stream's and pallas's within
               1e-4 (p99.9) and 1e-1 (max) of each leaf's peak; BASELINE
               config 2's finite-difference check on a 64×64 crop at SH
               degree 3 through oracle and xla; xla beside stream at
               bench.py's --quick size (50,000 splats, 640×480, tile list
               cap 512), forward and forward + backward;
 17. legacy  — footprint_clamp=True at the --quick size, forward and
               backward: stream (C, D, D' once; A, B never) and pallas (E,
               F once) against xla's plain blend, images under C's gate,
               gradients under 16's bounds, n_clamped of xla and pallas
               equal and > 0 and stream's the same count over the splats
               its legacy layout keeps; pallas against xla at tile_span
               9; C-F timed on the clamped bins;
 18. viewer  — the reference's main loop at full width: bonsai 1080p,
               72 frames of scripted control events (drag, right-button
               pan, wheel, keys, SetCameraTarget, a set_camera freeze)
               through controls.apply_event, update and to_camera into
               render_trajectory(fade_in=True, fade_speed=4.0) on the
               stream backend: A, B, C once a frame and nothing else;
               moving frames differ, still ones bit-equal, the last frame
               bit-equal to render() of its camera, overflow 0 at every
               camera, the cameras bit-equal through camera JSON; ms a
               frame (the fade's frames apart) and frames per second.
 19. sharded — the tile-sharded path (gsjax_torch.parallel) at full
               width: bonsai 1.2M, view 0 at 1080p. 19a: one
               make_train_step_equalized step over 4 bands in one process
               (cuts by derive_row_cuts, caps by derive_shard_caps), A, B,
               C, D and D' once a band and nothing else, its loss within
               1e-5 of the whole image's and 5% of 0.00031, its gradients
               within phase 16's bounds of the whole image's, overflow 0;
               render_sharded over 4 equal bands within C's gate of
               render(); 19b: on a band with ty0 > 0 and fewer live rows
               than static ones, A and B bit-equal to their plain
               versions, C and D within phases 6 and 9's gates; 19c: each
               band's forward + backward ms, splats, home rows and pairs,
               the sum and max against the unsharded step, the all-
               reduce's bytes; 19d: dryrun_multichip(8) on the card
               against MULTICHIP_r05 (cuts, loss 1e-4, pairs 0.1%, the
               CPU's beside), grads_match, overflow 0; 19e: two gloo
               processes of 2 bands on the one card (120 s each) against
               one process's 4-band mesh, rtol 1e-5, the loss falling,
               their render_sharded frame within 1e-6 of the process's.
 20. examples — the example apps (gsjax_torch.examples). 20a: each
               app's run() at the reference example's sizes on the card,
               and on the CPU in a process of its own: frames within C's
               gate, the .splat files written within the format's rule
               (positions bit-equal, scales within the exp∘log round
               trips between them, u8 one step), train_fit's first loss within
               1e-6 relative and its last within 2%, falling on both,
               sharded_render's frame and loss within 1e-5, overflow 0,
               the kernels each card run launched as app_launches says
               (A, B a measuring pass and a render, C a stream render, D
               and D' a step; the sharded xla path A, B a band and no C);
               20b: the demo scene at 1,200,000 splats, SH degree 3,
               written as .ply and .splat and run through the file apps:
               overflow 0, the orbit's frames distinct and lit, the files
               written back re-loading equal to the source, seconds, peak
               GiB and the measured demand of each; 20c: python -m
               gsjax_torch.examples.simple_viewer as a process: rc 0, 8
               PNGs.
 21. project — the projection pair (csrc/project.cu) at the cells'
               shapes: bonsai_like 1,200,000 at SH degree 3 on view 0,
               the forward's fields and the lazy table bit-equal to the
               composition on the card; there, at a lazy resort's home
               rows and at garden_like 5,000,000 at SH degree 3, the
               backward (both modes, the camera's gradient too) against
               the plain VJP computed in float64: each leaf within 2× the
               plain float32 VJP's own error + 1e-6 of its peak (the
               camera's 19 values: + 1e-5) and within 1e-3 of its peak
               (1e-4 at bonsai), two launches bit-equal, the camera's
               gradient leaving the leaves' unchanged (a row whose cull
               float64 decides otherwise gets no output gradient: another
               branch, not rounding; counted); each kernel's time
               alone at the three shapes, beside its byte bound and the
               plain version's time.
Prints the kernels' JSON line (A-J, D's class sum and the projection
pair, each with its
time, its plain version's, its bound and its launches: A-F in their
path's training run (A-D and D' also `sharded_launches`, phase 19's
step, and `examples_launches`, phase 20a's card runs summed), G-J in their probe's timed run in phase 11; a probe's times and bound
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
# BENCH_r05.json's autotune line for this orbit (the reference's derive_caps
# over its 30 views): phases 1-12 render and train at these copy budgets,
# and phase 14 holds the port's derive_caps to them
R05_FAT_CAP, R05_LIVE_CAP = 2_342_912, 1_617_920
R05_PAIR_CAP, R05_REPACK_ROWS = 11_353_088, 1_016
IO_SPLATS, IO_SH_DEGREE = 1_200_000, 3  # phase 13: bonsai_like written and read back
GARDEN_SPLATS, GARDEN_SH_DEGREE, GARDEN_VIEWS = 5_000_000, 2, 4  # phase 15
# phase 16: the reference backends' scene (H·W·N = 98,304,000 elements in
# each of the oracle's [H, W, N] tensors) and BASELINE config 2's
# finite-difference check (a 64×64 crop at SH degree 3)
REF_SPLATS, REF_SIZE, FD_SPLATS, FD_SIZE = 2000, (256, 192), 2, (64, 64)
QUICK_SPLATS, QUICK_SIZE = 50_000, (640, 480)  # bench.py's --quick (phases 16, 17)
QUICK_LIST_CAP = 512  # bench.py's --quick tile_list_cap for the xla backend
ORACLE_TOL = 1e-4  # gsjax's verify recipe: each backend's image within 1e-4 of the oracle's
# a backend's gradient against xla's, per leaf, |Δ| over the leaf's peak:
# the 99.9th percentile, and the most (a pixel's include set may flip near
# eps between a kernel's sequential product and torch's cumprod)
GRAD_REL_P999, GRAD_REL_MAX = 1e-4, 1e-1
FD_ABS, FD_REL, FD_EPS = 2e-4, 2e-2, 1e-3  # tests/test_render.py's finite differences
CAM_LEAVES = ("position", "quat", "fx", "fy")
VIEWER_FRAMES, FADE_SPEED = 72, 4.0  # phase 18: the fade reaches 1 at frame ~25
FLAT_FIXED_STEPS = 4
# phase 19: the equalized step's bands on one card; MULTICHIP_r05.json's
# dryrun_multichip(8) (cuts, loss, pairs); the two-process gloo run
SHARD_BANDS, DRYRUN_BANDS = 4, 8
DRYRUN_CUTS, DRYRUN_LOSS, DRYRUN_PAIRS = [0, 8, 9, 10, 11, 12, 13, 14, 16], 0.019779, 2538
MP_TIMEOUT_S = 120  # each worker process's limit
# phase 20: the example apps' demo scene at full size, and the app run as
# a process of its own
EXAMPLE_SPLATS, EXAMPLE_SH_DEGREE = 1_200_000, 3
EXAMPLE_TIMEOUT_S = 120
EXAMPLE_CPU_TIMEOUT_S = 600  # phase 20a's CPU side, after the card's 20a-20c
EXAMPLE_CPU_THREADS = 6  # of the chip machine's 8 cores
# the kernels each path launches (LAUNCHES keys) serving, and besides
# those when training; every backend projects through the projection
# pair (PROJECT_KERNELS), a camera's gradient included
SERVE_KERNELS = {"stream": ("repeat", "expand", "stream_fwd", "project_fwd"),
                 "pallas": ("repeat", "expand", "slots_fwd", "project_fwd"),
                 "xla": ("repeat", "expand", "project_fwd"),
                 "oracle": ("project_fwd",)}  # plain-PyTorch blends
TRAIN_KERNELS = {"stream": ("stream_bwd", "stream_class_sum", "project_bwd"),
                 "pallas": ("slots_bwd", "project_bwd"), "xla": ("project_bwd",),
                 "oracle": ("project_bwd",)}
PROJECT_KERNELS = ("project_fwd", "project_bwd")
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


def small_scene(rng, n, spread, z_range, log_scale_boost=0.0, sh_degree=1):
    """A random scene in front of a camera at the origin looking down +z
    (the CPU tests' make_random_scene, on the CPU, SH degree 1 unless
    told)."""
    import numpy as np

    from gsjax_torch import Gaussians

    means = np.stack([rng.uniform(-spread, spread, n),
                      rng.uniform(-spread, spread, n),
                      rng.uniform(*z_range, n)], axis=-1)
    scales = rng.uniform(0.02, 0.12, (n, 3)) * np.exp(log_scale_boost)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, (sh_degree + 1) ** 2, 3)) * 0.3
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
    the ms of each lazy step and of each resort (synchronised), peak
    device memory."""
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
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = tr.resort(cam)
        torch.cuda.synchronize()
        resorts.append((time.perf_counter() - t0) * 1e3)
        return plan, dict(kernels.LAUNCHES)

    plan, launched = resort(cams_l[0])
    want = {k: int(k in ("repeat", "expand", "project_fwd")) for k in launched}
    check(launched == want, f"lazy: the resort launched {launched} (want A, B and the "
          "projection once)")
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
        want_step = {k: LAZY_STEPS * int(k in ("stream_fwd", "stream_bwd", "stream_class_sum",
                                               *PROJECT_KERNELS)) for k in launched}
        check(launched == want_step, f"lazy: {LAZY_STEPS} steps at view {v} launched "
              f"{launched} (want C, D's two kernels and the projection pair once a step, "
              "nothing else)")
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
    print(f"# lazy timing on {card}: median {statistics.median(step_ms):.3f} ms per lazy "
          f"step over {len(step_ms)} (synchronised; all {[round(x, 2) for x in step_ms]}); "
          f"the exact step (phase 10) median {statistics.median(exact['step_ms']):.3f}; "
          f"resort at views 1-{LAZY_VIEWS - 1} median {statistics.median(resorts[1:]):.3f} "
          f"ms (synchronised; each {[round(x, 2) for x in resorts]}); the last sync "
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


def c_gate(a, b) -> tuple:
    """Two renders against C's gate: (p99.9 |Δ|, max |Δ|, within)."""
    import torch

    d = (a - b).abs().flatten()
    p999 = float(torch.quantile(d[:: max(1, d.numel() // 8_000_000)].float(), 0.999))
    return p999, float(d.max()), p999 <= 2e-5 and float(d.max()) <= 5e-3


def ovf_of(aux) -> dict:
    return {k: int(v) for k, v in aux.items() if k.startswith("n_") and k.endswith("overflow")}


def same_fields(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in RAW_FIELDS)


def io_phase(cfg, cam0, dev, card) -> dict:
    """13. Scene IO on the card at full size: bonsai_like(IO_SPLATS, SH
    degree IO_SH_DEGREE) written with save_ply and read back through the
    native parser, the numpy parser and load_ply_streamed, each bit-equal
    to the saved tensors; written with save_splat and read back through
    load_splat and load_splat_streamed (bit-equal to each other, the
    positions to the saved ones, the rest within the format's u8 steps);
    each loader's MB/s (file to tensors on the card). View 0 of the loaded
    .ply renders bit-equal to the in-memory scene's, overflow 0. The
    in-repo scene.splat at 1080p on the card against the CPU's plain path
    within C's gate, through both backends. A 4-group BandedGaussians
    (degrees 0-3, the scene's quarters) against its to_gaussians() within
    C's gate, and one backward that reaches every group's parameters,
    finite. The files live in a temporary directory that is removed
    afterwards."""
    import shutil
    import tempfile

    import torch

    import gsjax_torch as gt
    from gsjax_torch.bench.run import autotune
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.core.gaussians import SH_C0
    from gsjax_torch.io import native
    from gsjax_torch.io.ply import save_ply

    out = {}
    g3 = bonsai_like(n=IO_SPLATS, seed=0, sh_degree=IO_SH_DEGREE, device=dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="io_", dir=OUT_DIR)
    try:
        def timed(what, fn, nbytes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            out[what] = dict(s=round(s, 3), mb_per_s=round(nbytes / s / 1e6, 1))
            return r

        ply = os.path.join(tmp, "bonsai.ply")
        size = len(timed("save_ply", lambda: save_ply(g3, ply), 0))
        out["save_ply"]["mb_per_s"] = round(size / out["save_ply"]["s"] / 1e6, 1)
        with open(ply, "rb") as fh:
            parser = "native" if native.parse_ply_native(fh.read()) is not None else "numpy"
        check(parser == "native", "io: the native parser declined bonsai's .ply")
        loaded = {
            "load_ply (native)": timed("load_ply (native)",
                                       lambda: gt.load_ply(ply, device=dev), size),
            "load_ply (numpy)": timed("load_ply (numpy)", lambda: gt.load_ply(
                ply, use_native=False, device=dev), size),
            "load_ply_streamed": timed("load_ply_streamed",
                                       lambda: gt.load_ply_streamed(ply, device=dev), size),
        }
        for what, gl in loaded.items():
            check(same_fields(gl, g3), f"io: {what} differs from the saved scene")
        print(f"# io on {card}: bonsai_like({IO_SPLATS}, sh_degree={IO_SH_DEGREE}) .ply "
              f"{size / 1e6:.1f} MB; each loader bit-equal to the saved tensors; "
              + "; ".join(f"{k} {v['s']} s, {v['mb_per_s']} MB/s" for k, v in out.items())
              + f" (the native parser: libgsjax_torch_io from native/loader.cpp)")

        with torch.no_grad():
            img_l, aux = gt.render(loaded["load_ply (native)"], cam0, cfg, return_aux=True)
            img_m = gt.render(g3, cam0, cfg)
        check(torch.equal(img_l, img_m), "io: the loaded .ply renders differently")
        check(not any(ovf_of(aux).values()), f"io: overflow {ovf_of(aux)}")
        del loaded, img_l, img_m

        spl = os.path.join(tmp, "bonsai.splat")
        gt.save_splat(g3, spl)
        size_s = os.path.getsize(spl)
        gs = timed("load_splat", lambda: gt.load_splat(spl, device=dev), size_s)
        gss = timed("load_splat_streamed",
                    lambda: gt.load_splat_streamed(spl, device=dev), size_s)
        check(same_fields(gs, gss), "io: load_splat_streamed differs from load_splat")
        check(torch.equal(gs.means, g3.means), "io: .splat positions differ from the saved")
        with torch.no_grad():
            d_op = float((gs.opacities - g3.opacities).abs().max())
            dot = (gs.normalized_quats() * g3.normalized_quats()).sum(-1).abs()
            rgb = lambda gg: (0.5 + SH_C0 * gg.sh[:, 0]).clamp(0.0, 1.0)
            d_rgb = float((rgb(gs) - rgb(g3)).abs().max())
        check(d_op <= 1 / 255 + 1e-3 and float((1 - dot).max()) < 1e-3 and
              d_rgb <= 1 / 255 + 1e-3, f"io: .splat round trip beyond its u8 steps "
              f"(opacity {d_op}, quats {float((1 - dot).max())}, rgb {d_rgb})")
        print(f"# io: .splat {size_s / 1e6:.1f} MB: load_splat {out['load_splat']} and "
              f"load_splat_streamed {out['load_splat_streamed']} bit-equal, positions as "
              f"saved, opacity / rgb within a u8 step ({d_op:.2e}, {d_rgb:.2e})")
        del gs, gss
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the in-repo scene.splat at 1080p (tools/smoke_render.py's camera at
    # 6x its size), its caps from autotune, both backends: card against
    # the CPU's plain path
    cam_s = dict(fx=1800.0, fy=1800.0, width=WIDTH, height=HEIGHT)
    gsc = gt.load_splat(os.path.join(ROOT, "scene.splat"), device=dev)
    cfg_s = autotune(gsc, [gt.Camera.create(**cam_s, device=dev)],
                     gt.RenderConfig(backend="stream", chunk=128))
    for backend in ("stream", "pallas"):
        imgs = []
        for device in (dev, "cpu"):
            gsc = gt.load_splat(os.path.join(ROOT, "scene.splat"), device=device)
            with torch.no_grad():
                img, aux = gt.render(gsc, gt.Camera.create(**cam_s, device=device),
                                     dataclasses.replace(cfg_s, backend=backend),
                                     return_aux=True)
            check(not any(ovf_of(aux).values()), f"io: scene.splat overflow {ovf_of(aux)}")
            imgs.append(img.cpu())
        p999, dmax, ok = c_gate(imgs[0], imgs[1])
        print(f"# io: scene.splat ({gsc.n} splats) at {WIDTH}x{HEIGHT} ({backend}): card vs "
              f"the CPU's plain path p99.9 |Δ| {p999:.2e}, max {dmax:.2e}; mean "
              f"{float(imgs[0].mean()):.4f}")
        check(ok and float(imgs[0].max()) > 0, f"io: scene.splat ({backend}) card vs cpu "
              f"p99.9 {p999}, max {dmax}")
        out[f"scene_splat_{backend}"] = dict(p999=p999, max=dmax)

    # a banded scene: the bonsai scene's quarters at degrees 0-3
    q = IO_SPLATS // 4
    with torch.no_grad():
        bg = gt.BandedGaussians.from_groups(
            [g3.slice(i * q, (i + 1) * q).with_sh_degree(i) for i in range(4)])
        g_pad = bg.to_gaussians()
        img_b = gt.render(bg, cam0, cfg)
        img_p = gt.render(g_pad, cam0, cfg)
    p999, dmax, ok = c_gate(img_b, img_p)
    check(ok, f"io: banded render vs its to_gaussians() p99.9 {p999}, max {dmax}")
    (gt.render(bg, cam0, cfg) ** 2).mean().backward()
    for i, grp in enumerate(bg.groups):
        for f, t in grp.named_parameters():
            check(t.grad is not None and bool(torch.isfinite(t.grad).all()),
                  f"io: banded group {i}: gradient of {f} missing or not finite")
        check(float(grp.means.grad.abs().max()) > 0, f"io: banded group {i}: zero gradient")
    print(f"# io: BandedGaussians {bg.band_counts} at degrees 0-3 ({bg.sh_bytes() / 1e6:.1f} "
          f"MB of SH against {g_pad.sh.numel() * 4 / 1e6:.1f} padded): render vs "
          f"to_gaussians() p99.9 |Δ| {p999:.2e}, max {dmax:.2e}"
          f"{', bit-equal' if torch.equal(img_b, img_p) else ''}; one backward reached "
          f"all {len(list(bg.parameters()))} group parameters, finite")
    out["banded"] = dict(p999=p999, max=dmax)
    return out


def autotune_phase(g, cams, dev, card) -> dict:
    """14. derive_caps over bench.py's 30-view bonsai orbit at chunk 128
    and the scene-scaled base caps (bench.py's configuration), one
    measuring pass a view (project, kernel A, kernel B: the counters show
    A and B once a view and nothing of C-F); each view's counts and the
    derived config printed. fat_cap and fat_live_cap must be BENCH_r05's,
    pair_cap and repack_rows within one rounding step of its (128 pairs,
    one row); the raw n_pairs printed. Times per view and in total."""
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.core.autotune import derive_caps, measure_occupancy

    base = gt.RenderConfig(backend="stream", chunk=128)
    measure_occupancy(g, cams[0], base)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    ms, view_ms = [], []
    t_all = time.perf_counter()
    for cam in cams:
        t0 = time.perf_counter()
        ms.append(measure_occupancy(g, cam, base))  # reads the counts: synchronised
        view_ms.append((time.perf_counter() - t0) * 1e3)
    t_derive = time.perf_counter()
    cfg = derive_caps(g, cams, base, ms=ms)
    total_ms = (time.perf_counter() - t_all) * 1e3
    derive_ms = (time.perf_counter() - t_derive) * 1e3
    launched = dict(kernels.LAUNCHES)
    want = {k: len(cams) * int(k in ("repeat", "expand", "project_fwd")) for k in launched}
    keys = ("n_valid", "n_live_prim", "n_copies", "n_pairs", "n_fat_overflow")
    for v, m in enumerate(ms):
        print(f"# autotune view {v}: " + ", ".join(f"{k} {m[k]}" for k in keys)
              + f", max cand {int(m['cand'].max())}; {view_ms[v]:.2f} ms")
    worst = {k: max(m[k] for m in ms) for k in ("n_copies", "n_pairs")}
    worst["live_copies"] = max(m["n_valid"] - m["n_live_prim"] for m in ms)
    derived = {f: getattr(cfg, f) for f in ("fat_cap", "fat_live_cap", "pair_cap",
                                             "repack_w", "repack_rows")}
    print(f"# autotune on {card}: {len(cams)} views, median {statistics.median(view_ms):.2f} "
          f"ms a view, {total_ms:.1f} ms in all (derive {derive_ms:.1f}); launches "
          f"{nonzero(launched)}; worst view {worst}; derived {derived} (BENCH_r05: fat_cap "
          f"{R05_FAT_CAP}, live_cap {R05_LIVE_CAP}, pair_cap {R05_PAIR_CAP}, repack_rows "
          f"{R05_REPACK_ROWS})")
    check(launched == want, f"autotune: launches {launched} (want A, B and the projection "
          "once a view)")
    check((cfg.fat_cap, cfg.fat_live_cap) == (R05_FAT_CAP, R05_LIVE_CAP),
          f"autotune: fat_cap {cfg.fat_cap}, fat_live_cap {cfg.fat_live_cap}: not "
          f"BENCH_r05's {R05_FAT_CAP}, {R05_LIVE_CAP}")
    check(abs(cfg.pair_cap - R05_PAIR_CAP) <= 128 and
          abs(cfg.repack_rows - R05_REPACK_ROWS) <= 1,
          f"autotune: pair_cap {cfg.pair_cap}, repack_rows {cfg.repack_rows}: not within "
          f"one step of BENCH_r05's {R05_PAIR_CAP}, {R05_REPACK_ROWS}")
    return dict(view_ms=view_ms, total_ms=total_ms, derived=derived, worst=worst,
                launches=launched)


def garden_phase(dev, card) -> dict:
    """15. Garden on the card: garden_like(GARDEN_SPLATS, SH degree
    GARDEN_SH_DEGREE), caps from derive_caps over orbit views
    0-(GARDEN_VIEWS-1) (bench.run's autotune: the base grows to the
    measured copy demand if the scene-scaled one overflows); view 0
    rendered with every overflow counter 0; a LazyTrainer on perturb(g)
    toward the clean scene's render of view 0: a resort (overflow 0), then
    LAZY_STEPS lazy steps, each launching C, D and D's class sum once and
    nothing else, the loss falling. Prints ms per lazy step (median), ms
    per resort, NH and the card's peak allocated memory."""
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.run import autotune, orbit_cameras, perturb
    from gsjax_torch.bench.synth import garden_like

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = garden_like(n=GARDEN_SPLATS, sh_degree=GARDEN_SH_DEGREE, device=dev)
    cams = orbit_cameras(30, WIDTH, HEIGHT, device=dev)[:GARDEN_VIEWS]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = autotune(g, cams, gt.RenderConfig(backend="stream", chunk=128))
    tune_s = time.perf_counter() - t0
    caps = {f: getattr(cfg, f) for f in ("fat_cap", "fat_live_cap", "pair_cap")}
    with torch.no_grad():
        target, aux = gt.render(g, cams[0], cfg, return_aux=True)
    check(not any(ovf_of(aux).values()), f"garden: view 0 overflow {ovf_of(aux)}")
    check(bool(torch.isfinite(target).all()), "garden: view 0 not finite")
    g_train = perturb(g)
    del g
    tr = gt.LazyTrainer(g_train, cfg, torch.optim.Adam(g_train.parameters(), lr=1e-3))
    resort_ms, step_ms, losses = [], [], []
    for r in range(2):  # the second resort folds the first one's steps back
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernels.reset_launches()
        plan = tr.resort(cams[0])
        torch.cuda.synchronize()
        resort_ms.append((time.perf_counter() - t0) * 1e3)
        launched = dict(kernels.LAUNCHES)
        ovf = {k: int(v) for k, v in plan.ovf.items() if k != "n_pairs"}
        check(not any(ovf.values()), f"garden: resort {r} overflow {ovf}")
        check(launched == {k: int(k in ("repeat", "expand", "project_fwd")) for k in launched},
              f"garden: the resort launched {launched}")
        kernels.reset_launches()
        for _ in range(LAZY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.step(target, cams[0])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launched = dict(kernels.LAUNCHES)
        want = {k: LAZY_STEPS * int(k in ("stream_fwd", "stream_bwd", "stream_class_sum",
                                          *PROJECT_KERNELS)) for k in launched}
        check(launched == want, f"garden: {LAZY_STEPS} lazy steps launched {launched}")
    tr.sync()
    for n_, t in g_train.named_parameters():
        check(bool(torch.isfinite(t).all()), f"garden: {n_} not finite")
    check(losses[-1] < losses[0], f"garden: the loss did not fall ({losses[0]} -> "
          f"{losses[-1]})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"# garden on {card}: garden_like({GARDEN_SPLATS}, sh_degree={GARDEN_SH_DEGREE}), "
          f"set-up {setup_s:.1f} s, autotune over views 0-{GARDEN_VIEWS - 1} {tune_s:.2f} s "
          f"-> {caps}; view 0: {int(aux['n_pairs'])} pairs, overflow 0; lazy: NH "
          f"{plan.nh}, resorts {[round(x, 1) for x in resort_ms]} ms, median "
          f"{statistics.median(step_ms):.3f} ms per lazy step over {len(step_ms)} (all "
          f"{[round(x, 1) for x in step_ms]}), loss {losses[0]:.7f} -> {losses[-1]:.7f}; "
          f"C, D, D' once a step; peak device memory {peak:.2f} GiB")
    return dict(caps=caps, nh=plan.nh, resort_ms=resort_ms, step_ms=step_ms, losses=losses,
                peak_gib=peak, tune_s=tune_s)


def leaf_grads(g, cam) -> dict:
    """The gradients of a Gaussians' fields and a camera's leaves, by name."""
    out = {f: getattr(g, f).grad for f in RAW_FIELDS}
    out.update({f"cam.{f}": getattr(cam, f).grad for f in CAM_LEAVES})
    return out


def grad_camera(cam):
    """`cam` with its position, quat, fx and fy as fresh leaves that
    require grad."""
    return dataclasses.replace(cam, **{f: getattr(cam, f).detach().clone().requires_grad_()
                                       for f in CAM_LEAVES})


def rel_to_peak(a, ref) -> tuple:
    """(p99.9, max) of |a − ref| over ref's peak."""
    import torch

    rel = ((a - ref).abs() / ref.abs().max().clamp(min=1e-30)).flatten().float()
    return float(torch.quantile(rel, 0.999)), float(rel.max())


def host_ms(fn, reps: int) -> list:
    """Host-clock ms of fn over `reps` calls after one warm-up, each
    synchronised on both sides."""
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def reference_phase(dev, card) -> dict:
    """16. The reference backends on the card. A small scene (REF_SPLATS
    splats at SH degree 3, REF_SIZE) rendered exact through oracle, xla,
    stream and pallas, forward and backward, the counters zeroed before
    each and read after (every backend: the projection pair once, the
    camera's gradient too; xla: A and B once, C-F never): each image within ORACLE_TOL of the oracle's, overflow 0;
    xla's gradients (every field and the camera's) against stream's and
    pallas's within GRAD_REL_P999 / GRAD_REL_MAX of each leaf's peak;
    BASELINE config 2's finite-difference check on a FD_SIZE crop at SH
    degree 3 through oracle and xla (tests/test_render.py's smooth config
    and gate); xla and stream timed at bench.py's --quick size, forward
    and forward + backward. TF32 must be off."""
    import numpy as np
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.synth import bench_camera, bonsai_like

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the reference blends' products must run in fp32")
    w, h = REF_SIZE
    rng = np.random.default_rng(16)
    raw = [getattr(small_scene(rng, REF_SPLATS, 1.3, (3.0, 9.0), sh_degree=3), f)
           .detach().numpy() for f in RAW_FIELDS]
    tgt = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to(dev)
    cam0 = gt.Camera.create(position=(0.05, -0.04, 0.03), quat=(0.9995, 0.02, -0.03, 0.015),
                            fx=150.0, fy=150.0, width=w, height=h, device=dev)
    kw = dict(chunk=128, background=(0.2, 0.3, 0.5))
    cfgs = {"oracle": gt.RenderConfig(backend="oracle", **kw),
            "xla": gt.RenderConfig(backend="xla", tile_list_cap=QUICK_LIST_CAP, **kw),
            "stream": gt.RenderConfig(backend="stream", **kw),
            "pallas": gt.RenderConfig(backend="pallas", **kw)}
    imgs, grads, info = {}, {}, {}
    for backend, cfg in cfgs.items():
        g = gt.Gaussians.from_numpy(*raw, device=dev)
        cam = grad_camera(cam0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        img, aux = gt.render(g, cam, cfg, return_aux=True)
        torch.mean((img - tgt) ** 2).backward()
        torch.cuda.synchronize()
        check_launches(dict(kernels.LAUNCHES), backend, 1, train=True)
        imgs[backend], grads[backend] = img.detach(), leaf_grads(g, cam)
        ovf = ovf_of(aux)
        check(not any(ovf.values()), f"reference {backend}: overflow {ovf}")
        for k, t in grads[backend].items():
            check(t is not None and bool(torch.isfinite(t).all()) and bool((t != 0).any()),
                  f"reference {backend}: gradient of {k} missing, non-finite or zero")
        info[backend] = dict(n_pairs=int(aux.get("n_pairs", -1)), ovf=ovf)
    d_img = {b: float((imgs[b] - imgs["oracle"]).abs().max()) for b in cfgs if b != "oracle"}
    print(f"# reference backends on {card}: {REF_SPLATS} splats at SH degree 3, {w}x{h}, "
          f"exact; max |image - oracle's| {_fmt(d_img, 9)} (gate {ORACLE_TOL}); pairs "
          f"{ {b: i['n_pairs'] for b, i in info.items() if b != 'oracle'} }; launches "
          f"(forward + backward) xla A, B and the projection pair once, C-F never; oracle "
          "the projection pair only")
    for b, d in d_img.items():
        check(d <= ORACLE_TOL, f"reference {b}: max |Δ| {d} from the oracle's image")
    g_rel = {}
    for b in ("stream", "pallas", "oracle"):
        g_rel[b] = {k: rel_to_peak(grads[b][k], grads["xla"][k]) for k in grads["xla"]}
        print(f"# reference gradients, {b} against xla (p99.9, max) |Δ|/peak: "
              f"{ {k: (f'{x:.1e}', f'{y:.1e}') for k, (x, y) in g_rel[b].items()} }")
    for b in ("stream", "pallas"):
        for k, (p999, mx) in g_rel[b].items():
            check(p999 <= GRAD_REL_P999 and mx <= GRAD_REL_MAX,
                  f"reference gradients: {b} {k} against xla p99.9 {p999:.2e}, max {mx:.2e}")
    del imgs, grads

    # BASELINE config 2: finite differences on a 64×64 crop at SH degree 3
    fw, fh = FD_SIZE
    rng = np.random.default_rng(2)
    raw_fd = [torch.from_numpy(np.asarray(getattr(small_scene(
        rng, FD_SPLATS, 0.1, (4.5, 5.5), log_scale_boost=0.5, sh_degree=3), f).detach()
        .numpy(), np.float32)).to(dev) for f in RAW_FIELDS]
    cam_fd = gt.Camera.create(fx=100.0, fy=100.0, width=fw, height=fh, device=dev)
    smooth = dict(alpha_min=0.0, transmittance_eps=0.0, radius_sigma=5.0, chunk=32)
    fd_out = {}
    for backend, cfg in (("oracle", gt.RenderConfig(backend="oracle", **smooth)),
                         ("xla", gt.RenderConfig(backend="xla", tile_list_cap=256,
                                                 **smooth))):
        def loss_of(params):
            return torch.mean((gt.render(gt.Gaussians(*params), cam_fd, cfg) - 0.25) ** 2)

        # Parameters: Gaussians keeps them as they are under autograd
        leaves = [torch.nn.Parameter(t.clone()) for t in raw_fd]
        ga = torch.autograd.grad(loss_of(leaves), leaves)
        worst, n_el = 0.0, 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for ai, (a, gai) in enumerate(zip(raw_fd, ga)):
                for j in range(a.numel()):
                    lp = [t.clone() for t in raw_fd]
                    lm = [t.clone() for t in raw_fd]
                    lp[ai].view(-1)[j] += FD_EPS
                    lm[ai].view(-1)[j] -= FD_EPS
                    fd = (float(loss_of(lp)) - float(loss_of(lm))) / (2 * FD_EPS)
                    an = float(gai.view(-1)[j])
                    err = abs(an - fd) / (FD_ABS + FD_REL * abs(fd))
                    worst, n_el = max(worst, err), n_el + 1
                    check(err <= 1.0, f"finite differences ({backend}): {RAW_FIELDS[ai]}[{j}] "
                          f"analytic {an:.6e} against {fd:.6e}")
        fd_out[backend] = dict(elements=n_el, worst=worst, s=time.perf_counter() - t0)
    print(f"# finite differences on {card} (BASELINE config 2: {FD_SPLATS} splats at SH degree "
          f"3 on a {fw}x{fh} crop, alpha_min 0, transmittance_eps 0, radius_sigma 5; eps "
          f"{FD_EPS}, gate |analytic - fd| <= {FD_ABS} + {FD_REL}·|fd|): worst share of the "
          f"gate {_fmt({b: r['worst'] for b, r in fd_out.items()})} over "
          f"{fd_out['xla']['elements']} elements each")

    # bench.py's --quick size: xla beside stream, forward and forward + backward
    qw, qh = QUICK_SIZE
    gq = bonsai_like(n=QUICK_SPLATS, seed=0, sh_degree=0, device=dev)
    camq = bench_camera(width=qw, height=qh, device=dev)
    tq = torch.zeros((qh, qw, 3), dtype=torch.float32, device=dev)
    quick = {}
    for backend in ("xla", "stream"):
        cfg = gt.RenderConfig(backend=backend, chunk=128, tile_list_cap=QUICK_LIST_CAP)
        with torch.no_grad():
            aux = gt.render(gq, camq, cfg, return_aux=True)[1]
        check(not any(ovf_of(aux).values()), f"quick {backend}: overflow {ovf_of(aux)}")

        def fwd_bwd():
            gq.zero_grad(set_to_none=True)
            torch.mean((gt.render(gq, camq, cfg) - tq) ** 2).backward()

        with torch.no_grad():
            fwd = host_ms(lambda: gt.render(gq, camq, cfg), 5)
        quick[backend] = dict(fwd_ms=statistics.median(fwd), fwd_bwd_ms=statistics.median(
            host_ms(fwd_bwd, 5)), pairs=int(aux["n_pairs"]))
    print(f"# xla at bench.py's --quick size on {card} ({QUICK_SPLATS} splats, {qw}x{qh}, "
          f"tile_list_cap {QUICK_LIST_CAP}, chunk 128, overflow 0; median of 5, host clock "
          f"synchronised): xla forward {quick['xla']['fwd_ms']:.3f} ms, forward + backward "
          f"{quick['xla']['fwd_bwd_ms']:.3f}; stream {quick['stream']['fwd_ms']:.3f} / "
          f"{quick['stream']['fwd_bwd_ms']:.3f}")
    return dict(image_max_diff=d_img, grad_rel=g_rel, fd=fd_out, quick=quick, info=info)


def legacy_phase(dev, card) -> dict:
    """17. Legacy mode (footprint_clamp=True) at bench.py's --quick size:
    perturb(g) against the clean scene's exact render through xla (the
    plain padded-list blend), stream (kernels C, D on the legacy home
    layout) and pallas (E, F on the rect-anchored bins of the splats
    themselves), forward and backward, the counters zeroed before each
    and read after (stream: C, D and D's class sum once; pallas: E, F
    once; A and B never; xla: none); images against xla's under C's gate,
    gradients under GRAD_REL_P999 / GRAD_REL_MAX, n_clamped of xla and
    pallas equal and > 0, stream's the same count over the splats its
    legacy layout keeps (within two tiles of the image, gsjax's rule);
    then pallas against xla at tile_span 9 (gsjax's golden flat
    configuration); and C-F's times on the clamped bins."""
    import numpy as np
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.run import perturb
    from gsjax_torch.bench.synth import bench_camera, bonsai_like
    from gsjax_torch.render import flat, stream
    from gsjax_torch.render.binning import build_tile_bins, span_clamped_pairs
    from gsjax_torch.render.composite import assemble_band, att_table, clipped_pair_stream
    from gsjax_torch.render.homesort import _legacy_home, build_home_layout
    from gsjax_torch.render.project import project

    qw, qh = QUICK_SIZE
    g = bonsai_like(n=QUICK_SPLATS, seed=0, sh_degree=0, device=dev)
    cam0 = bench_camera(width=qw, height=qh, device=dev)
    with torch.no_grad():
        target = gt.render(g, cam0, gt.RenderConfig(chunk=128))
    raw = [getattr(perturb(g), f).detach() for f in RAW_FIELDS]
    out = {}
    for span in (3, 9):
        backends = ("xla", "stream", "pallas") if span == 3 else ("xla", "pallas")
        imgs, grads, clamped = {}, {}, {}
        for backend in backends:
            cfg = gt.RenderConfig(backend=backend, chunk=128, tile_list_cap=QUICK_LIST_CAP,
                                  footprint_clamp=True, tile_span=span)
            gg = gt.Gaussians(*[t.clone() for t in raw])
            cam = grad_camera(cam0)
            torch.cuda.synchronize()
            kernels.reset_launches()
            img, aux = gt.render(gg, cam, cfg, return_aux=True)
            torch.mean((img - target) ** 2).backward()
            torch.cuda.synchronize()
            # the blend's kernels and the projection pair once; no layout
            # kernel (A, B) in legacy mode
            want = {k: 1 for k in SERVE_KERNELS[backend] + TRAIN_KERNELS[backend]
                    if k not in ("repeat", "expand")}
            check(nonzero(kernels.LAUNCHES) == want, f"legacy {backend} span {span}: "
                  f"forward + backward launched {nonzero(kernels.LAUNCHES)}, want {want}")
            check(not any(ovf_of(aux).values()), f"legacy {backend}: overflow {ovf_of(aux)}")
            imgs[backend], grads[backend] = img.detach(), leaf_grads(gg, cam)
            clamped[backend] = int(aux["n_clamped"])
        rows = {}
        for backend in backends[1:]:
            p999, mx, ok = c_gate(imgs[backend], imgs["xla"])
            g_rel = {k: rel_to_peak(grads[backend][k], grads["xla"][k]) for k in grads["xla"]}
            rows[backend] = dict(img=(p999, mx), grad=g_rel)
            print(f"# legacy span {span}, {backend} against xla on {card}: image p99.9 / max "
                  f"|Δ| {p999:.2e} / {mx:.2e}; gradients (p99.9, max) |Δ|/peak "
                  f"{ {k: (f'{x:.1e}', f'{y:.1e}') for k, (x, y) in g_rel.items()} }")
            check(ok, f"legacy span {span} {backend}: image against xla {p999}, {mx}")
            for k, (x, y) in g_rel.items():
                check(x <= GRAD_REL_P999 and y <= GRAD_REL_MAX,
                      f"legacy span {span} {backend}: gradient {k} against xla {x:.2e}, {y:.2e}")
        # stream bins the legacy home rows, whose liveness drops the splats
        # more than two tiles outside the image (homesort._legacy_home), so
        # its count is the rect count over those splats, as in gsjax
        note = ""
        if "stream" in clamped:
            cfg = gt.RenderConfig(chunk=128, footprint_clamp=True, tile_span=span)
            with torch.no_grad():
                p = project(gt.Gaussians(*[t.clone() for t in raw]), cam0, cfg)
                on = _legacy_home(p, cfg.tiles_x(qw), cfg.tiles_y(qh), cfg)[2]
                on_count = int(span_clamped_pairs(
                    dataclasses.replace(p, valid=on), cfg, "rect", 0, cfg.tiles_y(qh),
                    cfg.tiles_x(qw), cfg.tiles_y(qh))[2])
            note = (f"; stream's the same count over the splats within two tiles of the "
                    f"image: {on_count}")
            check(clamped["stream"] == on_count, f"legacy span {span}: stream's n_clamped "
                  f"{clamped['stream']}, want {on_count}")
        print(f"# legacy span {span}: n_clamped {clamped} (xla and pallas equal, > 0{note}); "
              "launches (forward + backward) stream C, D, D' once, pallas E, F once, A and B "
              "never")
        check(clamped["pallas"] == clamped["xla"] > 0, f"legacy span {span}: n_clamped "
              f"{clamped}")
        out[span] = dict(rows=rows, n_clamped=clamped)

    # C-F on the clamped bins (the kernel wrappers alone, between CUDA events)
    cfg = gt.RenderConfig(chunk=128, footprint_clamp=True)
    tiles_x, tiles_y = cfg.tiles_x(qw), cfg.tiles_y(qh)
    gg = gt.Gaussians(*[t.clone() for t in raw])
    with torch.no_grad():
        p = project(gg, cam0, cfg)
        ph, layout = build_home_layout(p, cam0, cfg)
        bins_s = build_tile_bins(ph, cam0, cfg, anchor="home", layout=layout)
        bins_f = build_tile_bins(p, cam0, cfg)
    times = {}
    for name, pp, bins in (("stream", ph, bins_s), ("pallas", p, bins_f)):
        att = att_table(pp).detach().contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg)
        if name == "stream":
            fwd = lambda: stream.stream_forward(att, pid, starts, 0, tiles_x, cfg)
        else:
            att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg, 9)
            fwd = lambda: flat.slots_forward(att_al, starts, cbase, tile_of, 0, tiles_x,
                                             tiles_y, cfg)
        with torch.no_grad():
            fo = fwd()
        img_t = fo[:, 0:3].transpose(1, 2).contiguous().requires_grad_()
        T_t = fo[:, 3].contiguous().requires_grad_()
        img, _ = assemble_band(img_t, T_t, bins, cfg)
        ct_img, ct_T = torch.autograd.grad(torch.mean((img[:qh, :qw] - target) ** 2),
                                           [img_t, T_t])
        if name == "stream":
            bwd = lambda: stream.stream_backward(att, pid, starts, fo, ct_img, ct_T, 0,
                                                 tiles_x, cfg)
        else:
            bwd = lambda: flat.slots_backward(att_al, starts, cbase, tile_of, 0, fo, ct_img,
                                              ct_T, tiles_x, tiles_y, cfg)
        with torch.no_grad():
            times[name] = dict(fwd_ms=cuda_ms(fwd, 20), bwd_ms=cuda_ms(bwd, 10),
                               pairs=int(bins.n_pairs))
    print(f"# legacy kernels on the clamped bins on {card} ({QUICK_SPLATS} splats, {qw}x{qh}, "
          f"perturbed scene; wrapper between CUDA events): C {times['stream']['fwd_ms']:.4f} "
          f"ms, D (with its class sum) {times['stream']['bwd_ms']:.4f} over "
          f"{times['stream']['pairs']} pairs of the legacy home layout; E "
          f"{times['pallas']['fwd_ms']:.4f}, F {times['pallas']['bwd_ms']:.4f} over "
          f"{times['pallas']['pairs']} rect-anchored pairs")
    out["kernel_ms"] = times
    return out


def viewer_script(frames: int):
    """The viewer session's input, frame → the control events before
    that frame's update (the string "freeze" is controls.set_camera):
    a left-button drag (orbit), a right-button drag (pan), the wheel
    (out, then in), keys (W forward, E orbit), a SetCameraTarget back to
    the origin, a freeze, and a key that ends it."""
    from gsjax_torch import controls as ctl

    ev = {2: [ctl.MouseDown(960.0, 540.0)], 11: [ctl.MouseUp()],
          14: [ctl.MouseDown(900.0, 500.0, button=2)], 21: [ctl.MouseUp()],
          33: [ctl.KeyDown("KeyW")], 36: [ctl.KeyUp("KeyW")],
          40: [ctl.SetCameraTarget((0.0, 0.0, 0.0))], 50: ["freeze"],
          58: [ctl.KeyDown("KeyE")], 62: [ctl.KeyUp("KeyE")]}
    for i in range(3, 11):
        ev[i] = [ctl.MouseMove(960.0 + 14.0 * (i - 2), 540.0 + 4.0 * (i - 2))]
    for i in range(15, 21):
        ev[i] = [ctl.MouseMove(900.0 + 9.0 * (i - 14), 500.0 + 5.0 * (i - 14))]
    for i, dy in zip(range(24, 30), (40.0, 40.0, 40.0, -30.0, -30.0, -30.0)):
        ev[i] = [ctl.Wheel(dy)]
    check(max(ev) < frames, "viewer script longer than the session")
    return ev


def viewer_phase(g, cfg, dev, card) -> dict:
    """18. The viewer loop at full width — the reference's main loop,
    controls.update() then renderer.render(scene, camera), a frame at a
    time: bonsai 1080p at cfg's caps, VIEWER_FRAMES frames of viewer_
    script through controls.apply_event, update and to_camera, rendered by
    render_trajectory(fade_in=True, fade_speed=FADE_SPEED) on the stream
    backend under no_grad (it pulls each camera from the loop as it goes,
    so each frame's render is timed between two pulls). The counters,
    zeroed before and read after: A, B and C once a frame, nothing else.
    Frames finite; successive frames differ wherever the camera moved
    and are bit-equal where it stood still after the fade (the freeze); the
    last frame bit-equal to render() of its camera with no pass; every
    camera's overflow 0; the cameras through camera_to_json →
    cameras_from_json bit for bit; the session replayed gives the same
    frames. Prints ms a frame (median), the fade's frames apart, frames
    per second, the replay's ms a frame, and the render and the copy to
    the host apart over the same cameras."""
    import numpy as np
    import torch

    import gsjax_torch as gt
    from gsjax_torch import controls as ctl
    from gsjax_torch import kernels

    r = float(np.hypot(4.0, 0.6))  # bench.py's view 0 as an orbit state
    beta = float(np.arcsin(0.6 / r))
    state = ctl.OrbitState(alpha=0.0, beta=beta, radius=r, d_alpha=0.0, d_beta=beta,
                           d_radius=r)
    params = ctl.OrbitParams()
    intr = dict(fx=1600.0, fy=1600.0, width=WIDTH, height=HEIGHT, device=dev)
    script = viewer_script(VIEWER_FRAMES)
    cams, render_ms, controls_ms = [], [], []

    def session(state):
        for i in range(VIEWER_FRAMES):
            t0 = time.perf_counter()
            for e in script.get(i, ()):
                state = ctl.set_camera(state) if e == "freeze" else ctl.apply_event(
                    state, e, params)
            state = ctl.update(state, params)
            cam = ctl.to_camera(state, **intr)
            cams.append(cam)
            t1 = time.perf_counter()
            controls_ms.append((t1 - t0) * 1e3)
            yield cam
            render_ms.append((time.perf_counter() - t1) * 1e3)

    with torch.no_grad():
        gt.render(g, ctl.to_camera(ctl.update(state, params), **intr), cfg)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    frames = gt.render_trajectory(g, session(state), cfg, fade_in=True, fade_speed=FADE_SPEED)
    launched = dict(kernels.LAUNCHES)
    check_launches(launched, "stream", VIEWER_FRAMES, train=False)
    # the same session again (its cameras replayed, the fade anew): the
    # frames bit-equal, each frame's time next to the first pass's
    replay_ms = []

    def replay():
        for cam in cams:
            t1 = time.perf_counter()
            yield cam
            replay_ms.append((time.perf_counter() - t1) * 1e3)

    again = gt.render_trajectory(g, replay(), cfg, fade_in=True, fade_speed=FADE_SPEED)
    check(np.array_equal(again, frames), "viewer: the replayed session's frames differ")
    del again
    check(frames.shape == (VIEWER_FRAMES, HEIGHT, WIDTH, 3) and bool(np.isfinite(frames).all()),
          f"viewer frames {frames.shape} not finite")
    check(len(render_ms) == VIEWER_FRAMES, f"viewer: {len(render_ms)} frames timed")
    fade, faded = 0.0, []  # render_trajectory's schedule
    for _ in range(VIEWER_FRAMES):
        faded.append(fade < 1.0)
        if fade < 1.0:
            fade = min(fade + FADE_SPEED * 0.01, 1.0)
    n_fade = sum(faded)
    still, diffs = 0, []
    for i in range(1, VIEWER_FRAMES):
        same_cam = all(torch.equal(getattr(cams[i], f), getattr(cams[i - 1], f))
                       for f in CAM_LEAVES)
        d = float(np.abs(frames[i] - frames[i - 1]).max())
        if not same_cam:
            diffs.append(d)
            check(d > 0, f"viewer: frame {i} equals frame {i - 1} though the camera moved")
        elif not faded[i]:  # a still camera with no pass on either side
            still += 1
            check(d == 0, f"viewer: frame {i} differs from frame {i - 1} ({d}) at a "
                  "still camera after the fade")
    check(still >= 4, f"viewer: only {still} still frames")
    # the session's cameras again, one at a time, no pass: each frame's
    # render and its copy into fresh host memory (kept alive, as the loop
    # keeps its frames) timed apart, and every camera's overflow counters
    render_only, copy_only, ovf_total, kept = [], [], {}, []
    with torch.no_grad():
        for cam in cams:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, aux = gt.render(g, cam, cfg, return_aux=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kept.append(img.cpu().numpy())
            render_only.append((t1 - t0) * 1e3)
            copy_only.append((time.perf_counter() - t1) * 1e3)
            for k, v in ovf_of(aux).items():
                ovf_total[k] = ovf_total.get(k, 0) + v
    check(np.array_equal(kept[-1], frames[-1]), "viewer: the last frame differs from "
          "render() of its camera")
    check(not any(ovf_total.values()), f"viewer: overflow {ovf_total}")
    only_ms, copy_ms = statistics.median(render_only), statistics.median(copy_only)
    frame_mb = kept[-1].nbytes / 1e6
    del kept
    back = gt.cameras_from_json(json.dumps([gt.camera_to_json(c, id=i)
                                            for i, c in enumerate(cams)]), device=dev)
    check(len(back) == len(cams) and all(
        all(torch.equal(getattr(a, f), getattr(b, f)) for f in CAM_LEAVES)
        and (a.width, a.height, a.near, a.far) == (b.width, b.height, b.near, b.far)
        for a, b in zip(cams, back)), "viewer: cameras changed through camera JSON")
    med = statistics.median(render_ms)
    med_fade = statistics.median(render_ms[:n_fade])
    med_rest = statistics.median(render_ms[n_fade:])
    print(f"# viewer loop on {card}: bonsai {N_SPLATS} at {WIDTH}x{HEIGHT}, "
          f"{VIEWER_FRAMES} frames of controls events (drag, pan, wheel, keys, "
          f"SetCameraTarget, a set_camera freeze; {still} still frames), render_trajectory"
          f"(fade_in=True, fade_speed={FADE_SPEED}), stream: median {med:.3f} ms a frame "
          f"(render, passes and the copy to the host), {n_fade} fade frames {med_fade:.3f}, "
          f"the {VIEWER_FRAMES - n_fade} others {med_rest:.3f} ({1e3 / med_rest:.1f} frames "
          f"a second); the session replayed, bit-equal: {statistics.median(replay_ms):.3f} ms a "
          f"frame (fade frames {statistics.median(replay_ms[:n_fade]):.3f}, the others "
          f"{statistics.median(replay_ms[n_fade:]):.3f}); the same cameras again, no pass, "
          f"synchronised: the render {only_ms:.3f} ms and the "
          f"copy of its {frame_mb:.1f} MB to fresh host memory {copy_ms:.3f} (medians); "
          f"controls {statistics.median(controls_ms):.3f} ms a frame; A, B, C "
          f"once a frame, nothing else; successive moving frames differ (least max |Δ| "
          f"{min(diffs):.2e}), still ones bit-equal; the last frame bit-equal to render(); "
          f"overflow 0; cameras bit-equal through camera JSON")
    return dict(render_ms=render_ms, controls_ms=controls_ms, fade_frames=n_fade,
                still_frames=still, median_ms=med, fade_ms=med_fade, rest_ms=med_rest,
                render_only_ms=only_ms, copy_ms=copy_ms, replay_ms=replay_ms,
                launches=launched)


def band_stages(g, cam, cfg, ty0: int, band: int, rows_live: int) -> dict:
    """parallel.render_sharded._render_band's stream chain
    (binning.build_band_bins, then the blend) without gradients, timed
    stage by stage with a synchronize after each: the band's projected
    splats ("p"), its prefiltered scene ("pb", n_pref), home table and
    layout after the slice ("ph", "layout", n_sliced), bins, and each
    stage's ms ("ms": project, prefilter, home_layout, slice, bins_sort,
    blend)."""
    import torch

    from gsjax_torch.render.binning import build_band_bins
    from gsjax_torch.render.project import project
    from gsjax_torch.render.stream import composite_tiles_stream

    ms, made = {}, {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def lap(name, out=None):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        made[name] = out
        t = now

    with torch.no_grad():
        p = project(g, cam, cfg)
        lap("project")
        ph, layout, bins, n_pref, n_sliced = build_band_bins(p, cam, cfg, ty0, band, rows_live,
                                                             restrict=True, on_stage=lap)
        composite_tiles_stream(ph, layout, bins, cam, cfg)
        lap("blend")
    return dict(p=p, pb=made["prefilter"], n_pref=int(n_pref), ph=ph, layout=layout,
                n_sliced=int(n_sliced), bins=bins, ms=ms)


def sharded_phase(g, cams, cfg, dev, card, unsharded) -> dict:
    """19. The tile-sharded path on the card at full width: bonsai 1.2M,
    orbit view 0 at 1080p (68 tile rows), chunk 128.

    19a: cuts by derive_row_cuts over SHARD_BANDS bands, caps by
    derive_shard_caps(bands=...); one make_train_step_equalized step (one
    process, the bands in turn) from perturb(g) toward g's render of the
    view, the counters zeroed before and read after: A, B, C, D and D′
    once a band, no other kernel; its loss within 1e-5 of the whole
    image's (render, squared error over _image_px · 3) and within 5% of
    bench.py's loss0; each gradient leaf within phase 16's bounds of the
    whole image's gradient; every counter's overflow 0. render_sharded
    over SHARD_BANDS equal bands within C's gate of render() at view 0
    (phase 7's frame).
    19b: on a band with ty0 > 0 and fewer live rows than the bands' static
    rows, kernels A and B bit-equal to their plain versions, C and D
    within phases 6 and 9's gates (C and D's cotangents of the band's
    loss).
    19c: each band's forward + backward ms, its prefiltered splats, home
    rows and pairs; their sum and max against the unsharded step's (timed
    here, and phase 10's); the all-reduce's bytes (not timed: one card).
    19d: dryrun_multichip(DRYRUN_BANDS) on the card: MULTICHIP_r05's cuts,
    its loss within 1e-4, its pairs within 0.1% (the host CPU's run
    beside it), grads_match, overflow 0.
    19e: two gloo processes of two bands on the one card
    (parallel.mp_worker --device cuda:0, MP_TIMEOUT_S each): their 3
    losses those of one process's 4-band mesh within rtol 1e-5, falling;
    their render_sharded frame (the ranks' bands summed by all_reduce)
    within 1e-6 of the process's."""
    import shutil

    import numpy as np
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.bench.run import perturb
    from gsjax_torch.core.autotune import derive_row_cuts, derive_shard_caps, measure_occupancy
    from gsjax_torch.parallel import mp_worker
    from gsjax_torch.parallel.dryrun import dryrun_multichip
    from gsjax_torch.parallel.mesh import make_mesh
    from gsjax_torch.parallel.render_sharded import (AUX_COUNTERS, _band_loss, _image_px,
                                                     _render_band, make_train_step_equalized,
                                                     pad_target_rows, render_sharded)
    from gsjax_torch.render import binning, homesort, stream
    from gsjax_torch.render.composite import assemble_band, att_table, clipped_pair_stream

    out = {}
    cam0 = cams[0].to(dev)
    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles_x(WIDTH), cfg.tiles_y(HEIGHT)
    n_el = _image_px(cam0, cfg) * 3
    with torch.no_grad():
        target = gt.render(g, cam0, cfg)
    g_t = perturb(g)
    params = [getattr(g_t, f) for f in RAW_FIELDS]

    # 19a. the equalized step over SHARD_BANDS bands, one process
    t0 = time.perf_counter()
    m = measure_occupancy(g_t, cam0, cfg)
    cuts = derive_row_cuts(g_t, cam0, cfg, SHARD_BANDS, m=m)
    rows = [cuts[i + 1] - cuts[i] for i in range(SHARD_BANDS)]
    band_max = max(rows)
    cfg_b = derive_shard_caps(g_t, cam0, cfg, bands=list(zip(cuts[:-1], rows)), m=m)
    derive_ms = (time.perf_counter() - t0) * 1e3
    print(f"# sharded: cuts {cuts} (rows {rows}, static {band_max}); caps prefilter "
          f"{cfg_b.shard_prefilter_cap}, slice {cfg_b.shard_slice_cap}, pairs "
          f"{cfg_b.pair_cap}, fat {cfg_b.fat_cap} / {cfg_b.fat_live_cap}; derived in "
          f"{derive_ms:.1f} ms")
    loss1 = torch.sum((gt.render(g_t, cam0, cfg) - target) ** 2) / n_el
    grads1 = torch.autograd.grad(loss1, params)
    loss1 = float(loss1.detach())
    opt = torch.optim.Adam(params, lr=1e-3)
    step = make_train_step_equalized(cam0, cfg_b, make_mesh(SHARD_BANDS, dev), opt, cuts)
    tgt = pad_target_rows(cfg_b, cam0, target, band_max)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss, aux = step(g_t, tgt)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    loss = float(loss)
    aux = {k: int(v) for k, v in aux.items()}
    rel1, rel0 = abs(loss - loss1) / loss1, abs(loss - TRAIN_LOSS0) / TRAIN_LOSS0
    print(f"# sharded 19a: equalized step over {SHARD_BANDS} bands {step_ms:.2f} ms (its first "
          f"call); loss {loss:.9f}, the whole image's {loss1:.9f} (rel {rel1:.2e}), "
          f"bench.py's loss0 {TRAIN_LOSS0} (rel {rel0:.2e}); counters {aux}; launches "
          f"{nonzero(launches)}")
    for name, count in launches.items():
        want = SHARD_BANDS if name in SERVE_KERNELS["stream"] + TRAIN_KERNELS["stream"] else 0
        check(count == want, f"sharded step: kernel {name} launched {count} times over "
              f"{SHARD_BANDS} bands (want {want})")
    check(rel1 <= 1e-5, f"sharded step: loss {loss} not within 1e-5 of the whole image's {loss1}")
    check(rel0 <= 0.05, f"sharded step: loss {loss} not within 5% of {TRAIN_LOSS0}")
    check(all(v == 0 for k, v in aux.items() if k.endswith("overflow")),
          f"sharded step: overflow {aux}")
    grad_rel = {}
    for f, a, p in zip(RAW_FIELDS, grads1, params):
        grad_rel[f] = rel_to_peak(p.grad, a)
        check(grad_rel[f][0] <= GRAD_REL_P999 and grad_rel[f][1] <= GRAD_REL_MAX
              and bool(torch.isfinite(p.grad).all()),
              f"sharded step: gradient of {f} against the whole image's (p99.9, max) "
              f"{grad_rel[f]}")
    print(f"# sharded 19a: gradients against the whole image's, (p99.9, max) |Δ|/peak "
          f"{ {f: (f'{a:.1e}', f'{b:.1e}') for f, (a, b) in grad_rel.items()} }")
    with torch.no_grad():
        img_s = render_sharded(g, cam0, cfg, make_mesh(SHARD_BANDS, dev))
    p999, dmax, ok = c_gate(img_s[:HEIGHT, :WIDTH], target)
    print(f"# sharded 19a: render_sharded over {SHARD_BANDS} equal bands "
          f"({img_s.shape[0]} rows) against render() at view 0: p99.9 |Δ| {p999:.3e}, max "
          f"{dmax:.3e}")
    check(ok and not img_s[tiles_y * ts:].any(),
          f"render_sharded: outside C's gate ({p999}, {dmax}) or past the tiles not black")
    del img_s
    out.update(cuts=cuts, caps=dict(prefilter=cfg_b.shard_prefilter_cap,
                                    slice=cfg_b.shard_slice_cap, pairs=cfg_b.pair_cap),
               loss=loss, loss_whole=loss1, aux=aux, launches=launches, grad_rel=grad_rel,
               first_step_ms=step_ms, render_sharded=(p999, dmax))

    # 19b. kernels A-D on a band off ty0 = 0, fewer live rows than static
    b = min(range(1, SHARD_BANDS), key=lambda d: rows[d])
    ty0, live = cuts[b], rows[b]
    check(live < band_max, f"no band with fewer live rows than {band_max}: {rows}")
    st = band_stages(g_t, cam0, cfg_b, ty0, band_max, live)
    pb, ph, layout, bins = st["pb"], st["ph"], st["layout"], st["bins"]
    with torch.no_grad():
        src18, fb, fbe, n_copies = homesort.fat_repeat_inputs(pb, tiles_x, tiles_y, cfg_b)
        fat_cap = homesort.resolve_fat_caps(pb.depth.shape[0], cfg_b)[0]
        a_args = (src18, fb, fbe, n_copies, fat_cap, tiles_x, tiles_y, cfg.tile_span, ts,
                  cfg.alpha_min)
        tail_k, keys_k = homesort.repeat_fat_parents(*a_args)
        tail_p, keys_p = homesort.repeat_fat_parents_plain(*a_args)
        check(torch.equal(tail_k, tail_p) and torch.equal(keys_k, keys_p),
              f"band {b}: kernel A differs from its plain version")
        b_args = (ph, layout, ty0, live, tiles_x, cfg_b)
        pid_k, key_k = binning.expand_live_pairs(*b_args)
        pid_p, key_p = binning.expand_live_pairs_plain(*b_args)
        check(pid_k.shape == pid_p.shape and torch.equal(pid_k, pid_p)
              and torch.equal(key_k, key_p), f"band {b}: kernel B differs from its plain version")
        tiles_live = (key_k >> 32).to(torch.int32)
        check(int(tiles_live.max()) < tiles_x * live, f"band {b}: kernel B emitted a pair "
              f"past its live rows")
        att = att_table(ph).contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg_b)
        c_args = (att, pid, starts, ty0, tiles_x, cfg_b)
        out_k = stream.stream_forward(*c_args)
        err_c, p999_c, nd_c, _ = blend_diff(out_k, stream.stream_forward_plain(*c_args))
    check(p999_c <= 2e-5 and err_c <= 5e-3 and nd_c <= max(8, tiles_x * band_max // 1000),
          f"band {b}: kernel C against its plain version p99.9 {p999_c}, max {err_c}, "
          f"n_done differs on {nd_c} tiles")
    img_t = out_k[:, 0:3].transpose(1, 2).contiguous().requires_grad_()
    T_t = out_k[:, 3].contiguous().requires_grad_()
    img_b, _ = assemble_band(img_t, T_t, bins, cfg_b)
    loss_b = _band_loss(img_b, tgt[ty0 * ts:], ty0 * ts, live * ts, cam0, n_el)
    ct_img, ct_T = torch.autograd.grad(loss_b, [img_t, T_t])
    d_args = (att, pid, starts, out_k, ct_img, ct_T, ty0, tiles_x, cfg_b)
    with torch.no_grad():
        dk, dk2 = stream.stream_backward(*d_args), stream.stream_backward(*d_args)
        p999_d, rel_max_d, err_d, n_rows = grad_diff(dk, stream.stream_backward_plain(*d_args))
    check(torch.equal(dk, dk2), f"band {b}: kernel D's two launches differ")
    check(bool((p999_d <= 1e-4).all()) and bool((rel_max_d <= 1e-1).all()),
          f"band {b}: kernel D against its plain version p99.9 {p999_d.tolist()}, max "
          f"{rel_max_d.tolist()}")
    print(f"# sharded 19b: band {b} (ty0 {ty0}, {live} of {band_max} rows live): A "
          f"({int(n_copies)} copy slots of {fat_cap}) and B ({pid_k.shape[0]} pairs) bit-equal "
          f"to their plain versions; C p99.9 {p999_c:.2e} max {err_c:.2e}, n_done differs on "
          f"{nd_c} tiles; D per column p99.9 |Δ|/peak {fmt_cols(p999_d)}, max "
          f"{fmt_cols(rel_max_d)} over {n_rows} rows, two launches bit-equal")
    out["band_kernels"] = dict(band=b, ty0=ty0, rows_live=live, pairs=int(pid_k.shape[0]),
                               c=(p999_c, err_c, nd_c), d_p999=p999_d.tolist(),
                               d_max=rel_max_d.tolist())
    del st, pb, ph, layout, bins, src18, fb, fbe, tail_k, keys_k, tail_p, keys_p, pid_k, key_k
    del pid_p, key_p, att, pid, starts, out_k, img_t, T_t, img_b, ct_img, ct_T, dk, dk2, d_args

    # 19c. each band's forward + backward, its splats, home rows and pairs
    per_band = []
    for d in range(SHARD_BANDS):
        ty0, live = cuts[d], rows[d]

        def fwd_bwd(ty0=ty0, live=live):
            img, _ = _render_band(g_t, cam0, cfg_b, ty0, band_max, live)
            _band_loss(img, tgt[ty0 * ts:], ty0 * ts, live * ts, cam0, n_el).backward()

        ms = statistics.median(host_ms(fwd_bwd, 3))
        band_stages(g_t, cam0, cfg_b, ty0, band_max, live)  # warm
        st = band_stages(g_t, cam0, cfg_b, ty0, band_max, live)
        per_band.append(dict(band=d, ty0=ty0, rows=live, ms=ms,
                             stages_ms={k: round(v, 3) for k, v in st["ms"].items()},
                             splats=int(st["pb"].valid.sum()), splat_rows=st["pb"].depth.shape[0],
                             home_rows=int(st["ph"].valid.sum()),
                             home_table=st["ph"].depth.shape[0],
                             pairs=int(st["bins"].n_pairs), n_pref=st["n_pref"],
                             n_sliced=st["n_sliced"]))
        del st
    opt.zero_grad(set_to_none=True)

    def whole():
        (torch.sum((gt.render(g_t, cam0, cfg) - target) ** 2) / n_el).backward()

    whole_ms = statistics.median(host_ms(whole, 3))
    opt.zero_grad(set_to_none=True)
    band_ms = [x["ms"] for x in per_band]
    split = unsharded["split_ms"]
    p10 = statistics.median(split["forward"]) + statistics.median(split["backward"])
    reduce_bytes = sum(p.numel() for p in params) * 4 + (1 + 2 * len(AUX_COUNTERS)) * 4
    for x in per_band:
        print(f"# sharded 19c on {card}: band {x['band']} (rows {x['ty0']}-"
              f"{x['ty0'] + x['rows'] - 1}): forward + backward {x['ms']:.3f} ms; prefiltered "
              f"splats {x['splats']} (table {x['splat_rows']}), home rows {x['home_rows']} "
              f"(slice {x['home_table']}), pairs {x['pairs']}; the forward staged (ms) "
              f"{x['stages_ms']}")
    print(f"# sharded 19c on {card}: bands' forward + backward sum {sum(band_ms):.3f} ms, max "
          f"{max(band_ms):.3f} (what one step on {SHARD_BANDS} cards would pay before the "
          f"all-reduce); the whole image's forward + backward {whole_ms:.3f} ms here, phase "
          f"10's {p10:.3f} (its median step {statistics.median(unsharded['step_ms']):.3f} with "
          f"Adam); the all-reduce would sum {reduce_bytes} bytes ({reduce_bytes / 1e6:.1f} MB: "
          f"{sum(p.numel() for p in params) // g_t.n} floats a splat), not timed: one card "
          f"has no peer")
    out.update(per_band=per_band, bands_ms_sum=sum(band_ms), bands_ms_max=max(band_ms),
               whole_ms=whole_ms, phase10_fwd_bwd_ms=p10, all_reduce_bytes=reduce_bytes)
    del g_t, params, grads1, opt, step, tgt, target
    torch.cuda.empty_cache()

    # 19d. the dryrun on the card, and on the host CPU beside it
    dry = dryrun_multichip(DRYRUN_BANDS, dev)
    dry_cpu = dryrun_multichip(DRYRUN_BANDS, "cpu")
    rel_l = abs(dry["loss"] - DRYRUN_LOSS) / DRYRUN_LOSS
    rel_p = abs(dry["aux"]["n_pairs"] - DRYRUN_PAIRS) / DRYRUN_PAIRS
    print(f"# sharded 19d: dryrun_multichip({DRYRUN_BANDS}) on the card: loss "
          f"{dry['loss']:.6f} (MULTICHIP_r05 {DRYRUN_LOSS}, rel {rel_l:.1e}), cuts "
          f"{dry['cuts']}, n_pairs {dry['aux']['n_pairs']} (r05 {DRYRUN_PAIRS}; the host CPU's "
          f"{dry_cpu['aux']['n_pairs']}, loss {dry_cpu['loss']:.6f}), gradients against the "
          f"whole image's {max(dry['grad_err'].values()):.1e} of the peak")
    check(dry["cuts"] == DRYRUN_CUTS, f"dryrun: cuts {dry['cuts']}")
    check(rel_l <= 1e-4, f"dryrun: loss {dry['loss']} not within 1e-4 of {DRYRUN_LOSS}")
    check(rel_p <= 1e-3, f"dryrun: n_pairs {dry['aux']['n_pairs']} not within 0.1% of "
          f"{DRYRUN_PAIRS}")
    out["dryrun"] = dict(card=dry, cpu=dry_cpu)

    # 19e. two gloo processes of two bands on the one card
    mp_dir = os.path.join(OUT_DIR, "mp")
    shutil.rmtree(mp_dir, ignore_errors=True)
    os.makedirs(mp_dir)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "gsjax_torch.parallel.mp_worker", str(r),
                               "2", os.path.join(mp_dir, "store"), mp_dir, "--device", str(dev)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            try:
                logs.append(pr.communicate(timeout=MP_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                fail(f"mp_worker: a process ran past {MP_TIMEOUT_S} s")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    mp_s = time.perf_counter() - t0
    check(all(pr.returncode == 0 for pr in procs), f"mp_worker failed: {logs}")
    with open(os.path.join(mp_dir, "losses.txt")) as fh:
        got = [float(v) for v in fh.read().split()]
    want, frame = mp_worker.run(make_mesh(2 * mp_worker.BANDS_PER_RANK, dev))
    frame_d = float(np.abs(np.load(os.path.join(mp_dir, "frame.npy")) - frame).max())
    print(f"# sharded 19e: two gloo processes of {mp_worker.BANDS_PER_RANK} bands on the one card "
          f"({mp_s:.1f} s): losses {got}; one process, {2 * mp_worker.BANDS_PER_RANK} bands: "
          f"{want}; their render_sharded frames max |Δ| {frame_d:.1e}")
    check(len(got) == len(want) and np.allclose(got, want, rtol=1e-5, atol=0),
          f"mp_worker: losses {got} against {want}")
    check(got[-1] < got[0], f"mp_worker: losses do not fall {got}")
    check(frame_d <= 1e-6, f"mp_worker: render_sharded over the group differs by {frame_d}")
    out["mp"] = dict(losses=got, one_process=want, frame_max_diff=frame_d, seconds=mp_s)
    return out


def splat_diff(a: bytes, b: bytes) -> dict:
    """Two .splat files of one scene, row by row: bit-equal or not, the
    positions bit-equal or not, the scales' largest distance in ulps and
    in round trips (scale_trips: |Δs| over s·2^-22·(|ln s| + 1), the most
    one exp∘log of s moves it with the card's logf and expf within 2 ulps
    each: a .splat stores s = exp(log_scale), and a loader takes its log
    again), the u8 columns' largest step and the share of those bytes
    that differ (a rounded activation an ulp apart may cross a .5)."""
    import numpy as np

    if len(a) != len(b):
        return dict(bit_equal=False, rows=(len(a) // 32, len(b) // 32))
    ra, rb = (np.frombuffer(x, np.uint8).reshape(-1, 32) for x in (a, b))
    sa, sb = (r[:, 12:24].copy().view(np.int32).astype(np.int64) for r in (ra, rb))
    fa, fb = (r[:, 12:24].copy().view(np.float32).astype(np.float64) for r in (ra, rb))
    trips = np.abs(fa - fb) / (np.abs(fb) * 2.0**-22 * (np.abs(np.log(fb)) + 1))
    u8 = np.abs(ra[:, 24:].astype(np.int64) - rb[:, 24:].astype(np.int64))
    return dict(bit_equal=a == b, means_equal=bool(np.array_equal(ra[:, :12], rb[:, :12])),
                scale_ulps=int(np.abs(sa - sb).max(initial=0)),
                scale_trips=float(trips.max(initial=0)), u8_step=int(u8.max(initial=0)),
                u8_share=float((u8 > 0).mean()) if u8.size else 0.0)


def splat_close(d: dict, trips: int) -> bool:
    """splat_diff of a file against one `trips` exp∘log round trips away:
    positions bit-equal, the scales within that many round trips (see
    splat_diff), the u8 columns within one step on under 1% of them."""
    return d["bit_equal"] or (d.get("means_equal", False) and d["scale_trips"] <= trips
                              and d["u8_step"] <= 1 and d["u8_share"] < 0.01)


def projection_phase(dev, card) -> tuple:
    """21. The projection pair against its plain versions and timed at the
    cells' shapes (the module docstring's phase 21). Returns the two
    kernel-line entries and the errors and times by shape."""
    import torch

    import gsjax_torch as gt
    from gsjax_torch.bench.run import autotune, orbit_cameras, perturb
    from gsjax_torch.bench.synth import bonsai_like, garden_like
    from gsjax_torch.core.gaussians import FIELDS
    from gsjax_torch.render import project as P

    cfg = gt.RenderConfig(backend="stream", chunk=128)
    cams = orbit_cameras(30, WIDTH, HEIGHT, device=dev)
    cam = cams[0]
    camp = P.camera_params(cam)
    cam64 = gt.Camera(*(t.double() for t in (cam.position, cam.quat, cam.fx, cam.fy)),
                      cam.width, cam.height)
    g = bonsai_like(n=N_SPLATS, seed=0, sh_degree=3, device=dev)
    leaves = [getattr(g, f).detach() for f in FIELDS]
    n = leaves[0].shape[0]
    p = P.project_plain(*leaves, cam, cfg)
    fields = (P.home_columns(p), p.valid)  # the composition's, packed as the kernel's
    for table, want in ((False, fields), (True, (P.table_plain(p),))):
        got = P.project_forward(leaves, cam, camp, cfg, table)
        again = P.project_forward(leaves, cam, camp, cfg, table)
        for a, b, c in zip(got, want, again):
            check(torch.equal(a, b) and torch.equal(a, c), f"projection forward (table "
                  f"{table}): not the composition's bits ({int((a != b).sum())} differ) or "
                  "two launches differ")
    n_valid = int(p.valid.sum())
    del p, fields, want, got, again
    gen = torch.Generator(device=dev).manual_seed(0)

    def out_grads(n, table):
        if table:
            t = torch.randn((n, 9), generator=gen, device=dev)
            return (t[:, 0:2], None, t[:, 2:5], t[:, 5:8], t[:, 8])
        return tuple(torch.randn(s, generator=gen, device=dev)
                     for s in ((n, 2), (n,), (n, 3), (n, 3), (n,)))

    def vjp_errors(name, leaves, cap):
        """The backward (both modes, with the camera's gradient) against
        the plain VJP in float64: each leaf's and the camera block's max
        |Δ|/peak, (kernel, plain float32). The kernel within 2× the plain
        float32 VJP's own error (+ 1e-6 of the peak, 1e-5 for the
        camera's sum over every row) and within `cap`. A row that float64
        culls and float32 keeps, or the reverse, takes another branch
        (the table masks its gradient): its output gradients are zero."""
        v64 = P.project_plain(*(t.double() for t in leaves), cam64, cfg).valid
        flip = P.project_plain(*leaves, cam, cfg).valid != v64
        n_flip = int(flip.sum())
        del v64
        err = {"rows_culled_otherwise_in_float64": n_flip}
        for table in (False, True):
            grads = tuple(None if x is None else torch.where(
                flip.view(-1, *([1] * (x.dim() - 1))), 0.0, x)
                for x in out_grads(leaves[0].shape[0], table))
            d = P.project_backward(leaves, cam, camp, cfg, grads, table, camera=True)
            d2 = P.project_backward(leaves, cam, camp, cfg, grads, table, camera=True)
            d0 = P.project_backward(leaves, cam, camp, cfg, grads, table)
            check(all(torch.equal(a, b) for a, b in zip(d, d2)) and d0[5] is None
                  and all(torch.equal(a, b) for a, b in zip(d[:5], d0[:5])),
                  f"projection backward {name} (table {table}): two launches differ, or "
                  "the camera's gradient moved the leaves'")
            d32 = P.project_vjp_plain(*leaves, cam, cfg, *grads, masked=table, camera=True)
            d64 = P.project_vjp_plain(*(t.double() for t in leaves), cam64, cfg,
                                      *(None if x is None else x.double() for x in grads),
                                      masked=table, camera=True)
            rel = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
            e = {f: (rel(a, c), rel(b, c))
                 for f, a, b, c in zip((*FIELDS, "camera"), d, d32, d64)}
            err[str(table)] = e
            for f, (k, p32) in e.items():
                lim = min(cap, 2.0 * p32 + (1e-5 if f == "camera" else 1e-6))
                check(k <= lim, f"projection backward {name} (table {table}): {f} |Δ|/peak "
                      f"{k:.2e} against float64 (plain float32 {p32:.2e}, limit {lim:.2e}; "
                      f"{n_flip} rows culled otherwise in float64)")
            del d, d2, d0, d32, d64
        print(f"# projection backward {name} on {card}: max |Δ|/peak against the plain VJP "
              f"in float64 (kernel, plain float32): {err}")
        return err

    def times(name, leaves):
        n, k = leaves[0].shape[0], leaves[3].shape[1]
        grads, grads_t = out_grads(n, False), out_grads(n, True)
        table_g = torch.cat([grads_t[0], grads_t[2], grads_t[3], grads_t[4][:, None]], dim=1)
        in_b = 4 * (11 + 3 * k) * n  # the leaves: means, log_scales, quats, sh, logit
        lg = [t.detach().requires_grad_() for t in leaves]

        def plain_fwd_bwd():
            q = P.table_plain(P.project_plain(*lg, cam, cfg))
            torch.autograd.grad((q * table_g).sum(), lg)
        out = dict(
            n=n, fwd_ms=cuda_ms(lambda: P.project_forward(leaves, cam, camp, cfg, False), 20),
            table_ms=cuda_ms(lambda: P.project_forward(leaves, cam, camp, cfg, True), 20),
            bwd_ms=cuda_ms(lambda: P.project_backward(leaves, cam, camp, cfg, grads, False),
                           20),
            bwd_table_ms=cuda_ms(lambda: P.project_backward(leaves, cam, camp, cfg, grads_t,
                                                            True), 20),
            bwd_camera_ms=cuda_ms(lambda: P.project_backward(leaves, cam, camp, cfg, grads,
                                                             False, camera=True), 20),
            plain_fwd_ms=cuda_ms(lambda: P.project_plain(*leaves, cam, cfg), 3),
            plain_bwd_ms=cuda_ms(lambda: P.project_vjp_plain(*leaves, cam, cfg, *grads), 3),
            plain_table_fwd_bwd_ms=cuda_ms(plain_fwd_bwd, 3),
            fwd_bound=bound(in_b + 49 * n, 0)[0], table_bound=bound(in_b + 36 * n, 0)[0],
            bwd_bound=bound(2 * in_b + 40 * n, 0)[0],
            bwd_table_bound=bound(2 * in_b + 36 * n, 0)[0])
        print(f"# projection {name} on {card}: " + ", ".join(
            f"{k_} {v:.4f}" if isinstance(v, float) else f"{k_} {v}" for k_, v in out.items()))
        return out

    errors = {"bonsai_sh3": vjp_errors(f"bonsai {n} SH 3 view 0 ({n_valid} valid)", leaves,
                                       1e-4)}
    shapes = {"bonsai_sh3": times("bonsai SH 3 (the exact step's rows)", leaves)}
    # a lazy resort's home rows: the orbit's derived caps, view 0
    cfg_l = autotune(g, cams, cfg)
    gp = perturb(g)
    del g, leaves
    tr = gt.LazyTrainer(gp, cfg_l, torch.optim.Adam(gp.parameters(), lr=1e-3))
    plan = tr.resort(cam)
    hp = [getattr(tr.hp, f).detach() for f in FIELDS]
    name = f"lazy home rows ({plan.nh}, fat_cap {cfg_l.fat_cap})"
    errors["lazy_home_rows"] = vjp_errors(name, hp, 1e-3)
    shapes["lazy_home_rows"] = times(name, hp)
    del tr, gp, hp, plan
    torch.cuda.empty_cache()
    gg = garden_like(n=GARDEN_SPLATS, seed=1, sh_degree=3, device=dev)
    gl = [getattr(gg, f).detach() for f in FIELDS]
    del gg
    errors["garden_sh3"] = vjp_errors("garden SH 3", gl, 1e-3)
    shapes["garden_sh3"] = times("garden SH 3", gl)
    del gl
    torch.cuda.empty_cache()
    b = shapes["bonsai_sh3"]
    worst = max(k for by_mode in errors.values() for mode, e in by_mode.items()
                if mode != "rows_culled_otherwise_in_float64" for k, _ in e.values())
    results = [dict(name="project_forward", route="cuda", source="gsjax_torch/csrc/project.cu",
                    replaces="none (gsjax/render/project.py and sh.py are XLA)",
                    max_abs_err=0.0, ms=b["fwd_ms"], plain_ms=b["plain_fwd_ms"],
                    bound_ms=b["fwd_bound"], bound_by="bytes", library_ms=None),
               dict(name="project_backward", route="cuda", source="gsjax_torch/csrc/project.cu",
                    replaces="none (autograd of gsjax/render/project.py and sh.py)",
                    max_abs_err=worst, ms=b["bwd_ms"], plain_ms=b["plain_bwd_ms"],
                    bound_ms=b["bwd_bound"], bound_by="bytes", library_ms=None)]
    return results, dict(errors=errors, shapes=shapes)

def app_launches(name: str, res: dict) -> dict:
    """The kernels an example app's run launches on the card (LAUNCHES
    keys, nonzero only): A, B and the projection once a measuring pass and
    once a render (a band's, in sharded_render) with the exact layout, C
    once a stream render, D, D's class sum and the projection's backward
    once a training step."""
    if name == "ply_converter":
        return {}
    passes, renders = res["demand"]["passes"], res["renders"]
    if name == "sharded_render":  # derive_shard_caps' pass; a render and a step of 8 bands
        ab = passes + 1 + 2 * 8
        # and derive_shard_caps' rect ranges, a projection without A or B
        return {"repeat": ab, "expand": ab, "project_fwd": ab + 1, "project_bwd": 8}
    want = {"repeat": passes + renders, "expand": passes + renders, "stream_fwd": renders,
            "project_fwd": passes + renders}
    if name == "train_fit":
        want.update(stream_bwd=len(res["losses"]), stream_class_sum=len(res["losses"]),
                    project_bwd=len(res["losses"]))
    return want


EXAMPLE_APPS = ("simple_viewer", "file_loader", "ply_converter", "scene_transformations",
                "camera_updates", "train_fit", "sharded_render")


def examples_on_cpu(tmp: str) -> None:
    """Phase 20a's CPU side, run in a process of its own beside the card's
    runs (EXAMPLE_CPU_THREADS threads: the rest of the host's cores drive
    the card): each app's run() on the CPU at the reference example's
    sizes, its outputs under tmp/<app>_cpu, its results pickled to
    tmp/cpu.pkl."""
    import importlib
    import pickle

    import torch

    torch.set_num_threads(EXAMPLE_CPU_THREADS)
    res = {}
    for name in EXAMPLE_APPS:
        app = importlib.import_module(f"gsjax_torch.examples.{name}")
        t0 = time.perf_counter()
        res[name] = app.run(device="cpu", out=os.path.join(tmp, f"{name}_cpu"))
        res[name]["s"] = time.perf_counter() - t0
        res[name]["dir"] = os.path.join(tmp, f"{name}_cpu")
    with open(os.path.join(tmp, "cpu.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def examples_phase(dev, card) -> dict:
    """20. The example apps (gsjax_torch.examples) on the card.

    20a: each app's run() at the reference example's own sizes on the
    card, and on the CPU in a process of its own started first
    (examples_on_cpu: it runs while the card runs 20a-20c): the card's
    float frames within C's gate of the CPU's; the .splat files by
    splat_close, two exp∘log round trips apart (transformed.splat's floats
    within 1e-6 of each column's peak); train_fit's loss0 within 1e-6 relative, view 0's loss falling
    on both, the two final losses within 2%; sharded_render's frame
    within 1e-5 and loss within 1e-5 relative; every overflow counter 0;
    the counters, zeroed before each card run and read after, as
    app_launches says (> 0 where it names a kernel).

    20b: the demo scene at EXAMPLE_SPLATS splats and SH degree
    EXAMPLE_SH_DEGREE written as .ply and .splat, then simple_viewer
    (.ply), file_loader (.splat and .ply), ply_converter,
    scene_transformations (.splat) and camera_updates (.ply) on those
    files: every overflow counter 0; the launches as in 20a; the orbit's frames distinct and
    lit; the .ply re-loads bit-equal to the scene, the .splat written
    back from the .ply (and converted.splat) bit-equal to the source
    .splat, the one from the .splat by splat_close, one exp∘log round trip
    from it; each app's seconds,
    peak GiB and measured demand printed.

    20c: `python -m gsjax_torch.examples.simple_viewer --out DIR` as a
    process of its own (EXAMPLE_TIMEOUT_S): rc 0 and 8 PNGs.

    The files live in a temporary directory that is removed afterwards."""
    import importlib
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    import gsjax_torch as gt
    from gsjax_torch import kernels
    from gsjax_torch.examples._common import OVERFLOW_KEYS, demo_scene
    from gsjax_torch.io.ply import save_ply

    apps = {name: importlib.import_module(f"gsjax_torch.examples.{name}")
            for name in EXAMPLE_APPS}
    zero = dict.fromkeys(OVERFLOW_KEYS, 0)
    out = {"20a": {}, "20b": {}}
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="examples_", dir=OUT_DIR)
    cpu_log = open(os.path.join(tmp, "cpu.log"), "w")
    cpu = subprocess.Popen([sys.executable, "-c", "import chip_smoke; "
                            f"chip_smoke.examples_on_cpu({tmp!r})"], cwd=ROOT,
                           stdout=cpu_log, stderr=subprocess.STDOUT)
    try:
        def read(path):
            with open(path, "rb") as fh:
                return fh.read()

        # 20a, the card's side: the reference examples' sizes
        card_res = {}
        for name, app in apps.items():
            where = os.path.join(tmp, f"{name}_card")
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = app.run(device=dev, out=where)
            torch.cuda.synchronize()
            res.update(s=time.perf_counter() - t0, dir=where,
                       launched=nonzero(kernels.LAUNCHES))
            card_res[name] = res
            check(res["overflow"] == zero, f"examples 20a {name}: overflow {res['overflow']}")
            want = app_launches(name, res)
            check(res["launched"] == want, f"examples 20a {name}: the card run launched "
                                           f"{res['launched']}, want {want}")

        # 20b: the demo scene at full size, through the file apps
        g = demo_scene(n=EXAMPLE_SPLATS, sh_degree=EXAMPLE_SH_DEGREE, device=dev)
        ply, splat = os.path.join(tmp, "demo.ply"), os.path.join(tmp, "demo.splat")
        t0 = time.perf_counter()
        save_ply(g, ply)
        src_splat = gt.save_splat(g, splat)
        print(f"# examples 20b: the demo scene, {EXAMPLE_SPLATS} splats at SH degree "
              f"{EXAMPLE_SH_DEGREE}: .ply {os.path.getsize(ply) / 1e6:.1f} MB, .splat "
              f"{len(src_splat) / 1e6:.1f} MB written in {time.perf_counter() - t0:.2f} s")
        back = gt.load_ply(ply, device=dev)
        check(same_fields(back, g), "examples 20b: the .ply does not re-load bit-equal")
        del back, g
        for name, src in (("simple_viewer", ply), ("file_loader", splat),
                          ("file_loader", ply), ("ply_converter", ply),
                          ("scene_transformations", splat), ("camera_updates", ply)):
            ext = os.path.splitext(src)[1][1:]
            where = os.path.join(tmp, f"full_{name}_{ext}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = apps[name].run(src, device=dev, out=where)
            torch.cuda.synchronize()
            line = dict(s=round(time.perf_counter() - t0, 3),
                        peak_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 3),
                        demand=res.get("demand"), overflow=res["overflow"],
                        launches=nonzero(kernels.LAUNCHES))
            check(res["overflow"] == zero, f"examples 20b {name} ({ext}): {res['overflow']}")
            want = app_launches(name, res)
            check(line["launches"] == want, f"examples 20b {name} ({ext}): launched "
                                            f"{line['launches']}, want {want}")
            if name == "simple_viewer":
                f = res["frames"]
                distinct = all(not np.array_equal(f[i], f[i + 1]) for i in range(len(f) - 1))
                lit = [float((fr.max(axis=-1) > 0.05).mean()) for fr in f]
                line["lit_share"] = [round(x, 3) for x in lit]
                check(len(f) == 8 and distinct and min(lit) > 0.01,
                      f"examples 20b orbit frames: distinct {distinct}, lit shares {lit}")
            if name in ("file_loader", "ply_converter"):
                fname = "scene_out.splat" if name == "file_loader" else "converted.splat"
                d = splat_diff(read(os.path.join(where, fname)), src_splat)
                line[fname] = d
                if ext == "ply":  # the .ply holds the scene's raw floats
                    check(d["bit_equal"], f"examples 20b {name} (ply): {fname} {d}")
                check(splat_close(d, 1), f"examples 20b {name} ({ext}): {fname} {d}")
            if name == "scene_transformations":
                check(len(read(res["paths"][2])) == len(src_splat),
                      "examples 20b: transformed.splat holds another number of rows")
            if name == "camera_updates":
                with open(res["paths"][2]) as fh:
                    cams = gt.cameras_from_json(fh.read(), device=dev)
                check(len(cams) == 2 and np.allclose(cams[1].position.cpu().numpy(),
                                                     apps[name].POSITION_1),
                      "examples 20b: camera.json does not load back to the two poses")
            out["20b"][f"{name} ({ext})"] = line
            print(f"# examples 20b {name} ({ext}): {line['s']:.2f} s, peak "
                  f"{line['peak_gib']:.2f} GiB, measured demand {line['demand']}; "
                  + "; ".join(f"{k} {v}" for k, v in line.items()
                              if k not in ("s", "peak_gib", "demand")))
            del res
            torch.cuda.empty_cache()

        # 20c: the app as a user runs it, a process of its own
        where = os.path.join(tmp, "process")
        t0 = time.perf_counter()
        pr = subprocess.run([sys.executable, "-m", "gsjax_torch.examples.simple_viewer",
                             "--out", where], cwd=ROOT, capture_output=True, text=True,
                            timeout=EXAMPLE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        folder = os.path.join(where, "simple_viewer")
        pngs = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
        last = pr.stdout.strip().splitlines()[-1] if pr.stdout.strip() else ""
        print(f"# examples 20c: python -m gsjax_torch.examples.simple_viewer: rc "
              f"{pr.returncode} in {secs:.1f} s, {len(pngs)} PNGs; its last line: {last}")
        check(pr.returncode == 0, f"examples 20c: rc {pr.returncode}: {pr.stderr[-2000:]}")
        check(pngs == [f"frame_{i:04d}.png" for i in range(8)], f"examples 20c: {pngs}")
        out["20c"] = dict(rc=pr.returncode, s=secs, pngs=len(pngs), last_line=last)

        # 20a, the CPU's side, against the card's
        t0 = time.perf_counter()
        rc = cpu.wait(timeout=EXAMPLE_CPU_TIMEOUT_S)
        cpu_log.close()
        with open(os.path.join(tmp, "cpu.log")) as fh:
            log = fh.read()
        check(rc == 0, f"examples 20a: the CPU runs failed (rc {rc}): {log[-3000:]}")
        with open(os.path.join(tmp, "cpu.pkl"), "rb") as fh:
            cpu_res = pickle.load(fh)
        print(f"# examples 20a: the CPU process ended {time.perf_counter() - t0:.1f} s "
              f"after 20c")
        for name in EXAMPLE_APPS:
            rc, rh = card_res[name], cpu_res[name]
            check(rh["overflow"] == zero, f"examples 20a {name} on the CPU: {rh['overflow']}")
            line = dict(card_s=round(rc["s"], 3), cpu_s=round(rh["s"], 3),
                        launches=rc["launched"], demand=rc.get("demand"))
            frames = {"simple_viewer": ("frames",), "file_loader": ("frame",),
                      "scene_transformations": ("before", "after"),
                      "camera_updates": ("frames",)}.get(name, ())
            for key in frames:
                a, b = (torch.from_numpy(np.asarray(r[key])) for r in (rc, rh))
                p999, dmax, ok = c_gate(a, b)
                line[key] = dict(p999=p999, max=dmax)
                check(ok, f"examples 20a {name}: {key} card vs cpu p99.9 {p999:.2e}, "
                          f"max {dmax:.2e}")
            if name in ("file_loader", "ply_converter"):
                fname = "scene_out.splat" if name == "file_loader" else "converted.splat"
                d = splat_diff(*(read(os.path.join(r["dir"], fname)) for r in (rc, rh)))
                line[fname] = d
                check(splat_close(d, 2), f"examples 20a {name}: {fname} card vs cpu {d}")
            if name == "scene_transformations":
                ra, rb = (np.frombuffer(read(r["paths"][2]), np.uint8).reshape(-1, 32)
                          for r in (rc, rh))
                fa, fb = (r[:, :24].copy().view(np.float32) for r in (ra, rb))
                rel = float((np.abs(fa - fb) / np.abs(fb).max(axis=0)).max())
                step = int(np.abs(ra[:, 24:].astype(int) - rb[:, 24:].astype(int)).max())
                line["transformed.splat"] = dict(rel_to_peak=rel, u8_step=step)
                check(rel <= 1e-6 and step <= 1,
                      f"examples 20a transformed.splat card vs cpu: {rel:.2e}, step {step}")
            if name == "camera_updates":
                check(rc["cameras"] == rh["cameras"], "examples 20a camera.json card vs cpu")
            if name == "train_fit":
                ratio = rc["loss1"] / rh["loss1"]
                line.update(loss0=(rc["loss0"], rh["loss0"]), loss1=(rc["loss1"], rh["loss1"]),
                            loss1_ratio=ratio)
                check(abs(rc["loss0"] - rh["loss0"]) <= 1e-6 * rh["loss0"],
                      f"examples 20a train_fit loss0 card {rc['loss0']} vs cpu {rh['loss0']}")
                check(rc["loss1"] < rc["loss0"] and rh["loss1"] < rh["loss0"],
                      f"examples 20a train_fit: the loss does not fall {line}")
                check(abs(ratio - 1) <= 0.02, f"examples 20a train_fit: loss1 ratio {ratio}")
            if name == "sharded_render":
                dmax = float(np.abs(rc["frame"] - rh["frame"]).max())
                rel = abs(rc["loss"] - rh["loss"]) / rh["loss"]
                line.update(frame_max=dmax, loss=(rc["loss"], rh["loss"]), loss_rel=rel)
                check(dmax <= 1e-5 and rel <= 1e-5,
                      f"examples 20a sharded_render card vs cpu: frame {dmax}, loss {rel}")
            out["20a"][name] = line
            print(f"# examples 20a {name}: card {rc['s']:.2f} s, cpu {rh['s']:.2f} s; "
                  + "; ".join(f"{k} {v}" for k, v in line.items()
                              if k not in ("card_s", "cpu_s")))
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
        cpu_log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out

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
    from gsjax_torch.bench.run import orbit_cameras, perturb
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.render import binning, flat, homesort, stream
    from gsjax_torch.render.common import depth_bits
    from gsjax_torch.render.composite import (assemble_band, att_table,
                                              clipped_pair_stream)
    from gsjax_torch.io import native
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
    # both libraries side by side (every nvcc at once) and the native PLY
    # parser (the host C++ compiler), each timed: the path's time is the
    # cold start of a first render() or train step
    t0 = time.perf_counter()

    def build(library):
        if library == "baseline":
            path = blend_fwd_variants.build_variant(library)
        elif library == "native":
            path = native.build()
        else:
            path = kernels.build(library)
        return os.path.relpath(path, ROOT), time.perf_counter() - t0

    libraries = tuple(kernels.SOURCES) + ("baseline", "native")
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        built = dict(zip(libraries, pool.map(build, libraries)))
    for library in kernels.SOURCES:
        kernels.lib(library)
    native.lib()
    base_path = os.path.join(ROOT, built["baseline"][0])
    print(f"# build: {time.perf_counter() - t0:.2f} s; "
          + "; ".join(f"{library} library ready after {t:.2f} s -> {path}"
                      for library, (path, t) in built.items()))

    # 3-5. scene, cameras, config -------------------------------------------
    t0 = time.perf_counter()
    g = bonsai_like(n=N_SPLATS, seed=0, sh_degree=0, device=dev)
    cams = orbit_cameras(30, WIDTH, HEIGHT, device=dev)
    cfg = gt.RenderConfig(backend="stream", chunk=128, fat_cap=R05_FAT_CAP,
                          fat_live_cap=R05_LIVE_CAP)
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
        a_args = (src18, fb, fbe, n_copies, R05_FAT_CAP, tiles_x, tiles_y,
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
        bound_a = bound(nf * 21 * 4 + nbytes(tail_k, keys_k), OPS_PER_SLOT_A * R05_FAT_CAP)
        bound_a_old = bound(nf * 21 * 4 + nbytes(tail_k) + 8 * R05_FAT_CAP * 4, 130 * R05_FAT_CAP)
        print(f"# A repeat: fat parents {nf}, copy slots "
              f"{int(n_copies)} of {R05_FAT_CAP}, live copies {n_live_copies} of "
              f"{R05_LIVE_CAP}: bit-equal to the plain version, two launches bit-equal; "
              f"bound {bound_a[0]:.4f} ms ({bound_a[1]}; the earlier count, with a "
              f"search a slot and 8 key rows: {bound_a_old[0]:.4f})")
        launch_a = (src18, fb, fbe,
                    homesort.cull_threshold(src18[:, 6], cfg.alpha_min).contiguous(),
                    torch.as_tensor(n_copies, dtype=torch.int64, device=dev), R05_FAT_CAP,
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
    torch.cuda.empty_cache()

    # 13. scene IO on the card at full size ----------------------------------
    t0 = time.perf_counter()
    scene_io = io_phase(cfg, cams[0].to(dev), dev, card)
    print(f"# io: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 14. autotune over bench.py's 30-view orbit: kernels A and B a view -----
    t0 = time.perf_counter()
    tuned = autotune_phase(g, cams, dev, card)
    print(f"# autotune: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 15. garden on the card: derived caps, a render, lazy steps -------------
    t0 = time.perf_counter()
    garden = garden_phase(dev, card)
    print(f"# garden: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 16. the reference backends (oracle, xla) against stream and pallas ----
    t0 = time.perf_counter()
    reference = reference_phase(dev, card)
    print(f"# reference: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 17. legacy mode (footprint_clamp=True) through C-F ---------------------
    t0 = time.perf_counter()
    legacy = legacy_phase(dev, card)
    print(f"# legacy: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 18. the viewer loop: controls, then render, a frame at a time ----------
    t0 = time.perf_counter()
    viewer = viewer_phase(g, cfg, dev, card)
    print(f"# viewer: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # 19. the tile-sharded path: bands, the equalized step, the dryrun ---
    t0 = time.perf_counter()
    sharded = sharded_phase(g, cams, cfg, dev, card, train["stream"])
    print(f"# sharded: {time.perf_counter() - t0:.2f} s")
    del g
    torch.cuda.empty_cache()

    # 20. the example apps: the reference's sizes card vs CPU, full size ---
    t0 = time.perf_counter()
    examples = examples_phase(dev, card)
    print(f"# examples: {time.perf_counter() - t0:.2f} s")

    # 21. the projection pair at the cells' shapes --------------------------
    t0 = time.perf_counter()
    proj_results, projection = projection_phase(dev, card)
    results += proj_results
    print(f"# projection: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    # A-F and the projection pair: kernel → the training run its launches
    # are read from (A, B: both); the probes G-J: their runs in phase 11
    key = {"repeat_fat_parents": ("stream", "repeat"), "expand_pairs": ("stream", "expand"),
           "stream_forward": ("stream", "stream_fwd"),
           "stream_backward": ("stream", "stream_bwd"),
           "stream_class_sum": ("stream", "stream_class_sum"),
           "slots_forward": ("pallas", "slots_fwd"), "slots_backward": ("pallas", "slots_bwd"),
           "project_forward": ("stream", "project_fwd"),
           "project_backward": ("stream", "project_bwd")}
    for r in results:
        backend, counter = key[r["name"]]
        r["launches"] = train[backend]["launches"][counter]
        r["run"] = "its path's training run"
        if backend == "stream":  # phase 19's equalized step: once a band
            r["sharded_launches"] = sharded["launches"][counter]
            # phase 20: the example apps' card runs at the reference's sizes
            r["examples_launches"] = sum(line["launches"].get(counter, 0)
                                         for line in examples["20a"].values())
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
                       probes=probe_detail, lazy=lazy, scene_io=scene_io, autotune=tuned,
                       garden=garden, reference=reference, legacy=legacy, viewer=viewer,
                       sharded=sharded, examples=examples, projection=projection),
                  fh, indent=1)

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
