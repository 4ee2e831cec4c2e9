#!/usr/bin/env python3
"""Drive gsjax_torch's serving path once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — compile the CUDA kernels from gsjax_torch/csrc;
  3. scene   — bonsai_like(n=1,200,000, seed=0, sh_degree=0) on cuda:0;
  4. cameras — bench.py's 1080p orbit: 30 views over 30° of azimuth;
  5. config  — stream backend, chunk 128, fat_cap 2,342,912,
               fat_live_cap 1,617,920 (the copy budgets an autotune pass
               measured for this orbit; autotune is not ported yet);
  6. kernels — on view 0, each kernel against its plain PyTorch version
               at the path's shapes: repeat (A) and expand (B) bit-equal,
               the stream blend (C) within 2e-5 at the 99.9th percentile;
               times of both; then small scenes with the cases the
               bonsai view lacks (empty tiles, an image that is no
               multiple of the tile size, counted fat overflow), the
               card's kernel path against the CPU's plain path;
  7. serve   — zero the launch counters, render views 0-3 through
               render_trajectory, read the counters: every kernel must
               have launched once per frame; frames finite; every
               overflow counter 0; view 0's mean(img²) = 0.41342 ± 0.1%
               (the reference's black-target loss of this view);
  8. timing  — median ms/frame and the per-stage split.
Prints the kernels' JSON line, then the card's name and power limit, then
the result line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

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
FAT_CAP, LIVE_CAP = 2_342_912, 1_617_920
BLACK_LOSS0 = 0.41342  # mean(img²) of orbit view 0 in the reference
SERVE_VIEWS = 4
DEVICE = "cuda:0"


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
                                    opacities=rng.uniform(0.3, 0.95, n), sh=sh)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def orbit_cameras(views: int, width: int, height: int, sweep_deg: float = 30.0):
    """bench.py::orbit_cameras with the port's OrbitCamera."""
    import numpy as np

    from gsjax_torch import OrbitCamera

    r = float(np.hypot(4.0, 0.6))
    beta = float(np.arcsin(-0.6 / r))
    oc = OrbitCamera(alpha=float(np.pi), beta=beta, radius=r, target=(0.0, 0.0, 0.0))
    return oc.trajectory(views, alpha_end=float(np.deg2rad(sweep_deg)),
                         fx=1600.0, fy=1600.0, width=width, height=height)


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


def staged_render(g, cam, cfg):
    """pipeline.render, one stage at a time with a synchronize after
    each: (img, aux, {stage: ms})."""
    import torch

    from gsjax_torch.render.binning import build_tile_bins
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
    img, aux = composite_tiles_stream(ph, layout, bins, cam, cfg)
    lap("blend")
    return img[: cam.height, : cam.width], aux, ms, (p, ph, layout, bins)


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
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.render import binning, homesort, stream
    from gsjax_torch.render.composite import att_table, clipped_pair_stream

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
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    print(f"# build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, ROOT)}")

    # 3-5. scene, cameras, config -------------------------------------------
    t0 = time.perf_counter()
    g = bonsai_like(n=N_SPLATS, seed=0, sh_degree=0, device=dev)
    cams = orbit_cameras(30, WIDTH, HEIGHT)
    cfg = gt.RenderConfig(backend="stream", chunk=128, fat_cap=FAT_CAP,
                          fat_live_cap=LIVE_CAP)
    torch.cuda.synchronize()
    print(f"# scene: {N_SPLATS} splats, {len(cams)} orbit views at "
          f"{WIDTH}x{HEIGHT}, set-up {time.perf_counter() - t0:.2f} s")

    # 6. kernels vs their plain versions on view 0 ---------------------------
    results = []
    with torch.no_grad():
        cam0 = cams[0].to(dev)
        _, aux0, _, (p, ph, layout, bins) = staged_render(g, cam0, cfg)
        tiles_x, tiles_y = cfg.tiles_x(WIDTH), cfg.tiles_y(HEIGHT)

        src18, fb, fbe, n_copies = homesort.fat_repeat_inputs(p, tiles_x, tiles_y, cfg)
        a_args = (src18, fb, fbe, n_copies, FAT_CAP, tiles_x, tiles_y,
                  cfg.tile_span, cfg.tile_size, cfg.alpha_min)
        tail_k, keys_k = homesort.repeat_fat_parents(*a_args)
        tail_p, keys_p = homesort.repeat_fat_parents_plain(*a_args)
        err_a = max(float((tail_k - tail_p).abs().max()),
                    float((keys_k - keys_p).abs().max()))
        check(torch.equal(tail_k, tail_p) and torch.equal(keys_k, keys_p),
              f"kernel A (repeat) differs from its plain version: {err_a}")
        n_live_copies = int((keys_k[0] < tiles_x * tiles_y).sum())
        print(f"# A repeat: fat parents {int((fb < 2**30).sum())}, copy slots "
              f"{int(n_copies)} of {FAT_CAP}, live copies {n_live_copies} of "
              f"{LIVE_CAP}: bit-equal")
        results.append(dict(
            name="repeat_fat_parents", route="cuda",
            source="gsjax_torch/csrc/repeat.cu",
            replaces="gsjax/render/homesort.py:125",
            max_abs_err=err_a,
            ms=cuda_ms(lambda: homesort.repeat_fat_parents(*a_args), 20),
            plain_ms=cuda_ms(lambda: homesort.repeat_fat_parents_plain(*a_args), 5),
        ))

        cols = binning.expand_cols(ph, layout, cfg)
        b_args = (cols, 0, tiles_y, tiles_x, cfg.tile_size, cfg.tile_span)
        tile_k, pid_k = binning.expand_pairs(*b_args)
        tile_p, pid_p = binning.expand_pairs_plain(*b_args)
        err_b = float((tile_k.to(torch.int64) - tile_p).abs().max())
        check(torch.equal(tile_k, tile_p) and torch.equal(pid_k, pid_p),
              f"kernel B (expand) differs from its plain version: {err_b}")
        print(f"# B expand: home rows {ph.depth.shape[0]} (padded "
              f"{cols.shape[1]}), live pairs "
              f"{int((tile_k != binning.INVALID_TILE).sum())}: bit-equal")
        results.append(dict(
            name="expand_pairs", route="cuda",
            source="gsjax_torch/csrc/expand.cu",
            replaces="gsjax/render/binning.py:51",
            max_abs_err=err_b,
            ms=cuda_ms(lambda: binning.expand_pairs(*b_args), 20),
            plain_ms=cuda_ms(lambda: binning.expand_pairs_plain(*b_args), 5),
        ))

        att = att_table(ph).contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg)
        c_args = (att, pid, starts, 0, tiles_x, cfg)
        out_k = stream.stream_forward(*c_args)
        out_p = stream.stream_forward_plain(*c_args)
        d = (out_k[:, 0:4] - out_p[:, 0:4]).abs()
        err_c = float(d.max())
        p999 = float(torch.quantile(d.flatten()[:: max(1, d.numel() // 8_000_000)], 0.999))
        n_done_diff = int((out_k[:, 5, 0] != out_p[:, 5, 0]).sum())
        c_diff = float((out_k[:, 4] - out_p[:, 4]).abs().max())
        counts = starts[1:] - starts[:-1]
        print(f"# C stream blend: {bins.pid_sorted.shape[0]} pairs over "
              f"{tiles_x * tiles_y} tiles (max {int(counts.max())} per tile, "
              f"{int((counts == 0).sum())} empty); |img, T_act| diff p99.9 "
              f"{p999:.3e} max {err_c:.3e}; C max diff {c_diff:.3e}; n_done "
              f"differs on {n_done_diff} tiles; mean chunks run "
              f"{float(out_k[:, 5, 0].mean()):.2f} of "
              f"{float((-(-counts // cfg.chunk)).float().mean()):.2f}")
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
        ))
        del src18, fb, fbe, tail_k, tail_p, keys_k, keys_p, cols
        del tile_k, tile_p, pid_k, pid_p, out_k, out_p, d, p, ph, layout, bins

        # 6b. edge cases the bonsai view lacks, at the CPU tests' small
        # shapes: the card's kernel path against the CPU's plain path on
        # the same raw parameters
        for name, scene_kw, cfg_kw, (w, h) in EDGE_CASES:
            gc = small_scene(np.random.default_rng(7), **scene_kw)
            gg = gt.Gaussians.from_numpy(
                *(getattr(gc, f).detach().numpy() for f in RAW_FIELDS), device=dev
            )
            cam = gt.Camera.create(fx=80.0, fy=80.0, width=w, height=h)
            cfg_e = gt.RenderConfig(backend="stream", chunk=32, **cfg_kw)
            img_c, aux_c = gt.render(gc, cam, cfg_e, return_aux=True)
            img_g, aux_g = gt.render(gg, cam, cfg_e, return_aux=True)
            d = (img_g.cpu() - img_c).abs()
            counters = {k: (int(aux_g[k]), int(aux_c[k])) for k in
                        ("n_pairs", "n_fat_overflow", "n_pair_overflow")}
            print(f"# edge case {name} {w}x{h}: |card - cpu| p99.9 "
                  f"{float(torch.quantile(d.flatten(), 0.999)):.3e} max "
                  f"{float(d.max()):.3e}; (card, cpu) {counters}")
            check(float(torch.quantile(d.flatten(), 0.999)) <= 2e-5 and
                  float(d.max()) <= 5e-3, f"edge case {name}: card vs cpu {float(d.max())}")
            check(all(a == b for a, b in counters.values()),
                  f"edge case {name}: counters differ {counters}")
            if name == "overflow":
                check(counters["n_fat_overflow"][0] > 0, "overflow not counted")

    # 7. serve: the main path through the user's entry point ---------------
    gt.render_trajectory(g, cams[:1], cfg)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    frames = gt.render_trajectory(g, cams[:SERVE_VIEWS], cfg)
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(f"# serve: render_trajectory({SERVE_VIEWS} views) {serve_s * 1e3:.1f} ms "
          f"({serve_s * 1e3 / SERVE_VIEWS:.1f} ms/frame incl. device-to-host "
          f"copy); launches {launches}")
    for name, n in launches.items():
        check(n == SERVE_VIEWS, f"kernel {name} launched {n} times over "
              f"{SERVE_VIEWS} frames (want one per frame)")
    check(frames.shape == (SERVE_VIEWS, HEIGHT, WIDTH, 3), f"frames {frames.shape}")
    check(bool(np.isfinite(frames).all()), "non-finite pixels")
    loss0 = float(np.mean(frames[0].astype(np.float64) ** 2))
    rel = abs(loss0 - BLACK_LOSS0) / BLACK_LOSS0
    print(f"# view 0 mean(img^2) = {loss0:.6f} (reference {BLACK_LOSS0}, "
          f"rel diff {rel:.2e})")
    check(rel <= 1e-3, f"view 0 mean(img^2) {loss0} not within 0.1% of {BLACK_LOSS0}")
    os.makedirs(OUT_DIR, exist_ok=True)
    from gsjax_torch.utils.image import write_png

    write_png(os.path.join(OUT_DIR, "view0.png"), frames[0])
    for r in results:
        r["launches"] = launches[{"repeat_fat_parents": "repeat",
                                  "expand_pairs": "expand",
                                  "stream_forward": "stream_fwd"}[r["name"]]]

    # 8. timing ------------------------------------------------------------
    frame_ms, stages = [], {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for rep in range(2):
            for v in range(SERVE_VIEWS):
                cam = cams[v].to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gt.render(g, cam, cfg)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                img, aux, ms, _ = staged_render(g, cam, cfg)
                for k, x in ms.items():
                    stages.setdefault(k, []).append(x)
                if rep == 0:
                    ovf = {k: int(aux[k]) for k in aux if k.startswith("n_") and
                           k.endswith("overflow")}
                    check(all(x == 0 for x in ovf.values()),
                          f"view {v}: overflow {ovf}")
                    check(bool(torch.isfinite(img).all()), f"view {v}: non-finite")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    split = {k: round(statistics.median(x), 3) for k, x in stages.items()}
    print(f"# timing on {card}: median {statistics.median(frame_ms):.3f} ms/frame "
          f"over {len(frame_ms)} renders of views 0-{SERVE_VIEWS - 1} "
          f"(render() with synchronize); stage split (median ms) {split}; "
          f"peak device memory {peak_gb:.2f} GiB; overflow counters 0; "
          f"pairs view 0 {int(aux0['n_pairs'])}")
    for r in results:
        print(f"# kernel {r['name']} on {card}: {r['ms']:.3f} ms vs plain "
              f"{r['plain_ms']:.3f} ms, max |err| {r['max_abs_err']:.3e}, "
              f"{r['launches']} launches in the serve run")
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump(dict(card=card, kind=kind, kernels=results, frame_ms=frame_ms,
                       stages_ms=stages, peak_gib=peak_gb, loss0=loss0), fh, indent=1)

    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
