"""The port's training benchmark: bench.py's modes on the card, through
gsjax_torch.

    python -m gsjax_torch.bench.run                      # --mode orbit: lazy, 30 views
    python -m gsjax_torch.bench.run --mode orbit-exact   # per frame exact, 30 views
    python -m gsjax_torch.bench.run --mode fixed         # fixed camera, black target
    python -m gsjax_torch.bench.run --mode fixed-lazy --frames 64 --resort-every 16
    python -m gsjax_torch.bench.run --backend pallas --mode orbit-exact  # flat kernels
    python -m gsjax_torch.bench.run --backend xla --quick --mode fixed  # the reference blend
    python -m gsjax_torch.bench.run --scene garden       # 5M splats, SH degree 2
    python -m gsjax_torch.bench.run --quick --mode orbit --views 2 --device cpu

orbit (the default, bench.py's headline): the clean bonsai-scale scene
renders each orbit view's target; a perturbed copy (`perturb`) then
trains through lazy frame plans (render/lazy.py): at each view a resort
(fold back, frame plan, extract), then --steps-per-view lazy steps that
reuse its layout with fresh attributes (kernels C and D; the resort runs
A and B). orbit-exact: one per-frame-exact fwd + bwd + Adam step at every
view, in order. fixed: --frames exact steps at the bench camera toward a
black target. fixed-lazy: --frames lazy steps at the bench camera toward
its render, a resort every --resort-every steps. Every view's (every
resort's) overflow counters must read 0, or the run fails. --backend
picks the blend of the exact modes, as bench.py's flag does: stream
(kernels C, D; the default), pallas (the flat slot-stream kernels E, F)
or xla (the padded-list reference blend in plain PyTorch, bench.py's
tile_list_cap: 512 with --quick, else 1024; its n_tile_overflow is
gated like every counter, so at bonsai's full size, ~1,150 pairs a tile
on average, it fails the gate as bench.py's would); the lazy modes need
stream. --quick shrinks the scene (50,000 splats
at 640×480 unless --n / --width / --height say otherwise) and keeps the
mode (bench.py's --quick runs the fixed mode whatever --mode says; here
every mode has a small run, for the CPU tests).

--scene: bonsai (bonsai_like, 1.2M splats, SH degree 0; bench.py's
headline) or garden (garden_like, 5M splats, SH degree 2: BASELINE's
config-4 scale). Garden's targets are kept on the host as bf16 and
uploaded one per view, as bench.py keeps them.

The fat-split and pair budgets come from core/autotune.derive_caps over
the run's cameras (sized for the worst view, bench.py's rule), measured
at the base caps --fat-cap / --fat-live-cap (None: scaled with the
scene); the runner prints bench.py's `# autotune` line. bench.py derives
for its stream backend only, because the TPU's band scratch needs it;
the port has no band scratch and its fat caps serve every blend, so it
derives for pallas and xla too. --no-autotune renders at --fat-cap /
--fat-live-cap themselves.

Prints one JSON line, bench.py's {"metric": "1080p_fwd_bwd_ms_per_frame",
"value": ms, "unit": "ms", "mode": ..., "scene": ..., "loss0": ..., ...}
plus "device" (the card's name and power limit) and "peak_gib" (the
card's peak allocated memory; null on the CPU). There is no
"vs_baseline": bench.py's divides by a TPU target.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core.autotune import derive_caps, measure_occupancy
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.lazy import LazyTrainer
from gsjax_torch.render.pipeline import render
from gsjax_torch.bench.synth import bench_camera, bonsai_like, garden_like
from gsjax_torch.train import make_step_fn

SWEEP_DEG = 30.0  # bench.py's default orbit sweep, ~1°/view at 30 views
OVERFLOW_KEYS = ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
                 "n_fat_overflow", "n_clamped")


def perturb(g: Gaussians, seed: int = 7) -> Gaussians:
    """bench.py::perturb: small noise on means, SH and opacity logits (the
    same numpy draws in the same order), as a new module."""
    rng = np.random.default_rng(seed)

    def noisy(p, sd):
        noise = rng.normal(0, sd, tuple(p.shape)).astype("float32")
        return p.detach() + torch.from_numpy(noise).to(p.device)

    means = noisy(g.means, 2e-3)
    sh = noisy(g.sh, 2e-2)
    opacity_logits = noisy(g.opacity_logits, 5e-2)
    return Gaussians(means, g.log_scales.detach().clone(),
                     g.quats.detach().clone(), sh, opacity_logits)


def orbit_cameras(views: int, width: int, height: int, device="cuda"):
    """bench.py::orbit_cameras at its default sweep: `views` cameras over
    SWEEP_DEG of azimuth, view 0 at the fixed bench pose."""
    r = float(np.hypot(4.0, 0.6))
    beta = float(np.arcsin(-0.6 / r))
    oc = OrbitCamera(alpha=float(np.pi), beta=beta, radius=r, target=(0.0, 0.0, 0.0))
    return oc.trajectory(views, alpha_end=float(np.deg2rad(SWEEP_DEG)), fx=1600.0,
                         fy=1600.0, width=width, height=height, device=device)


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small scene smoke run (the mode stays)")
    ap.add_argument("--n", type=int, default=None, help="splat count")
    ap.add_argument("--mode", default="orbit",
                    choices=["orbit", "orbit-exact", "fixed", "fixed-lazy"])
    ap.add_argument("--backend", default="stream", choices=["stream", "pallas", "xla"],
                    help="the blend: stream (kernels C, D), xla (the padded-list "
                    "reference blend, plain PyTorch) or pallas (the flat "
                    "slot-stream kernels E, F)")
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--steps-per-view", type=int, default=16,
                    help="orbit: lazy steps per view (a resort at each view)")
    ap.add_argument("--frames", type=int, default=10,
                    help="fixed and fixed-lazy modes: steps")
    ap.add_argument("--resort-every", type=int, default=16,
                    help="fixed-lazy: the resort cadence")
    ap.add_argument("--width", type=int, default=None,
                    help="default 1920 (640 with --quick)")
    ap.add_argument("--height", type=int, default=None,
                    help="default 1080 (480 with --quick)")
    ap.add_argument("--forward-only", action="store_true",
                    help="time the forward only")
    ap.add_argument("--scene", default="bonsai", choices=["bonsai", "garden"],
                    help="bonsai: 1.2M splats, SH degree 0 (the headline scene); "
                    "garden: 5M splats, SH degree 2 (config-4 scale)")
    ap.add_argument("--fat-cap", type=int, default=None,
                    help="copy-enumeration budget: the measuring pass's base, or "
                    "with --no-autotune the run's (default: scaled with the scene)")
    ap.add_argument("--fat-live-cap", type=int, default=None,
                    help="live copy rows: as --fat-cap")
    ap.add_argument("--no-autotune", action="store_true",
                    help="skip the occupancy pre-pass (core/autotune.derive_caps) "
                    "and render at --fat-cap / --fat-live-cap")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch versions, "
                    "for tests; a CPU time is not a device time")
    args = ap.parse_args(argv)

    mode = args.mode
    lazy = mode in ("orbit", "fixed-lazy")
    if lazy and (args.backend != "stream" or args.forward_only):
        raise SystemExit(f"--mode {mode} trains lazy steps through the stream backend "
                         "(no --backend pallas or xla, no --forward-only)")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    garden = args.scene == "garden"
    if args.quick:
        n, width, height = args.n or 50_000, args.width or 640, args.height or 480
    else:
        n = args.n or (5_000_000 if garden else 1_200_000)
        width, height = args.width or 1920, args.height or 1080
    cfg = RenderConfig(backend=args.backend, chunk=128,
                       tile_list_cap=512 if args.quick else 1024, fat_cap=args.fat_cap,
                       fat_live_cap=args.fat_live_cap)
    if garden:
        g = garden_like(n=n, sh_degree=2, device=dev)
    else:
        g = bonsai_like(n=n, sh_degree=0, device=dev)
    if mode in ("orbit", "orbit-exact"):
        cams = orbit_cameras(args.views, width, height, device=dev)
    else:
        cams = [bench_camera(width=width, height=height, device=dev)]
    if not args.no_autotune:  # sized for the worst view of the run
        _sync(dev)
        t0 = time.perf_counter()
        cfg = autotune(g, cams, cfg)
        _sync(dev)
        print(f"# autotune {time.perf_counter() - t0:.1f}s over {len(cams)} view(s): "
              f"pair_cap={cfg.pair_cap} repack_w={cfg.repack_w} "
              f"repack_rows={cfg.repack_rows} band_cap={cfg.stream_band_cap} "
              f"blkw={cfg.stream_block_tiles} fat_cap={cfg.fat_cap} "
              f"live_cap={cfg.fat_live_cap}", file=sys.stderr)

    extra = {"mode": mode, "backend": args.backend, "scene": args.scene}
    if mode == "fixed":
        targets = [torch.zeros((height, width, 3), dtype=torch.float32, device=dev)]
        g_train = g
    else:
        with torch.no_grad():
            # garden keeps its targets on the host as bf16 (bench.py's
            # rule: 30 device targets beside the 5M-splat home state)
            targets = [render(g, cam, cfg).to("cpu", torch.bfloat16) if garden
                       else render(g, cam, cfg) for cam in cams]
        black = float(torch.mean(targets[0].double() ** 2))
        print(f"# targets: {len(targets)} view renders; black-target loss of "
              f"view 0 = {black:.6f}", file=sys.stderr)
        extra["black_loss0"] = round(black, 5)
        g_train = perturb(g)
        del g

    if lazy:  # every resort's budgets are gated there
        return run_lazy(args, g_train, cams, cfg, targets, dev, extra)

    # every view's budgets must hold: an overflow means dropped work
    with torch.no_grad():
        ovf = {}
        for cam in cams:
            aux = render(g_train, cam, cfg, return_aux=True)[1]
            for k in OVERFLOW_KEYS:
                if k in aux:  # bench.py's rule: the keys the backend reports
                    ovf[k] = ovf.get(k, 0) + int(aux[k])
    print(f"# overflow over {len(cams)} view(s): {ovf} (must be 0)", file=sys.stderr)
    if any(ovf.values()):
        print("# FAIL: overflow counters nonzero; raise --fat-cap / "
              "--fat-live-cap", file=sys.stderr)
        return 1

    opt = torch.optim.Adam(g_train.parameters(), lr=1e-3)  # bench.py: optax.adam(1e-3)
    if args.forward_only:
        def make_step(cam):
            def step(g, target):
                with torch.no_grad():
                    return torch.mean(render(g, cam, cfg))
            return step
    else:
        make_step = lambda cam: make_step_fn(cam, cfg, opt)
    steps = [make_step(cam) for cam in cams]

    t0 = time.perf_counter()
    tgt0 = on_device(targets[0], dev)
    loss = steps[0](g_train, tgt0)  # warm-up: kernel build, caches
    loss0 = float(loss)
    print(f"# mode={mode} backend={args.backend} n={n} {width}x{height} on "
          f"{device_label(dev)}: "
          f"warm-up {time.perf_counter() - t0:.1f}s loss0={loss0:.6f}",
          file=sys.stderr)

    _sync(dev)
    t0 = time.perf_counter()
    if mode == "orbit-exact":
        for i, step in enumerate(steps):
            loss = step(g_train, on_device(targets[i], dev))
        extra.update(views=len(cams), sweep_deg=SWEEP_DEG)
        n_steps = len(cams)
    else:
        for _ in range(args.frames):
            loss = steps[0](g_train, tgt0)
        extra.update(frames=args.frames)
        n_steps = args.frames
    final = float(loss)  # waits for the device
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    extra.update(loss0=round(loss0, 5), final_loss=round(final, 5))
    print_result(ms, extra, dev)
    return 0


def autotune(g: Gaussians, cams, cfg: RenderConfig) -> RenderConfig:
    """derive_caps over `cams`, measured at cfg's fat caps. Where those
    overflow (a scene whose splats are large for its count, as garden_like
    is at a small n), the base grows to the measured copy demand (every
    copy slot a live row) and the views are measured again; derive_caps
    still raises if that pass overflows (fat_max_blocks)."""
    ms = [measure_occupancy(g, c, cfg) for c in cams]
    if any(m["n_fat_overflow"] for m in ms):
        demand = -(-max(m["n_copies"] for m in ms) // 8192) * 8192
        print(f"# autotune: the base fat caps overflowed "
              f"({[m['n_fat_overflow'] for m in ms]}); measuring again at fat_cap = "
              f"fat_live_cap = {demand}, the copy demand", file=sys.stderr)
        base = dataclasses.replace(cfg, fat_cap=demand, fat_live_cap=demand)
        ms = [measure_occupancy(g, c, base) for c in cams]
    return derive_caps(g, cams, cfg, ms=ms)


def on_device(target: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A view's target as the loss reads it: float32 on the device (a
    host-resident bf16 target uploads here; a device one passes as is)."""
    return target.to(dev, torch.float32)


def print_result(ms: float, extra: dict, dev: torch.device) -> None:
    """bench.py's JSON line, with the card's name and power limit and its
    peak allocated memory."""
    peak = (round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)
            if dev.type == "cuda" else None)
    print(json.dumps({"metric": "1080p_fwd_bwd_ms_per_frame", "value": round(ms, 3),
                      "unit": "ms", **extra, "device": device_label(dev),
                      "peak_gib": peak}))


def clone(g: Gaussians) -> Gaussians:
    return Gaussians(*(p.detach().clone() for p in g.parameters()))


def run_lazy(args, g, cams, cfg, targets, dev, extra) -> int:
    """bench.py::run_lazy: the lazy modes. A warm-up trainer on a copy of
    g (resort, step, resort, step: the kernels' build, the fold) gives
    loss0, the first step's loss, which is the exact path's; a fresh
    trainer on g makes the timed run. orbit: a resort at each view, then
    --steps-per-view steps, the device synchronised every 8 views as
    bench.py does (every view when the targets are on the host, each
    uploaded at its view); fixed-lazy: --frames steps at the bench camera, a
    resort every --resort-every. Every resort's overflow counters must
    read 0. Prints bench.py's JSON line."""
    def adam(g):
        return torch.optim.Adam(g.parameters(), lr=1e-3)  # bench.py: optax.adam(1e-3)

    t0 = time.perf_counter()
    g_warm = clone(g)
    tr = LazyTrainer(g_warm, cfg, adam(g_warm))
    tgt0 = on_device(targets[0], dev)
    tr.resort(cams[0])
    loss0 = float(tr.step(tgt0, cams[0]))
    tr.resort(cams[0])  # the fold
    tr.step(tgt0, cams[0])
    tr.sync()
    _sync(dev)
    del tr, g_warm
    print(f"# mode={args.mode} backend=stream n={g.means.shape[0]} "
          f"{cams[0].width}x{cams[0].height} on {device_label(dev)}: warm-up "
          f"{time.perf_counter() - t0:.1f}s loss0={loss0:.6f}", file=sys.stderr)

    tr = LazyTrainer(g, cfg, adam(g))
    ovfs = []
    _sync(dev)
    t0 = time.perf_counter()
    if args.mode == "orbit":
        spv = args.steps_per_view
        sync_every = 8 if targets[0].device.type == dev.type else 1
        for i, cam in enumerate(cams):
            tgt = on_device(targets[i], dev)
            ovfs.append(tr.resort(cam).ovf)
            for _ in range(spv):
                loss = tr.step(tgt, cam)
            if i % sync_every == sync_every - 1:
                _sync(dev)
        n_steps = len(cams) * spv
        extra.update(views=len(cams), steps_per_view=spv, sweep_deg=SWEEP_DEG,
                     loss0=round(loss0, 5), resorts=len(cams))
    else:
        k = args.resort_every
        for s in range(args.frames):
            if s % k == 0:
                ovfs.append(tr.resort(cams[0]).ovf)
            loss = tr.step(tgt0, cams[0])
        n_steps = args.frames
        extra.update(frames=n_steps, resort_every=k, loss0=round(loss0, 5))
    tr.sync()
    final = float(loss)  # waits for the device
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    if gate_overflow(ovfs):
        return 1
    extra["final_loss"] = round(final, 5)
    print_result(ms, extra, dev)
    return 0


def gate_overflow(ovfs) -> bool:
    """bench.py::_gate_overflow: every resort's overflow counters summed
    (read from the card once, after the run); prints them and returns
    True when any is nonzero (work was dropped, so the run fails)."""
    tot = {}
    for o in ovfs:
        for k, v in o.items():
            if k.startswith("n_") and k != "n_pairs":
                tot[k] = tot.get(k, 0) + int(v)
    bad = sum(tot.values())
    print(f"# overflow over {len(ovfs)} resort(s): {bad} (must be 0) {tot}", file=sys.stderr)
    if bad:
        print("# FAIL: overflow counters nonzero; raise --fat-cap / --fat-live-cap",
              file=sys.stderr)
    return bad > 0


if __name__ == "__main__":
    sys.exit(main())
