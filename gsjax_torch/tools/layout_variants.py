"""Time the layout kernels A (csrc/repeat.cu) and B (csrc/expand.cu) at
the bonsai 1080p orbit's view 0, their variants, and the bins stage's
span around B, piece by piece.

    python -m gsjax_torch.tools.layout_variants [--variants a+row-stores,b+no-lookback,...]

A variant is a copy of repeat.cu or expand.cu with its text edited (every
edit's text must occur exactly as often as it expects, so a variant never
silently times the shipped kernel), built into a library of its own under
gsjax_torch/_build/variants, all at once, and swapped in for its kernel's
entry point. For each this prints ptxas's registers, the device time of
the kernel's launch alone (A without its wrapper's cull thresholds, B
without the read of its live count), and whether the wrapper's outputs
equal the shipped kernel's (an ablation's are wrong by design). Then the
bins stage's span, one piece at a time (B's inputs, its launch, the read
of its live count — the span's one host sync — the stable sort and the
tile starts), and the home-layout and bins stages whole. Times are device
times between CUDA events, beside the card's name and power limit; the
last line is a JSON object of the same. Card only; the shipped library
is left as it is. To compare with an older tree, run that tree's own
chip_smoke.py from `git archive`.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import (BONSAI_ORBIT_CAPS, build_edited, card_line, edit, loaded,
                               ptxas_kernels)

# kernel → its source, and its ablations: name → [(regex, replacement,
# matches expected)]. A variant is a kernel and its ablations joined by
# "+", e.g. a+thread-search+row-stores.
SOURCES = {"a": "repeat.cu", "b": "expand.cu"}
ABLATIONS = {
    "a": {
        # the block's search and staged parents replaced by each thread's
        # own binary search of fb and loads of its parent's row (the
        # search and loads of the kernel before its redesign)
        "thread-search": [
            (re.escape("if (s0 < live_end) {"), "if (false) {", 1),
            (r"(?s)const int par = count_le\(s_fb, 0, count, slot\) - 1;.*?th = s_thr\[par\];",
             "const int par = count_le(fb, 0, nf, slot) - 1;\n"
             "    if (par >= 0 && slot < fbe[par]) {\n#pragma unroll\n"
             "      for (int c = 0; c < kCols; ++c) a[c] = src18[static_cast<size_t>(par) * kCols + c];\n"
             "      th = thr[par];", 1)],
        # each thread stores its own tail row (three 16-byte stores 48
        # bytes apart) in place of the block's staged tile
        "row-stores": [
            (re.escape("reinterpret_cast<float4*>(s_tail + tid * kTail)"),
             "reinterpret_cast<float4*>(tail + static_cast<size_t>(j) * kTail)", 1),
            (re.escape("for (int e = tid; e < n4; e += kSlots) dst[e] = src[e];"), "", 1)],
        # 128 copy slots a block
        "slots128": [(re.escape("constexpr int kSlots = 256;"), "constexpr int kSlots = 128;", 1)],
    },
    "b": {
        # element stores in place of the 16-byte ones
        "scalar-stores": [
            (re.escape("if (g >= base && g + 4u <= end) {"), "if (false) {", 1),
            (re.escape("if (g >= base && g + 2u <= end) {"), "if (false) {", 1)],
        # no look-back, each block writes at its dense offset b·256·K (the
        # output has gaps: the look-back's cost)
        "no-lookback": [
            (re.escape("base = exclusive_prefix(status, b, lane);"),
             "base = static_cast<unsigned>(b) * kRows * k_slots;", 1)],
    },
}
VARIANTS = ("a+thread-search,a+row-stores,a+thread-search+row-stores,a+slots128,"
            "b+scalar-stores,b+no-lookback")


def variant_source(variant: str, src: str) -> str:
    """The kernel source `src` edited into `variant`; raises ValueError
    when an edit does not match as often as it expects."""
    kernel, *ablations = variant.split("+")
    return edit(variant, src, [e for name in ablations for e in ABLATIONS[kernel][name]])


def build_variant(variant: str) -> str:
    """The variant's library (built if missing) under _build/variants;
    returns its path."""
    name = SOURCES[variant.split("+")[0]]
    with open(os.path.join(kernels.CSRC, name)) as fh:
        return build_edited(variant, {name: variant_source(variant, fh.read())},
                            ("common.cuh",))


def registers(path: str) -> list:
    """Registers of each kernel in the library's ptxas report."""
    return [p["registers"] for _, p in ptxas_kernels(path)]


def ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls after a warm-up call,
    between CUDA events."""
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


def view0(dev):
    """(projected splats, home rows, layout, camera, cfg) at view 0 of the
    bonsai 1080p orbit, served scene."""
    from gsjax_torch.bench.run import orbit_cameras
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.core.config import RenderConfig
    from gsjax_torch.render.homesort import build_home_layout
    from gsjax_torch.render.project import project

    g = bonsai_like(n=1_200_000, seed=0, sh_degree=0, device=dev)
    cam = orbit_cameras(30, 1920, 1080, device=dev)[0]
    cfg = RenderConfig(chunk=128, **BONSAI_ORBIT_CAPS)
    p = project(g, cam, cfg)
    ph, layout = build_home_layout(p, cam, cfg)
    return p, ph, layout, cam, cfg


def span_pieces(ph, layout, cam, cfg) -> dict:
    """{piece: fn} of the bins stage up to its tile starts, in order;
    each fn runs on the previous pieces' outputs, computed once here:
    "kernel" is B's launch alone and "count" the read of its live
    count."""
    from gsjax_torch.render import binning

    tiles_x, band = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    ts, span = cfg.tile_size, cfg.tile_span
    arange = torch.arange(tiles_x * band + 1, dtype=torch.int32, device=ph.depth.device)
    inputs = binning.expand_inputs(ph, layout, cfg)
    launch = lambda: binning.launch_expand(*inputs, 0, band, tiles_x, ts, span)  # noqa: E731
    pid_full, key_full, count = launch()
    n_live = int(count)
    pid_live, key = pid_full[:n_live], key_full[:n_live]
    pieces = {"inputs": lambda: binning.expand_inputs(ph, layout, cfg),
              "kernel": launch, "count": lambda: int(count),
              "sort": lambda: torch.sort(key, stable=True)}
    key_s, order = torch.sort(key, stable=True)

    def after_fn():
        tile_of = (key_s >> 32).to(torch.int32)
        return (pid_live[order].to(torch.int32),
                torch.searchsorted(tile_of, arange, side="left").to(torch.int32))
    pieces["after"] = after_fn
    return pieces


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=VARIANTS,
                    help="comma-separated kernel+ablation+...; ablations: " + "; ".join(
                        f"{k}: {', '.join(v)}" for k, v in ABLATIONS.items()))
    ap.add_argument("--reps", type=int, default=20, help="timed calls per measurement")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card only")
    from gsjax_torch.render import binning, homesort

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    kernels.lib()
    variants = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = dict(zip(variants, pool.map(build_variant, variants)))

    out = dict(card=card, variants=[], span_ms={}, stages_ms={})
    with torch.no_grad():
        p, ph, layout, cam, cfg = view0(dev)
        tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
        src18, fb, fbe, n_copies = homesort.fat_repeat_inputs(p, tiles_x, tiles_y, cfg)
        a_args = (src18, fb, fbe, n_copies, cfg.fat_cap, tiles_x, tiles_y,
                  cfg.tile_span, cfg.tile_size, cfg.alpha_min)
        a_fn = lambda: homesort.repeat_fat_parents(*a_args)  # noqa: E731
        # the kernel alone, without the wrapper's thresholds
        thr = homesort.cull_threshold(src18[:, 6], cfg.alpha_min).contiguous()
        launch_args = (src18, fb, fbe, thr,
                       torch.as_tensor(n_copies, dtype=torch.int64, device=dev),
                       cfg.fat_cap, tiles_x, tiles_y, cfg.tile_span, cfg.tile_size)
        a_launch = lambda: homesort.launch_repeat(*launch_args)  # noqa: E731
        pieces = span_pieces(ph, layout, cam, cfg)
        b_out = lambda: binning.expand_live_pairs(ph, layout, 0, tiles_y, tiles_x, cfg)  # noqa: E731
        # source → (its entry point, the fn timed, the fn whose outputs are compared)
        shipped = {"repeat.cu": ("gsjax_repeat_fat_parents", a_launch, a_fn),
                   "expand.cu": ("gsjax_expand_live_pairs", pieces["kernel"], b_out)}
        ref = {src: fn() for src, (_, _, fn) in shipped.items()}
        row = dict(variant="shipped", a_ms=ms(a_launch, args.reps),
                   a_wrapper_ms=ms(a_fn, args.reps), b_ms=ms(pieces["kernel"], args.reps),
                   b_wrapper_ms=ms(b_out, args.reps))
        out["variants"].append(row)
        print(f"shipped: A {row['a_ms']:.4f} ms (wrapper {row['a_wrapper_ms']:.4f}), B "
              f"{row['b_ms']:.4f} ms (wrapper {row['b_wrapper_ms']:.4f}) on {card}; a "
              "variant's time is its launch alone")
        for v, path in paths.items():
            src = SOURCES[v.split("+")[0]]
            entry, time_fn, out_fn = shipped[src]
            with loaded("path", path, (entry,)):
                got = out_fn()
                same = all(x.shape == y.shape and torch.equal(x, y)
                           for x, y in zip(got, ref[src]))
                row = dict(variant=v, kernel=src, registers=registers(path),
                           ms=ms(time_fn, args.reps), equal_to_shipped=same)
            out["variants"].append(row)
            print(f"{v} ({src}): {row['ms']:.4f} ms on {card}; registers "
                  f"{row['registers']}; outputs {'equal to' if same else 'differ from'} "
                  "the shipped kernel's")
        for name, fn in pieces.items():
            out["span_ms"][name] = ms(fn, args.reps)
        print(f"bins span (ms each piece, device time with its host syncs) on {card}: "
              + ", ".join(f"{k} {x:.4f}" for k, x in out["span_ms"].items())
              + f"; total {sum(out['span_ms'].values()):.4f}")
        stages = {
            "home_layout": lambda: homesort.build_home_layout(p, cam, cfg),
            "bins_sort": lambda: binning.build_tile_bins(ph, cam, cfg, anchor="home",
                                                         layout=layout),
        }
        for name, fn in stages.items():
            out["stages_ms"][name] = ms(fn, args.reps)
        print(f"stages (ms, device time between events) on {card}: "
              + ", ".join(f"{k} {x:.4f}" for k, x in out["stages_ms"].items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
