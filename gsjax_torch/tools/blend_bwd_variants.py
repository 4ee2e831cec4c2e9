"""Build and time variants of the blend backward (kernels D and F,
csrc/blend.cuh) at the bonsai 1080p orbit's view 0: other groupings of
its pixel reductions, and ablations that each take one piece of the
kernel away, to see where the card spends its time.

    python -m gsjax_torch.tools.blend_bwd_variants [--variants 4x2,4x2+no-reduce]

A variant is PxX (P pairs reduced over a warp's pixels together, X
pixels per thread; the shipped kernel is 4x2) and any of the ablations
in ABLATIONS after a "+". Each is a copy of the backward's sources with
blend.cuh's text edited (every edit's text must occur exactly as often
as it expects, so a variant never silently times the shipped kernel),
built into a library of its own under gsjax_torch/_build/variants, all
at once. For each this prints ptxas's registers, stack frame and spills
of both backward kernels, the device times of D's blend kernel alone,
of D's wrapper and of F's wrapper between CUDA events, beside the card's
name and power limit, and the per attribute column p99.9 |Δ|/peak of D
against the plain version (an ablation's gradients are wrong by
design). The last line is a JSON object of the same. Runs on the card
only; the shipped library is left as it is.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import build_edited, card_line, edit, loaded, ptxas_kernels

VARIANTS = ("4x2,2x2,8x2,4x1,2x4,4x4,4x2+no-reduce,4x2+no-grad,"
            "4x2+no-grad+no-reduce,4x2+no-stop")
# ablation → [(regex, replacement, matches expected)] on blend.cuh
ABLATIONS = {
    # the reduce-scatter of a group's 9·P partials over the warp's lanes
    "no-reduce": [(re.escape("if (__any_sync(0xffffffffu, any)) "
                             "warp_reduce_scatter<P>(v, lane);"), "", 1)],
    # the 9 gradient products (and so v, U and dα): v stays 0
    "no-grad": [(r"\n *v\[e(?: \+ \d)?\] = __fmaf_rn\(.*\);", "", 9)],
    # the warp's stop once its pixels' C < eps
    "no-stop": [(re.escape("live = __any_sync(0xffffffffu, open);"), "live = true;", 1)],
}
SOURCES = ("stream_bwd.cu", "slots_bwd.cu")
ENTRY_POINTS = ("gsjax_stream_backward", "gsjax_stream_class_sum", "gsjax_slots_backward")


def variant_source(variant: str, src: str) -> str:
    """blend.cuh's text `src` edited into `variant` (PxX[+ablation...])."""
    grouping, *ablations = variant.split("+")
    pairs, pixels = (int(x) for x in grouping.split("x"))
    edits = [(r"constexpr int kBwdPairs = \d+;", f"constexpr int kBwdPairs = {pairs};", 1),
             (r"constexpr int kBwdPixels = \d+;", f"constexpr int kBwdPixels = {pixels};", 1)]
    return edit(variant, src, edits + [e for name in ablations for e in ABLATIONS[name]])


def build_variant(variant: str) -> str:
    """The variant's library (built if missing), with D's and F's entry
    points; returns its path."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        return build_edited(variant, {"blend.cuh": variant_source(variant, fh.read())},
                            ("common.cuh",) + SOURCES)


def ptxas_summary(path: str, kernel: str = "blend_bwd_kernel") -> dict:
    """{row source: registers, stack frame and spill bytes} of `kernel`'s
    instantiations, from the library's ptxas report."""
    out = {}
    for name, p in ptxas_kernels(path):
        m = re.search(rf"{kernel}\w*?(PairRows|SlotRows)", name)
        if m:
            out[m.group(1)] = p
    return out


def view0_inputs(dev, perturbed: bool = True):
    """(d_args, f_args): stream_backward's and slots_backward's arguments
    at view 0 of the bonsai 1080p orbit (the perturbed scene of the
    training runs, or with perturbed=False the served one; seeded
    cotangents)."""
    from gsjax_torch.bench.run import FAT_CAP, LIVE_CAP, orbit_cameras, perturb
    from gsjax_torch.bench.synth import bonsai_like
    from gsjax_torch.core.config import RenderConfig
    from gsjax_torch.render import flat, stream
    from gsjax_torch.render.binning import build_tile_bins
    from gsjax_torch.render.composite import att_table, clipped_pair_stream
    from gsjax_torch.render.homesort import build_home_layout
    from gsjax_torch.render.project import project

    g = bonsai_like(n=1_200_000, seed=0, sh_degree=0, device=dev)
    g = perturb(g) if perturbed else g
    cam = orbit_cameras(30, 1920, 1080, device=dev)[0]
    cfg = RenderConfig(chunk=128, fat_cap=FAT_CAP, fat_live_cap=LIVE_CAP)
    cfg_flat = dataclasses.replace(cfg, backend="pallas")
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    with torch.no_grad():
        ph, layout = build_home_layout(project(g, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
        att = att_table(ph).contiguous()
        pid, starts, _ = clipped_pair_stream(bins, cfg)
        out = stream.stream_forward(att, pid, starts, 0, tiles_x, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        ct_img = torch.randn((out.shape[0], out.shape[2], 3), generator=gen, device=dev)
        ct_T = torch.randn((out.shape[0], out.shape[2]), generator=gen, device=dev)
        att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg_flat,
                                                         cfg.tile_span ** 2)
        out_e = flat.slots_forward(att_al, starts, cbase, tile_of, 0, tiles_x, tiles_y,
                                   cfg_flat)
    d_args = (att, pid, starts, out, ct_img, ct_T, 0, tiles_x, cfg)
    f_args = (att_al, starts, cbase, tile_of, 0, out_e, ct_img, ct_T, tiles_x,
              tiles_y, cfg_flat)
    return d_args, f_args


def _ms(fn, reps: int) -> float:
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


def _col_p999(dk, dp) -> float:
    """The worst attribute column's p99.9 |Δ|/peak over rows either
    gradient reaches."""
    diff = (dk - dp).abs()
    peak = dp.abs().amax(dim=0).clamp(min=1e-30)
    rel = (diff / peak)[(dp != 0).any(dim=1) | (dk != 0).any(dim=1)]
    return max(float(torch.quantile(rel[:, c], 0.999)) for c in range(9))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=VARIANTS,
                    help="comma-separated PxX[+ablation...]; ablations: "
                         + ", ".join(ABLATIONS))
    ap.add_argument("--reps", type=int, default=10, help="timed calls per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card only")
    from gsjax_torch.render import flat, stream

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    variants = args.variants.split(",")
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(build_variant, variants)))
    d_args, f_args = view0_inputs(dev)
    nh, k_slots = d_args[0].shape[0], d_args[-1].tile_span ** 2
    dpair = torch.empty((nh * k_slots, 9), device=dev)
    marks = torch.zeros(nh * k_slots, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        dp = stream.stream_backward_plain(*d_args)
        rows = []
        for v in variants:
            with loaded("path", paths[v], ENTRY_POINTS):
                r = dict(variant=v, ptxas=ptxas_summary(paths[v]),
                         d_kernel_ms=_ms(lambda: stream.stream_backward_pairs(
                             dpair, marks, *d_args), args.reps),
                         d_ms=_ms(lambda: stream.stream_backward(*d_args), args.reps),
                         f_ms=_ms(lambda: flat.slots_backward(*f_args), args.reps),
                         d_p999=_col_p999(stream.stream_backward(*d_args), dp))
            rows.append(r)
            print(f"{v}: D blend kernel {r['d_kernel_ms']:.3f} ms, D {r['d_ms']:.3f} ms, "
                  f"F {r['f_ms']:.3f} ms on {card}; ptxas {r['ptxas']}; D vs plain "
                  f"p99.9 |Δ|/peak {r['d_p999']:.2e}")
    print(json.dumps({"card": card, "variants": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
