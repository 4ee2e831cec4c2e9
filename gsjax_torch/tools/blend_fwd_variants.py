"""Build and time variants of the blend forward (kernels C and E,
csrc/blend.cuh) at the bonsai 1080p orbit's view 0: other thread-to-pixel
mappings, and ablations that each take one piece of the kernel away.

    python -m gsjax_torch.tools.blend_fwd_variants [--variants 2x8,baseline]

A variant is XxW (X pixels per thread, each warp a W-pixel-wide rectangle
of the tile, 32·X / W rows high; the shipped kernel is 2x8) and any of the
ablations in ABLATIONS after a "+"; `baseline` is 1x16+no-cull+no-stop,
the full walk: one pixel per thread, a warp two rows of the tile, every
pair evaluated at every pixel of every chunk run. Each is
a copy of the forward's sources with blend.cuh's text edited (every
edit's text must occur exactly as often as it expects, so a variant never
silently times the shipped kernel), built into a library of its own under
gsjax_torch/_build/variants, all at once. For each this prints ptxas's
registers, stack frame and spills of the forward kernel, the device times
of C's and E's wrappers between CUDA events on the served scene's view 0,
beside the card's name and power limit, and whether C's and E's outputs
match the baseline's (rows 0-3 and 5 bit-equal, row 4 wherever the
baseline's is ≥ eps: every variant must). The last line is a JSON object
of the same. Runs on the card only; the shipped library is left as it is.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re

import torch

from gsjax_torch import kernels, tools
from gsjax_torch.tools import blend_bwd_variants as bwd
from gsjax_torch.tools import build_edited, card_line, edit

VARIANTS = "2x8,4x8,2x16,2x4,1x8,1x16,2x8+no-cull,2x8+no-stop,baseline"
BASELINE = "1x16+no-cull+no-stop"
# ablation → [(regex, replacement, matches expected)] on blend.cuh
ABLATIONS = {
    # the strip cull: no masks staged, every warp runs every pair
    "no-cull": [(r"\n *stage_warp_masks\(.*\);", "", 1),
                (re.escape("i0 + lane < m && ((smask[i0 + lane] >> warp) & 1u)"),
                 "i0 + lane < m", 1)],
    # the warp's stop once its pixels' C < eps
    "no-stop": [(re.escape("running = __any_sync(0xffffffffu, open);"),
                 "running = true;", 1)],
}
SOURCES = ("stream_fwd.cu", "slots_fwd.cu")
ENTRY_POINTS = ("gsjax_stream_forward", "gsjax_slots_forward")


def variant_source(variant: str, src: str) -> str:
    """blend.cuh's text `src` edited into `variant` (XxW[+ablation...] or
    baseline)."""
    grouping, *ablations = (BASELINE if variant == "baseline" else variant).split("+")
    pixels, width = (int(x) for x in grouping.split("x"))
    edits = [(r"constexpr int kFwdPixels = \d+;", f"constexpr int kFwdPixels = {pixels};", 1),
             (r"constexpr int kFwdWarpW = \d+;", f"constexpr int kFwdWarpW = {width};", 1)]
    return edit(variant, src, edits + [e for name in ablations for e in ABLATIONS[name]])


def build_variant(variant: str) -> str:
    """The variant's library (built if missing), with C's and E's entry
    points; returns its path."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        return build_edited(variant, {"blend.cuh": variant_source(variant, fh.read())},
                            ("common.cuh",) + SOURCES)


def loaded(path: str):
    """The forward wrappers launch the library at `path` while inside."""
    return tools.loaded("path", path, ENTRY_POINTS)


def matches_baseline(out, base, eps: float) -> tuple[bool, str]:
    """A forward's output [T, 8, ts²] against the baseline's on the same
    inputs: rows 0-3 (img, T_act) and 5 (n_done) bit-equal, row 4 (the
    exit C) bit-equal wherever the baseline's is ≥ eps and below eps in
    both elsewhere (a warp's stop leaves it there). Returns (ok, what
    differs)."""
    rows = [0, 1, 2, 3, 5]
    n_rows = int((out[:, rows] != base[:, rows]).sum())
    open_ = base[:, 4] >= eps
    n_open = int((out[:, 4] != base[:, 4])[open_].sum())
    n_closed = int((out[:, 4] >= eps)[~open_].sum())
    n_stopped = int((out[:, 4] != base[:, 4])[~open_].sum())
    ok = n_rows == 0 and n_open == 0 and n_closed == 0
    return ok, (f"rows 0-3, 5: {n_rows} values differ; row 4: {n_open} differ where the "
                f"baseline's C ≥ eps, {n_closed} ≥ eps where the baseline's is below, "
                f"{n_stopped} left below eps by a warp's stop")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=VARIANTS,
                    help="comma-separated XxW[+ablation...] or baseline; ablations: "
                         + ", ".join(ABLATIONS))
    ap.add_argument("--reps", type=int, default=20, help="timed calls per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card only")
    from gsjax_torch.render import flat, stream

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    variants = args.variants.split(",")
    names = list(dict.fromkeys(variants + ["baseline"]))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build_variant, names)))
    d_args, f_args = bwd.view0_inputs(dev, perturbed=False)
    att, pid, starts, _, _, _, ty0, tiles_x, cfg = d_args
    att_al, _, cbase, tile_of, _, _, _, _, _, tiles_y, cfg_flat = f_args
    c_args = (att, pid, starts, ty0, tiles_x, cfg)
    e_args = (att_al, starts, cbase, tile_of, ty0, tiles_x, tiles_y, cfg_flat)
    eps = cfg.transmittance_eps
    rows = []
    with torch.no_grad():
        with loaded(paths["baseline"]):
            base_c = stream.stream_forward(*c_args)
            base_e = flat.slots_forward(*e_args)
        for v in variants:
            with loaded(paths[v]):
                same_c, what_c = matches_baseline(stream.stream_forward(*c_args), base_c, eps)
                same_e, what_e = matches_baseline(flat.slots_forward(*e_args), base_e, eps)
                r = dict(variant=v, ptxas=bwd.ptxas_summary(paths[v], "blend_fwd_kernel"),
                         c_ms=bwd._ms(lambda: stream.stream_forward(*c_args), args.reps),
                         e_ms=bwd._ms(lambda: flat.slots_forward(*e_args), args.reps),
                         c_matches_baseline=same_c, e_matches_baseline=same_e)
            rows.append(r)
            print(f"{v}: C {r['c_ms']:.3f} ms, E {r['e_ms']:.3f} ms on {card}; ptxas "
                  f"{r['ptxas']}; against the baseline C {what_c}; E {what_e}")
    print(json.dumps({"card": card, "variants": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
