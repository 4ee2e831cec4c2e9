"""The readings the limits are set from (gsbench/limits/<workload>.json),
on the card at the cell's own size, in one process per call:

    python3 -m gsbench.control --workload <cell> --seeds 11,12,13 \
        [--controls 3] [--seconds 3]

For each seed: the program's set-up (and for serving a window of
--seconds, long enough to reach the sampled requests), the reference,
and the comparison the run makes: the lower readings. For the first
--controls seeds also the control, the reference computed in TF32 (the
configuration's float32 one step down) put in the program's place; and
for training the half-batch fault planted in the reference (the loss's
mean over the image's top half only): the upper readings. A state left
unchanged reads change_gap = 1 by its definition and needs no run. One
JSON line per seed on standard output, with each reading's verdict under
the cell's limits as a run's `correct` would give it (compare.judge)."""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from gsbench import compare, harness, port, run


def readings(c: dict, seed: int, seconds: float, controls: bool, device) -> dict:
    mod = harness.mode(c["traffic"]["kind"])
    ctx = run.context(c, seed, seconds, False, device)
    port.load_kernels(device)
    state = mod.setup(ctx)
    if c["traffic"]["kind"] == "serve":
        mod.window(state, ctx)
    prog = state.readings
    del state
    gc.collect()
    torch.cuda.empty_cache()
    numbers, ref = mod.reference(ctx, prog)
    out = {"seed": seed, "program": numbers}
    if "losses" in prog:
        out["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    if not controls:
        return out
    if c["traffic"]["kind"] == "serve":
        views = sorted({prog["frames"][i][0] for i in prog["frames"]})
        ref = mod.reference_frames(ctx, views)
        out["control_tf32"] = compare.frame_numbers(mod.reference_frames(ctx, views, True), ref)
        return out
    ref = mod.reference_run(ctx, prog)
    out["control_tf32"] = compare.training_numbers(mod.reference_run(ctx, prog, tf32=True), ref)
    H, W = ctx.cams[0]["height"], ctx.cams[0]["width"]
    keep = torch.zeros((-(-H // 16) * 16, -(-W // 16) * 16), dtype=torch.bool,
                       device=device)
    keep[: H // 2] = True
    out["fault_half_batch"] = compare.training_numbers(
        mod.reference_run(ctx, prog, keep=keep), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    c = harness.cell(harness.manifest(), args.workload)
    if not torch.cuda.is_available():
        print("gsbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        out = readings(c, s, args.seconds, i < args.controls, torch.device("cuda:0"))
        out["correct"] = {k: compare.judge(out[k], c["limits"])[0]
                          for k in ("program", "control_tf32", "fault_half_batch") if k in out}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
