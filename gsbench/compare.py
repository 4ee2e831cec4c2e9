"""The numbers that decide `correct`, each against its limit
(gsbench/limits/<workload>.json, set from the readings in PERF.md).

Training (the first steps of the object the window drives, through the
window's own calls: exact, three views a step each; lazy, two views of a
resort, three steps and the fold back each):
  loss_gap   — the first step's |loss − reference loss| / reference loss
               (the later steps' losses follow Adam's first, sign-like
               step through elements whose gradient is below its rounding,
               and lazy rows split at pixel-exact rect edges: they swing
               by 1e-3 on a seed in twelve, PERF.md);
  grad_gap   — the worst leaf's |‖g‖ − ‖g_ref‖| over max(‖g_ref‖ of the
               leaf, of the median leaf), g the first step's gradient as
               the optimizer got it (from its first moment);
  change_gap — the same for the parameters' change over those steps,
               over the leaves whose reference gradient is at least a
               thousandth of the median leaf's (a leaf nought to rounding
               moves under Adam by round-off alone).
Serving (frames sampled from the seed among those the window delivered):
  mean_abs   — the worst frame's mean |frame − reference| per value;
  bad_share  — the worst frame's share of values more than 1e-2 off.
"""

from __future__ import annotations

import math
import statistics

FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
BAD = 1e-2
NO_NUMBER = 1e300


def _leaf_gap(prog: dict, ref: dict, fields) -> float:
    med = statistics.median(ref[f] for f in FIELDS)
    return max((abs(prog[f] - ref[f]) / max(ref[f], med, 1e-30) for f in fields),
               default=0.0)


def training_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}}."""
    a, b = prog["losses"][0], ref["losses"][0]
    loss = abs(a - b) / max(abs(b), 1e-30)
    med = statistics.median(ref["grad"][f] for f in FIELDS)
    moved = [f for f in FIELDS if ref["grad"][f] >= 1e-3 * med]
    return {"loss_gap": loss, "grad_gap": _leaf_gap(prog["grad"], ref["grad"], FIELDS),
            "change_gap": _leaf_gap(prog["change"], ref["change"], moved)}


def frame_numbers(frames, refs) -> dict:
    """frames, refs: matching lists of [H, W, 3] float tensors."""
    mean_abs = bad = 0.0
    for f, r in zip(frames, refs):
        d = (f.float() - r.float()).abs()
        mean_abs = max(mean_abs, float(d.mean()))
        bad = max(bad, float((d > BAD).float().mean()))
    return {"mean_abs": mean_abs, "bad_share": bad}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite. A number that is not finite is written as NO_NUMBER
    (the result line stays strict JSON)."""
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    checks = {k: {"value": v if math.isfinite(v) else NO_NUMBER, "limit": limits[k]}
              for k, v in numbers.items()}
    return ok, checks
