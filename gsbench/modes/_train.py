"""What the two training kinds share: the scenes, the targets, the view
order, the first steps' readings and the reference's side."""

from __future__ import annotations

import numpy as np
import torch

from gsbench import compare
from gsbench.inputs import scenes
from gsbench.reference import render as ref_render
from gsbench.reference import train as ref_train

FIELDS = scenes.FIELDS
FIRST_STEPS = 3  # the exact kind's first steps, one a view


def inputs(ctx):
    """(clean scene, perturbed scene) as raw parameter dicts on the device."""
    clean = scenes.make_scene(ctx.config["scene"], ctx.seed, ctx.device)
    pert = ctx.traffic["perturb"]
    return clean, scenes.perturb(clean, pert["sd"], ctx.seed, int(pert["seed_offset"]))


def lrs(ctx) -> dict:
    return {f: float(ctx.traffic["optimizer"]["lrs"][f]) for f in FIELDS}


def view_order(ctx, n_views: int, length: int) -> list:
    """The views of the run's steps in order, from the seed: the orbit from
    a drawn start view ("orbit"), or a fresh draw of all views each epoch
    ("shuffled"), one entry per resort (lazy) or step (exact)."""
    rng = np.random.default_rng(ctx.seed)
    if ctx.traffic["order"] == "orbit":
        s = int(rng.integers(n_views))
        return [(s + i) % n_views for i in range(length)]
    out = []
    while len(out) < length:
        out += rng.permutation(n_views).tolist()
    return out[:length]


def reference_run(ctx, readings, tf32: bool = False, keep=None) -> dict:
    """The reference's first steps from the same inputs at the program's
    first views (readings["views"], readings["steps_per_view"] steps
    each), toward its own targets: {"losses", "grad", "change"} with
    per-leaf norms. tf32 / keep: the control and the half-batch fault
    (reference/train)."""
    clean, p0 = inputs(ctx)
    cams = [ctx.cams[v] for v in readings["views"]]
    targets = [ref_render.render(clean, c, tf32) for c in cams]
    del clean
    out = ref_train.train(p0, lrs(ctx), cams, targets, lazy=ctx.traffic["kind"] == "train_lazy",
                          steps=int(readings["steps_per_view"]), tf32=tf32, keep=keep)
    return {"losses": out["losses"],
            "grad": {f: float(torch.linalg.vector_norm(out["grad"][f])) for f in FIELDS},
            "change": {f: float(torch.linalg.vector_norm(out["change"][f])) for f in FIELDS}}


def reference(ctx, readings) -> tuple:
    """The comparison of the program's first steps with the reference's."""
    ref = reference_run(ctx, readings)
    return compare.training_numbers(readings, ref), ref


def work(ctx, visits: dict) -> dict:
    """The blend's work per step, at the training's starting parameters,
    averaged over the steps the window made at each view."""
    _, p0 = inputs(ctx)
    return weighted_work(p0, ctx.cams, visits)


def weighted_work(params: dict, cams: list, visits: dict) -> dict:
    tot, n = {}, sum(visits.values())
    for v, k in visits.items():
        _, w = ref_render.render(params, cams[v], count=True)
        for key, val in w.items():
            tot[key] = tot.get(key, 0.0) + val * k / n
    tot["n_splats"] = params["means"].shape[0]
    tot["sh_k"] = params["sh"].shape[1]
    tot["n_params"] = sum(params[f].numel() for f in FIELDS)
    return tot
