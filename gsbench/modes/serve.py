"""Serving a closed loop of one viewer (`gsjax_torch.render` under
torch.no_grad()): each request renders the next orbit view and copies the
float32 frame into one pinned host buffer the loop reuses; a request ends
when its frame is there, and the next starts at once.

Frames are checked one by one: `sample_frames` request numbers are drawn
from the seed among the first `sample_within` requests, their frames are
kept as delivered, and after the window the reference renders those views
for the comparison."""

from __future__ import annotations

import types

import numpy as np
import torch

from gsjax_torch.render.pipeline import render

from gsbench import compare, harness, port
from gsbench.inputs import scenes
from gsbench.modes import _train
from gsbench.reference import render as ref_render


def setup(ctx):
    clean = scenes.make_scene(ctx.config["scene"], ctx.seed, ctx.device)
    g = port.gaussians(clean)
    del clean
    with ctx.spans("autotune", sync=True, always=True):
        ctx.cfg = port.autotune(g, ctx.port_cams, ctx.cfg)
    cam0 = ctx.cams[0]
    pin = ctx.device.type == "cuda"
    host = torch.empty((cam0["height"], cam0["width"], 3), dtype=torch.float32,
                       pin_memory=pin)
    rng = np.random.default_rng(ctx.seed)
    n = int(ctx.traffic["sample_frames"])
    sample = sorted(rng.choice(int(ctx.traffic["sample_within"]), n, replace=False).tolist())
    start = int(rng.integers(len(ctx.cams)))
    bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
    with torch.no_grad():  # every view once: the shapes and the host copy
        for c in ctx.port_cams:
            img, aux = render(g, c, ctx.cfg, return_aux=True)
            bad += port.overflow_sum(aux)
            host.copy_(img, non_blocking=pin)
        _sync(ctx)
    return types.SimpleNamespace(g=g, host=host, sample=sample, start=start, bad=bad,
                                 readings={"setup_overflow": int(bad)})


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.current_stream(ctx.device).synchronize()


def window(state, ctx) -> dict:
    g, host, cfg = state.g, state.host, ctx.cfg
    pin = ctx.device.type == "cuda"
    n_views = len(ctx.cams)
    lat, visits, kept = [], {}, {}
    state.bad.zero_()
    want = set(state.sample)
    i = 0
    _sync(ctx)
    clock = ctx.clock
    t0 = clock()
    with torch.no_grad():
        while True:
            v = (state.start + i) % n_views
            r0 = clock()
            with ctx.spans("frame"):
                img, aux = render(g, ctx.port_cams[v], cfg, return_aux=True)
                state.bad += (port.overflow_sum(aux) > 0).to(torch.int64)
                host.copy_(img, non_blocking=pin)
                _sync(ctx)
            r1 = clock()
            lat.append(r1 - r0)
            visits[v] = visits.get(v, 0) + 1
            if i in want:
                kept[i] = (v, host.clone())
            i += 1
            if r1 - t0 >= ctx.seconds:
                break
    t1 = clock()
    state.readings["frames"] = kept
    return {"attempted": i, "failed": int(state.bad), "units": i, "visits": visits,
            "t0": t0, "t1": t1,
            "e2e": {"frames_per_s": i / (t1 - t0),
                    "frame_ms_p95": harness.percentile(lat, 95.0) * 1e3}}


def reference_frames(ctx, views, tf32: bool = False) -> list:
    """The reference's frames of `views` (tf32: the control's)."""
    clean = scenes.make_scene(ctx.config["scene"], ctx.seed, ctx.device)
    return [ref_render.render(clean, ctx.cams[v], tf32) for v in views]


def reference(ctx, readings) -> tuple:
    """The frames of the sampled requests against the reference's frames of
    their views (a sampled request the window never made counts as a
    wrong frame)."""
    kept = readings["frames"]
    order = sorted(kept)
    refs = reference_frames(ctx, [kept[i][0] for i in order])
    numbers = compare.frame_numbers([kept[i][1].to(ctx.device) for i in order], refs)
    if len(kept) < int(ctx.traffic["sample_frames"]):
        numbers = {k: float("inf") for k in numbers}
    return numbers, {"requests": order, "views": [kept[i][0] for i in order]}


def work(ctx, visits: dict) -> dict:
    clean = scenes.make_scene(ctx.config["scene"], ctx.seed, ctx.device)
    return _train.weighted_work(clean, ctx.cams, visits)
