"""Lazy training along the orbit (`render/lazy.LazyTrainer`, bench.py's
`--mode orbit`): at each view a resort, then `steps_per_view` lazy steps
toward that view's target, the orbit looped for the whole window.

Set-up builds the trainer on the perturbed scene and drives it as the
window does, through the same calls: at each of the run's first
FIRST_VIEWS views a resort and FIRST_STEPS_PER_VIEW steps, so the steps
after the first of a plan (the frozen layout with fresh attributes, rows
the fresh projection culls masked, copy rows training apart) and the
fold back of several steps are inside the comparison. Those steps'
losses, the first step's gradient (from the home copy's Adam moments,
summed over each splat's rows) and the parameters' change after the
last fold back are what the reference is held to. The window goes on
with the same trainer."""

from __future__ import annotations

import types

import torch

from gsjax_torch.render.lazy import LazyTrainer
from gsjax_torch.render.pipeline import render

from gsbench import port
from gsbench.modes import _train

reference = _train.reference
FIRST_VIEWS = 2
FIRST_STEPS_PER_VIEW = 3
reference_run = _train.reference_run
work = _train.work


def setup(ctx):
    clean, pert = _train.inputs(ctx)
    with ctx.spans("autotune", sync=True, always=True):
        g_clean = port.gaussians(clean)
        ctx.cfg = port.autotune(g_clean, ctx.port_cams, ctx.cfg)
    with torch.no_grad():
        targets = [render(g_clean, c, ctx.cfg) for c in ctx.port_cams]
    del g_clean, clean
    g = port.gaussians(pert)
    p0 = port.snapshot(g)
    del pert
    lr = _train.lrs(ctx)
    if len(set(lr.values())) != 1:
        raise ValueError("train_lazy: one learning rate for every leaf")
    tr = LazyTrainer(g, ctx.cfg, torch.optim.Adam(g.parameters(), lr=lr["means"]))
    n_views = len(ctx.cams)
    order = _train.view_order(ctx, n_views, FIRST_VIEWS)
    losses, grad = [], None
    bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
    for v in order:
        plan = tr.resort(ctx.port_cams[v])
        bad += port.overflow_sum(plan.ovf)
        for _ in range(FIRST_STEPS_PER_VIEW):
            losses.append(float(tr.step(targets[v], ctx.port_cams[v])))
            if grad is None:
                grad = _home_grad_norms(tr, plan)
    tr.sync()
    readings = {"views": order, "steps_per_view": FIRST_STEPS_PER_VIEW, "losses": losses,
                "grad": grad,
                "change": port.change_norms(g, p0), "overflow": int(bad)}
    del p0
    return types.SimpleNamespace(tr=tr, targets=targets, readings=readings,
                                 start=(order[-1] + 1) % n_views)


def _home_grad_norms(tr, plan) -> dict:
    """The first step's gradient as the home copy's Adam got it (its first
    moment over 1 − β1), summed over each splat's rows, per leaf norm."""
    beta1 = tr.hp_opt.param_groups[0]["betas"][0]
    n = plan.n
    out = {}
    for f in _train.FIELDS:
        m = tr.hp_opt.state[getattr(tr.hp, f)]["exp_avg"]
        g = torch.zeros((n + 1,) + tuple(m.shape[1:]), device=m.device)
        g.index_add_(0, plan.pidx, m / (1 - beta1))
        out[f] = g[:n]
    return port.leaf_norms(out)


def window(state, ctx) -> dict:
    tr, targets = state.tr, state.targets
    spv = int(ctx.traffic["steps_per_view"])
    n_views = len(ctx.cams)
    v = state.start
    visits = {}
    steps = 0
    failed = torch.zeros((), dtype=torch.int64, device=ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = ctx.clock()
    while True:
        cam = ctx.port_cams[v]
        with ctx.spans("resort", sync=True):
            plan = tr.resort(cam)
        failed += (port.overflow_sum(plan.ovf) > 0).to(torch.int64) * spv
        for _ in range(spv):
            with ctx.spans("step"):
                tr.step(targets[v], cam)
        steps += spv
        visits[v] = visits.get(v, 0) + spv
        v = (v + 1) % n_views
        if ctx.clock() - t0 >= ctx.seconds:
            break
    tr.sync()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t1 = ctx.clock()
    return {"attempted": steps, "failed": int(failed), "units": steps, "visits": visits,
            "t0": t0, "t1": t1, "e2e": {"train_step_ms": (t1 - t0) / steps * 1e3}}
