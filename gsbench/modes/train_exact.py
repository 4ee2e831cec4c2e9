"""Per-frame exact training as `train.fit` runs it (`train.make_step_fn`
with `train.default_optimizer`): one step per view, the layout rebuilt
every step, the loss read on the host after each step, the views in a
fresh seeded shuffle each epoch (the 3DGS training loop).

Set-up builds the step functions (one per view, one optimizer) and drives
them through the run's first three steps: their losses, the first step's
gradient (from Adam's first moment) and the parameters' change after
the three are what the reference is held to. The window goes on along
the same order with the same module and optimizer."""

from __future__ import annotations

import types

import torch

from gsjax_torch.render.pipeline import render
from gsjax_torch.train import default_optimizer, make_step_fn

from gsbench import port
from gsbench.modes import _train

reference = _train.reference
reference_run = _train.reference_run
work = _train.work
ORDER_LEN = 1 << 16  # more steps than any window makes


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
    opt = default_optimizer(g, lr_means=lr["means"], lr_scales=lr["log_scales"],
                            lr_quats=lr["quats"], lr_sh=lr["sh"],
                            lr_opacity=lr["opacity_logits"])
    bad = torch.zeros((), dtype=torch.int64, device=ctx.device)

    def on_aux(aux):
        bad.add_((port.overflow_sum(aux) > 0).to(torch.int64))

    steps = [make_step_fn(c, ctx.cfg, opt, on_aux=on_aux) for c in ctx.port_cams]
    order = _train.view_order(ctx, len(ctx.cams), ORDER_LEN)
    losses, grad = [], None
    for k in range(_train.FIRST_STEPS):
        v = order[k]
        losses.append(float(steps[v](g, targets[v])))
        if k == 0:
            beta1 = opt.param_groups[0]["betas"][0]
            # an optimizer that never stepped holds no moment: it got nothing
            grad = port.leaf_norms({
                f: opt.state[getattr(g, f)].get("exp_avg", torch.zeros(1, device=ctx.device))
                / (1 - beta1) for f in _train.FIELDS})
    readings = {"views": order[:_train.FIRST_STEPS], "steps_per_view": 1, "losses": losses,
                "grad": grad,
                "change": port.change_norms(g, p0), "overflow": int(bad)}
    del p0
    bad.zero_()
    return types.SimpleNamespace(g=g, steps=steps, targets=targets, order=order,
                                 bad=bad, readings=readings)


def window(state, ctx) -> dict:
    g, steps, targets, order = state.g, state.steps, state.targets, state.order
    visits = {}
    k = _train.FIRST_STEPS
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t0 = ctx.clock()
    while True:
        v = order[k]
        with ctx.spans("step"):
            float(steps[v](g, targets[v]))  # fit reads each step's loss
        visits[v] = visits.get(v, 0) + 1
        k += 1
        if ctx.clock() - t0 >= ctx.seconds:
            break
    t1 = ctx.clock()
    n = k - _train.FIRST_STEPS
    return {"attempted": n, "failed": int(state.bad), "units": n, "visits": visits,
            "t0": t0, "t1": t1, "e2e": {"train_step_ms": (t1 - t0) / n * 1e3}}
