"""Project + SH's device time per training step, in ms, from the port's
spans: the busy device time inside the `project` spans under `step`
roots (the exact step's projection and SH; the lazy step's lazy_cols,
which adds the attribute columns), plus the self time of `backward` (its
busy time less that of its `blend_bwd` and `layout_bwd` children: the
autograd of projection, SH, the columns and the loss), over the traced
window's steps. Moves train_step_ms."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.timed_records(art)
    if snap is None:
        return None
    steps = pt.under(snap, "step")
    if not steps:
        return None
    ms = pt.device_ms(steps, "project", "backward") - pt.device_ms(steps, "blend_bwd",
                                                                   "layout_bwd")
    return ms / art["units"]
