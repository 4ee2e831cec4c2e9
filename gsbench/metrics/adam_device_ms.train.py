"""The optimizer's device time per training step, in ms: the busy device
time inside the port's `optimizer` spans (torch.optim.Adam's step and
zero_grad) under `step` roots, over the traced window's steps. Moves
train_step_ms."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.timed_records(art)
    if snap is None:
        return None
    steps = pt.under(snap, "step")
    if not steps:
        return None
    return pt.device_ms(steps, "optimizer") / art["units"]
