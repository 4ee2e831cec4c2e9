"""The layout's and bins' device time per exact training step, in ms:
the busy device time inside the port's `layout` (kernel A, the sort, the
home gather), `bins` (kernel B, its count read, the pair sort) and
`layout_bwd` (the home gather's VJP) spans under `step` roots, over the
traced window's steps. Moves train_step_ms."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.timed_records(art)
    if snap is None:
        return None
    steps = pt.under(snap, "step")
    if not any(s["name"] == "layout" for s in steps):
        return None
    return pt.device_ms(steps, "layout", "bins", "layout_bwd") / art["units"]
