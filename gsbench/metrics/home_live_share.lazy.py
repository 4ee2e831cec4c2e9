"""The lazy steps' useful share of their home rows, in %: the port's
`home_rows_live` (rows with a source splat) over `home_rows` (the plan's
NH, every row of which a lazy step projects), summed over the traced
window's steps. Moves train_step_ms."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.records(art)
    if snap is None:
        return None
    rows = pt.counted(snap, "home_rows", "step")
    if not rows:
        return None
    return 100.0 * pt.counted(snap, "home_rows_live", "step") / rows
