"""The lazy resort's packs, in ms: the busy device time inside the port's
`fold` (the home rows' changes and moments folded back into the master)
and `extract` (the home-order parameters and moments gathered for the
new plan) spans under `resort` roots, mean over the traced window's
resorts; the frame plan between them (A, B, sorts) is left out. Moves
train_step_ms."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.timed_records(art)
    if snap is None:
        return None
    n = sum(1 for s in snap["spans"] if s["parent"] == -1 and s["name"] == "resort")
    if not n:
        return None
    return pt.device_ms(pt.under(snap, "resort"), "fold", "extract") / n
