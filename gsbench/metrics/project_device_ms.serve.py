"""Project + SH's device time per served frame, in ms: the busy device
time inside the port's `project` spans under `render` roots, over the
traced window's frames. Moves frames_per_s."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.timed_records(art)
    if snap is None:
        return None
    frames = pt.under(snap, "render")
    if not frames:
        return None
    return pt.device_ms(frames, "project") / art["units"]
