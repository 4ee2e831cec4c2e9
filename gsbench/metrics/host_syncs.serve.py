"""The host's waits for the device per served frame: the port's
`host_syncs` counter under `render` roots (a nonzero's size, kernel B's
pair count, a copy from pageable host memory), over the traced window's
frames. Moves frames_per_s."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.records(art)
    if snap is None or not pt.under(snap, "render"):
        return None
    return pt.counted(snap, "host_syncs", "render") / art["units"]
