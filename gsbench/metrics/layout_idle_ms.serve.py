"""The device's idle time inside the layout and bins per served frame, in
ms: the part of the host intervals of the port's `layout` and `bins`
spans under `render` roots (their union) in which no device operation of
the profiler's trace runs, over the traced window's frames. The tracer's
host clock (time.time_ns) is the profiler's. Moves frames_per_s."""

from gsbench import program_trace as pt


def read(art):
    snap = pt.records(art)
    if snap is None or not art["device_ops"]:
        return None
    host = pt.union((s["t0_ns"] * 1e-3, s["t1_ns"] * 1e-3) for s in pt.under(snap, "render")
                    if s["name"] in ("layout", "bins"))
    if not host:
        return None
    busy = pt.union((s, s + d) for _, s, d in art["device_ops"])
    idle_us = sum(e - s for s, e in host) - pt.overlap(host, busy)
    return idle_us * 1e-3 / art["units"]
