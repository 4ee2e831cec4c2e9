"""What the per-layer metrics of the port's own spans and counters share:
gsjax_torch.trace's records of the traced window (the tracer records
while the harness's profile records), each span's busy device time, and
the interval arithmetic over them."""

from __future__ import annotations

import bisect

from gsbench.harness import _union as union  # merged [start, end) intervals, sorted


def records(art):
    """gsjax_torch.trace.snapshot() of the traced window; None off the card,
    where the port has no tracer, or where it recorded no span."""
    if not art.get("cuda"):
        return None
    try:
        from gsjax_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap["spans"] else None


def timed_records(art):
    """records(art), each span given "device_ms" (busy_ms); None also
    where the trace does not hold each of the tracer's markers once."""
    snap = records(art)
    if snap is None:
        return None
    from gsjax_torch import trace

    return snap if busy_ms(snap, art["device_ops"], trace.MARK) else None


def busy_ms(snap: dict, device_ops: list, mark: str) -> bool:
    """Set each span's "device_ms" from the device trace [(name, start_us,
    dur_us)]: the union of the operations that are not markers, inside the
    span's interval from the end of its entry marker to the start of its
    exit marker (the k-th marker by start time is the tracer's marker k:
    they run in launch order on one stream). False where the trace's
    markers are not the tracer's count."""
    marks = sorted((s, s + d) for n, s, d in device_ops if mark in n)
    if len(marks) != snap["marks"]:
        return False
    ops = union((s, s + d) for n, s, d in device_ops if mark not in n)
    starts = [s for s, _ in ops]
    before = [0.0]  # busy time before each merged interval
    for s, e in ops:
        before.append(before[-1] + e - s)

    def busy_to(t):
        i = bisect.bisect_right(starts, t) - 1
        return 0.0 if i < 0 else before[i] + min(t, ops[i][1]) - ops[i][0]

    for s in snap["spans"]:
        lo, hi = marks[s["m0"]][1], marks[s["m1"]][0]
        s["device_ms"] = max(busy_to(hi) - busy_to(lo), 0.0) * 1e-3
    return True


def under(snap: dict, root: str) -> list:
    """The spans (the roots themselves included) under the root spans
    named `root` ("step": a training step, "render": a served frame,
    "resort": a lazy resort)."""
    roots = {s["id"] for s in snap["spans"] if s["parent"] == -1 and s["name"] == root}
    return [s for s in snap["spans"] if s["root"] in roots]


def device_ms(spans: list, *names: str) -> float:
    """The sum of the busy device times of the spans named one of `names`."""
    return sum(s["device_ms"] for s in spans if s["name"] in names)


def counted(snap: dict, name: str, root: str) -> float:
    """The sum of the counter `name` under the root spans named `root`."""
    roots = {s["id"] for s in snap["spans"] if s["parent"] == -1 and s["name"] == root}
    return sum(v for r, v in snap["counts"].get(name, []) if r in roots)


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot
