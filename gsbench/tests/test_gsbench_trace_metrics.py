"""The per-layer metrics that read the port's own spans and counters
(gsjax_torch.trace), on synthetic records and a synthetic traced window:
each value, the backward's self time, the device's waits inside a span
left out of its busy time, the idle time inside the layout's host
intervals, no device time where the trace's markers are not the
tracer's, and no value off the card or from a port without a tracer."""

from __future__ import annotations

import itertools
import sys

import pytest

from gsbench import harness

NAMES = ("project_device_ms.train", "project_device_ms.serve", "layout_device_ms.train",
         "layout_device_ms.serve", "layout_idle_ms.serve", "host_syncs.serve",
         "adam_device_ms.train", "home_live_share.lazy", "resort_pack_ms.lazy")
TIMED = ("project_device_ms.train", "project_device_ms.serve", "layout_device_ms.train",
         "layout_device_ms.serve", "adam_device_ms.train", "resort_pack_ms.lazy")
GAP_US = 100.0
MARK_OP = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def _window(*roots):
    """The tracer's records and the device trace of trees (name, work_ms,
    children...) on one stream: each span's entry marker, one operation of
    its own work_ms (none at 0), its children, its exit marker, GAP_US of
    idle after every operation (the stream waiting for the host); a span's
    host interval runs from its entry marker's start to its exit marker's
    end plus the gap after it."""
    spans, ops, ids, t = [], [], itertools.count(), [0.0]

    def op(name, dur_us):
        ops.append((name, t[0], dur_us))
        t[0] += dur_us + GAP_US
        return len([o for o in ops if o[0] == MARK_OP]) - 1

    def walk(node, parent, root):
        name, work, *kids = node
        i = next(ids)
        rec = {"name": name, "id": i, "parent": parent, "root": i if parent == -1 else root,
               "t0_ns": int(t[0] * 1000), "m0": op(MARK_OP, 1.0)}
        spans.append(rec)
        if work:
            op("k", work * 1000.0)
        for k in kids:
            walk(k, i, rec["root"])
        rec["m1"] = op(MARK_OP, 1.0)
        rec["t1_ns"] = int(t[0] * 1000)

    for r in roots:
        walk(r, -1, None)
    n = sum(1 for o in ops if o[0] == MARK_OP)
    return {"spans": spans, "marks": n, "counts": {}}, ops


def _roots(snap, name):
    return [s["id"] for s in snap["spans"] if s["parent"] == -1 and s["name"] == name]


SERVE, SERVE_OPS = _window(
    ("render", 0, ("project", 0.5), ("layout", 3.0), ("bins", 2.0)),
    ("render", 0, ("project", 0.7), ("layout", 4.0), ("bins", 1.0)))
_f = _roots(SERVE, "render")
SERVE["counts"] = {"host_syncs": [(_f[0], 1.0), (_f[0], 2.0), (_f[1], 3.0), (-1, 5.0)]}

# an exact step, two lazy resorts (a resort's projection and layout are
# no step's) and a lazy step
TRAIN, TRAIN_OPS = _window(
    ("step", 0, ("optimizer", 0), ("render", 0, ("project", 2.0), ("layout", 4.0),
                                   ("bins", 2.5)),
     ("backward", 4.0, ("blend_bwd", 3.0), ("layout_bwd", 1.0)), ("optimizer", 1.5)),
    ("resort", 0, ("fold", 10.0), ("plan", 0, ("project", 5.0), ("layout", 9.0), ("bins", 4.0)),
     ("extract", 15.0)),
    ("step", 0, ("optimizer", 0), ("project", 1.0), ("backward", 4.0, ("blend_bwd", 2.0)),
     ("optimizer", 0.5)),
    ("resort", 0, ("fold", 12.0), ("plan", 20.0), ("extract", 13.0)))
_s = _roots(TRAIN, "step")
TRAIN["counts"] = {"home_rows": [(_s[1], 1000.0), (_s[0], 1000.0)],
                   "home_rows_live": [(_s[1], 400.0), (_s[0], 100.0)]}


def _art(units, ops=()):
    return {"cuda": True, "units": units, "device_ops": list(ops), "busy_s": 0.0,
            "window_s": 1.0}


@pytest.fixture
def records(monkeypatch):
    from gsjax_torch import trace

    def use(snap):
        monkeypatch.setattr(trace, "snapshot", lambda: snap)

    return use


def read(name, art):
    return harness.metric_reader(name)(art)


def test_serving_metrics(records):
    records(SERVE)
    art = _art(2, SERVE_OPS)
    assert read("project_device_ms.serve", art) == pytest.approx((0.5 + 0.7) / 2)
    assert read("layout_device_ms.serve", art) == pytest.approx((3.0 + 2.0 + 4.0 + 1.0) / 2)
    assert read("host_syncs.serve", art) == pytest.approx(3.0)
    # layout's and bins' host intervals are back to back, each holding three
    # gaps; the markers' 1 µs inside them is device work
    assert read("layout_idle_ms.serve", art) == pytest.approx(6 * GAP_US * 1e-3)
    for name in ("project_device_ms.train", "layout_device_ms.train", "adam_device_ms.train",
                 "home_live_share.lazy", "resort_pack_ms.lazy"):
        assert read(name, art) is None, name


def test_training_metrics(records):
    records(TRAIN)
    art = _art(2, TRAIN_OPS)
    # project 2 + 1, backward's own work 4 + 4 (its children left out)
    assert read("project_device_ms.train", art) == pytest.approx((3.0 + 8.0) / 2)
    assert read("layout_device_ms.train", art) == pytest.approx((4.0 + 2.5 + 1.0) / 2)
    assert read("adam_device_ms.train", art) == pytest.approx((1.5 + 0.5) / 2)
    assert read("home_live_share.lazy", art) == pytest.approx(100.0 * 500.0 / 2000.0)
    assert read("resort_pack_ms.lazy", art) == pytest.approx((25.0 + 25.0) / 2)
    for name in ("project_device_ms.serve", "layout_device_ms.serve", "layout_idle_ms.serve",
                 "host_syncs.serve"):
        assert read(name, art) is None, name


def test_busy_time_is_the_spans_own_work():
    from gsbench import program_trace as pt

    snap = {"spans": [dict(s) for s in TRAIN["spans"]], "marks": TRAIN["marks"]}
    assert pt.busy_ms(snap, TRAIN_OPS, "spin_kernel")
    ms = {(s["name"], s["root"]): s["device_ms"] for s in snap["spans"]}
    root = _roots(TRAIN, "step")[0]
    assert ms["step", root] == pytest.approx(2.0 + 4.0 + 2.5 + 4.0 + 3.0 + 1.0 + 1.5)
    assert ms["backward", root] == pytest.approx(8.0)
    opt = [s["device_ms"] for s in snap["spans"] if s["name"] == "optimizer"]
    assert opt[0] == 0.0 and opt[1] == pytest.approx(1.5)  # the first: only gaps


def test_lazy_steps_alone_have_no_layout_reading(records):
    lazy, ops = _window(("step", 0, ("optimizer", 0), ("project", 1.0),
                         ("backward", 4.0, ("blend_bwd", 2.0)), ("optimizer", 0.5)))
    records(lazy)
    art = _art(1, ops)
    assert read("layout_device_ms.train", art) is None
    assert read("project_device_ms.train", art) == pytest.approx(1.0 + 4.0)
    assert read("home_live_share.lazy", art) is None


def test_no_device_time_where_the_markers_are_not_the_tracers(records):
    records(SERVE)
    lost = list(SERVE_OPS)
    assert lost[4][0] == MARK_OP
    del lost[4]  # a marker the profiler lost
    art = _art(2, lost)
    for name in ("project_device_ms.serve", "layout_device_ms.serve"):
        assert read(name, art) is None, name
    assert read("host_syncs.serve", art) == pytest.approx(3.0)
    assert read("layout_idle_ms.serve", art) is not None


@pytest.mark.parametrize("name", NAMES)
def test_no_value_off_the_card_or_without_the_tracer(records, monkeypatch, name):
    train = name.endswith((".train", ".lazy"))
    records(TRAIN if train else SERVE)
    art = _art(2, TRAIN_OPS if train else SERVE_OPS)
    assert read(name, art) is not None
    assert read(name, dict(art, cuda=False)) is None
    records({"spans": [], "marks": 0, "counts": {}})
    assert read(name, art) is None
    import gsjax_torch

    monkeypatch.delattr(gsjax_torch, "trace")  # a port without a tracer
    monkeypatch.setitem(sys.modules, "gsjax_torch.trace", None)
    assert read(name, art) is None


def test_on_the_card_the_roots_hold_the_windows_work():
    """A traced window of served frames and exact steps on the card: the
    trace holds each of the tracer's markers, and the roots' busy device
    times add up to the busy time of every operation that is not a
    marker (each ran inside a root)."""
    import time

    import torch

    import gsjax_torch as gt
    from gsbench import program_trace as pt
    from gsjax_torch import kernels, trace
    from gsjax_torch.bench.synth import bonsai_like

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the markers run there")
    dev = torch.device("cuda")
    cam = gt.Camera.look_at(position=(0.0, -0.6, -4.0), target=(0.0, 0.0, 0.0), fx=160.0,
                            fy=160.0, width=192, height=128, device=dev)
    cfg = gt.RenderConfig(chunk=32, fat_max_blocks=64, fat_cap=8192)
    g = bonsai_like(n=3000, sh_degree=1, device=dev)
    step = gt.train.make_step_fn(cam, cfg, gt.train.default_optimizer(g))
    with torch.no_grad():
        target = gt.render(g, cam, cfg) * 0.5
    step(g, target)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(3):
            with torch.no_grad():
                gt.render(g, cam, cfg)
            step(g, target)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    art = harness.trace_artefacts(prof, window_s)
    art.update(units=3, cuda=True)
    snap = pt.records(art)
    kernels.reset_launches()
    marks = [n for n, _, _ in art["device_ops"] if trace.MARK in n]
    assert snap is not None and len(marks) == snap["marks"] > 0, (len(marks), snap)
    assert pt.busy_ms(snap, art["device_ops"], trace.MARK)
    work = pt.union((s, s + d) for n, s, d in art["device_ops"] if trace.MARK not in n)
    roots = sum(s["device_ms"] for s in snap["spans"] if s["parent"] == -1)
    assert roots == pytest.approx(sum(e - s for s, e in work) * 1e-3, rel=1e-6)
    assert 0 < pt.device_ms(pt.under(snap, "render"), "project") < roots
