"""gsjax_torch.trace: the port's spans and counters record only while a
torch.profiler profile records, nest as the render, the exact step and
the lazy resort and step call them (one root a unit), mark the
profiler's own timeline, and change no output. On the card (skipped
without one): each span's markers in the device trace, and the
`host_syncs` counter against CUDA's own count of the host's waits."""

import os
import types
import warnings

import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels, trace
from gsjax_torch.bench.synth import bonsai_like


def _camera():
    return gt.Camera.look_at(position=(0.0, -0.6, -4.0), target=(0.0, 0.0, 0.0), fx=80.0,
                             fy=80.0, width=96, height=64, device="cpu")


CFG = gt.RenderConfig(chunk=32, fat_max_blocks=64, fat_cap=2048)


def _units():
    """A served frame, two exact steps, a lazy resort and two lazy steps
    on a fresh tiny scene, each a unit; their outputs."""
    cam = _camera()
    g = bonsai_like(n=300, sh_degree=1, device="cpu")
    with torch.no_grad():
        img = gt.render(g, cam, CFG)
    target = (img * 0.5).detach()
    step = gt.train.make_step_fn(cam, CFG, gt.train.default_optimizer(g))
    losses = [step(g, target) for _ in range(2)]
    g_lazy = bonsai_like(n=300, sh_degree=1, seed=1, device="cpu")
    tr = gt.LazyTrainer(g_lazy, CFG, torch.optim.Adam(g_lazy.parameters(), lr=1e-3))
    plan = tr.resort(cam)
    losses += [tr.step(target, cam) for _ in range(2)]
    tr.sync()
    return {"img": img, "losses": losses, "params": [p.detach().clone() for p in
                                                     (*g.parameters(), *g_lazy.parameters())],
            "plan": plan}


def _kineto(prof):
    """(name, start ns) of the profiler's gsjax_torch.* ranges, in order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gsjax_torch."):
            s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            out.append((e.name()[len("gsjax_torch."):], s))
    return sorted(out, key=lambda x: x[1])


@pytest.fixture(scope="module")
def runs():
    kernels.reset_launches()
    plain = _units()
    untraced = trace.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        kernels.reset_launches()
        traced = _units()
    snap = trace.snapshot()
    kernels.reset_launches()
    return {"plain": plain, "untraced": untraced, "traced": traced, "snap": snap,
            "kineto": _kineto(prof), "after_reset": trace.snapshot()}


def test_nothing_recorded_without_a_profile(runs):
    assert runs["untraced"] == {"spans": [], "marks": 0, "counts": {}}
    assert not trace.recording()
    assert trace.span("x") is trace.span("y")  # the shared null context
    trace.count("home_rows", 5)
    trace.host_sync(types.SimpleNamespace(is_cuda=True))
    assert trace.snapshot() == {"spans": [], "marks": 0, "counts": {}}


def test_outputs_bit_identical_with_tracing_on_and_off(runs):
    a, b = runs["plain"], runs["traced"]
    assert torch.equal(a["img"], b["img"])
    assert all(torch.equal(x, y) for x, y in zip(a["losses"], b["losses"]))
    assert len(a["params"]) == len(b["params"]) == 10
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))


def _tree(snap):
    """Each root's name and its spans as (name, parent's name) in entry
    order."""
    by_id = {s["id"]: s for s in snap["spans"]}
    roots = {}
    for s in snap["spans"]:
        if s["parent"] == -1:
            roots[s["id"]] = (s["name"], [])
        else:
            roots[s["root"]][1].append((s["name"], by_id[s["parent"]]["name"]))
    return list(roots.values())


EXACT_STEP = ("step", [("optimizer", "step"), ("render", "step"), ("project", "render"),
                       ("layout", "render"), ("bins", "render"), ("backward", "step"),
                       ("blend_bwd", "backward"), ("layout_bwd", "backward"),
                       ("optimizer", "step")])
RESORT = ("resort", [("fold", "resort"), ("plan", "resort"), ("project", "plan"),
                     ("layout", "plan"), ("bins", "plan"), ("extract", "resort")])
LAZY_STEP = ("step", [("optimizer", "step"), ("project", "step"), ("backward", "step"),
                      ("blend_bwd", "backward"), ("optimizer", "step")])
FRAME = ("render", [("project", "render"), ("layout", "render"), ("bins", "render")])


def test_spans_nest_with_one_root_a_unit(runs):
    snap = runs["snap"]
    assert _tree(snap) == [FRAME, EXACT_STEP, EXACT_STEP, RESORT, LAZY_STEP, LAZY_STEP]
    ids = [s["id"] for s in snap["spans"]]
    assert len(set(ids)) == len(ids)
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        assert s["t0_ns"] <= s["t1_ns"]
        # markers only where a CUDA context is open (none here, on the CPU)
        assert s["m0"] == s["m1"] == -1 or 0 <= s["m0"] < s["m1"] < snap["marks"]
        if s["parent"] != -1:
            p = by_id[s["parent"]]
            assert p["root"] == s["root"] and p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]


def test_counters_under_their_root(runs):
    snap, plan = runs["snap"], runs["traced"]["plan"]
    steps = [s["id"] for s in snap["spans"] if s["parent"] == -1 and s["name"] == "step"]
    live = float((plan.pidx < plan.n).sum())
    assert snap["counts"]["home_rows"] == [(r, float(plan.nh)) for r in steps[2:]]
    assert snap["counts"]["home_rows_live"] == [(r, live) for r in steps[2:]]
    assert 0 < live < plan.nh
    assert "host_syncs" not in snap["counts"]  # nothing waits on the CPU
    assert runs["after_reset"] == {"spans": [], "marks": 0, "counts": {}}  # reset_launches forgets


def test_each_span_marks_the_profilers_timeline(runs):
    snap, kin = runs["snap"], runs["kineto"]
    assert [n for n, _ in kin] == [s["name"] for s in snap["spans"]]
    for (_, start), s in zip(kin, snap["spans"]):
        assert abs(s["t0_ns"] - start) < 1_000_000, (s["name"], s["t0_ns"] - start)


def test_host_sync_counts_only_device_waits_while_recording():
    kernels.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("render"):
            trace.host_sync(types.SimpleNamespace(is_cuda=True))
            trace.host_sync(torch.zeros(1))
            with trace.span("bins"):
                trace.host_sync(types.SimpleNamespace(is_cuda=True))
        trace.host_sync(types.SimpleNamespace(is_cuda=True))
    snap = trace.snapshot()
    kernels.reset_launches()
    root = snap["spans"][0]["id"]
    assert snap["counts"] == {"host_syncs": [(root, 1.0), (root, 1.0), (-1, 1.0)]}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the markers and the host's waits are the device's")
    return torch.device("cuda")


def test_markers_in_the_device_trace_on_the_card():
    """Each span's two markers run on the card in launch order: the trace
    holds the tracer's count of them, and a span's markers bracket its
    children's."""
    dev = _card()
    cam = gt.Camera.look_at(position=(0.0, -0.6, -4.0), target=(0.0, 0.0, 0.0), fx=160.0,
                            fy=160.0, width=192, height=128, device=dev)
    g = bonsai_like(n=3000, sh_degree=1, device=dev)
    step = gt.train.make_step_fn(cam, CFG, gt.train.default_optimizer(g))
    with torch.no_grad():
        target = gt.render(g, cam, CFG) * 0.5
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        kernels.reset_launches()
        with torch.no_grad():
            gt.render(g, cam, CFG)
        step(g, target)
        torch.cuda.synchronize()
    snap = trace.snapshot()
    kernels.reset_launches()
    marks = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA and trace.MARK in e.name()]
    assert len(marks) == snap["marks"] == 2 * len(snap["spans"]) > 0
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        assert 0 <= s["m0"] < s["m1"]
        if s["parent"] != -1:
            assert by_id[s["parent"]]["m0"] < s["m0"] < s["m1"] < by_id[s["parent"]]["m1"]


def _synced(fn) -> tuple:
    """fn() under a CPU profile (so the tracer records) and CUDA's sync
    debug mode: the tracer's host_syncs, and CUDA's warnings raised from
    gsjax_torch's own lines by site (file:line → count)."""
    pkg = os.path.dirname(os.path.abspath(gt.__file__)) + os.sep
    kernels.reset_launches()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in seen:
        path = os.path.abspath(w.filename)
        if "synchroniz" in str(w.message) and path.startswith(pkg):
            site = f"{path[len(pkg):]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    counter = sum(v for _, v in trace.snapshot()["counts"].get("host_syncs", []))
    kernels.reset_launches()
    return counter, sites


def test_host_syncs_equal_cuda_sync_debug_count_on_the_card():
    """At the cells' scale (bonsai, 1.2M splats, SH 3, the 1080p orbit's
    budgets): a few served frames, exact steps, a lazy resort and lazy
    steps, each after one of its own: host_syncs equals the number of the
    port's synchronising calls that CUDA's sync debug mode warns of."""
    from gsjax_torch.bench.run import autotune, orbit_cameras, perturb
    from gsjax_torch.tools import BONSAI_ORBIT_CAPS

    dev = _card()
    cams = orbit_cameras(4, 1920, 1080, device=dev)
    g = bonsai_like(n=1_200_000, sh_degree=3, device=dev)
    cfg = autotune(g, cams, gt.RenderConfig(chunk=128, **BONSAI_ORBIT_CAPS))
    with torch.no_grad():
        targets = [gt.render(g, c, cfg) for c in cams]

    def serve():
        with torch.no_grad():
            for c in cams:
                gt.render(g, c, cfg)

    g_exact = perturb(g)
    opt = gt.train.default_optimizer(g_exact)
    steps = [gt.train.make_step_fn(c, cfg, opt) for c in cams]

    def exact():
        for step, t in zip(steps[:3], targets):
            step(g_exact, t)

    g_lazy = perturb(g)
    tr = gt.LazyTrainer(g_lazy, cfg, torch.optim.Adam(g_lazy.parameters(), lr=1e-3))

    def lazy():
        for _ in range(3):
            tr.step(targets[0], cams[0])

    got = {}
    for name, fn in (("serve", serve), ("exact", exact),
                     ("resort", lambda: tr.resort(cams[0])), ("lazy", lazy)):
        fn()
        got[name] = _synced(fn)
    print(got)
    for name, (counter, sites) in got.items():
        assert counter == sum(sites.values()), (name, counter, sites)
    assert got["serve"][0] > 0 and got["lazy"][0] == 0
