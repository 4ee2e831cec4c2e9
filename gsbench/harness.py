"""The harness's own machinery: the manifest and the files it names, the
cache directories, the clock, spans, and the traced window's device
activity. Nothing here knows a cell: configurations, traffic mixes,
limits and per-layer metrics are files found by the names in
BENCHMARK.json."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gsbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "gsjax")


def process_start() -> float:
    """time.monotonic() at this process's start, from /proc (the clock
    ticks since boot at which it started); the import time of this module
    where /proc has no answer."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port builds into gsjax_torch/_build/ itself; torch's extension builds
    and Triton's cache go under gsbench/_cache/."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(man: dict, workload: str) -> dict:
    """The workload entry, its configuration entry and file, its traffic
    mix's file and its limits' file, all found by name."""
    wl = {w["name"]: w for w in man["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = {c["name"]: c for c in man["configs"]}[wl["config"]]
    return {"workload": wl, "config_entry": conf,
            "config": load_json(os.path.join(ROOT, conf["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic", wl["traffic"] + ".json")),
            "limits": load_json(os.path.join(HERE, "limits", workload + ".json"))}


def metrics_for(man: dict, workload: str, kind: str) -> list:
    """The manifest's metrics of one kind ("end_to_end" or "per_layer")
    that the workload reports."""
    return [m for m in man[kind] if workload in m.get("workloads", [workload])]


def module_at(folder: str, name: str):
    """gsbench/<folder>/<name>.py, loaded from its file: the files a
    configuration or a per-layer metric names, found by that name."""
    path = os.path.join(HERE, folder, name + ".py")
    mod = _LOADED.get(path)
    if mod is None:
        key = "gsbench_" + "".join(ch if ch.isalnum() else "_" for ch in f"{folder}/{name}")
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not os.path.isfile(path):
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return mod


_LOADED: dict = {}


def metric_reader(name: str):
    """gsbench/metrics/<name>.py's read(art)."""
    return module_at("metrics", name).read


def mode(kind: str):
    """The general generator of a traffic mix's kind
    (gsbench/modes/<kind>.py)."""
    return importlib.import_module(f"gsbench.modes.{kind}")


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


class Spans:
    """The harness's spans: durations by name, and while tracing a
    record_function range of the same name ("gsbench.<name>") on the
    profiler's timeline. sync=True synchronises the device at both ends
    (only while tracing: the untraced window adds no host sync)."""

    def __init__(self, tracing: bool, device):
        self.tracing = tracing
        self.device = device
        self.durations: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False, always: bool = False):
        import torch

        if not (self.tracing or always):
            yield
            return
        cuda = self.device.type == "cuda"
        if sync and cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("gsbench." + name):
            yield
        if sync and cuda:
            torch.cuda.synchronize(self.device)
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# --------------------------------------------------------------------------
# the traced window
# --------------------------------------------------------------------------


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_artefacts(prof, window_s: float) -> dict:
    """From a torch.profiler run over the window: the device's operations
    [(name, start_us, dur_us)], busy_s (the union of their intervals),
    and the breakdown: the 10 device operations that took most time, and
    the 10 longest idle gaps named by the host's work under them (the
    harness span and the innermost host operation open at the gap's
    middle)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and d > 0:
                dev.append((e.name(), s, d))
        elif d >= 0:
            host.append((e.name(), s, s + d))
    merged = _union((s, s + d) for _, s, d in dev)
    busy_us = sum(e - s for s, e in merged)
    by_name: dict = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    host.sort(key=lambda h: h[1])

    def label(mid):
        spans = [h for h in host if h[1] <= mid <= h[2]]
        harness = [h for h in spans if h[0].startswith("gsbench.")]
        inner = min(spans, key=lambda h: h[2] - h[1], default=None)
        parts = [harness[-1][0] if harness else "outside the harness spans"]
        if inner is not None and (not harness or inner is not harness[-1]):
            parts.append(inner[0])
        return " / ".join(parts)[:120]

    return {
        "device_ops": dev,
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "breakdown": {
            "device_ops": [[n[:120], d * 1e-6] for n, d in ops],
            "idle_gaps": [[label(0.5 * (a + b)), g * 1e-6] for g, a, b in gaps],
        },
    }


def kernel_seconds(art: dict, names) -> float:
    """Device seconds of the operations whose name contains one of
    `names`."""
    return sum(d for n, _, d in art["device_ops"] if any(k in n for k in names)) * 1e-6


def idle_share(art):
    """The device's idle share over the traced window, in %: 1 − the union
    of its operations' intervals over the window's wall time."""
    if not art["device_ops"]:
        return None
    return 100.0 * (1.0 - art["busy_s"] / art["window_s"])


def peak_gib(art):
    """The device's peak allocated memory over the window, in GiB."""
    if not art["cuda"]:
        return None
    return art["peak_window_bytes"] / 2**30
