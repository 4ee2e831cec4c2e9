"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The run
sets up (imports, CUDA, the port's kernel library built or loaded, the
inputs drawn on the card from the seed, autotune, targets, warm-up and
the first steps), measures for --seconds, checks what the timed path
produced against the plain reference (gsbench/reference), and prints as
its last line of standard output one JSON object: correct, attempted,
failed, metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics, read from a torch.profiler trace of the window by
gsbench/metrics/<name>.py), device (and with --trace 1 breakdown), then
checks, each number compared beside its limit. The same numbers end
standard error.

It exits non-zero and prints no result without CUDA or with fewer cards
than the cell asks for, without the port beside it, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types

from gsbench import harness

_START = harness.process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    man = harness.manifest()
    c = harness.cell(man, args.workload)
    import torch

    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process with one intra-op thread: the serving loop is host-bound,
    # and fewer threads spread its runs less (PERF.md)
    torch.set_num_threads(1)
    print(f"# card: {card_label()}", file=sys.stderr)
    result = run_cell(man, c, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"))
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"gsbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def emit(result: dict) -> None:
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))


def context(c: dict, seed: int, seconds: float, trace: bool, device):
    """What a kind's setup, window and reference read: the seed, the
    window's length, the configuration and traffic mix, the cameras (as
    numbers and as the port's), the render config, the clock and spans."""
    from gsbench import port
    from gsbench.inputs import cameras

    ctx = types.SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, device=device, config=c["config"],
        traffic=c["traffic"], clock=time.perf_counter, spans=harness.Spans(trace, device),
        cams=cameras.make(c["config"]["cameras"]))
    ctx.port_cams = [port.camera(cam, device) for cam in ctx.cams]
    ctx.cfg = port.render_config(c["config"]["render"])
    return ctx


def run_cell(man: dict, c: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, start: float | None = None) -> dict:
    """Set up, measure, check: the result line as a dict. On a CPU device
    (the rehearsal) the program runs its plain versions, and the result
    carries no metric and no device reading."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gsbench import compare, port

    start = _START if start is None else start
    traffic = c["traffic"]
    mod = harness.mode(traffic["kind"])
    ctx = context(c, seed, seconds, trace, device)
    port.load_kernels(device)
    state = mod.setup(ctx)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    from gsjax_torch import kernels
    kernels.reset_launches()
    setup_s = time.monotonic() - start
    win = mod.window(state, ctx)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = win["t1"] - win["t0"]
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(peak_window, peak_setup) if cuda else 0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    readings = state.readings
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"# {workload} seed {seed}: {win['units']} units in {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s, launches {launches}, "
          f"first steps {{{', '.join(f'{k}: {v}' for k, v in readings.items() if k != 'frames')}}}",
          file=sys.stderr)
    t_ref = time.monotonic()
    numbers, ref = mod.reference(ctx, readings)
    print(f"# reference ({time.monotonic() - t_ref:.1f} s): {ref}", file=sys.stderr)
    correct, checks = compare.judge(numbers, c["limits"])

    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    values = dict(win["e2e"], setup_s=setup_s)
    art = None
    if trace:
        art = harness.trace_artefacts(prof, window_s) if cuda else {
            "device_ops": [], "busy_s": 0.0, "window_s": window_s,
            "breakdown": {"device_ops": [], "idle_gaps": []}}
        art.update(units=win["units"], spans=ctx.spans.durations,
                   peak_window_bytes=peak_window,
                   work=mod.work(ctx, win["visits"]), cuda=cuda)
    for m in harness.metrics_for(man, workload, kind):
        v = harness.metric_reader(m["name"])(art) if trace else values.get(m["name"])
        if v is not None and cuda:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics}
    if cuda:
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": int(c["workload"]["chips"]), "memory_peak_bytes": int(peak)}
        if trace:
            out["device"].update(busy_s=art["busy_s"], window_s=window_s)
            out["breakdown"] = art["breakdown"]
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu (rehearsal: no device metric)",
                         "count": 0, "memory_peak_bytes": 0}
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
