#!/usr/bin/env python3
"""The port's tracer on the frames of a benchmark cell: what a profiled frame
records, how its spans cover the frame, and what tracing costs when on.

    python3 scripts/trace_frames.py [--workload cornell.forward] [--seed N]
                                    [--pairs 3] [--out FILE.json]

Run from the root of a checkout with one CUDA card.  Builds the cell as
`benchmark/run.py` does (its loop, scene and warm-up), then:

1. renders `--pairs` pairs of frames without the profiler, with
   `tracing.capture()` off and on in turns (off, on, on, off, ...), host
   clock, each ended by the loop's synchronisation: the cost of tracing when
   on, and the spans of the frames it recorded (`unprofiled`);
2. renders one frame under `torch.profiler` with CUDA activity alone, as
   `benchmark/devtrace.py` profiles a traced window, and reports whether the
   tracer was on there, which of its spans reached the profiler's events
   (`kineto_results.events()`, host side and device side), the window's
   idle gaps named after the innermost host event open at their middle
   (`devtrace.reduce_events`) and its kernels' time;
3. renders one more frame under a profile with CPU activity too, where the
   spans are host annotations, and names each of the device's idle gaps
   after the innermost span open at its middle (`idle_by_span`; the CPU
   activity slows the host, so the gaps are longer than untraced), and each
   of the host's kernel launches after the innermost span open at its start
   (`launches`);
4. for each recorded frame (`gpu_pathtracer_tpu_torch.tracing`): the device
   time of `render.frame`, of its `integrator.step` spans, of each step's four
   children and of `kernel.closest_hit`, the coverage shares, and the
   `host_sync` / `loop_exit` counters by span; and the benchmark's four span
   metrics, from their readers (`benchmark/metrics/`), over the unprofiled
   frames and over the profiled one.

Prints one JSON line (also written to `--out`); the card's name and power
limit in it.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import devtrace  # noqa: E402
import run as bench  # noqa: E402
from gpu_pathtracer_tpu_torch import tracing  # noqa: E402
from gpu_pathtracer_tpu_torch.device import nvidia_smi, require_cuda  # noqa: E402

CHILDREN = ("dispatch.closest_hit", "shading.surface", "shading.nee", "shading.accumulate")
SPANS = set(tracing.SPANS)
METRICS = ("host_syncs.fwd", "dispatch_ms.fwd", "nee_ms.fwd", "shading_ms.fwd")


def profiled_frame(loop) -> dict:
    """One frame under a CUDA-only profile, as the traced window runs it."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on = tracing.enabled()
        with record_function(devtrace.WINDOW):
            loop.unit()
    events = list(prof.profiler.kineto_results.events())
    annotations = collections.Counter()  # events named after a span or the window
    for ev in events:
        if ev.name() in SPANS or ev.name() == devtrace.WINDOW:
            side = "device" if ev.device_type() == torch.autograd.DeviceType.CUDA else "host"
            annotations[f"{side}:{ev.name()}"] += 1
    trace = devtrace.reduce_events(events)
    run = types.SimpleNamespace(trace=trace, units=1)
    return {"tracer_on_under_cuda_only_profile": on, "annotations": dict(annotations),
            "breakdown": trace.breakdown(), "busy_s": trace.busy_s, "window_s": trace.window_s,
            **{name: reader(name)(run) for name in ("launches_per_frame.fwd", "closest_hit_ms.fwd")}}


def idle_by_span(loop) -> dict:
    """One frame under a CPU + CUDA profile: the device's idle seconds by the
    innermost tracer span open on the host at the middle of each gap, and
    the host's kernel launches by the innermost span open at each launch."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.unit()
    events = list(prof.profiler.kineto_results.events())
    return {"busy_s": devtrace.reduce_events(events).busy_s, "idle_s": span_gaps(events),
            "launches": span_launches(events)}


def _innermost(spans, t, state):
    """The name of the innermost span open at time t (spans sorted by start;
    `state` [next index, open spans] carries over increasing t)."""
    while state[0] < len(spans) and spans[state[0]][0] <= t:
        state[1].append(spans[state[0]])
        state[0] += 1
    state[1] = [sp for sp in state[1] if sp[1] > t]
    return max(state[1])[2] if state[1] else "(no span)"


def span_launches(events) -> dict:
    """The host's kernel launches (`cudaLaunchKernel` or `cuLaunchKernel` calls), by
    the innermost span of the step tree open at each launch's start."""
    from torch.autograd import DeviceType

    launches, spans = [], []
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            continue
        if ev.name() in SPANS:
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
        elif ev.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches.append(ev.start_ns())
    spans.sort()
    counts, state = collections.Counter(), [0, []]
    for t in sorted(launches):
        counts[_innermost(spans, t, state)] += 1
    return dict(counts)


def span_gaps(events) -> dict:
    """Idle seconds between the device's events, by the innermost span of the
    step tree open on the host at each gap's middle."""
    from torch.autograd import DeviceType

    busy, spans = [], []
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if ev.name() not in SPANS:  # a span's mark on the device's timeline is no work
                busy.append((start, end))
        elif ev.name() in SPANS:
            spans.append((start, end, ev.name()))
    busy.sort()
    spans.sort()
    idle, state = collections.Counter(), [0, []]
    cursor = busy[0][0] if busy else 0
    for start, end in busy:
        if start > cursor:
            idle[_innermost(spans, (start + cursor) // 2, state)] += (start - cursor) * 1e-9
        cursor = max(cursor, end)
    return dict(idle)


def reader(name: str):
    """The benchmark's reader of the metric `name`."""
    return bench.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read


def span_metrics(units: int) -> dict:
    """The benchmark's span metrics over the last `units` recorded frames, as
    its readers compute them."""
    run = types.SimpleNamespace(units=units)
    return {name: reader(name)(run) for name in METRICS}


def coverage(frame) -> dict:
    """Device-time shares of the frame's spans, and its counters by span."""
    frame_ms = frame.root.device_ms
    steps = frame.named("integrator.step")
    step_ms = sum(s.device_ms for s in steps)
    children_ms = {name: 0.0 for name in CHILDREN}
    worst = 1.0
    for s in steps:
        kids = frame.children(s)
        assert tuple(k.name for k in kids) == CHILDREN, [k.name for k in kids]
        for k in kids:
            children_ms[k.name] += k.device_ms
        worst = min(worst, sum(k.device_ms for k in kids) / s.device_ms)
    by_span = collections.defaultdict(collections.Counter)
    for s in frame.spans:
        for name, n in s.counters.items():
            by_span[name][s.name] += n
    return {"frame_ms": frame_ms, "host_ms": frame.root.host_ms, "steps": len(steps),
            "step_ms": step_ms, "step_share": step_ms / frame_ms,
            "children_ms": children_ms,
            "children_share": sum(children_ms.values()) / step_ms,
            "children_share_worst_step": worst,
            "kernel_closest_hit_ms": frame.device_ms("kernel.closest_hit"),
            "counters": {k: dict(v) for k, v in by_span.items()},
            "host_sync": frame.counter("host_sync"), "loop_exit": frame.counter("loop_exit")}


def overhead(loop, pairs: int) -> dict:
    """Untraced frames, `tracing.capture()` off and on in turns."""
    seconds = {"off": [], "on": []}
    for i in range(pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            t0 = time.perf_counter()
            if mode == "on":
                with tracing.capture():
                    loop.unit()
            else:
                loop.unit()
            seconds[mode].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in seconds.items()}
    return {"seconds": seconds, "median_s": med, "cost": med["on"] / med["off"] - 1.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cornell.forward")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = require_cuda()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    r = bench.resolve(spec, args.workload)
    loop = bench.load_module(ROOT / "benchmark" / "loops" / f"{r['traffic']['loop']}.py").Loop(
        r["config"], r["traffic"], args.seed, dev)
    loop.setup()
    out = {"card": nvidia_smi(), "torch": torch.__version__, "workload": args.workload,
           "seed": args.seed}
    tracing.clear()
    out["overhead"] = overhead(loop, args.pairs)
    unprofiled = tracing.frames()
    out["unprofiled"] = [coverage(f) for f in unprofiled]
    out["unprofiled_metrics"] = span_metrics(len(unprofiled))
    out["profiled"] = profiled_frame(loop)
    frames = tracing.frames()
    out["coverage"] = coverage(frames[-1]) if frames else None
    out["metrics"] = span_metrics(1) if frames else None
    out["idle_by_span"] = idle_by_span(loop)
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
