"""The traced window: `torch.profiler` (CUPTI) over a few units of work, and
its reduction to what the per-layer readers and the breakdown take.

The window is the span of a `benchmark.window` annotation around the units.
Only the CUDA activity is recorded (kernels, copies, sets, and the CUDA
runtime calls that launch them on the host), which keeps the profiler's own
cost on the host small: host operators are not recorded.  Device activity
is every event on the CUDA device but the annotation's mark; busy time is
the union of their intervals inside the window.  An idle gap is named after
the innermost host event open at its midpoint (a runtime call such as
`cudaLaunchKernel` or `cudaStreamSynchronize`), or "(no host event)".
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW = "benchmark.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    # per device-event name: (count, seconds)
    device: dict
    idle_by_host: dict  # host operation -> idle seconds

    def kernels(self) -> dict:
        """`device` without the copies and sets."""
        return {k: v for k, v in self.device.items()
                if not k.startswith(("Memcpy", "Memset"))}

    def breakdown(self) -> dict:
        ops = sorted(self.device.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:160], sec] for name, (_, sec) in ops],
                "idle_gaps": [[name[:160], sec] for name, sec in gaps]}


def _span(ev):
    """(start, end) of a profiler event in nanoseconds."""
    if hasattr(ev, "start_ns"):
        start = ev.start_ns()
        return start, start + ev.duration_ns()
    start = ev.start_us() * 1000
    return start, start + ev.duration_us() * 1000


def profile_units(unit, count: int) -> Trace:
    """Run `unit()` `count` times under the profiler; the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(count):
                unit()
    return reduce_events(prof.profiler.kineto_results.events())


def reduce_events(events) -> Trace:
    from torch.autograd import DeviceType

    device, host = [], []
    w0 = w1 = None
    for ev in events:
        name = ev.name()
        start, end = _span(ev)
        kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
        annotation = name == WINDOW or "user_annotation" in kind
        if ev.device_type() == DeviceType.CUDA:
            if not annotation:  # the window's own mark on the device's timeline
                device.append((start, end, name))
        elif name == WINDOW:
            w0, w1 = start, end
        else:
            host.append((start, end, name))
    if w0 is None:
        spans = device + host
        w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)

    totals = defaultdict(lambda: [0, 0.0])
    busy = []
    for start, end, name in sorted(device):
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        t = totals[name]
        t[0] += 1
        t[1] += (end - start) * 1e-9
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    busy_s = sum(e - s for s, e in busy) * 1e-9

    # idle gaps, each named after the innermost host operation open at its middle
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host.sort()
    idle = defaultdict(float)
    open_ops, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            open_ops.append(host[i])
            i += 1
        open_ops = [op for op in open_ops if op[1] > mid]
        label = max(open_ops)[2] if open_ops else "(no host event)"
        idle[label] += (g1 - g0) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
                 device={k: (v[0], v[1]) for k, v in totals.items()}, idle_by_host=dict(idle))
