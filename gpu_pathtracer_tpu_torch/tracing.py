"""The port's tracer: spans at the layer boundaries of the wavefront step and
the port's counters, kept in memory.

A **frame** is one `render_image` call (`render.frame`), the root of its
spans.  A **span** has a name, optional attributes (`integrator.step` carries
its `bounce`), a start and an end on the host clock, its parent, and its
frame's id; on a CUDA device it also records a `torch.cuda.Event` at each
edge, and its device time (`Span.device_ms`) is the elapsed time between the
two, resolved lazily, after the caller has synchronised.  That is what the
span holds of the card's timeline: busy time plus any idle between its
edges.  The ring keeps the last `RING_FRAMES` frames.

The spans of the wavefront step (`render/integrator.py`, `ops/trace.py`,
`ops/closest_hit.py`, `ops/anyhit.py`):

    render.frame
      integrator.sample                 one sample of one chunk of pixels
        integrator.step (bounce=i)      one bounce of `trace_paths`; its four
          dispatch.closest_hit          children tile it, in this order
            kernel.closest_hit          the kernel launch (CPU: plain version)
          shading.surface
          shading.nee
          shading.accumulate

and `dispatch.anyhit` / `kernel.anyhit` for the windowed any-hit query.

**Off** unless a `torch.profiler` session is active or the caller opened
`capture()`.  Off, a span costs one flag check and records, allocates,
launches and synchronises nothing.  On, under a profiler, each span also
enters `torch.profiler.record_function(name)`, so it lands on the
profiler's timeline (a profile with CPU activity keeps it; one with CUDA
activity alone drops it); on a CUDA device the frame sets `torch.cuda.set_sync_debug_mode`
to "warn" and counts every synchronising call torch reports as the counter
`host_sync`, printing nothing, and restores the mode and the warning filters
when it ends.  Tracing adds no kernel and no synchronisation (CUDA events are
neither).  Spans opened outside a frame reach the profiler only.

**Counters** (`count`) keep a running total in `totals` whether tracing is
on or off (the integer add that the counters they replace made), and, inside
a frame, add to the innermost open span:

    launch.<kernel>       a launch of one of the port's kernels (`KERNELS`: the
                          five tile kernels, the NEE/MIS kernel `nee_dense` and
                          the surface shading kernel `shade_surface`)
    loop_exit             a data-dependent loop exit or compaction of the
                          program (a `.any()` or a count read on the host)
    collective.<op>       a collective through `parallel.shard.Mesh`
    host_sync             a synchronising call reported by torch (CUDA, on)

A loop exit is a host synchronisation too; on a CUDA device `host_sync`
already counts it, so no metric adds the two.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
import warnings

import torch

RING_FRAMES = 64  # frames kept
# every span the port opens; under a profile with CPU activity each one also
# marks the device's timeline, where it is no work
SPANS = ("render.frame", "integrator.sample", "integrator.step", "dispatch.closest_hit",
         "kernel.closest_hit", "shading.surface", "shading.nee", "shading.accumulate",
         "dispatch.anyhit", "kernel.anyhit")
KERNELS = ("closest_hit", "closest_hit_pipe", "closest_hit_mxu", "anyhit", "anyhit_pipe",
           "nee_dense", "shade_surface")
# the message of torch's synchronisation check (c10/cuda, sync debug mode "warn")
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_profiler_enabled = torch._C._autograd._profiler_enabled


class Span:
    """One recorded span; also the context manager that records it."""

    __slots__ = ("name", "attrs", "parent", "frame", "t0", "t1", "counters", "_tracer",
                 "_rf", "_events", "_device_ms")

    def __init__(self, tracer, name: str, attrs: dict, parent, frame_id: int):
        self.name, self.attrs, self.parent, self.frame = name, attrs, parent, frame_id
        self.t0 = self.t1 = None
        self.counters: dict = {}
        self._tracer = tracer
        self._rf = None
        self._events = None
        self._device_ms = None

    def __enter__(self):
        tr = self._tracer
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if tr._stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(tr._stream)
            self._events = (ev, None)
        tr._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        self.t1 = time.perf_counter()
        if self._events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(tr._stream)
            self._events = (self._events[0], ev)
        tr._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)

    @property
    def device_ms(self) -> float | None:
        """Milliseconds of the card's timeline between the span's edges (None
        off a CUDA device).  Needs the device to have passed the end edge."""
        if self._events is not None:
            start, end = self._events
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class Frame:
    """The spans of one frame, in the order they opened (the root first)."""

    def __init__(self, frame_id: int, name: str, device: torch.device):
        self.id, self.name, self.device = frame_id, name, device
        self.spans: list[Span] = []
        self.sync_hook = False  # whether torch's synchronising calls were counted

    @property
    def root(self) -> Span:
        return self.spans[0]

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent is span]

    def counter(self, name: str) -> int:
        """The counter's total over the frame."""
        return sum(s.counters.get(name, 0) for s in self.spans)

    def device_ms(self, name: str) -> float | None:
        """Summed device time of the frame's spans called `name` (None off a
        CUDA device or when there are none)."""
        times = [s.device_ms for s in self.named(name)]
        return sum(times) if times and None not in times else None


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _FrameSpan(Span):
    """The root span: opens the frame, and on a CUDA device the sync hook."""

    __slots__ = ("_record", "_mode", "_warnings")

    def __init__(self, tracer, record: Frame):
        super().__init__(tracer, record.name, {}, None, record.id)
        self._record = record
        self._mode = self._warnings = None

    def __enter__(self):
        tr, record = self._tracer, self._record
        tr._frame = record
        record.spans.append(self)
        if record.device.type == "cuda":
            tr._stream = torch.cuda.current_stream(record.device)
            self._hook_syncs()
            record.sync_hook = True
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        tr = self._tracer
        if self._warnings is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._warnings.__exit__(None, None, None)
            self._warnings = None
        tr._frame = tr._stream = None
        tr._ring.append(self._record)
        return False

    def _hook_syncs(self) -> None:
        tr = self._tracer
        self._mode = torch.cuda.get_sync_debug_mode()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_MESSAGE):
                tr.count("host_sync")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")


class Tracer:
    """The spans of the last `RING_FRAMES` frames and the counters' totals;
    the port records into the one instance `TRACER`."""

    def __init__(self):
        self.totals = collections.Counter()
        self._ring = collections.deque(maxlen=RING_FRAMES)
        self._ids = itertools.count()
        self._captures = 0
        self._frame: Frame | None = None
        self._stream = None
        self._stack: list[Span] = []

    # -- switches ----------------------------------------------------------

    def enabled(self) -> bool:
        return bool(self._captures) or _profiler_enabled()

    @contextlib.contextmanager
    def capture(self):
        """Tracing on for the `with` block, profiler or not."""
        self._captures += 1
        try:
            yield self
        finally:
            self._captures -= 1

    # -- spans ---------------------------------------------------------------

    def span(self, name: str, **attrs):
        """A span of the open frame (a profiler annotation alone outside one)."""
        if not (self._captures or _profiler_enabled()):
            return _OFF
        if self._frame is None:
            return torch.profiler.record_function(name) if _profiler_enabled() else _OFF
        span = Span(self, name, attrs, self._stack[-1], self._frame.id)
        self._frame.spans.append(span)
        return span

    def frame(self, name: str, device: torch.device):
        """The root span of a frame on `device`; inside an open frame, a span."""
        if not (self._captures or _profiler_enabled()):
            return _OFF
        if self._frame is not None:
            return self.span(name)
        return _FrameSpan(self, Frame(next(self._ids), name, torch.device(device)))

    # -- counters --------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self.totals[name] += n
        if self._stack:
            c = self._stack[-1].counters
            c[name] = c.get(name, 0) + n

    def counts(self, prefix: str) -> dict:
        """The non-zero totals whose names start with `prefix`, by the rest
        of the name."""
        return {k[len(prefix):]: v for k, v in self.totals.items() if k.startswith(prefix) and v}

    def launches(self) -> dict:
        """Every kernel's launches so far, by kernel."""
        return {k: self.totals[f"launch.{k}"] for k in KERNELS}

    def reset(self, prefix: str = "") -> None:
        """Zero the totals whose names start with `prefix`."""
        for k in [k for k in self.totals if k.startswith(prefix)]:
            del self.totals[k]

    # -- the ring ----------------------------------------------------------------

    def frames(self) -> list[Frame]:
        """The recorded frames, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def per_frame(self, units: int, read) -> float | None:
        """The mean of `read(frame)` over the last `units` recorded frames;
        None when there are none or `read` gives None for any."""
        values = [read(f) for f in self.frames()[-units:]] if units else []
        return sum(values) / len(values) if values and None not in values else None


TRACER = Tracer()
span = TRACER.span
frame = TRACER.frame
count = TRACER.count
counts = TRACER.counts
launches = TRACER.launches
reset = TRACER.reset
capture = TRACER.capture
enabled = TRACER.enabled
frames = TRACER.frames
clear = TRACER.clear
per_frame = TRACER.per_frame
totals = TRACER.totals
