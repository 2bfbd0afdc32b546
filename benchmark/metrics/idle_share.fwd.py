"""idle_share.fwd: 100 * (1 - the device's busy seconds a frame / the
seconds of a frame without the profiler).  The busy seconds are the union of
the device's intervals over the traced frames; the frame's seconds are the
host clock's over the frames the traced run renders first, untraced.  The
profiler's own cost on the host (it slows each launch) is thus left out: it
is in the result's `device.busy_s` / `device.window_s`, not here."""


def read(run):
    if run.trace is None or not run.trace.device or not run.units or not run.untraced_unit_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.units / run.untraced_unit_s)
