"""host_syncs.fwd: synchronising calls torch reported inside `render.frame`
(the counter `host_sync` of the port's tracer, `gpu_pathtracer_tpu_torch.tracing`,
which counts them on a CUDA device while a profiler runs), a frame, over the
last `run.units` frames the tracer recorded: the traced frames (the warm-up
and the untraced frames run with the profiler off and record nothing).  None
where the program has no tracer or recorded no such frame."""


def read(run):
    try:
        from gpu_pathtracer_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.per_frame(run.units, lambda f: f.counter("host_sync") if f.sync_hook else None)
