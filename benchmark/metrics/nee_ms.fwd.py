"""nee_ms.fwd: device milliseconds a frame of the spans `shading.nee` of the
port's tracer (`gpu_pathtracer_tpu_torch.tracing`): next-event estimation with
the light pick and the mixture pdf, one a wavefront step.  A span's device
time is the card's timeline between CUDA events at its edges (busy and
idle).  Over the last `run.units` recorded frames (the traced ones); None
where the program has no tracer or recorded no such frame."""


def read(run):
    try:
        from gpu_pathtracer_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.per_frame(run.units, lambda f: f.device_ms("shading.nee"))
