"""shading_ms.fwd: device milliseconds a frame of the spans `shading.surface`
(hit interpolation and the BSDF sample) and `shading.accumulate` (emission,
sky, throughput, the SSS gather, the dielectric stack) of the port's tracer
(`gpu_pathtracer_tpu_torch.tracing`), one of each a wavefront step.  A span's
device time is the card's timeline between CUDA events at its edges (busy
and idle).  Over the last `run.units` recorded frames (the traced ones);
None where the program has no tracer or recorded no such frame."""


def shading_ms(frame):
    ms = [frame.device_ms(name) for name in ("shading.surface", "shading.accumulate")]
    return None if None in ms else sum(ms)


def read(run):
    try:
        from gpu_pathtracer_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.per_frame(run.units, shading_ms)
