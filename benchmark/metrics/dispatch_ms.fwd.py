"""dispatch_ms.fwd: device milliseconds a frame of the closest-hit queries'
dispatch, the spans `dispatch.closest_hit` of the port's tracer
(`gpu_pathtracer_tpu_torch.tracing`) less their `kernel.closest_hit` children:
the coherence sort, the inverse permutation, `prepare_rays`,
`block_tile_order` and `winner_bary`.  A span's device time is the card's
timeline between CUDA events at its edges (busy and idle).  Over the last
`run.units` recorded frames (the traced ones); None where the program has no
tracer or recorded no such frame."""


def dispatch_ms(frame):
    ms = 0.0
    for s in frame.named("dispatch.closest_hit"):
        kernel = [c.device_ms for c in frame.children(s) if c.name == "kernel.closest_hit"]
        if s.device_ms is None or None in kernel:
            return None
        ms += s.device_ms - sum(kernel)
    return ms


def read(run):
    try:
        from gpu_pathtracer_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.per_frame(run.units, dispatch_ms)
