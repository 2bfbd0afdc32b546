"""closest_hit_ms.fwd: device milliseconds a frame of the kernels built from
`csrc/closest_hit*.cu` (`closest_hit_kernel`, `closest_hit_pipe_kernel`,
`closest_hit_mxu_kernel`), matched by name in the traced window."""

import re

# as the profiler names them, e.g. "(anonymous namespace)::closest_hit_kernel(float const*, ..."
NAMES = re.compile(r"(^|[\s:])closest_hit(_pipe|_mxu)?_kernel\(")


def read(run):
    if run.trace is None or not run.units:
        return None
    seconds = [sec for name, (_, sec) in run.trace.kernels().items() if NAMES.search(name)]
    return 1e3 * sum(seconds) / run.units if seconds else None
