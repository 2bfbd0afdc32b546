from gpu_pathtracer_tpu_torch.render.integrator import render_image, trace_paths  # noqa: F401
from gpu_pathtracer_tpu_torch.render.sppm import (  # noqa: F401
    render_sppm,
    render_sppm_differentiable,
)
