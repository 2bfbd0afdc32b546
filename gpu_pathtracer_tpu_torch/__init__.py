"""gpu_pathtracer_tpu_torch — the PyTorch + CUDA port of gpu_pathtracer_tpu.

The JAX package `gpu_pathtracer_tpu` is the reference; this package mirrors
its layout (`ops/`, `models/`, `render/`, `parallel/`, `renderer.py`,
`cli.py`) so every module has an obvious counterpart.  Plain tensor code is
PyTorch; the closest-hit and windowed any-hit tile kernels, Pallas kernels in
the reference, are hand-written CUDA kernels for Hopper (`csrc/closest_hit.cu`,
`csrc/closest_hit_pipe.cu`, `csrc/closest_hit_mxu.cu`, `csrc/anyhit.cu`,
`csrc/anyhit_pipe.cu`), built at first use.  The scale-out (`parallel/`)
runs on `torch.distributed`: NCCL between GPUs, gloo between CPU processes.

The package imports `torch`, never `jax`, and nothing of `gpu_pathtracer_tpu`:
host-side parsing (OBJ/MTL, master files, images, test scenes) and the
constants are its own copies (`utils/`, `constants.py`).
"""

__version__ = "0.1.0"
