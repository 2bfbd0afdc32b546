"""Top-level renderer: master-file config -> image file (port of
`gpu_pathtracer_tpu.renderer`: path tracing and SPPM).

Usage:

    python -m gpu_pathtracer_tpu_torch.cli <master_file_path> <image_output_path> [--device cpu]

The device is the CUDA device; `--device cpu` runs the kernels' plain
versions on the CPU and exists for tests.  The renderer never picks the CPU
on its own.  `render_mode` 2 in the master file selects the SPPM render
(`render.sppm.render_sppm`), which writes its progress images beside the
output image.  `sss_pts_per_object > 0` samples the SSS point clouds, runs
their first pass and writes the `_pts.ppm` splat before the render.

`shard_rays 1` in the master file shards the render over every process of
the job (`parallel/`; on one process, over that one): path tracing through
`parallel.shard.render_image_distributed`, whose image is the unsharded
render's bit for bit, SPPM through `parallel.sppm_shard.render_sppm_distributed`.
On N GPUs of one host, one process each:

    GPT_TPU_AUTO_DISTRIBUTED=1 torchrun --nproc_per_node=N \
        -m gpu_pathtracer_tpu_torch.cli <master_file_path> <image_output_path>

or start N processes with `GPT_TPU_COORDINATOR=host:port`,
`GPT_TPU_NUM_PROCESSES=N` and `GPT_TPU_PROCESS_ID=0..N-1`.  Each process
renders on its own GPU (NCCL); rank 0 writes the image.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.device import resolve_device
from gpu_pathtracer_tpu_torch.parallel import dist as pdist
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import Scene, build_scene
from gpu_pathtracer_tpu_torch.utils.config import RenderConfig, parse_master_file
from gpu_pathtracer_tpu_torch.utils.image import save_png, save_ppm
from gpu_pathtracer_tpu_torch.utils.obj_io import _load_image_rgb as load_image_rgb
from gpu_pathtracer_tpu_torch.utils.obj_io import load_scene


class _Stage:
    """Stage timing banner; synchronizes the device before reading the clock."""

    def __init__(self, stage: str, device: torch.device | None = None):
        self.stage, self.device = stage, device

    def __enter__(self):
        print(f"[gpu_pathtracer_tpu_torch] {self.stage} ...", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.t0
        print(f"[gpu_pathtracer_tpu_torch] {self.stage} done in {self.seconds:.2f}s", flush=True)


def load_scene_from_config(cfg: RenderConfig, device: torch.device) -> tuple[Scene, Camera]:
    with _Stage("scene load"):
        host = load_scene(cfg.input_folder_path, cfg.obj_filename)
        sky_image = None
        if cfg.texture_bg_path:
            p = pathlib.Path(cfg.texture_bg_path)
            if not p.is_absolute():
                p = pathlib.Path(cfg.input_folder_path) / p
            if p.exists():
                sky_image = np.asarray(load_image_rgb(p))[::-1]
    with _Stage("device scene build", device):
        scene = build_scene(host, device, sky_emission=cfg.sky_emission, sky_image=sky_image)
    camera = Camera.create(
        eye=cfg.eye, center=cfg.center, up=cfg.up, fovy_deg=cfg.fovy,
        width=cfg.image_width, height=cfg.image_height,
        aperture=cfg.aperture, focus_dist=cfg.focus_dist, device=device,
    )
    return scene, camera


def render_from_config(cfg: RenderConfig, device=None, pass_log=None) -> np.ndarray:
    """Render and return (H, W, 3) linear radiance as numpy.  `device`
    None means the CUDA device (required).  `pass_log`, a list, receives the
    SPPM render's per-pass records (`render_sppm`).  With `cfg.shard_rays`
    the render is sharded over `parallel.dist.global_mesh()` and every
    process returns the whole image; only rank 0 writes files."""
    from gpu_pathtracer_tpu_torch.render.integrator import render_image

    dev = resolve_device(device)
    mesh = pdist.global_mesh(dev) if cfg.shard_rays else None
    writes = mesh is None or mesh.rank == 0
    sharded = "" if mesh is None else f" (sharded over {mesh.size} processes)"
    scene, camera = load_scene_from_config(cfg, dev)
    out = pathlib.Path(cfg.image_output_path)
    if cfg.sss_pts_per_object > 0:
        from gpu_pathtracer_tpu_torch.render.splat import splat_points
        from gpu_pathtracer_tpu_torch.render.sss import attach_sss

        # a stream of its own, so the render's numbers do not depend on the cloud's
        sss_generator = torch.Generator(device=dev).manual_seed(cfg.seed + 777)
        with torch.no_grad(), _Stage("SSS point cloud + first pass", dev):
            scene = attach_sss(
                scene, cfg.sss_pts_per_object, sample_size=cfg.pathtracing_sample_size,
                level=cfg.pathtracing_level, hittable_pdf_weight=cfg.hittable_pdf_weight,
                generator=sss_generator,
            )
        if scene.sss is not None and writes:
            pts = splat_points(camera, scene.sss.pos, scene.sss.color, cfg.image_width,
                               cfg.image_height, scene.sss.valid)
            save_ppm(pts.cpu().numpy(), f"{out.with_suffix('')}_pts.ppm")
    if cfg.render_mode == 2:
        from gpu_pathtracer_tpu_torch.parallel.sppm_shard import render_sppm_distributed
        from gpu_pathtracer_tpu_torch.render.sppm import render_sppm

        with torch.no_grad(), _Stage(f"SPPM render{sharded}", dev) as st:
            prefix = str(out.with_suffix(""))
            if mesh is None:
                img = render_sppm(scene, camera, cfg, cfg.seed, output_prefix=prefix,
                                  pass_log=pass_log)
            else:
                img = render_sppm_distributed(scene, camera, cfg, cfg.seed, mesh=mesh,
                                              output_prefix=prefix, pass_log=pass_log)
        photons = cfg.ppm_num_photon_per_pass * cfg.ppm_num_pass
        print(f"[gpu_pathtracer_tpu_torch] {photons} photons in {cfg.ppm_num_pass} passes on "
              f"{dev}: {photons / st.seconds:.0f} photons/s", flush=True)
        return img
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    rays = (cfg.image_width * cfg.image_height * cfg.pathtracing_sample_size
            * cfg.dof_sample_size * cfg.pathtracing_level)
    with torch.no_grad(), _Stage(f"path-tracing render{sharded}", dev) as st:
        # with a mesh: `parallel.shard.render_image_distributed`
        img = render_image(
            scene, camera,
            width=cfg.image_width,
            height=cfg.image_height,
            sample_size=cfg.pathtracing_sample_size,
            dof_sample_size=cfg.dof_sample_size,
            level=cfg.pathtracing_level,
            hittable_pdf_weight=cfg.hittable_pdf_weight,
            stack_size=cfg.max_stack,
            generator=generator,
            mesh=mesh,
        )
    print(f"[gpu_pathtracer_tpu_torch] {rays} rays on {dev}: "
          f"{rays / st.seconds:.0f} rays/s", flush=True)
    return img.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpu_pathtracer_tpu_torch.cli")
    ap.add_argument("master_file")
    ap.add_argument("image_output_path", nargs="?")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' is for tests)")
    args = ap.parse_args(argv)
    # a multi-process launch (see the module docstring); a no-op otherwise
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    pdist.init_distributed(backend="gloo" if on_cpu else None)
    cfg = parse_master_file(args.master_file)
    if args.image_output_path:
        cfg.image_output_path = args.image_output_path
    img = render_from_config(cfg, device=args.device)
    if pdist.global_mesh(args.device).rank != 0:
        return 0
    out = pathlib.Path(cfg.image_output_path)
    with _Stage(f"write {out}"):
        if out.suffix.lower() == ".png":
            save_png(img, out)
        else:
            save_ppm(img, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
