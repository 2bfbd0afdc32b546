#!/usr/bin/env python3
"""How far the card's renders of phases 19 and 20 of `chip_smoke.py` can be
from their CPU references without a fault: the spread of a reference-sized
render over seeds, and what the mesh's subdivision and the frame's size do
to the means.  Needs one CUDA card; about 6 minutes, most of it the CPU's.

    python3 scripts/reference_spread.py [mesh] [glass]

mesh: the textured mesh of phase 19 (map_Kd + map_Bump + its sky) on the
card at subdiv 3, 4, 5 and 7: 64x64 at 256 samples a pixel, and 64x64 at 8
samples over 8 seeds (the reference's size); subdiv 7 at 512x512, 8 samples;
the image mean and the mean over the mesh's pixels.
glass: the glass + depth-of-field box of phase 20 through
`renderer.render_from_config`: on the card 64x64 at 8 x 2 lens samples over
8 seeds and at 128 x 2, 512x512 at 4 x 2 over 3 seeds and at 32 x 2; on
the CPU 64x64 at 8 x 2 over 3 seeds.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402


def mesh_spread(dev) -> None:
    import torch
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.render.integrator import render_image

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="reference_spread_"))
    skw = dict(sky_emission=(1.0, 1.0, 1.0),
               sky_image=cs.sky_image(cs.TEX["sky_h"], cs.TEX["sky_w"], cs.TEX["sky_band"]))

    def means(scene, side, spp, seed):
        cam = Camera.create(**cs.MESH_CAM, width=side, height=side, device=dev)
        with torch.no_grad():
            img = render_image(scene, cam, side, side, sample_size=spp, level=cs.MAIN["level"],
                               hittable_pdf_weight=cs.MAIN["weight"],
                               generator=torch.Generator(device=dev).manual_seed(seed))
        img = img.cpu().numpy()
        return round(float(img.mean()), 6), round(float(img[cs.mesh_pixels(scene, cam, side)].mean()), 6)

    for sub in (3, 4, 5, 7):
        scene = build_scene(cs.textured_mesh_host(tmp / str(sub), sub), dev, **skw)
        print(f"mesh subdiv {sub}: (image, mesh pixels) 64x64 spp 256 {means(scene, 64, 256, 12)}; "
              f"64x64 spp 8, seeds 12-19 {[means(scene, 64, 8, s) for s in range(12, 20)]}"
              + (f"; 512x512 spp 8 {means(scene, 512, 8, 12)}" if sub == 7 else ""), flush=True)


def glass_spread(dev) -> None:
    from gpu_pathtracer_tpu_torch import renderer
    from gpu_pathtracer_tpu_torch.utils import config, testscenes

    folder = pathlib.Path(tempfile.mkdtemp(prefix="reference_spread_glass_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2, glass_priority=True)

    def mean(side, spp, seed, device=None):
        cfg = cs.path_tracing_master(folder, "box.obj", config, pathtracing_sample_size=spp,
                                     dof_sample_size=cs.GLASS["dof"], image_width=side,
                                     image_height=side, seed=seed,
                                     aperture=cs.GLASS["aperture"],
                                     focus_dist=cs.GLASS["focus_dist"])
        return round(float(renderer.render_from_config(cfg, device=device).mean()), 6)

    print(f"glass card 64x64 8 x 2, seeds 0-7 {[mean(64, 8, s) for s in range(8)]}; "
          f"128 x 2 {mean(64, 128, 0)}", flush=True)
    print(f"glass card 512x512 4 x 2, seeds 0-2 {[mean(512, 4, s) for s in range(3)]}; "
          f"32 x 2 {mean(512, 32, 0)}", flush=True)
    t0 = time.perf_counter()
    print(f"glass CPU 64x64 8 x 2, seeds 0-2 {[mean(64, 8, s, 'cpu') for s in range(3)]} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


def main() -> int:
    from gpu_pathtracer_tpu_torch.device import require_cuda

    dev = require_cuda()
    print(cs.nvidia_smi(), flush=True)
    which = sys.argv[1:] or ["mesh", "glass"]
    if "mesh" in which:
        mesh_spread(dev)
    if "glass" in which:
        glass_spread(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
