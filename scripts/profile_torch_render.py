#!/usr/bin/env python3
"""Where a render of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_render.py [cornell|mesh|mesh_prefilter|panel|sss] [--gradient]

Builds the scene of one `chip_smoke.py` main path (the Cornell box with
spheres, the 327,684-triangle mesh, the same mesh with the closest-hit edge
prefilter, the 2,048-emitter panel of the sparse light-tree regime, or the
SSS box with its 4,096-point cloud attached),
renders 512x512 at level 8 with
hittable_pdf_weight 0.5, one sample per pixel (4 chunks x 8 bounces = 32
wavefront steps of 65,536 rays), and prints:

* the wall time of one such render without the profiler (after a warm-up);
* from `torch.profiler` over one more: the device's busy time and its share
  of the unprofiled wall, the number of kernel launches, the loop exits
  of the sparse light regime and the SSS gather (the tracer's `loop_exit`)
  and, for the forward render, every synchronising call torch reported
  (`host_sync`), the closest-hit kernel's time, and the twelve largest
  kernels;
* CUDA-event times of the pieces of one closest-hit query on a captured
  bounce-2 wavefront: coherence sort, `prepare_rays`, `block_tile_order`,
  the kernel.
With `--gradient` the profiled call is the L2 loss's gradient to `ke`
(`render_image_value_and_grad`, spp 1) instead of the forward render.
Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gpu_pathtracer_tpu_torch import optim, tracing  # noqa: E402
from gpu_pathtracer_tpu_torch.device import require_cuda  # noqa: E402
from gpu_pathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from gpu_pathtracer_tpu_torch.models.scene import build_scene  # noqa: E402
from gpu_pathtracer_tpu_torch.ops import closest_hit as ch  # noqa: E402
from gpu_pathtracer_tpu_torch.ops import trace  # noqa: E402
from gpu_pathtracer_tpu_torch.render import sss  # noqa: E402
from gpu_pathtracer_tpu_torch.render.integrator import (  # noqa: E402
    render_image,
    render_image_value_and_grad,
)
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes  # noqa: E402

SIZE, LEVEL, WEIGHT = 512, 8, 0.5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="cornell",
                    choices=("cornell", "mesh", "mesh_prefilter", "panel", "sss"))
    ap.add_argument("--gradient", action="store_true")
    args = ap.parse_args()
    dev = require_cuda()
    print(f"card: {chip_smoke.nvidia_smi()}; torch {torch.__version__}", flush=True)

    if args.scene in ("mesh", "mesh_prefilter"):
        scene = build_scene(testscenes.make_mesh_scene_host(subdiv=7), dev,
                            edge_prefilter=args.scene == "mesh_prefilter")
        cam = Camera.create(**chip_smoke.MESH_CAM, width=SIZE, height=SIZE, device=dev)
    else:
        folder = pathlib.Path(tempfile.mkdtemp(prefix="profile_torch_"))
        obj = "box.obj"
        if args.scene == "panel":
            testscenes.make_emitter_panel(folder, nx=chip_smoke.PANEL["nx"],
                                          ny=chip_smoke.PANEL["ny"])
            obj = "panel.obj"
        elif args.scene == "sss":
            chip_smoke.make_sss_box(folder, testscenes)
        else:
            testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
        scene = build_scene(obj_io.load_scene(folder, obj), dev)
        cam = Camera.create(**chip_smoke.CORNELL_CAM, width=SIZE, height=SIZE, device=dev)
    kw = dict(sample_size=1, level=LEVEL, hittable_pdf_weight=WEIGHT)
    if args.scene == "sss":
        with torch.no_grad():
            scene = sss.attach_sss(scene, chip_smoke.SSS_POINTS, sample_size=8, level=LEVEL,
                                   hittable_pdf_weight=WEIGHT,
                                   generator=torch.Generator(device=dev).manual_seed(7))
        print(f"SSS cloud: {scene.sss.pos.shape[0]} points", flush=True)

    def forward(seed):
        with torch.no_grad():
            return render_image(scene, cam, SIZE, SIZE,
                                generator=torch.Generator(device=dev).manual_seed(seed), **kw)

    target = forward(0)

    def gradient(seed):
        ke = (scene.materials.ke * 1.01).requires_grad_(True)
        return render_image_value_and_grad(
            optim._substitute(scene, {"ke": ke}), cam, SIZE, SIZE,
            lambda im: torch.mean((im - target) ** 2), [ke],
            generator=torch.Generator(device=dev).manual_seed(seed), **kw)

    run = gradient if args.gradient else forward
    what = "gradient to ke (path replay)" if args.gradient else "forward render"
    run(1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = 4 * LEVEL * (2 if args.gradient else 1)
    print(f"{args.scene}, {what}, {SIZE}x{SIZE} spp 1 level {LEVEL}: wall {wall * 1e3:.1f} ms "
          f"unprofiled, {wall * 1e3 / steps:.2f} ms per wavefront step ({steps} steps)")

    from torch.profiler import ProfilerActivity, profile

    tracing.reset("loop_exit")
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(3)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel")
    # kernels only: an operator's entry repeats the time of the kernels it launched, and a
    # tracer span's mark on the device's timeline is no work
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in tracing.SPANS]

    def device_us(e):
        return e.self_device_time_total

    total_us = sum(device_us(e) for e in events)
    print(f"profiled wall {profiled_wall * 1e3:.1f} ms; device busy {total_us / 1e3:.1f} ms = "
          f"{total_us / 1e6 / wall:.3f} of the unprofiled wall; {launches} cudaLaunchKernel calls, "
          f"{launches / steps:.0f} per wavefront step; loop exits (the sparse light regime's "
          f"collect walk, the SSS gather) {tracing.totals['loop_exit'] / steps:.1f} per step")
    for f in tracing.frames():  # the forward render's frame (the gradient makes none)
        print(f"synchronising calls torch reported: {f.counter('host_sync') / steps:.1f} per step")
    for e in events:
        if "closest_hit" in e.key:
            print(f"kernel {e.key}: {device_us(e) / 1e3:.2f} ms in {e.count} launches")
    print("largest kernels:")
    for e in sorted(events, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e) / 1e3:9.2f} ms  {e.count:7d} calls  {e.key[:70]}")

    # the pieces of one closest-hit query, on a captured bounce-2 wavefront
    g = scene.geom
    wo, wd, live = chip_smoke.wavefronts(scene, cam, 65536, 3, seed=2)[2]
    tm = torch.where(live, float("inf"), -1.0)
    perm = trace.coherence_perm(g, wo, wd, live)
    rays = ch.prepare_rays(g.tile_aabb, wo[perm], wd[perm], tm[perm])
    order = ch.block_tile_order(rays, g.tile_aabb, rays.shape[0] // ch.RAY_BLOCK)
    edge = trace.edge_operand(g)
    if edge is not None:
        kernel = ("launch_closest_hit_mxu",
                  lambda: ch.launch_closest_hit_mxu(rays, g.tiles, *edge, g.tile_aabb, order))
    else:
        launch = ch.launch_closest_hit_pipe if trace.pallas_big(g) else ch.launch_closest_hit
        kernel = (launch.__name__, lambda: launch(rays, g.tiles, g.tile_aabb, order))
    pieces = {
        "coherence_perm": lambda: trace.coherence_perm(g, wo, wd, live),
        "gather + prepare_rays": lambda: ch.prepare_rays(g.tile_aabb, wo[perm], wd[perm], tm[perm]),
        "block_tile_order": lambda: ch.block_tile_order(rays, g.tile_aabb, order.shape[0]),
        f"kernel ({kernel[0]})": kernel[1],
        "trace.closest_hit, whole": lambda: trace.closest_hit(g, wo, wd, live=live),
    }
    print(f"one closest-hit query, bounce-2 wavefront, {g.tiles.shape[0]} tiles (CUDA events, "
          f"20 calls each):")
    for name, fn in pieces.items():
        print(f"  {chip_smoke.cuda_ms(fn, 20):8.4f} ms  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
