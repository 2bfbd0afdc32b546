#!/usr/bin/env python3
"""Sweep two build-time choices of `csrc/closest_hit_mxu.cu` on an NVIDIA GPU.

    python3 scripts/sweep_closest_hit_mxu.py        # from the repo root, one CUDA card

Builds variants of the kernel with the constant `kScanWide` (candidate
columns tested together in the exact scan) at 1, 2, 4 and 8, and, at the
committed width, with `__launch_bounds__(128, 8)` (at most 64 registers, so
eight blocks fit an SM instead of four), each from a rewritten copy of the
source.  Times every variant and `closest_hit_pipe` on the bounce-0 and
bounce-2 wavefronts (65,536 rays) of the 327,684-triangle mesh, CUDA events
over 20 launches, twice in turns, and checks every variant's (t, slot)
against `closest_hit_pipe` bit for bit.  Prints the card's name and power
limit, each variant's ptxas line, and one line of times (ms) per wavefront
and turn.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WIDTH_LINE = "constexpr int kScanWide = 4;"
BOUNDS_LINE = "__global__ void __launch_bounds__(kBlock)\nclosest_hit_mxu_kernel"


def main() -> int:
    import torch

    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import _build
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch
    from gpu_pathtracer_tpu_torch.utils import testscenes

    dev = require_cuda()
    print(cs.nvidia_smi(), flush=True)
    src = (_build.CSRC / "closest_hit_mxu.cu").read_text()
    if WIDTH_LINE not in src or BOUNDS_LINE not in src:
        raise SystemExit("closest_hit_mxu.cu no longer holds the lines this sweep rewrites")
    variants = {f"wide{n}": src.replace(WIDTH_LINE, f"constexpr int kScanWide = {n};")
                for n in (1, 2, 4, 8)}
    variants["wide4_regs64"] = src.replace(
        BOUNDS_LINE, "__global__ void __launch_bounds__(kBlock, 8)\nclosest_hit_mxu_kernel")

    out = pathlib.Path(tempfile.mkdtemp(prefix="sweep_mxu_"))
    running = []
    for name, text in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"lib{name}.so"), str(cu)]
        running.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: {' | '.join(lines)}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))

    mesh = build_scene(testscenes.make_mesh_scene_host(subdiv=cs.MESH_SUBDIV), dev,
                       edge_prefilter=True)
    g = mesh.geom
    cam = Camera.create(**cs.MESH_CAM, width=512, height=512, device=dev)
    waves = cs.wavefronts(mesh, cam, cs.WAVE_RAYS, 3, seed=2)
    for bounce in (0, 2):
        rays = cs.sorted_rays(g, waves[bounce])
        order = ch.block_tile_order(rays, g.tile_aabb, rays.shape[0] // ch.RAY_BLOCK)
        t_ref, slot_ref = ch.launch_closest_hit_pipe(rays, g.tiles, g.tile_aabb, order)
        out_t = torch.empty(rays.shape[0], dtype=torch.float32, device=dev)
        out_slot = torch.empty(rays.shape[0], dtype=torch.int32, device=dev)

        def launcher(lib):
            fn = lib.gpt_closest_hit_mxu
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def launch():
                err = fn(rays.data_ptr(), g.tiles.data_ptr(), g.tile_aabb.data_ptr(),
                         order.data_ptr(), g.edge_tiles.data_ptr(), g.edge_wsum.data_ptr(),
                         out_t.data_ptr(), out_slot.data_ptr(), None, rays.shape[0],
                         g.tiles.shape[0], ch.TILE, torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            return launch

        for turn in range(2):
            ms = {"closest_hit_pipe": cs.cuda_ms(
                lambda: ch.launch_closest_hit_pipe(rays, g.tiles, g.tile_aabb, order), 20)}
            for name, lib in libs.items():
                launch = launcher(lib)
                ms[name] = cs.cuda_ms(launch, 20)
                if not (torch.equal(out_t, t_ref) and torch.equal(out_slot, slot_ref)):
                    raise SystemExit(f"{name} differs from closest_hit_pipe at bounce {bounce}")
            print(f"mesh bounce {bounce}, turn {turn}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
