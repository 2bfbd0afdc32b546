#!/usr/bin/env python3
"""Time and take apart the closest-hit kernels B1 (`csrc/closest_hit.cu`) and
B2 (`csrc/closest_hit_pipe.cu`) on an NVIDIA GPU.

    python3 scripts/sweep_closest_hit_walk.py                   # the cycle split
    python3 scripts/sweep_closest_hit_walk.py --baseline DIR    # + older sources in turns
    python3 scripts/sweep_closest_hit_walk.py --sweep           # + the shape sweep

Run from the repo root with one CUDA card.  The rays are the main paths'
queries as `chip_smoke.py` makes them: the bounce-0 and bounce-2 wavefronts
(65,536 rays, coherence-sorted) of the 327,684-triangle mesh and the bounce-0
and bounce-3 wavefronts of the 972-triangle Cornell box.

- The cycle split: each kernel's per-unit cycles output (`clock64()` of the
  whole walk and of the part spent staging and scanning tiles; a unit is the
  group of rays that walks together) beside its per-unit counts: the slowest
  unit, the mean, and a least-squares fit of a unit's cycles to its walked
  and scanned tiles.
- `--baseline DIR`: DIR holds another version's `closest_hit.cu`,
  `closest_hit_pipe.cu` and `closest_hit_common.cuh` (e.g. the parent
  commit's `csrc/`, unpacked into the git-ignored `build/`).  They are built
  beside the tree's and timed in turns on the same rays (baseline, tree,
  tree, baseline), CUDA events over 20 launches; (t, slot) must be equal bit
  for bit.
- `--sweep`: variants of the tree's kernels rebuilt with other values of the
  walk's constants (rays per group, threads per ray; B2's ring depth), each
  checked bit for bit against the tree's build and timed.

Prints the card's name and power limit first and one line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = ("closest_hit", "closest_hit_pipe")
HEADER = "closest_hit_common.cuh"
REPS = 20


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def build(variants: dict, out: pathlib.Path) -> dict:
    """variants: {label: (csrc dir, kernel name, {constant: value})} -> {label:
    CDLL}; one nvcc per variant, all started together.  Each constant
    (`constexpr int <name> = <value>;` in the kernel's source or the header)
    is rewritten in a copy of the sources."""
    from gpu_pathtracer_tpu_torch.ops import _build

    running = []
    for label, (src_dir, kernel, consts) in variants.items():
        work = out / label
        work.mkdir(parents=True)
        texts = {f: (pathlib.Path(src_dir) / f).read_text() for f in (f"{kernel}.cu", HEADER)}
        for name, value in consts.items():
            found = 0
            for f, text in texts.items():
                texts[f], n = re.subn(rf"constexpr int {name} = \d+;",
                                      f"constexpr int {name} = {value};", text)
                found += n
            if found != 1:
                raise SystemExit(f"{label}: constant {name} found {found} times")
        for f, text in texts.items():
            (work / f).write_text(text)
        lib = work / f"lib{kernel}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(work / f"{kernel}.cu")]
        running.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, lib, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{log}")
        lines = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"ptxas {label}: {' | '.join(lines)}", flush=True)
        libs[label] = ctypes.CDLL(str(lib))
    return libs


class Kernel:
    """One built closest-hit kernel behind its C entry point.  `unit` is the
    rays per walking unit (counts and cycles have one row per unit);
    `has_cycles`: whether the entry point takes the cycles pointer."""

    def __init__(self, lib, kernel: str, unit: int, has_cycles: bool):
        from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

        self.fn = ch.bind_tile_entry(lib, kernel, cycles=has_cycles)
        self.unit, self.has_cycles = unit, has_cycles

    def __call__(self, rays, g, order, counts=False, cycles=False):
        import torch

        dev, n = rays.device, rays.shape[0]
        t = torch.empty(n, dtype=torch.float32, device=dev)
        slot = torch.empty(n, dtype=torch.int32, device=dev)
        c = torch.zeros((n // self.unit, 3), dtype=torch.int32, device=dev) if counts else None
        cy = torch.zeros((n // self.unit, 2), dtype=torch.int64, device=dev) if cycles else None
        ptrs = [rays.data_ptr(), g.tiles.data_ptr(), g.tile_aabb.data_ptr(), order.data_ptr(),
                t.data_ptr(), slot.data_ptr(), c.data_ptr() if counts else None]
        if self.has_cycles:
            ptrs.append(cy.data_ptr() if cycles else None)
        err = self.fn(*ptrs, n, g.tiles.shape[0], g.tiles.shape[2],
                      torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return t, slot, c, cy


def split(name, kernel, rays, g, order, clock_mhz):
    """The cycle split of one launch; returns a dict of its numbers."""
    import torch

    _, _, c, cy = kernel(rays, g, order, counts=True, cycles=True)
    torch.cuda.synchronize()
    c, cy = c.double().cpu(), cy.double().cpu()
    walked, scanned, total, scan = c[:, 0], c[:, 2], cy[:, 0], cy[:, 1]
    slow = int(torch.argmax(total))
    busy = int(torch.argmax(scanned))
    # cycles of a unit ~ a * walked + b * scanned + c0
    a_mat = torch.stack([walked, scanned, torch.ones_like(walked)], dim=1)
    coef = torch.linalg.lstsq(a_mat, total[:, None]).solution[:, 0]
    us = 1.0 / clock_mhz  # microseconds per cycle
    out = dict(units=int(c.shape[0]), slowest_cycles=float(total[slow]),
               slowest_us=float(total[slow]) * us, slowest_walked=int(walked[slow]),
               slowest_scanned=int(scanned[slow]),
               slowest_scan_share=float(scan[slow] / max(float(total[slow]), 1.0)),
               busiest_scanned=int(scanned[busy]), busiest_us=float(total[busy]) * us,
               mean_walked=float(walked.mean()), mean_scanned=float(scanned.mean()),
               mean_us=float(total.mean()) * us,
               mean_scan_share=float(scan.sum() / max(float(total.sum()), 1.0)),
               fit_us_per_walked=float(coef[0]) * us, fit_us_per_scanned=float(coef[1]) * us,
               fit_us_fixed=float(coef[2]) * us)
    print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in out.items()), flush=True)
    return out


def queries(dev):
    """[(label, geometry, prepared rays, order)] of the four wavefronts."""
    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch
    from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

    out = []
    mesh = build_scene(testscenes.make_mesh_scene_host(subdiv=cs.MESH_SUBDIV), dev)
    cam = Camera.create(**cs.MESH_CAM, width=512, height=512, device=dev)
    waves = cs.wavefronts(mesh, cam, cs.WAVE_RAYS, 3, seed=2)
    for bounce in (0, 2):
        out.append((f"mesh bounce {bounce}", mesh.geom, cs.sorted_rays(mesh.geom, waves[bounce])))
    folder = pathlib.Path(tempfile.mkdtemp(prefix="sweep_walk_cornell_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
    box = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
    cam = Camera.create(**cs.CORNELL_CAM, width=512, height=512, device=dev)
    waves = cs.wavefronts(box, cam, cs.WAVE_RAYS, 4, seed=1)
    for bounce in (0, 3):
        out.append((f"cornell bounce {bounce}", box.geom, cs.sorted_rays(box.geom, waves[bounce])))
    shutil.rmtree(folder)
    return [(label, g, rays, ch.block_tile_order(rays, g.tile_aabb, rays.shape[0] // ch.RAY_BLOCK))
            for label, g, rays in out]


def sweep_variants() -> dict:
    """{label: (kernel, {constant: value}, rays per group)} of the shape sweep:
    rays per group x threads per ray (whole warps, at most 512 threads) at
    the committed ring; B2's ring depth at the committed shape."""
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    out = {}
    for rays_per_group in (4, 8, 16, 32, 64):
        for threads in (1, 2, 4, 8, 16):
            if (rays_per_group * threads) % 32 or rays_per_group * threads > 512:
                continue
            for kernel in KERNELS:
                out[f"{kernel}_g{rays_per_group}x{threads}"] = (
                    kernel, {"kGroupRays": rays_per_group, "kRayThreads": threads}, rays_per_group)
    for ring in (1, 2, 3, 4):
        out[f"closest_hit_pipe_r{ring}"] = ("closest_hit_pipe", {"kRing": ring}, ch.GROUP_RAYS)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        help="a directory with older closest_hit{,_pipe}.cu and the header")
    parser.add_argument("--sweep", action="store_true", help="also the shape sweep")
    args = parser.parse_args()

    import torch

    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.ops import _build
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    dev = require_cuda()
    print(cs.nvidia_smi(), flush=True)
    out = pathlib.Path(tempfile.mkdtemp(prefix="sweep_walk_"))
    specs = {k: (_build.CSRC, k, {}) for k in KERNELS}
    if args.baseline is not None:
        specs.update({f"baseline_{k}": (args.baseline, k, {}) for k in KERNELS})
    sweep = sweep_variants() if args.sweep else {}
    specs.update({label: (_build.CSRC, k, consts) for label, (k, consts, _) in sweep.items()})
    libs = build(specs, out)
    tree = {k: Kernel(libs[k], k, ch.GROUP_RAYS, True) for k in KERNELS}
    base = ({k: Kernel(libs[f"baseline_{k}"], k, ch.RAY_BLOCK,
                       "out_cycles" in (args.baseline / f"{k}.cu").read_text()) for k in KERNELS}
            if args.baseline is not None else {})
    qs = queries(dev)
    print(f"SM clock {sm_clock_mhz():.0f} MHz", flush=True)
    for label, g, rays, order in qs:
        ref = {k: kern(rays, g, order)[:2] for k, kern in tree.items()}
        torch.cuda.synchronize()
        if not (torch.equal(ref[KERNELS[0]][0], ref[KERNELS[1]][0])
                and torch.equal(ref[KERNELS[0]][1], ref[KERNELS[1]][1])):
            raise SystemExit(f"{label}: closest_hit and closest_hit_pipe differ")
        for k, kern in base.items():
            t, slot = kern(rays, g, order)[:2]
            torch.cuda.synchronize()
            same = torch.equal(t, ref[k][0]) and torch.equal(slot, ref[k][1])
            print(f"{label}: baseline {k} equals the tree's bit for bit: {same} "
                  f"({int(((t != ref[k][0]) | (slot != ref[k][1])).sum())} rays differ)", flush=True)
        for k in KERNELS:
            if k in base:  # in turns: baseline, tree, tree, baseline
                ms = [cs.cuda_ms(lambda: base[k](rays, g, order), REPS),
                      cs.cuda_ms(lambda: tree[k](rays, g, order), REPS),
                      cs.cuda_ms(lambda: tree[k](rays, g, order), REPS),
                      cs.cuda_ms(lambda: base[k](rays, g, order), REPS)]
                print(f"{label}, {k}: baseline {ms[0]:.4f} / {ms[3]:.4f} ms, tree {ms[1]:.4f} / "
                      f"{ms[2]:.4f} ms", flush=True)
            else:
                print(f"{label}, {k}: tree {cs.cuda_ms(lambda: tree[k](rays, g, order), REPS):.4f} ms",
                      flush=True)
            split(f"{label}, {k}, split", tree[k], rays, g, order, sm_clock_mhz())
            if k in base and base[k].has_cycles:
                split(f"{label}, baseline {k}, split", base[k], rays, g, order, sm_clock_mhz())
        for name, (k, _, unit) in sweep.items():
            kern = Kernel(libs[name], k, unit, True)
            t, slot = kern(rays, g, order)[:2]
            torch.cuda.synchronize()
            if not (torch.equal(t, ref[k][0]) and torch.equal(slot, ref[k][1])):
                raise SystemExit(f"{label}: {name} differs from the tree's {k}")
            ms = [cs.cuda_ms(lambda: kern(rays, g, order), REPS) for _ in range(2)]
            print(f"{label}, sweep {name}: {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
    shutil.rmtree(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
