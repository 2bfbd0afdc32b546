#!/usr/bin/env python3
"""Time and take apart the tile kernels' group walk on an NVIDIA GPU: the
closest-hit kernels B1 (`csrc/closest_hit.cu`), B2 (`csrc/closest_hit_pipe.cu`)
and B5 (`csrc/closest_hit_mxu.cu`, the edge prefilter) and the any-hit
kernels B3 (`csrc/anyhit.cu`) and B4 (`csrc/anyhit_pipe.cu`).

    python3 scripts/sweep_closest_hit_walk.py                   # the cycle split
    python3 scripts/sweep_closest_hit_walk.py --baseline DIR    # + older sources in turns
    python3 scripts/sweep_closest_hit_walk.py --sweep           # + the build-time sweep
    python3 scripts/sweep_closest_hit_walk.py --kernels closest_hit_mxu --sweep
    python3 scripts/sweep_closest_hit_walk.py --kernels anyhit,anyhit_pipe --baseline DIR

Run from the repo root with one CUDA card.  The rays are the main paths'
queries as `chip_smoke.py` makes them.  Closest hit: the bounce-0 and
bounce-2 wavefronts (65,536 rays, coherence-sorted) of the 327,684-triangle
mesh (built with the prefilter's edge tiles) and the bounce-0 and bounce-3
wavefronts of the 972-triangle Cornell box; B5 runs on the mesh's only.  Any
hit: the fullest gather query of the SPPM box's main path (2 passes at
512x512, 50,000 photons) and of one mesh SPPM pass, each recorded as the
renderer makes it, and on each scene a query of that shape in which every
ray is live (`chip_smoke.visibility_rays`).

- The cycle split: each kernel's per-unit cycles output (`clock64()` of the
  whole walk and of the part spent staging, prefiltering and scanning
  tiles; a unit is the group of rays that walks together) beside its
  per-unit counts: the slowest unit, the mean, and a least-squares fit of a
  unit's cycles to its walked and scanned tiles; for B5 also the share of
  the scanned tiles' pairs it culls.
- `--baseline DIR`: DIR holds another version's kernel sources and headers
  (e.g. the parent commit's `csrc/`, unpacked into the git-ignored
  `build/`).  They are built beside the tree's and timed in turns on the
  same rays (baseline, tree, tree, baseline), CUDA events over 20 launches;
  the closest hit's (t, slot) and the any hit's bits must be equal bit for
  bit.  A baseline kernel without the cycles output walks in 128-ray blocks
  (B3, B4 and B5 before the group walk).
- `--sweep`: variants of the tree's kernels rebuilt with other values of
  their build-time constants, each checked bit for bit against the tree
  (B2 for the closest hit, B3 for the any hit) and timed twice: the walk's
  shape (rays per group, threads per ray) and the ring depth of B2 and B4;
  for B5 every combination of the cull's granularity (kPerRay: the group's
  union or each ray's own), the product split over the group's two warps
  (kSplitMma), the staging (kCpAsync: TMA or cp.async) and the ring depth
  (kRing 1 or 2).
- `--kernels`: the kernels to time, split and sweep (default all five;
  names separated by spaces or commas).

Prints the card's name and power limit first and one line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNELS = ("closest_hit", "closest_hit_pipe", "closest_hit_mxu", "anyhit", "anyhit_pipe")
WINDOW = ("anyhit", "anyhit_pipe")  # kernels of the windowed any-hit query
REPS = 20


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def build(variants: dict, out: pathlib.Path) -> dict:
    """variants: {label: (csrc dir, kernel name, {constant: value})} -> {label:
    CDLL}; one nvcc per variant, all started together.  Each constant
    (`constexpr int <name> = <value>;` in the kernel's source or a header it
    includes) is rewritten in a copy of the sources."""
    from gpu_pathtracer_tpu_torch.ops import _build

    running = []
    for label, (src_dir, kernel, consts) in variants.items():
        work = out / label
        work.mkdir(parents=True)
        texts = {f.name: f.read_text() for f in _build.sources(kernel, pathlib.Path(src_dir))}
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
    """One built tile kernel behind its C entry point.  `unit` is the rays
    per walking unit (counts and cycles have one row per unit);
    `walks_groups`: whether it is a group-walk kernel, whose entry point
    takes the cycles pointer (and, for the any hit, the live list's
    scratch).  B5 (`closest_hit_mxu`) also takes the scene's edge tiles and
    margin scales and reports two more counts; the any-hit kernels write two
    bytes a ray (near, far) where the closest-hit ones write (t, slot)."""

    def __init__(self, lib, kernel: str, unit: int, walks_groups: bool):
        from gpu_pathtracer_tpu_torch.ops import _build

        self.mxu = kernel == "closest_hit_mxu"
        self.window = kernel in WINDOW
        self.live_list = self.window and walks_groups
        n_extra = 2 if self.mxu else (1 if self.live_list else 0)
        # rays, tiles, tile boxes, order, the inputs, the outputs, counts, cycles; ints
        self.fn = _build.bind(lib, kernel, (_build.PTR,) * (7 + n_extra + walks_groups)
                              + (_build.INT,) * 3)
        self.unit, self.has_cycles = unit, walks_groups

    def __call__(self, rays, g, order, counts=False, cycles=False):
        import torch

        dev, n = rays.device, rays.shape[0]
        a = torch.empty(n, dtype=torch.uint8 if self.window else torch.float32, device=dev)
        b = torch.empty(n, dtype=torch.uint8 if self.window else torch.int32, device=dev)
        c = (torch.zeros((n // self.unit, 5 if self.mxu else 3), dtype=torch.int32, device=dev)
             if counts else None)
        cy = torch.zeros((n // self.unit, 2), dtype=torch.int64, device=dev) if cycles else None
        ptrs = [rays.data_ptr(), g.tiles.data_ptr(), g.tile_aabb.data_ptr(), order.data_ptr()]
        if self.mxu:
            ptrs += [g.edge_tiles.data_ptr(), g.edge_wsum.data_ptr()]
        if self.live_list:
            live = torch.empty(n // self.unit + 2, dtype=torch.int32, device=dev)
            ptrs.append(live.data_ptr())
        ptrs += [a.data_ptr(), b.data_ptr(), c.data_ptr() if counts else None]
        if self.has_cycles:
            ptrs.append(cy.data_ptr() if cycles else None)
        err = self.fn(*ptrs, n, g.tiles.shape[0], g.tiles.shape[2],
                      torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return a, b, c, cy


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
    if kernel.mxu:
        out["culled_share"] = float(c[:, 4].sum() / max(float(c[:, 3:].sum()), 1.0))
    print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in out.items()), flush=True)
    return out


def queries(dev, closest: bool, window: bool):
    """[(label, geometry, prepared rays, order, kind)] of the closest-hit
    wavefronts (kind "closest") and of the any-hit queries (kind
    "window")."""
    import torch

    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch import renderer
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch
    from gpu_pathtracer_tpu_torch.ops import trace
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    out = []
    mesh = build_scene(testscenes.make_mesh_scene_host(subdiv=cs.MESH_SUBDIV), dev,
                       edge_prefilter=True)
    mcam = Camera.create(**cs.MESH_CAM, width=512, height=512, device=dev)
    folder = pathlib.Path(tempfile.mkdtemp(prefix="sweep_walk_scenes_"))
    if closest:
        waves = cs.wavefronts(mesh, mcam, cs.WAVE_RAYS, 3, seed=2)
        for bounce in (0, 2):
            out.append((f"mesh bounce {bounce}", mesh.geom, cs.sorted_rays(mesh.geom, waves[bounce]),
                        "closest"))
        testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
        box = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
        cam = Camera.create(**cs.CORNELL_CAM, width=512, height=512, device=dev)
        waves = cs.wavefronts(box, cam, cs.WAVE_RAYS, 4, seed=1)
        for bounce in (0, 3):
            out.append((f"cornell bounce {bounce}", box.geom, cs.sorted_rays(box.geom, waves[bounce]),
                        "closest"))
    if window:
        scfg = cs.sppm_box_master(folder, False, config, testscenes)
        with cs.RecordedGather(trace) as box_gather:
            renderer.render_from_config(scfg)
        box_scene = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
        bg = box_scene.geom
        out.append(("SPPM box gather (recorded)", bg, box_gather.rays(bg.tile_aabb), "window"))
        box_cam = Camera.create(**cs.CORNELL_CAM, width=512, height=512, device=dev)
        out.append(("SPPM box, live gather rays", bg,
                    cs.visibility_rays(box_scene, box_cam, 512, cs.GATHER_CHUNK, sppm.K_NEAREST, 21),
                    "window"))
        mcfg = config.RenderConfig(image_width=512, image_height=512,
                                   ppm_num_photon_per_pass=cs.SPPM["photons"], ppm_num_pass=1,
                                   ppm_max_bounce=cs.SPPM["max_bounce"])
        with cs.RecordedGather(trace) as mesh_gather, torch.no_grad():
            sppm.render_sppm(mesh, mcam, mcfg, 12)
        mg = mesh.geom
        out.append(("mesh gather (recorded)", mg, mesh_gather.rays(mg.tile_aabb), "window"))
        out.append(("mesh, live gather rays", mg,
                    cs.visibility_rays(mesh, mcam, 512, cs.GATHER_CHUNK, sppm.K_NEAREST, 22),
                    "window"))
    shutil.rmtree(folder)
    return [(label, g, rays, ch.block_tile_order(rays, g.tile_aabb, rays.shape[0] // ch.RAY_BLOCK),
             kind) for label, g, rays, kind in out]


def sweep_variants(kernels) -> dict:
    """{label: (kernel, {constant: value}, rays per group)} of the sweep: the
    walk's rays per group x threads per ray (whole warps, at most 512
    threads; at most 32 rays for B3 and B4, whose first pass finds a
    group's rays in one warp) for B1-B4 at the committed ring, B2's and B4's ring depth at
    the committed shape, and B5's four build-time choices in every
    combination."""
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    out = {}
    for rays_per_group in (4, 8, 16, 32, 64):
        for threads in (1, 2, 4, 8, 16):
            if (rays_per_group * threads) % 32 or rays_per_group * threads > 512:
                continue
            for kernel in ("closest_hit", "closest_hit_pipe", "anyhit", "anyhit_pipe"):
                if kernel in WINDOW and rays_per_group > 32:  # a group's rays share a warp there
                    continue
                out[f"{kernel}_g{rays_per_group}x{threads}"] = (
                    kernel, {"kGroupRays": rays_per_group, "kRayThreads": threads}, rays_per_group)
    for ring in (1, 2, 3, 4):
        for kernel in ("closest_hit_pipe", "anyhit_pipe"):
            out[f"{kernel}_r{ring}"] = (kernel, {"kRing": ring}, ch.GROUP_RAYS)
    for per_ray, split_mma, cp_async, ring in itertools.product((0, 1), (0, 1), (0, 1), (1, 2)):
        out[f"closest_hit_mxu_{'ray' if per_ray else 'union'}_{'split' if split_mma else 'whole'}"
            f"_{'cpasync' if cp_async else 'tma'}_r{ring}"] = (
            "closest_hit_mxu", {"kPerRay": per_ray, "kSplitMma": split_mma, "kCpAsync": cp_async,
                                "kRing": ring}, ch.GROUP_RAYS)
    return {k: v for k, v in out.items() if v[0] in kernels}


def answer(kernel, rays, g, order):
    """A launch's per-ray outputs, synchronised."""
    import torch

    a, b = kernel(rays, g, order)[:2]
    torch.cuda.synchronize()
    return a, b


def differ(got, ref) -> int:
    """Rays whose outputs differ."""
    return int(((got[0] != ref[0]) | (got[1] != ref[1])).sum())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=pathlib.Path, default=None,
                        help="a directory with older kernel sources and their headers")
    parser.add_argument("--sweep", action="store_true", help="also the build-time sweep")
    parser.add_argument("--kernels", nargs="+", default=list(KERNELS),
                        help=f"any of {', '.join(KERNELS)} (spaces or commas)")
    args = parser.parse_args()
    wanted = {k for arg in args.kernels for k in arg.split(",") if k}
    if not wanted <= set(KERNELS):
        parser.error(f"unknown kernels {sorted(wanted - set(KERNELS))}")

    import torch

    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.ops import _build
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    dev = require_cuda()
    print(cs.nvidia_smi(), flush=True)
    kernels = [k for k in KERNELS if k in wanted]
    out = pathlib.Path(tempfile.mkdtemp(prefix="sweep_walk_"))
    # each query's yardstick (B2 for the closest hit, B3 for the any hit) is always built
    yardstick = {"closest": "closest_hit_pipe", "window": "anyhit"}
    closest = any(k not in WINDOW for k in kernels)
    window = any(k in WINDOW for k in kernels)
    needed = set(kernels) | {yardstick[kind] for kind, on in (("closest", closest),
                                                             ("window", window)) if on}
    specs = {k: (_build.CSRC, k, {}) for k in KERNELS if k in needed}
    if args.baseline is not None:
        specs.update({f"baseline_{k}": (args.baseline, k, {}) for k in kernels})
    sweep = sweep_variants(kernels) if args.sweep else {}
    specs.update({label: (_build.CSRC, k, consts) for label, (k, consts, _) in sweep.items()})
    libs = build(specs, out)
    tree = {k: Kernel(libs[k], k, ch.GROUP_RAYS, True) for k in specs if k in KERNELS}
    base = {}
    for k in kernels if args.baseline is not None else ():
        walks_groups = "out_cycles" in (args.baseline / f"{k}.cu").read_text()
        base[k] = Kernel(libs[f"baseline_{k}"], k, ch.GROUP_RAYS if walks_groups else ch.RAY_BLOCK,
                         walks_groups)
    qs = queries(dev, closest, window)
    print(f"SM clock {sm_clock_mhz():.0f} MHz", flush=True)
    for label, g, rays, order, kind in qs:
        here = [k for k in kernels if (k in WINDOW) == (kind == "window")
                and (k != "closest_hit_mxu" or g.edge_tiles is not None)]
        ref = answer(tree[yardstick[kind]], rays, g, order)
        print(f"{label}: {rays.shape[0]} rays x {g.tiles.shape[0]} tiles, live "
              f"{float((rays[:, 6] > 0).float().mean()):.4f}", flush=True)
        for k in here:
            if differ(answer(tree[k], rays, g, order), ref):
                raise SystemExit(f"{label}: {k} and {yardstick[kind]} differ")
        for k in here:
            if k in base:
                n = differ(answer(base[k], rays, g, order), ref)
                print(f"{label}: baseline {k} equals the tree's bit for bit: {n == 0} ({n} rays "
                      f"differ)", flush=True)
        for k in here:
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
            if k not in here:
                continue
            kern = Kernel(libs[name], k, unit, True)
            if differ(answer(kern, rays, g, order), ref):
                raise SystemExit(f"{label}: {name} differs from the tree's {yardstick[kind]}")
            ms = [cs.cuda_ms(lambda: kern(rays, g, order), REPS) for _ in range(2)]
            culled = ""
            if kern.mxu:
                c = kern(rays, g, order, counts=True)[2].double()
                culled = f", culled {float(c[:, 4].sum() / max(float(c[:, 3:].sum()), 1.0)):.4f}"
            print(f"{label}, sweep {name}: {ms[0]:.4f} / {ms[1]:.4f} ms{culled}", flush=True)
    shutil.rmtree(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
