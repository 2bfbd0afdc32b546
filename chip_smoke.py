#!/usr/bin/env python3
"""Drive the PyTorch port of the path tracer once on an NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught):
  1. the CUDA device, and the card's name and power limit from nvidia-smi;
  2. the seven kernels (closest hit and windowed any hit, each with plain
     loads and with a TMA ring, and the ring-buffered closest hit with the
     tensor-core edge prefilter, all five walking the tile order in 8-ray
     groups; the dense light tree's NEE/MIS step; and the wavefront step's
     surface shading) built with nvcc from
     the checkout's sources (one nvcc per source, started together), with
     their ptxas lines;
  3. the plain-load kernel (`closest_hit`, the group walk: 8-ray groups,
     8 threads a ray) against its plain PyTorch version on the card, and its
     per-group counts against the group walk's plain version: a random
     triangle soup with dead rays and a ragged tail, and Cornell wavefronts
     at bounce 0 and bounce 3 (65,536 rays x 972 triangles, the Cornell main
     path's shape), with its times and the bound from its own counts;
  4. the ring-buffered kernel (`closest_hit_pipe`, the same walk with TMA
     copies) on wavefronts of the 327,684-triangle mesh at bounce 0 and
     bounce 2: against its plain version (values and per-group counts) on a
     16,384-ray subset, bit-equal to `closest_hit` with the same walk on the
     full 65,536 rays (and on a ragged tail), the per-group counts with the
     most tiles scanned by a group, both kernels' times in turns, the cycle
     split of the slowest group, the plain version's time, the host-side
     preparation of a launch, and the bound from its own counts;
  5. the same uniforms through `trace_paths` on the card and on the CPU;
  6. the Cornell main path: `renderer.render_from_config` on a master file
     for the Cornell box with spheres at 512x512, 8 spp, level 8,
     hittable_pdf_weight 0.5; its launch count, seconds and rays/s, and its
     image mean against a CPU render of the same scene;
  7. the mesh main path: `build_scene(make_mesh_scene_host(subdiv=7))` and
     `render_image` at the same widths, which must run on `closest_hit_pipe`
     alone; its image against the same render forced onto `closest_hit` and
     against a CPU plain-path render of the mesh at subdiv=5;
  8. the gradient: the L2 loss of a 512x512, 2 spp, level 8 Cornell render
     against the main path's image, differentiated to the emission table
     `ke` by path replay; seconds, grad-rays/s and peak memory; the gradient
     against a central finite difference at 64x64; three `optimize` steps;
  9. the SPPM main path: `renderer.render_from_config` with render_mode 2 on
     the bench's SPPM box (72 triangles) at 512x512, 50,000 photons a pass,
     ppm_max_bounce 8, 4 passes: it must take the hash-grid gathers and run
     their visibility checks on `anyhit` alone; per-pass seconds, photons/s,
     launches and host synchronizations; its direct component against a CPU
     render at 48x48 with the photons scaled to the pixels; one pass on the
     same inputs (photon pass, eye pass, both gathers), card against CPU;
 10. both any-hit kernels (the same group walk as the closest-hit kernels,
     with per-ray budgets) on a soup with dead rays and a ragged tail and on
     the fullest gather wavefront recorded in phase 9: bits and per-group
     counts against the plain versions, `anyhit_pipe` bit-equal to `anyhit`
     with the same walk (entries walked and tiles scanned per group), both
     against the bits derived from `closest_hit`, their times in turns, the
     slowest group's cycle split and the bound from their own counts; the
     same on a query of that shape in which every ray is live (hit point to
     hit point), since few slots of the recorded one hold a photon;
 11. the fog configuration at the same size, one pass after the init pass:
     volume photons deposited, the hash-grid beam gather taken;
 12. the mesh configuration: SPPM on the 327,684-triangle mesh, one pass
     after the init pass through `render_sppm`, whose gathers must run on
     `anyhit_pipe` alone; the kernels compared as in phase 10 on its fullest
     gather wavefront.
 13. the kernel with the edge prefilter (`closest_hit_mxu`, the same group
     walk and TMA ring) against `closest_hit_pipe` and its plain version: the
     soup, and the mesh wavefronts at bounce 0 and bounce 2: (t, slot)
     bit-equal to `closest_hit_pipe` on every ray and the walk counts
     (walked, fetched, scanned) equal on every group, against the plain
     version on the 16,384-ray subset with the walk counts per group and the
     prefilter's pair counts within 1% of the plain version's; both kernels'
     times in turns on the same rays, the slowest group's cycle split, the
     bound from its own counts, the share of pairs culled (as the kernel
     culls: the union over a group's 8 rays; and per pair and per 32 rays on
     the nearest tiles), `pack_edge_tiles`' time and bytes;
 14. the mesh main path with the prefilter:
     `build_scene(..., edge_prefilter=True)` -> `render_image` at the main
     widths must run on `closest_hit_mxu` alone and give phase 7's image bit
     for bit from the same generator seed;
 15. the many-lights main path: the 2,048-emitter panel through
     `renderer.render_from_config` at the main widths, which must take the
     sparse light-tree regime; dropped MIS targets and host synchronizations
     per wavefront step; the lower half of its image against a 64x64 CPU
     render, and at 64x64 the card's image mean against the CPU's and against
     a render with the dense tables forced;
 16. the SSS main path: the box whose white sphere scatters below its surface
     through `renderer.render_from_config` at the main widths with 4,096
     points (the hash-grid gather): first-pass and render seconds, the
     `_pts.ppm` splat, the mean over the sphere's pixels against a 64x64 CPU
     render with the same point count;
 17. the differentiable SPPM leg of the bench: `render_sppm_differentiable`
     on the SPPM box at 256x256, 16,384 photons a pass, 2 passes, 8 photon
     and 8 eye bounces (the hash-grid gathers), the gradient of the image
     mean to `ke` by autograd; it must run on `closest_hit` and `anyhit`
     alone.  Seconds of a loss and its gradient (median of 3 after the first
     step; forward and backward apart), pixels/s, peak device memory, host
     synchronizations; both kernels on the step's own queries, recorded in
     its first run: `closest_hit` against its plain version on the fullest
     and the sparsest eye and photon wavefronts (timed on the fullest eye
     one), `anyhit` (and `anyhit_pipe`) as in phase 10 on the fullest gather
     chunk; the gradient against a central difference from the same seed
     (within 1%), and the indirect (photon) term's share of the image and
     its gradient alone against its central difference (within 1%; the
     direct term alone is the same render with the photons' colours set to
     0); the same render at 32x32 with 1,024 photons from uniforms drawn on
     the CPU, card against CPU (>= 99% of pixels within rtol 1e-4, the
     gradients within 1%); three `optimize` steps with
     `sppm_loss_fn(**SPPM_LOSS_PRODUCTION)` at 128x128;
 18. the scale-out (`parallel/`): (a) in this process an NCCL group of one,
     `shard_rays 1` through `renderer.render_from_config` on phase 6's
     master file (512x512, spp 8, level 8; the image must be phase 6's bit
     for bit; seconds, rays/s, launches and the collectives called) and on
     phase 9's SPPM master file (the image must be `render_sppm`'s with the
     rank stream traced in this process, bit for bit; seconds per pass,
     `anyhit` launches); (b) two ranks as child processes on gloo, both on
     the one card (`chip_smoke.py --scale-out-rank ...`, each with a time
     limit): `render_image_distributed` at 256x256, spp 2, level 8 (bit for
     bit the world-of-1 render's), `photon_pass_distributed` with 50,000
     photons and 8 bounces (`valid` equal to the two rank streams traced
     here, positions to rtol 1e-6), the sharded differentiable SPPM step at
     phase 17's size (loss to rtol 1e-5, d mean / d ke to rtol 1e-4, atol
     1e-7, of the same streams traced here; seconds per rank) and one
     `train_step_distributed` at 128x128 (loss and new `ke` to rtol 1e-5 of
     the single-process step); each rank must launch `closest_hit` in every
     part and `anyhit` in the step.  Part (b) runs below the main widths:
     two processes share one card, and gloo takes every collective through
     host memory.  One card measures no scaling, so no speed-up is printed.
     Rank 0 binds the group's port and hands it on (no other process can
     take it between pick and bind), the ranks write their output to files
     and use gloo on the loopback interface, and their time limit counts
     from their start;
 19. the textured large mesh (BASELINE config 2 with its textures): the
     327,684-triangle mesh whose material 1 carries a 1,024x1,024 map_Kd
     checker and a 256x256 `map_Bump -bm 5.0` sine field, lit by its quad
     and a 256x512 equirect sky bright over its top quarter, through
     `render_image` at the main widths on `closest_hit_pipe` alone (seconds,
     rays/s, launches): the checker must show (red > 2 blue and blue > 2
     red each on >= 20% of the mesh's pixels), the bump must change the
     image against the same render without it (mean |difference| > 1e-3),
     the means of the image and of the mesh's pixels must agree within 5%
     with a CPU plain-path render of the same textures on the mesh at
     subdiv 4 (64x64, 8 samples a pixel); on that mesh at 32x32 from the
     same uniforms, card against CPU, >= 99% of rays at level 8 (phase 5's
     gate) and, at level 3, the bumped texel gradient NaN on the same rows; the gradient leg without
     the bump map (512x512, spp 2, level 8, the L2 loss against its own
     forward image, d loss / d atlas_rgb by path replay: seconds,
     grad-rays/s, peak memory, launches), the texel gather's float64
     backward against a float32 one, the gradient at 64x64 within 5% of a
     central difference along one checker cell's texels, three `optimize`
     steps of `atlas_rgb` whose loss must fall, and `closest_hit_pipe`
     against its plain version and `closest_hit` on a recorded textured
     wavefront (phase 4's checks and times);
 20. the bench's glass + depth-of-field leg: the Cornell box with
     `glass_priority`, aperture 0.08, focus 2.0, through
     `renderer.render_from_config` at 512x512, sample_size 4 x
     dof_sample_size 2, level 8 on `closest_hit` alone (seconds and
     `rays_per_sec_fwd_glass_dof`): the card's image mean at 64x64 within
     5% of a CPU render's at that size (the main path's printed beside
     them: the camera samples pixel centres, so a frame's mean depends on
     its size), the spread of the central crop's red channel
     (`test_depth_of_field_blurs_out_of_focus`'s measure) below the pinhole
     render's of as many samples, and `closest_hit` against its plain
     version on the fullest recorded wavefront (phase 3's checks and times);
 21. the paths no earlier phase runs on the card, each held to the port's
     CPU run (uniforms drawn on the CPU where both run): (1) the gradient to
     `kd` and `ks` on phase 8's Cornell at 64x64, spp 2, level 8 by path
     replay (within 5% of a central difference along a random direction in
     kd-space; card vs CPU on the same uniforms within 1e-3, the NaN rows of
     the `n_s` gradient the CPU's) and three `optimize` steps on fixed paths
     whose loss must fall; (2) phase 17's differentiable SPPM step on the fog
     box with the grid gathers and the volume gather at 32x32, 1,024 photons
     (d mean / d ke within 1% of a central difference; card vs CPU: >= 99%
     of pixels, gradients within 1%); (3) a `MAX_POTENTIAL_TARGETS` overflow:
     phase 15's 2,048 emitters hung as 32 parallel sheets (the flat panel
     cannot overflow: its grazing rays stab at most two leaves), 4,096 rays
     under them: at level 1 `mis_targets_dropped` > 0 and the CPU's, at
     level 3 parting only at rays that met a leaf box's boundary (started
     on a sheet's plane, crossed a quad's edge), >= 99% of rays agreeing at
     both; (4) `optimize` stopped after 2 steps and resumed to 4,
     `render_sppm` after 1 pass and resumed to 2, each bit for bit the
     uninterrupted run, the checkpoint loaded onto the card; (5) the CLI as a
     child process without `--device` on phase 6's Cornell and phase 9's
     box at 64x64: exit 0, a CUDA render in its log, the files that the CPU
     run writes, the image an in-process render's to 8 bits;
 22. the bench: `python3 bench_torch.py` as a child process on the card at a
     small size (64x64, spp 2, level 4; 16,384 photons; the SPPM legs at
     64x64 with 8,192 photons, the differentiable one at 32x32 with 1,024; one
     timed call a leg): exit 0, a line for each of its eight legs, each leg's
     launches those of its path (forward and glass + DoF on `closest_hit`,
     `nee_dense` and `shade_surface`, the mesh on `closest_hit_pipe`,
     `nee_dense` and `shade_surface`, the
     backward pass on `closest_hit` alone, each by its count; the SPPM legs
     and the differentiable step on `closest_hit` and `anyhit`), the final
     line `bench.py`'s with its `detail` keys, `backend` cuda, the card's
     name and power limit;
 23. the scaling harness: `python3 bench_scaling_torch.py` as a child process at
     its defaults (256x256, spp 4, level 4) twice, (a) one rank a GPU over NCCL
     and (b) `--virtual 4`, 1, 2 and 4 gloo ranks sharing the card: exit 0,
     `bench_scaling.py`'s line with the port's keys, the sweep's sizes, every
     image the one-rank image bit for bit, `backend` cuda and the collective
     backend of each, the card's name and power limit, and each member's
     launches in the timed call 16 `closest_hit`, 16 `nee_dense`, 16
     `shade_surface` and no other kernel.  A virtual sweep on one card measures the sharding
     machinery and the host, not scaling across GPUs;
 24. the dense light tree's NEE/MIS kernel (`nee_dense`) at the
     `cornell.forward` cell's shapes (1920x1080 = 2,073,600 rays, 2
     emitters) on the steps that `trace_paths` hands it at bounce 0 and 3:
     its outputs against its plain version's (bit-equal share, largest
     relative difference, picks), its time over 20 launches, the plain
     version's, aten's cumsum over the (R, 2) pdf table (what it replaced),
     the bound from the bytes these inputs need, and one launch a step;
 25. the surface shading kernel (`shade_surface`) at the same shapes on the
     steps that `trace_paths` hands it at bounce 0 and 3: its outputs against
     its plain version's (`interpolate_hit` + `sample_bsdf`: the bit-equal
     share, the share whose flags and material ids agree, the largest
     relative difference), its time over 20 launches, the plain version's,
     the bound from the bytes these inputs need, and one launch a step.
To keep the run short some references run at a smaller depth than the main
paths: the Cornell SPPM render makes 2 of the bench's passes and its CPU
reference is 48x48, the render forced onto `closest_hit` and the mesh's CPU
reference (phase 7) takes 2 samples a pixel, phase 19's 8 on the mesh at
subdiv 4, the Cornell CPU reference 16, the many-lights one 4, the glass
one 16 (8 x 2 lens samples), and the ragged-tail mesh wavefronts hold 4,096
rays against the plain versions.
Each phase logs its seconds, and a line before the JSON record lists them.
The line before the card's line is the per-kernel JSON record; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = pathlib.Path(__file__).resolve().parent
MAIN = dict(width=512, height=512, spp=8, level=8, weight=0.5)
SPPM = dict(width=512, height=512, photons=50000, max_bounce=8, passes=2)  # the bench's SPPM leg, 2 of its passes
SPPM_CPU_SIDE = 48  # the CPU render that the SPPM render is held against
SPPM_SAME_PHOTONS = 4096  # photons of the same-inputs pass, card against CPU
GATHER_CHUNK = 16384  # pixels per chunk of the grid gather: one any-hit query is this x k_nearest
CORNELL_CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
MESH_CAM = dict(eye=(0.5, 0.8, 2.2), center=(0.5, 0.45, 0.5), up=(0, 1, 0), fovy_deg=45.0)
WAVE_RAYS = 65536  # one wavefront of the main paths
NEE_FRAME = (1920, 1080)  # the cornell.forward cell's frame, one wavefront (phases 24-25)
MESH_SUBDIV, MESH_TRIS = 7, 327684  # the large-mesh configuration
MESH_CPU_SUBDIV = 5  # the mesh that the CPU plain path renders as the reference
TOL_RTOL = 1e-6  # t where slots agree: same float32 ops, no FMA on either side
MIN_SLOT_AGREE = 0.999
PLAIN_SUBSET = 16384  # rays of a mesh wavefront that the plain version also answers
PREFILTER_COUNT_TOL = 0.01  # kernel vs plain version, pairs passed: the mma's own accumulation order
PANEL = dict(nx=32, ny=32, emitters=2048)  # the many-lights configuration
SSS_POINTS = 4096  # above SSS_DENSE_MAX: the hash-grid gather
SSS_SPHERE = ((0.3, 0.2, 0.4), 0.2)  # the scattering sphere of the box
REF_SIDE = 64  # the CPU reference renders of the new paths
# the bench's differentiable-SPPM leg (bench.py:341-375): the SPPM box, d mean(img) / d ke
DIFF_SPPM = dict(side=256, photons=16384, passes=2, max_bounce=8, eye_bounce=8, seed=6)
DIFF_SAME = dict(side=32, photons=1024)  # the same-uniforms render, card against CPU
DIFF_OPT_SIDE = 128  # the optimize steps with SPPM_LOSS_PRODUCTION
DIFF_EPS = 1e-2  # the central difference's step in the scale of ke
# phase 18(b): two ranks on the one card, below the main widths (two processes
# share the card, and gloo takes every collective through host memory)
SCALE_OUT = dict(side=256, spp=2, level=8, photons=50000, max_bounce=8, train_side=128, seed=5)
RANK_TIMEOUT = 300  # seconds that a rank of phase 18(b) may take, its process group's limit
# phase 19: BASELINE config 2 with textures (`tests/test_integration_tex.py`'s
# checker and bump field at these sizes, its directional sky at this size)
TEX = dict(checker=1024, bump=256, bm=5.0, sky_h=256, sky_w=512, sky_band=4.0)
TEX_GRAD_SPP = 2  # the gradient leg's samples a pixel (the bench's backward leg)
# the CPU references of phase 19: the textured mesh at subdiv 4 (on the card its
# image and mesh means are subdiv 7's within 0.9%: scripts/reference_spread.py),
# 64x64 at 8 samples a pixel
TEX_CPU = dict(subdiv=4, side=64, spp=8)
TEX_NAN_SIDE = 32  # the bumped texel gradient, card against CPU
# phase 20: the bench's glass + depth-of-field leg (bench.py:280-303)
GLASS = dict(aperture=0.08, focus_dist=2.0, spp=MAIN["spp"] // 2, dof=2)
# phase 21: the gradient to kd and ks on phase 8's Cornell (the central
# difference's step and the optimize steps' start, a fraction of the true
# tables, and learning rate)
CARD_GRAD = dict(side=64, spp=2, target_spp=16, seed=32, eps=3e-4, start=0.7, lr=0.05, steps=3)
GRAD_SAME_TOL = 1e-3  # |g card - g CPU| / |g CPU| on the same uniforms
LOUVRE = dict(sheets=32, nz=8, ny=4, rays=4096, level=3)  # 32 x 8 x 4 quads: 2,048 emitters
BOUNDARY_TOL = 1e-5  # a ray meets a leaf box's boundary: ~100 float32 ulps at 0.5
CKPT = dict(side=64, photons=8192)  # the checkpointed SPPM render: 64^2 x 8,192 > GRID_MIN_PAIRS
CLI_SIDE = 64
CLI_TIMEOUT = 300  # seconds that one CLI child may take
# phase 22: `bench_torch.py` as a child process, every leg at a small size
BENCH_SMALL = dict(BENCH_SIZE=64, BENCH_SPP=2, BENCH_LEVEL=4, BENCH_PHOTONS=16384,
                   BENCH_SPPM_SIZE=64, BENCH_SPPM_PHOTONS=8192, BENCH_DIFF_SPPM_SIZE=32,
                   BENCH_DIFF_SPPM_PHOTONS=1024, BENCH_REPEATS=1)
BENCH_LEGS = ("forward", "backward", "photon_pass", "glass_dof", "mesh", "sppm_cornell",
              "sppm_fog", "diff_sppm")
# the final line's `detail`: bench.py's keys, the card's name and power limit
BENCH_DETAIL_KEYS = frozenset((
    "size", "spp", "level", "scene", "num_tris", "seconds_fwd", "backend", "grad_rays_per_sec",
    "seconds_bwd", "sppm_photons_per_sec", "seconds_photon_pass", "rays_per_sec_fwd_glass_dof",
    "seconds_fwd_glass_dof", "rays_per_sec_fwd_mesh", "seconds_fwd_mesh", "mesh_num_tris",
    "sppm_pass_seconds_cornell", "sppm_pixels_per_sec_cornell", "sppm_pass_seconds_fog",
    "sppm_pixels_per_sec_fog", "sppm_pass_size", "sppm_pass_photons", "sppm_diff_step_seconds",
    "sppm_diff_pixels_per_sec", "sppm_diff_size", "sppm_diff_photons", "device", "power_limit"))
BENCH_TIMEOUT = 300  # seconds that the bench's child may take
# phase 23: `bench_scaling_torch.py` as a child process at its defaults (BENCH_SIZE 256,
# BENCH_SPP 4, BENCH_LEVEL 4), over NCCL and with `--virtual SCALING_VIRTUAL`
SCALING = dict(size=256, spp=4, level=4)
SCALING_VIRTUAL = 4
SCALING_SIZES = (1, 2, 4, 8, 16, 32)
# its final line: bench_scaling.py's keys and the port's additions
SCALING_KEYS = frozenset(("metric", "value", "unit", "vs_baseline", "detail"))
SCALING_DETAIL_KEYS = frozenset((
    "sweep", "size", "spp", "level", "backend", "virtual_mesh", "collective_backend", "device",
    "power_limit"))
SCALING_SWEEP_KEYS = frozenset((
    "n", "seconds", "rays_per_sec", "efficiency", "bit_for_bit", "member_seconds",
    "member_launches", "member_collectives", "member_peak_gb"))
SCALING_TIMEOUT = 600  # seconds that one child of the harness may take
FLOPS_PER_PAIR = 42  # fp32 operations of one (ray, triangle) Woop test, t included
PEAK_FP32 = 67e12  # H100 SXM, FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM bytes/s


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class PhaseClock:
    """Seconds per phase: `start(n)` ends the phase that ran before it."""

    def __init__(self):
        self.seconds, self.current, self.t0 = {}, None, time.perf_counter()

    def start(self, n: int) -> None:
        now = time.perf_counter()
        if self.current is not None:
            self.seconds[self.current] = round(now - self.t0, 1)
            log(f"phase {self.current} took {now - self.t0:.1f}s")
        self.current, self.t0 = n, now

    def report(self) -> None:
        self.start(None)
        log("seconds per phase: " + ", ".join(f"{n}: {s}" for n, s in self.seconds.items()))


def check(ok: bool, what: str) -> None:
    """A failed check ends the run with a non-zero exit (not an `assert`,
    which `python -O` would drop)."""
    if not ok:
        raise SystemExit(f"[chip_smoke] FAILED: {what}")


def nvidia_smi() -> str:
    """`device.nvidia_smi`: the card's name and power limit (the scripts call
    it by this name)."""
    from gpu_pathtracer_tpu_torch.device import nvidia_smi as query

    return query()


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def agreement(name, t, slot, rt, rslot, stats):
    """Checks slots (>= 99.9%) and t (rtol 1e-6 where slots agree) of a
    kernel against a plain version; records the largest |dt|."""
    import torch

    same = slot == rslot
    agree = float(same.float().mean())
    hit = same & (slot >= 0)
    err = float((t[hit] - rt[hit]).abs().max()) if bool(hit.any()) else 0.0
    close = bool(torch.all((t[hit] - rt[hit]).abs() <= TOL_RTOL * rt[hit].abs()))
    log(f"{name}: {t.shape[0]} rays, hits {float((slot >= 0).float().mean()):.3f}, "
        f"slot agreement {agree:.6f}, max |dt| {err:.3e}")
    check(agree >= MIN_SLOT_AGREE, f"{name}: slot agreement {agree} < {MIN_SLOT_AGREE}")
    check(close, f"{name}: t differs beyond rtol {TOL_RTOL} where slots agree")
    stats["max_abs_err"] = max(stats["max_abs_err"], err)


def bound_ms(rays, tiles, counts, out_bytes: int = 8, extra_tile_bytes: int = 0,
             unit: int = 128):
    """The least time the card could take for one launch's work (`out_bytes`
    of results per ray: 8 for a closest hit, 2 for the any-hit bits), from the
    launch's own counts (one row per `unit` rays that walk together): the
    fp32 pair tests of the tiles that were scanned at the fp32 peak, against
    the bytes that must move (rays in, results out, each scanned tile once
    with `extra_tile_bytes` of further operands, the walked part of each
    128-ray row of the order table and of the tile boxes) at the memory
    rate."""
    n_tiles, rows, tile = tiles.shape
    scanned = int(counts[:, 2].sum())
    walked = int(counts[:, 0].reshape(-1, 128 // unit).amax(dim=1).sum())
    flops = scanned * unit * tile * FLOPS_PER_PAIR
    nbytes = (rays.numel() * 4 + rays.shape[0] * out_bytes
              + min(scanned, n_tiles) * (rows * tile * 4 + extra_tile_bytes) + walked * (4 + 32))
    by_ops, by_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def group_rows(blocks, per_row: int):
    """The groups (rows of the group walk's counts) of the given 128-ray rows."""
    import torch

    return (blocks[:, None] * per_row
            + torch.arange(per_row, device=blocks.device)[None, :]).reshape(-1)


def group_stats(counts) -> str:
    walked, fetched, scanned = (counts[:, i].float() for i in range(3))
    return (f"per group: walked {float(walked.mean()):.1f} (most {int(walked.max())}), fetched "
            f"{float(fetched.mean()):.2f}, scanned {float(scanned.mean()):.2f} (most "
            f"{int(scanned.max())})")


def compare_plain_load(name, rays, tiles, aabb, stats, time_it=False):
    """`closest_hit` vs its plain version on the same prepared rays, and its
    per-group counts vs the group walk's plain version (ring 0); when asked,
    its time and its bound from its own counts."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    order = ch.block_tile_order(rays, aabb, rays.shape[0] // ch.RAY_BLOCK)
    t, slot, counts = ch.launch_closest_hit(rays, tiles, aabb, order, counts=True)
    torch.cuda.synchronize()
    rt, rslot = ch.closest_hit_rays_reference(rays, tiles)
    live = float((rays[:, 6] > 0).float().mean())
    agreement(f"{name} ({tiles.shape[0] * tiles.shape[2]} tri slots, live {live:.3f})",
              t, slot, rt, rslot, stats)
    _, _, rc = ch.closest_hit_pipe_reference(rays, tiles, aabb, order, ring=0)
    same_counts = float((rc == counts).all(dim=1).float().mean())
    log(f"{name}: closest_hit {group_stats(counts)}; counts equal the plain walk's on "
        f"{same_counts:.4f} of the groups")
    check(same_counts >= MIN_SLOT_AGREE, f"{name}: closest_hit's counts differ from the plain "
          f"walk's on {1 - same_counts:.4f} of the groups")
    if not time_it:
        return None
    ms = [cuda_ms(lambda: ch.launch_closest_hit(rays, tiles, aabb, order), 20) for _ in range(2)]
    plain_ms = cuda_ms(lambda: ch.closest_hit_rays_reference(rays, tiles), 3)
    bound, by = bound_ms(rays, tiles, counts, unit=ch.GROUP_RAYS)
    log(f"{name}: kernel {ms[0]:.4f} / {ms[1]:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.5f} ms ({by})")
    return dict(ms=min(ms), plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def compare_pipe(name, rays, tiles, aabb, stats, pipe_stats, time_it=False,
                 plain_subset=PLAIN_SUBSET):
    """`closest_hit_pipe` on prepared rays: bit-equal to `closest_hit` on all
    of them with the same walk (entries walked and tiles scanned per group),
    against its plain version (values and per-group counts) on a subset of
    whole 128-ray rows spread over the batch.  When asked, both kernels'
    times in turns, the cycle split of the slowest group, and the bound from
    the kernel's own counts."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    per_row = ch.RAY_BLOCK // ch.GROUP_RAYS
    order = ch.block_tile_order(rays, aabb, n_blocks)
    t1, slot1, c1 = ch.launch_closest_hit(rays, tiles, aabb, order, counts=True)
    t2, slot2, c2 = ch.launch_closest_hit_pipe(rays, tiles, aabb, order, counts=True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(t1, t2)) and bool(torch.equal(slot1, slot2))
    extra = c2[:, 1].long() - c2[:, 2].long()
    log(f"{name}: {rays.shape[0]} rays x {tiles.shape[0]} tiles; closest_hit_pipe == closest_hit "
        f"bit for bit: {equal} ({int(((t1 != t2) | (slot1 != slot2)).sum())} rays differ); "
        f"closest_hit_pipe {group_stats(c2)}; fetched but not scanned: {int(extra.sum())} tiles "
        f"in {c2.shape[0]} groups")
    check(equal, f"{name}: closest_hit_pipe and closest_hit differ")
    check(bool(torch.equal(c1[:, 0], c2[:, 0])) and bool(torch.equal(c1[:, 2], c2[:, 2])),
          f"{name}: the two kernels walk differently")
    check(bool(torch.equal(c1[:, 1], c1[:, 2])), f"{name}: closest_hit staged a tile it did not scan")
    check(bool((extra >= 0).all()) and bool((extra <= ch.PIPE_RING).all()),
          f"{name}: a group fetched {int(extra.max())} tiles more than it scanned")

    blocks, rows, sub_rays, sub_order = plain_rows(rays, order, plain_subset)
    t0 = time.perf_counter()
    rt, rslot, rc = ch.closest_hit_pipe_reference(sub_rays, tiles, aabb, sub_order)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    agreement(f"{name}, plain version on {sub_rays.shape[0]} rays", t2[rows], slot2[rows],
              rt, rslot, stats)
    same_counts = float((rc == c2[group_rows(blocks, per_row)]).all(dim=1).float().mean())
    log(f"{name}: plain version's counts equal the kernel's on {same_counts:.4f} of the "
        f"subset's groups")
    check(same_counts >= MIN_SLOT_AGREE, f"{name}: walked/fetched/scanned counts differ from the "
          f"plain version's on {1 - same_counts:.4f} of the groups")
    if not time_it:
        return
    # kernels in turns, on the same wavefront
    ms1a = cuda_ms(lambda: ch.launch_closest_hit(rays, tiles, aabb, order), 20)
    ms2a = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    ms2b = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    ms1b = cuda_ms(lambda: ch.launch_closest_hit(rays, tiles, aabb, order), 20)
    order_ms = cuda_ms(lambda: ch.block_tile_order(rays, aabb, n_blocks), 20)
    *_, cyc = ch.launch_closest_hit_pipe(rays, tiles, aabb, order, counts=True, cycles=True)
    slow, split = slowest_split(cyc)
    bound, by = bound_ms(rays, tiles, c2, unit=ch.GROUP_RAYS)
    log(f"{name}: closest_hit_pipe {ms2a:.4f} / {ms2b:.4f} ms, closest_hit {ms1a:.4f} / "
        f"{ms1b:.4f} ms (20 launches each, in turns), plain version {plain_s * 1e3:.1f} ms "
        f"(one launch, {sub_rays.shape[0]} rays), block_tile_order {order_ms:.4f} ms; the "
        f"slowest group (walked {int(c2[slow, 0])}, scanned {int(c2[slow, 2])}) spends {split:.3f} "
        f"of its {int(cyc[slow, 0])} cycles staging and scanning; bound {bound:.5f} ms ({by})")
    pipe_stats.update(ms=min(ms2a, ms2b), plain_ms=plain_s * 1e3, plain_rays=sub_rays.shape[0],
                      plain_load_ms=min(ms1a, ms1b), order_ms=order_ms, bound_ms=bound,
                      bound_by=by, scan_share_slowest=split, most_scanned=int(c2[:, 2].max()))


def plain_rows(rays, order, plain_subset):
    """Every k-th 128-ray row of a prepared batch, so that about
    `plain_subset` rays remain: (rows, ray indices, rays, order rows)."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    stride = max(1, rays.shape[0] // plain_subset)
    blocks = torch.arange(0, n_blocks, stride, device=rays.device)
    rows = (blocks[:, None] * ch.RAY_BLOCK
            + torch.arange(ch.RAY_BLOCK, device=rays.device)[None, :]).reshape(-1)
    return blocks, rows, rays[rows].contiguous(), order[blocks].contiguous()


def slowest_split(cycles):
    """The group with the most walk cycles, and the share of them spent
    staging and scanning."""
    import torch

    slow = int(torch.argmax(cycles[:, 0]))
    return slow, float(cycles[slow, 1]) / max(float(cycles[slow, 0]), 1.0)


def compare_mxu(name, rays, g, stats, out, time_it=False, plain_subset=PLAIN_SUBSET):
    """`closest_hit_mxu` on prepared rays: (t, slot) bit-equal to
    `closest_hit_pipe` on all of them, with the walk counts (walked,
    fetched, scanned) equal group by group; against its plain version on a
    subset of whole 128-ray rows spread over the batch (values, walk counts
    per group, the prefilter's pairs passed within PREFILTER_COUNT_TOL); the
    share of pairs it culls, and on the rows' nearest tiles the shares
    culled pair by pair, after the union over an 8-ray group (the kernel's
    cull) and after the union over a 32-ray warp (the cull of the 128-ray
    block walk before).  When asked, both kernels' times in turns, the cycle
    split of the slowest group and the bound from its own counts."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    tiles, aabb, edge, wsum = g.tiles, g.tile_aabb, g.edge_tiles, g.edge_wsum
    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    per_row = ch.RAY_BLOCK // ch.GROUP_RAYS
    order = ch.block_tile_order(rays, aabb, n_blocks)
    t2, slot2, c2 = ch.launch_closest_hit_pipe(rays, tiles, aabb, order, counts=True)
    t5, slot5, c5 = ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order, counts=True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(t2, t5)) and bool(torch.equal(slot2, slot5))
    differ = int(((t2 != t5) | (slot2 != slot5)).sum())
    same_walk = bool(torch.equal(c5[:, :3], c2))
    walked, fetched, scanned, passed, culled = (int(x) for x in c5.long().sum(dim=0))
    pairs = scanned * ch.GROUP_RAYS * tiles.shape[2]
    share = culled / max(pairs, 1)
    n_groups = c5.shape[0]
    log(f"{name}: {rays.shape[0]} rays x {tiles.shape[0]} tiles; closest_hit_mxu == "
        f"closest_hit_pipe bit for bit: {equal} ({differ} rays differ); walk counts equal "
        f"closest_hit_pipe's on every group: {same_walk}; closest_hit_mxu {group_stats(c5)}; of "
        f"{pairs} pairs of scanned tiles the prefilter passed {passed} to the exact test and "
        f"culled {culled} ({share:.4f})")
    check(equal, f"{name}: closest_hit_mxu and closest_hit_pipe differ on {differ} rays")
    check(same_walk, f"{name}: closest_hit_mxu walks differently from closest_hit_pipe")
    check(bool(torch.equal(c5[:, 3].long() + c5[:, 4].long(),
                           c5[:, 2].long() * ch.GROUP_RAYS * tiles.shape[2])),
          f"{name}: passed + culled != the pairs of a group's scanned tiles")
    check(culled > 0 or scanned == 0, f"{name}: the prefilter culled nothing")

    blocks, rows, sub_rays, sub_order = plain_rows(rays, order, plain_subset)
    t0 = time.perf_counter()
    rt, rslot, rc = ch.closest_hit_mxu_reference(sub_rays, tiles, edge, wsum, aabb, sub_order)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    agreement(f"{name}, plain version on {sub_rays.shape[0]} rays", t5[rows], slot5[rows],
              rt, rslot, stats)
    kc = c5[group_rows(blocks, per_row)]
    same_counts = float((rc[:, :3] == kc[:, :3]).all(dim=1).float().mean())
    k_passed, p_passed = int(kc[:, 3].long().sum()), int(rc[:, 3].long().sum())
    off = abs(k_passed - p_passed) / max(p_passed, 1)
    log(f"{name}: plain version's walk counts equal the kernel's on {same_counts:.4f} of the "
        f"subset's groups; pairs passed: kernel {k_passed}, plain version {p_passed} "
        f"(rel. difference {off:.6f}, tolerance {PREFILTER_COUNT_TOL})")
    check(same_counts >= MIN_SLOT_AGREE, f"{name}: walk counts differ from the plain version's")
    check(off <= PREFILTER_COUNT_TOL, f"{name}: the prefilter's counts are off the plain version's")

    # on 32 spread rows' nearest tiles with the rays' initial budgets: pair by
    # pair, after the union over a group's 8 rays, after the union over 32
    probe = blocks[:: max(1, blocks.shape[0] // 32)]
    first = order[probe, 0].long()
    rb = rays.reshape(n_blocks, ch.RAY_BLOCK, 8)[probe]
    cand = ch.prefilter_candidates(rb, edge[first], wsum[first], rb[..., 6:7])
    live = (rb[..., 6] > 0).sum() * tiles.shape[2]
    pair_share = 1.0 - float(cand.sum()) / max(int(live), 1)
    unions = {n: 1.0 - float(cand.reshape(-1, ch.RAY_BLOCK // n, n, tiles.shape[2])
                             .any(dim=2).float().mean()) for n in (ch.GROUP_RAYS, 32)}
    log(f"{name}: on {probe.shape[0]} rows' nearest tiles the prefilter culls {pair_share:.4f} "
        f"of the live rays' pairs one by one, {unions[ch.GROUP_RAYS]:.4f} of the columns after "
        f"the union over an 8-ray group, {unions[32]:.4f} after the union over 32 rays")
    if not time_it:
        return
    ms2a = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    ms5a = cuda_ms(lambda: ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order), 20)
    ms5b = cuda_ms(lambda: ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order), 20)
    ms2b = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    *_, cyc = ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order, counts=True,
                                        cycles=True)
    slow, split = slowest_split(cyc)
    extra = edge[0].numel() * 2 + wsum[0].numel() * 4
    bound, by = bound_ms(rays, tiles, c5, extra_tile_bytes=extra, unit=ch.GROUP_RAYS)
    log(f"{name}: closest_hit_mxu {ms5a:.4f} / {ms5b:.4f} ms, closest_hit_pipe {ms2a:.4f} / "
        f"{ms2b:.4f} ms (20 launches each, in turns), plain version {plain_s * 1e3:.1f} ms (one "
        f"launch, {sub_rays.shape[0]} rays); the slowest group (walked {int(c5[slow, 0])}, "
        f"scanned {int(c5[slow, 2])}, passed {int(c5[slow, 3])}) spends {split:.3f} of its "
        f"{int(cyc[slow, 0])} cycles staging, prefiltering and scanning; bound {bound:.5f} ms "
        f"({by})")
    out.update(ms=min(ms5a, ms5b), plain_ms=plain_s * 1e3, plain_rays=sub_rays.shape[0],
               pipe_ms=min(ms2a, ms2b), bound_ms=bound, bound_by=by, culled_share=share,
               culled_share_per_pair=pair_share, culled_share_group_union=unions[ch.GROUP_RAYS],
               culled_share_warp_union=unions[32], scan_share_slowest=split,
               most_scanned=int(c5[:, 2].max()), scanned_per_group=scanned / n_groups,
               walked_per_group=walked / n_groups)


def compare_anyhit(name, rays, tiles, aabb, err, out, plain_subset, time_it=False):
    """Both any-hit kernels on prepared window rays: `anyhit_pipe` bit-equal
    to `anyhit` on all of them with the same walk (entries walked and tiles
    scanned per group; at most PIPE_RING tiles fetched and not scanned),
    each against its plain version (bits and per-group counts) on a subset of
    whole 128-ray rows spread over the batch, and both bits against those
    derived from `closest_hit` on the same rays (hit & t < t_near, hit
    within t_far), coplanar ties aside.  `err` counts the rays whose bits
    differ from the plain versions'.  When asked, both kernels' times in
    turns, the slowest group's cycle split and the bound from their own
    counts."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import anyhit as ah
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    per_row = ch.RAY_BLOCK // ch.GROUP_RAYS
    order = ch.block_tile_order(rays, aabb, n_blocks)
    n3, f3, c3 = ah.launch_anyhit(rays, tiles, aabb, order, counts=True)
    n4, f4, c4 = ah.launch_anyhit_pipe(rays, tiles, aabb, order, counts=True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(n3, n4)) and bool(torch.equal(f3, f4))
    extra = c4[:, 1].long() - c4[:, 2].long()
    live = float((rays[:, 6] > 0).float().mean())
    log(f"{name}: {rays.shape[0]} rays (live {live:.3f}) x {tiles.shape[0]} tiles; far "
        f"{float(f3.float().mean()):.3f}, near {float(n3.float().mean()):.3f}; anyhit_pipe == anyhit "
        f"on every ray: {equal} ({int(((n3 != n4) | (f3 != f4)).sum())} rays differ); anyhit "
        f"{group_stats(c3)}; anyhit_pipe {group_stats(c4)}; fetched but not scanned: "
        f"{int(extra.sum())} tiles in {c4.shape[0]} groups")
    check(equal, f"{name}: anyhit_pipe and anyhit differ")
    check(bool(torch.equal(c3[:, 0], c4[:, 0])) and bool(torch.equal(c3[:, 2], c4[:, 2])),
          f"{name}: the two any-hit kernels walk differently")
    check(bool(torch.equal(c3[:, 1], c3[:, 2])), f"{name}: anyhit staged a tile it did not scan")
    check(bool((extra >= 0).all()) and bool((extra <= ch.PIPE_RING).all()),
          f"{name}: a group fetched {int(extra.max())} tiles more than it scanned")

    # the plain versions on every k-th 128-ray row
    blocks, rows, sub_rays, sub_order = plain_rows(rays, order, plain_subset)
    groups = group_rows(blocks, per_row)
    plain_s = {}
    for kernel, reference, (kn, kf, kc) in (("anyhit", ah.anyhit_reference, (n3, f3, c3)),
                                            ("anyhit_pipe", ah.anyhit_pipe_reference, (n4, f4, c4))):
        t0 = time.perf_counter()
        rn, rf, rc = reference(sub_rays, tiles, aabb, sub_order)
        torch.cuda.synchronize()
        plain_s[kernel] = time.perf_counter() - t0
        differ = int(((kn[rows] != rn) | (kf[rows] != rf)).sum())
        same_counts = float((rc == kc[groups]).all(dim=1).float().mean())
        log(f"{name}: {kernel} against its plain version on {sub_rays.shape[0]} rays: "
            f"{differ} rays differ, per-group counts equal on {same_counts:.4f} of the groups")
        check(differ == 0, f"{name}: {kernel} differs from its plain version on {differ} rays")
        check(same_counts == 1.0, f"{name}: {kernel}'s per-group counts differ from the plain "
              f"version's on {1 - same_counts:.4f} of the groups")
        err[kernel] = max(err[kernel], differ)

    # the bits derived from the closest-hit kernel: the same rays with the
    # far cap as the closest hit's budget
    as_closest = rays.clone()
    as_closest[:, 7] = 0.0
    t, slot = ch.launch_closest_hit(as_closest, tiles, aabb, order)
    hit = slot >= 0
    agree = float(((n3 == (hit & (t < rays[:, 7]))) & (f3 == hit)).float().mean())
    log(f"{name}: bits equal those derived from closest_hit on {agree:.6f} of the rays")
    check(agree >= MIN_SLOT_AGREE, f"{name}: any-hit bits off the closest hit's on {1 - agree:.6f}")
    if not time_it:
        return
    ms3a = cuda_ms(lambda: ah.launch_anyhit(rays, tiles, aabb, order), 20)
    ms4a = cuda_ms(lambda: ah.launch_anyhit_pipe(rays, tiles, aabb, order), 20)
    ms4b = cuda_ms(lambda: ah.launch_anyhit_pipe(rays, tiles, aabb, order), 20)
    ms3b = cuda_ms(lambda: ah.launch_anyhit(rays, tiles, aabb, order), 20)
    ms1 = cuda_ms(lambda: ch.launch_closest_hit(as_closest, tiles, aabb, order), 20)
    order_ms = cuda_ms(lambda: ch.block_tile_order(rays, aabb, n_blocks), 20)
    splits = {}
    for kernel, launch, kc in (("anyhit", ah.launch_anyhit, c3),
                               ("anyhit_pipe", ah.launch_anyhit_pipe, c4)):
        *_, cyc = launch(rays, tiles, aabb, order, cycles=True)
        slow, split = slowest_split(cyc)
        bound, by = bound_ms(rays, tiles, kc, out_bytes=2, unit=ch.GROUP_RAYS)
        splits[kernel] = (slow, split, int(cyc[slow, 0]), bound, by)
        log(f"{name}: {kernel}'s slowest group (walked {int(kc[slow, 0])}, scanned "
            f"{int(kc[slow, 2])}) spends {split:.3f} of its {int(cyc[slow, 0])} cycles staging and "
            f"scanning; the most tiles scanned by a group: {int(kc[:, 2].max())}; bound from its "
            f"own counts {bound:.5f} ms ({by})")
    log(f"{name}: anyhit {ms3a:.4f} / {ms3b:.4f} ms, anyhit_pipe {ms4a:.4f} / {ms4b:.4f} ms, "
        f"closest_hit on the same rays {ms1:.4f} ms (20 launches each, in turns); plain versions "
        f"{plain_s['anyhit'] * 1e3:.1f} / {plain_s['anyhit_pipe'] * 1e3:.1f} ms (one call, "
        f"{sub_rays.shape[0]} rays); block_tile_order {order_ms:.4f} ms")
    for kernel, ms, plain, kc in (("anyhit", min(ms3a, ms3b), plain_s["anyhit"], c3),
                                  ("anyhit_pipe", min(ms4a, ms4b), plain_s["anyhit_pipe"], c4)):
        _, split, _, bound, by = splits[kernel]
        out[kernel] = dict(ms=ms, plain_ms=plain * 1e3, bound_ms=bound, bound_by=by,
                           most_tiles_scanned_by_a_group=int(kc[:, 2].max()),
                           slowest_group_scan_share=split)
    out.update(plain_rays=sub_rays.shape[0], rays=rays.shape[0], closest_ms=ms1, order_ms=order_ms)


class RecordedGather:
    """While installed, keeps the arguments of the any-hit query with the most
    live rays that `ops.trace` makes (the rays as the kernel's launcher gets
    them: dead rays parked, coherence-sorted) and counts the queries.  It
    launches nothing itself."""

    def __init__(self, trace):
        self.trace, self.inner = trace, trace.occluded_window_tiles
        self.calls, self.live, self.args, self.big = 0, -1, None, None

    def __enter__(self):
        def spy(tiles, aabb, origin, direction, t_near, t_far=float("inf"), big=False):
            self.calls += 1
            live = int((t_far > 0).sum())
            if live > self.live:
                self.live, self.big = live, big
                self.args = tuple(x.clone() for x in (origin, direction, t_near, t_far))
            return self.inner(tiles, aabb, origin, direction, t_near, t_far, big=big)

        self.trace.occluded_window_tiles = spy
        return self

    def __exit__(self, *exc):
        self.trace.occluded_window_tiles = self.inner

    def rays(self, aabb, drop_tail: int = 0):
        from gpu_pathtracer_tpu_torch.ops import anyhit as ah

        o, d, t_near, t_far = (x[: x.shape[0] - drop_tail] for x in self.args)
        return ah.prepare_rays_window(aabb, o, d, t_near, t_far)


class RecordedClosest:
    """While installed, keeps for each geometry set and wavefront width the
    arguments of the `trace.closest_hit` query with the most live rays and of
    the one with the fewest (but some).  It launches nothing itself."""

    def __init__(self, trace):
        self.trace, self.inner = trace, trace.closest_hit
        self.fullest, self.sparsest = {}, {}

    def __enter__(self):
        import torch

        def spy(g, origin, direction, t_max=float("inf"), live=None):
            r = origin.shape[0]
            alive = torch.ones(r, dtype=torch.bool, device=origin.device) if live is None else live
            n = int(alive.sum())
            wave = (g, origin.detach().clone(), direction.detach().clone(), alive.clone(), n)
            key = (id(g), r)
            if n > self.fullest.get(key, (None,) * 4 + (-1,))[4]:
                self.fullest[key] = wave
            if 0 < n < self.sparsest.get(key, (None,) * 4 + (r + 1,))[4]:
                self.sparsest[key] = wave
            return self.inner(g, origin, direction, t_max, live)

        self.trace.closest_hit = spy
        return self

    def __exit__(self, *exc):
        self.trace.closest_hit = self.inner


def log_passes(name, pass_log, photons):
    for p in pass_log:
        per = p["gather_s"] * 1e3 / max(p["anyhit_launches"], 1)
        log(f"{name} pass {p['it'] + 1}: photon pass {p['photon_s']:.3f}s ({photons / p['photon_s']:.0f} "
            f"photons/s; {p['surface_photons']} surface, {p['volume_photons']} volume deposits), eye pass "
            f"{p['eye_s']:.3f}s, gather + update {p['gather_s']:.3f}s ({p['anyhit_launches']} any-hit "
            f"launches, {per:.2f} ms of gather per launch), {p['host_syncs']} host syncs, k_nearest "
            f"{p['k_nearest']}, k_per_cell {p['k_per_cell']}, dropped {p['dropped']}, grid {p['grid']}")


def sppm_box_master(folder, fog, config, testscenes, **overrides):
    """The bench's SPPM box (Cornell box with octahedron spheres, the light
    given a diffuse component; `fog` adds the medium) and a master file for
    the SPPM render of it; returns the parsed config."""
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=0, fog=fog)
    mtl = folder / "box.mtl"
    mtl.write_text(mtl.read_text().replace("newmtl light\nKd 0 0 0",
                                           "newmtl light\nKd 0.78 0.78 0.78"))
    kw = dict(
        input_folder_path=f"{folder}/", obj_filename="box.obj",
        image_output_path=str(folder / "sppm.ppm"), image_width=SPPM["width"],
        image_height=SPPM["height"], render_mode=2, ppm_num_photon_per_pass=SPPM["photons"],
        ppm_num_pass=SPPM["passes"], ppm_max_bounce=SPPM["max_bounce"],
        eye_x=0.5, eye_y=0.5, eye_z=2.4, center_x=0.5, center_y=0.5, center_z=0.0, fovy=40.0,
    )
    kw.update(overrides)
    master = folder / "sppm_master.txt"
    config.write_master_file(config.RenderConfig(**kw), master)
    return config.parse_master_file(master)


def visibility_rays(scene, camera, side: int, n_pixels: int, k: int, seed: int):
    """A gather-shaped any-hit query in which every ray is live: from the hit
    points of `n_pixels` neighbouring pixels of the SPPM eye pass, `k` rays
    each toward other hit points (the gathers' rays run from a hit point
    toward a photon's previous location, another surface point), the window's
    near cap just short of the target as in `_visible_flux`; sorted and
    prepared as `ops.trace.occluded_window` does."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import anyhit as ah
    from gpu_pathtracer_tpu_torch.ops import linalg, trace
    from gpu_pathtracer_tpu_torch.render import sppm

    g = scene.geom
    dev = g.p.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32, device=dev),
                            torch.arange(side, dtype=torch.float32, device=dev), indexing="ij")
    r = side * side
    with torch.no_grad():
        outs = sppm.eye_pass(scene, camera, ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5, None,
                             torch.full((r,), float("inf"), device=dev), init=True, generator=gen)
    pts = outs[0][outs[5]]
    check(pts.shape[0] >= n_pixels, f"visibility rays: only {pts.shape[0]} hit points")
    first = (pts.shape[0] - n_pixels) // 2
    origin = pts[first:first + n_pixels].repeat_interleave(k, dim=0)
    target = pts[torch.randint(pts.shape[0], (n_pixels * k,), generator=gen, device=dev)]
    vec = target - origin
    length = linalg.length(vec)
    direction = linalg.normalize(vec, 1e-6)
    perm = trace.coherence_perm(g, origin, direction)
    return ah.prepare_rays_window(g.tile_aabb, origin[perm], direction[perm],
                                  (length * (1.0 - 1e-3))[perm])


def photon_uniforms(rand, n_photons: int, max_bounce: int) -> dict:
    """Explicit uniforms of `sppm.photon_pass` (its docstring's layout), each
    array drawn by `rand(*shape)`."""
    from gpu_pathtracer_tpu_torch.render import sppm

    p = n_photons
    return {"emit": rand(5, p), "stack": rand(sppm.STACK_PROBE_STEPS, 4, p),
            "steps": rand(4 * max_bounce + 32, sppm.PHOTON_STEP_UNIFORMS, p)}


def eye_uniforms(rand, r: int, bounces: int) -> dict:
    """Explicit uniforms of `sppm.eye_pass` on a scene of the dense light
    regime (its docstring's layout), each array drawn by `rand(*shape)`."""
    from gpu_pathtracer_tpu_torch.render import sppm

    return {"lens": rand(2, r), "stack": rand(sppm.STACK_PROBE_STEPS, 4, r),
            "bounce": rand(bounces, 4, r), "direct_bsdf": rand(4, r), "direct_pick": rand(r),
            "direct_light": rand(2, r), "direct_chain": rand(sppm.DIRECT_CHAIN_STEPS, 4, r)}


def diff_sppm_uniforms(seed: int, kw: dict) -> dict:
    """Explicit uniforms of `render_sppm_differentiable` (its docstring's
    layout) for the render keywords `kw` (width, height, n_photons, num_pass,
    max_bounce, eye_bounce), drawn on the CPU from `torch.Generator` seed
    `seed`."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    r, eb, mb = kw["width"] * kw["height"], kw["eye_bounce"], kw["max_bounce"]
    return {"init": eye_uniforms(rand, r, eb),
            "corners": [eye_uniforms(rand, r, eb) for _ in range(4)],
            "passes": [{"photon": photon_uniforms(rand, kw["n_photons"], mb),
                        "eye": eye_uniforms(rand, r, eb), "jitter": rand(2, r)}
                       for _ in range(kw["num_pass"])]}


def sppm_same_inputs(folder, dev, side: int, n_photons: int, max_bounce: int):
    """One SPPM pass on the same inputs on the card and on the CPU's plain
    path: the photon pass and the eye pass from the same explicit uniforms,
    then both surface gathers on the card from the CPU's photons and hit
    points.  Returns the shares of photons, pixels and gathered pixels that
    agree and whether the grid gather's overflow counts are equal."""
    import dataclasses

    import torch
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import obj_io

    host = obj_io.load_scene(folder, "box.obj")
    scenes = {"cpu": build_scene(host, "cpu"), "card": build_scene(host, dev)}
    cams = {"cpu": Camera.create(**CORNELL_CAM, width=side, height=side),
            "card": Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)}
    gen = torch.Generator().manual_seed(9)
    r, p = side * side, n_photons

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    u_photon = photon_uniforms(rand, p, max_bounce)
    u_eye = eye_uniforms(rand, r, 64)
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32),
                            torch.arange(side, dtype=torch.float32), indexing="ij")
    pix_i, pix_j = ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5

    def on_cpu(obj):
        return {f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)}

    photons, eyes = {}, {}
    with torch.no_grad():
        for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
            photons[name] = sppm.photon_pass(scenes[name], p, max_bounce=max_bounce, uniforms=u_photon)
            eyes[name] = sppm.eye_pass(
                scenes[name], cams[name], pix_i.to(d), pix_j.to(d), None,
                torch.full((r,), float("inf"), device=d), init=False, uniforms=u_eye)
        pc, pg = on_cpu(photons["cpu"]), on_cpu(photons["card"])
        both = pc["valid"] & pg["valid"]
        photon_share = float(((pc["valid"] == pg["valid"]) & (pc["on_surface"] == pg["on_surface"])
                              & (~both | torch.isclose(pc["pos"], pg["pos"], rtol=1e-4, atol=1e-5)
                                 .all(dim=-1))).float().mean())
        ec, eg = eyes["cpu"], [x.cpu() for x in eyes["card"]]
        found = ec[5] & eg[5]
        eye_share = float(((ec[5] == eg[5]) & (~found | (
            torch.isclose(ec[0], eg[0], rtol=1e-4, atol=1e-5).all(dim=-1)
            & torch.isclose(ec[3], eg[3], rtol=1e-4, atol=1e-5).all(dim=-1)))).float().mean())

        # the gathers: the CPU's photons and hit points on both devices
        radius = torch.full((r,), 0.05)
        gather_share, overflow_equal = 1.0, True
        card_photons = sppm.Photons(**{k: v.to(dev) for k, v in pc.items()})
        for grid in (False, True):
            res = {}
            for name, ph, d in (("cpu", photons["cpu"], torch.device("cpu")),
                                ("card", card_photons, dev)):
                args = (scenes[name], ph, ec[0].to(d), ec[1].to(d), radius.to(d), ec[5].to(d))
                if grid:
                    res[name] = sppm.surface_gather_grid(*args, return_overflow=True)
                else:
                    res[name] = sppm.surface_gather(*args, return_overflow=True)
            fc, cc, oc = res["cpu"]
            fg, cg, og = (x.cpu() for x in res["card"])
            same = (cc == cg) & torch.isclose(fc, fg, rtol=1e-4, atol=1e-6).all(dim=-1)
            gather_share = min(gather_share, float(same.float().mean()))
            overflow_equal = overflow_equal and int(oc) == int(og)
    return dict(photons=photon_share, eye=eye_share, gather=gather_share,
                overflow_equal=overflow_equal,
                deposits=int(pc["valid"].sum()), gathered=int(res["cpu"][1].sum()))


def diff_sppm_step(scene, camera, kw: dict, ke, **render_kw):
    """One step of the differentiable SPPM leg: the image of
    `render_sppm_differentiable` with the emission table `ke`, the gradient
    of its mean to `ke`, and the forward's and the backward's seconds."""
    import torch
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.render import sppm

    def sync():
        if ke.is_cuda:
            torch.cuda.synchronize()

    ke = ke.detach().clone().requires_grad_(True)
    sync()
    t0 = time.perf_counter()
    img = sppm.render_sppm_differentiable(optim._substitute(scene, {"ke": ke}), camera, **kw,
                                          **render_kw)
    loss = img.mean()
    sync()
    t1 = time.perf_counter()
    (grad,) = torch.autograd.grad(loss, ke)
    sync()
    return img.detach(), grad, t1 - t0, time.perf_counter() - t1


def no_photon_flux(*args, **kwargs):
    """`photon_pass` with every deposited colour set to 0: as the render's
    `photon_pass_fn` it leaves the direct term and drops the indirect one."""
    import torch
    from gpu_pathtracer_tpu_torch.render import sppm

    photons = sppm.photon_pass(*args, **kwargs)
    return dataclasses.replace(photons, color=torch.zeros_like(photons.color))


def diff_sppm(dev, card: str, stats: dict, anyhit_err: dict) -> dict:
    """Phase 17: the differentiable SPPM step of the bench on the card, both
    kernels on the step's recorded queries against their plain versions
    (`stats` and `anyhit_err` as in phases 3 and 10), its gradient and its
    indirect term's gradient against central differences, the same render on
    the same uniforms on the card and on the CPU, and three `optimize` steps
    with `sppm_loss_fn`.  Returns the step's numbers and its kernel
    launches."""
    import statistics

    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.ops import trace
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_diff_"))
    sppm_box_master(folder, False, config, testscenes)
    host = obj_io.load_scene(folder, "box.obj")
    scene = build_scene(host, dev)
    side, passes = DIFF_SPPM["side"], DIFF_SPPM["passes"]
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    kw = dict(width=side, height=side, n_photons=DIFF_SPPM["photons"], num_pass=passes,
              max_bounce=DIFF_SPPM["max_bounce"], eye_bounce=DIFF_SPPM["eye_bounce"])
    ke0 = scene.materials.ke
    seed = DIFF_SPPM["seed"]

    # the main path: one step with the counts set to 0 just before it; its
    # queries are recorded for the kernels' comparisons below
    tracing.reset("launch.")
    tracing.reset("loop_exit")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the scene and what earlier phases keep
    with RecordedClosest(trace) as waves, RecordedGather(trace) as queries:
        img, grad, fwd0, bwd0 = diff_sppm_step(scene, cam, kw, ke0, seed=seed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_peak_gb = peak_gb - held / 1e9
    launches = tracing.launches()
    syncs = tracing.totals["loop_exit"]
    gathers = passes * -(-side * side // GATHER_CHUNK)  # one any-hit launch a grid-gather chunk
    light = ke0.amax(dim=-1) > 0
    log(f"differentiable SPPM: {side}x{side}, {DIFF_SPPM['photons']} photons x {passes} passes, "
        f"max_bounce {DIFF_SPPM['max_bounce']}, eye_bounce {DIFF_SPPM['eye_bounce']}, SPPM box: "
        f"first step forward {fwd0:.3f}s + backward {bwd0:.3f}s, peak memory {peak_gb:.3f} GB "
        f"({step_peak_gb:.3f} GB above what was held before the step), "
        f"launches {launches}, {syncs} host syncs; image mean {float(img.mean()):.6f}; "
        f"d mean / d ke on the light's row {grad[light].flatten().tolist()}; card: {card}")
    check(launches["closest_hit"] > 0 and launches["anyhit"] == gathers,
          f"differentiable SPPM: {launches['anyhit']} anyhit launches, expected {gathers} "
          "(the grid gathers' chunks)")
    check(launches["closest_hit_pipe"] == launches["closest_hit_mxu"] == launches["anyhit_pipe"]
          == 0, "differentiable SPPM: a ring-buffered kernel launched on the box")
    check(img.shape == (side, side, 3) and bool(torch.isfinite(img).all())
          and float(img.mean()) > 0, "differentiable SPPM image not finite or black")
    check(bool(torch.isfinite(grad).all()) and bool((grad[light] != 0).all()),
          "differentiable SPPM gradient not finite or zero on the light's row")

    # both kernels on the step's own queries against their plain versions
    g = scene.geom
    b1 = None
    for key, full_wave in waves.fullest.items():
        for which, (wg, wo, wd, alive, n) in (("fullest", full_wave),
                                               ("sparsest", waves.sparsest[key])):
            r = wo.shape[0]
            what = "the scene" if wg is g else f"a {wg.num_tris}-triangle set"
            timed = which == "fullest" and wg is g and r == side * side
            out = compare_plain_load(f"differentiable SPPM, {which} {r}-ray wavefront on {what} "
                                     f"({n} live)", sorted_rays(wg, (wo, wd, alive)), wg.tiles,
                                     wg.tile_aabb, stats, time_it=timed)
            if timed:
                b1 = dict(out, shape=f"{r} rays x {g.num_tris} triangles, the fullest eye "
                                     "wavefront of the differentiable SPPM step")
    widths = {r for gid, r in waves.fullest if gid == id(g)}
    check(b1 is not None and DIFF_SPPM["photons"] in widths,
          f"differentiable SPPM: recorded wavefronts of widths {sorted(widths)} on the scene")
    check(queries.calls == launches["anyhit"] and not queries.big,
          f"differentiable SPPM: {queries.calls} gather queries for {launches['anyhit']} launches")
    b3 = {}
    log(f"differentiable SPPM: {queries.calls} gather queries; the fullest has {queries.live} live "
        "rays")
    gather_rays = queries.rays(g.tile_aabb)
    compare_anyhit("differentiable SPPM, fullest gather chunk", gather_rays, g.tiles, g.tile_aabb,
                   anyhit_err, b3, plain_subset=gather_rays.shape[0], time_it=True)

    # seconds of a step at ke * 1.01 (the bench's point), median of 3
    steps = [diff_sppm_step(scene, cam, kw, ke0 * 1.01, seed=seed)[2:] for _ in range(3)]
    step_s = statistics.median(f + b for f, b in steps)
    fwd_s = statistics.median(f for f, _ in steps)
    bwd_s = statistics.median(b for _, b in steps)
    pixels_per_s = side * side * passes / step_s
    log(f"differentiable SPPM step (loss + gradient, median of 3): {step_s:.3f}s "
        f"(forward {fwd_s:.3f}s, backward {bwd_s:.3f}s; steps "
        f"{[round(f + b, 3) for f, b in steps]}), sppm_diff_pixels_per_sec {pixels_per_s:.1f}; "
        f"card: {card}")

    # the gradient along ke against a central difference from the same seed;
    # then the indirect term alone: the same renders less those whose photons
    # carry no colour (the direct term, on the same random numbers)
    def sides(**render_kw):
        with torch.no_grad():
            return [sppm.render_sppm_differentiable(optim._substitute(scene, {"ke": ke0 * t}), cam,
                                                    **kw, seed=seed, **render_kw).double()
                    for t in (1.0 + DIFF_EPS, 1.0 - DIFF_EPS)]

    full = sides()
    fd = float(full[0].mean() - full[1].mean()) / (2 * DIFF_EPS)
    an = float((grad * ke0).sum())
    grad_rel = abs(an - fd) / abs(fd)
    log(f"differentiable SPPM: d mean / d theta for ke * theta = {an:.6e} by autograd, {fd:.6e} "
        f"by central difference (eps {DIFF_EPS}), rel diff {grad_rel:.2e}")
    check(fd > 0 and grad_rel < 0.01, f"differentiable SPPM gradient {an} vs difference {fd}")

    img_d, grad_d, _, _ = diff_sppm_step(scene, cam, kw, ke0, seed=seed,
                                         photon_pass_fn=no_photon_flux)
    direct = sides(photon_pass_fn=no_photon_flux)
    indirect_share = 1.0 - float(img_d.double().mean() / img.double().mean())
    fd_ind = float((full[0] - direct[0]).mean() - (full[1] - direct[1]).mean()) / (2 * DIFF_EPS)
    an_ind = float(((grad - grad_d) * ke0).sum())
    ind_rel = abs(an_ind - fd_ind) / abs(fd_ind)
    log(f"differentiable SPPM: the indirect term is {indirect_share:.4e} of the image mean; its "
        f"d mean / d theta {an_ind:.6e} by autograd (the step's less the direct term's), "
        f"{fd_ind:.6e} by central difference, rel diff {ind_rel:.2e}; the direct term's "
        f"{float((grad_d * ke0).sum()):.6e}")
    check(indirect_share > 0 and fd_ind > 0 and ind_rel < 0.01,
          f"differentiable SPPM indirect gradient {an_ind} vs difference {fd_ind}")

    # the same uniforms, drawn on the CPU, through the grid gathers on both devices
    sside, sphot = DIFF_SAME["side"], DIFF_SAME["photons"]
    skw = dict(kw, width=sside, height=sside, n_photons=sphot)
    uniforms = diff_sppm_uniforms(17, skw)
    same = {}
    t0 = time.perf_counter()
    for name, d, scn in (("cpu", torch.device("cpu"), build_scene(host, "cpu")),
                         ("card", dev, scene)):
        scam = Camera.create(**CORNELL_CAM, width=sside, height=sside, device=d)
        simg, sgrad, _, _ = diff_sppm_step(scn, scam, skw, scn.materials.ke, gather_grid=True,
                                           uniforms=uniforms)
        same[name] = (simg.cpu(), sgrad.cpu())
    same_s = time.perf_counter() - t0
    (img_cpu, g_cpu), (img_card, g_card) = same["cpu"], same["card"]
    pixel_share = float(torch.isclose(img_card, img_cpu, rtol=1e-4, atol=1e-6).all(dim=-1)
                        .float().mean())
    same_grad_rel = float((g_card - g_cpu).norm() / g_cpu.norm())
    log(f"differentiable SPPM, same uniforms, {sside}x{sside}, {sphot} photons, grid gathers: "
        f"{pixel_share:.4f} of the pixels agree card vs CPU (rtol 1e-4, atol 1e-6), image means "
        f"{float(img_card.mean()):.6f} / {float(img_cpu.mean()):.6f}; |grad card - grad CPU| / "
        f"|grad CPU| = {same_grad_rel:.2e} ({same_s:.1f}s)")
    check(pixel_share >= 0.99, f"differentiable SPPM same uniforms: {pixel_share:.4f} of pixels")
    check(same_grad_rel < 0.01, f"differentiable SPPM same uniforms: gradients {same_grad_rel:.2e}")

    # three optimize steps through the photon mapper at the production sizes
    ocam = Camera.create(**CORNELL_CAM, width=DIFF_OPT_SIDE, height=DIFF_OPT_SIDE, device=dev)
    with torch.no_grad():
        target = sppm.render_sppm_differentiable(scene, ocam, DIFF_OPT_SIDE, DIFF_OPT_SIDE,
                                                 seed=7, **optim.SPPM_LOSS_PRODUCTION)
    dim = optim._substitute(scene, {"ke": ke0 * 0.3})
    t0 = time.perf_counter()
    params, losses = optim.optimize(
        dim, ocam, target, param_names=("ke",), steps=3, lr=0.5, seed=1,
        loss_fn=optim.sppm_loss_fn(dim, ocam, target, **optim.SPPM_LOSS_PRODUCTION))
    opt_s = time.perf_counter() - t0
    log(f"optimize through the photon mapper, 3 steps at {DIFF_OPT_SIDE}x{DIFF_OPT_SIDE} with "
        f"SPPM_LOSS_PRODUCTION {optim.SPPM_LOSS_PRODUCTION}: losses {losses} ({opt_s:.1f}s); ke "
        f"on the light's row {params['ke'][light].flatten().tolist()} (true "
        f"{ke0[light].flatten().tolist()})")
    check(len(losses) == 3 and bool(np.isfinite(losses).all()), f"optimize losses {losses}")
    check(bool(torch.isfinite(params["ke"]).all()) and bool((params["ke"] >= 0).all()),
          "optimize left a negative or non-finite parameter")
    return dict(step_s=step_s, fwd_s=fwd_s, bwd_s=bwd_s, pixels_per_s=pixels_per_s,
                peak_gb=peak_gb, step_peak_gb=step_peak_gb, launches=launches,
                host_syncs=syncs, grad_rel=grad_rel, indirect_share=indirect_share,
                indirect_grad_rel=ind_rel, same_pixels=pixel_share, same_grad_rel=same_grad_rel,
                closest_hit=b1,
                anyhit=dict(b3["anyhit"], shape=f"{gather_rays.shape[0]} rays x {g.num_tris} "
                            "triangles, the fullest gather chunk of the differentiable SPPM step"))


def rendezvous(rank: int, world: int, port_file, timeout: float):
    """`parallel.launch.rendezvous` (the two-rank tests' ranks call it by this
    name)."""
    from gpu_pathtracer_tpu_torch.parallel import launch

    return launch.rendezvous(rank, world, port_file, timeout)


def exit_reason(rc: int) -> str:
    """`parallel.launch.exit_reason`: a child's exit code in words."""
    from gpu_pathtracer_tpu_torch.parallel import launch

    return launch.exit_reason(rc)


def scale_out_rank(rank: int, out_dir: str, cornell_dir: str, box_dir: str) -> int:
    """One of phase 18(b)'s two ranks (`chip_smoke.py --scale-out-rank OUT
    CORNELL BOX --rank R`, started by `parallel.launch.run_ranks`): a gloo
    group of 2 on `cuda:0` (rank 0 binds its port and hands it on through
    OUT/port); the sharded render, the sharded photon pass, the sharded
    differentiable SPPM step and one `train_step_distributed`.  Rank 0
    writes the results; each rank writes its seconds and launches."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.parallel import dist as pdist
    from gpu_pathtracer_tpu_torch.parallel import shard, sppm_shard
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import obj_io

    store = rendezvous(rank, 2, pathlib.Path(out_dir) / "port", RANK_TIMEOUT)  # noqa: F841
    check(pdist.init_distributed(backend="gloo", timeout=RANK_TIMEOUT), "no process group")
    mesh = shard.make_mesh()
    dev = mesh.device
    check(mesh.size == 2 and dev.type == "cuda", f"rank {rank}: mesh {mesh}")
    side, so = SCALE_OUT["side"], SCALE_OUT
    cornell = build_scene(obj_io.load_scene(cornell_dir, "box.obj"), dev)
    box = build_scene(obj_io.load_scene(box_dir, "box.obj"), dev)
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    out, record = {}, {"rank": rank, "seconds": {}, "launches": {}}

    def timed(name, fn):
        tracing.reset("launch.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        record["seconds"][name] = time.perf_counter() - t0
        record["launches"][name] = tracing.launches()
        return res

    with torch.no_grad():
        out["image"] = timed("render", lambda: shard.render_image_distributed(
            cornell, cam, side, side, mesh, sample_size=so["spp"], level=so["level"],
            hittable_pdf_weight=MAIN["weight"],
            generator=torch.Generator(device=dev).manual_seed(so["seed"]))).cpu().numpy()
        photons = timed("photon_pass", lambda: sppm_shard.photon_pass_distributed(
            box, so["photons"], mesh, max_bounce=so["max_bounce"],
            generator=sppm.pass_generator(so["seed"], 1000, dev)))
    out.update({f"photons_{k}": getattr(photons, k).cpu().numpy() for k in ("pos", "valid")})

    def diff_step():
        ke = box.materials.ke.detach().clone().requires_grad_(True)
        img = sppm.render_sppm_differentiable(
            optim._substitute(box, {"ke": ke}), Camera.create(
                **CORNELL_CAM, width=DIFF_SPPM["side"], height=DIFF_SPPM["side"], device=dev),
            **diff_sppm_kw(), seed=DIFF_SPPM["seed"],
            photon_pass_fn=functools.partial(sppm_shard.photon_pass_distributed, mesh=mesh),
            pixel_sharding=mesh)
        loss = img.mean()
        (grad,) = torch.autograd.grad(loss, ke)
        return loss.detach(), mesh.all_reduce(grad)

    loss, grad = timed("diff_sppm_step", diff_step)
    out["diff_loss"], out["diff_grad"] = loss.cpu().numpy(), grad.cpu().numpy()
    tside = so["train_side"]
    loss, new = timed("train_step", lambda: shard.train_step_distributed(
        cornell, Camera.create(**CORNELL_CAM, width=tside, height=tside, device=dev),
        {"ke": cornell.materials.ke * 0.9}, torch.full((tside, tside, 3), 0.3, device=dev),
        torch.Generator(device=dev).manual_seed(11), mesh, width=tside, height=tside,
        sample_size=so["spp"], level=so["level"], hittable_pdf_weight=MAIN["weight"]))
    out["train_loss"], out["train_ke"] = loss.cpu().numpy(), new["ke"].cpu().numpy()
    record["collectives"] = tracing.counts("collective.")
    if rank == 0:
        np.savez(pathlib.Path(out_dir) / "results.npz", **out)
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()
    return 0


def diff_sppm_kw() -> dict:
    """`render_sppm_differentiable`'s sizes for the bench's leg (`DIFF_SPPM`)."""
    side = DIFF_SPPM["side"]
    return dict(width=side, height=side, n_photons=DIFF_SPPM["photons"],
                num_pass=DIFF_SPPM["passes"], max_bounce=DIFF_SPPM["max_bounce"],
                eye_bounce=DIFF_SPPM["eye_bounce"])


def scale_out(dev, card: str, folder, master, img, sppm_folder, scfg) -> dict:
    """Phase 18: the scale-out.  (a) In this process, an NCCL group of one:
    `shard_rays 1` on phase 6's master file (the image must be phase 6's bit
    for bit) and on phase 9's SPPM master file (the image must be
    `render_sppm`'s with the rank streams traced here); (b) two ranks on
    gloo sharing the card (`scale_out_rank`), each result against the same
    computation in this process.  Returns the phase's record."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist
    from gpu_pathtracer_tpu_torch import optim, renderer
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.parallel import dist as pdist
    from gpu_pathtracer_tpu_torch.parallel import launch, shard, sppm_shard
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.render.integrator import render_image_value_and_grad
    from gpu_pathtracer_tpu_torch.utils import config

    rec = {}
    # ---- (a) NCCL, world size 1, the main widths
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    store = rendezvous(0, 1, out_dir / "port_world_of_1", RANK_TIMEOUT)  # noqa: F841
    check(pdist.init_distributed(timeout=RANK_TIMEOUT), "phase 18: no process group")
    mesh = shard.make_mesh()
    check(mesh.size == 1 and mesh.group is not None and dist.get_backend() == "nccl",
          f"phase 18: mesh {mesh}, backend {dist.get_backend()}")
    cfg = config.parse_master_file(master)
    cfg.shard_rays = True
    tracing.reset("launch.")
    tracing.reset("collective.")
    t0 = time.perf_counter()
    img_s = renderer.render_from_config(cfg)
    seconds = time.perf_counter() - t0
    rays = MAIN["width"] * MAIN["height"] * MAIN["spp"] * MAIN["level"]
    launches = tracing.launches()
    colls = tracing.counts("collective.")
    same = bool(np.array_equal(img_s, img))
    log(f"scale-out (a), NCCL world of 1: shard_rays 1 on the Cornell main path "
        f"({MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level {MAIN['level']}): "
        f"{seconds:.3f}s end to end, {rays / seconds:.0f} rays/s; launches {launches}; "
        f"collectives {colls}; image bit for bit phase 6's: {same}; card: {card}")
    check(same, "phase 18: the shard_rays image is not phase 6's")
    check(launches["closest_hit"] == 256 and colls.get("all_gather", 0) == 1,
          f"phase 18: {launches['closest_hit']} closest_hit launches, collectives {colls}")
    rec["cornell"] = dict(seconds=seconds, rays_per_s=rays / seconds, launches=launches,
                          collectives=colls)

    scfg_s = config.RenderConfig(**dataclasses.asdict(scfg))
    scfg_s.shard_rays = True
    scfg_s.image_output_path = str(pathlib.Path(sppm_folder) / "sppm_sharded.ppm")
    tracing.reset("launch.")
    tracing.reset("collective.")
    slog = []
    t0 = time.perf_counter()
    simg_s = renderer.render_from_config(scfg_s, pass_log=slog)
    sseconds = time.perf_counter() - t0
    slaunches = tracing.launches()
    scolls = tracing.counts("collective.")
    log_passes("scale-out (a) SPPM", slog, SPPM["photons"])
    scene, camera = renderer.load_scene_from_config(scfg, dev)
    with torch.no_grad():
        simg_ref = sppm.render_sppm(
            scene, camera, scfg, scfg.seed,
            photon_pass_fn=functools.partial(sppm_shard.photon_pass_local, n_shards=1))
    ssame = bool(np.array_equal(simg_s, simg_ref))
    log(f"scale-out (a): shard_rays 1 on the SPPM main path ({SPPM['width']}x{SPPM['height']}, "
        f"{SPPM['photons']} photons x {SPPM['passes']} passes): {sseconds:.3f}s end to end, "
        f"seconds per pass {[round(p['photon_s'] + p['eye_s'] + p['gather_s'], 3) for p in slog]}; "
        f"launches {slaunches}; collectives {scolls}; image bit for bit render_sppm's with the "
        f"rank stream traced locally: {ssame} (image mean {simg_s.mean():.6f}); card: {card}")
    check(ssame, "phase 18: the shard_rays SPPM image is not the local emulation's")
    check(slaunches["anyhit"] > 0 and slaunches["anyhit"] == sum(p["anyhit_launches"] for p in slog)
          and slaunches["closest_hit"] > 0, f"phase 18: SPPM launches {slaunches}")
    rec["sppm"] = dict(seconds=sseconds, pass_seconds=[p["photon_s"] + p["eye_s"] + p["gather_s"]
                                                       for p in slog],
                       launches=slaunches, collectives=scolls)

    # ---- (b) two ranks on gloo sharing the card (`parallel.launch.run_ranks`:
    # each writes its output to a file, gloo on the loopback interface, one
    # time limit from their start)
    ranks_s = max(launch.run_ranks(
        [sys.executable, HERE / "chip_smoke.py", "--scale-out-rank", out_dir, folder,
         sppm_folder], 2, out_dir, RANK_TIMEOUT))
    for r in range(2):
        for line in (out_dir / f"rank{r}.log").read_text().strip().splitlines()[-6:]:
            log(f"rank {r}: {line}")
    got = dict(np.load(out_dir / "results.npz"))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]
    for rk in ranks:
        log(f"scale-out (b), rank {rk['rank']} of 2 (gloo, cuda:0): seconds "
            f"{ {k: round(v, 3) for k, v in rk['seconds'].items()} }; launches {rk['launches']}; "
            f"collectives {rk['collectives']}; card: {card}")
        for part in ("render", "photon_pass", "diff_sppm_step", "train_step"):
            check(rk["launches"][part]["closest_hit"] > 0,
                  f"phase 18: rank {rk['rank']}'s {part} launched no closest_hit")
        check(rk["launches"]["diff_sppm_step"]["anyhit"] > 0,
              f"phase 18: rank {rk['rank']}'s differentiable step launched no anyhit")

    so = SCALE_OUT
    side = so["side"]
    cornell = renderer.load_scene_from_config(config.parse_master_file(master), dev)[0]
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    with torch.no_grad():
        ref_img = shard.render_image_distributed(
            cornell, cam, side, side, mesh, sample_size=so["spp"], level=so["level"],
            hittable_pdf_weight=MAIN["weight"],
            generator=torch.Generator(device=dev).manual_seed(so["seed"])).cpu().numpy()
        ref_ph = sppm_shard.photon_pass_local(
            scene, so["photons"], 2, max_bounce=so["max_bounce"],
            generator=sppm.pass_generator(so["seed"], 1000, dev))
    img_same = bool(np.array_equal(got["image"], ref_img))
    valid = ref_ph.valid.cpu().numpy()
    ph_ok = bool(np.array_equal(got["photons_valid"], valid)) and bool(np.allclose(
        got["photons_pos"][valid], ref_ph.pos.cpu().numpy()[valid], rtol=1e-6, atol=0.0))
    ke = scene.materials.ke.detach().clone().requires_grad_(True)
    dimg = sppm.render_sppm_differentiable(
        optim._substitute(scene, {"ke": ke}), Camera.create(
            **CORNELL_CAM, width=DIFF_SPPM["side"], height=DIFF_SPPM["side"], device=dev),
        **diff_sppm_kw(), seed=DIFF_SPPM["seed"],
        photon_pass_fn=functools.partial(sppm_shard.photon_pass_local, n_shards=2))
    dloss = dimg.mean()
    (dgrad,) = torch.autograd.grad(dloss, ke)
    dloss, dgrad = dloss.detach().cpu().numpy(), dgrad.cpu().numpy()
    loss_rel = float(abs(got["diff_loss"] - dloss) / abs(dloss))
    grad_ok = bool(np.allclose(got["diff_grad"], dgrad, rtol=1e-4, atol=1e-7))
    tside = so["train_side"]
    leaf = (cornell.materials.ke * 0.9).requires_grad_(True)
    target = torch.full((tside, tside, 3), 0.3, device=dev)
    tloss, _, (tgrad,) = render_image_value_and_grad(
        optim._substitute(cornell, {"ke": leaf}),
        Camera.create(**CORNELL_CAM, width=tside, height=tside, device=dev), tside, tside,
        lambda im: torch.mean((im - target) ** 2), [leaf], sample_size=so["spp"],
        level=so["level"], hittable_pdf_weight=MAIN["weight"],
        generator=torch.Generator(device=dev).manual_seed(11))
    tke = torch.clamp(leaf.detach() - 0.05 * tgrad, min=0.0).cpu().numpy()
    train_ok = (bool(np.allclose(got["train_loss"], float(tloss), rtol=1e-5, atol=0.0))
                and bool(np.allclose(got["train_ke"], tke, rtol=1e-5, atol=1e-7)))
    log(f"scale-out (b): two ranks in {ranks_s:.1f}s; {side}x{side} spp {so['spp']} level "
        f"{so['level']} image bit for bit the world-of-1 render's: {img_same}; photon map "
        f"({so['photons']} photons, {int(valid.sum())} deposits) the rank streams': {ph_ok}; "
        f"differentiable SPPM step loss {float(got['diff_loss']):.8e} against "
        f"{float(dloss):.8e} (rel {loss_rel:.2e}), d mean / d ke within rtol 1e-4: {grad_ok} "
        f"(max abs diff {float(np.abs(got['diff_grad'] - dgrad).max()):.3e}); train step "
        f"loss {float(got['train_loss']):.8e} against {float(tloss):.8e}, new ke within rtol "
        f"1e-5: {train_ok}")
    check(img_same, "phase 18: the two-rank image is not the world-of-1 render's")
    check(ph_ok, "phase 18: the two-rank photon map is not the rank streams'")
    check(loss_rel < 1e-5 and grad_ok, "phase 18: the sharded differentiable step is off")
    check(train_ok, "phase 18: the two-rank train step is off the single-process step")
    dist.destroy_process_group()
    rec["two_ranks"] = dict(seconds=ranks_s, ranks=ranks)
    return rec


def mesh_pixels(scene, camera, side: int):
    """The pixels of a side x side frame whose centre ray first meets object
    0 (the mesh; the floor shares its material), as a (side, side) bool
    array.  One closest-hit query, outside any counted run."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import trace

    dev = scene.geom.p.device
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32, device=dev),
                            torch.arange(side, dtype=torch.float32, device=dev), indexing="ij")
    zeros = torch.zeros(side * side, device=dev)
    o, d = camera.generate_rays(ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5, zeros, zeros)
    with torch.no_grad():
        _, slot, _, hit = trace.closest_hit(scene.geom, o, d)
    mesh = hit & (scene.geom.obj_id[torch.clamp(slot, min=0).long()] == 0)
    return mesh.reshape(side, side).cpu().numpy()


def without_bump(host):
    """The host scene as if its MTL had no `map_Bump` line: every bump slot
    the default 1x1 texel (the atlas keeps the bump image, unread)."""
    tex_slot = host.materials.tex_slot.copy()
    tex_slot[:, 4] = 0
    return dataclasses.replace(host, materials=dataclasses.replace(host.materials,
                                                                   tex_slot=tex_slot))


def textured_mesh(dev, card: str, stats: dict, pipe_err: dict) -> dict:
    """Phase 19: BASELINE config 2 with textures at the main widths (see the
    module docstring).  Returns the phase's record."""
    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.ops import texture
    from gpu_pathtracer_tpu_torch.render.integrator import (
        N_UNIFORMS,
        render_image,
        render_image_value_and_grad,
        trace_paths,
    )

    rec = {}
    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_tex_"))
    t0 = time.perf_counter()
    host = textured_mesh_host(folder, MESH_SUBDIV)
    sky = sky_image(TEX["sky_h"], TEX["sky_w"], TEX["sky_band"])
    skw = dict(sky_emission=(1.0, 1.0, 1.0), sky_image=sky)
    scene = build_scene(host, dev, **skw)
    flat = build_scene(without_bump(host), dev, **skw)
    torch.cuda.synchronize()
    atlas = scene.materials.atlas
    log(f"textured mesh: {scene.geom.num_tris} triangles; atlas {atlas.rgb.shape[0]} texels "
        f"(checker {TEX['checker']}x{TEX['checker']}, bump {TEX['bump']}x{TEX['bump']} -bm "
        f"{TEX['bm']}), sky {TEX['sky_h']}x{TEX['sky_w']}; host arrays and both scenes "
        f"{time.perf_counter() - t0:.2f}s")
    check(scene.geom.num_tris == MESH_TRIS, f"the textured mesh has {scene.geom.num_tris} tris")
    w, h, spp, level = MAIN["width"], MAIN["height"], MAIN["spp"], MAIN["level"]
    mcam = Camera.create(**MESH_CAM, width=w, height=h, device=dev)
    kw = dict(width=w, height=h, sample_size=spp, level=level, hittable_pdf_weight=MAIN["weight"])
    expected = -(-w * h // WAVE_RAYS) * spp * level
    rays = w * h * spp * level

    def render(scn, **changes):
        tracing.reset("launch.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_image(scn, mcam, generator=torch.Generator(device=dev).manual_seed(12),
                               **dict(kw, **changes))
        torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0, tracing.launches()

    img, seconds, launches = render(scene)
    log(f"textured mesh main path: {w}x{h} spp {spp} level {level}, map_Kd + map_Bump + sky: "
        f"render {seconds:.3f}s, {rays / seconds:.0f} rays/s; launches {launches} (expected "
        f"{expected} closest_hit_pipe, nee_dense and shade_surface each); card: {card}")
    check(launches["closest_hit_pipe"] == launches["nee_dense"] == launches["shade_surface"]
          == expected and sum(launches.values()) == 3 * expected,
          f"textured mesh: launches {launches}, expected {expected} closest_hit_pipe, "
          f"nee_dense and shade_surface each")
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 1e-3,
          "textured mesh image not finite or black")
    rec.update(seconds=seconds, rays_per_s=rays / seconds, launches=launches)

    on_mesh = mesh_pixels(scene, mcam, w)
    red, blue = img[..., 0][on_mesh], img[..., 2][on_mesh]
    red_share, blue_share = float((red > 2 * blue).mean()), float((blue > 2 * red).mean())
    log(f"checker on the mesh's {int(on_mesh.sum())} pixels: red > 2 blue on {red_share:.3f}, "
        f"blue > 2 red on {blue_share:.3f}")
    check(red_share >= 0.2 and blue_share >= 0.2, "the checker does not show on the mesh")

    flat_img, flat_s, flat_launches = render(flat)
    bump_diff = float(np.abs(img - flat_img).mean())
    log(f"the same render without map_Bump: {flat_s:.3f}s ({rays / flat_s:.0f} rays/s), "
        f"launches {flat_launches}; mean |bumped - flat| {bump_diff:.3e}")
    check(bump_diff > 1e-3, f"the bump map does not change the image ({bump_diff:.3e})")
    rec.update(flat_seconds=flat_s, bump_mean_abs_diff=bump_diff)

    # the CPU plain path on the mesh at subdiv 4 with the same textures and sky
    cpu_side, cpu_spp = TEX_CPU["side"], TEX_CPU["spp"]
    host_cpu = textured_mesh_host(folder / "cpu", TEX_CPU["subdiv"])
    scene_cpu = build_scene(host_cpu, "cpu", **skw)
    cam64 = Camera.create(**MESH_CAM, width=cpu_side, height=cpu_side)
    t0 = time.perf_counter()
    with torch.no_grad():
        img_cpu = render_image(scene_cpu, cam64, generator=torch.Generator().manual_seed(12),
                               **dict(kw, width=cpu_side, height=cpu_side,
                                      sample_size=cpu_spp)).numpy()
    cpu_s = time.perf_counter() - t0
    on_mesh64 = mesh_pixels(scene_cpu, cam64, cpu_side)
    regions = {"image": (img.mean(), img_cpu.mean()),
               "mesh": (img[on_mesh].mean(), img_cpu[on_mesh64].mean())}
    rel = {k: abs(float(a) - float(b)) / float(b) for k, (a, b) in regions.items()}
    channels = {c: (float(img[..., i][on_mesh].mean()), float(img_cpu[..., i][on_mesh64].mean()))
                for i, c in enumerate("rgb")}
    log(f"region means, card against the CPU plain path (subdiv {TEX_CPU['subdiv']}, "
        f"{cpu_side}x{cpu_side} spp {cpu_spp}, {cpu_s:.1f}s): "
        + ", ".join(f"{k} {float(a):.6f} / {float(b):.6f} (rel {rel[k]:.4f})"
                    for k, (a, b) in regions.items())
        + f"; the mesh's channels (printed, not held: {int(on_mesh64.sum())} CPU pixels x "
        f"{cpu_spp} samples) {channels}")
    check(max(rel.values()) < 0.05, f"textured mesh region means off the CPU render: {rel}")
    rec.update(region_rel_diff=rel, mesh_channel_means=channels)

    # the same uniforms card against CPU (phase 5's gate), and the bumped
    # texel gradient's NaN rows, on that mesh
    scene_small = build_scene(host_cpu, dev, **skw)
    cam32 = Camera.create(**MESH_CAM, width=TEX_NAN_SIDE, height=TEX_NAN_SIDE)
    n = TEX_NAN_SIDE
    ii, jj = torch.meshgrid(torch.arange(float(n)), torch.arange(float(n)), indexing="ij")
    o32, d32 = cam32.generate_rays(ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5,
                                   torch.zeros(n * n), torch.zeros(n * n))
    uni = torch.rand((level, N_UNIFORMS, n * n), generator=torch.Generator().manual_seed(3))

    def same_uniforms(scn, lvl, grad):
        rgb = scn.materials.atlas.rgb.clone().requires_grad_(grad)
        d_ = scn.geom.p.device
        with torch.set_grad_enabled(grad):
            col = trace_paths(optim._substitute(scn, {"atlas_rgb": rgb}), o32.to(d_), d32.to(d_),
                              level=lvl, hittable_pdf_weight=MAIN["weight"],
                              uniforms=uni[:lvl].to(d_))
        if not grad:
            return col.cpu(), None
        return col.detach().cpu(), torch.autograd.grad(col.sum(), rgb)[0].cpu()

    col_card, _ = same_uniforms(scene_small, level, False)
    col_cpu, _ = same_uniforms(scene_cpu, level, False)
    match = float(torch.isclose(col_card, col_cpu, rtol=1e-4, atol=1e-5).all(dim=-1).float().mean())
    log(f"textured mesh (subdiv {TEX_CPU['subdiv']}, map_Kd + map_Bump + sky), same uniforms "
        f"{n}x{n} level {level}: {match:.4f} of rays match card vs CPU")
    check(match >= 0.99, f"textured mesh, same uniforms: only {match:.4f} of rays match")
    nan_level = 3
    _, g_card = same_uniforms(scene_small, nan_level, True)
    _, g_cpu = same_uniforms(scene_cpu, nan_level, True)
    nan_card, nan_cpu = torch.isnan(g_card).any(dim=-1), torch.isnan(g_cpu).any(dim=-1)
    log(f"bumped texel gradient, same uniforms {n}x{n} level {nan_level}: NaN on {int(nan_card.sum())} "
        f"rows on the card, {int(nan_cpu.sum())} on the CPU, the same rows: "
        f"{bool(torch.equal(nan_card, nan_cpu))}")
    check(bool(torch.equal(nan_card, nan_cpu)), "the bumped texel gradient's NaN rows differ")
    rec.update(same_uniforms_match=match, nan_rows=int(nan_card.sum()))

    # the gradient leg: the map_Kd-only mesh, the L2 loss against its own
    # forward image, d loss / d atlas_rgb from 0.9 of the texels
    target = torch.as_tensor(flat_img, device=dev)
    rgb0 = flat.materials.atlas.rgb

    def atlas_loss_and_grad(side, cam, tgt, rgb, seed, spp_=TEX_GRAD_SPP):
        leaf = rgb.detach().clone().requires_grad_(True)
        loss, _, (grad,) = render_image_value_and_grad(
            optim._substitute(flat, {"atlas_rgb": leaf}), cam, side, side,
            lambda im: torch.mean((im - tgt) ** 2), [leaf], sample_size=spp_, level=level,
            hittable_pdf_weight=MAIN["weight"],
            generator=torch.Generator(device=dev).manual_seed(seed))
        return float(loss), grad

    tracing.reset("launch.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grad = atlas_loss_and_grad(w, mcam, target, rgb0 * 0.9, 2)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    glaunches = tracing.launches()
    grad_rays = w * h * TEX_GRAD_SPP * level
    touched = int((grad[1:].abs().sum(dim=-1) > 0).sum())
    log(f"textured mesh gradient: {w}x{h} spp {TEX_GRAD_SPP} level {level}, L2 loss {loss:.6e} to "
        f"atlas_rgb ({rgb0.shape[0]} texels, {touched} with a gradient) by path replay: "
        f"{grad_s:.3f}s, {grad_rays / grad_s:.0f} grad-rays/s, peak memory {peak_gb:.3f} GB; "
        f"launches {glaunches}; card: {card}")
    # the default texel (row 0, which the untextured channels read) has a NaN
    # gradient on this scene in the reference too (ROADMAP C); every other row is finite
    check(bool(torch.isfinite(grad[1:]).all()) and touched > 0, "the texel gradient is not finite")
    check(glaunches["closest_hit_pipe"] == 2 * expected * TEX_GRAD_SPP // spp
          and sum(glaunches.values()) == glaunches["closest_hit_pipe"],
          f"textured mesh gradient: launches {glaunches}")
    rec.update(grad_seconds=grad_s, grad_rays_per_s=grad_rays / grad_s, peak_gb=peak_gb,
               grad_launches=glaunches)

    # what the float64 sum of the texel gather's backward costs: one lookup
    # of a wavefront and its backward, float64 against a float32 gather
    slot = torch.full((WAVE_RAYS,), int(flat.materials.tex_slot[1, 0]), dtype=torch.int32,
                      device=dev)
    uv = torch.rand((WAVE_RAYS, 2), generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    gout = torch.rand((WAVE_RAYS, 3), generator=torch.Generator(device=dev).manual_seed(10),
                      device=dev)
    leaf = rgb0.detach().clone().requires_grad_(True)
    tex64 = texture.Atlas(leaf, atlas.offsets, atlas.heights, atlas.widths)
    idx = texture.texel_index(tex64, slot, uv)
    ms64 = cuda_ms(lambda: torch.autograd.grad(texture.lookup(tex64, slot, uv), leaf, gout), 20)
    ms32 = cuda_ms(lambda: torch.autograd.grad(leaf[idx], leaf, gout), 20)
    log(f"texel gather + backward, {WAVE_RAYS} lookups into {rgb0.shape[0]} texels: float64 sum "
        f"{ms64:.4f} ms, float32 {ms32:.4f} ms (CUDA events, 20 each); card: {card}")
    rec.update(gather_backward_ms_f64=ms64, gather_backward_ms_f32=ms32)

    # 64x64: against a central difference along one checker cell's texels
    side = 64
    cam64c = Camera.create(**MESH_CAM, width=side, height=side, device=dev)
    with torch.no_grad():
        tgt64 = render_image(flat, cam64c, generator=torch.Generator(device=dev).manual_seed(4),
                             **dict(kw, width=side, height=side, sample_size=TEX_GRAD_SPP))
    start = rgb0 * 0.9
    _, g64 = atlas_loss_and_grad(side, cam64c, tgt64, start, 5)
    k = int(flat.materials.tex_slot[1, 0])
    off, cw = int(atlas.offsets[k]), TEX["checker"]
    cell = cw // 8
    texel = torch.arange(cw * cw, device=dev)
    cell_of = (texel // cw // cell) * 8 + (texel % cw) // cell
    per_cell = torch.zeros(64, device=dev).index_add_(0, cell_of, g64[off:off + cw * cw].abs().sum(-1))
    best = int(torch.argmax(per_cell))
    rows = off + texel[cell_of == best]
    chan = int(torch.argmax(g64[rows].abs().sum(0)))
    an = float(g64[rows, chan].sum())
    eps = 0.05 * float(start[rows, chan].mean())
    side_losses = []
    for sign in (1.0, -1.0):
        rgb = start.clone()
        rgb[rows, chan] += sign * eps
        side_losses.append(atlas_loss_and_grad(side, cam64c, tgt64, rgb, 5)[0])
    fd = (side_losses[0] - side_losses[1]) / (2 * eps)
    log(f"texel gradient 64x64 along checker cell {best}'s {rows.numel()} texels, channel {chan}: "
        f"{an:.6e} by autograd, {fd:.6e} by central difference")
    check(abs(an - fd) < 0.05 * max(abs(fd), abs(an), 1e-12), f"texel gradient {an} vs {fd}")
    rec.update(grad_autograd=an, grad_central_difference=fd)

    # from 0.4 of the texels, the loss on the target's own paths (its zero at
    # the truth, as `tests/test_optim.py`'s texel recovery); the steps hold the
    # default texel, whose gradient is the reference's NaN
    dim = optim._substitute(flat, {"atlas_rgb": rgb0 * 0.4})
    base = optim.render_loss_fn(dim, cam64c, tgt64, side, side, sample_size=TEX_GRAD_SPP,
                                level=level, hittable_pdf_weight=MAIN["weight"])

    def images_only(params, _generator):
        loss, grads = base(params, torch.Generator(device=dev).manual_seed(4))
        grads["atlas_rgb"][0] = 0.0
        return loss, grads

    params, losses = optim.optimize(dim, cam64c, tgt64, param_names=("atlas_rgb",), steps=3,
                                    lr=0.1, loss_fn=images_only)
    log(f"optimize atlas_rgb, 3 steps at 64x64 from 0.4 of the texels (the default texel "
        f"held): losses {losses}")
    check(bool(np.isfinite(losses).all()) and len(losses) == 3 and losses[-1] < losses[0],
          f"optimize atlas_rgb: losses {losses}")
    check(bool((params["atlas_rgb"] >= 0).all()) and bool(torch.isfinite(params["atlas_rgb"]).all()),
          "optimize left a negative or non-finite texel")
    rec["optimize_losses"] = [float(x) for x in losses]

    # B2 against its plain version on a recorded textured wavefront (phase 4's check)
    waves = wavefronts(scene, mcam, WAVE_RAYS, 3, seed=3)
    b2 = {}
    compare_pipe("textured mesh bounce 2", sorted_rays(scene.geom, waves[2]), scene.geom.tiles,
                 scene.geom.tile_aabb, pipe_err, b2, time_it=True)
    rec["closest_hit_pipe"] = b2
    return rec


def glass_dof(dev, card: str, stats: dict) -> dict:
    """Phase 20: the bench's glass + depth-of-field leg (see the module
    docstring).  Returns the phase's record."""
    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch import renderer
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.utils import config, testscenes

    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_glass_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2, glass_priority=True)
    lens = dict(aperture=GLASS["aperture"], focus_dist=GLASS["focus_dist"])
    cfg = path_tracing_master(folder, "box.obj", config, pathtracing_sample_size=GLASS["spp"],
                              dof_sample_size=GLASS["dof"], **lens)
    w, h, level = MAIN["width"], MAIN["height"], MAIN["level"]
    check(cfg.dof_sample_size == GLASS["dof"], f"dof_sample_size {cfg.dof_sample_size}")
    tracing.reset("launch.")
    t0 = time.perf_counter()
    img = renderer.render_from_config(cfg)
    seconds = time.perf_counter() - t0
    launches = tracing.launches()
    expected = -(-w * h // WAVE_RAYS) * GLASS["spp"] * GLASS["dof"] * level
    rays = w * h * GLASS["spp"] * GLASS["dof"] * level
    log(f"glass + DoF main path: {w}x{h}, sample_size {GLASS['spp']} x dof_sample_size "
        f"{GLASS['dof']}, level {level}, aperture {GLASS['aperture']}, focus {GLASS['focus_dist']}: "
        f"{seconds:.3f}s end to end, rays_per_sec_fwd_glass_dof {rays / seconds:.1f}; launches "
        f"{launches} (expected {expected} closest_hit, nee_dense and shade_surface each); "
        f"card: {card}")
    check(launches["closest_hit"] == launches["nee_dense"] == launches["shade_surface"]
          == expected and sum(launches.values()) == 3 * expected,
          f"glass + DoF: launches {launches}, expected {expected} closest_hit, nee_dense and "
          "shade_surface each")
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0,
          "glass + DoF image not finite or black")
    rec = dict(seconds=seconds, rays_per_sec_fwd_glass_dof=rays / seconds, launches=launches)

    cpu_spp = 8
    cfg64 = path_tracing_master(folder, "box.obj", config, pathtracing_sample_size=cpu_spp,
                                dof_sample_size=GLASS["dof"], image_width=REF_SIDE,
                                image_height=REF_SIDE, **lens)
    t0 = time.perf_counter()
    img_cpu = renderer.render_from_config(cfg64, device="cpu")
    cpu_s = time.perf_counter() - t0
    # the camera samples pixel centres (it jitters the lens, not the pixel), so
    # the mean of a frame depends on its size: the card's 64x64 render is the one
    # held to the CPU's, the main path's is printed beside them
    img64 = renderer.render_from_config(cfg64)
    ref = float(img_cpu.mean())
    rel, rel_main = (abs(float(x.mean()) - ref) / ref for x in (img64, img))
    log(f"glass + DoF image mean: CPU plain path {REF_SIDE}x{REF_SIDE} sample_size {cpu_spp} x "
        f"dof {GLASS['dof']} {ref:.6f} ({cpu_s:.1f}s), card at that size {img64.mean():.6f} (rel "
        f"diff {rel:.4f}), card main path {img.mean():.6f} (rel diff {rel_main:.4f})")
    check(rel < 0.05, f"glass + DoF 64x64 image mean off the CPU render by {rel:.4f}")

    # test_depth_of_field_blurs_out_of_focus's measure: the red channel's
    # spread over the central crop, against the pinhole render of as many samples
    pin = path_tracing_master(folder, "box.obj", config,
                              pathtracing_sample_size=GLASS["spp"] * GLASS["dof"])
    t0 = time.perf_counter()
    img_pin = renderer.render_from_config(pin)
    pin_s = time.perf_counter() - t0

    def contrast(im):
        return float(im[h // 4:3 * h // 4, w // 4:3 * w // 4, 0].std())

    c_lens, c_pin = contrast(img), contrast(img_pin)
    log(f"central crop red std: thin lens {c_lens:.6f}, pinhole {c_pin:.6f} (ratio "
        f"{c_lens / c_pin:.4f}; pinhole render {pin_s:.3f}s)")
    check(c_lens < c_pin, "the thin lens does not blur the out-of-focus back of the box")
    rec.update(image_rel_diff=rel, main_image_rel_diff=rel_main, contrast_lens=c_lens,
               contrast_pinhole=c_pin)

    # B1 against its plain version on the fullest recorded wavefront (phase 3's check)
    scene, camera = renderer.load_scene_from_config(cfg, dev)
    waves = wavefronts(scene, camera, WAVE_RAYS, 4, seed=1)
    fullest = max(range(len(waves)), key=lambda i: int(waves[i][2].sum()))
    b1 = compare_plain_load(f"glass + DoF bounce {fullest}", sorted_rays(scene.geom, waves[fullest]),
                            scene.geom.tiles, scene.geom.tile_aabb, stats, time_it=True)
    b1["bounce"] = fullest
    rec["closest_hit"] = b1
    return rec


def sync(dev) -> float:
    """The clock after the device's queue has drained."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def rel_norm(a, b) -> float:
    """|a - b| / |b| over the entries where both are finite, in float64."""
    import torch

    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a[ok].double() - b[ok].double()).norm() / b[ok].double().norm())


def grad_kd_ks(dev, card: str) -> dict:
    """Phase 21.1: the gradient to the diffuse and specular tables (`kd`,
    `ks`) on phase 8's Cornell by path replay, against a central difference,
    against the CPU on the same uniforms (with the NaN rows of `n_s`), and
    three `optimize` steps.  Returns the sub-phase's record."""
    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.ops import linalg
    from gpu_pathtracer_tpu_torch.render.integrator import (
        N_UNIFORMS,
        render_image,
        render_image_value_and_grad,
        trace_paths,
    )
    from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

    cg = CARD_GRAD
    side, spp, level = cg["side"], cg["spp"], MAIN["level"]
    kw = dict(sample_size=spp, level=level, hittable_pdf_weight=MAIN["weight"])
    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_kd_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
    host = obj_io.load_scene(folder, "box.obj")
    scene = build_scene(host, dev)
    mats = scene.materials
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    with torch.no_grad():
        target = render_image(scene, cam, side, side, generator=torch.Generator(device=dev).manual_seed(31),
                              **dict(kw, sample_size=cg["target_spp"]))
    kd = (mats.kd * cg["start"]).requires_grad_(True)
    ks = (mats.ks * cg["start"]).requires_grad_(True)

    # autograd by path replay: the main path of the sub-phase
    tracing.reset("launch.")
    t0 = sync(dev)
    loss, _, (g_kd, g_ks) = render_image_value_and_grad(
        optim._substitute(scene, {"kd": kd, "ks": ks}), cam, side, side,
        lambda img: torch.mean((img - target) ** 2), [kd, ks],
        generator=torch.Generator(device=dev).manual_seed(cg["seed"]), **kw)
    grad_s = sync(dev) - t0
    launches = tracing.launches()
    expected = 2 * spp * level  # one chunk a sample, rendered twice (path replay)
    log(f"gradient to kd, ks: Cornell {side}x{side} spp {spp} level {level} from {cg['start']} "
        f"kd, ks: L2 loss {float(loss):.6e} in {grad_s:.3f}s, launches {launches} (expected "
        f"{expected} closest_hit); d loss / d kd {g_kd.flatten().tolist()}, d loss / d ks "
        f"{g_ks.flatten().tolist()}; card: {card}")
    check(launches["closest_hit"] == expected and sum(launches.values()) == expected,
          f"kd/ks gradient: launches {launches}, expected {expected} closest_hit alone")
    check(bool(torch.isfinite(g_kd).all() and torch.isfinite(g_ks).all()),
          "the kd/ks gradient is not finite")
    check(float(g_kd.abs().max()) > 0 and float(g_ks.abs().max()) > 0,
          "the kd/ks gradient is zero")

    # a central difference along a seeded random direction in kd-space (no
    # gradient support where kd == 0), on the same paths; the loss in float64
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(kd.shape)),
                        dtype=torch.float32, device=dev)
    v[mats.kd.amax(dim=-1) <= 0] = 0.0

    def loss_at(kd_v):
        with torch.no_grad():
            img = render_image(optim._substitute(scene, {"kd": kd_v, "ks": ks.detach()}), cam,
                               side, side, generator=torch.Generator(device=dev).manual_seed(cg["seed"]), **kw)
        return float(torch.mean((img.double() - target.double()) ** 2))

    eps = cg["eps"]
    fd = (loss_at(kd.detach() + eps * v) - loss_at(kd.detach() - eps * v)) / (2 * eps)
    an = float((g_kd.double() * v.double()).sum())
    fd_rel = abs(an - fd) / max(abs(fd), abs(an), 1e-3)
    log(f"gradient to kd along a random direction: {an:.6e} by autograd, {fd:.6e} by central "
        f"difference (eps {eps}), rel diff {fd_rel:.2e}")
    check(fd_rel < 0.05, f"kd gradient {an} vs central difference {fd}")

    # the same uniforms, drawn on the CPU, card against CPU: kd, ks and n_s
    # (whose rows of the sphere materials are NaN in both packages)
    r = side * side * spp
    uni = torch.rand((level, N_UNIFORMS, r), generator=torch.Generator().manual_seed(33))
    ii, jj = torch.meshgrid(torch.arange(float(side)), torch.arange(float(side)), indexing="ij")
    o, dd = Camera.create(**CORNELL_CAM, width=side, height=side).generate_rays(
        (ii.reshape(-1) + 0.5).repeat(spp), (jj.reshape(-1) + 0.5).repeat(spp), torch.zeros(r),
        torch.zeros(r))  # spp rays through each pixel centre, sample-major as `render_image`
    names = ("kd", "ks", "n_s")
    grads = {}
    t0 = time.perf_counter()
    for name, d, scn in (("cpu", torch.device("cpu"), build_scene(host, "cpu")),
                         ("card", dev, scene)):
        leaves = {n: optim._get_param(scn.materials, n).detach().clone() for n in names}
        leaves["kd"] *= cg["start"]
        leaves["ks"] *= cg["start"]
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        col = linalg.de_nan(trace_paths(optim._substitute(scn, leaves), o.to(d), dd.to(d),
                                        uniforms=uni.to(d), level=level,
                                        hittable_pdf_weight=MAIN["weight"]))
        img = col.reshape(spp, side, side, 3).mean(dim=0)
        same_loss = torch.mean((img - target.to(d)) ** 2)
        grads[name] = {n: g.cpu() for n, g in zip(names, torch.autograd.grad(
            same_loss, list(leaves.values())))}
    same_s = time.perf_counter() - t0
    rel = {n: rel_norm(grads["card"][n], grads["cpu"][n]) for n in names}
    nan_rows = {n: [torch.isnan(grads[s][n]).reshape(len(grads[s][n]), -1).any(dim=-1)
                    for s in ("card", "cpu")] for n in names}
    log(f"kd/ks gradient, same uniforms {side}x{side} spp {spp} level {level}, card vs CPU "
        f"({same_s:.1f}s): |g card - g CPU| / |g CPU| {rel}; NaN rows card / CPU "
        f"{ {n: [torch.nonzero(m)[:, 0].tolist() for m in v] for n, v in nan_rows.items()} }")
    check(rel["kd"] < GRAD_SAME_TOL and rel["ks"] < GRAD_SAME_TOL,
          f"kd/ks gradient card vs CPU on the same uniforms: {rel}")
    check(all(torch.equal(*v) for v in nan_rows.values()),
          "kd/ks/n_s gradient: the card's NaN rows are not the CPU's")
    check(bool(nan_rows["n_s"][1].any()), "no NaN row of the n_s gradient on the CPU")

    # three optimize steps on fixed paths: the loss function draws its paths
    # from its own seed, so each step's loss is one function of the
    # parameters, and its fall is the gradient's, not the paths' noise
    with torch.no_grad():
        fixed_target = render_image(scene, cam, side, side, generator=torch.Generator(device=dev).manual_seed(7), **kw)
    start = optim._substitute(scene, {"kd": mats.kd * cg["start"], "ks": mats.ks * cg["start"]})
    inner = optim.render_loss_fn(start, cam, fixed_target, side, side, **kw)
    tracing.reset("launch.")
    t0 = sync(dev)
    params, losses = optim.optimize(
        start, cam, fixed_target, param_names=("kd", "ks"), steps=cg["steps"], lr=cg["lr"],
        seed=1, loss_fn=lambda p, generator: inner(p, torch.Generator(device=dev).manual_seed(7)))
    opt_s = sync(dev) - t0
    at_zero = int(sum(int((params[n] == 0).sum()) for n in params))
    log(f"optimize kd, ks on fixed paths, {cg['steps']} steps at {side}x{side} from {cg['start']} "
        f"kd, ks, lr {cg['lr']}: losses {losses} ({opt_s:.1f}s, launches {tracing.launches()}); "
        f"{at_zero} components at the clamp; kd {params['kd'].flatten().tolist()} (true "
        f"{mats.kd.flatten().tolist()})")
    check(len(losses) == cg["steps"] and bool(np.isfinite(losses).all())
          and all(b < a for a, b in zip(losses, losses[1:])), f"optimize kd, ks: losses {losses}")
    check(all(bool(torch.isfinite(p).all() and (p >= 0).all()) for p in params.values()),
          "optimize kd, ks left a negative or non-finite parameter")
    return dict(launches=launches, grad_s=grad_s, fd_rel=fd_rel, same_rel=rel,
                nan_rows_n_s=torch.nonzero(nan_rows["n_s"][0])[:, 0].tolist(), losses=losses)


def fog_diff_sppm(dev, card: str) -> dict:
    """Phase 21.2: phase 17's differentiable SPPM step on the fog box with
    the volume gather, at phase 17's same-uniforms size: its d mean / d ke
    against a central difference, and card against CPU on uniforms drawn on
    the CPU.  Returns the sub-phase's record."""
    import torch
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fogdiff_"))
    sppm_box_master(folder, True, config, testscenes)
    host = obj_io.load_scene(folder, "box.obj")
    scene = build_scene(host, dev)
    check(bool(torch.any(scene.materials.scattering_coef > 0)), "the fog box has no medium")
    side, photons, passes = DIFF_SAME["side"], DIFF_SAME["photons"], DIFF_SPPM["passes"]
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    kw = dict(width=side, height=side, n_photons=photons, num_pass=passes,
              max_bounce=DIFF_SPPM["max_bounce"], eye_bounce=DIFF_SPPM["eye_bounce"],
              gather_grid=True, gather_volume=True)
    ke0, seed = scene.materials.ke, DIFF_SPPM["seed"]
    light = ke0.amax(dim=-1) > 0

    tracing.reset("launch.")
    img, grad, fwd_s, bwd_s = diff_sppm_step(scene, cam, kw, ke0, seed=seed)
    launches = tracing.launches()
    with torch.no_grad():
        no_vol = sppm.render_sppm_differentiable(scene, cam, **dict(kw, gather_volume=False),
                                                 seed=seed)
    vol_share = 1.0 - float(no_vol.double().mean() / img.double().mean())
    log(f"differentiable SPPM on the fog box: {side}x{side}, {photons} photons x {passes} passes, "
        f"grid gathers and the volume gather: forward {fwd_s:.3f}s + backward {bwd_s:.3f}s, "
        f"launches {launches}; image mean {float(img.mean()):.6f} ({vol_share:.4f} of it from the "
        f"volume gather); d mean / d ke on the light's row {grad[light].flatten().tolist()}; "
        f"card: {card}")
    check(launches["closest_hit"] > 0 and launches["anyhit"] > 0
          and launches["closest_hit_pipe"] == launches["closest_hit_mxu"]
          == launches["anyhit_pipe"] == 0,
          f"fog differentiable SPPM: launches {launches}, expected closest_hit and anyhit")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0 and vol_share > 0,
          "fog differentiable SPPM: image not finite, black or without the volume term")
    check(bool(torch.isfinite(grad).all()) and bool((grad[light] != 0).all()),
          "fog differentiable SPPM: gradient not finite or zero on the light's row")

    with torch.no_grad():
        sides = [float(sppm.render_sppm_differentiable(
            optim._substitute(scene, {"ke": ke0 * t}), cam, **kw, seed=seed).double().mean())
            for t in (1.0 + DIFF_EPS, 1.0 - DIFF_EPS)]
    fd = (sides[0] - sides[1]) / (2 * DIFF_EPS)
    an = float((grad * ke0).sum())
    grad_rel = abs(an - fd) / abs(fd)
    log(f"fog differentiable SPPM: d mean / d theta for ke * theta = {an:.6e} by autograd, "
        f"{fd:.6e} by central difference (eps {DIFF_EPS}), rel diff {grad_rel:.2e}")
    check(fd > 0 and grad_rel < 0.01, f"fog differentiable SPPM gradient {an} vs difference {fd}")

    uniforms = diff_sppm_uniforms(19, kw)
    same = {}
    t0 = time.perf_counter()
    for name, d, scn in (("cpu", torch.device("cpu"), build_scene(host, "cpu")),
                         ("card", dev, scene)):
        scam = Camera.create(**CORNELL_CAM, width=side, height=side, device=d)
        simg, sgrad, _, _ = diff_sppm_step(scn, scam, kw, scn.materials.ke, uniforms=uniforms)
        same[name] = (simg.cpu(), sgrad.cpu())
    same_s = time.perf_counter() - t0
    (img_cpu, g_cpu), (img_card, g_card) = same["cpu"], same["card"]
    pixel_share = float(torch.isclose(img_card, img_cpu, rtol=1e-4, atol=1e-6).all(dim=-1)
                        .float().mean())
    same_rel = float((g_card - g_cpu).norm() / g_cpu.norm())
    log(f"fog differentiable SPPM, same uniforms: {pixel_share:.4f} of the pixels agree card vs "
        f"CPU (rtol 1e-4, atol 1e-6), image means {float(img_card.mean()):.6f} / "
        f"{float(img_cpu.mean()):.6f}; |grad card - grad CPU| / |grad CPU| = {same_rel:.2e} "
        f"({same_s:.1f}s)")
    check(pixel_share >= 0.99, f"fog differentiable SPPM same uniforms: {pixel_share:.4f} of pixels")
    check(same_rel < 0.01, f"fog differentiable SPPM same uniforms: gradients {same_rel:.2e}")
    return dict(launches=launches, fwd_s=fwd_s, bwd_s=bwd_s, volume_share=vol_share,
                grad_rel=grad_rel, same_pixels=pixel_share, same_grad_rel=same_rel)


def louvre_x(k: int, sheets: int) -> float:
    """The plane x of sheet k of `louvre_panel`."""
    return round(0.2 + 0.6 * k / (sheets - 1), 6)


def louvre_boundaries(o, d, lv: dict):
    """For rays (o, d) (float64) against the sheets of `louvre_panel`:
    whether each starts on a sheet's plane, and whether it crosses a sheet
    ahead of it on the edge of a quad (both within BOUNDARY_TOL)."""
    import torch

    xs = torch.tensor([louvre_x(k, lv["sheets"]) for k in range(lv["sheets"])],
                      dtype=torch.float64)
    y_edges = 0.55 + 0.4 * torch.arange(lv["ny"] + 1, dtype=torch.float64) / lv["ny"]
    z_edges = 0.1 + 0.8 * torch.arange(lv["nz"] + 1, dtype=torch.float64) / lv["nz"]
    gap = xs[None, :] - o[:, :1]
    plane = (gap.abs() < BOUNDARY_TOL).any(dim=-1)
    t = gap / d[:, :1]
    y, z = o[:, 1:2] + t * d[:, 1:2], o[:, 2:3] + t * d[:, 2:3]
    tol = BOUNDARY_TOL
    inside = (t > 0) & (y > 0.55 - tol) & (y < 0.95 + tol) & (z > 0.1 - tol) & (z < 0.9 + tol)
    near = (((y[..., None] - y_edges).abs().amin(dim=-1) < tol)
            | ((z[..., None] - z_edges).abs().amin(dim=-1) < tol))
    return plane, (inside & near).any(dim=-1)


def louvre_panel(folder, sheets: int, nz: int, ny: int) -> str:
    """The many-lights box with its 2,048 emitters hung as louvres: `sheets`
    parallel emitter sheets (planes x = const over the upper half of the
    box), each `nz` x `ny` quads of `make_emitter_panel`'s LED material.  A
    ray along x stabs one quad (two leaf boxes) per sheet it crosses.  Writes
    louvres.obj / .mtl; returns the OBJ's name."""
    folder = pathlib.Path(folder)
    mtl = ["newmtl white", "Kd 0.73 0.73 0.73", "Ks 0 0 0", "d 1.0", "Ns 1",
           "newmtl led", "Kd 0 0 0", "Ke 15 15 15", "d 1.0", "Ns 1"]
    obj, verts = ["mtllib louvres.mtl"], []

    def quad(*corners):
        for p in corners:
            obj.append("v {} {} {}".format(*p))
        n = len(verts) + 1
        verts.extend(corners)
        obj.extend([f"f {n} {n + 1} {n + 2}", f"f {n} {n + 2} {n + 3}"])

    obj.append("usemtl white")
    quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0))
    quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
    obj.append("usemtl led")
    for k in range(sheets):
        x = louvre_x(k, sheets)
        for a in range(nz):
            for b in range(ny):
                z0, z1 = 0.1 + 0.8 * a / nz, 0.1 + 0.8 * (a + 1) / nz
                y0, y1 = 0.55 + 0.4 * b / ny, 0.55 + 0.4 * (b + 1) / ny
                quad((x, y0, z0), (x, y1, z0), (x, y1, z1), (x, y0, z1))  # normal -x
    (folder / "louvres.mtl").write_text("\n".join(mtl) + "\n")
    (folder / "louvres.obj").write_text("\n".join(obj) + "\n")
    return "louvres.obj"


def mis_overflow(dev, card: str) -> dict:
    """Phase 21.3: a `MAX_POTENTIAL_TARGETS` overflow at the default cap on
    the card.  The panel of phase 15 cannot overflow (its emitters lie in one
    plane, so a ray stabs at most one LED's two leaf boxes: shown on grazing
    rays on the CPU); its 2,048 emitters hung as louvres can.  Rays from
    below the louvres to the left wall under them, whose mixture-pdf rays
    then run along x through the sheets, on the same uniforms and pick
    uniforms on card and CPU.  Returns the sub-phase's record."""
    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch.constants import MAX_POTENTIAL_TARGETS
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
    from gpu_pathtracer_tpu_torch.ops import trace
    from gpu_pathtracer_tpu_torch.render.integrator import N_UNIFORMS, trace_paths
    from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

    lv = LOUVRE
    rng = np.random.default_rng(23)
    n = lv["rays"]

    def unit(v):
        return torch.as_tensor(v / np.linalg.norm(v, axis=-1, keepdims=True), dtype=torch.float32)

    panel_folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_grazing_"))
    testscenes.make_emitter_panel(panel_folder, nx=PANEL["nx"], ny=PANEL["ny"])
    panel = build_scene(obj_io.load_scene(panel_folder, "panel.obj"), "cpu")
    graze_o = torch.as_tensor(np.stack([np.full(n, 0.001), 0.999 - 10.0 ** rng.uniform(-9, -2, n),
                                        rng.uniform(0.1, 0.9, n)], -1), dtype=torch.float32)
    graze_d = unit(np.stack([np.ones(n), rng.uniform(-1e-3, 1e-3, n), rng.uniform(-0.3, 0.3, n)], -1))
    _, stabbed, _ = lights_mod.collect_hit_leaves(panel.light_tree, graze_o, graze_d,
                                                  max_k=PANEL["emitters"])
    panel_most = int(stabbed.sum(dim=-1).max())

    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_louvres_"))
    host = obj_io.load_scene(folder, louvre_panel(folder, lv["sheets"], lv["nz"], lv["ny"]))
    scenes = {"cpu": build_scene(host, "cpu"), "card": build_scene(host, dev)}
    lt = scenes["card"].light_tree
    check(scenes["card"].num_lights == PANEL["emitters"] and not lt.dense,
          f"the louvres have {scenes['card'].num_lights} emitters, dense {lt.dense}")
    z = rng.uniform(0.15, 0.85, n)
    origin = np.stack([np.full(n, 0.1), np.full(n, 0.05), z], -1)
    wall = np.stack([np.zeros(n), rng.uniform(0.6, 0.9, n), z + rng.uniform(-0.05, 0.05, n)], -1)
    o, d = torch.as_tensor(origin, dtype=torch.float32), unit(wall - origin)
    gen = torch.Generator().manual_seed(29)
    uni = torch.rand((lv["level"], N_UNIFORMS, n), generator=gen)
    picks = torch.rand((lv["level"], lights_mod.descent_steps(lt), n), generator=gen)
    inner, inner_hit = lights_mod.hittable_pdf_sum_sparse, trace.closest_hit

    def run(name, dv, level):
        """(radiance, total dropped, seconds, launches, host syncs, [(origin,
        direction, dropped, counted) of each mixture-pdf sum]): a sum counts
        where its bounce's closest hit found a surface for a live ray (the
        louvres have no dielectric, so no false hit)."""
        calls, hits = [], []

        def recording(*args, **kwargs):
            out = inner(*args, **kwargs)
            calls.append((args[1].cpu(), args[2].cpu(), out[1].cpu(), hits[-1]))
            return out

        def recording_hit(*args, live=None, **kwargs):
            out = inner_hit(*args, live=live, **kwargs)
            hits.append((out[3] & live).cpu())
            return out

        lights_mod.hittable_pdf_sum_sparse = recording
        trace.closest_hit = recording_hit
        tracing.reset("launch.")
        tracing.reset("loop_exit")
        try:
            t0 = sync(dv)
            with torch.no_grad():
                col, stats = trace_paths(scenes[name], o.to(dv), d.to(dv), level=level,
                                         hittable_pdf_weight=MAIN["weight"],
                                         uniforms=uni[:level].to(dv),
                                         pick_uniforms=picks[:level].to(dv), return_stats=True)
            seconds = sync(dv) - t0
        finally:
            lights_mod.hittable_pdf_sum_sparse, trace.closest_hit = inner, inner_hit
        return (col.cpu(), int(stats["mis_targets_dropped"]), seconds, tracing.launches(),
                tracing.totals["loop_exit"], calls)

    def agree(a, b):
        return float(torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1).float().mean())

    # the first bounce: every mixture-pdf ray starts on the wall, off the emitters
    first = {name: run(name, dv, 1) for name, dv in (("cpu", torch.device("cpu")), ("card", dev))}
    drop1_cpu, drop1_card = first["cpu"][1], first["card"][1]
    share1 = agree(first["card"][0], first["cpu"][0])
    launches = first["card"][3]
    log(f"MIS target cap {MAX_POTENTIAL_TARGETS}: the panel's grazing rays stab at most "
        f"{panel_most} emitter leaves; the louvres ({lv['sheets']} sheets of {lv['nz']}x{lv['ny']} "
        f"quads), {n} rays to the wall under them, level 1: mis_targets_dropped {drop1_card} on the "
        f"card, {drop1_cpu} on the CPU; {share1:.4f} of the rays agree (rtol 1e-4, atol 1e-5); "
        f"card {first['card'][2]:.3f}s ({launches}, {first['card'][4]} host syncs); card: {card}")
    check(drop1_cpu > 0, "the louvres' rays dropped no MIS target on the CPU")
    check(drop1_card == drop1_cpu,
          f"mis_targets_dropped {drop1_card} on the card, {drop1_cpu} on the CPU")
    check(share1 >= 0.99, f"MIS overflow, same uniforms: {share1:.4f} of the rays agree")
    check(launches["closest_hit"] == launches["shade_surface"] == 1
          and sum(launches.values()) == 2,
          f"MIS overflow: launches {launches}, expected 1 closest_hit and 1 shade_surface")

    # all bounces: a stab turns on the last ulp of a ray that meets a leaf
    # box's boundary: a ray that starts on a sheet (a hit on an emitter) stabs
    # that sheet's leaf when its origin lies before the sheet's plane, not on
    # or after it, and one that crosses a sheet on the edge two quads share
    # stabs both.  From such a ray on, the two sides' counts may part, and so
    # may the path (a ray leaving a sheet's plane may meet the sheet again)
    full = {name: run(name, dv, lv["level"]) for name, dv in (("cpu", torch.device("cpu")),
                                                              ("card", dev))}
    share = agree(full["card"][0], full["cpu"][0])
    met = torch.zeros(n, dtype=torch.bool)  # the ray has met a boundary by this bounce
    parted, on_plane, on_edge, unexplained, counted_diff = [], 0, 0, 0, 0
    for b, ((o_cpu, d_cpu, k_cpu, c_cpu), (o_card, d_card, k_card, c_card)) in enumerate(
            zip(full["cpu"][5], full["card"][5])):
        plane, edge = louvre_boundaries(o_cpu.double(), d_cpu.double(), lv)
        met |= c_cpu & (plane | edge)
        rows = torch.nonzero((c_cpu != c_card) | (c_cpu & (k_cpu != k_card)))[:, 0]
        counted_diff += int(k_card[c_card].sum()) - int(k_cpu[c_cpu].sum())
        parted.append(int(rows.numel()))
        on_plane += int((plane[rows] & c_cpu[rows]).sum())
        on_edge += int((edge[rows] & ~plane[rows] & c_cpu[rows]).sum())
        for row in rows[~met[rows]].tolist():
            unexplained += 1
            log(f"MIS overflow: bounce {b}, ray {row} parts having met no boundary: origin "
                f"{o_cpu[row].tolist()} / {o_card[row].tolist()}, direction {d_cpu[row].tolist()} "
                f"/ {d_card[row].tolist()}, dropped {int(k_cpu[row])} / {int(k_card[row])}, live "
                f"hit {bool(c_cpu[row])} / {bool(c_card[row])} (CPU / card)")
    log(f"MIS overflow, level {lv['level']}: mis_targets_dropped {full['card'][1]} on the card, "
        f"{full['cpu'][1]} on the CPU ({full['card'][3]}, {full['card'][4]} host syncs, "
        f"{full['card'][2]:.3f}s); rays whose count or path parts, by bounce: {parted}, of them "
        f"{on_plane} starting on a sheet's plane and {on_edge} crossing a sheet within "
        f"{BOUNDARY_TOL} of a quad's edge at that bounce, {unexplained} meeting no boundary "
        f"before; {share:.4f} of the rays agree")
    check(len(full["card"][5]) == len(full["cpu"][5]) == lv["level"],
          "MIS overflow: a mixture-pdf sum per bounce expected")
    check(counted_diff == full["card"][1] - full["cpu"][1],
          f"MIS overflow: the parted rays account for {counted_diff} of the totals' difference")
    check(unexplained == 0, f"MIS overflow: {unexplained} rays part having met no leaf box's "
          "boundary")
    check(share >= 0.99, f"MIS overflow, level {lv['level']}: {share:.4f} of the rays agree")
    return dict(launches=launches, dropped=drop1_card, dropped_cpu=drop1_cpu, rays_agree=share1,
                panel_most_stabbed=panel_most, card_s=first["card"][2],
                level3=dict(dropped=full["card"][1], dropped_cpu=full["cpu"][1], parted=parted,
                            parted_on_plane=on_plane, parted_on_edge=on_edge, rays_agree=share,
                            launches=full["card"][3]))


def checkpoint_resume(dev, card: str) -> dict:
    """Phase 21.4: `optimize` stopped after 2 steps and resumed to 4, and
    `render_sppm` stopped after 1 pass and resumed to 2, on the card, each
    against the uninterrupted run bit for bit.  Returns the sub-phase's
    record."""
    import numpy as np
    import torch
    from gpu_pathtracer_tpu_torch import optim, renderer
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.render.integrator import render_image
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    cg = CARD_GRAD
    side = cg["side"]
    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
    scene = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
    cam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
    kw = dict(sample_size=cg["spp"], level=MAIN["level"], hittable_pdf_weight=MAIN["weight"])
    with torch.no_grad():
        target = render_image(scene, cam, side, side, generator=torch.Generator(device=dev).manual_seed(31), **kw)
    start = optim._substitute(scene, {"kd": scene.materials.kd * cg["start"],
                                      "ks": scene.materials.ks * cg["start"]})
    okw = dict(param_names=("kd", "ks"), lr=cg["lr"], seed=3, **kw)
    tracing.reset("launch.")
    t0 = sync(dev)
    whole, whole_losses = optim.optimize(start, cam, target, steps=4, **okw)
    ckpt = folder / "optimize"
    _, first = optim.optimize(start, cam, target, steps=2, checkpoint_dir=str(ckpt), **okw)
    saved = sorted(p.name for p in ckpt.iterdir())
    state = torch.load(ckpt / "step_1.pt", map_location=dev, weights_only=True)
    held = list(state["params"].values()) + [
        v for s in state["opt_state"]["state"].values() for v in s.values() if v.dim()]
    resumed, rest = optim.optimize(start, cam, target, steps=4, checkpoint_dir=str(ckpt), **okw)
    opt_s = sync(dev) - t0
    opt_launches = tracing.launches()
    opt_equal = (first + rest == whole_losses
                 and all(torch.equal(resumed[k], whole[k]) for k in whole))
    diffs = {k: float((resumed[k] - whole[k]).abs().max()) for k in whole}
    log(f"optimize checkpoint: 2 steps saved {saved}, resumed to 4: losses {first} + {rest}, "
        f"uninterrupted {whole_losses}; parameters' largest difference {diffs}; equal bit for bit: "
        f"{opt_equal}; the checkpoint's {len(held)} tensors loaded on "
        f"{sorted({str(t.device) for t in held})} ({opt_s:.1f}s, launches {opt_launches})")
    check(saved == ["step_0.pt", "step_1.pt"], f"optimize checkpoint files {saved}")
    check(all(t.device.type == dev.type for t in held),
          "torch.load(map_location=device) left checkpoint state off the card")
    check(len(rest) == 2, f"the resumed optimize ran {len(rest)} steps, expected 2")
    check(opt_equal, f"the resumed optimize differs from the uninterrupted one: {diffs}")

    box = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_box_"))
    cfg = sppm_box_master(box, False, config, testscenes, image_width=CKPT["side"],
                          image_height=CKPT["side"], ppm_num_photon_per_pass=CKPT["photons"],
                          ppm_num_pass=2)
    box_scene, box_cam = renderer.load_scene_from_config(cfg, dev)
    one = dataclasses.replace(cfg, ppm_num_pass=1)
    ckpt = box / "sppm"
    tracing.reset("launch.")
    log_whole, log_resumed = [], []
    t0 = sync(dev)
    with torch.no_grad():
        img_whole = sppm.render_sppm(box_scene, box_cam, cfg, cfg.seed, pass_log=log_whole)
        sppm.render_sppm(box_scene, box_cam, one, cfg.seed, checkpoint_dir=str(ckpt),
                         checkpoint_every=1)
        img_resumed = sppm.render_sppm(box_scene, box_cam, cfg, cfg.seed, checkpoint_dir=str(ckpt),
                                       checkpoint_every=1, pass_log=log_resumed)
    sppm_s = sync(dev) - t0
    sppm_launches = tracing.launches()
    sppm_equal = bool(np.array_equal(img_resumed, img_whole))
    log(f"render_sppm checkpoint: {CKPT['side']}x{CKPT['side']}, {CKPT['photons']} photons, 1 pass "
        f"then resumed to 2 (passes run: {[p['it'] for p in log_resumed]}; grid "
        f"{log_whole[0]['grid']}): equal to the uninterrupted render bit for bit: {sppm_equal}, "
        f"largest difference {float(np.abs(img_resumed - img_whole).max()):.3e}, image mean "
        f"{img_whole.mean():.6f} ({sppm_s:.1f}s, launches {sppm_launches}); card: {card}")
    check([p["it"] for p in log_resumed] == [1], "the resumed render_sppm did not run pass 2 alone")
    check(log_whole[0]["grid"] and sppm_launches["anyhit"] > 0,
          "the checkpointed render_sppm did not take the grid gathers on anyhit")
    check(sppm_equal, "the resumed render_sppm differs from the uninterrupted one")
    return dict(optimize_launches=opt_launches, sppm_launches=sppm_launches, optimize_s=opt_s,
                sppm_s=sppm_s, optimize_equal=opt_equal, sppm_equal=sppm_equal)


def cli_on_card(dev, card: str) -> dict:
    """Phase 21.5: `python3 -m gpu_pathtracer_tpu_torch.cli master out.ppm`
    as a child process without `--device`, on phase 6's Cornell and phase
    9's SPPM box at 64x64: it must exit 0 on CUDA, write every file that the
    same command writes with `--device cpu`, and its image must be an
    in-process `render_from_config`'s to the PPM's 8 bits.  Returns the
    sub-phase's record."""
    import os

    from gpu_pathtracer_tpu_torch import renderer
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.utils import config, testscenes
    from gpu_pathtracer_tpu_torch.utils.image import load_ppm, save_ppm

    side = CLI_SIDE
    cornell = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    testscenes.make_cornell_box(cornell, spheres=True, sphere_subdiv=2)
    box = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_box_"))
    configs = {
        1: (cornell, path_tracing_master(cornell, "box.obj", config, image_width=side,
                                         image_height=side)),
        2: (box, sppm_box_master(box, False, config, testscenes, image_width=side,
                                 image_height=side, ppm_num_pass=1)),
    }
    # a user's one-process run: without the job's variables that phase 18's
    # process group leaves in this process's environment
    one_process = {k: v for k, v in os.environ.items() if not k.startswith("GPT_TPU_")}
    rec = {"launches_in_process": {}}
    for mode, (folder, cfg) in configs.items():
        check(cfg.render_mode == mode, f"render_mode {cfg.render_mode}, expected {mode}")
        master = folder / f"cli_master_{mode}.txt"
        config.write_master_file(cfg, master)
        # the files the command writes on the CPU, from a tiny copy of the config
        small = folder / f"cli_small_{mode}.txt"
        config.write_master_file(dataclasses.replace(
            cfg, image_width=8, image_height=8, pathtracing_sample_size=1,
            ppm_num_photon_per_pass=64), small)
        cpu_dir = folder / "cpu"
        cpu_dir.mkdir()
        check(renderer.main([str(small), str(cpu_dir / "out.ppm"), "--device", "cpu"]) == 0,
              f"the CLI on the CPU failed (render_mode {mode})")
        cpu_files = sorted(p.name for p in cpu_dir.iterdir())

        card_dir = folder / "card"
        card_dir.mkdir()
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "gpu_pathtracer_tpu_torch.cli", str(master),
             str(card_dir / "out.ppm")], cwd=HERE, capture_output=True, text=True,
            timeout=CLI_TIMEOUT, env=one_process)
        child_s = time.perf_counter() - t0
        (card_dir / "cli.log").write_text(child.stdout + child.stderr)
        card_files = sorted(p.name for p in card_dir.iterdir() if p.suffix == ".ppm")
        on_cuda = " on cuda" in child.stdout  # the renderer's banner names its device
        log(f"CLI, render_mode {mode}, {side}x{side}: exit code {child.returncode} in "
            f"{child_s:.1f}s, ran on CUDA: {on_cuda}; files {card_files} (with --device cpu: "
            f"{cpu_files}); its log's last lines: {child.stdout.strip().splitlines()[-2:]}")
        check(child.returncode == 0, f"the CLI exited with {child.returncode} (render_mode {mode}): "
              f"{child.stderr[-2000:]}")
        check(on_cuda, f"the CLI's log does not show a CUDA render (render_mode {mode})")
        check(card_files == cpu_files, f"the CLI wrote {card_files} on the card, {cpu_files} on "
              "the CPU")

        tracing.reset("launch.")
        inproc = dataclasses.replace(cfg, image_output_path=str(folder / "inproc" / "out.ppm"))
        pathlib.Path(inproc.image_output_path).parent.mkdir()
        img = renderer.render_from_config(inproc, device=dev)
        rec["launches_in_process"][mode] = tracing.launches()
        save_ppm(img, folder / "inproc.ppm")
        mine, theirs = load_ppm(folder / "inproc.ppm"), load_ppm(card_dir / "out.ppm")
        differ = int((mine != theirs).any(axis=-1).sum())
        log(f"CLI, render_mode {mode}: {differ} of {side * side} pixels differ in 8 bits from an "
            f"in-process render_from_config (launches {rec['launches_in_process'][mode]}); image "
            f"mean {img.mean():.6f}")
        check(differ == 0 and mine.shape == (side, side, 3) and int(mine.max()) > 0,
              f"the CLI's image differs from the in-process render on {differ} pixels "
              f"(render_mode {mode})")
        rec[f"mode_{mode}"] = dict(seconds=child_s, files=card_files)
    return rec


def card_paths(dev, card: str) -> dict:
    """Phase 21: the paths that no earlier phase runs on the card, each held
    to the port's CPU run; logs each sub-phase's seconds and launches."""
    rec = {}
    for name, part in (("kd_ks_gradient", grad_kd_ks), ("fog_diff_sppm", fog_diff_sppm),
                       ("mis_overflow", mis_overflow), ("checkpoint_resume", checkpoint_resume),
                       ("cli", cli_on_card)):
        t0 = time.perf_counter()
        rec[name] = part(dev, card)
        rec[name]["seconds"] = time.perf_counter() - t0
        log(f"phase 21, {name}: {rec[name]['seconds']:.1f}s; card: {card}")
    return rec


def bench_on_card(card: str) -> dict:
    """Phase 22: `python3 bench_torch.py` as a child process at `BENCH_SMALL`'s
    sizes, on the card (no `--device`) and without the job variables of
    phase 18: it must exit 0 and print one line per leg of `BENCH_LEGS` and
    `bench.py`'s final line with `BENCH_DETAIL_KEYS`; each leg's launches in
    its timed calls must be those of its path.  Returns the child's seconds
    and each leg's median, peak memory and launches summed over its timed
    calls."""
    import math
    import os

    import torch

    env = {k: v for k, v in os.environ.items() if not k.startswith(("GPT_TPU_", "BENCH_"))}
    env.update({k: str(v) for k, v in BENCH_SMALL.items()})
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(HERE / "bench_torch.py")], cwd=HERE,
                           capture_output=True, text=True, timeout=BENCH_TIMEOUT, env=env)
    seconds = time.perf_counter() - t0
    out = child.stdout.strip().splitlines()
    log(f"bench_torch.py at {BENCH_SMALL}: exit code {child.returncode} in {seconds:.1f}s; "
        f"its output:")
    for line in out:
        log(f"  {line}")
    check(child.returncode == 0, f"bench_torch.py exited with {child.returncode}: "
          f"{child.stderr[-2000:]}")
    lines = [json.loads(line) for line in out]
    legs, final = lines[:-1], lines[-1]
    check([leg.get("leg") for leg in legs] == list(BENCH_LEGS),
          f"bench_torch.py printed the legs {[leg.get('leg') for leg in legs]}")
    launches = {leg["leg"]: {k: sum(n) for k, n in leg["launches"].items()} for leg in legs}

    small, reps = BENCH_SMALL, BENCH_SMALL["BENCH_REPEATS"]
    chunks = -(-small["BENCH_SIZE"] ** 2 // WAVE_RAYS)
    per_sample = chunks * small["BENCH_LEVEL"] * reps
    only = {  # the launches of each leg that depend on no data: its kernels, a count
        "forward": (("closest_hit", "nee_dense", "shade_surface"), per_sample * small["BENCH_SPP"]),
        "backward": (("closest_hit",), 2 * per_sample * max(1, small["BENCH_SPP"] // 4)),
        "glass_dof": (("closest_hit", "nee_dense", "shade_surface"),
                      per_sample * max(1, small["BENCH_SPP"] // 2) * 2),
        "mesh": (("closest_hit_pipe", "nee_dense", "shade_surface"),
                 per_sample * small["BENCH_SPP"]),
    }
    for leg, (kernels, n) in only.items():
        want = {k: n if k in kernels else 0 for k in launches[leg]}
        check(launches[leg] == want, f"bench leg {leg}: launches {launches[leg]}, expected {want}")
    box_kernels = ("closest_hit", "anyhit")  # the SPPM box: below PALLAS_MAX
    for leg in ("sppm_cornell", "sppm_fog", "diff_sppm"):
        check(all(launches[leg][k] > 0 for k in box_kernels)
              and all(n == 0 for k, n in launches[leg].items() if k not in box_kernels),
              f"bench leg {leg}: launches {launches[leg]}")
    check(launches["photon_pass"]["closest_hit"] > 0 and sum(launches["photon_pass"].values())
          == launches["photon_pass"]["closest_hit"],
          f"bench leg photon_pass: launches {launches['photon_pass']}")

    detail = final.get("detail", {})
    check(final.get("metric") == "rays_per_sec_fwd_512" and final.get("unit") == "rays/s"
          and final.get("vs_baseline", 0) is None and math.isfinite(final.get("value", math.nan))
          and final["value"] > 0, f"bench_torch.py's final line: {final}")
    check(set(detail) == BENCH_DETAIL_KEYS,
          f"the final line's detail keys differ from bench.py's: "
          f"{sorted(set(detail) ^ BENCH_DETAIL_KEYS)}")
    check(detail["backend"] == "cuda" and detail["device"] == torch.cuda.get_device_name(0)
          and detail["power_limit"] == card, f"bench_torch.py ran on {detail['backend']}, "
          f"{detail['device']}, {detail['power_limit']}")
    log(f"phase 22: bench_torch.py's {len(legs)} legs on the card in {seconds:.1f}s, "
        f"launches {launches}; card: {card}")
    return dict(seconds=seconds, launches=launches,
                legs={leg["leg"]: dict(median_s=leg["median_s"], peak_gb=leg["peak_gb"])
                      for leg in legs})


def scaling_on_card(card: str) -> dict:
    """Phase 23: `python3 bench_scaling_torch.py` as a child process at its
    defaults, without the job variables and `BENCH_*` knobs of this process:
    (a) without `--virtual` (one rank a GPU over NCCL), (b) with `--virtual
    SCALING_VIRTUAL` (gloo ranks sharing `cuda:0`).  Each must exit 0 and
    print `bench_scaling.py`'s line with the port's keys, sweep N over the
    sizes of its rank count with every image the one-rank image bit for bit,
    and each member must launch `closest_hit` and `nee_dense` the path's
    count in the timed call and no other kernel.  Returns each child's seconds, line and
    launches."""
    from gpu_pathtracer_tpu_torch.ops import _build
    import os

    import torch

    env = {k: v for k, v in os.environ.items() if not k.startswith(("GPT_TPU_", "BENCH_"))}
    per_member = -(-SCALING["size"] ** 2 // WAVE_RAYS) * SCALING["spp"] * SCALING["level"]
    rec = {}
    for part, flags, backend, world in (
            ("nccl", [], "nccl", torch.cuda.device_count()),
            ("virtual", ["--virtual", str(SCALING_VIRTUAL)], "gloo", SCALING_VIRTUAL)):
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, str(HERE / "bench_scaling_torch.py"), *flags],
                               cwd=HERE, capture_output=True, text=True, timeout=SCALING_TIMEOUT,
                               env=env)
        seconds = time.perf_counter() - t0
        log(f"bench_scaling_torch.py {' '.join(flags)}: exit code {child.returncode} in "
            f"{seconds:.1f}s")
        check(child.returncode == 0, f"bench_scaling_torch.py {' '.join(flags)} exited with "
              f"{child.returncode}:\n{child.stdout[-2000:]}\n{child.stderr[-4000:]}")
        final = json.loads(child.stdout.strip().splitlines()[-1])
        detail = final.get("detail", {})
        sweep = detail.get("sweep", [])
        for e in sweep:
            log(f"  ({part}) N={e['n']}: {e['seconds']} s, {e['rays_per_sec']} rays/s, efficiency "
                f"{e['efficiency']}, bit for bit {e['bit_for_bit']}; members' seconds "
                f"{[round(t, 4) for t in e['member_seconds']]}, peak GB {e['member_peak_gb']}, "
                f"collectives {e['member_collectives']}; card: {card}")
        check(set(final) == SCALING_KEYS and set(detail) == SCALING_DETAIL_KEYS
              and all(set(e) == SCALING_SWEEP_KEYS for e in sweep),
              f"bench_scaling_torch.py's line has the keys {sorted(final)}, detail "
              f"{sorted(detail)}, sweep {[sorted(e) for e in sweep]}")
        check([e["n"] for e in sweep] == [n for n in SCALING_SIZES if n <= world],
              f"bench_scaling_torch.py ({part}) swept {[e['n'] for e in sweep]} on {world} ranks")
        check(all(e["bit_for_bit"] for e in sweep),
              f"bench_scaling_torch.py ({part}): an image is not the one-rank image bit for bit")
        check(detail["backend"] == "cuda" and detail["collective_backend"] == backend
              and detail["virtual_mesh"] == bool(flags)
              and (detail["size"], detail["spp"], detail["level"]) == tuple(SCALING.values()),
              f"bench_scaling_torch.py ({part}): {detail['backend']}, "
              f"{detail['collective_backend']}, virtual {detail['virtual_mesh']}")
        check(detail["device"] == torch.cuda.get_device_name(0) and detail["power_limit"] == card,
              f"bench_scaling_torch.py ran on {detail['device']}, {detail['power_limit']}")
        want = {k: per_member if k in ("closest_hit", "nee_dense", "shade_surface") else 0
                for k in _build.KERNELS}
        for e in sweep:
            check(len(e["member_launches"]) == e["n"]
                  and all(m == want for m in e["member_launches"]),
                  f"bench_scaling_torch.py ({part}) N={e['n']}: members' launches "
                  f"{e['member_launches']}, expected {want} each")
        rec[part] = dict(seconds=seconds, value=final["value"], unit=final["unit"], sweep=sweep)
    return rec


def nee_on_card(dev, scene, card: str) -> dict:
    """Phase 24: the dense light tree's NEE/MIS kernel at the `cornell.forward`
    cell's shapes: a 1920x1080 frame as one wavefront, sample 1, level 4 on
    phase 3's Cornell box (2 emitters), with `lights.nee_dense` recording
    the steps that `trace_paths` hands it.  At bounce 0 and 3: the kernel
    against `nee_dense_reference` (the share of rays whose outputs are
    bit-equal, the largest relative difference, picks inferred from the
    next direction), its time over 20 launches, the plain version's, aten's
    cumsum over the (R, 2) pdf table that the plain version runs, and the
    bound from the bytes the launch needs: every ray reads the lobe's
    direction and filter and its do_nee flag and writes 28 B; a ray with NEE
    also reads its origin, normal, perfect direction, incoming direction,
    exponent, three flags and four uniforms (71 B), and one whose reflected
    or refracted lobe takes the light its k (12 B).  Returns the phase's
    record."""
    import torch

    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
    from gpu_pathtracer_tpu_torch.render.integrator import render_image

    (w, h), level = NEE_FRAME, 4
    lt = scene.light_tree
    steps, real = [], lights_mod.nee_dense

    def recording(*args):
        steps.append(args)
        return real(*args)

    cam = Camera.create(**CORNELL_CAM, width=w, height=h, device=dev)
    lights_mod.nee_dense = recording
    tracing.reset("launch.")
    try:
        with torch.no_grad():
            render_image(scene, cam, w, h, sample_size=1, level=level,
                         hittable_pdf_weight=MAIN["weight"], ray_chunk=w * h,
                         generator=torch.Generator(device=dev).manual_seed(24))
    finally:
        lights_mod.nee_dense = real
    torch.cuda.synchronize()
    launched = tracing.totals["launch.nee_dense"]
    check(len(steps) == level and launched == level,
          f"nee_dense: {len(steps)} steps recorded, {launched} launches, expected {level}")
    rec = {"emitters": lt.num_lights, "rays": w * h, "launches_a_step": launched / level}
    for bounce in (0, 3):
        _, ref, normal, coming, weight, u, do_nee = steps[bounce]
        args = (lt, ref, normal, coming, weight, u, do_nee)
        with torch.no_grad():
            got = lights_mod.launch_nee_dense(*args)
            want = lights_mod.nee_dense_reference(*args)
            same = torch.ones_like(do_nee)
            worst = 0.0
            for a, b in zip(got, want):
                eq = a.view(torch.int32) == b.view(torch.int32)
                same &= eq.all(dim=-1) if eq.dim() > 1 else eq
                both = torch.isfinite(a) & torch.isfinite(b)
                rel = (a - b).abs() / b.abs().clamp(min=1e-30)
                worst = max(worst, float(rel[both].max()))
                check(bool((torch.isfinite(a) == torch.isfinite(b)).all()),
                      f"nee_dense bounce {bounce}: finite where the plain version is not")
            took = do_nee & (u[0] < torch.where(torch.isinf(ref.n), 0.0, weight))
            refilter = took & (ref.reflected | ref.refracted)
            nbytes = (w * h * 53 + int(do_nee.sum()) * 71 + int(refilter.sum()) * 12)
            bound = nbytes / PEAK_BYTES * 1e3
            ms = cuda_ms(lambda: lights_mod.launch_nee_dense(*args), 20)
            plain_ms = cuda_ms(lambda: lights_mod.nee_dense_reference(*args), 20)
            table = torch.rand((w * h, lt.num_lights), device=dev)
            cumsum_ms = cuda_ms(lambda: torch.cumsum(table, dim=-1), 20)
        share = float(same.float().mean())
        log(f"nee_dense, Cornell bounce {bounce}, {w * h} rays ({float(do_nee.float().mean()):.3f} "
            f"with NEE, {float(took.float().mean()):.3f} taking the light): kernel {ms:.4f} ms, "
            f"bound {bound:.4f} ms (bytes, {nbytes} B), plain version {plain_ms:.3f} ms, aten "
            f"cumsum over the (R, {lt.num_lights}) table {cumsum_ms:.3f} ms; outputs bit-equal on "
            f"{share:.7f} of the rays, largest relative difference {worst:.3e}; card: {card}")
        check(share >= 0.99999 and worst <= 1e-5,
              f"nee_dense bounce {bounce}: bit-equal on {share:.7f}, largest rel diff {worst:.3e}")
        rec[f"bounce_{bounce}"] = dict(ms=ms, bound_ms=bound, bound_by="bytes", plain_ms=plain_ms,
                                       library_ms=cumsum_ms, bit_equal_share=share,
                                       max_rel_diff=worst, nee_share=float(do_nee.float().mean()))
    return rec


def surface_on_card(dev, scene, card: str) -> dict:
    """Phase 25: the surface shading kernel at the `cornell.forward` cell's
    shapes: a 1920x1080 frame as one wavefront, sample 1, level 4 on phase
    3's Cornell box, with `surface.shade_surface` recording the steps that
    `trace_paths` hands it.  At bounce 0 and 3: the kernel against
    `shade_surface_reference` (the share of rays whose every output is
    bit-equal, the share whose flags and material ids agree, and on those
    the largest relative difference of a float field), its time over 20
    launches, the plain version's, and the bound from the bytes the launch
    needs: every ray reads its slot, barycentrics, direction, stack length
    and four uniforms (48 B) and its stack's live entries, and writes 115 B
    (point, uv, shading normal, material id, the record's six vectors, pdf,
    exponent, next material and seven flags); the attr rows and the material
    tables are read once.  Returns the phase's record."""
    import torch

    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.ops import surface
    from gpu_pathtracer_tpu_torch.render.integrator import render_image

    (w, h), level = NEE_FRAME, 4
    steps, real = [], surface.shade_surface

    def recording(*args):
        steps.append(args)
        return real(*args)

    cam = Camera.create(**CORNELL_CAM, width=w, height=h, device=dev)
    surface.shade_surface = recording
    tracing.reset("launch.")
    try:
        with torch.no_grad():
            render_image(scene, cam, w, h, sample_size=1, level=level,
                         hittable_pdf_weight=MAIN["weight"], ray_chunk=w * h,
                         generator=torch.Generator(device=dev).manual_seed(25))
    finally:
        surface.shade_surface = real
    torch.cuda.synchronize()
    launched = tracing.totals["launch.shade_surface"]
    check(len(steps) == level and launched == level,
          f"shade_surface: {len(steps)} steps recorded, {launched} launches, expected {level}")
    rec = {"rays": w * h, "launches_a_step": launched / level}
    for bounce in (0, 3):
        args = steps[bounce]
        g, table, stack_ids, stack_len = args[0], args[1], args[5], args[6]
        with torch.no_grad():
            got = surface.shade_fields(surface.launch_shade_surface(*args))
            want = surface.shade_fields(surface.shade_surface_reference(*args))
            same = torch.ones_like(stack_len, dtype=torch.bool)
            for key in surface.SHADE_DISCRETE:
                same &= got[key] == want[key]
            bits, close, worst = same.clone(), True, 0.0
            for key in surface.SHADE_FLOATS:
                a, b = got[key], want[key]
                eq = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
                bits &= eq.all(dim=-1) if eq.dim() > 1 else eq
                a, b = a[same], b[same]
                close &= bool(torch.isclose(a, b, rtol=1e-5, atol=1e-6, equal_nan=True).all())
                big = torch.isfinite(a) & torch.isfinite(b) & (b.abs() >= 1e-6)
                if bool(big.any()):
                    worst = max(worst, float(((a - b).abs() / b.abs())[big].max()))
            mats = 4 * (table.kd.shape[0] * 24 + g.attr.numel())
            live = int(torch.clamp(stack_len, max=stack_ids.shape[-1]).sum())
            nbytes = w * h * (48 + 115) + 4 * live + mats
            bound = nbytes / PEAK_BYTES * 1e3
            ms = cuda_ms(lambda: surface.launch_shade_surface(*args), 20)
            plain_ms = cuda_ms(lambda: surface.shade_surface_reference(*args), 20)
        agree, bit_share = float(same.float().mean()), float(bits.float().mean())
        log(f"shade_surface, Cornell bounce {bounce}, {w * h} rays "
            f"({float(want['false_hit'].float().mean()):.3f} false hits, "
            f"{float(want['diffuse'].float().mean()):.3f} diffuse, "
            f"{float(want['refracted'].float().mean()):.3f} refracted): kernel {ms:.4f} ms, bound "
            f"{bound:.4f} ms (bytes, {nbytes} B), plain version {plain_ms:.3f} ms; flags and ids "
            f"agree on {agree:.7f} of the rays, every output bit-equal on {bit_share:.7f}, largest "
            f"relative difference {worst:.3e}; card: {card}")
        check(agree >= 0.99999 and close,
              f"shade_surface bounce {bounce}: flags agree on {agree:.7f}, floats within rtol "
              f"1e-5: {close} (largest rel diff {worst:.3e})")
        rec[f"bounce_{bounce}"] = dict(ms=ms, bound_ms=bound, bound_by="bytes", bytes=nbytes,
                                       plain_ms=plain_ms, flags_agree_share=agree,
                                       bit_equal_share=bit_share, max_rel_diff=worst)
    return rec


def wavefronts(scene, camera, n_rays: int, bounces: int, seed: int):
    """(origin, direction, live) of each closest-hit call of `trace_paths`
    for camera rays of the given view, bounce by bounce."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import trace
    from gpu_pathtracer_tpu_torch.render.integrator import trace_paths

    dev = scene.geom.p.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    side = int(n_rays ** 0.5)
    ii, jj = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev),
                            indexing="ij")
    cam_i = ii.reshape(-1).float() * (camera.height / side) + 0.5
    cam_j = jj.reshape(-1).float() * (camera.width / side) + 0.5
    u = torch.rand((2, side * side), generator=gen, device=dev)
    o, d = camera.generate_rays(cam_i, cam_j, u[0], u[1])
    captured = []
    inner = trace.closest_hit

    def recording(g, origin, direction, t_max=float("inf"), live=None):
        captured.append((origin.clone(), direction.clone(), live.clone()))
        return inner(g, origin, direction, t_max, live)

    trace.closest_hit = recording
    try:
        with torch.no_grad():
            trace_paths(scene, o, d, level=bounces, hittable_pdf_weight=MAIN["weight"], generator=gen)
    finally:
        trace.closest_hit = inner
    return captured


def sorted_rays(g, wave, drop_tail: int = 0):
    """The main path's query for one captured wavefront: dead rays get a
    budget of -1 and are parked, the rays are coherence-sorted and prepared."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch
    from gpu_pathtracer_tpu_torch.ops import trace

    wo, wd, live = wave
    tm = torch.where(live, float("inf"), -1.0)
    wo, wd = trace.park_dead(g, wo, wd, live)
    perm = trace.coherence_perm(g, wo, wd, live)
    if drop_tail:
        perm = perm[:-drop_tail]
    return ch.prepare_rays(g.tile_aabb, wo[perm], wd[perm], tm[perm])


def path_tracing_master(folder, obj_filename, config, **overrides):
    """A master file for a path-tracing render of `folder`'s scene at the main
    widths from the Cornell camera; returns the parsed config."""
    kw = dict(
        input_folder_path=f"{folder}/", obj_filename=obj_filename,
        image_output_path=str(folder / "out.ppm"),
        image_width=MAIN["width"], image_height=MAIN["height"], render_mode=1,
        pathtracing_sample_size=MAIN["spp"], pathtracing_level=MAIN["level"],
        dof_sample_size=1, hittable_pdf_weight=MAIN["weight"],
        eye_x=0.5, eye_y=0.5, eye_z=2.4, center_x=0.5, center_y=0.5, center_z=0.0, fovy=40.0,
    )
    kw.update(overrides)
    master = folder / "master.txt"
    config.write_master_file(config.RenderConfig(**kw), master)
    return config.parse_master_file(master)


def make_sss_box(folder, testscenes) -> None:
    """The Cornell box with spheres whose first (white) sphere gets a `skin`
    material with a scattering path length of 0.15."""
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=1)
    mtl = folder / "box.mtl"
    mtl.write_text(mtl.read_text()
                   + "\nnewmtl skin\nKd 0.8 0.5 0.4\nKs 0 0 0\nd 1.0\nNs 1\npath_length 0.15\n")
    lines = (folder / "box.obj").read_text().splitlines()
    seen = 0
    for i, line in enumerate(lines):
        if line == "usemtl white":
            seen += 1
            if seen == 4:  # 3 wall groups, then the first sphere
                lines[i] = "usemtl skin"
                break
    (folder / "box.obj").write_text("\n".join(lines) + "\n")


def checker_image(side: int):
    """8 x 8 cells, red (230, 30, 30) where row + column is even and blue (30,
    30, 230) elsewhere: `tests/test_integration_tex.py`'s map_Kd at another
    size.  uint8 (side, side, 3)."""
    import numpy as np

    cell = np.arange(side) // (side // 8)
    on = ((cell[:, None] + cell[None, :]) % 2 == 0)[..., None]
    return np.where(on, np.uint8([230, 30, 30]), np.uint8([30, 30, 230])).astype(np.uint8)


def bump_image(side: int):
    """`tests/test_integration_tex.py`'s map_Bump, a horizontal sine field of
    six periods, at another size.  uint8 (side, side, 3)."""
    import numpy as np

    row = (np.sin(np.linspace(0, 12 * np.pi, side)) * 100 + 120).astype(np.uint8)
    return np.repeat(np.broadcast_to(row[None, :, None], (side, side, 1)), 3, axis=2)


def sky_image(height: int, width: int, band: float, base: float = 0.0):
    """An equirect sky of radiance `base` with a bright band over its top
    quarter (with base 0, the directional sky of
    `test_map_bump_changes_shading`).  float32 (H, W, 3)."""
    import numpy as np

    sky = np.full((height, width, 3), base, np.float32)
    sky[: height // 4] = band
    return sky


def textured_mesh_host(folder, subdiv: int, bump: bool = True, checker: int = TEX["checker"],
                       bump_side: int = TEX["bump"]):
    """`make_mesh_scene_host(subdiv)` with material 1 (`white`, the mesh and
    the floor) textured as `obj_io` packs an MTL line `map_Kd checker.png`
    and, with `bump`, `map_Bump -bm 5.0 bump.png`: the images written to
    `folder` as PNG and packed by `TextureAtlas.build`, their atlas slots in
    `tex_slot`, the multiplier in `bm`.  The mesh keeps its equirect uvs."""
    from PIL import Image

    from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    Image.fromarray(checker_image(checker)).save(folder / "checker.png")
    names = ["checker.png"]
    if bump:
        Image.fromarray(bump_image(bump_side)).save(folder / "bump.png")
        names.append("bump.png")
    host = testscenes.make_mesh_scene_host(subdiv=subdiv)
    atlas = obj_io.TextureAtlas.build(folder, names)
    tex_slot, bm = host.materials.tex_slot.copy(), host.materials.bm.copy()
    tex_slot[1, 0] = atlas.slot("checker.png")
    if bump:
        tex_slot[1, 4] = atlas.slot("bump.png")
        bm[1] = TEX["bm"]
    mats = dataclasses.replace(host.materials, tex_slot=tex_slot, bm=bm)
    return dataclasses.replace(host, materials=mats, atlas=atlas)


def sphere_pixels(side: int):
    """The pixels of a side x side frame from the Cornell camera whose centre
    ray meets the scattering sphere shrunk to 0.9 of its radius."""
    import torch
    from gpu_pathtracer_tpu_torch.models.camera import Camera

    cam = Camera.create(**CORNELL_CAM, width=side, height=side)
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32),
                            torch.arange(side, dtype=torch.float32), indexing="ij")
    zeros = torch.zeros(side * side)
    o, d = cam.generate_rays(ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5, zeros, zeros)
    centre, radius = SSS_SPHERE
    oc = o - torch.tensor(centre)
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - (0.9 * radius) ** 2)
    return (disc > 0).reshape(side, side).numpy()


def main() -> int:
    if not (HERE / "gpu_pathtracer_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout holding gpu_pathtracer_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    if sys.argv[1:2] == ["--scale-out-rank"]:
        out_dir, cornell_dir, box_dir, flag, rank = sys.argv[2:7]
        check(flag == "--rank", "usage: chip_smoke.py --scale-out-rank OUT CORNELL BOX --rank R")
        return scale_out_rank(int(rank), out_dir, cornell_dir, box_dir)
    import numpy as np
    import torch

    from gpu_pathtracer_tpu_torch import optim, renderer
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import _build, intersect, trace
    from gpu_pathtracer_tpu_torch import tracing
    from gpu_pathtracer_tpu_torch.ops import anyhit as ah
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch
    from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.render import sss as sss_mod
    from gpu_pathtracer_tpu_torch.render.integrator import (
        N_UNIFORMS,
        render_image,
        render_image_value_and_grad,
        trace_paths,
    )
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    t_start = time.perf_counter()
    phases = PhaseClock()
    phases.start(1)
    # ---- 1. device --------------------------------------------------------
    dev = require_cuda()
    card = nvidia_smi()
    log(f"device {torch.cuda.get_device_name(dev)}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    # the light-tree pdf matmul runs in full float32
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    phases.start(2)
    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_many(_build.KERNELS)
    log(f"built {', '.join(str(p.relative_to(HERE)) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f}s (all compilers started together)")
    for name, lib_path in zip(_build.KERNELS, libs):
        _build.load(name)
        for line in (lib_path.parent / "nvcc.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    phases.start(3)
    # ---- 3. closest_hit vs plain ------------------------------------------
    stats = {"max_abs_err": 0.0}
    pipe_err = {"max_abs_err": 0.0}
    rng = np.random.default_rng(0)
    n_tri, n_ray = 3000, 20000  # 20000 % 128 != 0: a padded ragged tail
    base = rng.uniform(-2, 2, (n_tri, 1, 3))
    tris = np.concatenate([base, base + rng.uniform(-0.7, 0.7, (n_tri, 2, 3))], 1)
    tris_t = torch.as_tensor(tris, dtype=torch.float32, device=dev)
    valid = torch.ones(n_tri, dtype=torch.bool, device=dev)
    valid[7] = False
    tiles, aabb = ch.pack_tiles(tris_t, intersect.triangle_tolerance(tris_t), valid)
    o = torch.as_tensor(rng.uniform(-3, 3, (n_ray, 3)), dtype=torch.float32, device=dev)
    d = torch.as_tensor(rng.normal(size=(n_ray, 3)), dtype=torch.float32, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.where(torch.arange(n_ray, device=dev) % 5 == 0, -1.0, float("inf"))
    soup = ch.prepare_rays(aabb, o, d, t_max)
    compare_plain_load("soup", soup, tiles, aabb, stats)
    compare_pipe("soup", soup, tiles, aabb, pipe_err, {})
    # the same soup for the any-hit kernels (phase 10's first part): a window
    # around typical hit distances, every 5th ray dead, the ragged tail
    anyhit_err = {"anyhit": 0, "anyhit_pipe": 0}
    t_near = torch.as_tensor(rng.uniform(0.3, 3.0, n_ray), dtype=torch.float32, device=dev)
    t_far = t_near + torch.as_tensor(rng.uniform(0.0, 2.0, n_ray), dtype=torch.float32, device=dev)
    dead = t_max < 0
    soup_window = ah.prepare_rays_window(aabb, o, d, torch.where(dead, -1.0, t_near),
                                         torch.where(dead, -1.0, t_far))
    compare_anyhit("soup", soup_window, tiles, aabb, anyhit_err, {}, plain_subset=n_ray)

    folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2)
    scene = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
    check(scene.geom.num_tris == 972, f"Cornell has {scene.geom.num_tris} triangles, not 972")
    camera = Camera.create(**CORNELL_CAM, width=MAIN["width"], height=MAIN["height"], device=dev)
    waves = wavefronts(scene, camera, WAVE_RAYS, 4, seed=1)
    g = scene.geom
    b1s = {}
    for bounce in (0, 3):
        compare_plain_load(f"cornell bounce {bounce} (ragged)", sorted_rays(g, waves[bounce], 100),
                           g.tiles, g.tile_aabb, stats)
        b1s[bounce] = compare_plain_load(f"cornell bounce {bounce}", sorted_rays(g, waves[bounce]),
                                         g.tiles, g.tile_aabb, stats, time_it=True)
    b1 = b1s[3]

    phases.start(4)
    # ---- 4. closest_hit_pipe on the mesh ----------------------------------
    t0 = time.perf_counter()
    mesh_host = testscenes.make_mesh_scene_host(subdiv=MESH_SUBDIV)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = build_scene(mesh_host, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mg = mesh.geom
    log(f"mesh: {mg.num_tris} triangles, {mg.tiles.shape[0]} tiles of {mg.tiles.shape[2]} "
        f"({mg.tiles.numel() * 4 / 1e6:.1f} MB); host arrays {host_s:.2f}s, build_scene on the "
        f"card {build_s:.2f}s")
    check(mg.num_tris == MESH_TRIS, f"the mesh has {mg.num_tris} triangles, not {MESH_TRIS}")
    check(trace.pallas_big(mg), "the mesh is not above PALLAS_MAX")
    mcam = Camera.create(**MESH_CAM, width=MAIN["width"], height=MAIN["height"], device=dev)
    tracing.reset("launch.")
    mwaves = wavefronts(mesh, mcam, WAVE_RAYS, 3, seed=2)
    check(tracing.totals["launch.closest_hit_pipe"] == 3
          and tracing.totals["launch.closest_hit"] == 0,
          "the mesh wavefronts did not run on closest_hit_pipe alone")
    b2s = {0: {}, 2: {}}
    for bounce, b2 in b2s.items():
        compare_pipe(f"mesh bounce {bounce} (ragged)", sorted_rays(mg, mwaves[bounce], 100),
                     mg.tiles, mg.tile_aabb, pipe_err, {}, plain_subset=PLAIN_SUBSET // 4)
        compare_pipe(f"mesh bounce {bounce}", sorted_rays(mg, mwaves[bounce]),
                     mg.tiles, mg.tile_aabb, pipe_err, b2, time_it=True)
    b2 = b2s[2]
    prep_ms = cuda_ms(lambda: sorted_rays(mg, mwaves[2]), 10)
    log(f"mesh bounce 2: coherence sort + prepare_rays {prep_ms:.4f} ms per launch "
        f"(block_tile_order apart, above)")
    b2["prep_ms"] = prep_ms

    phases.start(5)
    # ---- 5. same uniforms, card vs CPU -------------------------------------
    scene_cpu = build_scene(obj_io.load_scene(folder, "box.obj"), "cpu")
    cam32 = Camera.create(**CORNELL_CAM, width=32, height=32)
    ii, jj = torch.meshgrid(torch.arange(32.0), torch.arange(32.0), indexing="ij")
    o32, d32 = cam32.generate_rays(ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5,
                                   torch.zeros(1024), torch.zeros(1024))
    uni = torch.rand((8, N_UNIFORMS, 1024), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        col_gpu = trace_paths(scene, o32.to(dev), d32.to(dev), level=8,
                              hittable_pdf_weight=MAIN["weight"], uniforms=uni.to(dev)).cpu()
        col_cpu = trace_paths(scene_cpu, o32, d32, level=8,
                              hittable_pdf_weight=MAIN["weight"], uniforms=uni)
    match = torch.isclose(col_gpu, col_cpu, rtol=1e-4, atol=1e-5).all(dim=-1)
    share = float(match.float().mean())
    log(f"same uniforms, 32x32 level 8: {share:.4f} of rays match card vs CPU; "
        f"means {float(col_gpu.mean()):.6f} / {float(col_cpu.mean()):.6f}")
    check(share >= 0.99, f"same uniforms: only {share:.4f} of rays match")

    phases.start(6)
    # ---- 6. Cornell main path -------------------------------------------------
    cfg = config.RenderConfig(
        input_folder_path=f"{folder}/", obj_filename="box.obj",
        image_output_path=str(folder / "out.ppm"),
        image_width=MAIN["width"], image_height=MAIN["height"], render_mode=1,
        pathtracing_sample_size=MAIN["spp"], pathtracing_level=MAIN["level"],
        dof_sample_size=1, hittable_pdf_weight=MAIN["weight"],
        eye_x=0.5, eye_y=0.5, eye_z=2.4, center_x=0.5, center_y=0.5, center_z=0.0,
        fovy=40.0,
    )
    master = folder / "master.txt"
    config.write_master_file(cfg, master)
    cfg = config.parse_master_file(master)
    tracing.reset("launch.")
    t0 = time.perf_counter()
    img = renderer.render_from_config(cfg)
    seconds = time.perf_counter() - t0
    launches = tracing.totals["launch.closest_hit"]
    rays = MAIN["width"] * MAIN["height"] * MAIN["spp"] * MAIN["level"]
    chunks = -(-MAIN["width"] * MAIN["height"] // WAVE_RAYS)
    expected = chunks * MAIN["spp"] * MAIN["level"]
    log(f"main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level {MAIN['level']} "
        f"Cornell (972 tris): {launches} closest_hit launches (expected {expected}), "
        f"{tracing.totals['launch.closest_hit_pipe']} closest_hit_pipe launches")
    check(launches == expected, f"main path: {launches} kernel launches, expected {expected}")
    check(tracing.totals["launch.closest_hit_pipe"] == 0, "Cornell ran on closest_hit_pipe")
    check(img.shape == (MAIN["height"], MAIN["width"], 3), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()) and img.mean() > 0, "image not finite or all zero")

    log(f"main path: {seconds:.3f}s end to end (scene load and build included), "
        f"{rays / seconds:.0f} rays/s end to end; card: {card}")

    # the same master file at 64x64, 16 spp: the plain path on the CPU, and
    # the card at the same pixel centres
    cfg64 = config.parse_master_file(master)
    cfg64.image_width = cfg64.image_height = 64
    cfg64.pathtracing_sample_size = 16
    t0 = time.perf_counter()
    img_cpu = renderer.render_from_config(cfg64, device="cpu")
    cpu_s = time.perf_counter() - t0
    img_card64 = renderer.render_from_config(cfg64)
    ref_mean = float(img_cpu.mean())
    rel = abs(float(img.mean()) - ref_mean) / ref_mean
    rel64 = abs(float(img_card64.mean()) - ref_mean) / ref_mean
    log(f"image mean: card main path {img.mean():.6f}, card 64x64 {img_card64.mean():.6f}, "
        f"CPU plain path 64x64 {ref_mean:.6f} ({cpu_s:.1f}s); rel diff main: {rel:.4f}, "
        f"64: {rel64:.4f}")
    check(rel < 0.05, f"main-path image mean off the CPU plain path by {rel:.4f}")
    check(rel64 < 0.02, f"64x64 card image mean off the CPU plain path by {rel64:.4f}")

    phases.start(7)
    # ---- 7. mesh main path ------------------------------------------------------
    kw = dict(width=MAIN["width"], height=MAIN["height"], sample_size=MAIN["spp"],
              level=MAIN["level"], hittable_pdf_weight=MAIN["weight"])

    def render_mesh(scn=mesh, **changes):
        tracing.reset("launch.")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_image(scn, mcam, generator=torch.Generator(device=dev).manual_seed(12),
                               **dict(kw, **changes))
        torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0

    mimg, mesh_s = render_mesh()
    pipe_launches, plain_load_launches = (tracing.totals["launch.closest_hit_pipe"],
                                          tracing.totals["launch.closest_hit"])
    log(f"mesh main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level {MAIN['level']}, {mg.num_tris} triangles: {pipe_launches} "
        f"closest_hit_pipe launches (expected {expected}), {plain_load_launches} closest_hit "
        f"launches; render {mesh_s:.3f}s, {rays / mesh_s:.0f} rays/s; card: {card}")
    check(pipe_launches == expected and plain_load_launches == 0,
          f"mesh main path: {pipe_launches} closest_hit_pipe / {plain_load_launches} closest_hit "
          f"launches, expected {expected} / 0")
    check(mimg.shape == (MAIN["height"], MAIN["width"], 3), f"mesh image shape {mimg.shape}")
    check(bool(np.isfinite(mimg).all()) and mimg.mean() > 1e-3, "mesh image not finite or black")

    # the same view with every query forced onto closest_hit, 2 samples a pixel
    b1_spp = 2
    pallas_max = trace.PALLAS_MAX
    trace.PALLAS_MAX = mg.p.shape[0]
    try:
        mimg_b1, mesh_b1_s = render_mesh(sample_size=b1_spp)
    finally:
        trace.PALLAS_MAX = pallas_max
    check(tracing.totals["launch.closest_hit"] == expected * b1_spp // MAIN["spp"]
          and tracing.totals["launch.closest_hit_pipe"] == 0,
          "the forced render did not run on closest_hit alone")
    rel_b1 = abs(float(mimg.mean()) - float(mimg_b1.mean())) / float(mimg_b1.mean())
    log(f"mesh through closest_hit (forced, spp {b1_spp}): render {mesh_b1_s:.3f}s, "
        f"{rays * b1_spp / MAIN['spp'] / mesh_b1_s:.0f} rays/s; image mean {mimg_b1.mean():.6f} "
        f"against {mimg.mean():.6f}")
    check(rel_b1 < 0.05, f"mesh image mean off the closest_hit render by {rel_b1:.4f}")

    # CPU plain path: the mesh at subdiv=5 (20,484 triangles), 64x64
    cpu_spp = 2  # ~13 s per sample on the CPU: every ray against all 161 tiles
    cpu_kw = dict(kw, width=64, height=64, sample_size=cpu_spp)
    mesh5_host = testscenes.make_mesh_scene_host(subdiv=MESH_CPU_SUBDIV)
    cam64 = Camera.create(**MESH_CAM, width=64, height=64)
    t0 = time.perf_counter()
    with torch.no_grad():
        mimg_cpu = render_image(build_scene(mesh5_host, "cpu"), cam64,
                                generator=torch.Generator().manual_seed(12), **cpu_kw).numpy()
    mcpu_s = time.perf_counter() - t0
    mref = float(mimg_cpu.mean())
    mrel = abs(float(mimg.mean()) - mref) / mref
    log(f"mesh image mean: card main path {mimg.mean():.6f}; CPU plain path, the mesh at "
        f"subdiv={MESH_CPU_SUBDIV}, 64x64 spp {cpu_spp}: {mref:.6f} ({mcpu_s:.1f}s); rel diff {mrel:.4f}")
    check(mrel < 0.05, f"mesh image mean off the CPU plain path by {mrel:.4f}")

    phases.start(8)
    # ---- 8. gradient ------------------------------------------------------------
    bw_spp = max(1, MAIN["spp"] // 4)
    target = torch.as_tensor(img, device=dev)

    def ke_loss_and_grad(scn, cam, tgt, size, ke, seed):
        return render_image_value_and_grad(
            optim._substitute(scn, {"ke": ke}), cam, size, size,
            lambda im: torch.mean((im - tgt) ** 2), [ke], sample_size=bw_spp,
            level=MAIN["level"], hittable_pdf_weight=MAIN["weight"],
            generator=torch.Generator(device=dev).manual_seed(seed))

    ke = (scene.materials.ke * 1.01).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracing.reset("launch.")
    t0 = time.perf_counter()
    loss, _, (grad,) = ke_loss_and_grad(scene, camera, target, MAIN["width"], ke, 2)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grad_rays = MAIN["width"] * MAIN["height"] * bw_spp * MAIN["level"]
    light = scene.materials.ke.amax(dim=-1) > 0
    log(f"gradient: Cornell 512x512 spp {bw_spp} level {MAIN['level']}, L2 loss {float(loss):.6e} "
        f"to ke by path replay: {grad_s:.3f}s, {grad_rays / grad_s:.0f} grad-rays/s, peak memory "
        f"{peak_gb:.3f} GB, {tracing.totals['launch.closest_hit']} closest_hit launches; "
        f"d loss / d ke on the light's row {grad[light].flatten().tolist()}; card: {card}")
    check(bool(torch.isfinite(grad).all()), "the gradient is not finite")
    check(int(light.sum()) == 1 and bool((grad[light] != 0).all()),
          "the gradient is zero on the light's row")
    check(tracing.totals["launch.closest_hit"] == 2 * chunks * bw_spp * MAIN["level"],
          f"gradient: {tracing.totals['launch.closest_hit']} closest_hit launches")

    # 64x64: against a central finite difference on one component of ke.  The
    # paths are fixed by the seed and the image is linear in ke, so the loss is
    # quadratic in it and the central difference exact up to rounding
    cam64c = Camera.create(**CORNELL_CAM, width=64, height=64, device=dev)
    tgt64 = torch.as_tensor(img_card64, device=dev)
    row = int(torch.nonzero(light)[0, 0])
    ke0 = scene.materials.ke.clone()
    _, _, (g64,) = ke_loss_and_grad(scene, cam64c, tgt64, 64, (ke0 * 0.9).requires_grad_(True), 5)
    eps = 0.05 * float(ke0[row, 0])
    side = []
    for sign in (1.0, -1.0):
        kp = ke0 * 0.9
        kp[row, 0] += sign * eps
        side.append(float(ke_loss_and_grad(scene, cam64c, tgt64, 64, kp.requires_grad_(True), 5)[0]))
    fd = (side[0] - side[1]) / (2 * eps)
    an = float(g64[row, 0])
    log(f"gradient 64x64: d loss / d ke[{row}, 0] = {an:.6e} by autograd, {fd:.6e} by central "
        f"finite difference")
    check(abs(an - fd) < 0.05 * max(abs(fd), abs(an), 1e-3), f"gradient {an} vs difference {fd}")

    dim = optim._substitute(scene, {"ke": ke0 * 0.3})
    params, losses = optim.optimize(dim, cam64c, tgt64, param_names=("ke",), steps=3, lr=0.5,
                                    seed=1, sample_size=bw_spp, level=MAIN["level"],
                                    hittable_pdf_weight=MAIN["weight"])
    log(f"optimize, 3 steps at 64x64 from 0.3 ke: losses {losses}; ke on the light's row "
        f"{params['ke'][light].flatten().tolist()} (true {ke0[light].flatten().tolist()})")
    check(bool(np.isfinite(losses).all()) and len(losses) == 3, f"optimize losses {losses}")
    check(bool((params["ke"] >= 0).all()) and bool(torch.isfinite(params["ke"]).all()),
          "optimize left a negative or non-finite parameter")

    phases.start(9)
    # ---- 9. SPPM main path ----------------------------------------------------------
    sppm_folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sppm_"))
    scfg = sppm_box_master(sppm_folder, False, config, testscenes)
    tracing.reset("launch.")
    tracing.reset("loop_exit")
    sppm_log = []
    with RecordedGather(trace) as box_gather:
        t0 = time.perf_counter()
        simg = renderer.render_from_config(scfg, pass_log=sppm_log)
        sppm_s = time.perf_counter() - t0
    b3_launches, b4_on_box = tracing.totals["launch.anyhit"], tracing.totals["launch.anyhit_pipe"]
    total_photons = SPPM["photons"] * SPPM["passes"]
    log(f"SPPM main path: {SPPM['width']}x{SPPM['height']}, {SPPM['photons']} photons x "
        f"{SPPM['passes']} passes, ppm_max_bounce {SPPM['max_bounce']}, 72-triangle box: {sppm_s:.3f}s "
        f"end to end (scene load, build and init pass included), {total_photons / sppm_s:.0f} "
        f"photons/s end to end; {b3_launches} anyhit launches in {box_gather.calls} queries, "
        f"{b4_on_box} anyhit_pipe launches, {tracing.totals['launch.closest_hit']} closest_hit "
        f"launches, {tracing.totals['loop_exit']} host syncs; card: {card}")
    log_passes("SPPM main path", sppm_log, SPPM["photons"])
    check(len(sppm_log) == SPPM["passes"], f"{len(sppm_log)} passes logged")
    check(b3_launches > 0 and b3_launches == box_gather.calls
          and b3_launches == sum(p["anyhit_launches"] for p in sppm_log),
          f"SPPM main path: {b3_launches} anyhit launches for {box_gather.calls} queries")
    check(b4_on_box == 0 and tracing.totals["launch.closest_hit_pipe"] == 0,
          "the SPPM box ran on a ring-buffered kernel")
    check(all(p["grid"] for p in sppm_log), "the SPPM main path did not take the grid gathers")
    check(simg.shape == (SPPM["height"], SPPM["width"], 3), f"SPPM image shape {simg.shape}")
    check(bool(np.isfinite(simg).all()) and simg.mean() > 0, "SPPM image not finite or black")
    for suffix in ("", "_hit_point", "_direct", "_indirect", "_surface_photon"):
        check((sppm_folder / f"sppm{suffix}.ppm").stat().st_size > 0, f"sppm{suffix}.ppm missing")

    # the same master file at 48x48 on the CPU's plain path, the photon count
    # scaled to keep the photons per pixel.  The direct component must agree.
    # The indirect one is printed, not compared: the gathers' caps depend on
    # the size (the grid's cell is the largest gather radius, which a few
    # pixels behind glass set to about the scene's size; at 512x512 and 50,000
    # photons the 27 cells then hold far more photons than `k_per_cell`
    # admits, at 64x64 and 781 or fewer they do not), and so does the truncation that
    # the cap totals report.  What can be compared exactly is below: one pass
    # on the same inputs.
    scale = (SPPM_CPU_SIDE * SPPM_CPU_SIDE) / (SPPM["width"] * SPPM["height"])
    scfg64 = sppm_box_master(sppm_folder, False, config, testscenes,
                             image_width=SPPM_CPU_SIDE, image_height=SPPM_CPU_SIDE,
                             ppm_num_photon_per_pass=int(SPPM["photons"] * scale),
                             image_output_path=str(sppm_folder / "sppm_cpu.ppm"))
    cpu_log = []
    t0 = time.perf_counter()
    simg_cpu = renderer.render_from_config(scfg64, device="cpu", pass_log=cpu_log)
    scpu_s = time.perf_counter() - t0
    direct_card, direct_cpu = sppm_log[-1]["direct_mean"], cpu_log[-1]["direct_mean"]
    srel = abs(direct_card - direct_cpu) / direct_cpu
    log(f"SPPM image mean: card main path {simg.mean():.6f} (direct {direct_card:.6f}); CPU plain "
        f"path {SPPM_CPU_SIDE}x{SPPM_CPU_SIDE}, {scfg64.ppm_num_photon_per_pass} photons a pass: "
        f"{simg_cpu.mean():.6f} (direct {direct_cpu:.6f}; {scpu_s:.1f}s); rel diff of the direct "
        f"component {srel:.4f}; candidates dropped by the caps: {sum(p['dropped'] for p in sppm_log)} "
        f"on the card, {sum(p['dropped'] for p in cpu_log)} on the CPU")
    check(srel < 0.05, f"SPPM direct component off the CPU plain path by {srel:.4f}")

    # one pass on the same inputs, card against the CPU's plain path
    same = sppm_same_inputs(sppm_folder, dev, SPPM_CPU_SIDE, SPPM_SAME_PHOTONS, SPPM["max_bounce"])
    log(f"SPPM same inputs, {SPPM_CPU_SIDE}x{SPPM_CPU_SIDE}, {SPPM_SAME_PHOTONS} photons: card vs "
        f"CPU agree on {same['photons']:.4f} of the photons ({same['deposits']} deposits), "
        f"{same['eye']:.4f} of the eye pass's pixels, {same['gather']:.4f} of the gathers' pixels "
        f"({same['gathered']} photons gathered); grid overflow counts equal: {same['overflow_equal']}")
    check(same["deposits"] > 0 and same["gathered"] > 0, "SPPM same inputs: nothing deposited or gathered")
    check(same["photons"] >= 0.99, f"SPPM same inputs: {same['photons']:.4f} of the photons agree")
    check(same["eye"] >= 0.99, f"SPPM same inputs: {same['eye']:.4f} of the pixels agree")
    check(same["gather"] >= 0.999 and same["overflow_equal"],
          f"SPPM same inputs: {same['gather']:.4f} of the gathered pixels agree")

    phases.start(10)
    # ---- 10. the any-hit kernels on the recorded gather wavefront ------------------
    box_scene = build_scene(obj_io.load_scene(sppm_folder, "box.obj"), dev)
    bg = box_scene.geom
    check(not box_gather.big, "the box's gather went to the ring-buffered kernel")
    b34_box = {}
    compare_anyhit("SPPM box gather (ragged)", box_gather.rays(bg.tile_aabb, 100), bg.tiles,
                   bg.tile_aabb, anyhit_err, {}, plain_subset=PLAIN_SUBSET)
    box_rays = box_gather.rays(bg.tile_aabb)
    compare_anyhit("SPPM box gather", box_rays, bg.tiles, bg.tile_aabb, anyhit_err, b34_box,
                   plain_subset=box_rays.shape[0], time_it=True)
    # the recorded query is nearly all dead slots (few photons lie within a
    # pixel-sized radius); the same shape with every ray live
    box_cam = Camera.create(**CORNELL_CAM, width=SPPM["width"], height=SPPM["height"], device=dev)
    box_live = visibility_rays(box_scene, box_cam, SPPM["width"], GATHER_CHUNK, sppm.K_NEAREST, 21)
    b34_box_live = {}
    compare_anyhit("SPPM box, live gather rays", box_live, bg.tiles, bg.tile_aabb, anyhit_err,
                   b34_box_live, plain_subset=box_live.shape[0], time_it=True)

    phases.start(11)
    # ---- 11. the fog configuration -----------------------------------------------------
    fog_folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fog_"))
    fcfg = sppm_box_master(fog_folder, True, config, testscenes, ppm_num_pass=1)
    tracing.reset("launch.")
    fog_log = []
    t0 = time.perf_counter()
    fimg = renderer.render_from_config(fcfg, pass_log=fog_log)
    fog_s = time.perf_counter() - t0
    log(f"fog configuration: init pass + 1 pass in {fog_s:.3f}s end to end, "
        f"{tracing.totals['launch.anyhit']} anyhit launches; "
        f"tmp_lm sum {fog_log[0]['tmp_lm_sum']:.4f}; image mean {fimg.mean():.6f}; card: {card}")
    log_passes("fog", fog_log, SPPM["photons"])
    check(fog_log[0]["volume_photons"] > 0, "the fog pass deposited no volume photons")
    check(fog_log[0]["grid"], "the fog pass did not take the grid gathers")
    check(fog_log[0]["tmp_lm_finite"] and fog_log[0]["tmp_lm_sum"] > 0,
          "the fog's beam gather is not finite or is zero")
    check(tracing.totals["launch.anyhit"] > 0 and tracing.totals["launch.anyhit_pipe"] == 0,
          "the fog pass's gathers did not run on anyhit alone")
    check(bool(np.isfinite(fimg).all()) and fimg.mean() > 0, "fog image not finite or black")

    phases.start(12)
    # ---- 12. the mesh configuration ----------------------------------------------------
    mcfg = config.RenderConfig(image_width=SPPM["width"], image_height=SPPM["height"],
                               ppm_num_photon_per_pass=SPPM["photons"], ppm_num_pass=1,
                               ppm_max_bounce=SPPM["max_bounce"])
    tracing.reset("launch.")
    mesh_log = []
    with RecordedGather(trace) as mesh_gather, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msimg = sppm.render_sppm(mesh, mcam, mcfg, 12, pass_log=mesh_log)
        mesh_sppm_s = time.perf_counter() - t0
    b4_launches = tracing.totals["launch.anyhit_pipe"]
    log(f"mesh configuration: SPPM on {mg.num_tris} triangles, init pass + 1 pass in "
        f"{mesh_sppm_s:.3f}s; {b4_launches} anyhit_pipe launches in {mesh_gather.calls} queries, "
        f"{tracing.totals['launch.anyhit']} anyhit launches, "
        f"{tracing.totals['launch.closest_hit_pipe']} closest_hit_pipe launches; "
        f"image mean {msimg.mean():.6f}; card: {card}")
    log_passes("mesh", mesh_log, SPPM["photons"])
    check(b4_launches > 0 and b4_launches == mesh_gather.calls
          and tracing.totals["launch.anyhit"] == 0,
          f"mesh SPPM: {b4_launches} anyhit_pipe / {tracing.totals['launch.anyhit']} anyhit "
          "launches")
    check(tracing.totals["launch.closest_hit"] == 0, "the mesh SPPM pass launched closest_hit")
    check(mesh_log[0]["grid"], "the mesh pass did not take the grid gathers")
    check(msimg.shape == (SPPM["height"], SPPM["width"], 3) and bool(np.isfinite(msimg).all())
          and msimg.mean() > 0, "mesh SPPM image not finite or black")
    check(mesh_gather.big, "the mesh's gather did not go to the ring-buffered kernel")
    b34_mesh = {}
    compare_anyhit("mesh gather (ragged)", mesh_gather.rays(mg.tile_aabb, 100), mg.tiles,
                   mg.tile_aabb, anyhit_err, {}, plain_subset=PLAIN_SUBSET)
    compare_anyhit("mesh gather", mesh_gather.rays(mg.tile_aabb), mg.tiles, mg.tile_aabb,
                   anyhit_err, b34_mesh, plain_subset=PLAIN_SUBSET, time_it=True)
    mesh_live = visibility_rays(mesh, mcam, SPPM["width"], GATHER_CHUNK, sppm.K_NEAREST, 22)
    b34_mesh_live = {}
    compare_anyhit("mesh, live gather rays", mesh_live, mg.tiles, mg.tile_aabb, anyhit_err,
                   b34_mesh_live, plain_subset=PLAIN_SUBSET, time_it=True)

    phases.start(13)
    # ---- 13. closest_hit_mxu against closest_hit_pipe and its plain version ---------
    mxu_err = {"max_abs_err": 0.0}
    soup_g = SimpleNamespace(tiles=tiles, tile_aabb=aabb)
    soup_g.edge_tiles, soup_g.edge_wsum = ch.pack_edge_tiles(tris_t, valid)
    compare_mxu("soup", soup, soup_g, mxu_err, {})
    t0 = time.perf_counter()
    mesh_pf = build_scene(mesh_host, dev, edge_prefilter=True)
    torch.cuda.synchronize()
    build_pf_s = time.perf_counter() - t0
    pg = mesh_pf.geom
    check(pg.edge_tiles is not None and trace.edge_operand(pg) is not None,
          "build_scene(edge_prefilter=True) packed no edge tiles for the mesh")
    check(bool(torch.equal(pg.tiles, mg.tiles)), "the two mesh scenes' tiles differ")
    pack_ms = cuda_ms(lambda: ch.pack_edge_tiles(pg.p, pg.valid), 5)
    edge_mb = (pg.edge_tiles.numel() * 2 + pg.edge_wsum.numel() * 4) / 1e6
    log(f"mesh with the prefilter: build_scene {build_pf_s:.2f}s; pack_edge_tiles {pack_ms:.3f} ms, "
        f"{pg.edge_tiles.numel() * 2 / 1e6:.1f} MB of edge tiles + "
        f"{pg.edge_wsum.numel() * 4 / 1e6:.1f} MB of margin scales")
    b5 = {}
    b5_bounce0 = {}
    compare_mxu("mesh bounce 0 (ragged)", sorted_rays(pg, mwaves[0], 100), pg, mxu_err, {},
                plain_subset=PLAIN_SUBSET // 4)
    compare_mxu("mesh bounce 0", sorted_rays(pg, mwaves[0]), pg, mxu_err, b5_bounce0, time_it=True)
    compare_mxu("mesh bounce 2", sorted_rays(pg, mwaves[2]), pg, mxu_err, b5, time_it=True)

    phases.start(14)
    # ---- 14. mesh main path with the prefilter ------------------------------------------
    mimg_pf, mesh_pf_s = render_mesh(mesh_pf)
    mxu_launches = tracing.totals["launch.closest_hit_mxu"]
    log(f"mesh main path with the prefilter: {mxu_launches} closest_hit_mxu launches (expected "
        f"{expected}), {tracing.totals['launch.closest_hit_pipe']} closest_hit_pipe, "
        f"{tracing.totals['launch.closest_hit']} closest_hit; render {mesh_pf_s:.3f}s, "
        f"{rays / mesh_pf_s:.0f} rays/s (closest_hit_pipe render: {mesh_s:.3f}s); image equal to "
        f"the closest_hit_pipe render's bit for bit: {bool(np.array_equal(mimg, mimg_pf))}; "
        f"card: {card}")
    check(mxu_launches == expected and tracing.totals["launch.closest_hit_pipe"] == 0
          and tracing.totals["launch.closest_hit"] == 0,
          f"prefilter main path: {mxu_launches} closest_hit_mxu launches, expected {expected}")
    check(bool(np.array_equal(mimg, mimg_pf)), "the prefilter render's image differs")

    phases.start(15)
    # ---- 15. many lights ---------------------------------------------------------------------
    panel_folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_panel_"))
    testscenes.make_emitter_panel(panel_folder, nx=PANEL["nx"], ny=PANEL["ny"])
    pcfg = path_tracing_master(panel_folder, "panel.obj", config)
    picks = []
    inner_pick = lights_mod.pick_light

    def counting_pick(*args, **kwargs):
        picks.append(1)
        return inner_pick(*args, **kwargs)

    lights_mod.pick_light = counting_pick
    tracing.reset("launch.")
    tracing.reset("loop_exit")
    try:
        t0 = time.perf_counter()
        pimg = renderer.render_from_config(pcfg)
        panel_s = time.perf_counter() - t0
    finally:
        lights_mod.pick_light = inner_pick
    panel_syncs = tracing.totals["loop_exit"]
    log(f"many-lights main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level "
        f"{MAIN['level']}, {PANEL['emitters']} emitters: {panel_s:.3f}s end to end, "
        f"{rays / panel_s:.0f} rays/s end to end; {len(picks)} descents (one per wavefront step), "
        f"{tracing.totals['launch.closest_hit']} closest_hit launches, {panel_syncs} host syncs = "
        f"{panel_syncs / expected:.1f} per wavefront step; image mean {pimg.mean():.6f}; card: {card}")
    check(len(picks) == expected, f"many lights: {len(picks)} descents, expected {expected}: the "
          "sparse regime was not taken")
    check(tracing.totals["launch.closest_hit"] == expected, "many lights: closest_hit launch count")
    check(pimg.shape == (MAIN["height"], MAIN["width"], 3) and bool(np.isfinite(pimg).all())
          and pimg.mean() > 0, "many-lights image not finite or black")

    # one wavefront of it with the statistics, and the dense tables forced
    panel_scene, panel_cam = renderer.load_scene_from_config(pcfg, dev)
    plt = panel_scene.light_tree
    check(panel_scene.num_lights == PANEL["emitters"] and not plt.dense,
          f"the panel has {panel_scene.num_lights} emitters, dense {plt.dense}")
    pwave = wavefronts(panel_scene, panel_cam, WAVE_RAYS, 1, seed=4)[0]
    tracing.reset("loop_exit")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, pstats = trace_paths(panel_scene, pwave[0], pwave[1], level=MAIN["level"],
                                hittable_pdf_weight=MAIN["weight"], return_stats=True,
                                generator=torch.Generator(device=dev).manual_seed(5))
    dropped = int(pstats["mis_targets_dropped"])
    wave_s = time.perf_counter() - t0
    log(f"many lights, one wavefront of {WAVE_RAYS} rays, level {MAIN['level']}: {wave_s:.3f}s = "
        f"{wave_s / MAIN['level'] * 1e3:.1f} ms a step; mis_targets_dropped {dropped} "
        f"({dropped / (WAVE_RAYS * MAIN['level']):.6f} per ray and bounce); tree depth {plt.depth}, "
        f"{tracing.totals['loop_exit'] / MAIN['level']:.1f} host syncs a step")
    dense_tree = lights_mod.build_light_tree(
        plt.tri_p, plt.tri_n, plt.tri_uv, plt.node_energy[panel_scene.num_lights - 1:],
        plt.geom_slot, dense_tables=True)
    check(dense_tree.dense and dense_tree.anc.shape[1] == PANEL["emitters"], "dense tables not forced")
    # The camera jitters the lens, not the pixel, so the LED grid aliases on a
    # frame's pixel centres and the image mean depends on the resolution (on
    # the CPU the directly seen emission averages 0.725 at 64x64, 0.630 at
    # 128x128, 0.647 at 512x512).  So: the main path against the CPU render
    # over the lower half of the frame, which sees no LED; and at the CPU
    # render's own pixel centres the card's sparse regime against the CPU's
    # and against the dense tables forced.
    pcfg64 = path_tracing_master(panel_folder, "panel.obj", config, image_width=REF_SIDE,
                                 image_height=REF_SIDE, pathtracing_sample_size=MAIN["spp"] // 2)
    t0 = time.perf_counter()
    pimg_cpu = renderer.render_from_config(pcfg64, device="cpu")
    pcpu_s = time.perf_counter() - t0
    pimg_card64 = renderer.render_from_config(pcfg64)
    dcam = Camera.create(**CORNELL_CAM, width=REF_SIDE, height=REF_SIDE, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        pimg_dense = render_image(
            dataclasses.replace(panel_scene, light_tree=dense_tree), dcam, REF_SIDE, REF_SIDE,
            sample_size=MAIN["spp"] // 2, level=MAIN["level"], hittable_pdf_weight=MAIN["weight"],
            generator=torch.Generator(device=dev).manual_seed(6)).cpu().numpy()
    dense_s = time.perf_counter() - t0

    def rel(a, b):
        return abs(float(a.mean()) - float(b.mean())) / float(b.mean())

    prel_low = rel(pimg[MAIN["height"] // 2:], pimg_cpu[REF_SIDE // 2:])
    prel_cpu, prel_dense = rel(pimg_card64, pimg_cpu), rel(pimg_card64, pimg_dense)
    log(f"many-lights image mean: card main path {pimg.mean():.6f}, its lower half "
        f"{pimg[MAIN['height'] // 2:].mean():.6f}; CPU plain path {REF_SIDE}x{REF_SIDE} "
        f"{pimg_cpu.mean():.6f}, lower half {pimg_cpu[REF_SIDE // 2:].mean():.6f} ({pcpu_s:.1f}s): "
        f"rel diff of the lower halves {prel_low:.4f}; card {REF_SIDE}x{REF_SIDE} "
        f"{pimg_card64.mean():.6f}: rel diff to the CPU {prel_cpu:.4f}; dense tables forced, card "
        f"{REF_SIDE}x{REF_SIDE} {pimg_dense.mean():.6f} ({dense_s:.1f}s): rel diff {prel_dense:.4f}")
    check(prel_low < 0.05, f"many lights: the main path's lower half is off the CPU's by {prel_low:.4f}")
    check(prel_cpu < 0.05, f"many-lights image mean off the CPU render by {prel_cpu:.4f}")
    check(prel_dense < 0.05, f"many-lights image mean off the dense-table render by {prel_dense:.4f}")

    phases.start(16)
    # ---- 16. SSS ---------------------------------------------------------------------------------
    sss_folder = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sss_"))
    make_sss_box(sss_folder, testscenes)
    sss_cfg = path_tracing_master(sss_folder, "box.obj", config, sss_pts_per_object=SSS_POINTS)
    grid_calls = []
    inner_grid = sss_mod.gather_sss_grid

    def counting_grid(*args, **kwargs):
        grid_calls.append(args[1].shape[0])
        return inner_grid(*args, **kwargs)

    sss_mod.gather_sss_grid = counting_grid
    tracing.reset("launch.")
    tracing.reset("loop_exit")
    stages = {}
    inner_exit = renderer._Stage.__exit__

    def timed_exit(self, *exc):
        inner_exit(self, *exc)
        stages[self.stage] = self.seconds

    renderer._Stage.__exit__ = timed_exit
    try:
        t0 = time.perf_counter()
        sss_img = renderer.render_from_config(sss_cfg)
        sss_s = time.perf_counter() - t0
    finally:
        sss_mod.gather_sss_grid = inner_grid
        renderer._Stage.__exit__ = inner_exit
    first_s, render_s = stages["SSS point cloud + first pass"], stages["path-tracing render"]
    first_launches = MAIN["spp"] * MAIN["level"]
    log(f"SSS main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level {MAIN['level']}, "
        f"{SSS_POINTS} points on one object: {sss_s:.3f}s end to end; first pass {first_s:.3f}s, "
        f"render {render_s:.3f}s = {rays / render_s:.0f} rays/s; {len(grid_calls)} grid gathers for "
        f"{sum(grid_calls)} rays, {tracing.totals['loop_exit']} host syncs of the gather, "
        f"{tracing.totals['launch.closest_hit']} closest_hit launches (expected "
        f"{expected + first_launches}); image mean {sss_img.mean():.6f}; card: {card}")
    check(tracing.totals["launch.closest_hit"] == expected + first_launches,
          "SSS: closest_hit launch count")
    check(len(grid_calls) > 0 and tracing.totals["loop_exit"] == expected,
          f"SSS: {len(grid_calls)} grid gathers, {tracing.totals['loop_exit']} gather calls")
    check((sss_folder / "out_pts.ppm").stat().st_size > 0, "the SSS splat out_pts.ppm is missing")
    check(sss_img.shape == (MAIN["height"], MAIN["width"], 3) and bool(np.isfinite(sss_img).all()),
          "SSS image not finite")
    sss_cfg64 = path_tracing_master(sss_folder, "box.obj", config, sss_pts_per_object=SSS_POINTS,
                                    image_width=REF_SIDE, image_height=REF_SIDE)
    t0 = time.perf_counter()
    sss_cpu = renderer.render_from_config(sss_cfg64, device="cpu")
    sss_cpu_s = time.perf_counter() - t0
    on_card, on_cpu = sphere_pixels(MAIN["width"]), sphere_pixels(REF_SIDE)
    s_card, s_cpu = float(sss_img[on_card].mean()), float(sss_cpu[on_cpu].mean())
    srel_sphere = abs(s_card - s_cpu) / s_cpu
    log(f"SSS, mean over the sphere's pixels: card {s_card:.6f} ({int(on_card.sum())} pixels), CPU "
        f"plain path {REF_SIDE}x{REF_SIDE} spp {sss_cfg64.pathtracing_sample_size} {s_cpu:.6f} "
        f"({int(on_cpu.sum())} pixels, {sss_cpu_s:.1f}s), rel diff {srel_sphere:.4f}; image means "
        f"{sss_img.mean():.6f} / {sss_cpu.mean():.6f}")
    check(s_card > 0 and srel_sphere < 0.10,
          f"SSS: the sphere's mean is off the CPU render's by {srel_sphere:.4f}")

    phases.start(17)
    # ---- 17. differentiable SPPM ---------------------------------------------------------
    diff = diff_sppm(dev, card, stats, anyhit_err)
    log(f"phase 17 record: {json.dumps(diff)}")

    phases.start(18)
    # ---- 18. scale-out ---------------------------------------------------------------------
    scale = scale_out(dev, card, folder, master, img, sppm_folder, scfg)
    log(f"phase 18 record: {json.dumps(scale)}")
    scale_launches = {k: {"cornell_shard_rays": scale["cornell"]["launches"][k],
                          "sppm_shard_rays": scale["sppm"]["launches"][k],
                          "two_ranks": [sum(part[k] for part in rk["launches"].values())
                                        for rk in scale["two_ranks"]["ranks"]]}
                      for k in scale["cornell"]["launches"]}

    phases.start(19)
    # ---- 19. the textured large mesh ------------------------------------------------------
    tex = textured_mesh(dev, card, stats, pipe_err)
    log(f"phase 19 record: {json.dumps(tex)}")

    phases.start(20)
    # ---- 20. glass + depth of field -------------------------------------------------------
    glass = glass_dof(dev, card, stats)
    log(f"phase 20 record: {json.dumps(glass)}")

    phases.start(21)
    # ---- 21. the paths no earlier phase runs on the card ----------------------------------
    paths = card_paths(dev, card)
    log(f"phase 21 record: {json.dumps(paths)}")
    paths_launches = {k: {"kd_ks_gradient": paths["kd_ks_gradient"]["launches"][k],
                          "fog_diff_sppm": paths["fog_diff_sppm"]["launches"][k],
                          "mis_overflow": paths["mis_overflow"]["launches"][k],
                          "checkpoint_resume": paths["checkpoint_resume"]["optimize_launches"][k]
                          + paths["checkpoint_resume"]["sppm_launches"][k],
                          "cli_in_process": sum(m[k] for m in
                                                paths["cli"]["launches_in_process"].values())}
                      for k in paths["kd_ks_gradient"]["launches"]}

    phases.start(22)
    # ---- 22. the bench on the card ---------------------------------------------------------
    bench = bench_on_card(card)
    log(f"phase 22 record: {json.dumps(bench)}")
    bench_launches = {k: {leg: n[k] for leg, n in bench["launches"].items()}
                      for k in paths_launches}

    phases.start(23)
    # ---- 23. the scaling harness on the card -----------------------------------------------
    scaling = scaling_on_card(card)
    log(f"phase 23 record: {json.dumps(scaling)}")
    scaling_launches = {k: {part: [[m[k] for m in e["member_launches"]] for e in r["sweep"]]
                            for part, r in scaling.items()}
                        for k in _build.KERNELS}

    phases.start(24)
    # ---- 24. the NEE/MIS kernel at the benchmark cell's shapes -------------------------------
    nee = nee_on_card(dev, scene, card)
    log(f"phase 24 record: {json.dumps(nee)}")

    phases.start(25)
    # ---- 25. the surface shading kernel at the benchmark cell's shapes ----------------------
    surface = surface_on_card(dev, scene, card)
    log(f"phase 25 record: {json.dumps(surface)}")

    phases.report()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    record = {"kernels": [
        {
            "name": "closest_hit",
            "route": "cuda",
            "scale_out_launches": scale_launches["closest_hit"],
            "card_paths_launches": paths_launches["closest_hit"],
            "bench_launches": bench_launches["closest_hit"],
            "scaling_launches": scaling_launches["closest_hit"],
            "source": "gpu_pathtracer_tpu_torch/csrc/closest_hit.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:519",
            "launches": launches,
            "max_abs_err": stats["max_abs_err"],
            "ms": b1["ms"],
            "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"],
            "bound_by": b1["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a closest hit
            "diff_sppm_launches": diff["launches"]["closest_hit"],
            "diff_sppm": diff["closest_hit"],
            "shape": "65,536 rays x 972 triangles, Cornell bounce 3",
            "bounce_0": {k: b1s[0][k] for k in ("ms", "bound_ms", "bound_by")},
            "glass_dof_launches": glass["launches"]["closest_hit"],
            "glass_dof": {**glass["closest_hit"],
                          "shape": f"65,536 rays x 972 triangles, glass + DoF bounce "
                                   f"{glass['closest_hit']['bounce']}"},
        },
        {
            "name": "closest_hit_pipe",
            "route": "cuda",
            "scale_out_launches": scale_launches["closest_hit_pipe"],
            "card_paths_launches": paths_launches["closest_hit_pipe"],
            "bench_launches": bench_launches["closest_hit_pipe"],
            "scaling_launches": scaling_launches["closest_hit_pipe"],
            "source": "gpu_pathtracer_tpu_torch/csrc/closest_hit_pipe.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:609",
            "launches": pipe_launches,
            "max_abs_err": pipe_err["max_abs_err"],
            "ms": b2["ms"],
            "plain_ms": b2["plain_ms"],
            "bound_ms": b2["bound_ms"],
            "bound_by": b2["bound_by"],
            "library_ms": None,
            "shape": "65,536 rays x 327,684 triangles, mesh bounce 2; plain_ms on "
                     f"{b2['plain_rays']} of the rays",
            "closest_hit_ms_same_rays": b2["plain_load_ms"],
            "block_tile_order_ms": b2["order_ms"],
            "sort_and_prepare_ms": b2["prep_ms"],
            "most_tiles_scanned_by_a_group": b2["most_scanned"],
            "slowest_group_scan_share": b2["scan_share_slowest"],
            "bounce_0": {k: b2s[0][k] for k in ("ms", "plain_load_ms", "bound_ms", "bound_by",
                                                "most_scanned", "scan_share_slowest")},
            "textured_mesh_launches": tex["launches"]["closest_hit_pipe"],
            "textured_mesh_grad_launches": tex["grad_launches"]["closest_hit_pipe"],
            "textured_mesh": {**{k: tex["closest_hit_pipe"][k] for k in (
                "ms", "plain_ms", "plain_rays", "bound_ms", "bound_by", "most_scanned")},
                "shape": "65,536 rays x 327,684 triangles, textured mesh bounce 2"},
        },
        {
            "name": "anyhit",
            "route": "cuda",
            "scale_out_launches": scale_launches["anyhit"],
            "card_paths_launches": paths_launches["anyhit"],
            "bench_launches": bench_launches["anyhit"],
            "scaling_launches": scaling_launches["anyhit"],
            "source": "gpu_pathtracer_tpu_torch/csrc/anyhit.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:788",
            "launches": b3_launches,
            "max_abs_err": anyhit_err["anyhit"],  # rays whose bits differ from the plain version's
            **b34_box["anyhit"],
            "library_ms": None,  # no single PyTorch call answers an any-hit window
            "diff_sppm_launches": diff["launches"]["anyhit"],
            "diff_sppm": diff["anyhit"],
            "shape": f"{b34_box['rays']} rays x 72 triangles, the fullest gather query of the "
                     "SPPM main path",
            "anyhit_pipe_ms_same_rays": b34_box["anyhit_pipe"]["ms"],
            "closest_hit_ms_same_rays": b34_box["closest_ms"],
            "live_rays": {"shape": f"{b34_box_live['rays']} rays, every one live, between hit "
                                   "points of the box's eye pass",
                          **b34_box_live["anyhit"],
                          "anyhit_pipe_ms_same_rays": b34_box_live["anyhit_pipe"]["ms"],
                          "closest_hit_ms_same_rays": b34_box_live["closest_ms"]},
        },
        {
            "name": "anyhit_pipe",
            "route": "cuda",
            "scale_out_launches": scale_launches["anyhit_pipe"],
            "card_paths_launches": paths_launches["anyhit_pipe"],
            "bench_launches": bench_launches["anyhit_pipe"],
            "scaling_launches": scaling_launches["anyhit_pipe"],
            "source": "gpu_pathtracer_tpu_torch/csrc/anyhit_pipe.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:827",
            "launches": b4_launches,
            "max_abs_err": anyhit_err["anyhit_pipe"],
            **b34_mesh["anyhit_pipe"],
            "library_ms": None,
            "shape": f"{b34_mesh['rays']} rays x {MESH_TRIS} triangles, the fullest gather query "
                     f"of the mesh SPPM pass; plain_ms on {b34_mesh['plain_rays']} of the rays",
            "anyhit_ms_same_rays": b34_mesh["anyhit"]["ms"],
            "closest_hit_ms_same_rays": b34_mesh["closest_ms"],
            "block_tile_order_ms": b34_mesh["order_ms"],
            "live_rays": {"shape": f"{b34_mesh_live['rays']} rays, every one live, between hit "
                                   f"points of the mesh's eye pass; plain_ms on "
                                   f"{b34_mesh_live['plain_rays']} of the rays",
                          **b34_mesh_live["anyhit_pipe"],
                          "anyhit_ms_same_rays": b34_mesh_live["anyhit"]["ms"],
                          "closest_hit_ms_same_rays": b34_mesh_live["closest_ms"],
                          "block_tile_order_ms": b34_mesh_live["order_ms"]},
        },
        {
            "name": "closest_hit_mxu",
            "route": "cuda",
            "scale_out_launches": scale_launches["closest_hit_mxu"],
            "card_paths_launches": paths_launches["closest_hit_mxu"],
            "bench_launches": bench_launches["closest_hit_mxu"],
            "scaling_launches": scaling_launches["closest_hit_mxu"],
            "source": "gpu_pathtracer_tpu_torch/csrc/closest_hit_mxu.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:692",
            "launches": mxu_launches,
            "max_abs_err": mxu_err["max_abs_err"],
            "ms": b5["ms"],
            "plain_ms": b5["plain_ms"],
            "bound_ms": b5["bound_ms"],
            "bound_by": b5["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a closest hit
            "shape": "65,536 rays x 327,684 triangles, mesh bounce 2; plain_ms on "
                     f"{b5['plain_rays']} of the rays",
            "closest_hit_pipe_ms_same_rays": b5["pipe_ms"],
            "culled_share": b5["culled_share"],
            "culled_share_per_pair": b5["culled_share_per_pair"],
            "culled_share_group_union": b5["culled_share_group_union"],
            "culled_share_warp_union": b5["culled_share_warp_union"],
            "most_tiles_scanned_by_a_group": b5["most_scanned"],
            "slowest_group_scan_share": b5["scan_share_slowest"],
            "pack_edge_tiles_ms": pack_ms,
            "edge_operand_mb": edge_mb,
            "bounce_0": {k: b5_bounce0[k] for k in (
                "ms", "pipe_ms", "plain_ms", "bound_ms", "bound_by", "culled_share",
                "culled_share_per_pair", "culled_share_group_union", "culled_share_warp_union",
                "most_scanned", "scan_share_slowest")},
        },
        {
            "name": "nee_dense",
            "route": "cuda",
            "scale_out_launches": scale_launches["nee_dense"],
            "card_paths_launches": paths_launches["nee_dense"],
            "bench_launches": bench_launches["nee_dense"],
            "scaling_launches": scaling_launches["nee_dense"],
            "source": "gpu_pathtracer_tpu_torch/csrc/nee_dense.cu",
            "replaces": None,  # no TPU kernel: the step's ~460 torch launches
            "launches": nee["launches_a_step"],
            "max_abs_err": 1.0 - nee["bounce_3"]["bit_equal_share"],  # share of rays not bit-equal
            **{k: nee["bounce_3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")},
            "shape": "2,073,600 rays x 2 emitters, Cornell bounce 3 (the cornell.forward cell)",
            "bounce_0": nee["bounce_0"],
        },
        {
            "name": "shade_surface",
            "route": "cuda",
            "scale_out_launches": scale_launches["shade_surface"],
            "card_paths_launches": paths_launches["shade_surface"],
            "bench_launches": bench_launches["shade_surface"],
            "scaling_launches": scaling_launches["shade_surface"],
            "source": "gpu_pathtracer_tpu_torch/csrc/shade_surface.cu",
            "replaces": None,  # no TPU kernel: the step's ~780 torch launches
            "launches": surface["launches_a_step"],
            "max_abs_err": 1.0 - surface["bounce_3"]["bit_equal_share"],  # rays not bit-equal
            **{k: surface["bounce_3"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,  # no single PyTorch call computes the step
            "shape": "2,073,600 rays, Cornell bounce 3 (the cornell.forward cell)",
            "bounce_0": surface["bounce_0"],
        },
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
