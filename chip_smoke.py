#!/usr/bin/env python3
"""Drive the PyTorch port of the path tracer once on an NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one CUDA card

Phases (any failure exits non-zero; nothing is caught):
  1. the CUDA device, and the card's name and power limit from nvidia-smi;
  2. the five kernels (closest hit and windowed any hit, each with plain
     loads and double-buffered, and the double-buffered closest hit with the
     tensor-core edge prefilter) built with nvcc from the checkout's sources
     (one nvcc per source, started together), with their ptxas lines;
  3. the plain-load kernel (`closest_hit`, the group walk: 8-ray groups,
     8 threads a ray) against its plain PyTorch version on the card, and its
     per-group counts against the group walk's plain version: a random
     triangle soup with dead rays and a ragged tail, and Cornell wavefronts
     at bounce 0 and bounce 3 (65,536 rays x 972 triangles, the Cornell main
     path's shape), with both times and two bounds (from its own counts and
     from the 128-ray block walk's: `closest_hit_mxu`'s counts on the same
     rays);
  4. the ring-buffered kernel (`closest_hit_pipe`, the same walk with TMA
     copies) on wavefronts of the 327,684-triangle mesh at bounce 0 and
     bounce 2: against its plain version (values and per-group counts) on a
     16,384-ray subset, bit-equal to `closest_hit` with the same walk on the
     full 65,536 rays (and on a ragged tail), the per-group counts with the
     most tiles scanned by a group, both kernels' times in turns, the cycle
     split of the slowest group, the plain version's time, the host-side
     preparation of a launch, and two bounds (its own counts; the 128-ray
     block walk's, from `closest_hit_mxu`'s counts on the same rays);
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
 10. both any-hit kernels on a soup with dead rays and a ragged tail and on
     the fullest gather wavefront recorded in phase 9: bits and per-block
     counts against the plain versions, `anyhit_pipe` bit-equal to `anyhit`,
     both against the bits derived from `closest_hit`, and their times; the
     same on a query of that shape in which every ray is live (hit point to
     hit point), since few slots of the recorded one hold a photon;
 11. the fog configuration at the same size, one pass after the init pass:
     volume photons deposited, the hash-grid beam gather taken;
 12. the mesh configuration: SPPM on the 327,684-triangle mesh, one pass
     after the init pass through `render_sppm`, whose gathers must run on
     `anyhit_pipe` alone; the kernels compared as in phase 10 on its fullest
     gather wavefront.
 13. the kernel with the edge prefilter (`closest_hit_mxu`) against
     `closest_hit_pipe` and its plain version: the soup, and the mesh
     wavefronts at bounce 0 and bounce 2: (t, slot) bit-equal to
     `closest_hit_pipe` on every ray (the 128-ray block walk against the
     group walk), against the plain version on the 16,384-ray subset with its
     walk counts equal to the plain version's (the block walk), the
     prefilter's pair counts within 1% of the plain version's; both kernels'
     times on the same rays, the share of pairs culled (per warp, as the
     kernel culls, and per pair), `pack_edge_tiles`' time and bytes;
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
     render with the same point count.
To keep the run short some references run at a smaller depth than the main
paths: the Cornell SPPM render makes 2 of the bench's passes and its CPU
reference is 48x48, the render forced onto `closest_hit` and the mesh's CPU
reference take 2 samples a pixel, the Cornell CPU reference 16, the
many-lights one 4, and the ragged-tail mesh wavefronts hold 4,096 rays
against the plain versions.
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
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def compare_plain_load(name, rays, tiles, aabb, stats, time_it=False, edge=None):
    """`closest_hit` vs its plain version on the same prepared rays, and its
    per-group counts vs the group walk's plain version (ring 0); when asked,
    its time and two bounds: from its own counts and from the 128-ray block
    walk's (the walk of B1 before the group walk), which the prefilter kernel
    keeps: its counts on the same rays (`edge` = `pack_edge_tiles` of the
    scene)."""
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
    *_, bc = ch.launch_closest_hit_mxu(rays, tiles, *edge, aabb, order, counts=True)
    block_bound, block_by = bound_ms(rays, tiles, bc[:, :3])
    log(f"{name}: kernel {ms[0]:.4f} / {ms[1]:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.5f} ms ({by}); the 128-ray block walk's bound {block_bound:.5f} ms ({block_by}, "
        f"most tiles scanned by a block {int(bc[:, 2].max())})")
    return dict(ms=min(ms), plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bound_ms_block_walk=block_bound)


def compare_pipe(name, rays, tiles, aabb, stats, pipe_stats, time_it=False,
                 plain_subset=PLAIN_SUBSET, edge=None):
    """`closest_hit_pipe` on prepared rays: bit-equal to `closest_hit` on all
    of them with the same walk (entries walked and tiles scanned per group),
    against its plain version (values and per-group counts) on a subset of
    whole 128-ray rows spread over the batch.  When asked, both kernels'
    times in turns, the cycle split of the slowest group, and two bounds:
    from the kernel's own counts and from the 128-ray block walk's, which the
    prefilter kernel keeps (its counts on the same rays; `edge` =
    `pack_edge_tiles` of the scene)."""
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

    # the plain version on every k-th row
    stride = max(1, rays.shape[0] // plain_subset)
    blocks = torch.arange(0, n_blocks, stride, device=rays.device)
    rows = (blocks[:, None] * ch.RAY_BLOCK
            + torch.arange(ch.RAY_BLOCK, device=rays.device)[None, :]).reshape(-1)
    sub_rays, sub_order = rays[rows].contiguous(), order[blocks].contiguous()
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
    slow = int(torch.argmax(cyc[:, 0]))
    split = float(cyc[slow, 1]) / max(float(cyc[slow, 0]), 1.0)
    bound, by = bound_ms(rays, tiles, c2, unit=ch.GROUP_RAYS)
    *_, c5 = ch.launch_closest_hit_mxu(rays, tiles, *edge, aabb, order, counts=True)
    block_bound, block_by = bound_ms(rays, tiles, c5[:, :3])
    log(f"{name}: closest_hit_pipe {ms2a:.4f} / {ms2b:.4f} ms, closest_hit {ms1a:.4f} / "
        f"{ms1b:.4f} ms (20 launches each, in turns), plain version {plain_s * 1e3:.1f} ms "
        f"(one launch, {sub_rays.shape[0]} rays), block_tile_order {order_ms:.4f} ms; the "
        f"slowest group (walked {int(c2[slow, 0])}, scanned {int(c2[slow, 2])}) spends {split:.3f} "
        f"of its {int(cyc[slow, 0])} cycles staging and scanning; bound {bound:.5f} ms ({by}), "
        f"the 128-ray block walk's {block_bound:.5f} ms ({block_by}; most tiles scanned by a "
        f"block {int(c5[:, 2].max())})")
    pipe_stats.update(ms=min(ms2a, ms2b), plain_ms=plain_s * 1e3, plain_rays=sub_rays.shape[0],
                      plain_load_ms=min(ms1a, ms1b), order_ms=order_ms, bound_ms=bound,
                      bound_by=by, bound_ms_block_walk=block_bound, scan_share_slowest=split,
                      most_scanned=int(c2[:, 2].max()))


def compare_mxu(name, rays, g, stats, out, time_it=False, plain_subset=PLAIN_SUBSET):
    """`closest_hit_mxu` on prepared rays: (t, slot) bit-equal to
    `closest_hit_pipe` on all of them with the same walk counts, against its
    plain version on a subset of whole ray blocks spread over the batch, the
    prefilter's pair counts within PREFILTER_COUNT_TOL of the plain
    version's, and the share of pairs it culls."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    tiles, aabb, edge, wsum = g.tiles, g.tile_aabb, g.edge_tiles, g.edge_wsum
    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    order = ch.block_tile_order(rays, aabb, n_blocks)
    t2, slot2 = ch.launch_closest_hit_pipe(rays, tiles, aabb, order)
    t5, slot5, c5 = ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order, counts=True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(t2, t5)) and bool(torch.equal(slot2, slot5))
    differ = int(((t2 != t5) | (slot2 != slot5)).sum())
    walked, fetched, scanned, passed, culled = (int(x) for x in c5.long().sum(dim=0))
    pairs = scanned * ch.RAY_BLOCK * tiles.shape[2]
    share = culled / max(pairs, 1)
    log(f"{name}: {rays.shape[0]} rays x {tiles.shape[0]} tiles; closest_hit_mxu == "
        f"closest_hit_pipe bit for bit: {equal} ({differ} rays differ); per block: steps "
        f"{walked / n_blocks:.1f} (most {int(c5[:, 0].max())}), fetched {fetched / n_blocks:.2f}, "
        f"scanned {scanned / n_blocks:.2f} (most {int(c5[:, 2].max())}); of {pairs} pairs of "
        f"scanned tiles the prefilter passed {passed} to the exact test and culled {culled} "
        f"({share:.4f})")
    check(equal, f"{name}: closest_hit_mxu and closest_hit_pipe differ on {differ} rays")
    check(passed + culled == pairs, f"{name}: passed + culled != the pairs of the scanned tiles")

    # the plain version on every k-th block
    stride = max(1, rays.shape[0] // plain_subset)
    blocks = torch.arange(0, n_blocks, stride, device=rays.device)
    rows = (blocks[:, None] * ch.RAY_BLOCK
            + torch.arange(ch.RAY_BLOCK, device=rays.device)[None, :]).reshape(-1)
    sub_rays, sub_order = rays[rows].contiguous(), order[blocks].contiguous()
    t0 = time.perf_counter()
    rt, rslot, rc = ch.closest_hit_mxu_reference(sub_rays, tiles, edge, wsum, aabb, sub_order)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    agreement(f"{name}, plain version on {sub_rays.shape[0]} rays", t5[rows], slot5[rows],
              rt, rslot, stats)
    same_walk = float((rc[:, :3] == c5[blocks][:, :3]).all(dim=1).float().mean())
    k_passed, p_passed = int(c5[blocks][:, 3].long().sum()), int(rc[:, 3].long().sum())
    off = abs(k_passed - p_passed) / max(p_passed, 1)
    log(f"{name}: plain version's walk counts equal the kernel's on {same_walk:.4f} of the "
        f"subset's blocks; pairs passed: kernel {k_passed}, plain version {p_passed} "
        f"(rel. difference {off:.6f}, tolerance {PREFILTER_COUNT_TOL})")
    check(same_walk >= MIN_SLOT_AGREE, f"{name}: walk counts differ from the plain version's")
    check(off <= PREFILTER_COUNT_TOL, f"{name}: the prefilter's counts are off the plain version's")
    check(culled > 0, f"{name}: the prefilter culled nothing")

    # per pair, before the union over a warp's rays: each of 32 spread blocks
    # against the first tile it scans with the rays' initial budgets
    probe = blocks[:: max(1, blocks.shape[0] // 32)]
    first = order[probe, 0].long()
    rb = rays.reshape(n_blocks, ch.RAY_BLOCK, 8)[probe]
    cand = ch.prefilter_candidates(rb, edge[first], wsum[first], rb[..., 6:7])
    live = (rb[..., 6] > 0).sum() * tiles.shape[2]
    pair_share = 1.0 - float(cand.sum()) / max(int(live), 1)
    union = cand.reshape(-1, ch.RAY_BLOCK // 32, 32, tiles.shape[2]).any(dim=2)
    log(f"{name}: on {probe.shape[0]} blocks' nearest tiles the prefilter culls {pair_share:.4f} "
        f"of the live rays' pairs one by one, {1.0 - float(union.float().mean()):.4f} of the "
        f"columns after the union over a warp's 32 rays")
    if not time_it:
        return
    ms2a = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    ms5a = cuda_ms(lambda: ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order), 20)
    ms5b = cuda_ms(lambda: ch.launch_closest_hit_mxu(rays, tiles, edge, wsum, aabb, order), 20)
    ms2b = cuda_ms(lambda: ch.launch_closest_hit_pipe(rays, tiles, aabb, order), 20)
    extra = edge[0].numel() * 2 + wsum[0].numel() * 4
    bound, by = bound_ms(rays, tiles, c5, extra_tile_bytes=extra)
    log(f"{name}: closest_hit_mxu {ms5a:.4f} / {ms5b:.4f} ms, closest_hit_pipe {ms2a:.4f} / "
        f"{ms2b:.4f} ms (20 launches each, in turns), plain version {plain_s * 1e3:.1f} ms (one "
        f"launch, {sub_rays.shape[0]} rays), bound {bound:.5f} ms ({by})")
    out.update(ms=min(ms5a, ms5b), plain_ms=plain_s * 1e3, plain_rays=sub_rays.shape[0],
               pipe_ms=min(ms2a, ms2b), bound_ms=bound, bound_by=by, culled_share=share,
               culled_share_per_pair=pair_share, scanned_per_block=scanned / n_blocks,
               walked_per_block=walked / n_blocks)


def compare_anyhit(name, rays, tiles, aabb, err, out, plain_subset, time_it=False):
    """Both any-hit kernels on prepared window rays: `anyhit_pipe` bit-equal
    to `anyhit` on all of them, each against its plain version (bits and
    per-block counts) on a subset of whole ray blocks spread over the batch,
    and both bits against those derived from `closest_hit` on the same rays
    (hit & t < t_near, hit within t_far), coplanar ties aside.  `err` counts
    the rays whose bits differ from the plain versions'."""
    import torch
    from gpu_pathtracer_tpu_torch.ops import anyhit as ah
    from gpu_pathtracer_tpu_torch.ops import closest_hit as ch

    n_blocks = rays.shape[0] // ch.RAY_BLOCK
    order = ch.block_tile_order(rays, aabb, n_blocks)
    n3, f3, c3 = ah.launch_anyhit(rays, tiles, aabb, order, counts=True)
    n4, f4, c4 = ah.launch_anyhit_pipe(rays, tiles, aabb, order, counts=True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(n3, n4)) and bool(torch.equal(f3, f4))
    extra = c4[:, 1].long() - c4[:, 2].long()
    live = float((rays[:, 6] > 0).float().mean())
    log(f"{name}: {rays.shape[0]} rays (live {live:.3f}) x {tiles.shape[0]} tiles; far {float(f3.float().mean()):.3f}, "
        f"near {float(n3.float().mean()):.3f}; anyhit_pipe == anyhit on every ray: {equal}; per block: "
        f"steps {float(c3[:, 0].float().mean()):.1f}, anyhit scans {float(c3[:, 2].float().mean()):.2f}, "
        f"anyhit_pipe fetches {float(c4[:, 1].float().mean()):.2f} and scans "
        f"{float(c4[:, 2].float().mean()):.2f}")
    check(equal, f"{name}: anyhit_pipe and anyhit differ")
    check(bool(torch.equal(c3[:, 0], c4[:, 0])), f"{name}: the two kernels walk different steps")
    check(bool((extra >= 0).all()) and bool((extra <= 1).all()),
          f"{name}: a block fetched {int(extra.max())} tiles more than it scanned")
    check(bool((c4[:, 2] >= c3[:, 2]).all()), f"{name}: anyhit_pipe scanned fewer tiles")

    # the plain versions on every k-th block
    stride = max(1, rays.shape[0] // plain_subset)
    blocks = torch.arange(0, n_blocks, stride, device=rays.device)
    rows = (blocks[:, None] * ch.RAY_BLOCK
            + torch.arange(ch.RAY_BLOCK, device=rays.device)[None, :]).reshape(-1)
    sub_rays, sub_order = rays[rows].contiguous(), order[blocks].contiguous()
    plain_s = {}
    for kernel, reference, (kn, kf, kc) in (("anyhit", ah.anyhit_reference, (n3, f3, c3)),
                                            ("anyhit_pipe", ah.anyhit_pipe_reference, (n4, f4, c4))):
        t0 = time.perf_counter()
        rn, rf, rc = reference(sub_rays, tiles, aabb, sub_order)
        torch.cuda.synchronize()
        plain_s[kernel] = time.perf_counter() - t0
        differ = int(((kn[rows] != rn) | (kf[rows] != rf)).sum())
        same_counts = bool(torch.equal(rc, kc[blocks]))
        log(f"{name}: {kernel} against its plain version on {sub_rays.shape[0]} rays: "
            f"{differ} rays differ, per-block counts equal: {same_counts}")
        check(differ == 0, f"{name}: {kernel} differs from its plain version on {differ} rays")
        check(same_counts, f"{name}: {kernel}'s per-block counts differ from the plain version's")
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
    b3, by3 = bound_ms(rays, tiles, c3, out_bytes=2)
    b4, by4 = bound_ms(rays, tiles, c4, out_bytes=2)
    log(f"{name}: anyhit {ms3a:.4f} / {ms3b:.4f} ms, anyhit_pipe {ms4a:.4f} / {ms4b:.4f} ms, "
        f"closest_hit on the same rays {ms1:.4f} ms (20 launches each, in turns); plain versions "
        f"{plain_s['anyhit'] * 1e3:.1f} / {plain_s['anyhit_pipe'] * 1e3:.1f} ms (one call, "
        f"{sub_rays.shape[0]} rays); block_tile_order {order_ms:.4f} ms; bounds {b3:.5f} ms ({by3}) / "
        f"{b4:.5f} ms ({by4})")
    out["anyhit"] = dict(ms=min(ms3a, ms3b), plain_ms=plain_s["anyhit"] * 1e3, bound_ms=b3,
                         bound_by=by3)
    out["anyhit_pipe"] = dict(ms=min(ms4a, ms4b), plain_ms=plain_s["anyhit_pipe"] * 1e3,
                              bound_ms=b4, bound_by=by4)
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

    u_photon = {"emit": rand(5, p), "stack": rand(sppm.STACK_PROBE_STEPS, 4, p),
                "steps": rand(4 * max_bounce + 32, sppm.PHOTON_STEP_UNIFORMS, p)}
    u_eye = {"lens": rand(2, r), "stack": rand(sppm.STACK_PROBE_STEPS, 4, r),
             "bounce": rand(64, 4, r), "direct_bsdf": rand(4, r), "direct_pick": rand(r),
             "direct_light": rand(2, r), "direct_chain": rand(sppm.DIRECT_CHAIN_STEPS, 4, r)}
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


def reset_launches(ch) -> None:
    """Every kernel's launch count to 0."""
    from gpu_pathtracer_tpu_torch.ops import anyhit as ah

    ch.launch_closest_hit.launches = 0
    ch.launch_closest_hit_pipe.launches = 0
    ch.launch_closest_hit_mxu.launches = 0
    ah.launch_anyhit.launches = 0
    ah.launch_anyhit_pipe.launches = 0


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
    import numpy as np
    import torch

    from gpu_pathtracer_tpu_torch import optim, renderer
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import _build, intersect, trace
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
    kernels = ("closest_hit", "closest_hit_pipe", "anyhit", "anyhit_pipe", "closest_hit_mxu")
    t0 = time.perf_counter()
    libs = _build.build_many(kernels)
    log(f"built {', '.join(str(p.relative_to(HERE)) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f}s (all compilers started together)")
    for name, lib_path in zip(kernels, libs):
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
    cornell_edge = ch.pack_edge_tiles(g.p, g.valid)
    b1s = {}
    for bounce in (0, 3):
        compare_plain_load(f"cornell bounce {bounce} (ragged)", sorted_rays(g, waves[bounce], 100),
                           g.tiles, g.tile_aabb, stats)
        b1s[bounce] = compare_plain_load(f"cornell bounce {bounce}", sorted_rays(g, waves[bounce]),
                                         g.tiles, g.tile_aabb, stats, time_it=True,
                                         edge=cornell_edge)
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
    reset_launches(ch)
    mwaves = wavefronts(mesh, mcam, WAVE_RAYS, 3, seed=2)
    check(ch.launch_closest_hit_pipe.launches == 3 and ch.launch_closest_hit.launches == 0,
          "the mesh wavefronts did not run on closest_hit_pipe alone")
    mesh_edge = ch.pack_edge_tiles(mg.p, mg.valid)
    b2s = {0: {}, 2: {}}
    for bounce, b2 in b2s.items():
        compare_pipe(f"mesh bounce {bounce} (ragged)", sorted_rays(mg, mwaves[bounce], 100),
                     mg.tiles, mg.tile_aabb, pipe_err, {}, plain_subset=PLAIN_SUBSET // 4)
        compare_pipe(f"mesh bounce {bounce}", sorted_rays(mg, mwaves[bounce]),
                     mg.tiles, mg.tile_aabb, pipe_err, b2, time_it=True, edge=mesh_edge)
    del mesh_edge
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
    reset_launches(ch)
    t0 = time.perf_counter()
    img = renderer.render_from_config(cfg)
    seconds = time.perf_counter() - t0
    launches = ch.launch_closest_hit.launches
    rays = MAIN["width"] * MAIN["height"] * MAIN["spp"] * MAIN["level"]
    chunks = -(-MAIN["width"] * MAIN["height"] // WAVE_RAYS)
    expected = chunks * MAIN["spp"] * MAIN["level"]
    log(f"main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level {MAIN['level']} "
        f"Cornell (972 tris): {launches} closest_hit launches (expected {expected}), "
        f"{ch.launch_closest_hit_pipe.launches} closest_hit_pipe launches")
    check(launches == expected, f"main path: {launches} kernel launches, expected {expected}")
    check(ch.launch_closest_hit_pipe.launches == 0, "Cornell ran on closest_hit_pipe")
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
        reset_launches(ch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = render_image(scn, mcam, generator=torch.Generator(device=dev).manual_seed(12),
                               **dict(kw, **changes))
        torch.cuda.synchronize()
        return out.cpu().numpy(), time.perf_counter() - t0

    mimg, mesh_s = render_mesh()
    pipe_launches, plain_load_launches = (ch.launch_closest_hit_pipe.launches,
                                          ch.launch_closest_hit.launches)
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
    check(ch.launch_closest_hit.launches == expected * b1_spp // MAIN["spp"]
          and ch.launch_closest_hit_pipe.launches == 0,
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
    reset_launches(ch)
    t0 = time.perf_counter()
    loss, _, (grad,) = ke_loss_and_grad(scene, camera, target, MAIN["width"], ke, 2)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grad_rays = MAIN["width"] * MAIN["height"] * bw_spp * MAIN["level"]
    light = scene.materials.ke.amax(dim=-1) > 0
    log(f"gradient: Cornell 512x512 spp {bw_spp} level {MAIN['level']}, L2 loss {float(loss):.6e} "
        f"to ke by path replay: {grad_s:.3f}s, {grad_rays / grad_s:.0f} grad-rays/s, peak memory "
        f"{peak_gb:.3f} GB, {ch.launch_closest_hit.launches} closest_hit launches; d loss / d ke "
        f"on the light's row {grad[light].flatten().tolist()}; card: {card}")
    check(bool(torch.isfinite(grad).all()), "the gradient is not finite")
    check(int(light.sum()) == 1 and bool((grad[light] != 0).all()),
          "the gradient is zero on the light's row")
    check(ch.launch_closest_hit.launches == 2 * chunks * bw_spp * MAIN["level"],
          f"gradient: {ch.launch_closest_hit.launches} closest_hit launches")

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
    reset_launches(ch)
    sppm.host_syncs = 0
    sppm_log = []
    with RecordedGather(trace) as box_gather:
        t0 = time.perf_counter()
        simg = renderer.render_from_config(scfg, pass_log=sppm_log)
        sppm_s = time.perf_counter() - t0
    b3_launches, b4_on_box = ah.launch_anyhit.launches, ah.launch_anyhit_pipe.launches
    total_photons = SPPM["photons"] * SPPM["passes"]
    log(f"SPPM main path: {SPPM['width']}x{SPPM['height']}, {SPPM['photons']} photons x "
        f"{SPPM['passes']} passes, ppm_max_bounce {SPPM['max_bounce']}, 72-triangle box: {sppm_s:.3f}s "
        f"end to end (scene load, build and init pass included), {total_photons / sppm_s:.0f} "
        f"photons/s end to end; {b3_launches} anyhit launches in {box_gather.calls} queries, "
        f"{b4_on_box} anyhit_pipe launches, {ch.launch_closest_hit.launches} closest_hit launches, "
        f"{sppm.host_syncs} host syncs; card: {card}")
    log_passes("SPPM main path", sppm_log, SPPM["photons"])
    check(len(sppm_log) == SPPM["passes"], f"{len(sppm_log)} passes logged")
    check(b3_launches > 0 and b3_launches == box_gather.calls
          and b3_launches == sum(p["anyhit_launches"] for p in sppm_log),
          f"SPPM main path: {b3_launches} anyhit launches for {box_gather.calls} queries")
    check(b4_on_box == 0 and ch.launch_closest_hit_pipe.launches == 0,
          "the SPPM box ran on a double-buffered kernel")
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
    check(not box_gather.big, "the box's gather went to the double-buffered kernel")
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
    reset_launches(ch)
    fog_log = []
    t0 = time.perf_counter()
    fimg = renderer.render_from_config(fcfg, pass_log=fog_log)
    fog_s = time.perf_counter() - t0
    log(f"fog configuration: init pass + 1 pass in {fog_s:.3f}s end to end, "
        f"{ah.launch_anyhit.launches} anyhit launches; tmp_lm sum {fog_log[0]['tmp_lm_sum']:.4f}; "
        f"image mean {fimg.mean():.6f}; card: {card}")
    log_passes("fog", fog_log, SPPM["photons"])
    check(fog_log[0]["volume_photons"] > 0, "the fog pass deposited no volume photons")
    check(fog_log[0]["grid"], "the fog pass did not take the grid gathers")
    check(fog_log[0]["tmp_lm_finite"] and fog_log[0]["tmp_lm_sum"] > 0,
          "the fog's beam gather is not finite or is zero")
    check(ah.launch_anyhit.launches > 0 and ah.launch_anyhit_pipe.launches == 0,
          "the fog pass's gathers did not run on anyhit alone")
    check(bool(np.isfinite(fimg).all()) and fimg.mean() > 0, "fog image not finite or black")

    phases.start(12)
    # ---- 12. the mesh configuration ----------------------------------------------------
    mcfg = config.RenderConfig(image_width=SPPM["width"], image_height=SPPM["height"],
                               ppm_num_photon_per_pass=SPPM["photons"], ppm_num_pass=1,
                               ppm_max_bounce=SPPM["max_bounce"])
    reset_launches(ch)
    mesh_log = []
    with RecordedGather(trace) as mesh_gather, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msimg = sppm.render_sppm(mesh, mcam, mcfg, 12, pass_log=mesh_log)
        mesh_sppm_s = time.perf_counter() - t0
    b4_launches = ah.launch_anyhit_pipe.launches
    log(f"mesh configuration: SPPM on {mg.num_tris} triangles, init pass + 1 pass in "
        f"{mesh_sppm_s:.3f}s; {b4_launches} anyhit_pipe launches in {mesh_gather.calls} queries, "
        f"{ah.launch_anyhit.launches} anyhit launches, {ch.launch_closest_hit_pipe.launches} "
        f"closest_hit_pipe launches; image mean {msimg.mean():.6f}; card: {card}")
    log_passes("mesh", mesh_log, SPPM["photons"])
    check(b4_launches > 0 and b4_launches == mesh_gather.calls and ah.launch_anyhit.launches == 0,
          f"mesh SPPM: {b4_launches} anyhit_pipe / {ah.launch_anyhit.launches} anyhit launches")
    check(ch.launch_closest_hit.launches == 0, "the mesh SPPM pass launched closest_hit")
    check(mesh_log[0]["grid"], "the mesh pass did not take the grid gathers")
    check(msimg.shape == (SPPM["height"], SPPM["width"], 3) and bool(np.isfinite(msimg).all())
          and msimg.mean() > 0, "mesh SPPM image not finite or black")
    check(mesh_gather.big, "the mesh's gather did not go to the double-buffered kernel")
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
    mxu_launches = ch.launch_closest_hit_mxu.launches
    log(f"mesh main path with the prefilter: {mxu_launches} closest_hit_mxu launches (expected "
        f"{expected}), {ch.launch_closest_hit_pipe.launches} closest_hit_pipe, "
        f"{ch.launch_closest_hit.launches} closest_hit; render {mesh_pf_s:.3f}s, "
        f"{rays / mesh_pf_s:.0f} rays/s (closest_hit_pipe render: {mesh_s:.3f}s); image equal to "
        f"the closest_hit_pipe render's bit for bit: {bool(np.array_equal(mimg, mimg_pf))}; "
        f"card: {card}")
    check(mxu_launches == expected and ch.launch_closest_hit_pipe.launches == 0
          and ch.launch_closest_hit.launches == 0,
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
    reset_launches(ch)
    lights_mod.host_syncs = 0
    try:
        t0 = time.perf_counter()
        pimg = renderer.render_from_config(pcfg)
        panel_s = time.perf_counter() - t0
    finally:
        lights_mod.pick_light = inner_pick
    panel_syncs = lights_mod.host_syncs
    log(f"many-lights main path: {MAIN['width']}x{MAIN['height']} spp {MAIN['spp']} level "
        f"{MAIN['level']}, {PANEL['emitters']} emitters: {panel_s:.3f}s end to end, "
        f"{rays / panel_s:.0f} rays/s end to end; {len(picks)} descents (one per wavefront step), "
        f"{ch.launch_closest_hit.launches} closest_hit launches, {panel_syncs} host syncs = "
        f"{panel_syncs / expected:.1f} per wavefront step; image mean {pimg.mean():.6f}; card: {card}")
    check(len(picks) == expected, f"many lights: {len(picks)} descents, expected {expected}: the "
          "sparse regime was not taken")
    check(ch.launch_closest_hit.launches == expected, "many lights: closest_hit launch count")
    check(pimg.shape == (MAIN["height"], MAIN["width"], 3) and bool(np.isfinite(pimg).all())
          and pimg.mean() > 0, "many-lights image not finite or black")

    # one wavefront of it with the statistics, and the dense tables forced
    panel_scene, panel_cam = renderer.load_scene_from_config(pcfg, dev)
    plt = panel_scene.light_tree
    check(panel_scene.num_lights == PANEL["emitters"] and not plt.dense,
          f"the panel has {panel_scene.num_lights} emitters, dense {plt.dense}")
    pwave = wavefronts(panel_scene, panel_cam, WAVE_RAYS, 1, seed=4)[0]
    lights_mod.host_syncs = 0
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
        f"{lights_mod.host_syncs / MAIN['level']:.1f} host syncs a step")
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
    reset_launches(ch)
    sss_mod.host_syncs = 0
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
        f"{sum(grid_calls)} rays, {sss_mod.host_syncs} host syncs of the gather, "
        f"{ch.launch_closest_hit.launches} closest_hit launches (expected "
        f"{expected + first_launches}); image mean {sss_img.mean():.6f}; card: {card}")
    check(ch.launch_closest_hit.launches == expected + first_launches, "SSS: closest_hit launch count")
    check(len(grid_calls) > 0 and sss_mod.host_syncs == expected,
          f"SSS: {len(grid_calls)} grid gathers, {sss_mod.host_syncs} gather calls")
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

    phases.report()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    record = {"kernels": [
        {
            "name": "closest_hit",
            "route": "cuda",
            "source": "gpu_pathtracer_tpu_torch/csrc/closest_hit.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:519",
            "launches": launches,
            "max_abs_err": stats["max_abs_err"],
            "ms": b1["ms"],
            "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"],
            "bound_by": b1["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a closest hit
            "shape": "65,536 rays x 972 triangles, Cornell bounce 3",
            # the same bound from the 128-ray block walk's counts (B5's on the same rays)
            "bound_ms_block_walk": b1["bound_ms_block_walk"],
            "bounce_0": {k: b1s[0][k] for k in ("ms", "bound_ms", "bound_by",
                                                "bound_ms_block_walk")},
        },
        {
            "name": "closest_hit_pipe",
            "route": "cuda",
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
            # the same bound from the 128-ray block walk's counts (B5's on the same rays)
            "bound_ms_block_walk": b2["bound_ms_block_walk"],
            "most_tiles_scanned_by_a_group": b2["most_scanned"],
            "slowest_group_scan_share": b2["scan_share_slowest"],
            "bounce_0": {k: b2s[0][k] for k in ("ms", "plain_load_ms", "bound_ms", "bound_by",
                                                "bound_ms_block_walk", "most_scanned",
                                                "scan_share_slowest")},
        },
        {
            "name": "anyhit",
            "route": "cuda",
            "source": "gpu_pathtracer_tpu_torch/csrc/anyhit.cu",
            "replaces": "gpu_pathtracer_tpu/ops/pallas_trace.py:788",
            "launches": b3_launches,
            "max_abs_err": anyhit_err["anyhit"],  # rays whose bits differ from the plain version's
            **b34_box["anyhit"],
            "library_ms": None,  # no single PyTorch call answers an any-hit window
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
            "pack_edge_tiles_ms": pack_ms,
            "edge_operand_mb": edge_mb,
            "bounce_0": {k: b5_bounce0[k] for k in ("ms", "pipe_ms", "plain_ms", "bound_ms",
                                                    "bound_by", "culled_share",
                                                    "culled_share_per_pair")},
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
