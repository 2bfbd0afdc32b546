"""Windowed any-hit tile query: host prep, the CUDA kernels' wrappers and
their plain PyTorch versions (port of the any-hit half of
`gpu_pathtracer_tpu.ops.pallas_trace`).

For every ray two bits over the packed tiles of `ops/closest_hit.py`:
`occ_far` = some accepted hit with t <= t_far (t_far capped at the ray's exit
from the scene's root box), `occ_near` = some accepted hit with t < t_near
(strict; t_near <= t_far, so near implies far).  The photon gathers' verdict
"the photon's previous location is visible" is `occ_far & ~occ_near` with
t_near just short of that location.  There is no best t to refine: a ray is
settled by its first accepted hit, a settled ray stops voting for tiles, and a
block leaves its walk once all its rays are settled.

Two kernels answer the query on CUDA tensors, with the closest-hit kernels'
pair test (`csrc/closest_hit_common.cuh`): `csrc/anyhit.cu` stages each tile
with plain loads, `csrc/anyhit_pipe.cu` (`big=True`, scenes above
`ops.trace.PALLAS_MAX` triangle rows) through two `cp.async` buffers with the
lagging prefetch decision.  Their bits are equal.  CPU tensors run the plain
versions `anyhit_reference` / `anyhit_pipe_reference`, which walk each
block's tiles as the kernels do and return the kernels' per-block counts.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.ops.closest_hit import (
    _INF,
    _LB_SLACK,
    _PIPE_REFERENCE_BLOCKS,
    _TILE_ROWS,
    RAY_BLOCK,
    block_tile_order,
    check_async_tiles,
    launch_tile_kernel,
    pair_t,
    root_exit_cap,
    woop_ctx,
)


def prepare_rays_window(tile_aabb, origin, direction, t_near, t_far=float("inf")):
    """(R_pad, 8) float32 rays [o, d, t_far, t_near] padded to a multiple of
    RAY_BLOCK: t_far capped at the exit from the scene's root box (-1 for a
    ray that misses it), t_near = min(t_near, t_far), both clamped to 3.4e38.
    Padding rays are d = (0, 0, 1) with both caps -1, which culls every
    tile."""
    r = origin.shape[0]
    dev = origin.device
    t_far_b = torch.as_tensor(t_far, dtype=torch.float32, device=dev).expand(r)
    t_near_b = torch.as_tensor(t_near, dtype=torch.float32, device=dev).expand(r)
    t_far_b = root_exit_cap(tile_aabb, origin, direction, t_far_b)
    t_near_b = torch.minimum(t_near_b, t_far_b)
    rays = torch.cat(
        [origin, direction, torch.clamp(t_far_b, max=_INF)[:, None],
         torch.clamp(t_near_b, max=_INF)[:, None]],
        dim=-1,
    )
    pad = (-r) % RAY_BLOCK
    if pad:
        filler = torch.zeros((pad, 8), dtype=torch.float32, device=dev)
        filler[:, 5] = 1.0
        filler[:, 6:8] = -1.0
        rays = torch.cat([rays, filler])
    return rays.contiguous()


# ---------------------------------------------------------------------------
# The kernels (CUDA tensors)
# ---------------------------------------------------------------------------

_BITS_OUT = (torch.uint8, torch.uint8)  # the kernels write 0 / 1 bytes


def launch_anyhit(rays, tiles, tile_aabb, order, counts: bool = False):
    """Launch `csrc/anyhit.cu` on prepared window rays; returns (occ_near,
    occ_far), each (R_pad,) bool, and with `counts` also the (R_pad / 128, 3)
    int32 per-block [tile steps walked, tiles staged, tiles scanned].  Raises
    on any input the kernel does not take and on a refused launch."""
    near, far, c, _ = launch_tile_kernel("anyhit", 1024, _BITS_OUT,
                                         rays, tiles, tile_aabb, order, counts)
    launch_anyhit.launches += 1
    near, far = near.view(torch.bool), far.view(torch.bool)
    return (near, far, c) if counts else (near, far)


def launch_anyhit_pipe(rays, tiles, tile_aabb, order, counts: bool = False):
    """Launch `csrc/anyhit_pipe.cu` (the double-buffered kernel); same inputs
    and outputs as `launch_anyhit`, the same bits.  It also refuses a tile
    width that is not a multiple of 4 and tiles that are not 16-byte aligned."""
    check_async_tiles(tiles)
    near, far, c, _ = launch_tile_kernel("anyhit_pipe", 512, _BITS_OUT,
                                         rays, tiles, tile_aabb, order, counts)
    launch_anyhit_pipe.launches += 1
    near, far = near.view(torch.bool), far.view(torch.bool)
    return (near, far, c) if counts else (near, far)


# kernel launches; set to 0 by callers that count
launch_anyhit.launches = 0
launch_anyhit_pipe.launches = 0


# ---------------------------------------------------------------------------
# The plain versions (any device)
# ---------------------------------------------------------------------------

def _walk_reference(rays, tiles, tile_aabb, order, lagging: bool):
    """Both plain versions: every ray block walks its own row of `order`.
    Per step a block's budgets (-1 near set, t_near far set, else t_far) give
    `improve` (Chebyshev bound within the largest budget) and the slab vote;
    the walk ends at the first step without `improve`.  Without `lagging` a
    tile is scanned when voted by the current budgets; with it, when it was
    "fetched" on the budgets from before the previous tile's pairs and the
    walk still goes on (the double-buffered kernel's rule).  All blocks
    advance one step together; pair work is done only for the blocks that
    scan at that step."""
    n_blocks, n_tiles = order.shape
    tile = tiles.shape[2]
    dev = rays.device
    rb = rays.reshape(n_blocks, RAY_BLOCK, 8)
    o, d = rb[..., 0:3], rb[..., 3:6]
    t_far, t_near = rb[..., 6], rb[..., 7]
    b_lo, b_hi = torch.amin(o, dim=1), torch.amax(o, dim=1)
    dmax = torch.amax(torch.abs(d), dim=(1, 2))
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    order = order.long()

    near = torch.zeros((n_blocks, RAY_BLOCK), dtype=torch.bool, device=dev)
    far = torch.zeros_like(near)

    def budgets():
        return torch.where(near, -1.0, torch.where(far, t_near, t_far))

    def lower_bound(ti):
        box = tile_aabb[ti]
        gap = torch.maximum(box[:, 0:3] - b_hi, b_lo - box[:, 3:6])
        return torch.clamp(torch.amax(gap, dim=-1), min=0.0)

    def slab_vote(ti, budget):
        box = tile_aabb[ti][:, None, :]
        t0 = (box[..., 0:3] - o) * inv_d
        t1 = (box[..., 3:6] - o) * inv_d
        tlo = torch.amax(torch.minimum(t0, t1), dim=-1)
        thi = torch.amin(torch.maximum(t0, t1), dim=-1)
        ok = (thi >= tlo) & (thi > 0.0) & (torch.clamp(tlo, min=0.0) < budget)
        return torch.any(ok, dim=1)

    walking = torch.ones((n_blocks,), dtype=torch.bool, device=dev)
    counts = torch.zeros((n_blocks, 3), dtype=torch.int32, device=dev)
    ti_cur = order[:, 0]
    if lagging:
        budget = budgets()
        reach = torch.amax(budget, dim=1) * dmax
        fetched_cur = (lower_bound(ti_cur) * _LB_SLACK < reach) & slab_vote(ti_cur, budget)
        counts[:, 1] += fetched_cur
    for j in range(n_tiles):
        if not bool(walking.any()):
            break
        counts[:, 0] += walking
        budget = budgets()
        reach = torch.amax(budget, dim=1) * dmax
        improve = lower_bound(ti_cur) * _LB_SLACK < reach
        has_next = j + 1 < n_tiles
        ti_next = order[:, j + 1] if has_next else ti_cur
        if not lagging:
            fetched_cur = walking & improve & slab_vote(ti_cur, budget)
            counts[:, 1] += fetched_cur
        elif has_next:
            fetched_next = (walking & improve & (lower_bound(ti_next) * _LB_SLACK < reach)
                            & slab_vote(ti_next, budget))
            counts[:, 1] += fetched_next
        else:
            fetched_next = torch.zeros_like(walking)

        scan = torch.nonzero(walking & fetched_cur & improve)[:, 0]
        counts[scan, 2] += 1
        for c0 in range(0, scan.shape[0], _PIPE_REFERENCE_BLOCKS):
            blk = scan[c0:c0 + _PIPE_REFERENCE_BLOCKS]
            ti = ti_cur[blk]
            tv = [tiles[ti, row][:, None, :] for row in range(_TILE_ROWS)]
            t, ok = pair_t(woop_ctx(rb[blk]), tv)
            # a ray without a window does no pair test (the kernels' rule)
            hit_far = ok & (t <= t_far[blk][..., None]) & (budget[blk][..., None] >= 0.0)
            hit_near = hit_far & (t < t_near[blk][..., None])
            far[blk] |= torch.any(hit_far, dim=-1)
            near[blk] |= torch.any(hit_near, dim=-1)

        walking = walking & improve
        if lagging:
            fetched_cur = fetched_next
        ti_cur = ti_next
    return near.reshape(-1), far.reshape(-1), counts


def anyhit_reference(rays, tiles, tile_aabb, order):
    """Plain PyTorch version of `csrc/anyhit.cu` on prepared window rays.
    Returns (occ_near, occ_far, counts): (R_pad,) bool twice and the
    (R_pad / 128, 3) int32 per-block [tile steps walked, tiles staged, tiles
    scanned]."""
    return _walk_reference(rays, tiles, tile_aabb, order, lagging=False)


def anyhit_pipe_reference(rays, tiles, tile_aabb, order):
    """Plain PyTorch version of `csrc/anyhit_pipe.cu`: `anyhit_reference`
    with the lagging prefetch decision (tile j+1 is "fetched" on the budgets
    from before tile j's pairs; tile j is scanned only if it was fetched and
    the walk still goes on).  Same outputs; counts are [walked, fetched,
    scanned]."""
    return _walk_reference(rays, tiles, tile_aabb, order, lagging=True)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def occluded_window_tiles(tiles, tile_aabb, origin, direction, t_near, t_far=float("inf"),
                          big=False):
    """Windowed any-hit for a ray batch: (occ_near, occ_far), each (R,) bool.
    CUDA tensors go through a kernel (one launch per call): the
    double-buffered one with `big`, else the plain-load one; CPU tensors
    through the matching plain version.  Not differentiable."""
    r = origin.shape[0]
    with torch.no_grad():
        rays = prepare_rays_window(tile_aabb, origin, direction, t_near, t_far)
        order = block_tile_order(rays, tile_aabb, rays.shape[0] // RAY_BLOCK)
        if rays.device.type == "cuda":
            launch = launch_anyhit_pipe if big else launch_anyhit
            near, far = launch(rays, tiles, tile_aabb, order)
        elif rays.device.type == "cpu":
            reference = anyhit_pipe_reference if big else anyhit_reference
            near, far, _ = reference(rays, tiles, tile_aabb, order)
        else:
            raise ValueError(f"occluded_window_tiles runs on cuda or cpu, got {rays.device}")
    return near[:r], far[:r]
