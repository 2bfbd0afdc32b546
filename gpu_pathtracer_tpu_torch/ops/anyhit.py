"""Windowed any-hit tile query: host prep, the CUDA kernels' wrappers and
their plain PyTorch version (port of the any-hit half of
`gpu_pathtracer_tpu.ops.pallas_trace`).

For every ray two bits over the packed tiles of `ops/closest_hit.py`:
`occ_far` = some accepted hit with t <= t_far (t_far capped at the ray's exit
from the scene's root box), `occ_near` = some accepted hit with t < t_near
(strict; t_near <= t_far, so near implies far).  The photon gathers' verdict
"the photon's previous location is visible" is `occ_far & ~occ_near` with
t_near just short of that location.  There is no best t to refine: a ray is
settled by its first accepted hit, a settled ray stops voting for tiles, and a
group leaves its walk once all its rays are settled.

Two kernels answer the query on CUDA tensors with the closest-hit kernels'
pair test and group walk (`csrc/closest_hit_common.cuh`: groups of
GROUP_RAYS = 8 rays, 8 threads a ray, WALK_BATCH = 32 order entries culled
together, the per-ray budgets driving the culls): `csrc/anyhit.cu` stages
each candidate tile with plain loads, `csrc/anyhit_pipe.cu` (`big=True`,
scenes above `ops.trace.PALLAS_MAX` triangle rows) brings them in with the
closest-hit kernels' TMA ring of PIPE_RING buffers.  Their bits are equal,
and so are their walked and scanned counts, group by group.  Each launch
first settles the groups without a window (dead or padding rays) a thread
a ray, then a grid that fills the card walks the live groups, each block
pulling the next one.  CPU tensors run
the plain version, the group walk of `ops.closest_hit` in its window mode
(`anyhit_reference`, `anyhit_pipe_reference`), which returns the kernels'
per-group counts.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops.closest_hit import (
    _INF,
    GROUP_RAYS,
    PIPE_RING,
    RAY_BLOCK,
    _group_walk,
    block_tile_order,
    check_async_tiles,
    launch_group_walk,
    root_exit_cap,
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


def _launch_window(kernel, max_tile, rays, tiles, tile_aabb, order, counts, cycles):
    """An any-hit kernel's launch with its scratch: the list of live groups
    ((R_pad / GROUP_RAYS + 2) int32, its two counters zeroed by the kernel's
    entry point); the bytes come back as bool."""
    live = torch.empty((rays.shape[0] // GROUP_RAYS + 2,), dtype=torch.int32, device=rays.device)
    out = launch_group_walk(kernel, max_tile, _BITS_OUT, rays, tiles, tile_aabb, order, counts,
                            cycles, extra=(live,))
    return (out[0].view(torch.bool), out[1].view(torch.bool)) + out[2:]


def launch_anyhit(rays, tiles, tile_aabb, order, counts: bool = False, cycles: bool = False):
    """Launch `csrc/anyhit.cu` on prepared window rays; returns (occ_near,
    occ_far), each (R_pad,) bool, with `counts` also the (R_pad / GROUP_RAYS,
    3) int32 per group [order entries walked, tiles staged, tiles scanned],
    and with `cycles` the (R_pad / GROUP_RAYS, 2) int64 per group [clock64
    cycles of the walk, of its staging and scanning].  Raises on any input
    the kernel does not take and on a refused launch."""
    return _launch_window("anyhit", 1024, rays, tiles, tile_aabb, order, counts, cycles)


def launch_anyhit_pipe(rays, tiles, tile_aabb, order, counts: bool = False,
                       cycles: bool = False):
    """Launch `csrc/anyhit_pipe.cu` (the TMA ring); same inputs and outputs as
    `launch_anyhit`, the same bits and the same walked and scanned counts
    (the ring fetches up to PIPE_RING candidates ahead).  It also refuses a
    tile width that is not a multiple of 4 and tiles that are not 16-byte
    aligned."""
    check_async_tiles(tiles)
    return _launch_window("anyhit_pipe", 512, rays, tiles, tile_aabb, order, counts, cycles)


# ---------------------------------------------------------------------------
# The plain version (any device)
# ---------------------------------------------------------------------------

def anyhit_reference(rays, tiles, tile_aabb, order):
    """Plain PyTorch version of `csrc/anyhit.cu` on prepared window rays: the
    group walk in its window mode, staging only what it scans.  Returns
    (occ_near, occ_far, counts): (R_pad,) bool twice and the (R_pad /
    GROUP_RAYS, 3) int32 per group [order entries walked, tiles staged,
    tiles scanned]."""
    return _group_walk(rays, tiles, tile_aabb, order, 0, window=True)


def anyhit_pipe_reference(rays, tiles, tile_aabb, order):
    """Plain PyTorch version of `csrc/anyhit_pipe.cu`: `anyhit_reference`'s
    walk and bits, with the tiles fetched counted for the ring of PIPE_RING
    buffers."""
    return _group_walk(rays, tiles, tile_aabb, order, PIPE_RING, window=True)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def occluded_window_tiles(tiles, tile_aabb, origin, direction, t_near, t_far=float("inf"),
                          big=False):
    """Windowed any-hit for a ray batch: (occ_near, occ_far), each (R,) bool.
    CUDA tensors go through a kernel (one launch per call): the
    ring-buffered one with `big`, else the plain-load one; CPU tensors
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
            with tracing.span("kernel.anyhit"):  # the kernels' plain version
                near, far, _ = reference(rays, tiles, tile_aabb, order)
        else:
            raise ValueError(f"occluded_window_tiles runs on cuda or cpu, got {rays.device}")
    return near[:r], far[:r]
