"""Closest-hit tile query: packing, host prep, the CUDA kernel's wrapper and
its plain PyTorch version (port of the closest-hit half of
`gpu_pathtracer_tpu.ops.pallas_trace`).

The triangles of the Morton-sorted SoA are packed into tiles of `TILE`
columns, (NT, 10, TILE) float32: rows v1xyz v2xyz v3xyz and the per-triangle
tolerance.  Invalid and padding rows are zero with tol = +inf (det == 0, a
miss), and every tile has an AABB, inverted for empty tiles so that no slab
test ever passes.  A slot (the kernel's output) is `tile * TILE + column`,
i.e. a row of the sorted SoA.

Three kernels answer the query on CUDA tensors, over the same packed tiles
and with the same arithmetic and walk (`csrc/closest_hit_common.cuh`), so
their results are bit-equal: a CUDA block is a group of GROUP_RAYS = 8 rays
with 8 threads per ray, which walks the tile order of its 128-ray row
WALK_BATCH = 32 entries at a time (one batched cull, one candidate mask, the
early exit re-checked per candidate).  `csrc/closest_hit.cu` (B1) stages
each candidate tile with plain loads; `csrc/closest_hit_pipe.cu` (B2,
`big=True`, the route of scenes above `ops.trace.PALLAS_MAX` triangles)
brings them in with TMA bulk copies into a ring of PIPE_RING buffers
(`csrc/tile_ring.cuh`); `csrc/closest_hit_mxu.cu` (B5, `big=True` with
`edge=`, scenes built with `edge_prefilter=True`) fills the same ring with
each tile's triangles, margin scales and edge weights and puts a
conservative bf16 tensor-core test of the Pluecker edge values in front of
the exact pair test (`pack_edge_tiles` packs its operand; the cull unites
the candidates of a group's rays).  CPU tensors run the plain PyTorch
versions: `closest_hit_rays_reference` and, for `big=True`,
`closest_hit_pipe_reference` / `closest_hit_mxu_reference` (the group walk,
with the prefilter for the latter).  Counts are per group.  Geometry on the
card: 128-triangle tiles (5 KB of shared memory, fine-grained enough that
the tile cull prunes within a 972-triangle scene) and the tile order per 128
rays (one sort row per 128 rays at the 65,536-ray wavefront).
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops import _build

TILE = 128  # triangles per tile (kernel maximum: 1024)
RAY_BLOCK = 128  # rays per row of the tile order
# The tile kernels' group walk (csrc/closest_hit_common.cuh; the kernels'
# constants kGroupRays, kBatch and the kRing of closest_hit_pipe.cu,
# closest_hit_mxu.cu and anyhit_pipe.cu)
GROUP_RAYS = 8  # rays per group: one CUDA block of 8 threads per ray
WALK_BATCH = 32  # order entries culled together
PIPE_RING = 1  # tile buffers of the TMA ring
_INF = 3.4e38
_LB_SLACK = 0.999999  # 1 - 1e-6, the kernels' kLbSlack
_TILE_ROWS = 10
_REFERENCE_CHUNK = 8192  # rays per step of the plain version (chunk x TILE temporaries)
EDGE_K = 8  # contraction depth of the prefilter's product: 6 Pluecker slots, 2 zero
# 2^-6: twice the worst relative error of the bf16 product (each factor rounded
# to bf16: 2^-8 each, 2^-7 for the product; the f32 accumulation is negligible),
# applied to rmax_i * wsum_j >= sum_k |r_ik| |w_kj|
MXU_MARGIN = 2.0 ** -6


def pack_tiles(p: torch.Tensor, tol: torch.Tensor, valid: torch.Tensor):
    """(T, 3, 3) sorted triangles -> ((NT, 10, TILE) tiles, (NT, 8) tile AABBs)."""
    tile = TILE
    t = p.shape[0]
    pad = (-t) % tile
    dev = p.device
    pz = torch.where(valid[:, None, None], p, 0.0)
    tolz = torch.where(valid, tol, float("inf"))
    vflat = valid
    if pad:
        pz = torch.cat([pz, torch.zeros((pad, 3, 3), dtype=p.dtype, device=dev)])
        tolz = torch.cat([tolz, torch.full((pad,), float("inf"), dtype=tol.dtype, device=dev)])
        vflat = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    nt = (t + pad) // tile
    cols = torch.cat([pz.reshape(-1, 9).T, tolz[None, :]], dim=0)  # (10, Tpad)
    tiles = cols.reshape(_TILE_ROWS, nt, tile).permute(1, 0, 2).contiguous()

    per_tile = pz.reshape(nt, tile, 3, 3)
    vmask = vflat.reshape(nt, tile, 1, 1)
    tmin = torch.amin(torch.where(vmask, per_tile, _INF), dim=(1, 2))
    tmax = torch.amax(torch.where(vmask, per_tile, -_INF), dim=(1, 2))
    aabb = torch.cat([tmin, tmax, torch.zeros((nt, 2), dtype=p.dtype, device=dev)], dim=1)
    return tiles, aabb.contiguous()


def pack_edge_tiles(p: torch.Tensor, valid: torch.Tensor):
    """(T, 3, 3) sorted triangles -> the prefilter's second operand, tile by
    tile as `pack_tiles` cuts them: ((NT, 3 * TILE, EDGE_K) bfloat16 edge
    weights, (NT, 3, TILE) float32 margin scales).

    Column m * TILE + j of a tile (edge m of its triangle j; edges run
    (v1, v2), (v2, v3), (v3, v1)) holds the Pluecker weights
    [cross(a, b), b - a, 0, 0], so that with the ray's [d, o x d, 0, 0] one
    depth-8 product gives e = d . cross(a, b) + (o x d) . (b - a); a hit
    needs the three values of a triangle to share a sign.  The k index is
    the fastest so that a tensor-core B fragment is one 32-bit load.  The
    margin scale is wsum = sum |w| * (1 + 2^-7), and -1 on invalid and
    padding triangles: their zero edge values then fail both `e >= -margin`
    and `e <= margin` (margin < 0) instead of being vacuously consistent.

    The cull weakens (it never errs) for scenes far from the origin, where
    |o x d| inflates every margin; such scenes are best re-centred."""
    tile = TILE
    t = p.shape[0]
    pad = (-t) % tile
    dev = p.device
    a = torch.where(valid[:, None, None], p, 0.0)
    b = a[:, (1, 2, 0), :]
    w6 = torch.cat([torch.linalg.cross(a, b), b - a], dim=-1)  # (T, 3 edges, 6)
    wsum = torch.sum(torch.abs(w6), dim=-1) * (1.0 + 2.0 ** -7)  # (T, 3)
    wsum = torch.where(valid[:, None], wsum, -1.0)
    if pad:
        w6 = torch.cat([w6, torch.zeros((pad, 3, 6), dtype=w6.dtype, device=dev)])
        wsum = torch.cat([wsum, torch.full((pad, 3), -1.0, dtype=wsum.dtype, device=dev)])
    nt = (t + pad) // tile
    w8 = torch.cat([w6, torch.zeros((t + pad, 3, EDGE_K - 6), dtype=w6.dtype, device=dev)], dim=-1)
    edge = w8.reshape(nt, tile, 3, EDGE_K).permute(0, 2, 1, 3).reshape(nt, 3 * tile, EDGE_K)
    return (edge.to(torch.bfloat16).contiguous(),
            wsum.reshape(nt, tile, 3).permute(0, 2, 1).contiguous())


def root_exit_cap(tile_aabb, origin, direction, t_max) -> torch.Tensor:
    """Cap every ray's t budget at its exit from the scene's root box (no hit
    lies outside it), so misses get a finite best t and the early exit fires
    for them too; rays that miss the root box get -1 (all tile work culled)."""
    root_lo = torch.amin(tile_aabb[:, 0:3], dim=0)
    root_hi = torch.amax(
        torch.where(tile_aabb[:, 3:6] >= tile_aabb[:, 0:3], tile_aabb[:, 3:6], float("-inf")),
        dim=0,
    )
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-20, 1e-20, direction)
    ta = (root_lo[None, :] - origin) * inv_d
    tb = (root_hi[None, :] - origin) * inv_d
    root_exit = torch.amin(torch.maximum(ta, tb), dim=-1)
    root_entry = torch.amax(torch.minimum(ta, tb), dim=-1)
    hits_root = (root_exit >= root_entry) & (root_exit > 0.0)
    return torch.where(hits_root, torch.minimum(t_max, root_exit * 1.0001 + 1e-4), -1.0)


def prepare_rays(tile_aabb, origin, direction, t_max=float("inf")):
    """(R_pad, 8) float32 rays [o, d, t_cap, 0] padded to a multiple of
    RAY_BLOCK.  Padding rays are d = (0, 0, 1) with a budget of 0, which culls
    every tile."""
    r = origin.shape[0]
    t_max_b = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device).expand(r)
    t_cap = root_exit_cap(tile_aabb, origin, direction, t_max_b)
    rays = torch.cat(
        [origin, direction, torch.clamp(t_cap, max=_INF)[:, None],
         torch.zeros((r, 1), dtype=torch.float32, device=origin.device)],
        dim=-1,
    )
    pad = (-r) % RAY_BLOCK
    if pad:
        filler = torch.zeros((pad, 8), dtype=torch.float32, device=origin.device)
        filler[:, 5] = 1.0
        rays = torch.cat([rays, filler])
    return rays.contiguous()


def block_tile_order(rays: torch.Tensor, tile_aabb: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(n_blocks, NT) int32 front-to-back tile order per ray block: a stable
    argsort of the Chebyshev distance from the block's origin box to each
    tile box — the same quantity the kernel recomputes for its early exit."""
    o_blocks = rays[:, 0:3].reshape(n_blocks, -1, 3)
    b_lo = torch.amin(o_blocks, dim=1)
    b_hi = torch.amax(o_blocks, dim=1)
    t_lo = tile_aabb[:, 0:3]
    t_hi = tile_aabb[:, 3:6]
    gap = torch.maximum(t_lo[None, :, :] - b_hi[:, None, :], b_lo[:, None, :] - t_hi[None, :, :])
    lb = torch.amax(torch.clamp(gap, min=0.0), dim=-1)
    return torch.sort(lb, dim=1, stable=True).indices.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# The kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch_group_walk(kernel: str, max_tile: int, out_dtypes, rays, tiles, tile_aabb, order,
                      counts: bool, cycles: bool, extra=(), n_counts: int = 3):
    """Check the inputs (`max_tile` is the kernel's kMaxTile), launch
    `csrc/<kernel>.cu` and return its two per-ray outputs (of `out_dtypes`),
    then with `counts` the (R_pad / GROUP_RAYS, `n_counts`) int32 counts and
    with `cycles` the (R_pad / GROUP_RAYS, 2) int64 cycles per group.  Every
    tile kernel walks in groups (`csrc/closest_hit_common.cuh`) behind this
    one C signature; `extra` are further inputs (checked by the caller)
    after `order`.  The launch alone is the span `kernel.anyhit` (any-hit
    kernels) or `kernel.closest_hit`."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got {dev}")
    n_rays = rays.shape[0]
    n_tiles, rows, tile = tiles.shape
    if n_rays % RAY_BLOCK or rows != _TILE_ROWS or not 0 < tile <= max_tile or n_tiles == 0:
        raise ValueError(
            f"bad shapes: rays {tuple(rays.shape)} (multiple of {RAY_BLOCK}), "
            f"tiles {tuple(tiles.shape)} (NT, 10, tile <= {max_tile})"
        )
    _check("rays", rays, torch.float32, (n_rays, 8), dev)
    _check("tiles", tiles, torch.float32, (n_tiles, _TILE_ROWS, tile), dev)
    _check("tile_aabb", tile_aabb, torch.float32, (n_tiles, 8), dev)
    _check("order", order, torch.int32, (n_rays // RAY_BLOCK, n_tiles), dev)
    if tile_aabb.data_ptr() % 16:
        raise ValueError("the group walk reads tile boxes as 16-byte vectors: tile_aabb must be "
                         "16-byte aligned")

    out_a = torch.empty((n_rays,), dtype=out_dtypes[0], device=dev)
    out_b = torch.empty((n_rays,), dtype=out_dtypes[1], device=dev)
    groups = n_rays // GROUP_RAYS
    out_counts = torch.empty((groups, n_counts), dtype=torch.int32, device=dev) if counts else None
    out_cycles = torch.empty((groups, 2), dtype=torch.int64, device=dev) if cycles else None
    with tracing.span("kernel.anyhit" if kernel.startswith("anyhit") else "kernel.closest_hit"):
        _build.launch(kernel, (_build.PTR,) * (8 + len(extra)) + (_build.INT,) * 3, dev,
                      rays.data_ptr(), tiles.data_ptr(), tile_aabb.data_ptr(), order.data_ptr(),
                      *(x.data_ptr() for x in extra), out_a.data_ptr(), out_b.data_ptr(),
                      out_counts.data_ptr() if counts else None,
                      out_cycles.data_ptr() if cycles else None, n_rays, n_tiles, tile)
    return (out_a, out_b) + ((out_counts,) if counts else ()) + ((out_cycles,) if cycles else ())


def check_async_tiles(tiles) -> None:
    """What the async tile copies (16-byte chunks, TMA bulk copies) need."""
    if tiles.dim() == 3 and (tiles.shape[2] % 4 or tiles.data_ptr() % 16):
        raise ValueError(
            f"the 16-byte async tile copies need tile % 4 == 0 and 16-byte-aligned tiles, "
            f"got tile {tiles.shape[2]}, address % 16 = {tiles.data_ptr() % 16}"
        )


_CLOSEST_OUT = (torch.float32, torch.int32)


def launch_closest_hit(rays, tiles, tile_aabb, order, counts: bool = False, cycles: bool = False):
    """Launch `csrc/closest_hit.cu` on prepared rays; returns (best_t, slot),
    each (R_pad,); with `counts` also the (R_pad / GROUP_RAYS, 3) int32 per
    group [order entries walked, tiles staged, tiles scanned], and with
    `cycles` the (R_pad / GROUP_RAYS, 2) int64 per group [clock64 cycles of
    the walk, of its staging and scanning].  Raises on any input the kernel
    does not take and on a refused launch."""
    return launch_group_walk("closest_hit", 1024, _CLOSEST_OUT, rays, tiles, tile_aabb, order,
                             counts, cycles)


def launch_closest_hit_pipe(rays, tiles, tile_aabb, order, counts: bool = False,
                            cycles: bool = False):
    """Launch `csrc/closest_hit_pipe.cu` (the TMA ring); same inputs and
    outputs as `launch_closest_hit`, the same values bit for bit (counts
    apart from the tiles fetched: the ring fetches up to PIPE_RING candidates
    ahead).  It also refuses a tile width that is not a multiple of 4 and
    tiles that are not 16-byte aligned (its bulk copies move whole 16-byte
    chunks)."""
    check_async_tiles(tiles)
    return launch_group_walk("closest_hit_pipe", 512, _CLOSEST_OUT, rays, tiles, tile_aabb,
                             order, counts, cycles)


def launch_closest_hit_mxu(rays, tiles, edge_tiles, wsum, tile_aabb, order, counts: bool = False,
                           cycles: bool = False):
    """Launch `csrc/closest_hit_mxu.cu` (the TMA ring with the tensor-core
    edge prefilter) on prepared rays and the tiles of `pack_tiles` and
    `pack_edge_tiles`; (best_t, slot) as the other two kernels, the same
    values bit for bit.  With `counts` also the (R_pad / GROUP_RAYS, 5)
    int32 per group [order entries walked, tiles fetched, tiles scanned (the
    same as `launch_closest_hit_pipe`'s), pairs passed to the exact test,
    pairs the prefilter culled], and with `cycles` the (R_pad / GROUP_RAYS,
    2) int64 per group [clock64 cycles of the walk, of its waiting,
    prefiltering and scanning].  The kernel's tile width is fixed at 128."""
    check_async_tiles(tiles)
    n_tiles, _, tile = tiles.shape
    if tile != TILE:
        raise ValueError(f"the closest_hit_mxu kernel takes tiles of {TILE} triangles, got {tile}")
    _check("edge_tiles", edge_tiles, torch.bfloat16, (n_tiles, 3 * tile, EDGE_K), rays.device)
    _check("wsum", wsum, torch.float32, (n_tiles, 3, tile), rays.device)
    if edge_tiles.data_ptr() % 16 or wsum.data_ptr() % 16:
        raise ValueError("the 16-byte copies need 16-byte-aligned edge tiles and wsum")
    return launch_group_walk("closest_hit_mxu", TILE, _CLOSEST_OUT, rays, tiles, tile_aabb,
                             order, counts, cycles, extra=(edge_tiles, wsum), n_counts=5)


# ---------------------------------------------------------------------------
# The plain versions (any device)
# ---------------------------------------------------------------------------

def woop_ctx(rays: torch.Tensor):
    """Per-ray constants of the pair test, each (..., 1) for rays (..., 8)."""
    ox, oy, oz = rays[..., 0:1], rays[..., 1:2], rays[..., 2:3]
    dx_, dy_, dz_ = rays[..., 3:4], rays[..., 4:5], rays[..., 5:6]
    ax, ay, az = torch.abs(dx_), torch.abs(dy_), torch.abs(dz_)
    is2 = (az >= ax) & (az >= ay)
    is1 = (~is2) & (ay >= ax)
    is0 = ~(is1 | is2)

    def perm(vx, vy, vz):
        x = torch.where(is0, vy, torch.where(is1, vz, vx))
        y = torch.where(is0, vz, torch.where(is1, vx, vy))
        z = torch.where(is0, vx, torch.where(is1, vy, vz))
        return x, y, z

    dx, dy, dz = perm(dx_, dy_, dz_)
    return (ox, oy, oz), perm, (-dx / dz, -dy / dz, 1.0 / dz), rays[..., 6:7]


def pair_t(ctx, tv):
    """The kernels' Woop pair test of one tile against every ray: `tv` is the
    tile's ten rows, each broadcastable against the rays' (..., 1) to
    (..., tile).  Returns (t, ok): the candidate t of every pair and whether
    the ray's line meets the triangle at or above its tolerance, before the
    caller's own window."""
    (ox, oy, oz), perm, (sx, sy, sz), _ = ctx

    def corner(c):
        px, py, pz = perm(tv[3 * c + 0] - ox, tv[3 * c + 1] - oy, tv[3 * c + 2] - oz)
        return px + sx * pz, py + sy * pz, pz * sz

    x1, y1, z1 = corner(0)
    x2, y2, z2 = corner(1)
    x3, y3, z3 = corner(2)
    e1 = x2 * y3 - y2 * x3
    e2 = x3 * y1 - y3 * x1
    e3 = x1 * y2 - y1 * x2
    mixed = ((e1 < 0) | (e2 < 0) | (e3 < 0)) & ((e1 > 0) | (e2 > 0) | (e3 > 0))
    det = e1 + e2 + e3
    ts = e1 * z1 + e2 * z2 + e3 * z3
    t = ts * (1.0 / torch.where(det == 0.0, 1.0, det))
    return t, (~mixed) & (det != 0.0) & (t >= tv[9])


def _scan_tile(ctx, tv, base, lane, best_t, best_slot, columns=None):
    """One tile against every ray for the closest hit; `base` is the slot of
    the tile's first column.  Strict `<` against best_t and the first column
    at the minimum.  `columns` (bool, broadcastable to the pairs) limits the
    test to the pairs a prefilter passed."""
    t, ok = pair_t(ctx, tv)
    hit = ok & (t < best_t) & (t <= ctx[3])
    if columns is not None:
        hit = hit & columns
    t = torch.where(hit, t, _INF)
    t_min = torch.amin(t, dim=-1, keepdim=True)
    k = torch.amin(torch.where(t == t_min, lane, 2**30), dim=-1, keepdim=True)
    better = t_min < best_t
    return torch.where(better, t_min, best_t), torch.where(better, base + k, best_slot)


def closest_hit_rays_reference(rays: torch.Tensor, tiles: torch.Tensor):
    """Plain PyTorch closest hit over the packed tiles for prepared rays:
    the kernel's Woop arithmetic and axis permutation, tiles in index order
    with strict `<` across tiles and the first column at the minimum within
    a tile.  Chunked over rays to bound the pair temporaries.  Returns
    (best_t, slot), each (R_pad,)."""
    n_tiles, _, tile = tiles.shape
    out_t, out_slot = [], []
    lane = torch.arange(tile, dtype=torch.int32, device=rays.device)
    for r0 in range(0, rays.shape[0], _REFERENCE_CHUNK):
        ctx = woop_ctx(rays[r0:r0 + _REFERENCE_CHUNK])
        best_t = torch.clamp(ctx[3], max=_INF)
        best_slot = torch.full_like(best_t, -1, dtype=torch.int32)
        for ti in range(n_tiles):
            tv = [row[None, :] for row in tiles[ti]]
            best_t, best_slot = _scan_tile(ctx, tv, ti * tile, lane, best_t, best_slot)
        out_t.append(best_t[:, 0])
        out_slot.append(best_slot[:, 0])
    return torch.cat(out_t), torch.cat(out_slot)


_PIPE_REFERENCE_BLOCKS = 64  # ray blocks per pair step of the pipelined plain version


def prefilter_candidates(rays, edge_tile, wsum_tile, best_t):
    """The prefilter's verdict on every pair of a ray batch with one tile:
    (..., R, TILE) bool.  `rays` (..., R, 8), `edge_tile` (..., 3 * TILE,
    EDGE_K) bfloat16, `wsum_tile` (..., 3, TILE), `best_t` (..., R, 1).  The
    rays' [d, o x d] rounded to bfloat16, the product accumulated in float32,
    then sign-consistency of the three edge values within the margin
    `MXU_MARGIN * rmax_i * wsum_j`, for live rays (best_t > 0) only."""
    o, d = rays[..., 0:3], rays[..., 3:6]
    moment = torch.stack([o[..., 1] * d[..., 2] - o[..., 2] * d[..., 1],
                          o[..., 2] * d[..., 0] - o[..., 0] * d[..., 2],
                          o[..., 0] * d[..., 1] - o[..., 1] * d[..., 0]], dim=-1)  # o x d
    rv = torch.cat([d, moment], dim=-1)
    rmax = torch.amax(torch.abs(rv), dim=-1, keepdim=True)
    w = edge_tile[..., 0:6].to(torch.float32)
    # (..., R, 3 TILE)
    e = torch.matmul(rv.to(torch.bfloat16).to(torch.float32), w.transpose(-1, -2))
    tile = wsum_tile.shape[-1]
    margin = (MXU_MARGIN * rmax) * wsum_tile.reshape(*wsum_tile.shape[:-2], 1, 3 * tile)
    e = e.reshape(*e.shape[:-1], 3, tile)
    margin = margin.reshape(*margin.shape[:-1], 3, tile)
    pos = torch.all(e >= -margin, dim=-2)
    neg = torch.all(e <= margin, dim=-2)
    return (pos | neg) & (best_t > 0.0)


def closest_hit_pipe_reference(rays, tiles, tile_aabb, order, ring: int = PIPE_RING):
    """Plain PyTorch version of `csrc/closest_hit_pipe.cu`'s walk (see
    `_group_walk`), and with `ring=0` of `csrc/closest_hit.cu`'s, which
    stages only what it scans.  Returns (best_t, slot, counts): (R_pad,),
    (R_pad,) and (R_pad / GROUP_RAYS, 3) int32 per group [order entries
    walked, tiles fetched, tiles scanned]."""
    return _group_walk(rays, tiles, tile_aabb, order, ring)


def closest_hit_block_reference(rays, tiles, tile_aabb, order):
    """The 128-ray block walk (`_pipe_walk`): the TPU kernel's own walk and,
    before the group walk, the port's.  Returns (best_t, slot, counts),
    counts (R_pad / 128, 3) int32 per block [tile steps walked, tiles
    fetched, tiles scanned]; (best_t, slot) equal the group walk's."""
    return _pipe_walk(rays, tiles, tile_aabb, order)


def closest_hit_mxu_reference(rays, tiles, edge_tiles, wsum, tile_aabb, order):
    """Plain PyTorch version of `csrc/closest_hit_mxu.cu`: the group walk
    (`_group_walk`, with the ring of PIPE_RING buffers) with the edge
    prefilter in front of the pair test of every scanned tile
    (`prefilter_candidates`; the exact test runs on the columns that are
    candidates for some ray of the group, for all of its rays).  Returns
    (best_t, slot, counts), counts (R_pad / GROUP_RAYS, 5): walked, fetched,
    scanned (equal to `closest_hit_pipe_reference`'s), pairs passed to the
    exact test, pairs culled.  (best_t, slot) equal
    `closest_hit_pipe_reference`'s bit for bit."""
    return _group_walk(rays, tiles, tile_aabb, order, PIPE_RING, (edge_tiles, wsum))


def _pipe_walk(rays, tiles, tile_aabb, order):
    """The 128-ray block walk in plain PyTorch (the walk of the TPU kernel
    and, before the group walk, of B1, B2 and B5; kept as the yardstick of
    the group walk): every ray block walks its own row of `order` tile by
    tile with the Chebyshev early exit, the block slab vote and the lagging
    prefetch decision (tile j+1 is "fetched" on the best_t from before tile
    j's pairs; tile j is scanned only if it was fetched and the walk still
    goes on).  All blocks advance one tile step together; pair work is done
    only for the blocks that scan at that step.  Returns (best_t, slot,
    counts), counts (R_pad / 128, 3)."""
    n_blocks, n_tiles = order.shape
    tile = tiles.shape[2]
    dev = rays.device
    rb = rays.reshape(n_blocks, RAY_BLOCK, 8)
    o, d = rb[..., 0:3], rb[..., 3:6]
    b_lo, b_hi = torch.amin(o, dim=1), torch.amax(o, dim=1)
    dmax = torch.amax(torch.abs(d), dim=(1, 2))
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    lane = torch.arange(tile, dtype=torch.int32, device=dev)
    order = order.long()

    best_t = torch.clamp(rb[..., 6:7], max=_INF)  # (B, 128, 1)
    best_slot = torch.full_like(best_t, -1, dtype=torch.int32)

    def lower_bound(ti):
        box = tile_aabb[ti]
        gap = torch.maximum(box[:, 0:3] - b_hi, b_lo - box[:, 3:6])
        return torch.clamp(torch.amax(gap, dim=-1), min=0.0)

    def slab_vote(ti):
        box = tile_aabb[ti][:, None, :]
        t0 = (box[..., 0:3] - o) * inv_d
        t1 = (box[..., 3:6] - o) * inv_d
        tlo = torch.amax(torch.minimum(t0, t1), dim=-1)
        thi = torch.amin(torch.maximum(t0, t1), dim=-1)
        ok = (thi >= tlo) & (thi > 0.0) & (torch.clamp(tlo, min=0.0) < best_t[..., 0])
        return torch.any(ok, dim=1)

    ti_cur = order[:, 0]
    reach = torch.amax(best_t, dim=(1, 2)) * dmax
    fetched_cur = (lower_bound(ti_cur) * _LB_SLACK < reach) & slab_vote(ti_cur)
    walking = torch.ones((n_blocks,), dtype=torch.bool, device=dev)
    counts = torch.zeros((n_blocks, 3), dtype=torch.int32, device=dev)
    counts[:, 1] += fetched_cur
    for j in range(n_tiles):
        if not bool(walking.any()):
            break
        counts[:, 0] += walking
        has_next = j + 1 < n_tiles
        ti_next = order[:, j + 1] if has_next else ti_cur
        reach = torch.amax(best_t, dim=(1, 2)) * dmax
        improve = lower_bound(ti_cur) * _LB_SLACK < reach
        if has_next:
            fetched_next = (walking & improve & (lower_bound(ti_next) * _LB_SLACK < reach)
                            & slab_vote(ti_next))
        else:
            fetched_next = torch.zeros_like(walking)
        counts[:, 1] += fetched_next

        scan = torch.nonzero(walking & fetched_cur & improve)[:, 0]
        counts[scan, 2] += 1
        for c0 in range(0, scan.shape[0], _PIPE_REFERENCE_BLOCKS):
            blk = scan[c0:c0 + _PIPE_REFERENCE_BLOCKS]
            ti = ti_cur[blk]
            tv = [tiles[ti, row][:, None, :] for row in range(_TILE_ROWS)]
            base = (ti * tile).to(torch.int32)[:, None, None]
            best_t[blk], best_slot[blk] = _scan_tile(
                woop_ctx(rb[blk]), tv, base, lane, best_t[blk], best_slot[blk])

        walking = walking & improve
        fetched_cur, ti_cur = fetched_next, ti_next
    return best_t.reshape(-1), best_slot.reshape(-1), counts


_GROUP_REFERENCE_GROUPS = 256  # groups per pair step of the group walk's plain version


def _group_walk(rays, tiles, tile_aabb, order, ring, edge=None, window=False):
    """The tile kernels' group walk (`csrc/closest_hit_common.cuh`) in plain
    PyTorch.  Each group of GROUP_RAYS rays walks the row of `order` of its
    128-ray block, WALK_BATCH entries at a time, against its rays' budgets:
    the Chebyshev bound of each entry from the row's origin box, the first
    entry that no ray of the group can reach (bound * (1 - 1e-6) >= max
    budget * the row's max |d|_inf) ending the walk there, the slab votes of
    every ray against its budget at the start of the batch, then the voted
    entries in order, each re-checked against the group's up-to-date max
    budget (a failed re-check ends the walk) and scanned.  All groups advance
    one batch, then one batch position, together; pair work is done only for
    the groups that scan at that position.  Counts per group: [entries walked
    (up to the one at which the walk ended), tiles fetched, tiles scanned],
    where a ring of `ring` buffers fetches up to `ring` candidates of a batch
    ahead (0: only what is scanned).

    The closest hit (default): the budget is the ray's best t; returns
    (best_t, slot, counts).  `edge` = (edge_tiles, wsum) puts the prefilter
    in front of the pairs (the union of a group's candidates, with the best_t
    each ray starts the tile with) and adds two counts: pairs passed to the
    exact test (the union's columns x GROUP_RAYS) and pairs culled.

    `window`: the any hit of window rays; the budget is -1 once the near bit
    is set, t_near once only the far bit is, else t_cap; a ray whose budget
    is below 0 at a tile's start does no pair test; returns (occ_near,
    occ_far, counts)."""
    n_rows, n_tiles = order.shape
    tile = tiles.shape[2]
    dev = rays.device
    per_row = RAY_BLOCK // GROUP_RAYS
    n_groups = n_rows * per_row
    rb = rays.reshape(n_rows, RAY_BLOCK, 8)
    row = torch.arange(n_groups, device=dev) // per_row
    b_lo = torch.amin(rb[..., 0:3], dim=1)[row, None, :]  # (G, 1, 3)
    b_hi = torch.amax(rb[..., 0:3], dim=1)[row, None, :]
    dmax = torch.amax(torch.abs(rb[..., 3:6]), dim=(1, 2))[row]  # (G,)
    gr = rays.reshape(n_groups, GROUP_RAYS, 8)
    o, d = gr[:, :, None, 0:3], gr[:, :, None, 3:6]  # (G, R, 1, 3)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    lane = torch.arange(tile, dtype=torch.int32, device=dev)
    order = order.long()[row]  # (G, NT)

    if window:
        t_cap, t_near = gr[..., 6:7], gr[..., 7:8]  # (G, R, 1)
        near = torch.zeros_like(t_cap, dtype=torch.bool)
        far = torch.zeros_like(near)
    else:
        best_t = torch.clamp(gr[..., 6:7], max=_INF)  # (G, R, 1)
        best_slot = torch.full_like(best_t, -1, dtype=torch.int32)

    def budget(at):
        if window:
            return torch.where(near[at], -1.0, torch.where(far[at], t_near[at], t_cap[at]))
        return best_t[at]

    def scan(grp, ti):
        tv = [tiles[ti, r][:, None, :] for r in range(_TILE_ROWS)]
        if window:
            t, ok = pair_t(woop_ctx(gr[grp]), tv)
            hit_far = ok & (t <= t_cap[grp]) & (budget(grp) >= 0.0)
            near[grp] |= torch.any(hit_far & (t < t_near[grp]), dim=-1, keepdim=True)
            far[grp] |= torch.any(hit_far, dim=-1, keepdim=True)
            return
        columns = None
        if edge is not None:
            pairs = prefilter_candidates(gr[grp], edge[0][ti], edge[1][ti], best_t[grp])
            columns = torch.any(pairs, dim=1, keepdim=True)  # (n, 1, TILE)
            passed = (torch.sum(columns, dim=(1, 2)) * GROUP_RAYS).to(torch.int32)
            counts[grp, 3] += passed
            counts[grp, 4] += GROUP_RAYS * tile - passed
        base = (ti * tile).to(torch.int32)[:, None, None]
        best_t[grp], best_slot[grp] = _scan_tile(
            woop_ctx(gr[grp]), tv, base, lane, best_t[grp], best_slot[grp], columns)

    everyone = torch.arange(n_groups, device=dev)
    counts = torch.zeros((n_groups, 3 if edge is None else 5), dtype=torch.int32, device=dev)
    walking = torch.ones((n_groups,), dtype=torch.bool, device=dev)
    for s in range(0, n_tiles, WALK_BATCH):
        if not bool(walking.any()):
            break
        nb = min(WALK_BATCH, n_tiles - s)
        ent = order[:, s:s + nb]  # (G, nb)
        box = tile_aabb[ent]  # (G, nb, 8)
        gap = torch.maximum(box[..., 0:3] - b_hi, b_lo - box[..., 3:6])
        lb = torch.clamp(torch.amax(gap, dim=-1), min=0.0)  # (G, nb)
        start = budget(everyone)  # (G, R, 1)
        reach = torch.amax(start, dim=(1, 2)) * dmax
        stops = ~(lb * _LB_SLACK < reach[:, None])
        stop = torch.where(stops.any(dim=1), torch.argmax(stops.to(torch.int32), dim=1), nb)
        t0 = (box[:, None, :, 0:3] - o) * inv_d  # (G, R, nb, 3)
        t1 = (box[:, None, :, 3:6] - o) * inv_d
        tlo = torch.amax(torch.minimum(t0, t1), dim=-1)
        thi = torch.amin(torch.maximum(t0, t1), dim=-1)
        votes = ((thi >= tlo) & (thi > 0.0) & (torch.clamp(tlo, min=0.0) < start)).any(dim=1)
        pos = torch.arange(nb, device=dev)
        cand = votes & (pos[None, :] < stop[:, None]) & walking[:, None]
        n_cand = cand.sum(dim=1, dtype=torch.int32)
        in_batch = walking.clone()
        exit_at = torch.full((n_groups,), -1, dtype=torch.long, device=dev)
        scanned = torch.zeros((n_groups,), dtype=torch.int32, device=dev)
        for k in torch.nonzero(cand.any(dim=0))[:, 0].tolist():  # positions some group votes for
            at = torch.nonzero(in_batch & cand[:, k])[:, 0]
            if at.shape[0] == 0:
                continue
            reach = torch.amax(budget(at), dim=(1, 2)) * dmax[at]
            ok = lb[at, k] * _LB_SLACK < reach
            fail = at[~ok]
            in_batch[fail] = False
            exit_at[fail] = k
            go = at[ok]
            scanned[go] += 1
            for c0 in range(0, go.shape[0], _GROUP_REFERENCE_GROUPS):
                grp = go[c0:c0 + _GROUP_REFERENCE_GROUPS]
                scan(grp, ent[grp, k])
        ended = exit_at >= 0
        stopped = ~ended & (stop < nb)
        walked = torch.where(ended, s + exit_at + 1, torch.where(stopped, s + stop + 1, s + nb))
        counts[:, 0] = torch.where(walking, walked.to(torch.int32), counts[:, 0])
        counts[:, 1] += torch.where(ended, torch.minimum(n_cand, scanned + ring), n_cand)
        counts[:, 2] += scanned
        walking = walking & ~ended & ~stopped
    if window:
        return near.reshape(-1), far.reshape(-1), counts
    return best_t.reshape(-1), best_slot.reshape(-1), counts


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _finish(t, slot, r):
    t, slot = t[:r], slot[:r]
    hit = slot >= 0
    return torch.where(hit, t, float("inf")), slot, hit


def closest_hit_tiles(tiles, tile_aabb, origin, direction, t_max=float("inf"), big=False,
                      edge=None):
    """Closest hit for a ray batch: (t, slot, hit), slot a row of the sorted
    SoA and -1 on a miss, t = +inf on a miss.  CUDA tensors go through a
    kernel (one launch per call): with `big` the ring-buffered one, or, when
    `edge` = (edge_tiles, wsum) of `pack_edge_tiles` is given, the one with
    the edge prefilter; else the plain-load one.  CPU tensors go through
    the matching plain version.  Not differentiable: recompute winner
    attributes outside (`ops.trace.winner_bary`)."""
    if edge is not None and not big:
        raise ValueError("the edge prefilter belongs to the ring-buffered route (big=True)")
    r = origin.shape[0]
    with torch.no_grad():
        rays = prepare_rays(tile_aabb, origin, direction, t_max)
        if rays.device.type == "cuda":
            order = block_tile_order(rays, tile_aabb, rays.shape[0] // RAY_BLOCK)
            if edge is not None:
                t, slot = launch_closest_hit_mxu(rays, tiles, edge[0], edge[1], tile_aabb, order)
            elif big:
                t, slot = launch_closest_hit_pipe(rays, tiles, tile_aabb, order)
            else:
                t, slot = launch_closest_hit(rays, tiles, tile_aabb, order)
        elif rays.device.type == "cpu":
            with tracing.span("kernel.closest_hit"):  # the kernel's plain version
                t, slot = _reference(rays, tiles, tile_aabb, big, edge)
        else:
            raise ValueError(f"closest_hit_tiles runs on cuda or cpu, got {rays.device}")
    return _finish(t, slot, r)


def _reference(rays, tiles, tile_aabb, big, edge=None):
    if not big:
        return closest_hit_rays_reference(rays, tiles)
    order = block_tile_order(rays, tile_aabb, rays.shape[0] // RAY_BLOCK)
    return _group_walk(rays, tiles, tile_aabb, order, PIPE_RING, edge)[:2]


def closest_hit_tiles_reference(tiles, tile_aabb, origin, direction, t_max=float("inf"),
                                big=False, edge=None):
    """The plain version of `closest_hit_tiles` on any device (no kernel)."""
    r = origin.shape[0]
    with torch.no_grad():
        rays = prepare_rays(tile_aabb, origin, direction, t_max)
        t, slot = _reference(rays, tiles, tile_aabb, big, edge)
    return _finish(t, slot, r)
