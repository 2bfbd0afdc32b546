"""Ray-scene intersection dispatch (port of `gpu_pathtracer_tpu.ops.trace`).

Every closest-hit query goes through the tile query of `ops/closest_hit.py`:
on a CUDA device that is a hand-written kernel, on the CPU the kernel's
plain version.  Scenes above `PALLAS_MAX` triangle rows take the
double-buffered kernel (`csrc/closest_hit_pipe.cu`), as they take the
HBM-resident kernel in the reference package, or, when the geometry set
carries the prefilter's edge tiles (`build_scene(edge_prefilter=True)`),
`csrc/closest_hit_mxu.cu`; smaller scenes take `csrc/closest_hit.cu`.  Large
wavefronts are first sorted for coherence so that the kernels' per-block
tile cull and early exit fire.  Hits are reported in sorted-SoA slots (rows
of `GeometrySet.p`), with barycentrics recomputed differentiably for the
winner.  A query is the span `dispatch.closest_hit` of the port's tracer
(`tracing`), the kernel's launch inside it `kernel.closest_hit`.

Around the tile kernel, a query on CUDA tensors where no gradient is asked
for runs three kernels of its own (`launch_query`): `csrc/query_key.cu`
writes the coherence key as int32 for `torch.sort`, `csrc/query_pack.cu`
gathers, parks and packs the sorted rays with their budgets, and
`csrc/query_finish.cu` scatters the results back with the winner's
barycentrics.  `closest_hit_reference`, the torch ops they replace, is the
plain version: it serves CPU tensors, gradients and the tests.

The windowed any-hit query (`occluded_window`, the photon gathers'
visibility re-check) goes through `ops/anyhit.py` by the same rules:
`csrc/anyhit_pipe.cu` above `PALLAS_MAX`, `csrc/anyhit.cu` below, the plain
versions on the CPU; its spans are `dispatch.anyhit` and `kernel.anyhit`.
"""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops import _build, intersect, morton, route
from gpu_pathtracer_tpu_torch.ops.anyhit import occluded_window_tiles
from gpu_pathtracer_tpu_torch.ops.closest_hit import RAY_BLOCK, closest_hit_tiles, launch_walk

# triangle rows (of the sorted, padded SoA) above which a scene's queries run
# on the double-buffered kernel; the reference package's cap of its
# VMEM-resident kernel, kept as the dispatch rule
PALLAS_MAX = 131072
# sort rays for coherence at and above this batch size ...
RAY_SORT_MIN = 8192
# ... when the scene has at least this many tiles
RAY_SORT_MIN_TILES = 2
# 8-byte fields of the query kernels' argument blocks (their `Args`)
_KEY_SLOTS, _PACK_SLOTS, _FINISH_SLOTS = 11, 13, 12


def coherence_perm(g, origin, direction, live=None) -> torch.Tensor:
    """Permutation putting rays in (live, origin-Morton, direction-octant)
    order; dead rays sort last, into dead-only groups whose budget of -1
    ends their walk at once.  Stable, so equal keys keep ray order."""
    lo = torch.amin(g.tile_aabb[:, 0:3], dim=0)
    hi = torch.amax(g.tile_aabb[:, 3:6], dim=0)
    span = torch.clamp(hi - lo, min=1e-12)
    octant = (
        (direction[:, 0] > 0).to(torch.int64) * 4
        + (direction[:, 1] > 0).to(torch.int64) * 2
        + (direction[:, 2] > 0).to(torch.int64)
    )
    q = torch.clamp((origin - lo) / span * 64.0, 0.0, 63.0).to(torch.int64)
    m = (
        morton.expand_bits(q[:, 0]) * 4
        + morton.expand_bits(q[:, 1]) * 2
        + morton.expand_bits(q[:, 2])
    )
    key = (m << 3) | octant
    if live is not None:
        key = key | torch.where(live, 0, 1 << 21)
    return torch.sort(key, stable=True).indices


def pallas_big(g) -> bool:
    """Whether the scene's queries take the double-buffered kernels."""
    return g.p.shape[0] > PALLAS_MAX


def park_dead(g, origin, direction, live):
    """Dead rays moved to a corner of the scene's root box, pointing along z.
    A dead ray's result is never used, but its origin and direction still
    enter its 128-ray row's origin box and |d| bound, and a stale NaN or
    infinity there (an absorbed photon's direction, an invalid hit point)
    would cull the row's live rays too."""
    corner = torch.amin(g.tile_aabb[:, 0:3], dim=0)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=origin.device)
    return (torch.where(live[:, None], origin, corner),
            torch.where(live[:, None], direction, z_axis))


def edge_operand(g):
    """The prefilter's (edge_tiles, wsum) when the set's closest-hit queries
    take the kernel with the edge prefilter, else None.  A set without the
    fields (any object with `p`, `tiles` and `tile_aabb` serves as one) has
    none."""
    edge_tiles = getattr(g, "edge_tiles", None)
    if pallas_big(g) and edge_tiles is not None:
        return edge_tiles, g.edge_wsum
    return None


def _sorts(g, r: int) -> bool:
    return r >= RAY_SORT_MIN and g.tiles.shape[0] >= RAY_SORT_MIN_TILES


def _inverse(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def closest_hit_sorted(g, origin, direction, t_max=float("inf"), live=None):
    """Closest hit with coherence-sorted rays.  `live` marks rays whose
    result is used: the others get a budget of -1 and miss without work.
    Returns (t, slot, hit) in the caller's ray order."""
    r = origin.shape[0]
    big, edge = pallas_big(g), edge_operand(g)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device).expand(r)
    if live is not None:
        t_max = torch.where(live, t_max, -1.0)
        origin, direction = park_dead(g, origin, direction, live)
    if not _sorts(g, r):
        return closest_hit_tiles(g.tiles, g.tile_aabb, origin, direction, t_max, big=big,
                                 edge=edge)
    perm = coherence_perm(g, origin, direction, live)
    t, slot, hit = closest_hit_tiles(
        g.tiles, g.tile_aabb, origin[perm], direction[perm], t_max[perm], big=big, edge=edge
    )
    inv = _inverse(perm)
    return t[inv], slot[inv], hit[inv]


def winner_bary(p, tol, origin, direction, slot, hit, attr=None) -> torch.Tensor:
    """Barycentrics of the winning triangle, recomputed differentiably for
    that one candidate (from the packed `attr` row when given)."""
    safe = torch.clamp(slot, min=0).long()
    if attr is not None:
        rows = attr[safe]
        tri_w = rows[:, 0:9].reshape(-1, 3, 3)
        tol_w = rows[:, 24]
    else:
        tri_w = p[safe]
        tol_w = tol[safe]
    _, bary_w, _ = intersect.intersect_tris(
        origin, direction, tri_w[:, None], tol_w[:, None], float("inf")
    )
    return torch.where(hit[:, None], bary_w[:, 0], 0.0)


def closest_hit(g, origin, direction, t_max=float("inf"), live=None, kernels: bool = True):
    """Closest hit against a GeometrySet: (t, slot, bary, hit).  Where the
    caller allows `kernels`, autograd records nothing for the rays and the
    set's attr rows (`route.records_nothing`), `t_max` is a number and the
    set carries `attr`: `closest_hit_query`; else its plain version."""
    with tracing.span("dispatch.closest_hit"):
        if (kernels and isinstance(t_max, (int, float)) and getattr(g, "attr", None) is not None
                and route.records_nothing(origin, direction, g.attr)):
            return closest_hit_query(g, origin, direction, t_max, live)
        return closest_hit_reference(g, origin, direction, t_max, live)


def closest_hit_reference(g, origin, direction, t_max=float("inf"), live=None):
    """The plain version of the query's kernels (any device; the
    barycentrics differentiable): `closest_hit_sorted`, then `winner_bary`."""
    t, slot, hit = closest_hit_sorted(g, origin, direction, t_max, live)
    bary = winner_bary(g.p, g.tol, origin, direction, slot, hit, attr=g.attr)
    return t, slot, bary, hit


def closest_hit_query(g, origin, direction, t_max, live):
    """`launch_query` for CUDA tensors (not differentiable),
    `closest_hit_reference` for others."""
    if origin.device.type == "cuda":
        return launch_query(g, origin, direction, t_max, live)
    return closest_hit_reference(g, origin, direction, t_max, live)


@_build.derived(lambda g: (g.tile_aabb,))
def root_box(g):
    """The scene's root box as the query kernels read it, (3, 3) float32
    rows: the low corner (`park_dead`'s corner), `coherence_perm`'s span,
    and `closest_hit.root_exit_cap`'s high corner over the non-empty tiles;
    by the same torch ops (a min or max is exact)."""
    lo_all, hi_all = g.tile_aabb[:, 0:3], g.tile_aabb[:, 3:6]
    lo = torch.amin(lo_all, dim=0)
    span = torch.clamp(torch.amax(hi_all, dim=0) - lo, min=1e-12)
    hi = torch.amax(torch.where(hi_all >= lo_all, hi_all, float("-inf")), dim=0)
    return torch.stack([lo, span, hi]).detach().contiguous()


def _query_rays(origin, direction, live):
    """The query kernels' ray fields: (R, 3) float32 origins and directions
    and (R,) bool live flags or (null, 0), any strides."""
    r, dev = origin.shape[0], origin.device
    for name, x, dtype, shape in (("origin", origin, torch.float32, (r, 3)),
                                  ("direction", direction, torch.float32, (r, 3)),
                                  ("live", live, torch.bool, (r,))):
        if x is not None and (x.dtype != dtype or tuple(x.shape) != shape or x.device != dev):
            raise ValueError(f"the query takes {name} {tuple(shape)} {dtype} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return (origin, direction) + ((live,) if live is not None else (0, 0))


def launch_query_key(g, origin, direction, live=None) -> torch.Tensor:
    """Launch `csrc/query_key.cu`: `coherence_perm`'s key of each ray as
    (R,) int32; `torch.sort(key, stable=True).indices` is its permutation."""
    key = torch.empty((origin.shape[0],), dtype=torch.int32, device=origin.device)
    block = _build.arg_block((*_query_rays(origin, direction, live), root_box(g).data_ptr(),
                              key.data_ptr(), origin.shape[0]), _KEY_SLOTS)
    _build.launch("query_key", (_build.PTR,), origin.device, block)
    return key


def launch_query_pack(g, origin, direction, t_max, live=None, perm=None) -> torch.Tensor:
    """Launch `csrc/query_pack.cu`: `prepare_rays`' (R_pad, 8) rows of the
    rays in `perm`'s order (None: the caller's), dead ones parked as
    `park_dead` parks them with a budget of -1, live ones with `t_max`."""
    r = origin.shape[0]
    rays = torch.empty((r + (-r) % RAY_BLOCK, 8), dtype=torch.float32, device=origin.device)
    block = _build.arg_block((perm.data_ptr() if perm is not None else 0,
                              *_query_rays(origin, direction, live), root_box(g).data_ptr(),
                              rays.data_ptr(), r, rays.shape[0]), _PACK_SLOTS)
    _build.launch("query_pack", (_build.PTR, _build.FLOAT), origin.device, block, float(t_max))
    return rays


def launch_query_finish(g, perm, t, slot, rays, r):
    """Launch `csrc/query_finish.cu` on the tile kernel's (R_pad,) best t and
    slot of the packed `rays` in `perm`'s order: (t, slot, bary, hit) of the
    r rays in the caller's order."""
    dev = rays.device
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((r,), dtype=torch.int32, device=dev)
    hit = torch.empty((r,), dtype=torch.bool, device=dev)
    bary = torch.empty((r, 3), dtype=torch.float32, device=dev)
    attr = g.attr
    if attr.dtype != torch.float32 or attr.dim() != 2 or attr.shape[1] < 9 or attr.device != dev:
        raise ValueError(f"the query reads (T, 26) float32 attr rows on {dev}, got "
                         f"{tuple(attr.shape)} {attr.dtype} on {attr.device}")
    block = _build.arg_block((perm.data_ptr() if perm is not None else 0, t.data_ptr(),
                              slot.data_ptr(), rays.data_ptr(), attr, out_t.data_ptr(),
                              out_slot.data_ptr(), hit.data_ptr(), bary.data_ptr(), r),
                             _FINISH_SLOTS)
    _build.launch("query_finish", (_build.PTR,), dev, block)
    return out_t, out_slot, bary, hit


def launch_query(g, origin, direction, t_max=float("inf"), live=None):
    """The query on the card: where the batch sorts (`_sorts`), the key
    kernel and a stable `torch.sort` of its int32 keys; the pack kernel;
    `block_tile_order` and the tile kernel (`closest_hit.launch_walk`); the
    finish kernel.  (t, slot, bary, hit) bit for bit as
    `closest_hit_reference`'s."""
    r = origin.shape[0]
    perm = None
    if _sorts(g, r):
        perm = torch.sort(launch_query_key(g, origin, direction, live), stable=True).indices
    rays = launch_query_pack(g, origin, direction, t_max, live, perm)
    t, slot = launch_walk(rays, g.tiles, g.tile_aabb, pallas_big(g), edge_operand(g))
    return launch_query_finish(g, perm, t, slot, rays, r)


def occluded_window_sorted(g, origin, direction, t_near, t_far=float("inf"), live=None):
    """Windowed any-hit with coherence-sorted rays: first accepted hit, no
    best-t refinement, a group of rays leaves its walk once every ray of it
    is settled.
    Returns (occ_near, occ_far) in the caller's ray order; dead rays
    (live False) get both caps -1 and report (False, False)."""
    r = origin.shape[0]
    dev = origin.device
    big = pallas_big(g)
    t_near = torch.as_tensor(t_near, dtype=torch.float32, device=dev).expand(r)
    t_far = torch.as_tensor(t_far, dtype=torch.float32, device=dev).expand(r)
    if live is not None:
        t_far = torch.where(live, t_far, -1.0)
        t_near = torch.where(live, t_near, -1.0)
        origin, direction = park_dead(g, origin, direction, live)
    if not _sorts(g, r):
        return occluded_window_tiles(g.tiles, g.tile_aabb, origin, direction, t_near, t_far,
                                     big=big)
    perm = coherence_perm(g, origin, direction, live)
    occ_n, occ_f = occluded_window_tiles(
        g.tiles, g.tile_aabb, origin[perm], direction[perm], t_near[perm], t_far[perm], big=big
    )
    inv = _inverse(perm)
    return occ_n[inv], occ_f[inv]


def occluded_window(g, origin, direction, t_near, t_far=float("inf"), live=None):
    """Windowed any-hit against a GeometrySet: (occ_near, occ_far) = ("some
    hit with t < t_near", "some hit with t <= t_far").  The photon gathers'
    visibility verdict is `occ_far & ~occ_near` with t_near = len * (1 - tol)
    and t_far = inf.  On a CUDA device this is one launch of an any-hit
    kernel, on the CPU the kernel's plain version; the bits equal those
    derived from the closest hit (hit & t < t_near, hit & t <= t_far)."""
    with tracing.span("dispatch.anyhit"):
        return occluded_window_sorted(g, origin, direction, t_near, t_far, live)
