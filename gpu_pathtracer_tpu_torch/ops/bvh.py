"""LBVH: Karras-2012 radix-tree build + threaded (stackless) layout (port of
`gpu_pathtracer_tpu.ops.bvh`).

The path-tracing slice needs the Morton `order` (it sorts the triangle SoA
that the closest-hit tiles are packed from) and the full topology (the light
tree is a `leaf_size=1` BVH).  The build's fixed-point loops run eagerly and
stop when nothing changes; they run once per scene.

Node indexing: one unified array of 2M-1 nodes for M leaves; internal nodes
are 0..M-2 (0 = root), leaf k is node (M-1)+k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.ops import morton

_BIG = 3.4e38


@dataclasses.dataclass
class BVH:
    aabb_min: torch.Tensor  # (2M-1, 3)
    aabb_max: torch.Tensor  # (2M-1, 3)
    escape: torch.Tensor  # (2M-1,) int32: next node on miss; -1 ends traversal
    left: torch.Tensor  # (2M-1,) int32: next node on hit (leaf: == escape)
    parent: torch.Tensor  # (2M-1,) int32 (-1 for root)
    order: torch.Tensor  # (M * leaf_size,) int32 original prim index, -1 = pad
    num_leaves: int = 1
    leaf_size: int = 4


def _karras_topology(codes: torch.Tensor, n: int):
    """Left/right children (unified ids) and parents of the radix tree over
    n sorted codes."""
    dev = codes.device
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)

    def delta(a, b):
        return morton.lcp(codes, a, b, n)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # upper bound for the range length by doubling
    n_steps = max(int(n - 1).bit_length() + 1, 1)
    l_max = torch.full_like(i, 2)
    for _ in range(n_steps):
        cond = delta(i, i + l_max * d) > delta_min
        l_max = torch.where(cond, l_max * 2, l_max)

    # binary search for the exact range end
    l = torch.zeros_like(i)
    t = l_max
    for _ in range(n_steps + 1):
        t = torch.clamp(t // 2, min=0)
        take = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(take, l + t, l)
    j = i + l * d
    delta_node = delta(i, j)

    # binary search for the split position
    s = torch.zeros_like(i)
    t = l
    while bool(torch.any(t > 0)):
        t_new = torch.clamp((t + 1) // 2, min=1)
        take = delta(i, i + (s + t_new) * d) > delta_node
        s = torch.where(take, s + t_new, s)
        t = torch.where(t_new == 1, 0, t_new)
    gamma = i + s * d + torch.clamp(d, max=0)

    leaf_base = n - 1
    left_is_leaf = torch.minimum(i, j) == gamma
    right_is_leaf = torch.maximum(i, j) == gamma + 1
    left = torch.where(left_is_leaf, gamma + leaf_base, gamma)
    right = torch.where(right_is_leaf, gamma + 1 + leaf_base, gamma + 1)

    parent = torch.full((2 * n - 1,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i
    return left, right, parent


def _fixed_point_refit(left, right, leaf_min, leaf_max, num_internal: int):
    """Deterministic bottom-up AABB fit: recompute every internal box from its
    children until nothing changes."""
    amin = torch.cat([torch.full((num_internal, 3), _BIG, dtype=leaf_min.dtype,
                                 device=leaf_min.device), leaf_min])
    amax = torch.cat([torch.full((num_internal, 3), -_BIG, dtype=leaf_max.dtype,
                                 device=leaf_max.device), leaf_max])
    while True:
        new_min = torch.minimum(amin[left], amin[right])
        new_max = torch.maximum(amax[left], amax[right])
        changed = bool(torch.any(new_min != amin[:num_internal])) or bool(
            torch.any(new_max != amax[:num_internal])
        )
        amin = torch.cat([new_min, amin[num_internal:]])
        amax = torch.cat([new_max, amax[num_internal:]])
        if not changed:
            return amin, amax


def _escape_links(left, right, parent, total: int):
    """Threaded-DFS miss links: escape(n) = right sibling if n is a left
    child, else escape(parent); the root's is -1."""
    node_ids = torch.arange(total, dtype=torch.int64, device=left.device)
    par_safe = torch.clamp(parent, min=0)
    is_left = (parent >= 0) & (left[par_safe] == node_ids)
    sibling = right[par_safe]
    esc = torch.where(is_left, sibling, -1)
    while True:
        new = torch.where(is_left, sibling, torch.where(parent >= 0, esc[par_safe], -1))
        if not bool(torch.any(new != esc)):
            return new
        esc = new


def build_bvh(prim_min: torch.Tensor, prim_max: torch.Tensor, leaf_size: int = 4) -> BVH:
    """Threaded LBVH over N primitives; leaf k owns
    `order[k*L:(k+1)*L]` (original rows, -1 padded)."""
    n = prim_min.shape[0]
    dev = prim_min.device
    centers = 0.5 * (prim_min + prim_max)
    codes = morton.morton_3d(morton.normalized_centroids(centers))
    # stable: equal codes keep index order, as the reference's sort does
    codes_sorted, order_sorted = torch.sort(codes, stable=True)

    m = -(-n // leaf_size)
    pad = m * leaf_size - n
    order_padded = torch.cat(
        [order_sorted, torch.full((pad,), -1, dtype=torch.int64, device=dev)]
    )
    slot_prim = torch.clamp(order_padded, min=0).reshape(m, leaf_size)
    slot_valid = (order_padded >= 0).reshape(m, leaf_size)

    mins = torch.where(slot_valid[..., None], prim_min[slot_prim], _BIG)
    maxs = torch.where(slot_valid[..., None], prim_max[slot_prim], -_BIG)
    leaf_min = torch.amin(mins, dim=1)
    leaf_max = torch.amax(maxs, dim=1)
    order32 = order_padded.to(torch.int32)

    if m == 1:
        minus1 = torch.full((1,), -1, dtype=torch.int32, device=dev)
        return BVH(leaf_min, leaf_max, minus1, minus1.clone(), minus1.clone(),
                   order32, num_leaves=1, leaf_size=leaf_size)

    leaf_codes = codes_sorted[::leaf_size][:m]
    left, right, parent = _karras_topology(leaf_codes, m)
    amin, amax = _fixed_point_refit(left, right, leaf_min, leaf_max, m - 1)
    escape = _escape_links(left, right, parent, 2 * m - 1)
    hit_link = torch.cat([left, escape[m - 1:]])
    return BVH(
        aabb_min=amin,
        aabb_max=amax,
        escape=escape.to(torch.int32),
        left=hit_link.to(torch.int32),
        parent=parent.to(torch.int32),
        order=order32,
        num_leaves=m,
        leaf_size=leaf_size,
    )


def ray_box_test(o, inv_d, box_min, box_max, t_max) -> torch.Tensor:
    """Slab test of rays (origin, 1 / direction) against boxes, within t_max."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tmax >= tmin) & (tmax > 0.0) & (tmin < t_max)


def validate(bvh: BVH, prim_min=None, prim_max=None, atol: float = 1e-5) -> dict:
    """Structural invariant check; returns failure counts (all zero == valid).
    Host-side numpy, for tests and debugging."""
    m = bvh.num_leaves
    parent = bvh.parent.cpu().numpy()
    amin = bvh.aabb_min.cpu().numpy()
    amax = bvh.aabb_max.cpu().numpy()
    order = bvh.order.cpu().numpy()
    escape = bvh.escape.cpu().numpy()
    fails = {}
    if m == 1:
        fails["root_parent"] = int(parent[0] != -1)
        fails["root_escape"] = int(escape[0] != -1)
    else:
        child_count = np.zeros(m - 1, np.int64)
        fails["orphan_nonroot"] = int(np.sum(parent[1:] < 0))
        np.add.at(child_count, parent[parent >= 0], 1)
        fails["internal_degree"] = int(np.sum(child_count != 2))
        has_parent = parent >= 0
        p = parent[has_parent]
        fails["aabb_containment"] = int(
            np.sum(
                np.any(amin[has_parent] < amin[p] - atol, axis=-1)
                | np.any(amax[has_parent] > amax[p] + atol, axis=-1)
            )
        )
        fails["root_parent"] = int(parent[0] != -1)
        fails["root_escape"] = int(escape[0] != -1)

    real = order[order >= 0]
    fails["order_permutation"] = int(
        len(real) != len(np.unique(real))
        or (prim_min is not None and len(real) != len(prim_min))
    )
    if prim_min is not None:
        pmin = np.asarray(prim_min.cpu() if isinstance(prim_min, torch.Tensor) else prim_min)
        pmax = np.asarray(prim_max.cpu() if isinstance(prim_max, torch.Tensor) else prim_max)
        leaf_base = m - 1 if m > 1 else 0
        leaf_of_slot = np.repeat(np.arange(m), bvh.leaf_size)
        ok = order >= 0
        node = leaf_base + leaf_of_slot[ok]
        rows = order[ok]
        fails["leaf_containment"] = int(
            np.sum(
                np.any(pmin[rows] < amin[node] - atol, axis=-1)
                | np.any(pmax[rows] > amax[node] + atol, axis=-1)
            )
        )
    return fails
