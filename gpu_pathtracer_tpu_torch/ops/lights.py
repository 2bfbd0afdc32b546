"""Light tree: many-lights importance sampling + MIS mixture pdf (port of
`gpu_pathtracer_tpu.ops.lights`, dense regime).

The emitters get a `leaf_size=1` radix tree whose nodes carry energy sums.
In the dense regime (E <= LIGHT_TREE_DENSE_MAX) every leaf's selection pdf
is one (R, 2E-1) x (2E-1, E) product against the host-built ancestor
matrix, the pick is an inverse-CDF over those pdfs, and the mixture pdf sums
over every emitter.  The sparse regime (stochastic descent, bounded walks)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.constants import LIGHT_TREE_DENSE_MAX, SMALL_EPS
from gpu_pathtracer_tpu_torch.ops import bvh as bvh_mod
from gpu_pathtracer_tpu_torch.ops import intersect, linalg


@dataclasses.dataclass
class LightTree:
    tree: bvh_mod.BVH  # leaf_size=1 radix tree over emitters
    node_energy: torch.Tensor  # (2E-1, 3) energy sums (leaves = emitter energy)
    # leaf payloads in tree order (leaf k <-> sorted slot k):
    tri_p: torch.Tensor  # (E, 3, 3)
    tri_n: torch.Tensor  # (E, 3, 3)
    tri_uv: torch.Tensor  # (E, 3, 2)
    area: torch.Tensor  # (E,)
    avg_normal: torch.Tensor  # (E, 3)
    centroid: torch.Tensor  # (E, 3)
    tol: torch.Tensor  # (E,)
    geom_slot: torch.Tensor  # (E,) int32 row in the sorted scene arrays
    sib: torch.Tensor  # (2E-1,) int32 sibling node id (root -> itself)
    anc: torch.Tensor  # (2E-1, E) f32 1.0 where node lies on root->leaf path
    node_centroid: torch.Tensor  # (2E-1, 3)
    node_avg_normal: torch.Tensor  # (2E-1, 3)
    node_is_leaf: torch.Tensor  # (2E-1,) bool
    num_lights: int = 0
    depth: int = 1
    dense: bool = True


def topology_tables(parent: np.ndarray, left: np.ndarray, escape: np.ndarray, e: int):
    """Host-side sibling map, root->leaf ancestor matrix and depth of a
    leaf_size=1 tree over e leaves."""
    total = 2 * e - 1
    leaf_base = e - 1
    if e == 1:
        return np.zeros((1,), np.int64), np.ones((1, 1), np.float32), 1
    parent = parent.astype(np.int64)
    lchild = left.astype(np.int64)[:leaf_base]
    rchild = escape.astype(np.int64)[lchild]  # right sibling = left child's escape
    sib = np.arange(total, dtype=np.int64)
    sib[lchild] = rchild
    sib[rchild] = lchild
    anc = np.zeros((total, e), np.float32)
    cur = np.arange(e, dtype=np.int64) + leaf_base
    depth = 0
    while True:
        anc[cur, np.arange(e)] = 1.0
        depth += 1
        done = cur == 0
        if done.all() or depth > 2 * e + 2:
            break
        cur = np.where(done, cur, parent[cur])
    return sib, anc, depth


def build_light_tree(tri_p, tri_n, tri_uv, energy, geom_slot) -> LightTree:
    """Build the light tree (radix tree over emitters + bottom-up energy)."""
    e = tri_p.shape[0]
    if e > LIGHT_TREE_DENSE_MAX:
        raise NotImplementedError(
            f"{e} emitters: the sparse light-tree regime (E > "
            f"{LIGHT_TREE_DENSE_MAX}) is not ported yet (ROADMAP queue A, "
            "item 5: pick_light / hittable_pdf_sum_sparse)"
        )
    dev = tri_p.device
    pmin = torch.amin(tri_p, dim=1)
    pmax = torch.amax(tri_p, dim=1)
    tree = bvh_mod.build_bvh(pmin, pmax, leaf_size=1)
    order = tree.order[:e].long()

    tri_p = tri_p[order]
    tri_n = tri_n[order]
    tri_uv = tri_uv[order]
    energy = energy[order]
    geom_slot = geom_slot[order]

    num_internal = e - 1
    node_energy = torch.cat(
        [torch.zeros((num_internal, 3), dtype=energy.dtype, device=dev), energy]
    )
    if num_internal > 0:
        left = tree.left[:num_internal].long()
        right = tree.escape[left].long()
        while True:
            new = torch.cat([node_energy[left] + node_energy[right], node_energy[num_internal:]])
            if not bool(torch.any(new != node_energy)):
                break
            node_energy = new

    sib, anc, depth = topology_tables(
        tree.parent.cpu().numpy(), tree.left.cpu().numpy(), tree.escape.cpu().numpy(), e
    )
    total = 2 * e - 1
    leaf_base = e - 1
    avg_normal = linalg.normalize(torch.mean(tri_n, dim=1), SMALL_EPS)
    centroid = torch.mean(tri_p, dim=1)
    zeros_int = torch.zeros((leaf_base, 3), dtype=torch.float32, device=dev)
    return LightTree(
        tree=tree,
        node_energy=node_energy,
        tri_p=tri_p,
        tri_n=tri_n,
        tri_uv=tri_uv,
        area=intersect.triangle_area(tri_p),
        avg_normal=avg_normal,
        centroid=centroid,
        tol=intersect.triangle_tolerance(tri_p),
        geom_slot=geom_slot,
        sib=torch.as_tensor(sib, dtype=torch.int32, device=dev),
        anc=torch.as_tensor(anc, device=dev),
        node_centroid=torch.cat([zeros_int, centroid]),
        node_avg_normal=torch.cat([zeros_int, avg_normal]),
        node_is_leaf=torch.arange(total, device=dev) >= leaf_base,
        num_lights=e,
        depth=depth,
        dense=True,
    )


def leaf_energies(lt: LightTree, table, mat_id_sorted: torch.Tensor) -> torch.Tensor:
    """Per-emitter energy 2*pi*avg(Ke at the 3 vertices)*area, (E, 3), read
    from the live material table (`build_scene` bakes the same values into
    the leaves of `lt.node_energy`).  `mat_id_sorted` is `scene.geom.mat_id`."""
    mat = mat_id_sorted[lt.geom_slot.long()]  # (E,)
    ke_verts = table.emission_color(mat[:, None].expand(-1, 3), lt.tri_uv)  # (E, 3, 3)
    return 2.0 * math.pi * torch.mean(ke_verts, dim=1) * lt.area[:, None]


def pick_light_dense(lt: LightTree, node_pdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample a leaf from its selection distribution by inverse CDF.
    node_pdf (R, E), u (R,) uniforms -> (R,) int32 leaf index."""
    cdf = torch.cumsum(node_pdf, dim=-1)
    total = cdf[..., -1:]
    pick = torch.sum(cdf < u.reshape(-1, 1) * total, dim=-1)
    return torch.clamp(pick, 0, lt.num_lights - 1).to(torch.int32)


def sample_point_on_light(lt: LightTree, leaf, u1, u2) -> torch.Tensor:
    """Uniform point on the chosen emitter: u = 1-sqrt(r1), v = r2*sqrt(r1)."""
    s = torch.sqrt(torch.clamp(u1, min=0.0))
    u = 1.0 - s
    v = u2 * s
    p = lt.tri_p[leaf.long()]
    return (
        u[..., None] * p[..., 0, :]
        + v[..., None] * p[..., 1, :]
        + (1.0 - u - v)[..., None] * p[..., 2, :]
    )


def _importance_tables(lt: LightTree, perm: torch.Tensor | None = None):
    """Per-node data for the dense importance eval; `perm` gathers the
    sibling-permuted copy."""
    centers = 0.5 * (lt.tree.aabb_min + lt.tree.aabb_max)
    tables = (centers, lt.node_energy, lt.node_centroid, lt.node_avg_normal, lt.node_is_leaf)
    if perm is None:
        return tables
    perm = perm.long()
    return tuple(t[perm] for t in tables)


def _dense_importance(tables, point, pivot):
    """Node importance |energy|/dist^2 (leaves: directed energy toward the
    shading point) for every node at once: (R, 3) -> (R, T)."""
    centers, energy, centroid, avg_n, is_leaf = tables
    d = point[..., None, :] - centers
    dist2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-30)
    dtp = linalg.normalize(point[..., None, :] - centroid, SMALL_EPS)
    fac = torch.clamp(
        linalg.dot(avg_n, dtp) * linalg.dot(-dtp, pivot[..., None, :]), min=0.0
    )
    eff = torch.where(is_leaf[..., None], energy * fac[..., None], energy)
    return linalg.length(eff) / dist2


def leaf_node_pdfs(lt: LightTree, point: torch.Tensor, pivot: torch.Tensor) -> torch.Tensor:
    """Per-leaf selection pdf = product of branch probabilities root->leaf,
    for all leaves at once: exp(log_ratio @ anc).  NaN/inf branch ratios fall
    back to 0.5.  point/pivot (R, 3) -> (R, E).

    The product is a plain float32 matmul (`torch.backends.cuda.matmul.
    allow_tf32` stays at its default False, so it runs in full float32)."""
    e = lt.num_lights
    if e == 1:
        return torch.ones(point.shape[:-1] + (1,), dtype=point.dtype, device=point.device)
    total = 2 * e - 1
    imp = _dense_importance(_importance_tables(lt), point, pivot)
    imp_sib = _dense_importance(_importance_tables(lt, lt.sib), point, pivot)
    ratio = imp / (imp + imp_sib)
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.5)
    is_root = torch.arange(total, device=point.device) == 0
    ratio = torch.where(is_root, 1.0, ratio)
    log_pdf = torch.log(torch.clamp(ratio, 1e-35, 1.0)) @ lt.anc
    return torch.exp(log_pdf)


def hittable_pdf_sum(lt: LightTree, origin, direction, pivot, node_pdf=None) -> torch.Tensor:
    """sum_i node_pdf_i * geom_pdf_i over every emitter the ray hits;
    geom_pdf = t^2 / (|cos| * area) at that emitter's watertight hit."""
    if node_pdf is None:
        node_pdf = leaf_node_pdfs(lt, origin, pivot)
    t, bary, hit = intersect.intersect_tris(
        origin, direction, lt.tri_p[None], lt.tol[None], float("inf")
    )
    n_hit = linalg.normalize(torch.sum(bary[..., None] * lt.tri_n[None], dim=-2), SMALL_EPS)
    cos = torch.abs(linalg.dot(direction[..., None, :], n_hit))
    geom = torch.where(
        hit, (t * t) / torch.clamp(cos * lt.area[None, :], min=1e-20), 0.0
    )
    return torch.sum(node_pdf * geom, dim=-1)
