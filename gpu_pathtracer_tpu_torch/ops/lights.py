"""Light tree: many-lights importance sampling + MIS mixture pdf (port of
`gpu_pathtracer_tpu.ops.lights`).

The emitters get a `leaf_size=1` radix tree whose nodes carry energy sums.
In the dense regime (E <= LIGHT_TREE_DENSE_MAX) every leaf's selection pdf
is one (R, 2E-1) x (2E-1, E) product against the host-built ancestor
matrix, the pick is an inverse-CDF over those pdfs, and the mixture pdf sums
over every emitter.  Above that the (2E-1, E) matrix is not built and the
integrators take the sparse regime, which never makes an (R, E) table: the
pick is a stochastic root-to-leaf descent (`pick_light`), and the mixture
pdf collects the emitter leaves whose boxes the ray stabs by a stackless
walk of the tree (`collect_hit_leaves`, at most MAX_POTENTIAL_TARGETS a ray,
the rest counted as dropped), intersects only those and gets their selection
pdfs from bounded leaf-to-root walks (`node_pdf_walk`).

The descent runs its `depth - 1` steps without asking the device anything.
The collect walk is data-dependent (a ray is done when it leaves the tree):
it asks the device every COLLECT_SYNC_STEPS steps whether any ray is still
walking, bounded by 4 E steps as in the reference package; each question
is a `loop_exit` of the port's tracer (`tracing`).

`nee` is the integrator's NEE/MIS stage: `nee_mis` in torch ops, or
`nee_dense` (one launch of `csrc/nee_dense.cu` on the card, counter
`launch.nee_dense`) on a dense tree of at most NEE_DENSE_MAX_LIGHTS emitters.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import (
    LIGHT_TREE_DENSE_MAX,
    MAX_POTENTIAL_TARGETS,
    SMALL_EPS,
)
from gpu_pathtracer_tpu_torch.ops import _build, intersect, linalg, route, sampling
from gpu_pathtracer_tpu_torch.ops import bvh as bvh_mod


# steps of the collect walk between two `.any()` questions to the device
COLLECT_SYNC_STEPS = 8
# most emitters `nee_dense` takes: the kernel keeps 3E-1 floats a ray in
# shared memory (csrc/nee_dense.cu, kMaxLights), up to 58 KB a block at 32
NEE_DENSE_MAX_LIGHTS = 32
_NEE_ARG_SLOTS = 43  # 8-byte fields of the kernel's argument block (`Args`)


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


def topology_tables(parent: np.ndarray, left: np.ndarray, escape: np.ndarray, e: int,
                    dense: bool = True):
    """Host-side sibling map, root->leaf ancestor matrix and depth of a
    leaf_size=1 tree over e leaves; without `dense` the O(E^2) matrix is a
    (1, 1) placeholder."""
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
    anc = np.zeros((total, e) if dense else (1, 1), np.float32)
    cur = np.arange(e, dtype=np.int64) + leaf_base
    depth = 0
    while True:
        if dense:
            anc[cur, np.arange(e)] = 1.0
        depth += 1
        done = cur == 0
        if done.all() or depth > 2 * e + 2:
            break
        cur = np.where(done, cur, parent[cur])
    return sib, anc, depth


def build_light_tree(tri_p, tri_n, tri_uv, energy, geom_slot,
                     dense_tables: bool | None = None) -> LightTree:
    """Build the light tree (radix tree over emitters + bottom-up energy).
    `dense_tables` (default: E <= LIGHT_TREE_DENSE_MAX) says whether the
    O(E^2) ancestor matrix of the matmul-form pdf is built; without it the
    integrators take the sparse descent / walk regime."""
    e = tri_p.shape[0]
    if dense_tables is None:
        dense_tables = e <= LIGHT_TREE_DENSE_MAX
    dense_tables = bool(dense_tables) or e == 1
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
        tree.parent.cpu().numpy(), tree.left.cpu().numpy(), tree.escape.cpu().numpy(), e,
        dense=dense_tables,
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
        dense=dense_tables,
    )


def cone_union(ax_a, t0_a, te_a, ax_b, t0_b, te_b):
    """Orientation-cone union per Estevez-Kulla, branch-free over (..., 3)
    axes.  Returns (axis, theta_0, theta_e)."""
    swap = t0_b > t0_a
    ax_1 = torch.where(swap[..., None], ax_b, ax_a)
    ax_2 = torch.where(swap[..., None], ax_a, ax_b)
    t0_1 = torch.where(swap, t0_b, t0_a)
    t0_2 = torch.where(swap, t0_a, t0_b)

    theta_d = torch.arccos(torch.clamp(linalg.dot(ax_1, ax_2), -1.0, 1.0))
    new_te = torch.maximum(te_a, te_b)

    contained = torch.clamp(theta_d + t0_2, max=math.pi) <= t0_1
    t0_open = (t0_1 + theta_d + t0_2) / 2.0
    full = t0_open >= math.pi

    rot_axis = linalg.cross(ax_1, ax_2)
    # a zero rotation axis means parallel axes: same-direction ones land in
    # `contained`; antipodal ones admit no finite cone: the full sphere
    degenerate = linalg.length(rot_axis) < 1e-12
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=rot_axis.dtype, device=rot_axis.device)
    rot_axis = torch.where(degenerate[..., None], x_axis, rot_axis)
    ax_open = linalg.rodrigues_rotate(ax_1, rot_axis, t0_open - t0_1)

    axis = torch.where((contained | full | degenerate)[..., None], ax_1, ax_open)
    t0 = torch.where(contained, t0_1,
                     torch.where(full | (degenerate & ~contained), math.pi, t0_open))
    return axis, t0, new_te


def build_node_cones(lt: LightTree):
    """Per-node orientation cones, bottom-up: a leaf's cone is (avg normal,
    theta_0 = 0, theta_e = pi / 2), an internal node's the union of its
    children's; `depth` sweeps of recompute-from-children reach the fixed
    point.  The importance does not use them (the reference leaves the cone
    terms out); they are kept as a data structure.  Returns (axis (2E-1, 3),
    theta_0 (2E-1,), theta_e (2E-1,))."""
    e = lt.num_lights
    num_internal = e - 1
    dev = lt.avg_normal.device
    axis = torch.cat([torch.zeros((num_internal, 3), dtype=torch.float32, device=dev),
                      lt.avg_normal])
    t0 = torch.zeros((2 * e - 1,), dtype=torch.float32, device=dev)
    te = torch.cat([torch.zeros((num_internal,), dtype=torch.float32, device=dev),
                    torch.full((e,), math.pi / 2.0, dtype=torch.float32, device=dev)])
    if num_internal == 0:
        return axis, t0, te
    left = lt.tree.left[:num_internal].long()
    right = lt.tree.escape[left].long()
    for _ in range(lt.depth):
        ux, u0, ue = cone_union(axis[left], t0[left], te[left],
                                axis[right], t0[right], te[right])
        axis = torch.cat([ux, axis[num_internal:]])
        t0 = torch.cat([u0, t0[num_internal:]])
        te = torch.cat([ue, te[num_internal:]])
    return axis, t0, te


def leaf_energies(lt: LightTree, table, mat_id_sorted: torch.Tensor) -> torch.Tensor:
    """Per-emitter energy 2*pi*avg(Ke at the 3 vertices)*area, (E, 3), read
    from the live material table (`build_scene` bakes the same values into
    the leaves of `lt.node_energy`).  `mat_id_sorted` is `scene.geom.mat_id`."""
    mat = mat_id_sorted[lt.geom_slot.long()]  # (E,)
    ke_verts = table.emission_color(mat[:, None].expand(-1, 3), lt.tri_uv)  # (E, 3, 3)
    return 2.0 * math.pi * torch.mean(ke_verts, dim=1) * lt.area[:, None]


def _node_importance(lt: LightTree, node, point, pivot) -> torch.Tensor:
    """Node importance |energy| / dist^2 to the node's box centre, a leaf
    with its energy directed toward the shading point.  node (...,) unified
    node ids, point / pivot broadcastable (..., 3)."""
    e = lt.num_lights
    leaf_base = e - 1
    node = node.long()
    center = 0.5 * (lt.tree.aabb_min[node] + lt.tree.aabb_max[node])
    d = point - center
    dist2 = torch.clamp(linalg.dot(d, d), min=1e-30)
    is_leaf = node >= leaf_base
    leaf = torch.clamp(node - leaf_base, 0, e - 1)
    dir_to_point = linalg.normalize(point - lt.centroid[leaf], SMALL_EPS)
    fac = torch.clamp(
        linalg.dot(lt.avg_normal[leaf], dir_to_point) * linalg.dot(-dir_to_point, pivot), min=0.0
    )
    energy = lt.node_energy[node]
    eff = torch.where(is_leaf[..., None], energy * fac[..., None], energy)
    return linalg.length(eff) / dist2


def _children(lt: LightTree, internal):
    left = lt.tree.left[internal].long()
    return left, lt.tree.escape[left].long()


def descent_steps(lt: LightTree) -> int:
    """Steps of `pick_light`'s descent: the longest root-to-leaf path."""
    return max(lt.depth - 1, 0)


def pick_light(lt: LightTree, point, pivot, generator: torch.Generator | None = None,
               uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """Stochastic root-to-leaf descent, each branch taken in proportion to
    the children's importance.  point / pivot (R, 3) -> (R,) int32 leaf index
    (tree order).  Step s uses row s of `uniforms` (`descent_steps(lt)`, R)
    (the reference folds its key by the step), else a draw from `generator`.
    The loop runs its fixed number of steps: a ray that has reached its leaf
    stays there, and the host never waits for the device."""
    e = lt.num_lights
    r_shape = point.shape[:-1]
    dev = point.device
    if e == 1:
        return torch.zeros(r_shape, dtype=torch.int32, device=dev)
    leaf_base = e - 1
    steps = descent_steps(lt)
    if uniforms is None:
        uniforms = torch.rand((steps,) + tuple(r_shape), generator=generator, device=dev)
    elif uniforms.shape[0] < steps:
        raise ValueError(f"pick_light needs {steps} rows of uniforms, got {uniforms.shape[0]}")
    node = torch.zeros(r_shape, dtype=torch.int64, device=dev)
    for step in range(steps):
        at_internal = node < leaf_base
        left, right = _children(lt, torch.clamp(node, max=leaf_base - 1))
        imp_l = _node_importance(lt, left, point, pivot)
        imp_r = _node_importance(lt, right, point, pivot)
        total = imp_l + imp_r
        factor = torch.where(total < 1e-10, 0.5, imp_l / torch.clamp(total, min=1e-30))
        nxt = torch.where(uniforms[step] < factor, left, right)
        node = torch.where(at_internal, nxt, node)
    return (node - leaf_base).to(torch.int32)


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


def node_pdf_walk(lt: LightTree, leaf, point, pivot) -> torch.Tensor:
    """Selection pdf of the given leaves by the bounded leaf-to-root walk
    that multiplies branch ratios: O(K * depth) per ray, no (R, E) table.
    leaf (..., K) leaf indices (tree order), point / pivot (..., 3).  A plain
    loop over the tree's depth, differentiable to the emitter energies."""
    e = lt.num_lights
    if e == 1:
        return torch.ones(leaf.shape, dtype=torch.float32, device=leaf.device)
    pt = point[..., None, :]
    pv = pivot[..., None, :]
    cur = leaf.long() + (e - 1)
    pdf = torch.ones(leaf.shape, dtype=torch.float32, device=leaf.device)
    for _ in range(lt.depth):
        live = cur > 0
        safe = torch.clamp(cur, min=0)
        par = lt.tree.parent[safe].long()
        left, right = _children(lt, torch.clamp(par, min=0))
        sib = torch.where(left == safe, right, left)
        imp_1 = _node_importance(lt, safe, pt, pv)
        imp_2 = _node_importance(lt, sib, pt, pv)
        ratio = imp_1 / (imp_1 + imp_2)
        ratio = torch.where(torch.isfinite(ratio), ratio, 0.5)
        pdf = torch.where(live, pdf * ratio, pdf)
        cur = torch.where(live, par, cur)
    return pdf


def leaf_node_pdfs_walk(lt: LightTree, point, pivot) -> torch.Tensor:
    """Walk-form pdfs for all leaves (the cross-check of the matmul-form
    `leaf_node_pdfs`; O(E * depth) per ray, dense-regime sizes only)."""
    e = lt.num_lights
    leaves = torch.arange(e, dtype=torch.int32, device=point.device).expand(
        point.shape[:-1] + (e,))
    return node_pdf_walk(lt, leaves, point, pivot)


def collect_hit_leaves(lt: LightTree, origin, direction, max_k: int = MAX_POTENTIAL_TARGETS):
    """Up to `max_k` emitter leaves whose box the ray stabs, by a stackless
    walk of the light tree over its hit / escape links.  Returns (leaf, ok,
    dropped): (R, K) int32 leaf indices in the order met, their validity, and
    the (R,) int32 count of stabbed leaves dropped past the cap (a mixture pdf
    summed over a capped collection is biased low for that ray).  The
    collection is a superset of the emitters the ray hits."""
    e = lt.num_lights
    r = origin.shape[0]
    dev = origin.device
    if e == 1:
        return (torch.zeros((r, 1), dtype=torch.int32, device=dev),
                torch.ones((r, 1), dtype=torch.bool, device=dev),
                torch.zeros((r,), dtype=torch.int32, device=dev))
    leaf_base = e - 1
    tree = lt.tree
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-20,
                              torch.where(direction < 0, -1e-20, 1e-20), direction)
    k_ar = torch.arange(max_k, dtype=torch.int32, device=dev)
    t_inf = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    left_link, escape_link = tree.left.long(), tree.escape.long()

    cur = torch.zeros((r,), dtype=torch.int64, device=dev)
    buf = torch.zeros((r, max_k), dtype=torch.int32, device=dev)
    cnt = torch.zeros((r,), dtype=torch.int32, device=dev)
    drop = torch.zeros((r,), dtype=torch.int32, device=dev)
    for step in range(4 * e):
        if step % COLLECT_SYNC_STEPS == 0:
            tracing.count("loop_exit")
            if not bool(torch.any(cur >= 0)):
                break
        live = cur >= 0
        node = torch.clamp(cur, min=0)
        box_hit = bvh_mod.ray_box_test(origin, inv_d, tree.aabb_min[node], tree.aabb_max[node],
                                       t_inf) & live
        is_leaf = node >= leaf_base
        stab = box_hit & is_leaf
        take = stab & (cnt < max_k)
        slot = (k_ar[None, :] == cnt[:, None]) & take[:, None]
        buf = torch.where(slot, (node - leaf_base).to(torch.int32)[:, None], buf)
        cnt = cnt + take.to(torch.int32)
        drop = drop + (stab & ~take).to(torch.int32)
        nxt = torch.where(box_hit & ~is_leaf, left_link[node], escape_link[node])
        cur = torch.where(live, nxt, cur)
    return buf, k_ar[None, :] < cnt[:, None], drop


def hittable_pdf_sum_sparse(lt: LightTree, origin, direction, pivot,
                            max_k: int = MAX_POTENTIAL_TARGETS, with_stats: bool = False):
    """`hittable_pdf_sum` without any (R, E) table: collect the candidate
    leaves through the light tree, intersect only those K triangles and get
    their selection pdfs by bounded walks.  With `with_stats` also the (R,)
    int32 count of stabbed emitter leaves dropped past `max_k`."""
    cand, ok, dropped = collect_hit_leaves(lt, origin, direction, max_k)
    c = cand.long()
    t, bary, hit = intersect.intersect_tris(origin, direction, lt.tri_p[c], lt.tol[c],
                                            float("inf"))
    n_hit = linalg.normalize(torch.sum(bary[..., None] * lt.tri_n[c], dim=-2), SMALL_EPS)
    cos = torch.abs(linalg.dot(direction[..., None, :], n_hit))
    geom = torch.where(hit & ok, (t * t) / torch.clamp(cos * lt.area[c], min=1e-20), 0.0)
    node_pdf = node_pdf_walk(lt, cand, origin, pivot)
    s = torch.sum(torch.where(hit & ok, node_pdf * geom, 0.0), dim=-1)
    return (s, dropped) if with_stats else s


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


def nee_mis(lt: LightTree, ref, normal, coming_dir, hittable_pdf_weight: float,
            u: torch.Tensor, u_descent: torch.Tensor | None = None):
    """change_ref_ray: with probability w redirect the sampled ray at a
    light-tree-sampled emitter point, then weight with the mixture pdf.
    `ref` is the lobe's `materials.ReflectionRecord`; `u` is (4, R):
    u_accept, the light-pick uniform, u1, u2; `u_descent` (descent steps, R)
    feeds the sparse regime's pick instead of u[1].  Returns (new_dir,
    new_filter, factor, mis_dropped): mis_dropped is the (R,) count of
    emitter leaves the sparse pdf sum dropped past MAX_POTENTIAL_TARGETS (0
    in the dense regime, which sums over all)."""
    pivot = torch.where(ref.diffuse[..., None], normal, ref.perfect_dir)
    w = torch.where(torch.isinf(ref.n), 0.0, hittable_pdf_weight)
    take_light = u[0] < w

    # dense regime: one (R, E) pdf table serves the pick and the mixture pdf;
    # sparse regime: stochastic descent + bounded walks, O(R log E)
    if lt.dense:
        node_pdf = leaf_node_pdfs(lt, ref.origin, pivot)
        leaf = pick_light_dense(lt, node_pdf, u[1])
    else:
        leaf = pick_light(lt, ref.origin, pivot, uniforms=u_descent)
    target = sample_point_on_light(lt, leaf, u[2], u[3])
    light_dir = linalg.normalize(target - ref.origin, SMALL_EPS)

    new_dir = torch.where(take_light[..., None], light_dir, ref.dir)
    refilter = take_light & (ref.reflected | ref.refracted)
    filt_l = sampling.phong_filter(ref.k, ref.n, pivot, new_dir)
    new_filter = torch.where(refilter[..., None], filt_l, ref.filter)

    if lt.dense:
        hittable = hittable_pdf_sum(lt, ref.origin, new_dir, pivot, node_pdf=node_pdf)
        mis_dropped = torch.zeros(ref.pdf.shape, dtype=torch.int32, device=ref.pdf.device)
    else:
        hittable, mis_dropped = hittable_pdf_sum_sparse(
            lt, ref.origin, new_dir, pivot, with_stats=True)
    samp_diff = sampling.diffuse_sampling_pdf(normal, new_dir)
    samp_spec = sampling.specular_sampling_pdf(
        coming_dir, new_dir, normal, ref.perfect_dir, ref.n, ref.refracted
    )
    samp = torch.where(ref.diffuse, samp_diff, samp_spec)
    pdf = w * hittable + (1.0 - w) * samp

    scat = sampling.scattering_pdf(normal, new_dir, ref.diffuse, coming_dir, ref.refracted)
    factor = scat / math.pi / torch.where(pdf != 0, pdf, 1.0)
    factor = torch.where(pdf != 0, factor, 0.0)
    return new_dir, new_filter, factor, mis_dropped


def nee(lt: LightTree, ref, normal, coming_dir, hittable_pdf_weight: float, u: torch.Tensor,
        u_descent, do_nee: torch.Tensor, kernels: bool):
    """`nee_dense` where the caller allows `kernels`, it takes the tree and
    `route.records_nothing`, else `nee_mis` and the `do_nee` selects; with
    the 0-d count of leaves `nee_mis` dropped on the `do_nee` rays (or None)."""
    if (kernels and lt.dense and lt.num_lights <= NEE_DENSE_MAX_LIGHTS
            and route.records_nothing(ref, normal, coming_dir, u)):
        return (*nee_dense(lt, ref, normal, coming_dir, hittable_pdf_weight, u, do_nee), None)
    new_dir, new_filter, factor, mis_dropped = nee_mis(
        lt, ref, normal, coming_dir, hittable_pdf_weight, u, u_descent)
    return (torch.where(do_nee[..., None], new_dir, ref.dir),
            torch.where(do_nee[..., None], new_filter, ref.filter),
            torch.where(do_nee, factor, 1.0),
            torch.sum(torch.where(do_nee, mis_dropped, 0)))


def nee_dense_reference(lt: LightTree, ref, normal, coming_dir, hittable_pdf_weight: float,
                        u: torch.Tensor, do_nee: torch.Tensor):
    """The plain version of `csrc/nee_dense.cu` (any device), `nee`'s torch
    path on a dense light tree: (next_dir, filter, factor), where `do_nee`
    nee_mis's (new_dir, new_filter, factor), elsewhere (ref.dir, ref.filter, 1)."""
    return nee(lt, ref, normal, coming_dir, hittable_pdf_weight, u, None, do_nee, False)[:3]


def nee_dense(lt: LightTree, ref, normal, coming_dir, hittable_pdf_weight: float,
              u: torch.Tensor, do_nee: torch.Tensor):
    """The dense light tree's NEE/MIS step with the `do_nee` selects:
    `launch_nee_dense` for CUDA tensors (not differentiable),
    `nee_dense_reference` for others."""
    if ref.origin.device.type == "cuda":
        return launch_nee_dense(lt, ref, normal, coming_dir, hittable_pdf_weight, u, do_nee)
    return nee_dense_reference(lt, ref, normal, coming_dir, hittable_pdf_weight, u, do_nee)


@_build.derived(lambda lt: (lt.tree.aabb_min, lt.tree.aabb_max, lt.node_energy, lt.anc, lt.sib,
                            lt.node_centroid, lt.node_avg_normal, lt.tri_p, lt.tri_n, lt.area,
                            lt.tol))
def nee_tables(lt: LightTree):
    """The light tree's tables as `csrc/nee_dense.cu` reads them: node (2E-1,
    12) float32 [box centre, energy, leaf centroid, leaf average normal],
    leaf (E, 20) float32 [vertices, vertex normals, area, tol] and ints
    (2E-1 + E * depth,) int32 [the siblings, each leaf's root-to-leaf path
    in ascending node id padded with 2E-1].  Built on the tree's device
    without a host synchronisation, kept on it while its sources stand."""
    e = lt.num_lights
    n_nodes = 2 * e - 1
    centers = 0.5 * (lt.tree.aabb_min + lt.tree.aabb_max)
    node = torch.cat([centers, lt.node_energy, lt.node_centroid, lt.node_avg_normal], dim=1)
    leaf = torch.cat([lt.tri_p.reshape(e, 9), lt.tri_n.reshape(e, 9), lt.area[:, None],
                      lt.tol[:, None]], dim=1)
    ids = torch.arange(n_nodes, dtype=torch.int32, device=lt.anc.device)
    paths = torch.where(lt.anc.T > 0, ids, n_nodes).sort(dim=1).values[:, :lt.depth]
    ints = torch.cat([lt.sib.to(torch.int32), paths.reshape(-1)])
    return tuple(t.detach().to(dtype).contiguous() for t, dtype in (
        (node, torch.float32), (leaf, torch.float32), (ints, torch.int32)))


def launch_nee_dense(lt: LightTree, ref, normal, coming_dir, hittable_pdf_weight: float,
                     u: torch.Tensor, do_nee: torch.Tensor):
    """Launch `csrc/nee_dense.cu` on the current stream: `nee_dense_reference`'s
    (next_dir (R, 3), filter (R, 3), factor (R,)) float32 from the inputs read
    in place (float32 vectors (R, 3), ref.n (R,), bool flags (R,), u (4, R),
    any strides).  A launch the card took counts as `launch.nee_dense`."""
    r = ref.origin.shape[0]
    dev = ref.origin.device
    e = lt.num_lights
    if not lt.dense or e > NEE_DENSE_MAX_LIGHTS:
        raise ValueError(f"nee_dense takes a dense light tree of at most {NEE_DENSE_MAX_LIGHTS} "
                         f"emitters, got {e} (dense {lt.dense})")
    vectors = (ref.origin, ref.dir, ref.k, ref.filter, ref.perfect_dir, normal, coming_dir)
    flags = (ref.diffuse, ref.reflected, ref.refracted, do_nee)
    if (any(t.dtype != torch.float32 or t.shape != (r, 3) for t in vectors)
            or any(t.dtype != torch.bool or t.shape != (r,) for t in flags)
            or ref.n.dtype != torch.float32 or ref.n.shape != (r,)
            or u.dtype != torch.float32 or u.shape != (4, r)):
        raise ValueError("nee_dense takes float32 (R, 3) vectors, a float32 (R,) exponent, "
                         "bool (R,) flags and float32 (4, R) uniforms")
    out_dir = torch.empty((r, 3), dtype=torch.float32, device=dev)
    out_filter = torch.empty((r, 3), dtype=torch.float32, device=dev)
    out_factor = torch.empty((r,), dtype=torch.float32, device=dev)
    block = _build.arg_block(
        (*vectors, u, ref.n, *flags,
         *(t.data_ptr() for t in (*nee_tables(lt), out_dir, out_filter, out_factor)),
         r, e, lt.depth), _NEE_ARG_SLOTS)
    _build.launch("nee_dense", (_build.PTR, _build.FLOAT), dev, block, hittable_pdf_weight)
    return out_dir, out_filter, out_factor
