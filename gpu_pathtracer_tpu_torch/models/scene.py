"""Device scene: sorted SoA geometry + closest-hit tiles + materials + lights
(port of `gpu_pathtracer_tpu.models.scene`).

Triangles live in one SoA re-ordered by the geometry BVH's Morton order; the
closest-hit tiles are packed from it, and one packed (T, 26) `attr` row per
triangle [p(9) n(9) uv(6) tol(1) mat(1)] feeds both the winner barycentrics
and the hit interpolation from a single gather.  Everything is float32 or
int32 on the scene's device (host arrays may be float64; they are cast here).

`Scene.transparent` is the same structure over the transparent triangles
alone (t_r > 0), with its own tiles; SPPM marches through it to find the
media a camera or an emitter starts in.  `Scene.sss` is the surface point
cloud of the sub-surface-scattering objects (`render.sss.attach_sss`).
With `build_scene(edge_prefilter=True)` a scene above `ops.trace.PALLAS_MAX`
triangle rows also carries the edge tiles of the closest-hit prefilter
(`ops.closest_hit.pack_edge_tiles`), and its closest-hit queries then take
`csrc/closest_hit_mxu.cu`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpu_pathtracer_tpu_torch.device import as_f32 as _f32
from gpu_pathtracer_tpu_torch.device import as_i32 as _i32
from gpu_pathtracer_tpu_torch.ops import bvh as bvh_mod
from gpu_pathtracer_tpu_torch.ops import closest_hit, intersect, lights, materials, trace
from gpu_pathtracer_tpu_torch.utils.obj_io import HostScene


@dataclasses.dataclass
class GeometrySet:
    """One BVH + its leaf-ordered triangle SoA (padded to leaves * leaf_size;
    padding rows have valid=False and are never reported as hits)."""

    bvh: bvh_mod.BVH
    p: torch.Tensor  # (T, 3, 3)
    n: torch.Tensor  # (T, 3, 3)
    uv: torch.Tensor  # (T, 3, 2)
    tangent: torch.Tensor  # (T, 3, 3) NaN where degenerate
    tol: torch.Tensor  # (T,)
    mat_id: torch.Tensor  # (T,) int32
    obj_id: torch.Tensor  # (T,) int32
    valid: torch.Tensor  # (T,) bool
    tiles: torch.Tensor  # (NT, 10, TILE) closest-hit tiles
    tile_aabb: torch.Tensor  # (NT, 8)
    attr: torch.Tensor  # (T, 26) packed shading rows
    num_tris: int = 0
    # the closest-hit prefilter's operand (`closest_hit.pack_edge_tiles`), on
    # scenes above PALLAS_MAX that were built with edge_prefilter=True
    edge_tiles: torch.Tensor | None = None  # (NT, 3 * TILE, 8) bfloat16
    edge_wsum: torch.Tensor | None = None  # (NT, 3, TILE)


@dataclasses.dataclass
class SSSPoints:
    """Surface point cloud for sub-surface scattering: one flat array across
    all SSS objects, gathered by object id."""

    pos: torch.Tensor  # (S, 3)
    normal: torch.Tensor  # (S, 3)
    filter: torch.Tensor  # (S, 3) kd texture at the sample
    color: torch.Tensor  # (S, 3) cached irradiance * albedo (first pass)
    obj_id: torch.Tensor  # (S,) int32
    valid: torch.Tensor  # (S,) bool


@dataclasses.dataclass
class Scene:
    geom: GeometrySet
    transparent: GeometrySet | None
    light_tree: lights.LightTree | None
    materials: materials.MaterialTable
    sky_emission: torch.Tensor  # (3,)
    sky_rgb: torch.Tensor  # (P, 3) equirect env image (1 px white default)
    sss: SSSPoints | None = None
    num_lights: int = 0
    has_sky_tex: bool = False
    sky_h: int = 1
    sky_w: int = 1


def pack_attr(p, n, uv, tol, mat_id) -> torch.Tensor:
    """(T, 26) rows [p(9) n(9) uv(6) tol(1) mat(1)]."""
    return torch.cat(
        [p.reshape(-1, 9), n.reshape(-1, 9), uv.reshape(-1, 6), tol[:, None],
         mat_id.to(torch.float32)[:, None]],
        dim=1,
    )


# triangles per BVH leaf: the reference package's default, so both sort the
# triangle SoA into the same rows
LEAF_SIZE = 4


def build_geometry_set(p, n, uv, tangent, mat_id, obj_id,
                       edge_prefilter: bool = False) -> GeometrySet:
    """BVH + leaf-order gathers + tolerances + tile packing + attr rows; with
    `edge_prefilter`, the prefilter's edge tiles for a set above PALLAS_MAX."""
    bvh = bvh_mod.build_bvh(torch.amin(p, dim=1), torch.amax(p, dim=1), leaf_size=LEAF_SIZE)
    safe = torch.clamp(bvh.order, min=0).long()
    valid = bvh.order >= 0
    p_sorted = p[safe]
    tol_sorted = intersect.triangle_tolerance(p_sorted)
    tiles, tile_aabb = closest_hit.pack_tiles(p_sorted, tol_sorted, valid)
    edge_tiles = edge_wsum = None
    if edge_prefilter and p_sorted.shape[0] > trace.PALLAS_MAX:
        edge_tiles, edge_wsum = closest_hit.pack_edge_tiles(p_sorted, valid)
    mat_sorted = torch.where(valid, mat_id[safe], 0).to(torch.int32)
    n_sorted = n[safe]
    uv_sorted = uv[safe]
    return GeometrySet(
        bvh=bvh,
        p=p_sorted,
        n=n_sorted,
        uv=uv_sorted,
        tangent=tangent[safe],
        tol=tol_sorted,
        mat_id=mat_sorted,
        obj_id=torch.where(valid, obj_id[safe], -1).to(torch.int32),
        valid=valid,
        tiles=tiles,
        tile_aabb=tile_aabb,
        attr=pack_attr(p_sorted, n_sorted, uv_sorted, tol_sorted, mat_sorted),
        num_tris=int(p.shape[0]),
        edge_tiles=edge_tiles,
        edge_wsum=edge_wsum,
    )


def build_scene(host: HostScene, device, sky_emission=(0.0, 0.0, 0.0),
                sky_image: np.ndarray | None = None, edge_prefilter: bool = False) -> Scene:
    """Assemble the device scene from host-parsed arrays: material table,
    geometry BVH + tiles, light tree over the emissive triangles.
    `edge_prefilter` (off by default) packs the closest-hit prefilter's edge
    tiles when the geometry is above `ops.trace.PALLAS_MAX` rows, which routes
    its closest-hit queries to the kernel with the tensor-core prefilter."""
    if host.tri_p.shape[0] == 0:
        raise ValueError("the scene has no triangles")
    table = materials.MaterialTable.from_host(host.materials, host.atlas, device)
    tri_p = _f32(host.tri_p, device)
    tri_n = _f32(host.tri_n, device)
    tri_uv = _f32(host.tri_uv, device)
    tri_tangent = _f32(host.tri_tangent, device)
    mat_idx = _i32(host.mat_idx, device)
    object_idx = _i32(host.object_idx, device)
    geom = build_geometry_set(tri_p, tri_n, tri_uv, tri_tangent, mat_idx, object_idx,
                              edge_prefilter=edge_prefilter)

    # transparent subset (t_r > 0)
    transparent = None
    trans_mask = np.asarray(host.materials.t_r)[np.asarray(host.mat_idx)] > 0
    if trans_mask.any():
        idx = torch.as_tensor(np.nonzero(trans_mask)[0], device=device)
        transparent = build_geometry_set(
            tri_p[idx], tri_n[idx], tri_uv[idx], tri_tangent[idx], mat_idx[idx], object_idx[idx],
            edge_prefilter=edge_prefilter,
        )

    # emitters: any vertex with |Ke texture| above the triangle tolerance;
    # energy 2*pi*avg(Ke)*area (host numpy, as the reference package does)
    mat_v = mat_idx[:, None].expand(-1, 3)
    ke_verts = table.emission_color(mat_v, tri_uv).cpu().numpy()
    tol_np = intersect.triangle_tolerance(tri_p).cpu().numpy()
    emissive = (np.linalg.norm(ke_verts, axis=-1) > tol_np[:, None]).any(axis=1)
    light_tree = None
    num_lights = 0
    if emissive.any():
        idx = np.nonzero(emissive)[0]
        idx_t = torch.as_tensor(idx, device=device)
        area = intersect.triangle_area(tri_p[idx_t]).cpu().numpy()
        energy = 2.0 * np.pi * ke_verts[idx].mean(axis=1) * area[:, None]
        order = geom.bvh.order.cpu().numpy()
        inv_order = np.full(order.shape, -1, np.int64)
        pos = np.nonzero(order >= 0)[0]
        inv_order[order[pos]] = pos
        light_tree = lights.build_light_tree(
            tri_p[idx_t], tri_n[idx_t], tri_uv[idx_t],
            _f32(energy, device), _i32(inv_order[idx], device),
        )
        num_lights = int(idx.shape[0])

    if sky_image is not None:
        sky_rgb = _f32(sky_image.reshape(-1, 3), device)
        sky_h, sky_w = int(sky_image.shape[0]), int(sky_image.shape[1])
        has_sky_tex = True
    else:
        sky_rgb = torch.ones((1, 3), dtype=torch.float32, device=device)
        sky_h = sky_w = 1
        has_sky_tex = False

    return Scene(
        geom=geom,
        transparent=transparent,
        light_tree=light_tree,
        materials=table,
        sky_emission=_f32(sky_emission, device),
        sky_rgb=sky_rgb,
        num_lights=num_lights,
        has_sky_tex=has_sky_tex,
        sky_h=sky_h,
        sky_w=sky_w,
    )
