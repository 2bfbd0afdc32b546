"""Sub-surface scattering via surface point clouds (port of
`gpu_pathtracer_tpu.render.sss`).

* build time: `pts_per_object` points per SSS object (its triangles carry a
  material with path_length > 0), by an area-weighted triangle pick and a
  uniform barycentric point, with the kd texture as the point's filter;
* first pass: cosine-hemisphere paths from every point estimate its
  irradiance; point colour = mean * filter;
* render time: a diffuse bounce on an SSS material returns the 1/d-weighted
  average of the cached point colours within `path_length` of the hit, same
  object only, times the local kd (`render.integrator.trace_paths`).

The gather is a masked all-pairs reduction over the flat point array up to
SSS_DENSE_MAX points and goes through the spatial hash grid above.  Only the
rays that gather are gathered for: they are compacted first (one host
synchronization a call, a `loop_exit` of the port's tracer), which changes
no value.

Randomness comes from an explicit `torch.Generator` or from uniforms passed
in, laid out as the reference package folds its key (see each function).
"""

from __future__ import annotations

import dataclasses

import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import SMALL_EPS
from gpu_pathtracer_tpu_torch.models.scene import Scene, SSSPoints
from gpu_pathtracer_tpu_torch.ops import bounding_sphere, hashgrid, intersect, linalg, sampling

# dense all-pairs gather up to this point count, the hash grid above
SSS_DENSE_MAX = 2048
_W_MAX = 9999.99  # cap of the 1/d weight


def sss_object_ids(scene: Scene) -> list[int]:
    """Ids of the objects with an SSS material, ascending."""
    g = scene.geom
    is_sss_tri = (scene.materials.path_length[g.mat_id.long()] * g.valid) > 0
    ids = torch.unique(torch.where(is_sss_tri, g.obj_id, -1))
    return [int(i) for i in ids.tolist() if i >= 0]


def sample_sss_points(scene: Scene, pts_per_object: int,
                      generator: torch.Generator | None = None,
                      uniforms: torch.Tensor | None = None) -> SSSPoints | None:
    """Sample the per-object point clouds over the sorted geometry SoA; None
    when the scene has no SSS object.  Object k of `sss_object_ids` uses
    `uniforms[k]`, (3, P): the triangle pick, r1, r2 (the reference folds its
    key by the object id, then by 0, 1, 2); else `generator`."""
    g = scene.geom
    table = scene.materials
    dev = g.p.device
    obj_ids = sss_object_ids(scene)
    if not obj_ids:
        return None
    is_sss_tri = (table.path_length[g.mat_id.long()] * g.valid) > 0
    areas = intersect.triangle_area(g.p) * g.valid

    pos, nrm, filt, obj = [], [], [], []
    for k, oid in enumerate(obj_ids):
        if uniforms is not None:
            u = uniforms[k].to(dev)
        else:
            u = torch.rand((3, pts_per_object), generator=generator, device=dev)
        w = torch.where((g.obj_id == oid) & is_sss_tri, areas, 0.0)
        cdf = torch.cumsum(w, dim=0)
        tri = torch.clamp(torch.searchsorted(cdf, u[0] * cdf[-1]), 0, w.shape[0] - 1)
        # uniform point: u = 1 - sqrt(r1), v = r2 sqrt(r1)
        s = torch.sqrt(u[1])
        bu = 1.0 - s
        bv = u[2] * s
        bary = torch.stack([bu, bv, 1.0 - bu - bv], dim=-1)[..., None]
        pos.append(torch.sum(bary * g.p[tri], dim=-2))
        nrm.append(linalg.normalize(torch.sum(bary * g.n[tri], dim=-2), SMALL_EPS))
        uv = torch.sum(bary * g.uv[tri], dim=-2)
        filt.append(table.diffuse_color(g.mat_id[tri], uv))
        obj.append(torch.full((pts_per_object,), oid, dtype=torch.int32, device=dev))

    pos = torch.cat(pos)
    return SSSPoints(
        pos=pos,
        normal=torch.cat(nrm),
        filter=torch.cat(filt),
        color=torch.zeros_like(pos),
        obj_id=torch.cat(obj),
        valid=torch.ones((pos.shape[0],), dtype=torch.bool, device=dev),
    )


def run_first_pass(scene: Scene, points: SSSPoints, sample_size: int = 16, level: int = 4,
                   hittable_pdf_weight: float = 0.0, generator: torch.Generator | None = None,
                   uniforms: dict | None = None) -> SSSPoints:
    """Cosine-hemisphere irradiance estimates per point, colour = mean *
    filter.  `uniforms` = {"dir": (sample_size, 2, S), "paths": (sample_size,
    level, 8, S)} and, in the sparse light-tree regime, "pick": (sample_size,
    level, descent steps, S); else `generator`."""
    from gpu_pathtracer_tpu_torch.render.integrator import trace_paths

    s = points.pos.shape[0]
    dev = points.pos.device
    zeros = torch.zeros_like(points.normal)
    mode = torch.zeros((s,), dtype=torch.int32, device=dev)
    ones = torch.ones((s,), dtype=torch.float32, device=dev)
    total = torch.zeros((s, 3), dtype=torch.float32, device=dev)
    for i in range(sample_size):
        if uniforms is not None:
            u = uniforms["dir"][i].to(dev)
            kw = dict(uniforms=uniforms["paths"][i],
                      pick_uniforms=uniforms["pick"][i] if "pick" in uniforms else None)
        else:
            u = torch.rand((2, s), generator=generator, device=dev)
            kw = dict(generator=generator)
        d = sampling.generate_direction(zeros, points.normal, mode, ones, u[0], u[1])
        c = trace_paths(scene, points.pos, d, level=level,
                        hittable_pdf_weight=hittable_pdf_weight, sss_first_pass=True, **kw)
        total = total + linalg.de_nan(c)
    return dataclasses.replace(points, color=(total / sample_size) * points.filter)


def _weighted_average(w, color):
    """(R, C) weights and (R, C, 3) or (C, 3) colours -> ((R, 3) average, (R,) found)."""
    sum_w = torch.sum(w, dim=-1)
    if color.dim() == 2:
        total = w @ color
    else:
        total = torch.sum(w[..., None] * color, dim=-2)
    found = sum_w > 0
    avg = torch.where(found[..., None], total / torch.clamp(sum_w, min=1e-20)[..., None], 0.0)
    return avg, found


def _weights(inside, d):
    return torch.where(inside, torch.clamp(1.0 / torch.clamp(d, min=1e-20), max=_W_MAX), 0.0)


def gather_sss(points: SSSPoints, hit_pt, hit_obj, radius, kd, enable) -> torch.Tensor:
    """Inverse-distance-weighted average of the cached point colours within
    `radius` (the material's path_length) of each hit, same object only, the
    weight capped at 9999.99; zero where no point is in range or `enable` is
    off.  All pairs: (R, S) temporaries."""
    d = linalg.length(points.pos[None, :, :] - hit_pt[:, None, :])  # (R, S)
    inside = (
        enable[:, None]
        & points.valid[None, :]
        & (points.obj_id[None, :] == hit_obj[:, None])
        & bounding_sphere.is_inside(hit_pt[:, None, :], radius[:, None], points.pos[None, :, :],
                                    d=d)
    )
    avg, found = _weighted_average(_weights(inside, d), points.color)
    return avg * kd * found[..., None]


def gather_sss_grid(points: SSSPoints, hit_pt, hit_obj, radius, kd, enable,
                    k_per_cell: int = 32, chunk: int = 8192) -> torch.Tensor:
    """`gather_sss` through the spatial hash grid: the cell is the largest
    enabled radius, so each ray inspects the 27 cells around it, at most
    `k_per_cell` points a cell (a denser cloud drops the excess; the dense
    gather is unbounded).  O(R * 27 * k_per_cell), in chunks of rays."""
    cell = torch.clamp(torch.amax(torch.where(enable, radius, 0.0)), min=1e-6)
    grid = hashgrid.build_grid(points.pos, points.valid, cell)
    out = []
    for r0 in range(0, hit_pt.shape[0], chunk):
        sl = slice(r0, r0 + chunk)
        pt, obj, rad, en = hit_pt[sl], hit_obj[sl], radius[sl], enable[sl]
        cand, ok = hashgrid.query_candidates(grid, pt, k_per_cell)  # (C, 27 K)
        c = cand.long()
        cpos = points.pos[c]
        d = linalg.length(cpos - pt[:, None, :])
        inside = (
            ok
            & en[:, None]
            & (points.obj_id[c] == obj[:, None])
            & bounding_sphere.is_inside(pt[:, None, :], rad[:, None], cpos, d=d)
        )
        avg, found = _weighted_average(_weights(inside, d), points.color[c])
        out.append(avg * found[..., None])
    return torch.cat(out) * kd


def gather_sss_auto(points: SSSPoints, hit_pt, hit_obj, radius, kd, enable) -> torch.Tensor:
    """The SSS gather for a wavefront: dense up to SSS_DENSE_MAX points, the
    hash grid above.  Only the enabled rays are gathered for."""
    tracing.count("loop_exit")
    idx = torch.nonzero(enable)[:, 0]
    out = torch.zeros_like(kd)
    if idx.shape[0] == 0:
        return out
    gather = gather_sss if points.pos.shape[0] <= SSS_DENSE_MAX else gather_sss_grid
    args = (hit_pt[idx], hit_obj[idx], radius[idx], kd[idx], enable[idx])
    return out.index_copy(0, idx, gather(points, *args))


def attach_sss(scene: Scene, pts_per_object: int, sample_size: int = 16, level: int = 4,
               hittable_pdf_weight: float = 0.0,
               generator: torch.Generator | None = None) -> Scene:
    """Sample the point clouds, run the first pass and attach the points to
    the scene (the scene itself when it has no SSS object)."""
    points = sample_sss_points(scene, pts_per_object, generator=generator)
    if points is None:
        return scene
    points = run_first_pass(scene, points, sample_size=sample_size, level=level,
                            hittable_pdf_weight=hittable_pdf_weight, generator=generator)
    return dataclasses.replace(scene, sss=points)
