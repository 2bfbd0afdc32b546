"""The wavefront step's surface shading (`shade`): `interpolate_hit` and
`sample_bsdf` as `gpu_pathtracer_tpu.render.integrator` runs them, or one
launch of `csrc/shade_surface.cu` on the card (`shade_surface`)."""

from __future__ import annotations

import torch

from gpu_pathtracer_tpu_torch.constants import SMALL_EPS
from gpu_pathtracer_tpu_torch.ops import _build, linalg, materials, route

_SHADE_ARG_SLOTS = 37  # 8-byte fields of the kernel's argument block (`Args`)
SHADE_FLOATS = ("point", "uv", "normal", "dir", "k", "filter", "filter_2", "perfect_dir", "pdf",
                "n")
SHADE_DISCRETE = ("mat_id", "next_mat", "diffuse", "reflected", "refracted", "false_hit",
                  "entering", "bent", "sss")


def interpolate_hit(g, table, slot, bary):
    """Barycentric position / uv and the shading normal with tangent-frame
    bump perturbation, from one packed attr-row gather."""
    s = torch.clamp(slot, min=0).long()
    b = bary[..., None]  # (R, 3, 1)
    rows = g.attr[s]  # (R, 26)
    point = torch.sum(b * rows[:, 0:9].reshape(-1, 3, 3), dim=-2)
    n = linalg.normalize(torch.sum(b * rows[:, 9:18].reshape(-1, 3, 3), dim=-2), SMALL_EPS)
    uv = torch.sum(b * rows[:, 18:24].reshape(-1, 3, 2), dim=-2)
    mat_id = rows[:, 25].to(torch.int32)  # exact for < 2^24 materials

    if table.atlas.rgb.shape[0] <= 1:  # no images anywhere -> no bump maps
        return point, uv, n, mat_id

    bump = table.bump_vector(mat_id, uv)
    tangent = torch.sum(b * g.tangent[s], dim=-2)
    tan_ok = torch.all(torch.isfinite(tangent), dim=-1)
    tangent = torch.where(tan_ok[..., None], tangent, 1.0)
    ux, vy, _ = linalg.onb_from_z_tangent(n, linalg.normalize(tangent, SMALL_EPS))
    ux0, vy0, _ = linalg.onb_from_z(n)
    u_axis = torch.where(tan_ok[..., None], ux, ux0)
    v_axis = torch.where(tan_ok[..., None], vy, vy0)
    has_bump = linalg.length(bump) > 0.0
    n_bumped = linalg.normalize(n + bump[..., 0:1] * u_axis + bump[..., 1:2] * v_axis, SMALL_EPS)
    normal = torch.where(has_bump[..., None], n_bumped, n)
    return point, uv, normal, mat_id


def shade(g, table, slot, bary, d, stack_ids, stack_len, u, kernels: bool):
    """`shade_surface` where the caller allows `kernels` and autograd records
    nothing for the rays (`route.records_nothing`), else its plain version."""
    if kernels and route.records_nothing(bary, d, u):
        return shade_surface(g, table, slot, bary, d, stack_ids, stack_len, u)
    return shade_surface_reference(g, table, slot, bary, d, stack_ids, stack_len, u)


def shade_surface_reference(g, table, slot, bary, d, stack_ids, stack_len, u):
    """The plain version of `csrc/shade_surface.cu` (any device):
    `interpolate_hit`, then `materials.sample_bsdf` with the step's four
    BSDF uniforms `u` (4, R).  Returns (point, uv, normal, mat_id, ref)."""
    point, uv, normal, mat_id = interpolate_hit(g, table, slot, bary)
    ref = materials.sample_bsdf(table, mat_id, point, d, normal, uv, stack_ids, stack_len, u)
    return point, uv, normal, mat_id, ref


def shade_surface(g, table, slot, bary, d, stack_ids, stack_len, u):
    """`launch_shade_surface` for CUDA tensors (not differentiable),
    `shade_surface_reference` for others."""
    if bary.device.type == "cuda":
        return launch_shade_surface(g, table, slot, bary, d, stack_ids, stack_len, u)
    return shade_surface_reference(g, table, slot, bary, d, stack_ids, stack_len, u)


def launch_shade_surface(g, table, slot, bary, d, stack_ids, stack_len, u):
    """Launch `csrc/shade_surface.cu`: `shade_surface_reference`'s outputs,
    contiguous, from inputs read in place (slot (R,) int32, bary and d (R, 3)
    float32, the stack (R, S) and its length (R,) int32, u (4, R) float32,
    any strides)."""
    r = slot.shape[0]
    dev = bary.device
    f32, i32 = torch.float32, torch.int32
    inputs = ((slot, i32, (r,)), (bary, f32, (r, 3)), (d, f32, (r, 3)),
              (stack_ids, i32, (r, stack_ids.shape[-1])), (stack_len, i32, (r,)),
              (u, f32, (4, r)), (g.attr, f32, (g.attr.shape[0], 26)),
              (g.tangent, f32, (g.attr.shape[0], 3, 3)))
    if (any(t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
            for t, dtype, shape in inputs) or stack_ids.shape[-1] < 1):
        raise ValueError("shade_surface takes slot (R,) int32, bary and d (R, 3) float32, a "
                         "stack (R, S >= 1) and its length (R,) int32, u (4, R) float32, and "
                         "a geometry of (T, 26) attr rows and (T, 3, 3) tangents, on one device")
    tables = materials.surface_tables(table)  # mat_f, mat_i, then the atlas, rgb first
    vec = torch.empty((7, r, 3), dtype=f32, device=dev)
    uv = torch.empty((r, 2), dtype=f32, device=dev)
    scalar = torch.empty((2, r), dtype=f32, device=dev)
    ints = torch.empty((2, r), dtype=i32, device=dev)
    flags = torch.empty((7, r), dtype=torch.bool, device=dev)
    block = _build.arg_block(
        (slot, bary, d, stack_ids, stack_len, u, g.attr, g.tangent,
         *(t.data_ptr() for t in (*tables, vec, uv, scalar, ints, flags)),
         r, stack_ids.shape[-1], int(tables[2].shape[0] > 1)), _SHADE_ARG_SLOTS)
    _build.launch("shade_surface", (_build.PTR,), dev, block)
    point = vec[0]
    ref = materials.ReflectionRecord(
        origin=point, dir=vec[2], k=vec[3], filter=vec[4], filter_2=vec[5], perfect_dir=vec[6],
        pdf=scalar[0], n=scalar[1], diffuse=flags[0], reflected=flags[1], refracted=flags[2],
        false_hit=flags[3], entering=flags[4], bent=flags[5], sss=flags[6], next_mat=ints[1])
    return point, uv, vec[1], ints[0], ref


def shade_fields(out) -> dict:
    """`shade_surface`'s (point, uv, normal, mat_id, ref) as one dict, its
    keys SHADE_FLOATS and SHADE_DISCRETE (and the record's `origin`)."""
    point, uv, normal, mat_id, ref = out
    return dict(vars(ref), point=point, uv=uv, normal=normal, mat_id=mat_id)
