"""Modified-Phong BSDF sampling with nested-dielectric priority stacks (port of
`gpu_pathtracer_tpu.ops.materials`).

Materials are one structure-of-arrays `MaterialTable`; a ray's current media
are a fixed-size int32 id stack (-1 = vacuum, -2 = empty slot).  `sample_bsdf`
is the branch-free, batched `check_next_path`: the false-hit, refraction and
opaque branches are all computed and blended with masks.  Its four uniforms
come in explicitly, so both packages can be fed the same numbers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from gpu_pathtracer_tpu_torch.constants import (
    MAX_PHONG_N_S,
    SMALL_EPS,
    VACUUM_IOR,
    VACUUM_PRIORITY,
)
from gpu_pathtracer_tpu_torch.device import as_f32 as _f32
from gpu_pathtracer_tpu_torch.device import as_i32 as _i32
from gpu_pathtracer_tpu_torch.ops import linalg, sampling, texture

NULL_MAT = -1  # "nullptr" — the vacuum pseudo-material (a legal stack entry)
EMPTY_SLOT = -2  # unused slot


def _take(table: torch.Tensor, mat_id: torch.Tensor) -> torch.Tensor:
    """Row gather with the vacuum id (-1) clamped to row 0.

    When autograd records it, the gather goes through float64 (the values
    are the same): its backward sums every ray's gradient onto a handful of
    rows, and a float32 running sum over ~65,536 rays drifts by up to ~3e-4
    of the total, so a gradient summed in two halves (two ranks) would part
    from the one summed whole by that much."""
    idx = torch.clamp(mat_id, min=0).long()
    if torch.is_grad_enabled() and table.requires_grad and table.is_floating_point():
        return table.double()[idx].to(table.dtype)
    return table[idx]


@dataclasses.dataclass
class MaterialTable:
    """SoA of every MTL material.  `n_s` holds +inf for the perfect-mirror
    limit (n_s >= MAX_PHONG_N_S and t_r > 0)."""

    kd: torch.Tensor  # (M, 3)
    ks: torch.Tensor  # (M, 3)
    ke: torch.Tensor  # (M, 3)
    tf: torch.Tensor  # (M, 3) transmission
    n_s: torch.Tensor  # (M,)
    n_i: torch.Tensor  # (M,)
    t_r: torch.Tensor  # (M,)
    bm: torch.Tensor  # (M,) bump multiplier
    path_length: torch.Tensor  # (M,) > 0 => sub-surface scattering
    scattering_coef: torch.Tensor  # (M,)
    absorption_coef: torch.Tensor  # (M,)
    g: torch.Tensor  # (M,) Henyey-Greenstein asymmetry
    priority: torch.Tensor  # (M,) int32
    tex_slot: torch.Tensor  # (M, 5) int32: diffuse/specular/emission/n_s/bump
    atlas: texture.Atlas

    @staticmethod
    def from_host(mats, atlas_np, device) -> "MaterialTable":
        """Build from `utils.obj_io.HostMaterials` + `TextureAtlas` (float32 /
        int32 on `device`)."""
        n_s = _f32(mats.n_s, device)
        t_r = _f32(mats.t_r, device)
        n_s = torch.where((n_s >= MAX_PHONG_N_S) & (t_r > 0), float("inf"), n_s)
        return MaterialTable(
            kd=_f32(mats.kd, device),
            ks=_f32(mats.ks, device),
            ke=_f32(mats.ke, device),
            tf=_f32(mats.tf, device),
            n_s=n_s,
            n_i=_f32(mats.n_i, device),
            t_r=t_r,
            bm=_f32(mats.bm, device),
            path_length=_f32(mats.path_length, device),
            scattering_coef=_f32(mats.scattering_coef, device),
            absorption_coef=_f32(mats.absorption_coef, device),
            g=_f32(mats.g, device),
            priority=_i32(mats.priority, device),
            tex_slot=_i32(mats.tex_slot, device),
            atlas=texture.Atlas(
                rgb=_f32(atlas_np.rgb, device),
                offsets=_i32(atlas_np.offsets, device),
                heights=_i32(atlas_np.heights, device),
                widths=_i32(atlas_np.widths, device),
            ),
        )

    # -- per-id accessors (id -1 => vacuum defaults) --------------------

    def get_priority(self, mat_id: torch.Tensor) -> torch.Tensor:
        return torch.where(mat_id < 0, VACUUM_PRIORITY, _take(self.priority, mat_id))

    def get_ior(self, mat_id: torch.Tensor) -> torch.Tensor:
        return torch.where(mat_id < 0, VACUUM_IOR, _take(self.n_i, mat_id))

    # -- textured channels ----------------------------------------------

    def _tex(self, mat_id, channel: int, uv, filt):
        slot = _take(self.tex_slot, mat_id)[..., channel]
        return texture.lookup(self.atlas, slot, uv) * filt

    def diffuse_color(self, mat_id, uv):
        return self._tex(mat_id, 0, uv, _take(self.kd, mat_id))

    def specular_color(self, mat_id, uv):
        return self._tex(mat_id, 1, uv, _take(self.ks, mat_id))

    def emission_color(self, mat_id, uv):
        return self._tex(mat_id, 2, uv, _take(self.ke, mat_id))

    def phong_exponent(self, mat_id, uv):
        """|n_s/sqrt(3) * tex_rgb| (epsilon-guarded norm); +inf passes through."""
        n_s = _take(self.n_s, mat_id)
        inf = torch.isinf(n_s)
        filt = torch.where(inf, 0.0, n_s)[..., None] / math.sqrt(3.0)
        v = self._tex(mat_id, 3, uv, filt)
        len_v = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-30))
        return torch.where(inf, float("inf"), len_v)

    def bump_vector(self, mat_id, uv):
        """2*bm*(tex - 0.5); zero when the bump image is < 2x2."""
        if self.atlas.rgb.shape[0] <= 1:
            return torch.zeros(mat_id.shape + (3,), dtype=self.atlas.rgb.dtype,
                               device=self.atlas.rgb.device)
        slot = _take(self.tex_slot, mat_id)[..., 4].long()
        has = (self.atlas.heights[slot] >= 2) & (self.atlas.widths[slot] >= 2)
        tex = texture.lookup(self.atlas, slot, uv)
        bump = 2.0 * _take(self.bm, mat_id)[..., None] * (tex - 0.5)
        return torch.where(has[..., None], bump, 0.0)

    def transmission_k(self, mat_id):
        """k = Tf * t_r, 1 for nullptr (vacuum filters nothing)."""
        k = _take(self.tf, mat_id) * _take(self.t_r, mat_id)[..., None]
        return torch.where((mat_id < 0)[..., None], 1.0, k)


def surface_tables(table: MaterialTable):
    """The material table and its atlas as `csrc/shade_surface.cu` reads them:
    mat_f (M, 16) float32 [kd, ks, tf, n_s, n_i, t_r, bm, path_length, 0, 0],
    mat_i (M, 8) int32 [priority, tex_slot (5), 0, 0], and the atlas's rgb,
    offsets, heights and widths, contiguous.  Built on the table's device
    without a host synchronisation and kept on the table until one of the
    tensors they come from is replaced or updated in place."""
    sources = (table.kd, table.ks, table.tf, table.n_s, table.n_i, table.t_r, table.bm,
               table.path_length, table.priority, table.tex_slot, table.atlas.rgb,
               table.atlas.offsets, table.atlas.heights, table.atlas.widths)
    cached = table.__dict__.get("_surface_tables")
    if cached is not None and all(t is s and t._version == v
                                  for t, (s, v) in zip(sources, cached[0])):
        return cached[1]
    m = table.kd.shape[0]
    dev = table.kd.device
    cols = [table.kd, table.ks, table.tf] + [
        t[:, None] for t in (table.n_s, table.n_i, table.t_r, table.bm, table.path_length)]
    mat_f = torch.cat(cols + [torch.zeros((m, 2), dtype=torch.float32, device=dev)], dim=1)
    mat_i = torch.cat([table.priority[:, None], table.tex_slot,
                       torch.zeros((m, 2), dtype=torch.int32, device=dev)], dim=1)
    atlas = table.atlas
    tables = tuple(t.detach().to(dtype).contiguous() for t, dtype in (
        (mat_f, torch.float32), (mat_i, torch.int32), (atlas.rgb, torch.float32),
        (atlas.offsets, torch.int32), (atlas.heights, torch.int32),
        (atlas.widths, torch.int32)))
    table._surface_tables = (tuple((t, t._version) for t in sources), tables)
    return tables


# ---------------------------------------------------------------------------
# Nested-dielectric id stack
# ---------------------------------------------------------------------------

def stack_init(batch_shape, size: int, device=None):
    """Fresh stacks pre-loaded with one nullptr entry."""
    ids = torch.full(tuple(batch_shape) + (size,), EMPTY_SLOT, dtype=torch.int32, device=device)
    ids[..., 0] = NULL_MAT
    return ids, torch.ones(tuple(batch_shape), dtype=torch.int32, device=device)


def stack_add(ids, length, mat_id, enable):
    """Append mat_id unless already present; full stacks drop the push."""
    size = ids.shape[-1]
    slots = torch.arange(size, dtype=torch.int32, device=ids.device)
    valid = slots < length[..., None]
    present = torch.any(valid & (ids == mat_id[..., None]), dim=-1)
    do = enable & ~present & (length < size)
    new_ids = torch.where(
        do[..., None] & (slots == length[..., None]), mat_id[..., None].to(ids.dtype), ids
    )
    return new_ids, length + do.to(torch.int32)


def stack_remove(ids, length, mat_id, enable):
    """Remove the LAST occurrence of mat_id and compact."""
    size = ids.shape[-1]
    slots = torch.arange(size, dtype=torch.int32, device=ids.device)
    valid = slots < length[..., None]
    match = valid & (ids == mat_id[..., None])
    sel = torch.amax(torch.where(match, slots, -1), dim=-1)
    found = (sel >= 0) & enable
    shifted = torch.cat(
        [ids[..., 1:], torch.full(ids.shape[:-1] + (1,), EMPTY_SLOT, dtype=ids.dtype,
                                  device=ids.device)],
        dim=-1,
    )
    new_ids = torch.where(found[..., None] & (slots >= sel[..., None]), shifted, ids)
    new_len = length - found.to(torch.int32)
    new_ids = torch.where(
        found[..., None] & (slots >= new_len[..., None]), EMPTY_SLOT, new_ids
    )
    return new_ids, new_len


def stack_rearrange(ids, length, mat_id, false_hit, entering, refracted, enable):
    """rearrange_material_list: push on entering, pop on leaving."""
    push = enable & ((false_hit & entering) | (~false_hit & refracted & entering))
    pop = enable & ((false_hit & ~entering) | (~false_hit & refracted & ~entering))
    ids, length = stack_add(ids, length, mat_id, push)
    ids, length = stack_remove(ids, length, mat_id, pop)
    return ids, length


def find_highest_prioritised(table: MaterialTable, ids, length):
    """(highest, second-highest)-priority material ids on the stack: lowest
    priority value wins, ties go to the highest slot; the second must be
    strictly lower-priority than the first and strictly above nullptr."""
    size = ids.shape[-1]
    slots = torch.arange(size, dtype=torch.int32, device=ids.device)
    valid = slots < length[..., None]
    pri = torch.where(valid, table.get_priority(ids), VACUUM_PRIORITY + 1)
    key = pri * (size + 1) + (size - 1 - slots)
    min_key = torch.amin(key, dim=-1)
    hp_pri = min_key // (size + 1)
    sel = key == min_key[..., None]
    hp_id = torch.where(
        hp_pri >= VACUUM_PRIORITY,
        NULL_MAT,
        torch.sum(torch.where(sel, ids, 0), dim=-1).to(torch.int32),
    )
    eligible = valid & (pri > hp_pri[..., None]) & (pri < VACUUM_PRIORITY)
    key2 = torch.where(eligible, key, 2**31 - 1)
    min_key2 = torch.amin(key2, dim=-1)
    any2 = torch.any(eligible, dim=-1)
    sel2 = key2 == min_key2[..., None]
    shp_id = torch.where(
        any2,
        torch.sum(torch.where(sel2 & eligible, ids, 0), dim=-1).to(torch.int32),
        NULL_MAT,
    )
    return hp_id.to(torch.int32), shp_id.to(torch.int32)


# ---------------------------------------------------------------------------
# BSDF sampling (check_next_path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReflectionRecord:
    origin: torch.Tensor  # (R, 3) hit point = next ray origin
    dir: torch.Tensor  # (R, 3) sampled next direction
    k: torch.Tensor  # (R, 3)
    filter: torch.Tensor  # (R, 3)
    filter_2: torch.Tensor  # (R, 3)
    perfect_dir: torch.Tensor  # (R, 3)
    pdf: torch.Tensor  # (R,)
    n: torch.Tensor  # (R,) effective Phong exponent (inf = mirror)
    diffuse: torch.Tensor  # (R,) bool
    reflected: torch.Tensor
    refracted: torch.Tensor
    false_hit: torch.Tensor
    entering: torch.Tensor
    bent: torch.Tensor
    sss: torch.Tensor
    next_mat: torch.Tensor  # (R,) int32


def _snell_out_dir(v_in, normal, cos1, sin_ratio, sign):
    """Bend v_in across the interface (entering: sign=-1, exiting: +1);
    grazing/degenerate bends fall back to +/-normal."""
    sin1 = linalg.safe_sqrt(1.0 - cos1 * cos1)
    v_perp = sign[..., None] * cos1[..., None] * normal
    v_par = v_in - v_perp
    sin2 = sin_ratio * sin1
    cos2 = linalg.safe_sqrt(1.0 - sin2 * sin2)
    tan2 = sin2 / torch.clamp(cos2, min=1e-20)
    straight = torch.abs(tan2) <= SMALL_EPS
    inv_tan = torch.where(straight, 0.0, 1.0 / torch.clamp(tan2, min=SMALL_EPS))
    par_len = linalg.length(v_par, keepdims=True)
    v_out = linalg.normalize(
        v_par + sign[..., None] * inv_tan[..., None] * par_len * normal, SMALL_EPS
    )
    return torch.where(straight[..., None], sign[..., None] * normal, v_out)


def sample_bsdf(
    table: MaterialTable,
    mat_id: torch.Tensor,  # (R,) int32 hit material
    hit_point: torch.Tensor,  # (R, 3)
    v_in: torch.Tensor,  # (R, 3) incoming (unit) direction
    normal: torch.Tensor,  # (R, 3) shading normal
    uv: torch.Tensor,  # (R, 2)
    stack_ids: torch.Tensor,  # (R, S)
    stack_len: torch.Tensor,  # (R,)
    uniforms: torch.Tensor,  # (4, R): u_choice, u_pick, u_lobe1, u_lobe2
    force_refract: bool = False,
) -> ReflectionRecord:
    """Batched, branch-free check_next_path: false-hit test -> refraction
    (Schlick + Snell + TIR with the nested-dielectric stack) -> diffuse /
    specular pick; every ray evaluates every branch and blends by mask.
    `force_refract` makes every transparent interface refract (no Fresnel
    reflection, no total internal reflection): the SPPM stack probes and
    shadow chains."""
    r_shape = mat_id.shape
    u_choice, u_pick, u_lobe1, u_lobe2 = uniforms[0], uniforms[1], uniforms[2], uniforms[3]
    ones = torch.ones(r_shape, dtype=v_in.dtype, device=v_in.device)
    ones_i = torch.ones(r_shape, dtype=torch.int32, device=v_in.device)

    hp_id, shp_id = find_highest_prioritised(table, stack_ids, stack_len)
    hp_pri = table.get_priority(hp_id)
    this_pri = table.get_priority(mat_id)
    false_hit = this_pri > hp_pri

    n_i = _take(table.n_i, mat_id)
    t_r = _take(table.t_r, mat_id)
    transparent = t_r > 0
    n_s_local = table.phong_exponent(mat_id, uv)

    d_in_n = linalg.dot(v_in, normal)
    entering_geom = d_in_n <= 0

    # ---- refraction branch ---------------------------------------------
    hp_ior = table.get_ior(hp_id)
    shp_ior = table.get_ior(shp_id)

    cos1_in = -d_in_n
    rp_in = sampling.schlick_reflectance(cos1_in, hp_ior, n_i)
    refract_in = (u_choice >= rp_in) | force_refract
    v_refr_in = _snell_out_dir(v_in, normal, cos1_in, hp_ior / n_i, -ones)
    v_refl_in = linalg.normalize(linalg.reflect(v_in, normal), SMALL_EPS)

    cos1_out = d_in_n
    sin1_out = linalg.safe_sqrt(1.0 - cos1_out * cos1_out)
    sin1_max = shp_ior / n_i
    rp_out = sampling.schlick_reflectance(cos1_out, n_i, shp_ior)
    reflect_out = ((sin1_out >= sin1_max) | (u_choice <= rp_out)) & (not force_refract)
    v_refr_out = _snell_out_dir(v_in, normal, cos1_out, n_i / shp_ior, ones)
    v_refl_out = linalg.normalize(linalg.reflect(v_in, -normal), SMALL_EPS)

    refracted_t = torch.where(entering_geom, refract_in, ~reflect_out)
    v_out_t = torch.where(
        entering_geom[..., None],
        torch.where(refract_in[..., None], v_refr_in, v_refl_in),
        torch.where(reflect_out[..., None], v_refl_out, v_refr_out),
    )
    entering_t = entering_geom & refract_in
    next_t = torch.where(
        entering_geom,
        torch.where(refract_in, mat_id, hp_id),
        torch.where(reflect_out, mat_id, shp_id),
    )
    bent_t = refracted_t & torch.where(
        entering_geom,
        torch.abs(hp_ior - n_i) > SMALL_EPS,
        torch.abs(shp_ior - n_i) > SMALL_EPS,
    )

    dir_t = sampling.generate_direction(v_out_t, normal, ones_i, n_s_local, u_lobe1, u_lobe2)
    k_t = _take(table.tf, mat_id) * t_r[..., None]
    filt_t = sampling.phong_filter(k_t, n_s_local, v_out_t, dir_t)
    filt2_t = sampling.phong_filter_2(k_t, n_s_local, v_out_t, dir_t)
    # second interface factor when passing into a different medium
    has_next2 = (next_t >= 0) & (next_t != mat_id)
    k2 = table.transmission_k(next_t)
    n_s2 = table.phong_exponent(next_t, uv)
    k_t = torch.where(has_next2[..., None], k_t * k2, k_t)
    filt_t = torch.where(
        has_next2[..., None], filt_t * sampling.phong_filter(k2, n_s2, v_out_t, dir_t), filt_t
    )
    filt2_t = torch.where(
        has_next2[..., None], filt2_t * sampling.phong_filter_2(k2, n_s2, v_out_t, dir_t), filt2_t
    )

    # ---- opaque branch ---------------------------------------------------
    kd_tex = table.diffuse_color(mat_id, uv)
    ks_tex = table.specular_color(mat_id, uv)
    kd_len = linalg.length(kd_tex)
    ks_len = linalg.length(ks_tex)
    denom = kd_len + ks_len
    # kd=ks=0 (pure emitters): the reference's 0/0 lands in the specular
    # branch — reproduced via spec_prob = 1
    spec_prob = torch.where(denom > 0, ks_len / torch.clamp(denom, min=1e-20), 1.0)
    choose_spec = u_pick <= spec_prob

    dir_diff = sampling.generate_direction(
        torch.zeros_like(v_in), normal, torch.zeros_like(ones_i), ones, u_lobe1, u_lobe2
    )
    refl_dir = linalg.normalize(linalg.reflect(v_in, normal), SMALL_EPS)
    dir_spec = sampling.generate_direction(refl_dir, normal, ones_i, n_s_local, u_lobe1, u_lobe2)
    filt_spec = sampling.phong_filter(ks_tex, n_s_local, refl_dir, dir_spec)
    filt2_spec = sampling.phong_filter_2(ks_tex, n_s_local, refl_dir, dir_spec)

    cs = choose_spec[..., None]
    dir_o = torch.where(cs, dir_spec, dir_diff)
    filt_o = torch.where(cs, filt_spec, kd_tex)
    filt2_o = torch.where(cs, filt2_spec, kd_tex)
    k_o = torch.where(cs, ks_tex, kd_tex)
    n_o = torch.where(choose_spec, n_s_local, 1.0)
    sss_o = ~choose_spec & (_take(table.path_length, mat_id) > 0)

    # ---- blend the three paths -------------------------------------------
    use_refr = ~false_hit & transparent
    use_opaque = ~false_hit & ~transparent
    fh, ur = false_hit[..., None], use_refr[..., None]

    direction = torch.where(fh, v_in, torch.where(ur, dir_t, dir_o))
    perfect = torch.where(ur, v_out_t, torch.where(cs, refl_dir, normal))
    filt = torch.where(fh, 1.0, torch.where(ur, filt_t, filt_o))
    filt2 = torch.where(fh, 1.0, torch.where(ur, filt2_t, filt2_o))
    k = torch.where(fh, 1.0, torch.where(ur, k_t, k_o))
    n_eff = torch.where(false_hit, 1.0, torch.where(use_refr, n_s_local, n_o))
    diffuse = use_opaque & ~choose_spec
    reflected = torch.where(use_refr, ~refracted_t, use_opaque & choose_spec)
    refracted = false_hit | (use_refr & refracted_t)
    entering = torch.where(false_hit, entering_geom, use_refr & entering_t)
    bent = use_refr & bent_t
    sss = use_opaque & sss_o
    next_mat = torch.where(false_hit, hp_id, torch.where(use_refr, next_t, hp_id))

    # pdf = sampling_pdf_2 * pi / scattering_pdf
    samp_pdf = sampling.sampling_pdf_2(
        normal, direction, diffuse, n_eff, v_in, perfect, refracted & ~false_hit
    )
    scat_pdf = sampling.scattering_pdf(normal, direction, diffuse, v_in, refracted & ~false_hit)
    pdf = samp_pdf * math.pi / torch.where(scat_pdf != 0, scat_pdf, 1.0)
    pdf = torch.where(false_hit, 1.0, pdf)

    return ReflectionRecord(
        origin=hit_point,
        dir=direction,
        k=k,
        filter=filt,
        filter_2=filt2,
        perfect_dir=perfect,
        pdf=pdf,
        n=n_eff,
        diffuse=diffuse,
        reflected=reflected,
        refracted=refracted,
        false_hit=false_hit,
        entering=entering,
        bent=bent,
        sss=sss,
        next_mat=next_mat.to(torch.int32),
    )
