"""Stochastic progressive photon mapping (SPPM) with participating media
(port of `gpu_pathtracer_tpu.render.sppm`): the forward render and the
differentiable one.

* eye pass: per pixel, trace through the specular / refractive chain to the
  first diffuse hit (a wavefront loop, at most 64 bounces), accumulating the
  `filter_2` products and the per-segment Beer-Lambert transmittance; at the
  diffuse hit, direct radiance by light sampling and a forced-refraction
  shadow chain.  The init pass also shoots 4 corner rays per pixel and sets
  the initial gather radius to the least pairwise hit distance.
* photon pass: emit from emitters in proportion to their mean energy, bounce
  with the dielectric stack; in media sample propagation distances and
  deposit VOLUME photons on scatter events; on surfaces Russian roulette on
  max(k) and SURFACE photons at diffuse hits after the first bounce.
* gathers: all-pairs reductions for small workloads, a spatial hash grid
  (`ops/hashgrid.py`) for large ones; the K nearest in-radius photons of a
  pixel are visibility-checked with the windowed any-hit query
  (`ops.trace.occluded_window`: on the card a hand-written kernel).
* per-pixel update: flux -> radiance `filter * flux / (N * pi * r^2)`, radius
  schedule `r *= ((i + alpha) / (i + 1))^(1/2)` on surfaces and `^(1/3)` in
  volumes from iteration 2.

`render_sppm` is the forward render (numpy image, debug images, checkpoints,
auto-raised gather caps).  `render_sppm_differentiable` returns the image as
a tensor that carries gradient to the material table (notably `ke`: the
photon colours through `ops.lights.leaf_energies`' energy normalization, the
direct chain through `emission_color`).  Its passes run the photon and eye
passes with `differentiable=True`; the gathers' candidate topology (hash
grid, cell lookup, top-k pick, any-hit visibility) runs under
`torch.no_grad()` and their contributions stay differentiable.  The
kernels return non-differentiable results, so no pass needs a custom
backward.

Randomness.  Every stochastic function takes either a `torch.Generator` or
explicit uniforms in [0, 1) (a dict of tensors whose layout the function's
docstring gives), so a test can feed the reference package's numbers.  Loops
run while any ray is alive, which costs one host synchronization per step;
each is a `loop_exit` of the port's tracer (`tracing`).

Scale-out.  Both renders take `pixel_sharding`, a `parallel.shard.Mesh`
whose ranks split the pixels (`Columns`): each rank draws the whole batch's
numbers and keeps its columns, and every loop exit, compaction, gather cap,
grid cell and average is decided over all ranks, so the ranks trace what the
unsharded render traces and meet in every collective alike.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
import pathlib
import time

import numpy as np
import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import MATERIAL_STACK_SIZE, SMALL_EPS
from gpu_pathtracer_tpu_torch.models.scene import Scene
from gpu_pathtracer_tpu_torch.ops import bounding_sphere, hashgrid
from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
from gpu_pathtracer_tpu_torch.ops import linalg, materials, sampling, trace
from gpu_pathtracer_tpu_torch.ops.surface import interpolate_hit

# eye-pass straggler compaction starts at this batch width (0 disables)
EYE_COMPACT_MIN = 65536
# gather caps: photons tested for visibility per pixel, photons taken per grid
# cell, and the ceiling that the automatic raising stops at
K_NEAREST = 16
K_PER_CELL = 8
AUTO_CAPS_MAX = 256
# hash-grid gathers once pixels * photons exceeds this
GRID_MIN_PAIRS = 1 << 24

STACK_PROBE_STEPS = 8  # steps of `init_material_stack`
DIRECT_CHAIN_STEPS = 8  # steps of the direct-radiance shadow chain
PHOTON_STEP_UNIFORMS = 10  # per photon-pass step: see `photon_pass`

def _host_any(mask: torch.Tensor) -> bool:
    tracing.count("loop_exit")
    return bool(mask.any())


def _host_int(x: torch.Tensor) -> int:
    tracing.count("loop_exit")
    return int(x)


def _draw(uniforms, name: str, index, shape, generator, device) -> torch.Tensor:
    """`uniforms[name][index]` when explicit uniforms are given, else a fresh
    draw of `shape` from `generator`."""
    if uniforms is None:
        return torch.rand(shape, generator=generator, device=device)
    u = uniforms[name]
    if index is not None:
        u = u[index]
    return u.to(device)[..., : shape[-1]]


@dataclasses.dataclass(frozen=True)
class Columns:
    """The columns [lo, hi) of a batch of `width` rays that this process
    traces.  With `mesh` (a `parallel.shard.Mesh`) the batch is sharded over
    the mesh's ranks: each rank draws the whole batch's numbers and keeps its
    own columns, and every count or extreme that decides a loop, a cap or a
    grid is taken over all ranks, so a sharded pass traces what the unsharded
    one does, and every rank reaches every collective as often as the others
    and in the same order.  Without a mesh the whole batch is here."""

    lo: int
    hi: int
    width: int
    mesh: object = None

    @staticmethod
    def whole(width: int) -> "Columns":
        return Columns(0, width, width)

    @staticmethod
    def share(mesh, n: int) -> "Columns":
        """This rank's even share of `n` columns (a multiple of the mesh size)."""
        per = n // mesh.size
        return Columns(mesh.rank * per, (mesh.rank + 1) * per, n, mesh)

    def draw(self, uniforms, name: str, index, rows: tuple, generator, device) -> torch.Tensor:
        """`_draw` at the batch's full width (`rows` + (width,)), cut to these
        columns."""
        u = _draw(uniforms, name, index, tuple(rows) + (self.width,), generator, device)
        return u[..., self.lo:self.hi]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh is None else self.mesh.all_reduce(t)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh is None else self.mesh.all_reduce(t, "max")

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `t`, in rank order (the whole batch)."""
        return t if self.mesh is None else self.mesh.all_gather(t)

    def count(self, x: torch.Tensor) -> int:
        """The sum of `x` over the batch as a Python int (a host
        synchronization)."""
        tracing.count("loop_exit")
        return int(self.sum(x.sum().reshape(1)))

    def any(self, mask: torch.Tensor) -> bool:
        return _host_any(mask) if self.mesh is None else self.count(mask) > 0

    def stage(self, n_mine: int, width: int) -> "Columns":
        """The columns of this rank's `n_mine` rays in a batch of `width`
        made of every rank's rays in rank order (a compaction stage)."""
        if self.mesh is None:
            return Columns(0, n_mine, width)
        counts = self.mesh.all_gather(torch.tensor([n_mine], device=self.mesh.device)).tolist()
        lo = sum(counts[:self.mesh.rank])
        return Columns(lo, lo + n_mine, width, self.mesh)


def _shard_pixels(mesh, pix_i, pix_j):
    """This rank's pixels of a frame sharded over `mesh`: the batch padded
    with pixel (0, 0) to a multiple of the mesh size (the pad is dropped at
    assembly), and the rank's `Columns` of it."""
    pad = (-pix_i.shape[0]) % mesh.size
    if pad:
        zeros = pix_i.new_zeros((pad,))
        pix_i, pix_j = torch.cat([pix_i, zeros]), torch.cat([pix_j, zeros])
    cols = Columns.share(mesh, pix_i.shape[0])
    return pix_i[cols.lo:cols.hi], pix_j[cols.lo:cols.hi], cols


# ---------------------------------------------------------------------------
# media helpers
# ---------------------------------------------------------------------------

def _take(table_field, mat_id):
    return table_field[torch.clamp(mat_id, min=0).long()]


def extinction_coef(table, mat_id):
    ext = _take(table.scattering_coef, mat_id) + _take(table.absorption_coef, mat_id)
    return torch.where(mat_id < 0, 0.0, ext)


def transmittance(table, mat_id, dist):
    """Beer-Lambert exp(-t * sigma_t); 1 outside media."""
    ext = extinction_coef(table, mat_id)
    return torch.where(ext > SMALL_EPS, torch.exp(-dist * ext), 1.0)


def scattering_prob(table, mat_id):
    ext = extinction_coef(table, mat_id)
    return torch.where(ext > 0, _take(table.scattering_coef, mat_id) / torch.clamp(ext, min=1e-20),
                       0.0)


def check_entering_medium(table, ref, in_medium, medium_id):
    entering = (
        ~ref.false_hit & (ref.next_mat >= 0) & (extinction_coef(table, ref.next_mat) > SMALL_EPS)
    ) | (ref.false_hit & in_medium)
    return entering, torch.where(entering, ref.next_mat, medium_id)


def sample_hg_direction(table, medium_id, current_dir, u1, u2):
    """Henyey-Greenstein scattering direction: cos(theta) by inverse CDF from
    `u1`, the azimuth from `u2`, in the frame of the current direction."""
    g = _take(table.g, medium_id)
    cos_t = torch.clamp(sampling.henyey_greenstein_cos_theta(g, u1), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    x, y, z = linalg.onb_from_z(current_dir)
    return linalg.to_world(x, y, z, local)


def sample_propagation_distance(table, medium_id, u):
    """-ln(xi) / sigma_t with xi in [1e-12, 1) made from the uniform `u`."""
    xi = torch.clamp(u * (1.0 - 1e-12) + 1e-12, min=1e-12)
    return -torch.log(xi) / torch.clamp(extinction_coef(table, medium_id), min=1e-20)


# ---------------------------------------------------------------------------
# dielectric-stack initialization
# ---------------------------------------------------------------------------

def init_material_stack(scene: Scene, point, init_dir, stack_size: int = MATERIAL_STACK_SIZE,
                        max_steps: int = STACK_PROBE_STEPS, generator=None, uniforms=None,
                        cols: Columns | None = None):
    """March from far away (t = 999) back toward `point` through the
    transparent geometry with forced refraction, pushing and popping media, so
    a camera or an emitter inside glass or fog starts with the right stack.
    Returns (stack_ids, stack_len).

    `uniforms`: (max_steps, 4, R), step i's four `sample_bsdf` uniforms.
    `cols`: the rays' columns of a sharded batch (default: the whole)."""
    r = point.shape[0]
    dev = point.device
    cols = cols or Columns.whole(r)
    ids, length = materials.stack_init((r,), stack_size, device=dev)
    tset = scene.transparent
    if tset is None:
        return ids, length

    t_rem = torch.full((r,), 999.0, dtype=torch.float32, device=dev)
    origin = point + t_rem[..., None] * init_dir
    probe_dir = -init_dir
    live = torch.ones((r,), dtype=torch.bool, device=dev)
    wrapped = None if uniforms is None else {"stack": uniforms}
    for i in range(max_steps):
        t, slot, bary, hit = trace.closest_hit(tset, origin, probe_dir, live=live)
        live = live & hit & (t_rem - t > SMALL_EPS)
        if not cols.any(live):
            break
        t_rem = torch.where(live, t_rem - t, t_rem)
        pt, uv, normal, mat_id = interpolate_hit(tset, scene.materials, slot, bary)
        ref = materials.sample_bsdf(
            scene.materials, mat_id, pt, probe_dir, normal, uv, ids, length,
            cols.draw(wrapped, "stack", i, (4,), generator, dev), force_refract=True,
        )
        ids, length = materials.stack_rearrange(
            ids, length, mat_id, ref.false_hit, ref.entering, ref.refracted, live
        )
        origin = torch.where(live[..., None], pt, origin)
    return ids, length


# ---------------------------------------------------------------------------
# photon map
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Photons:
    pos: torch.Tensor  # (P, 3)
    color: torch.Tensor  # (P, 3)
    direction: torch.Tensor  # (P, 3) travel direction at deposit
    prev: torch.Tensor  # (P, 3) previous interaction location
    on_surface: torch.Tensor  # (P,) bool
    valid: torch.Tensor  # (P,) bool


_PH_SURF, _PH_MARCH = 0, 1


def _records_grad_if_differentiable(fn):
    """Runs `fn` under autograd only when it is called with
    `differentiable=True` and grad mode is on, else under `torch.no_grad()`."""
    signature = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        differentiable = signature.bind(*args, **kwargs).arguments.get("differentiable", False)
        with torch.set_grad_enabled(bool(differentiable) and torch.is_grad_enabled()):
            return fn(*args, **kwargs)

    return wrapped


@_records_grad_if_differentiable
def photon_pass(scene: Scene, n_photons: int, max_bounce: int = 16,
                stack_size: int = MATERIAL_STACK_SIZE, generator=None, uniforms=None,
                differentiable: bool = False) -> Photons:
    """Wavefront photon tracing: one deposit slot per photon, the loop runs
    while any photon is alive and for at most 4 * max_bounce + 32 steps.

    `differentiable=True` records the pass for autograd: the deposited
    colours carry gradient to the material table (emission through
    `lights.leaf_energies` and the energy normalization; the emitter pick,
    Russian roulette and scatter events are index or comparison outputs, the
    pathwise gradient without the score term).  Otherwise the pass runs
    under `torch.no_grad()`.  The outputs are the same either way.  Both
    modes keep the early exit (a host synchronization a step): every state
    update is masked, so the steps after the last photon dies change
    nothing, and leaving them out keeps them out of the autograd graph (the
    reference's differentiable mode runs all 4 * max_bounce + 32 steps as a
    bounded scan because XLA cannot differentiate a while loop).

    `uniforms`: {"emit": (5, P) emitter pick, two barycentric, two direction
    uniforms; "stack": (8, 4, P) for `init_material_stack`; "steps":
    (4 * max_bounce + 32, 10, P), per step rows 0-3 `sample_bsdf`, 4 the
    surface's propagation distance, 5 Russian roulette, 6 the scatter test,
    7-8 the Henyey-Greenstein direction, 9 the march's new distance}."""
    lt = scene.light_tree
    table = scene.materials
    g = scene.geom
    dev = g.p.device
    p = n_photons
    f32 = dict(dtype=torch.float32, device=dev)

    # emitter pick in proportion to accumulated mean energy
    leaf_energy = lights_mod.leaf_energies(lt, table, g.mat_id)
    acc = torch.cumsum(linalg.de_nan(torch.mean(leaf_energy, dim=-1)), dim=0)
    max_energy = acc[-1]
    u_emit = _draw(uniforms, "emit", None, (5, p), generator, dev)
    leaf = torch.clamp(
        torch.searchsorted(acc.detach(), (u_emit[0] * max_energy.detach()).contiguous()),
        0, lt.num_lights - 1,
    )

    # uniform point and interpolated attributes on the emitter
    s = torch.sqrt(torch.clamp(u_emit[1], min=0.0))
    bu = 1.0 - s
    bv = u_emit[2] * s
    bary = torch.stack([bu, bv, 1.0 - bu - bv], dim=-1)
    point = torch.sum(bary[..., None] * lt.tri_p[leaf], dim=-2)
    normal = linalg.normalize(torch.sum(bary[..., None] * lt.tri_n[leaf], dim=-2), SMALL_EPS)
    uv = torch.sum(bary[..., None] * lt.tri_uv[leaf], dim=-2)
    mat_id = g.mat_id[lt.geom_slot[leaf].long()]

    # photon colour normalized to constant mean energy
    color = table.emission_color(mat_id, uv)
    mean0 = torch.mean(color, dim=-1)
    color = color * torch.where(
        mean0 > 1e-20, max_energy / torch.where(mean0 > 1e-20, mean0, 1.0), 0.0
    )[..., None]
    mean_color = torch.mean(color, dim=-1)

    # fake incoming ray: hemisphere sample about the normal, negated
    coming_dir = -sampling.generate_direction(
        normal, normal, torch.full((p,), 2, dtype=torch.int32, device=dev),
        torch.ones((p,), **f32), u_emit[3], u_emit[4],
    )

    stack_ids, stack_len = init_material_stack(
        scene, point, normal, stack_size, generator=generator,
        uniforms=None if uniforms is None else uniforms["stack"],
    )

    zeros = torch.zeros((p,), **f32)
    false = torch.zeros((p,), dtype=torch.bool, device=dev)
    st = dict(
        # current surface interaction
        pt=point, nrm=normal, uv=uv, mat=mat_id, coming=coming_dir,
        # current march ray (phase MARCH)
        m_o=point, m_d=coming_dir, m_dsamp=zeros, m_t=zeros, m_pt=point,
        color=color, prev=point,
        stack_ids=stack_ids, stack_len=stack_len,
        in_medium=false, medium=torch.full((p,), -1, dtype=torch.int32, device=dev),
        scattered_ever=false, dcs=false,  # dcs: direct_check_surface
        phase=torch.full((p,), _PH_SURF, dtype=torch.int32, device=dev),
        nb=torch.full((p,), -1, dtype=torch.int32, device=dev),
        alive=torch.ones((p,), dtype=torch.bool, device=dev),
        # deposit slots
        d_pos=torch.full((p, 3), float("inf"), **f32), d_color=torch.ones((p, 3), **f32),
        d_dir=torch.zeros((p, 3), **f32), d_prev=torch.zeros((p, 3), **f32),
        d_surf=false, d_valid=false,
    )

    def body(st, u):
        surf = st["alive"] & (st["phase"] == _PH_SURF)
        march = st["alive"] & (st["phase"] == _PH_MARCH)

        # ---------------- SURF step ----------------
        nb = torch.where(surf, st["nb"] + 1, st["nb"])
        ref = materials.sample_bsdf(
            table, st["mat"], st["pt"], st["coming"], st["nrm"], st["uv"],
            st["stack_ids"], st["stack_len"], u[0:4],
        )
        stack_ids, stack_len = materials.stack_rearrange(
            st["stack_ids"], st["stack_len"], st["mat"],
            ref.false_hit, ref.entering, ref.refracted, surf & (nb > 0),
        )
        entering_m, medium = check_entering_medium(table, ref, st["in_medium"], st["medium"])
        in_medium = torch.where(surf, entering_m, st["in_medium"])
        medium = torch.where(surf, medium, st["medium"])

        want_march = surf & ~ref.false_hit & in_medium & ~st["dcs"]
        d_samp = sample_propagation_distance(table, medium, u[4])

        # MARCH-phase proposal ray (state and uniforms only, so it is known
        # before the traversal)
        p_s = scattering_prob(table, medium)
        deposit_vol = march & (u[6] < p_s)
        keep_march = march & ~deposit_vol
        hg_dir = sample_hg_direction(table, medium, st["m_d"], u[7], u[8])
        d_new = sample_propagation_distance(table, medium, u[9])
        # move by the NEW distance along the OLD direction, then turn (the
        # reference's ordering)
        o_new = st["m_o"] + d_new[..., None] * st["m_d"]

        # one merged traversal per step: a photon is in exactly one phase
        q_o = torch.where(march[..., None], o_new, ref.origin)
        q_d = torch.where(march[..., None], hg_dir, ref.dir)
        t_q, slot_q, bary_q, hit_q = trace.closest_hit(
            g, q_o, q_d, live=st["alive"] & ~deposit_vol
        )
        pt_q, uv_q, nrm_q, mat_q = interpolate_hit(g, table, slot_q, bary_q)

        t_hit = torch.where(hit_q, t_q, float("inf"))
        march_now = want_march & (d_samp - t_hit < SMALL_EPS)
        dcs = torch.where(want_march & ~march_now, True, st["dcs"])

        # Russian roulette on surfaces
        do_rr = surf & ~march_now & ~ref.false_hit & (nb > 0)
        k_max = torch.amax(ref.k, dim=-1)
        absorbed = do_rr & (u[5] > k_max)
        deposit_surf = absorbed & ref.diffuse & ((nb > 1) | st["scattered_ever"])
        new_color = st["color"] * ref.k
        mean_raw = torch.mean(new_color, dim=-1)
        scale = torch.where(
            mean_raw > 1e-20, mean_color / torch.where(mean_raw > 1e-20, mean_raw, 1.0), 0.0
        )
        new_color = new_color * scale[..., None]
        survive = do_rr & ~absorbed
        color = torch.where(survive[..., None], new_color, st["color"])
        dcs = torch.where(survive, False, dcs)

        # advance to the next surface (skipped when entering a march)
        advance = surf & ~march_now & ~absorbed
        adv3 = advance[..., None]
        prev = torch.where(adv3, st["pt"], st["prev"])
        new_pt = torch.where(adv3, pt_q, st["pt"])
        new_nrm = torch.where(adv3, nrm_q, st["nrm"])
        new_uv = torch.where(adv3, uv_q, st["uv"])
        new_mat = torch.where(advance, mat_q, st["mat"])
        new_coming = torch.where(adv3, ref.dir, st["coming"])
        alive = st["alive"] & torch.where(advance, hit_q & (nb < max_bounce), ~absorbed)

        # enter march: record the march ray and its surface hit
        mn3 = march_now[..., None]
        m_o = torch.where(mn3, ref.origin, st["m_o"])
        m_d = torch.where(mn3, ref.dir, st["m_d"])
        m_dsamp = torch.where(march_now, d_samp, st["m_dsamp"])
        m_t = torch.where(march_now, t_hit, st["m_t"])
        m_pt = torch.where(mn3, pt_q, st["m_pt"])
        phase = torch.where(march_now, _PH_MARCH, st["phase"])
        scattered_ever = st["scattered_ever"] | march_now

        # ---------------- MARCH step (traversal merged above) ----------------
        km3 = keep_march[..., None]
        prev = torch.where(km3, m_pt, prev)
        still = keep_march & (d_new - t_hit < SMALL_EPS)
        exit_march = keep_march & ~still

        m_o = torch.where(km3, o_new, m_o)
        m_d = torch.where(km3, hg_dir, m_d)
        m_dsamp = torch.where(keep_march, d_new, m_dsamp)
        m_pt = torch.where(km3, pt_q, m_pt)

        # march exit: the surface hit becomes the next interaction
        ex3 = exit_march[..., None]
        new_pt = torch.where(ex3, pt_q, new_pt)
        new_nrm = torch.where(ex3, nrm_q, new_nrm)
        new_uv = torch.where(ex3, uv_q, new_uv)
        new_mat = torch.where(exit_march, mat_q, new_mat)
        new_coming = torch.where(ex3, m_d, new_coming)
        phase = torch.where(exit_march, _PH_SURF, phase)
        dcs = torch.where(exit_march, True, dcs)
        alive = alive & torch.where(exit_march, hit_q, True)

        # deposits (once per photon)
        can = ~st["d_valid"]
        dep_s = deposit_surf & can
        dep_v = deposit_vol & can
        dep = (dep_s | dep_v)[..., None]
        vol_pos = m_o + m_dsamp[..., None] * m_d
        d_pos = torch.where(dep_s[..., None], st["pt"],
                            torch.where(dep_v[..., None], vol_pos, st["d_pos"]))
        d_dir = torch.where(dep_s[..., None], st["coming"],
                            torch.where(dep_v[..., None], m_d, st["d_dir"]))
        alive = alive & ~deposit_vol  # a volume deposit ends the photon

        return dict(
            pt=new_pt, nrm=new_nrm, uv=new_uv, mat=new_mat, coming=new_coming,
            m_o=m_o, m_d=m_d, m_dsamp=m_dsamp, m_t=m_t, m_pt=m_pt,
            color=color, prev=prev,
            stack_ids=stack_ids, stack_len=stack_len,
            in_medium=in_medium, medium=medium,
            scattered_ever=scattered_ever, dcs=dcs, phase=phase, nb=nb, alive=alive,
            d_pos=d_pos, d_color=torch.where(dep, color, st["d_color"]), d_dir=d_dir,
            d_prev=torch.where(dep, st["prev"], st["d_prev"]),
            d_surf=torch.where(dep_s, True, st["d_surf"]), d_valid=st["d_valid"] | dep_s | dep_v,
        )

    max_steps = 4 * max_bounce + 32
    step = 0
    while step < max_steps and _host_any(st["alive"]):
        st = body(st, _draw(uniforms, "steps", step, (PHOTON_STEP_UNIFORMS, p), generator, dev))
        step += 1
    return Photons(pos=st["d_pos"], color=st["d_color"], direction=st["d_dir"],
                   prev=st["d_prev"], on_surface=st["d_surf"], valid=st["d_valid"])


# ---------------------------------------------------------------------------
# gathers
# ---------------------------------------------------------------------------

def _beam_contrib(table, medium, seg_dir, radius, d_par, d_perp, inside, pdir, pcolor):
    """Radiance of candidate photons to a beam: kernel * transmittance *
    sigma_s * phase * colour, summed over the candidate axis.  `medium`,
    `radius` are (R,), `seg_dir` (R, 3), the pair arrays (R, C[, 3])."""
    rr = radius[:, None]
    kernel = (1.0 / (rr * rr)) * sampling.silverman_biweight(d_perp / rr)
    tr = transmittance(table, medium[:, None], d_par)
    sigma_s = _take(table.scattering_coef, medium)
    phase = sampling.henyey_greenstein_pdf(_take(table.g, medium)[:, None], seg_dir[:, None, :],
                                           pdir)
    contrib = ((kernel > SMALL_EPS) * inside * kernel * tr * sigma_s[:, None]
               * phase)[..., None] * pcolor
    return torch.sum(linalg.de_nan(contrib), dim=1)


def volume_gather_segment(table, photons: Photons, medium_id, seg_start, seg_dir, seg_len,
                          vol_radius, enable):
    """Volumetric beam gather along one camera-path segment per ray: photons
    inside the cylinder of `vol_radius` around it contribute.  (R, 3)."""
    vphot = photons.valid & ~photons.on_surface  # (P,)
    w = photons.pos[None, :, :] - seg_start[:, None, :]  # (R, P, 3)
    d_par = torch.sum(w * seg_dir[:, None, :], dim=-1)
    d_perp = linalg.length(w - d_par[..., None] * seg_dir[:, None, :])
    r = torch.clamp(vol_radius, min=1e-20)
    inside = (vphot[None, :] & enable[:, None] & (d_par >= 0) & (d_par <= seg_len[:, None])
              & (d_perp <= r[:, None]))
    return _beam_contrib(table, medium_id, seg_dir, r, d_par, d_perp, inside,
                         photons.direction[None, :, :], photons.color[None, :, :])


def volume_gather_segments_dense(table, photons: Photons, seg_start, seg_dir, seg_len,
                                 seg_medium, seg_filt, seg_valid, vol_radius):
    """Beam gather over recorded eye-path medium segments, all pairs:
    sum_s filt_s * volume_gather_segment(segment_s).  Segment arrays are
    (R, S[, 3]); returns (R, 3)."""
    out = torch.zeros((seg_start.shape[0], 3), dtype=torch.float32, device=seg_start.device)
    for k in range(seg_start.shape[1]):
        lm = volume_gather_segment(
            table, photons, seg_medium[:, k], seg_start[:, k], seg_dir[:, k], seg_len[:, k],
            vol_radius, seg_valid[:, k],
        )
        out = out + seg_filt[:, k] * lm
    return out


VOLUME_GRID_MAX_STEPS = 512  # sample points per segment of the grid beam gather


def _beam_spacing(seg_valid, vol_radius, cols: Columns | None = None):
    r_max = torch.amax(torch.where(seg_valid.any(dim=1), vol_radius, 0.0))
    if cols is not None:
        r_max = cols.max(r_max)
    return torch.clamp(r_max, min=1e-12)


def volume_gather_segments_grid(table, photons: Photons, seg_start, seg_dir, seg_len,
                                seg_medium, seg_filt, seg_valid, vol_radius,
                                k_per_cell: int = K_PER_CELL, chunk: int = 4096,
                                static_steps: int | None = None, cols: Columns | None = None):
    """Hash-grid beam gather over recorded medium segments.  Grid cell =
    1.5 r_max, sample points r_max apart along each segment; a photon within
    r <= r_max of the axis is within one cell of its canonical sample point
    i = round(d_par / r_max), so the 27-cell neighbourhood cannot miss it,
    and counting it only at step i removes duplicates across overlapping
    neighbourhoods.  Only the recorded (valid) segments are visited.

    The step loop runs `static_steps` sample points when it is given (a
    Python int: no host synchronization on the longest segment), else as
    many as the longest segment needs, at most `VOLUME_GRID_MAX_STEPS`;
    segments needing more lose their tail.  The grid and the candidate
    lookup run under `torch.no_grad()`; the contributions carry gradient.
    `cols`, the segments' rays' columns of a sharded batch: the spacing is
    then the largest radius over every rank's."""
    vphot = photons.valid & ~photons.on_surface
    spacing = _beam_spacing(seg_valid, vol_radius, cols).detach()
    with torch.no_grad():
        grid = hashgrid.build_grid(photons.pos, vphot, 1.5 * spacing)

    r_total, s = seg_start.shape[:2]
    q_total = r_total * s
    f_valid = seg_valid.reshape(q_total)
    # valid slots first (stable), and only those are visited
    order = torch.sort((~f_valid).to(torch.int8), stable=True).indices
    n_valid = _host_int(f_valid.sum())
    lm = torch.zeros((q_total, 3), dtype=torch.float32, device=seg_start.device)
    if n_valid:
        order = order[:n_valid]
        f_start = seg_start.reshape(q_total, 3)[order]
        f_dir = seg_dir.reshape(q_total, 3)[order]
        f_len = seg_len.reshape(q_total)[order]
        f_med = seg_medium.reshape(q_total)[order].to(torch.int32)
        f_radius = torch.clamp(vol_radius.repeat_interleave(s)[order], min=1e-20)
        if static_steps is None:
            n_steps = min(VOLUME_GRID_MAX_STEPS,
                          _host_int(torch.amax(torch.ceil(f_len / spacing))) + 1)
        else:
            n_steps = static_steps
        for c0 in range(0, n_valid, chunk):
            sl = slice(c0, c0 + chunk)
            st, dr, ln, med, rr = f_start[sl], f_dir[sl], f_len[sl], f_med[sl], f_radius[sl]
            last = torch.ceil(ln / spacing)
            acc = torch.zeros((st.shape[0], 3), dtype=torch.float32, device=st.device)
            for i in range(n_steps):
                with torch.no_grad():
                    cand, ok = hashgrid.query_candidates(grid, st + (i * spacing) * dr,
                                                         k_per_cell)
                cand = cand.long()
                w = photons.pos[cand] - st[:, None, :]  # (C, 27K, 3)
                d_par = torch.sum(w * dr[:, None, :], dim=-1)
                d_perp = linalg.length(w - d_par[..., None] * dr[:, None, :])
                canonical = torch.round(d_par / spacing).to(torch.int32) == i
                inside = (ok & (i <= last)[:, None] & canonical & (d_par >= 0)
                          & (d_par <= ln[:, None]) & (d_perp <= rr[:, None]))
                acc = acc + _beam_contrib(table, med, dr, rr, d_par, d_perp, inside,
                                          photons.direction[cand], photons.color[cand])
            lm[order[sl]] = acc
    return torch.sum(seg_filt * lm.reshape(r_total, s, 3), dim=1)


def _visible_flux(g, photon_prev, photon_dir, photon_color, top_idx, cand_ok, loc, nrm):
    """Flux and count of the candidates `top_idx` (R, K rows of the photon
    arrays) that are visible from `loc`: a ray toward each photon's previous
    location must hit something, and nothing before that location (with a
    relative tolerance of 1e-3 on the length).  The verdict runs under
    `torch.no_grad()`; the flux carries the photons' colours' gradient."""
    top_idx = top_idx.long()
    with torch.no_grad():
        ray_vec = photon_prev[top_idx] - loc[:, None, :]  # (R, K, 3)
        ray_len = linalg.length(ray_vec)
        ray_dir = linalg.normalize(ray_vec, SMALL_EPS)
        r, kk = ray_dir.shape[:2]
        occ_near, occ_far = trace.occluded_window(
            g,
            loc[:, None, :].expand(r, kk, 3).reshape(-1, 3),
            ray_dir.reshape(-1, 3),
            (ray_len * (1.0 - 1e-3)).reshape(-1),
            live=cand_ok.reshape(-1),  # no ray for slots without an in-radius photon
        )
        visible = cand_ok & (occ_far & ~occ_near).reshape(r, kk)
    fac = torch.clamp(torch.sum(nrm[:, None, :] * (-photon_dir[top_idx]), dim=-1), min=0.0)
    flux = torch.sum((visible * fac)[..., None] * photon_color[top_idx], dim=1)
    return flux, torch.sum(visible, dim=-1)


def surface_gather_grid(scene: Scene, photons: Photons, hp_loc, hp_normal, hp_radius, hp_valid,
                        k_nearest: int = K_NEAREST, k_per_cell: int = K_PER_CELL,
                        chunk: int = 16384, return_overflow: bool = False,
                        cols: Columns | None = None):
    """Hash-grid surface photon gather: each hit point inspects the 27 cells
    around it (cell = the largest radius of a valid pixel), keeps the
    `k_nearest` nearest in-radius candidates and checks their visibility as
    the dense gather does.  Returns (flux (R, 3), count (R,)); with
    `return_overflow` also the total of candidates dropped by the cell cap
    and of in-radius photons dropped by the `k_nearest` reduction.  The
    candidate topology (grid, cell lookup, top-k pick) runs under
    `torch.no_grad()`.  `cols`, the hit points' columns of a sharded batch:
    the cell is then the largest radius over every rank's."""
    sphot = photons.valid & photons.on_surface
    with torch.no_grad():
        r_max = torch.amax(torch.where(hp_valid, hp_radius, 0.0))
        if cols is not None:
            r_max = cols.max(r_max)
        grid = hashgrid.build_grid(photons.pos, sphot, r_max)
        # bucket-ordered payload copies: candidates are K-wide slices of them
        si = grid.sorted_idx.long()
        pos_s, prev_s, dir_s = photons.pos[si], photons.prev[si], photons.direction[si]
    color_s = photons.color[si]

    fluxes, counts = [], []
    overflow = torch.zeros((), dtype=torch.int64, device=hp_loc.device)
    for c0 in range(0, hp_loc.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        loc, nrm, rad, val = hp_loc[sl], hp_normal[sl], hp_radius[sl], hp_valid[sl]
        with torch.no_grad():
            starts, ok3, cell_drop = hashgrid.query_cell_ranges(grid, loc, k_per_cell,
                                                                with_stats=True)
            ok = ok3.reshape(ok3.shape[0], -1)  # (C, 27K)
            cpos = hashgrid.gather_cell_slices(pos_s, starts, k_per_cell)  # (C, 27K, 3)
            d2 = torch.sum((cpos - loc[:, None, :]) ** 2, dim=-1)
            in_r = ok & val[:, None] & bounding_sphere.is_inside_sq(
                loc[:, None, :], rad[:, None], cpos, d2=d2
            )
            key_val = torch.where(in_r, -d2, float("-inf"))
            k = min(k_nearest, key_val.shape[-1])
            top_val, top_pos = torch.topk(key_val, k, dim=-1)
            top_idx = torch.gather(hashgrid.cell_slots(starts, k_per_cell), 1, top_pos)
        flux, count = _visible_flux(scene.geom, prev_s, dir_s, color_s, top_idx,
                                    torch.isfinite(top_val), loc, nrm)
        fluxes.append(flux)
        counts.append(count)
        knn_drop = torch.clamp(torch.sum(in_r, dim=-1) - k, min=0)
        overflow = overflow + torch.sum(torch.where(val, cell_drop, 0) + knn_drop)
    flux, count = torch.cat(fluxes), torch.cat(counts)
    if return_overflow:
        return flux, count, overflow
    return flux, count


def surface_gather(scene: Scene, photons: Photons, hp_loc, hp_normal, hp_radius, hp_valid,
                   k_nearest: int = K_NEAREST, return_overflow: bool = False):
    """Surface photon gather over all (pixel, photon) pairs with the
    per-photon visibility re-check: for each hit point the K nearest
    in-radius photons are tested with a ray toward the photon's previous
    location.  Returns (flux, count); with `return_overflow` also the total
    of in-radius photons beyond the `k_nearest` cap.  The pair distances and
    the top-k pick run under `torch.no_grad()`."""
    sphot = photons.valid & photons.on_surface
    with torch.no_grad():
        d2 = torch.sum((photons.pos[None, :, :] - hp_loc[:, None, :]) ** 2, dim=-1)  # (R, P)
        in_r = sphot[None, :] & hp_valid[:, None] & bounding_sphere.is_inside_sq(
            hp_loc[:, None, :], hp_radius[:, None], photons.pos[None, :, :], d2=d2
        )
        key_val = torch.where(in_r, -d2, float("-inf"))
        k = min(k_nearest, photons.pos.shape[0])
        top_val, top_idx = torch.topk(key_val, k, dim=-1)
    flux, count = _visible_flux(scene.geom, photons.prev, photons.direction, photons.color,
                                top_idx, torch.isfinite(top_val), hp_loc, hp_normal)
    if return_overflow:
        return flux, count, torch.sum(torch.clamp(torch.sum(in_r, dim=-1) - k, min=0))
    return flux, count


# ---------------------------------------------------------------------------
# eye pass
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HitPoints:
    """Per-pixel SPPM state."""

    loc: torch.Tensor  # (R, 3) inf = invalid
    normal: torch.Tensor  # (R, 3)
    filter: torch.Tensor  # (R, 3)
    direct: torch.Tensor  # (R, 3) accumulated direct radiance
    indirect: torch.Tensor  # (R, 3) accumulated photon radiance
    tmp_lm: torch.Tensor  # (R, 3) this pass's volume gather
    surface_radius: torch.Tensor  # (R,)
    volume_radius: torch.Tensor  # (R,)
    valid: torch.Tensor  # (R,) diffuse hit found


def _direct_radiance_chain(scene: Scene, diff_pt, diff_nrm, diff_uv, diff_mat, diff_coming,
                           filter_base, stack_ids, stack_len, in_medium, medium, enable,
                           generator=None, uniforms=None, max_steps: int = DIRECT_CHAIN_STEPS,
                           cols: Columns | None = None):
    """Direct radiance at the diffuse hits: light-sample the diffuse bounce
    (hittable weight 1), then follow a forced-refraction chain through
    transparent geometry accumulating transmittance, adding emission at
    diffuse hits; clamped to <= 1 per channel.

    `uniforms`: {"direct_bsdf": (4, R), "direct_pick": (R,), "direct_light":
    (2, R), "direct_chain": (max_steps, 4, R)}; in the sparse light-tree
    regime the pick is a descent and "direct_pick" is (descent steps, R).
    `cols`: the rays' columns of a sharded batch (default: the whole)."""
    table = scene.materials
    g = scene.geom
    lt = scene.light_tree
    r = diff_mat.shape[0]
    dev = diff_pt.device
    cols = cols or Columns.whole(r)

    emittance = filter_base * table.emission_color(diff_mat, diff_uv)

    # re-sample the diffuse bounce, then redirect it at a light
    ref = materials.sample_bsdf(
        table, diff_mat, diff_pt, diff_coming, diff_nrm, diff_uv, stack_ids, stack_len,
        cols.draw(uniforms, "direct_bsdf", None, (4,), generator, dev),
    )
    pivot = torch.where(ref.diffuse[..., None], diff_nrm, ref.perfect_dir)
    if lt.dense:
        node_pdf = lights_mod.leaf_node_pdfs(lt, diff_pt, pivot)
        leaf = lights_mod.pick_light_dense(
            lt, node_pdf, cols.draw(uniforms, "direct_pick", None, (), generator, dev)
        )
    else:
        leaf = lights_mod.pick_light(
            lt, diff_pt, pivot,
            uniforms=cols.draw(uniforms, "direct_pick", None, (lights_mod.descent_steps(lt),),
                               generator, dev),
        )
    u_light = cols.draw(uniforms, "direct_light", None, (2,), generator, dev)
    target = lights_mod.sample_point_on_light(lt, leaf, u_light[0], u_light[1])
    new_dir = linalg.normalize(target - diff_pt, SMALL_EPS)
    refilter = ref.reflected | ref.refracted
    filt_redir = sampling.phong_filter(ref.k, ref.n, pivot, new_dir)
    ref_filter = torch.where(refilter[..., None], filt_redir, ref.filter)

    if lt.dense:
        hittable = lights_mod.hittable_pdf_sum(lt, diff_pt, new_dir, pivot, node_pdf=node_pdf)
    else:
        hittable = lights_mod.hittable_pdf_sum_sparse(lt, diff_pt, new_dir, pivot)
    scat = sampling.scattering_pdf(diff_nrm, new_dir, ref.diffuse, diff_coming, ref.refracted)
    factor = scat / math.pi / torch.where(hittable != 0, hittable, 1.0)
    factor = torch.where(hittable != 0, factor, 0.0)

    o, d = diff_pt, new_dir
    filt = filter_base * ref_filter
    prev_in_medium, prev_medium, prev_pt = in_medium, medium, diff_pt
    direct = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    live = enable
    for i in range(max_steps):
        if not cols.any(live):
            break
        _, slot, bary, hit = trace.closest_hit(g, o, d, live=live)
        live = live & hit
        pt, uv, nrm, mat = interpolate_hit(g, table, slot, bary)
        ref2 = materials.sample_bsdf(
            table, mat, pt, d, nrm, uv, stack_ids, stack_len,
            cols.draw(uniforms, "direct_chain", i, (4,), generator, dev), force_refract=True,
        )
        stack_ids, stack_len = materials.stack_rearrange(
            stack_ids, stack_len, mat, ref2.false_hit, ref2.entering, ref2.refracted, live
        )
        in_m, med = check_entering_medium(table, ref2, in_medium, medium)
        in_medium = torch.where(live, in_m, in_medium)
        medium = torch.where(live, med, medium)

        seg_l = linalg.length(pt - prev_pt)
        tr = transmittance(table, prev_medium, seg_l)
        apply_tr = live & ~ref2.false_hit & prev_in_medium
        filt = filt * torch.where(apply_tr[..., None], tr[..., None], 1.0)
        filt = torch.where(live[..., None], filt * ref2.filter_2, filt)

        add = live & ~ref2.false_hit & ref2.diffuse
        emit = table.emission_color(mat, uv)
        direct = direct + torch.where(
            add[..., None], filt * torch.clamp(factor, 0.0, 0.999999)[..., None] * emit, 0.0
        )

        upd = live & ~ref2.false_hit
        o = torch.where(live[..., None], pt, o)
        d = torch.where(live[..., None], ref2.dir, d)
        prev_in_medium = torch.where(upd, in_medium, prev_in_medium)
        prev_medium = torch.where(upd, medium, prev_medium)
        prev_pt = torch.where(upd[..., None], pt, prev_pt)
        live = live & ~(~ref2.refracted | ref2.bent)
    out = direct + torch.where(enable[..., None], emittance, 0.0)
    return torch.clamp(out, max=1.0)


def _compaction_widths(r: int) -> list[int]:
    """Stage widths of the straggler compaction: r / 8, r / 64, ... with a
    floor of 1024."""
    widths = []
    wcur = r
    while max(1024, wcur // 8) < wcur:
        wcur = max(1024, wcur // 8)
        widths.append(wcur)
        if wcur == 1024:
            break
    return widths


@_records_grad_if_differentiable
def eye_pass(scene: Scene, camera, pix_i, pix_j, volume_photons: Photons | None, volume_radius,
             init: bool, max_bounce: int = 64, stack_size: int = MATERIAL_STACK_SIZE,
             differentiable: bool = False, max_segments: int = 8, volume_grid: bool = False,
             vol_steps: int | None = None, vol_k_per_cell: int = K_PER_CELL,
             return_stats: bool = False, compact_min: int | None = None, generator=None,
             uniforms=None, cols: Columns | None = None):
    """One eye trace per pixel to the first diffuse hit.  Returns (loc,
    normal, filter, direct_radiance, tmp_lm, valid); with `return_stats` a
    7th element, a dict of capacity-overflow counters: `segments_dropped`
    (medium segments lost to the `max_segments` cap) and
    `beam_steps_dropped` (grid-gather sample points lost to its step bound).

    The walk records up to `max_segments` medium segments (origin, direction,
    length, medium, throughput) per ray, and one volume gather over the
    recorded segments runs after the loop: all pairs, or the hash-grid form
    with `volume_grid`, whose step loop runs `vol_steps` sample points when
    that is given (see `volume_gather_segments_grid`).

    `differentiable=True` records the pass for autograd (the recorded
    filter, the direct radiance and the volume gather carry gradient to the
    material table) and never compacts; otherwise the pass runs under
    `torch.no_grad()`.  Without compaction the outputs are the same either
    way.

    Straggler compaction (forward mode, batches of at least `compact_min`
    rays, default `EYE_COMPACT_MIN`): once the live rays fit a stage width
    (r / 8, r / 64, ..., floor 1024) they are compacted, in batch order into
    the stage's first columns, iterated at that width and scattered back.
    The same estimator; bounces after a compaction use other random numbers
    than the full-width loop would.

    `uniforms`: {"lens": (2, R), "stack": (8, 4, R), "bounce": (max_bounce, 4,
    R)} and the keys of `_direct_radiance_chain`; after a compaction a stage
    of width w reads the first w columns.

    `cols`: the pixels' columns of a batch sharded over a mesh (`Columns`;
    default: the whole batch).  R above is then the whole batch's width, the
    loop exits, the compaction and the stats are taken over every rank, and
    each rank returns its own pixels' outputs, the unsharded pass's."""
    if differentiable:
        compact_min = 0
    table = scene.materials
    g = scene.geom
    r = pix_i.shape[0]
    dev = pix_i.device
    cols = cols or Columns.whole(r)
    f32 = dict(dtype=torch.float32, device=dev)
    record_segments = (volume_photons is not None) and (not init)

    u_lens = cols.draw(uniforms, "lens", None, (2,), generator, dev)
    o, d = camera.generate_rays(pix_i, pix_j, u_lens[0], u_lens[1])
    z_axis = torch.tensor([0.0, 0.0, 1.0], **f32).expand(r, 3)
    stack_ids, stack_len = init_material_stack(
        scene, o, z_axis, stack_size, generator=generator,
        uniforms=None if uniforms is None else uniforms["stack"], cols=cols,
    )
    # the medium the camera starts in
    hp0, _ = materials.find_highest_prioritised(table, stack_ids, stack_len)
    in_medium0 = extinction_coef(table, hp0) > SMALL_EPS
    medium0 = torch.where(in_medium0, hp0, -1)

    ones3 = torch.ones((r, 3), **f32)
    st = dict(
        o=o, d=d, filt=ones3, filt_lag=ones3,
        stack_ids=stack_ids, stack_len=stack_len,
        in_medium=in_medium0, medium=medium0,
        prev_in_medium=in_medium0, prev_medium=medium0, prev_pt=o,
        sg_start=torch.zeros((r, max_segments, 3), **f32),
        sg_dir=torch.zeros((r, max_segments, 3), **f32),
        sg_len=torch.zeros((r, max_segments), **f32),
        sg_med=torch.full((r, max_segments), -1, dtype=torch.int32, device=dev),
        sg_filt=torch.zeros((r, max_segments, 3), **f32),
        sg_cnt=torch.zeros((r,), dtype=torch.int32, device=dev),
        sg_lost=torch.zeros((r,), dtype=torch.int32, device=dev),
        live=torch.ones((r,), dtype=torch.bool, device=dev),
        found=torch.zeros((r,), dtype=torch.bool, device=dev),
        # recorded diffuse-hit info
        h_pt=torch.full((r, 3), float("inf"), **f32), h_nrm=torch.zeros((r, 3), **f32),
        h_uv=torch.zeros((r, 2), **f32), h_mat=torch.zeros((r,), dtype=torch.int32, device=dev),
        h_coming=d, h_filt_lag=ones3,
        h_stack_ids=stack_ids, h_stack_len=stack_len,
        h_in_medium=in_medium0, h_medium=medium0,
    )
    seg_slots = torch.arange(max_segments, dtype=torch.int32, device=dev)[None, :]

    def body(st, u):
        _, slot, bary, hit = trace.closest_hit(g, st["o"], st["d"], live=st["live"])
        live = st["live"] & hit
        pt, uv, nrm, mat = interpolate_hit(g, table, slot, bary)
        ref = materials.sample_bsdf(
            table, mat, pt, st["d"], nrm, uv, st["stack_ids"], st["stack_len"], u
        )
        stack_ids2, stack_len2 = materials.stack_rearrange(
            st["stack_ids"], st["stack_len"], mat, ref.false_hit, ref.entering, ref.refracted,
            live,
        )
        in_m, med = check_entering_medium(table, ref, st["in_medium"], st["medium"])
        in_m = torch.where(live, in_m, st["in_medium"])
        med = torch.where(live, med, st["medium"])

        # record the medium segment (gathered after the loop) and apply its
        # transmittance
        seg_vec = pt - st["prev_pt"]
        seg_l = linalg.length(seg_vec)
        seg_on = live & ~ref.false_hit & st["prev_in_medium"]
        sg = {}
        if record_segments:
            seg_dir = linalg.normalize(seg_vec, SMALL_EPS)
            can = seg_on & (st["sg_cnt"] < max_segments)
            at = (seg_slots == st["sg_cnt"][:, None]) & can[:, None]
            sg = dict(
                sg_start=torch.where(at[..., None], st["prev_pt"][:, None, :], st["sg_start"]),
                sg_dir=torch.where(at[..., None], seg_dir[:, None, :], st["sg_dir"]),
                sg_len=torch.where(at, seg_l[:, None], st["sg_len"]),
                sg_med=torch.where(at, st["prev_medium"][:, None], st["sg_med"]),
                sg_filt=torch.where(at[..., None], st["filt"][:, None, :], st["sg_filt"]),
                sg_cnt=st["sg_cnt"] + can.to(torch.int32),
                sg_lost=st["sg_lost"] + (seg_on & ~can).to(torch.int32),
            )
        filt = st["filt"]
        if not init:
            tr = transmittance(table, st["prev_medium"], seg_l)
            filt = filt * torch.where(seg_on[..., None], tr[..., None], 1.0)

        nf = live & ~ref.false_hit
        filt_lag = torch.where(nf[..., None], filt, st["filt_lag"])
        filt = torch.where(nf[..., None], filt * ref.filter_2, filt)

        # first diffuse hit: record and stop
        found_now = live & ref.diffuse & ~st["found"]

        def h(new, old):
            return torch.where(found_now[..., None] if new.dim() == 2 else found_now, new, old)

        return {
            **st, **sg,
            "o": torch.where(live[..., None], pt, st["o"]),
            "d": torch.where(live[..., None], ref.dir, st["d"]),
            "filt": filt, "filt_lag": filt_lag,
            "stack_ids": stack_ids2, "stack_len": stack_len2,
            "in_medium": in_m, "medium": med,
            "prev_in_medium": torch.where(nf, in_m, st["prev_in_medium"]),
            "prev_medium": torch.where(nf, med, st["prev_medium"]),
            "prev_pt": torch.where(nf[..., None], pt, st["prev_pt"]),
            "live": live & ~found_now,
            "found": st["found"] | found_now,
            "h_pt": h(pt, st["h_pt"]), "h_nrm": h(nrm, st["h_nrm"]),
            "h_uv": h(uv, st["h_uv"]), "h_mat": h(mat, st["h_mat"]),
            "h_coming": h(st["d"], st["h_coming"]),
            "h_filt_lag": h(filt_lag, st["h_filt_lag"]),
            "h_stack_ids": h(stack_ids2, st["h_stack_ids"]),
            "h_stack_len": h(stack_len2, st["h_stack_len"]),
            "h_in_medium": h(in_m, st["h_in_medium"]),
            "h_medium": h(med, st["h_medium"]),
        }

    step = 0

    def run(st, stage_cols, widths):
        """Iterate `st` while more rays are alive than the next stage's width
        (or, at the last stage, while any is); then compact into that stage.
        A stage takes the live rays alone: a settled ray's state is left as
        it is by every step, and the live rays take the stage's first
        columns, rank by rank."""
        nonlocal step
        floor = widths[0] if widths else 0
        while step < max_bounce and stage_cols.count(st["live"]) > floor:
            u = stage_cols.draw(uniforms, "bounce", step, (4,), generator, dev)
            if u.shape[-1]:
                st = body(st, u)
            step += 1
        if not widths or step >= max_bounce:
            return st
        idx = torch.nonzero(st["live"]).squeeze(1)
        sub = run({k: v[idx] for k, v in st.items()}, stage_cols.stage(idx.shape[0], floor),
                  widths[1:])
        out = {}
        for k, v in st.items():
            out[k] = v.clone()
            out[k][idx] = sub[k]
        return out

    cmin = EYE_COMPACT_MIN if compact_min is None else compact_min
    st = run(st, cols, _compaction_widths(cols.width) if cmin and cols.width >= cmin else [])

    # gather the recorded medium segments
    tmp_lm = torch.zeros((r, 3), **f32)
    seg_valid = None
    if record_segments:
        seg_valid = seg_slots < st["sg_cnt"][:, None]
        seg_args = (table, volume_photons, st["sg_start"], st["sg_dir"], st["sg_len"],
                    st["sg_med"], st["sg_filt"], seg_valid, volume_radius)
        if volume_grid:
            tmp_lm = volume_gather_segments_grid(*seg_args, k_per_cell=vol_k_per_cell,
                                                 static_steps=vol_steps, cols=cols)
        else:
            tmp_lm = volume_gather_segments_dense(*seg_args)

    # the recorded hit-point filter includes the diffuse filter_2 (= kd)
    h_filter = st["h_filt_lag"] * table.diffuse_color(st["h_mat"], st["h_uv"])

    found = st["found"]
    direct = torch.zeros((r, 3), **f32)
    if scene.light_tree is not None:
        direct = _direct_radiance_chain(
            scene, st["h_pt"], st["h_nrm"], st["h_uv"], st["h_mat"], st["h_coming"],
            st["h_filt_lag"], st["h_stack_ids"], st["h_stack_len"],
            st["h_in_medium"], st["h_medium"], found, generator=generator, uniforms=uniforms,
            cols=cols,
        )
        direct = torch.where(found[..., None], direct, 0.0)

    loc = torch.where(found[..., None], st["h_pt"], float("inf"))
    outs = (loc, st["h_nrm"], h_filter, direct, tmp_lm, found)
    if not return_stats:
        return outs
    steps_dropped = 0
    if record_segments and volume_grid:
        # sample points beyond the grid gather's step bound (its spacing)
        bound = VOLUME_GRID_MAX_STEPS if vol_steps is None else vol_steps
        needed = torch.ceil(st["sg_len"] / _beam_spacing(seg_valid, volume_radius, cols)) + 1
        steps_dropped = cols.count(torch.where(seg_valid, torch.clamp(needed - bound, min=0.0),
                                               0.0))
    stats = {"segments_dropped": cols.count(st["sg_lost"]), "beam_steps_dropped": steps_dropped}
    return outs + (stats,)


# ---------------------------------------------------------------------------
# initial radius
# ---------------------------------------------------------------------------

def initial_radius(eye_fn, scene: Scene, camera, pix_i, pix_j, loc, valid, radius_scale,
                   cols: Columns | None = None):
    """Initial gather radius: 4 corner rays per pixel (`eye_fn(scene, camera,
    pix_i, pix_j, None, vol_r, init=True)` traces one set), radius = least
    pairwise distance among the 5 hit points * `radius_scale`; pixels without
    one get the average (over every rank's pixels with `cols` of a sharded
    batch)."""
    cols = cols or Columns.whole(pix_i.shape[0])
    r = pix_i.shape[0]
    vol_r = torch.full((r,), float("inf"), dtype=torch.float32, device=pix_i.device)
    pts = [torch.where(valid[..., None], loc, float("inf"))]
    for oi, oj in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0)):
        outs = eye_fn(scene, camera, pix_i + oi, pix_j + oj, None, vol_r, init=True)
        pts.append(torch.where(outs[5][..., None], outs[0], float("inf")))

    radius = torch.full_like(vol_r, float("inf"))
    for a in range(len(pts)):
        for b in range(a + 1, len(pts)):
            dist = linalg.length(pts[a] - pts[b])
            ok = torch.isfinite(dist) & (dist > 0)
            radius = torch.where(ok & (dist < radius), dist, radius)
    radius = radius * radius_scale
    finite = torch.isfinite(radius)
    avg = (cols.sum(torch.sum(torch.where(finite, radius, 0.0)))
           / torch.clamp(cols.sum(torch.sum(finite)), min=1))
    return torch.where(finite, radius, avg)


# ---------------------------------------------------------------------------
# the render
# ---------------------------------------------------------------------------

def pass_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of one pass (index 0: the init pass; 1000 + i: pass i):
    a stream of its own per (seed, index), so a resumed render draws what an
    uninterrupted one would."""
    return torch.Generator(device=device).manual_seed((seed << 20) + index)


def update(hp: HitPoints, flux, iteration: int, n_phot: int, alpha: float) -> HitPoints:
    """Fold one pass's surface flux and volume gather into the per-pixel
    state and shrink the radii (from iteration 2)."""
    ratio = (iteration + alpha) / (iteration + 1.0)
    shrink = math.sqrt(ratio) if iteration >= 2 else 1.0
    shrink_v = ratio ** (1.0 / 3.0) if iteration >= 2 else 1.0
    surf = linalg.de_nan(hp.filter * flux / (n_phot * math.pi * hp.surface_radius[..., None] ** 2))
    vol = linalg.de_nan(hp.tmp_lm / n_phot)
    return dataclasses.replace(
        hp,
        indirect=hp.indirect + surf + vol,
        surface_radius=hp.surface_radius * shrink,
        volume_radius=hp.volume_radius * shrink_v,
        tmp_lm=torch.zeros_like(hp.tmp_lm),
    )


def _saved_passes(folder: pathlib.Path) -> list[int]:
    return sorted(int(f.stem.split("_")[1]) for f in folder.glob("pass_*.pt"))


def _restore(folder: pathlib.Path, run_meta: dict, device):
    """The newest checkpoint's (hit points, pass index), or None.  A
    checkpoint written by another run (scene size, seed, photon count, ...)
    is refused: restoring it would blend foreign state into this render."""
    saved = _saved_passes(folder)
    if not saved:
        return None
    state = torch.load(folder / f"pass_{saved[-1]}.pt", map_location=device, weights_only=True)
    saved_meta = state.get("meta")
    if saved_meta is None:
        raise ValueError(
            f"checkpoint at {folder} has no run metadata; refusing to resume (delete the "
            "directory to start fresh)"
        )
    for k, want in run_meta.items():
        got = saved_meta.get(k)
        if got is None or got != want:
            raise ValueError(
                f"checkpoint at {folder} was written by a different run (field {k!r}: "
                f"saved={got} != current={want}); refusing to resume"
            )
    return HitPoints(**state["hit_points"]), saved[-1]


def render_sppm(scene: Scene, camera, cfg, seed: int, output_prefix: str | None = None,
                n_photons_override: int | None = None, checkpoint_dir: str | None = None,
                checkpoint_every: int = 10, pass_log=None, photon_pass_fn=None,
                pixel_sharding=None) -> np.ndarray:
    """Full SPPM render: (H, W, 3) combined (direct + indirect) linear
    radiance as numpy.

    With `output_prefix`, writes the debug images: a hit-point splat after
    the init pass (`_hit_point.ppm`) and, every
    `cfg.ppm_image_output_iteration` passes, direct / indirect / combined
    images and surface- and volume-photon splats.  With `checkpoint_dir`, the
    per-pixel state is saved (`torch.save`) every `checkpoint_every` passes
    and at the last, and the render resumes from the newest checkpoint.  A
    pass whose gather drops more than 1% of its in-radius candidates gathers
    again with doubled caps (up to `AUTO_CAPS_MAX`).  `pass_log`, a list,
    receives one dict per pass (seconds of its parts, each ended by a device
    synchronization made for the log alone; the tracer's loop exits as
    `host_syncs` and any-hit kernel launches; caps, photon counts, the mean
    of the direct image so far).

    Scale-out hooks (`parallel.sppm_shard`): `photon_pass_fn` replaces
    `photon_pass` (called as `photon_pass(scene, n_photons, max_bounce=,
    stack_size=, generator=)`); `pixel_sharding`, a `parallel.shard.Mesh`,
    shards the pixels over its ranks (the batch padded with pixel (0, 0) to a
    multiple of the mesh size): each rank traces its own, the gather caps
    and grid cells are decided over all of them, and the image, the debug
    images and the checkpoints are assembled with all-gathers; only rank 0
    writes files (`checkpoint_dir` must be one that every rank reads).
    With a pixel count that the mesh size divides, the image is the
    unsharded render's up to the rounding of the initial radius's average."""
    from gpu_pathtracer_tpu_torch.render.splat import splat_points
    from gpu_pathtracer_tpu_torch.utils.image import save_ppm

    dev = scene.geom.p.device
    w, h = cfg.image_width, cfg.image_height
    n_pix = w * h
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij",
    )
    pix_i, pix_j = ii.reshape(-1), jj.reshape(-1)
    cols = Columns.whole(n_pix)
    if pixel_sharding is not None:
        pix_i, pix_j, cols = _shard_pixels(pixel_sharding, pix_i, pix_j)
    r = pix_i.shape[0]  # this rank's pixels
    writes = pixel_sharding is None or pixel_sharding.rank == 0
    if photon_pass_fn is None:
        photon_pass_fn = photon_pass

    max_bounce = cfg.ppm_max_bounce
    n_phot = int(n_photons_override or cfg.ppm_num_photon_per_pass)
    alpha = cfg.ppm_alpha
    num_pass = cfg.ppm_num_pass
    # all-pairs gathers for small workloads, hash grids once pixels * photons
    # would dominate
    use_grid = n_pix * n_phot > GRID_MIN_PAIRS

    def eye(scene, camera, pi, pj, photons, vol_r, init, generator):
        return eye_pass(scene, camera, pi, pj, photons, vol_r, init=init, max_bounce=64,
                        stack_size=cfg.max_stack, volume_grid=use_grid, return_stats=True,
                        generator=generator, cols=cols)

    def whole(hp: HitPoints) -> dict:
        """Every pixel's state, the pad included."""
        return {f.name: cols.gather(getattr(hp, f.name)) for f in dataclasses.fields(hp)}

    run_meta = {"seed": int(seed), "num_pixels": cols.width, "n_phot": n_phot,
                "max_bounce": int(max_bounce), "alpha": float(alpha)}
    # ppm_num_pass is left out on purpose: resuming with a larger pass target
    # extends the run
    ckpt = None if checkpoint_dir is None else pathlib.Path(checkpoint_dir)
    start_pass = 0
    hp = None
    if ckpt is not None:
        ckpt.mkdir(parents=True, exist_ok=True)
        restored = _restore(ckpt, run_meta, dev)
        if restored is not None:
            hp, last = restored
            hp = HitPoints(**{f.name: getattr(hp, f.name)[cols.lo:cols.hi]
                              for f in dataclasses.fields(hp)})
            start_pass = last + 1

    # ---- init pass: main + 4 corner traces -> initial radius ---------------
    if hp is None:
        gen0 = pass_generator(seed, 0, dev)
        vol_r = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
        loc, nrm, filt, direct, _, valid = eye(
            scene, camera, pix_i + 0.5, pix_j + 0.5, None, vol_r, True, gen0)[:6]
        radius = initial_radius(
            lambda *a, **k: eye(*a, **k, generator=gen0), scene, camera, pix_i, pix_j, loc, valid,
            cfg.ppm_radius_scaling_factor, cols=cols,
        )
        zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        hp = HitPoints(loc=loc, normal=nrm, filter=filt, direct=direct, indirect=zeros3,
                       tmp_lm=zeros3, surface_radius=radius, volume_radius=2.0 * radius,
                       valid=valid)

    if output_prefix is not None:
        shown = {k: v[:n_pix] for k, v in whole(hp).items()}
        if writes:
            save_ppm(splat_points(camera, shown["loc"], shown["filter"], w, h, shown["valid"])
                     .cpu().numpy(), f"{output_prefix}_hit_point.ppm")

    def gather(photons, hp, kn, kpc):
        if use_grid:
            return surface_gather_grid(scene, photons, hp.loc, hp.normal, hp.surface_radius,
                                       hp.valid, k_nearest=kn, k_per_cell=kpc,
                                       return_overflow=True, cols=cols)
        return surface_gather(scene, photons, hp.loc, hp.normal, hp.surface_radius, hp.valid,
                              k_nearest=kn, return_overflow=True)

    k_nearest_cur, k_per_cell_cur = K_NEAREST, K_PER_CELL
    # media-free scenes skip the recorded-segment machinery
    has_medium = bool(torch.any(scene.materials.scattering_coef
                                + scene.materials.absorption_coef > 0))
    cap_totals = {"gather_candidates_dropped": 0, "segments_dropped": 0, "beam_steps_dropped": 0}

    def clock():
        """The host clock after the device has caught up; only for `pass_log`
        (a render without one makes no synchronisation for it)."""
        if pass_log is None:
            return None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def counted():
        """(loop exits, any-hit launches) so far."""
        n = tracing.totals
        return n["loop_exit"], n["launch.anyhit"] + n["launch.anyhit_pipe"]

    for it in range(start_pass, num_pass):
        gen = pass_generator(seed, 1000 + it, dev)
        syncs0, launches0 = counted()
        t0 = clock()
        photons = photon_pass_fn(scene, n_phot, max_bounce=max_bounce, stack_size=cfg.max_stack,
                                 generator=gen)
        t1 = clock()
        jitter = cols.draw(None, "jitter", None, (2,), gen, dev)
        eye_outs = eye(scene, camera, pix_i + jitter[0], pix_j + jitter[1],
                       photons if has_medium else None, hp.volume_radius, False, gen)
        loc, nrm, filt, direct, tmp_lm, valid = eye_outs[:6]
        hp = dataclasses.replace(
            hp, loc=torch.where(valid[..., None], loc, float("inf")), normal=nrm, filter=filt,
            direct=hp.direct + direct, tmp_lm=tmp_lm, valid=valid,
        )
        t2 = clock()
        # re-gather this pass with doubled caps while more than 1% of the
        # in-radius candidates were dropped (radii only shrink, so the raises
        # fall in the first passes, where a silent cap would bias the most);
        # the counts are every rank's, so all ranks decide alike
        flux, count, overflow = gather(photons, hp, k_nearest_cur, k_per_cell_cur)
        dropped, kept = cols.count(overflow), cols.count(count)
        while (dropped > 0.01 * (dropped + kept)
               and k_nearest_cur < min(AUTO_CAPS_MAX, n_phot)):
            k_nearest_cur = min(k_nearest_cur * 2, AUTO_CAPS_MAX, n_phot)
            k_per_cell_cur = min(k_per_cell_cur * 2, AUTO_CAPS_MAX)
            flux, count, overflow = gather(photons, hp, k_nearest_cur, k_per_cell_cur)
            dropped, kept = cols.count(overflow), cols.count(count)
        hp = update(hp, flux, it + 1, n_phot, alpha)
        t3 = clock()
        es = eye_outs[6]
        cap_totals["gather_candidates_dropped"] += dropped
        cap_totals["segments_dropped"] += es["segments_dropped"]
        cap_totals["beam_steps_dropped"] += es["beam_steps_dropped"]
        if pass_log is not None:
            syncs, launches = counted()
            pass_log.append(dict(
                it=it, photon_s=t1 - t0, eye_s=t2 - t1, gather_s=t3 - t2,
                host_syncs=syncs - syncs0, anyhit_launches=launches - launches0,
                k_nearest=k_nearest_cur,
                k_per_cell=k_per_cell_cur, dropped=dropped,
                surface_photons=int((photons.valid & photons.on_surface).sum()),
                volume_photons=int((photons.valid & ~photons.on_surface).sum()),
                tmp_lm_sum=float(cols.sum(tmp_lm.sum())),
                tmp_lm_finite=cols.count(~torch.isfinite(tmp_lm)) == 0,
                direct_mean=float(cols.sum(linalg.de_nan(hp.direct).sum()))
                / (3 * cols.width) / (it + 1),
                grid=use_grid,
            ))
        if ckpt is not None and ((it + 1) % max(checkpoint_every, 1) == 0 or it + 1 == num_pass):
            state = {"hit_points": whole(hp), "meta": run_meta}
            if writes:
                torch.save(state, ckpt / f"pass_{it}.pt")
                for old in _saved_passes(ckpt)[:-2]:
                    (ckpt / f"pass_{old}.pt").unlink()

        every = max(int(cfg.ppm_image_output_iteration), 1)
        if output_prefix is not None and ((it + 1) % every == 0 or it + 1 == num_pass):
            passes = it + 1
            direct_img = cols.gather(linalg.de_nan(hp.direct / passes))[:n_pix]
            indirect_img = cols.gather(linalg.de_nan(hp.indirect / passes))[:n_pix]
            if writes:
                direct_img = direct_img.reshape(h, w, 3).cpu().numpy()
                indirect_img = indirect_img.reshape(h, w, 3).cpu().numpy()
                save_ppm(direct_img, f"{output_prefix}_direct.ppm")
                save_ppm(indirect_img, f"{output_prefix}_indirect.ppm")
                save_ppm(direct_img + indirect_img, f"{output_prefix}.ppm")
                for name, mask in (("surface", photons.valid & photons.on_surface),
                                   ("volume", photons.valid & ~photons.on_surface)):
                    save_ppm(splat_points(camera, photons.pos, photons.color, w, h, mask)
                             .cpu().numpy(), f"{output_prefix}_{name}_photon.ppm")

    if writes:
        print("[capstats] render totals: " + " ".join(f"{k}={v}" for k, v in cap_totals.items())
              + f" (final k_nearest={k_nearest_cur})", flush=True)
    img = cols.gather(linalg.de_nan((hp.direct + hp.indirect) / num_pass))[:n_pix]
    return img.reshape(h, w, 3).cpu().numpy()


# ---------------------------------------------------------------------------
# the differentiable render
# ---------------------------------------------------------------------------

def render_sppm_differentiable(scene: Scene, camera, width: int, height: int, n_photons: int,
                               num_pass: int, max_bounce: int = 16, eye_bounce: int = 16,
                               alpha: float = 0.7, radius_scale: float = 1.0,
                               stack_size: int = MATERIAL_STACK_SIZE,
                               gather_volume: bool = False, k_nearest: int = K_NEAREST,
                               gather_grid: bool | None = None, k_per_cell: int = K_PER_CELL,
                               vol_steps: int = 64, photon_pass_fn=None, pixel_sharding=None,
                               seed: int = 0, uniforms=None) -> torch.Tensor:
    """SPPM render whose (H, W, 3) radiance tensor carries gradient to the
    material table (notably `ke`: the photon colours through
    `leaf_energies`' energy normalization, the direct chain through
    `emission_color`).  The scene's device runs it.

    The estimator of `render_sppm` with the reference's two deviations:

    * the init pass gives geometry and the initial radius only: its direct
      sample is dropped, so the direct term averages `num_pass` samples;
    * the init pass and the four corner passes of `initial_radius` run
      under `torch.no_grad()`, so the scene is read there as constants (the
      gather radius is geometry only).

    Each pass runs `photon_pass` and `eye_pass` with `differentiable=True`
    (no straggler compaction), then the surface gather at fixed caps
    (`k_nearest`, `k_per_cell`; no raising).  `gather_grid` (None: auto,
    pixels * photons > `GRID_MIN_PAIRS`, as `render_sppm`) takes the
    hash-grid gathers, and with `gather_volume` the grid beam gather with
    the static step bound `vol_steps`.  With `gather_volume` the eye passes
    gather the volume photons (media are ignored otherwise).

    Randomness: `pass_generator(seed, 0)` for the init pass and its corners,
    `pass_generator(seed, 1000 + i)` for pass i (the photon pass, the pixel
    jitters, the eye pass, in that order).  `uniforms` replaces them:
    {"init": the init eye pass's uniforms, "corners": a list of four,
    "passes": a list of `num_pass` dicts {"photon": `photon_pass`'s, "eye":
    `eye_pass`'s, "jitter": (2, R) row and column jitters}}; every draw is
    taken before the pass that uses it, none inside autograd's recompute.

    `photon_pass_fn` replaces `photon_pass` (any callable with its
    signature, `differentiable` included).  `pixel_sharding`, a
    `parallel.shard.Mesh`, shards the pixels over its ranks as in
    `render_sppm`: each pass's jitter and eye numbers are drawn at the whole
    frame's width and cut to the rank's pixels (the differentiable eye pass
    never compacts, so this is exact), the grid cells and the initial
    radius's average are taken over all of them, and every rank returns the
    whole image, assembled so that the gradient of a loss that every rank
    computes alike from it reaches each rank's own pixels.  A rank's
    parameter gradients are then its pixels' share; their sum over the ranks
    is the gradient (`optim.sppm_loss_fn` takes it).  `uniforms` hold the
    whole frame's numbers either way.
    """
    dev = scene.geom.p.device
    h, w = height, width
    n_pix = w * h
    if gather_grid is None:
        gather_grid = n_pix * n_photons > GRID_MIN_PAIRS
    ii, jj = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij",
    )
    pix_i, pix_j = ii.reshape(-1), jj.reshape(-1)
    cols = Columns.whole(n_pix)
    if pixel_sharding is not None:
        pix_i, pix_j, cols = _shard_pixels(pixel_sharding, pix_i, pix_j)
    r = pix_i.shape[0]  # this rank's pixels
    trace_photons = photon_pass if photon_pass_fn is None else photon_pass_fn

    def eye(pi, pj, photons, vol_r, init, generator, eye_uniforms, differentiable=False):
        return eye_pass(scene, camera, pi, pj, photons, vol_r, init=init, max_bounce=eye_bounce,
                        stack_size=stack_size, differentiable=differentiable,
                        volume_grid=gather_grid and gather_volume, vol_steps=vol_steps,
                        vol_k_per_cell=k_per_cell, generator=generator, uniforms=eye_uniforms,
                        cols=cols)

    # geometry-only init pass and the corner radius, as constants
    with torch.no_grad():
        gen0 = None if uniforms is not None else pass_generator(seed, 0, dev)
        corners = iter([None] * 4 if uniforms is None else uniforms["corners"])
        vol_r0 = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
        loc, nrm, filt, _, _, valid = eye(pix_i + 0.5, pix_j + 0.5, None, vol_r0, True, gen0,
                                          None if uniforms is None else uniforms["init"])
        radius = initial_radius(
            lambda _scene, _camera, pi, pj, photons, vol_r, init: eye(
                pi, pj, photons, vol_r, init, gen0, next(corners)),
            scene, camera, pix_i, pix_j, loc, valid, radius_scale, cols=cols,
        )
    zeros3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    hp = HitPoints(loc=torch.where(valid[..., None], loc, float("inf")), normal=nrm, filter=filt,
                   direct=zeros3, indirect=zeros3, tmp_lm=zeros3, surface_radius=radius,
                   volume_radius=2.0 * radius, valid=valid)

    for it in range(num_pass):
        u = None if uniforms is None else uniforms["passes"][it]
        gen = None if u is not None else pass_generator(seed, 1000 + it, dev)
        photons = trace_photons(scene, n_photons, max_bounce=max_bounce, stack_size=stack_size,
                                generator=gen, uniforms=None if u is None else u["photon"],
                                differentiable=True)
        jitter = cols.draw(u, "jitter", None, (2,), gen, dev)
        loc, nrm, filt, direct, tmp_lm, valid = eye(
            pix_i + jitter[0], pix_j + jitter[1], photons if gather_volume else None,
            hp.volume_radius, False, gen, None if u is None else u["eye"], differentiable=True)
        hp = dataclasses.replace(
            hp, loc=torch.where(valid[..., None], loc, float("inf")), normal=nrm, filter=filt,
            direct=hp.direct + direct, tmp_lm=tmp_lm, valid=valid,
        )
        if gather_grid:
            flux, _ = surface_gather_grid(scene, photons, hp.loc, hp.normal, hp.surface_radius,
                                          hp.valid, k_nearest=k_nearest, k_per_cell=k_per_cell,
                                          cols=cols)
        else:
            flux, _ = surface_gather(scene, photons, hp.loc, hp.normal, hp.surface_radius,
                                     hp.valid, k_nearest=k_nearest)
        hp = update(hp, flux, it + 1, n_photons, alpha)
    img = linalg.de_nan((hp.direct + hp.indirect) / num_pass)
    if pixel_sharding is not None:
        img = pixel_sharding.gather_image(img)[:n_pix]
    return img.reshape(h, w, 3)
