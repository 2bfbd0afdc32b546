"""The surface shading kernel (`csrc/shade_surface.cu`) and the surface
stage's rule for taking it (`surface.shade`).

This file imports no JAX.  The card's tests are marked `cuda` and skip
without an NVIDIA GPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_shade_surface.py -q

They hold the kernel to its plain version, `surface.shade_surface_reference`
(`interpolate_hit`, then `sample_bsdf`), on the inputs that `trace_paths`
hands it (recorded through the integrator's call) and on edited inputs for
the edges: total internal reflection, false hits, kd = ks = 0, the mirror
limit n_s = inf, degenerate tangents, NaN uvs, empty stack slots and empty
stacks.  Tolerances: every flag, material id and next material the same on
>= 99.999% of the rays (a flag turns on a comparison, which splits only
where the compared value lies within rounding of its limit, should a form of
the kernel's arithmetic round apart from aten's on another card or torch
build), and on those rays every float field within rtol 1e-5.  A card
render with the kernel matches one without it within 1e-4 relative on
>= 99.9% of pixels.

The CPU tests check the routing: one `launch.shade_surface` a wavefront step
for a render without gradients (the router is stood in for by a counting
spy, since a CPU tensor takes the plain version), none for a gradient
render, `render_image_value_and_grad`, rays that require grad or SPPM; and
the plain version equal to `interpolate_hit` + `sample_bsdf` bit for bit on
the Cornell box, a textured and bump-mapped mesh, and a box of nested
dielectrics with a scattering material.
"""

import dataclasses
import math

import pytest
import torch

import chip_smoke
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import materials, surface
from gpu_pathtracer_tpu_torch.render import integrator, sppm
from gpu_pathtracer_tpu_torch.render.integrator import render_image, render_image_value_and_grad
from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

CAM = chip_smoke.CORNELL_CAM
CPU = torch.device("cpu")
SIDE, SPP, LEVEL = (8, 4), 2, 2


def _cornell(folder):
    obj, _ = testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=1)
    return obj_io.load_scene(folder, obj), CAM


def _textured(folder):
    """The subdivided sphere with a checker `map_Kd` and a `map_Bump` on
    material 1 (phase 19's scene at subdiv 2)."""
    return (chip_smoke.textured_mesh_host(folder, 2, checker=64, bump_side=32),
            chip_smoke.MESH_CAM)


def _nested(folder):
    """The Cornell box with the glass sphere at priority 1 inside a fog
    sphere at priority 2 (false hits, a two-deep stack), and the white
    sphere a scattering material (`path_length`)."""
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=1, glass_priority=True,
                                fog=True)
    mtl = (folder / "box.mtl").read_text()
    (folder / "box.mtl").write_text(
        mtl + "newmtl skin\nKd 0.8 0.5 0.4\nKs 0 0 0\nd 1.0\nNs 1\npath_length 0.15\n")
    lines = (folder / "box.obj").read_text().splitlines()
    whites = [i for i, line in enumerate(lines) if line == "usemtl white"]
    lines[whites[3]] = "usemtl skin"  # 3 wall groups, then the first sphere
    (folder / "box.obj").write_text("\n".join(lines) + "\n")
    return obj_io.load_scene(folder, "box.obj"), CAM


SCENES = {"cornell": _cornell, "textured": _textured, "nested": _nested}


def _scene(folder, name, dev):
    host, cam = SCENES[name](folder)
    return build_scene(host, dev), cam


def _render(scene, cam_kw, side, spp, level, dev, seed=1):
    w, h = side
    with torch.no_grad():
        return render_image(scene, Camera.create(**cam_kw, width=w, height=h, device=dev), w, h,
                            sample_size=spp, level=level, hittable_pdf_weight=0.5,
                            ray_chunk=w * h,
                            generator=torch.Generator(device=dev).manual_seed(seed))


def _spy(monkeypatch, record=None):
    """Stand in for the surface stage's call of `shade_surface`: count it as
    the launch it makes on the card, keep its arguments, run the real one."""
    real = surface.shade_surface

    def spy(*args):
        tracing.count("launch.shade_surface")
        if record is not None:
            record.append(args)
        return real(*args)

    monkeypatch.setattr(surface, "shade_surface", spy)


def _torch_ops(g, table, slot, bary, d, stack_ids, stack_len, u):
    """`interpolate_hit`, then `sample_bsdf`: the step's torch ops."""
    point, uv, normal, mat_id = surface.interpolate_hit(g, table, slot, bary)
    ref = materials.sample_bsdf(table, mat_id, point, d, normal, uv, stack_ids, stack_len, u)
    return point, uv, normal, mat_id, ref


def _assert_same(a, b):
    torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


# ---------------------------------------------------------------------------
# The CPU: the routing rule and the plain path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return _scene(tmp_path_factory.mktemp("cornell"), "cornell", CPU)[0]


def test_one_launch_a_step_for_a_render_without_gradients(cornell, tmp_path, monkeypatch):
    _spy(monkeypatch)
    tracing.reset("launch.")
    _render(cornell, CAM, SIDE, SPP, LEVEL, CPU)
    assert tracing.totals["launch.shade_surface"] == SPP * LEVEL
    # the sparse light-tree regime keeps the torch NEE, not the torch shading
    panel = build_scene(obj_io.load_scene(
        tmp_path, testscenes.make_emitter_panel(tmp_path, nx=17, ny=16)[0]), CPU)
    assert not panel.light_tree.dense
    _render(panel, CAM, SIDE, SPP, LEVEL, CPU)
    assert tracing.totals["launch.shade_surface"] == 2 * SPP * LEVEL
    # grad mode on: the kernel unless an input of the step requires grad
    w, h = SIDE
    o, d = Camera.create(**CAM, width=w, height=h).generate_rays(
        torch.rand(w * h) * h, torch.rand(w * h) * w, torch.rand(w * h), torch.rand(w * h))
    integrator.trace_paths(cornell, o, d, level=LEVEL, hittable_pdf_weight=0.5,
                           generator=torch.Generator().manual_seed(2))
    assert tracing.totals["launch.shade_surface"] == 2 * SPP * LEVEL + LEVEL


def _value_and_grad(scene):
    w, h = SIDE
    kd = scene.materials.kd.requires_grad_(True)
    _, _, (grad,) = render_image_value_and_grad(
        scene, Camera.create(**CAM, width=w, height=h), w, h, lambda img: img.mean(), [kd],
        sample_size=SPP, level=LEVEL, hittable_pdf_weight=0.5,
        generator=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def _gradient_render(scene):
    w, h = SIDE
    kd = scene.materials.kd.requires_grad_(True)
    with torch.enable_grad():
        img = render_image(scene, Camera.create(**CAM, width=w, height=h), w, h,
                           sample_size=SPP, level=LEVEL, hittable_pdf_weight=0.5,
                           ray_chunk=w * h, generator=torch.Generator().manual_seed(4))
        (grad,) = torch.autograd.grad(img.mean(), [kd])
    assert float(grad.abs().max()) > 0


def _rays_require_grad(scene):
    w, h = SIDE
    o, d = Camera.create(**CAM, width=w, height=h).generate_rays(
        torch.rand(w * h) * h, torch.rand(w * h) * w, torch.rand(w * h), torch.rand(w * h))
    for grad_o, grad_d in ((True, False), (False, True)):
        col = integrator.trace_paths(
            scene, o.clone().requires_grad_(grad_o), d.clone().requires_grad_(grad_d),
            level=LEVEL, hittable_pdf_weight=0.5, generator=torch.Generator().manual_seed(2))
        assert col.requires_grad


def _sppm(scene):
    cfg = config.RenderConfig(image_width=8, image_height=8, ppm_num_photon_per_pass=64,
                              ppm_num_pass=1, ppm_max_bounce=4, ppm_alpha=0.7,
                              ppm_radius_scaling_factor=1.0)
    img = sppm.render_sppm(scene, Camera.create(**CAM, width=8, height=8), cfg, 5)
    assert img.shape == (8, 8, 3)


@pytest.mark.parametrize("case", ["value_and_grad", "gradient_render", "rays_require_grad",
                                  "sppm"])
def test_no_launch_where_a_gradient_is_asked_for_or_in_sppm(case, tmp_path, monkeypatch):
    """`render_image_value_and_grad`'s `wrt` are scene tensors that require
    grad: neither its pass without a graph nor its replay takes the kernel;
    nor does a graph-recording render, a step whose rays require grad, or
    SPPM's own shading (its `force_refract` calls stay on the torch ops)."""
    scene = _scene(tmp_path, "cornell", CPU)[0]
    _spy(monkeypatch)
    tracing.reset("launch.")
    {"value_and_grad": _value_and_grad, "gradient_render": _gradient_render,
     "rays_require_grad": _rays_require_grad, "sppm": _sppm}[case](scene)
    assert tracing.totals["launch.shade_surface"] == 0


def _recorded_steps(folder, name, dev, monkeypatch, side=(16, 16), level=4):
    scene, cam_kw = _scene(folder, name, dev)
    steps = []
    _spy(monkeypatch, steps)
    _render(scene, cam_kw, side, 1, level, dev)
    monkeypatch.undo()
    assert len(steps) == level
    return scene, steps


@pytest.mark.parametrize("name", list(SCENES))
def test_the_plain_path_is_the_torch_path_bit_for_bit(name, tmp_path, monkeypatch):
    """On the CPU `shade_surface` runs `shade_surface_reference`: the step's
    `interpolate_hit` and `sample_bsdf`, bit for bit, on every recorded step
    (the textured scene's bump frames, the nested box's false hits, refractions
    and scattering flags among them)."""
    scene, steps = _recorded_steps(tmp_path, name, CPU, monkeypatch)
    seen = {k: False for k in ("false_hit", "refracted", "sss", "reflected")}
    for args in steps:
        got = surface.shade_fields(surface.shade_surface(*args))
        want = surface.shade_fields(_torch_ops(*args))
        assert got.keys() == want.keys()
        for key in want:
            _assert_same(got[key], want[key])
        for key in seen:
            seen[key] |= bool(want[key].any())
    if name == "nested":
        assert all(seen.values()), seen
    if name == "textured":
        assert scene.materials.atlas.rgb.shape[0] > 1


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _assert_kernel_matches_plain(args):
    """The kernel against `shade_surface_reference` on the same inputs; the
    share of rays on which every output is bit-equal."""
    before = tracing.totals["launch.shade_surface"]
    with torch.no_grad():
        got = surface.shade_fields(surface.launch_shade_surface(*args))
        want = surface.shade_fields(surface.shade_surface_reference(*args))
    torch.cuda.synchronize()
    assert tracing.totals["launch.shade_surface"] == before + 1
    r = want["mat_id"].shape[0]
    same = torch.ones(r, dtype=torch.bool, device=want["mat_id"].device)
    for key in surface.SHADE_DISCRETE:
        same &= got[key] == want[key]
    assert float(same.float().mean()) >= 0.99999, {
        key: int((got[key] != want[key]).sum()) for key in surface.SHADE_DISCRETE}
    bits = same.clone()
    for key in surface.SHADE_FLOATS:
        a, b = got[key], want[key]
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-6, equal_nan=True,
                                   msg=lambda m, key=key: f"{key}: {m}")
        eq = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
        bits &= eq.all(dim=-1) if eq.dim() > 1 else eq
    return got, want, float(bits.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell-0", "cornell-3", "textured-1", "nested-1"])
def test_kernel_matches_plain_on_recorded_steps(cuda, case, tmp_path, monkeypatch):
    name, bounce = case.split("-")
    _, steps = _recorded_steps(tmp_path, name, cuda, monkeypatch, side=(256, 256))
    _, want, bit_equal = _assert_kernel_matches_plain(steps[int(bounce)])
    print(f"{case}: bit-equal on {bit_equal:.7f} of the rays")
    assert float(want["diffuse"].float().mean()) > 0.05


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True)


@pytest.mark.cuda
def test_kernel_edge_cases(cuda, tmp_path, monkeypatch):
    """Edited inputs of the nested box's bounce-1 step: grazing exits from
    the glass (total internal reflection), empty stacks and empty slots
    inside a stack, a false hit forced on every transparent hit, uniforms
    at 0 and 1, kd = ks = 0 on every material, n_s = inf on every material;
    and of the textured mesh's step: NaN tangents and NaN uvs."""
    _, steps = _recorded_steps(tmp_path / "nested", "nested", cuda, monkeypatch,
                               side=(128, 128))
    g, table, slot, bary, d, stack_ids, stack_len, u = steps[1]
    r = slot.shape[0]
    third = torch.arange(r, device=cuda) % 3
    _, _, normal, mat_id, _ = surface.shade_surface_reference(*steps[1])
    glass = (table.t_r[mat_id.long()] > 0) & (mat_id >= 0)
    assert bool(glass.any())

    # grazing exits: d . n = +0.05 on every transparent hit
    side = _unit(torch.cross(normal, torch.tensor([0.3, 0.9, 0.1], device=cuda).expand_as(normal),
                             dim=-1))
    grazing = torch.where(glass[:, None], _unit(0.05 * normal + side), d)
    got, _, _ = _assert_kernel_matches_plain((g, table, slot, bary, grazing, stack_ids,
                                              stack_len, u))
    tir = glass & ~got["false_hit"] & ~got["refracted"]
    assert bool(tir.any())

    # empty stacks on a third of the rays, an empty slot inside the stack on another
    ids = stack_ids.clone()
    ids[:, 1] = torch.where(third == 1, materials.EMPTY_SLOT, ids[:, 1])
    length = torch.where(third == 0, 0, torch.where(third == 1, stack_len.clamp(min=2), stack_len))
    _assert_kernel_matches_plain((g, table, slot, bary, d, ids, length.to(torch.int32), u))

    # a false hit on every transparent hit: the material of the lowest priority
    # value (an opaque one) on top of the stack
    low = int(torch.argmin(table.priority))
    assert bool((table.priority[mat_id[glass].long()] > table.priority[low]).all())
    ids = stack_ids.clone()
    ids[:, 1] = torch.where(glass, low, stack_ids[:, 1])
    length = torch.where(glass, 2, stack_len).to(torch.int32)
    got, _, _ = _assert_kernel_matches_plain((g, table, slot, bary, d, ids, length, u))
    assert bool(got["false_hit"][glass].all())

    # uniforms at the ends of [0, 1]
    for value in (0.0, 1.0 - 2.0 ** -24):
        _assert_kernel_matches_plain((g, table, slot, bary, d, stack_ids, stack_len,
                                      torch.full_like(u, value)))

    # kd = ks = 0 (every opaque material a pure emitter), then n_s = inf
    dark = dataclasses.replace(table, kd=torch.zeros_like(table.kd), ks=torch.zeros_like(table.ks))
    got, _, _ = _assert_kernel_matches_plain((g, dark, slot, bary, d, stack_ids, stack_len, u))
    assert not bool(got["diffuse"].any())
    mirror = dataclasses.replace(table, n_s=torch.full_like(table.n_s, math.inf))
    _assert_kernel_matches_plain((g, mirror, slot, bary, d, stack_ids, stack_len, u))

    # the textured mesh: NaN tangents on half the triangles, NaN uvs on a quarter
    _, tsteps = _recorded_steps(tmp_path / "textured", "textured", cuda, monkeypatch,
                                side=(128, 128))
    tg, ttable, tslot, tbary, td, tids, tlen, tu = tsteps[1]
    rows = torch.arange(tg.attr.shape[0], device=cuda)
    tangent = torch.where((rows % 2 == 0)[:, None, None], math.nan, tg.tangent)
    attr = tg.attr.clone()
    attr[rows % 4 == 1, 18:24] = math.nan
    edited = dataclasses.replace(tg, tangent=tangent, attr=attr)
    _assert_kernel_matches_plain((edited, ttable, tslot, tbary, td, tids, tlen, tu))


@pytest.mark.cuda
def test_render_with_and_without_the_kernel(cuda, tmp_path, monkeypatch):
    scene, _ = _scene(tmp_path, "cornell", cuda)
    spp, level = 2, 8
    tracing.reset("launch.")
    with_kernel = _render(scene, CAM, (128, 128), spp, level, cuda)
    assert tracing.totals["launch.shade_surface"] == spp * level
    monkeypatch.setattr(surface, "shade_surface", surface.shade_surface_reference)
    without = _render(scene, CAM, (128, 128), spp, level, cuda)
    assert tracing.totals["launch.shade_surface"] == spp * level
    close = torch.isclose(with_kernel, without, rtol=1e-4, atol=0.0).all(dim=-1)
    assert float(close.float().mean()) >= 0.999
    assert float(without.mean()) > 0.01
