"""PyTorch port vs the JAX package: the differentiable SPPM render
(`render_sppm_differentiable`) and the loss through the photon mapper
(`optim.sppm_loss_fn`), at the sizes of tests/test_sppm_diff.py (8x8, 256
photons, 2 passes, photon bounces 4, eye bounces 6) on its dimmed box (light
Kd 0.78, Ke 2), built with the port's own `testscenes` and `build_scene`.

One case calls the reference's `render_sppm_differentiable` (jitted, one
forward, no `jax.grad`: the reference's gradients are compiled by its own
tests), with the port fed the same uniforms folded from the same key
(`torch_parity.sppm_diff_uniforms_from_key`).  The port's gradients are held
against its own central differences: ke scaled by theta moves no photon and
no pick probability, so the pathwise gradient is exact up to rounding.

Tolerances, each stated where it is used: the differentiable modes equal the
forward modes exactly; pixels against the reference rtol 1e-4, atol 1e-6 on
>= 99% of them (measured: all 64); gradients rtol 1e-3 against central
differences (eps 1e-2) and between the dense and grid gathers.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.models.scene import build_scene as jax_build_scene
from gpu_pathtracer_tpu.render import sppm as jsppm
from gpu_pathtracer_tpu.utils import obj_io as jobj_io
from gpu_pathtracer_tpu_torch import optim
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import lights as lights_mod
from gpu_pathtracer_tpu_torch.render import sppm
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
KW = dict(width=8, height=8, n_photons=256, num_pass=2, max_bounce=4, eye_bounce=6)
EPS = 1e-2


def _dim_box(folder, fog=False):
    """tests/test_sppm_diff.py's box: emission dimmed well below the direct
    chain's clamp at 1, a light with a diffuse component."""
    testscenes.make_cornell_box(folder, spheres=fog, sphere_subdiv=0, fog=fog)
    mtl = folder / "box.mtl"
    mtl.write_text(mtl.read_text().replace(
        "newmtl light\nKd 0 0 0", "newmtl light\nKd 0.78 0.78 0.78").replace(
        "Ke 15 15 15", "Ke 2 2 2"))
    return folder


@pytest.fixture(scope="module")
def box_folder(tmp_path_factory):
    return _dim_box(tmp_path_factory.mktemp("diff_box"))


@pytest.fixture(scope="module")
def dim_box(box_folder):
    return build_scene(obj_io.load_scene(box_folder, "box.obj"), "cpu")


@pytest.fixture(scope="module")
def dim_fog_box(tmp_path_factory):
    folder = _dim_box(tmp_path_factory.mktemp("diff_fog_box"), fog=True)
    return build_scene(obj_io.load_scene(folder, "box.obj"), "cpu")


def _cam(n=8):
    return Camera.create(**CAM, width=n, height=n)


def _scaled(scene, theta):
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, ke=scene.materials.ke * theta))


def _mean_and_grad(scene, **kw):
    """mean(render(theta * ke)) at theta = 1 and its autograd derivative."""
    theta = torch.tensor(1.0, requires_grad=True)
    img = sppm.render_sppm_differentiable(_scaled(scene, theta), _cam(), **kw)
    (grad,) = torch.autograd.grad(img.mean(), theta)
    return img.detach(), float(grad)


def _central_difference(scene, **kw):
    with torch.no_grad():
        side = [float(sppm.render_sppm_differentiable(_scaled(scene, torch.tensor(t)), _cam(),
                                                      **kw).mean())
                for t in (1.0 + EPS, 1.0 - EPS)]
    return (side[0] - side[1]) / (2 * EPS)


# ---------------------------------------------------------------------------
# (a), (b): the emitter energies and the passes' differentiable modes
# ---------------------------------------------------------------------------

def test_leaf_energies_match_baked(dim_box):
    """The live table's emitter energies equal those `build_scene` baked
    into the light tree's leaves: rtol 1e-5."""
    lt = dim_box.light_tree
    live = lights_mod.leaf_energies(lt, dim_box.materials, dim_box.geom.mat_id)
    baked = lt.node_energy[lt.num_lights - 1:]
    np.testing.assert_allclose(live.numpy(), baked.numpy(), rtol=1e-5)


def test_photon_pass_differentiable_mode_identical(dim_box):
    """The same generator state: every field of the photon map equal; only
    the differentiable mode's colours carry gradient."""
    scene = _scaled(dim_box, torch.tensor(1.0, requires_grad=True))
    maps = [sppm.photon_pass(scene, 128, max_bounce=4, differentiable=diff,
                             generator=torch.Generator().manual_seed(3))
            for diff in (False, True)]
    for f in dataclasses.fields(sppm.Photons):
        a, b = (getattr(m, f.name) for m in maps)
        assert torch.equal(a, b), f.name
    assert maps[1].color.requires_grad and not maps[0].color.requires_grad
    assert int(maps[1].valid.sum()) > 20


def test_eye_pass_differentiable_mode_identical(dim_fog_box):
    """On the box with the glass and fog spheres, 16 rays (the reference's
    case) and 1,600 rays with compaction asked for: the differentiable mode
    equals the forward mode without compaction exactly (it never compacts,
    whose stages would draw other numbers), and only its direct radiance
    carries gradient."""
    scene = _scaled(dim_fog_box, torch.tensor(1.0, requires_grad=True))
    for n, compact_min in ((4, None), (40, 1)):
        r = n * n
        pix = (torch.arange(r, dtype=torch.float32) % n) + 0.5
        vol_r = torch.full((r,), float("inf"))
        args = (scene, _cam(n), pix, pix.flip(0), None, vol_r)

        def run(diff, cmin):
            return sppm.eye_pass(*args, init=False, max_bounce=6, differentiable=diff,
                                 compact_min=cmin, generator=torch.Generator().manual_seed(5))

        plain, diff = run(False, 0), run(True, compact_min)
        for a, b in zip(plain, diff):
            assert torch.equal(a, b)
        assert diff[3].requires_grad and not plain[3].requires_grad
        if compact_min:  # compaction does run in forward mode, on other numbers
            compacted = run(False, compact_min)
            assert not torch.equal(compacted[0], plain[0])


# ---------------------------------------------------------------------------
# (c): the one call of the reference
# ---------------------------------------------------------------------------

def test_render_matches_jax_same_uniforms(box_folder, dim_box):
    """The reference's jitted `render_sppm_differentiable` from key 0 and the
    port's from the same uniforms: >= 99% of the pixels within rtol 1e-4,
    atol 1e-6 (measured: 64 of 64)."""
    jscene = jax_build_scene(jobj_io.load_scene(box_folder, "box.obj"))
    key = jax.random.key(0)
    jimg = np.asarray(jsppm.render_sppm_differentiable(
        jscene, JCamera.create(**CAM, width=8, height=8), key, **KW))
    uni = torch_parity.sppm_diff_uniforms_from_key(
        key, 64, KW["n_photons"], KW["num_pass"], KW["max_bounce"], KW["eye_bounce"])
    img = sppm.render_sppm_differentiable(dim_box, _cam(), **KW, uniforms=uni).numpy()
    assert img.shape == jimg.shape == (8, 8, 3) and jimg.mean() > 1e-3
    close = np.isclose(img, jimg, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(img - jimg).max())


# ---------------------------------------------------------------------------
# (d)-(f): gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_gradient_matches_finite_difference(dim_box, grid):
    """d mean(img) / d theta for ke * theta by autograd against the central
    difference, rtol 1e-3: the dense gathers, and the grid gathers at the
    realistic cell cap (k_per_cell 8; the cap's truncation does not depend
    on theta)."""
    kw = dict(KW, gather_grid=grid, k_per_cell=8)
    _, grad = _mean_and_grad(dim_box, **kw)
    fd = _central_difference(dim_box, **kw)
    assert np.isfinite(grad) and fd > 0
    np.testing.assert_allclose(grad, fd, rtol=1e-3)


def test_grid_matches_dense_image_and_gradient(dim_box):
    """With k_per_cell = n_photons the 27 cells hold every in-radius photon,
    so the grid gathers pick the dense gathers' photons: image rtol 1e-4
    (atol 1e-6), gradient rtol 1e-3."""
    kw = dict(KW, k_per_cell=KW["n_photons"])
    img_d, g_d = _mean_and_grad(dim_box, gather_grid=False, **kw)
    img_g, g_g = _mean_and_grad(dim_box, gather_grid=True, **kw)
    np.testing.assert_allclose(img_g.numpy(), img_d.numpy(), rtol=1e-4, atol=1e-6)
    assert np.isfinite(g_d) and g_d > 0
    np.testing.assert_allclose(g_g, g_d, rtol=1e-3)


def test_volume_grid_matches_dense_gradient(dim_fog_box):
    """The fog box with `gather_volume`: the grid beam gather with the static
    step bound `vol_steps` 48 against the dense recorded-segment gather,
    image rtol 1e-3 (atol 1e-5), gradient rtol 1e-3 (the reference's sizes:
    192 photons, 6 photon and 8 eye bounces, seed 4)."""
    kw = dict(KW, n_photons=192, max_bounce=6, eye_bounce=8, gather_volume=True,
              k_per_cell=192, vol_steps=48, seed=4)
    img_d, g_d = _mean_and_grad(dim_fog_box, gather_grid=False, **kw)
    img_g, g_g = _mean_and_grad(dim_fog_box, gather_grid=True, **kw)
    assert torch.isfinite(img_g).all() and float(img_g.mean()) > 1e-5
    np.testing.assert_allclose(img_g.numpy(), img_d.numpy(), rtol=1e-3, atol=1e-5)
    assert np.isfinite(g_g) and g_d > 0
    np.testing.assert_allclose(g_g, g_d, rtol=1e-3)


def test_volume_grid_static_steps_and_gradient(dim_fog_box):
    """`volume_gather_segments_grid` with `static_steps`: as many steps as
    the longest segment needs give the unbounded gather's value (rtol 1e-5)
    and, through the scatter of the visited segments back into their slots,
    the dense gather's gradient to the photon colours (rtol 1e-5); two steps
    lose the tails, which the eye pass's `beam_steps_dropped` counts with the
    same bound."""
    table = dim_fog_box.materials
    rng = np.random.default_rng(9)
    p, r, s = 512, 64, 4
    fog_id = int(table.scattering_coef.argmax())
    f = lambda *shape: rng.uniform(0, 1, shape).astype(np.float32)  # noqa: E731
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    pos = f(p, 3)
    ph = dict(pos=pos, color=f(p, 3), direction=unit(rng.normal(size=(p, 3))), prev=pos,
              on_surface=np.zeros(p, bool), valid=rng.random(p) < 0.8)
    seg = [torch.from_numpy(a) for a in (
        f(r, s, 3), unit(rng.normal(size=(r, s, 3))),
        rng.uniform(0.1, 1.2, (r, s)).astype(np.float32), np.full((r, s), fog_id, np.int32),
        f(r, s, 3), rng.random((r, s)) < 0.7, rng.uniform(0.02, 0.08, r).astype(np.float32))]
    spacing = float(sppm._beam_spacing(seg[5], seg[6]))
    needed = int(np.ceil(float(seg[2][seg[5]].max()) / spacing)) + 1

    def gather(kind, **kw):
        photons = convert.photons_from_numpy(ph, "cpu")
        photons.color.requires_grad_(True)
        fn = (sppm.volume_gather_segments_dense if kind == "dense"
              else sppm.volume_gather_segments_grid)
        out = fn(table, photons, *seg, **kw)
        (grad,) = torch.autograd.grad(out.sum(), photons.color)
        return out.detach(), grad

    dense, g_dense = gather("dense")
    unbounded, _ = gather("grid", chunk=100)
    static, g_static = gather("grid", chunk=100, static_steps=needed)
    cut, _ = gather("grid", chunk=100, static_steps=2)
    assert dense.sum() > 0 and g_dense.abs().sum() > 0
    np.testing.assert_allclose(static.numpy(), unbounded.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g_static.numpy(), g_dense.numpy(), rtol=1e-5, atol=1e-7)
    assert float(cut.sum()) < 0.9 * float(static.sum())


# ---------------------------------------------------------------------------
# (g)-(i): the loss, another scene, the hooks
# ---------------------------------------------------------------------------

def test_sppm_emitter_optimization_recovers(dim_box):
    """tests/test_sppm_diff.py's recovery: the emitter dimmed 4x, `ke`
    optimized against a target rendered with the true emission from the
    loss's own seed (a deterministic loss with its zero at the truth), 40
    Adam steps at lr 0.1: loss < 0.15x its start, the emissive rows' error
    < 0.5x its start."""
    cam = _cam()
    with torch.no_grad():
        target = sppm.render_sppm_differentiable(dim_box, cam, **KW, seed=1)
    dimmed = _scaled(dim_box, 0.25)
    base = optim.sppm_loss_fn(dimmed, cam, target, n_photons=KW["n_photons"],
                              num_pass=KW["num_pass"], max_bounce=KW["max_bounce"],
                              eye_bounce=KW["eye_bounce"], seed=1)
    params, losses = optim.optimize(dimmed, cam, target, param_names=("ke",), steps=40, lr=0.1,
                                    loss_fn=lambda params, _generator: base(params))
    assert losses[-1] < 0.15 * losses[0], losses
    ke_true = dim_box.materials.ke
    emissive = ke_true.amax(dim=-1) > 0
    err0 = float((ke_true * 0.25 - ke_true).abs()[emissive].mean())
    err1 = float((params["ke"] - ke_true).abs()[emissive].mean())
    assert err1 < 0.5 * err0, (err0, err1, losses)


def test_neon_sign_renders_and_differentiates(tmp_path):
    """The many thin coloured emitters of the neon sign: finite, non-negative
    and not black, with a finite positive gradient."""
    testscenes.make_neon_sign(tmp_path, segs_per_tube=6, emission=4.0)
    neon = build_scene(obj_io.load_scene(tmp_path, "sign.obj"), "cpu")
    assert neon.light_tree.num_lights >= 30
    img, grad = _mean_and_grad(neon, **KW, seed=2)
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert float(img.mean()) > 1e-4, float(img.mean())
    assert np.isfinite(grad) and grad > 0, grad


def test_pixel_sharding_raises(dim_box):
    """`pixel_sharding` is ported (it no longer raises): a mesh of this
    process alone gives the unsharded image bit for bit, and the same
    gradient to `ke` (the two-rank job is `tests/test_torch_parallel.py`)."""
    from gpu_pathtracer_tpu_torch.parallel.shard import make_mesh

    ke = dim_box.materials.ke.clone().requires_grad_(True)
    scene = dataclasses.replace(dim_box, materials=dataclasses.replace(dim_box.materials, ke=ke))
    images, grads = [], []
    for kw in ({}, dict(pixel_sharding=make_mesh(device="cpu"))):
        img = sppm.render_sppm_differentiable(scene, _cam(), **KW, **kw)
        images.append(img.detach())
        grads.append(torch.autograd.grad(img.mean(), ke)[0])
    assert torch.equal(images[0], images[1]) and torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


def test_photon_pass_fn_hook(dim_box):
    """`photon_pass_fn` replaces the photon pass, called with
    `differentiable=True` once a pass; the image is the default render's."""
    calls = []

    def traced(*args, **kwargs):
        calls.append(kwargs["differentiable"])
        return sppm.photon_pass(*args, **kwargs)

    with torch.no_grad():
        a = sppm.render_sppm_differentiable(dim_box, _cam(), **KW, photon_pass_fn=traced)
        b = sppm.render_sppm_differentiable(dim_box, _cam(), **KW)
    assert calls == [True] * KW["num_pass"]
    assert torch.equal(a, b)
