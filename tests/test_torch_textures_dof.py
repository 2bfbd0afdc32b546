"""PyTorch port vs the JAX package on the textured and the thin-lens paths
(BASELINE configs 2-3): `map_Kd`, `map_Bump`, the equirect sky image, the
gradient to the atlas texels, and the glass + depth-of-field leg.

* Per ray: `trace_paths` at level 3 on every ray, the JAX function run op
  by op (`jax.disable_jit()`, `tests/test_torch_render.py`'s rule) with the
  port fed the uniforms that JAX folds from the same key, both packages
  built from the same host arrays; rtol 1e-4 on every ray of a 16x16
  frame (one ray count for every case: JAX compiles each primitive once per
  shape, so the cases share most of the op-by-op compiles):
  - the checker wall of `tests/test_integration_tex.py` with `map_Kd`,
    `map_Bump -bm 5.0` and its directional sky image (over a dim base), and
    the same wall without `map_Bump`;
  - the textured mesh (`chip_smoke.textured_mesh_host`: the subdivided
    sphere with the checker and the bump field on material 1) at subdiv 2,
    lit by its quad and the sky image;
  - the `glass_priority` Cornell box through the bench's thin lens
    (aperture 0.08, focus 2.0; the lens uniforms from a numpy seed), the
    camera's rays held to JAX's first.  (At 24x24 one ray of 576 parts:
    torch's and XLA's CPU `cos` round one bounce-0 sample 1 ulp apart, and
    the path then meets the ceiling beside the light; ROADMAP C.)
* The gradient of the summed radiance to `atlas_rgb` against `jax.grad` on
  the same uniforms: equal (rtol 1e-4) on every finite row; with `map_Bump`
  NaN on the same rows in both packages (a reference behaviour), without it
  no NaN.  The texel gather sums its backward in float64, so halves and
  the whole agree.
* `optimize(param_names=("atlas_rgb",))` recovers the dimmed checker
  (`tests/test_optim.py::test_atlas_texel_recovery`'s bounds).
* `render_image` with `dof_sample_size=2` on the glass box: 4x4 region
  means against JAX's render within 5 sigma, sigma from the spread of the
  port's 8 batches
  (`test_render_image_region_means_match_jax`'s bound).
* The CLI on a master file that names a sky image: finite, and the checker
  shows.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.models.scene import build_scene as jax_build_scene
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu_torch import optim
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import texture
from gpu_pathtracer_tpu_torch.render import integrator
from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes
from gpu_pathtracer_tpu_torch.utils.image import load_ppm
from test_integration_tex import _make_textured_scene

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
LEVEL, WEIGHT, SIDE = 3, 0.5, 16
WALL_CAM = dict(eye=(0.5, 0.5, 1.2), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=50.0)
GLASS_CAM = dict(chip_smoke.CORNELL_CAM, aperture=chip_smoke.GLASS["aperture"],
                 focus_dist=chip_smoke.GLASS["focus_dist"])
# test_map_bump_changes_shading's directional sky, over a dim base so that
# most paths of the 16x16 frame carry light
SKY = chip_smoke.sky_image(16, 32, chip_smoke.TEX["sky_band"], base=0.25)


def _rays(cam_kw, n, lens_seed=None):
    """JAX's camera rays of an n x n frame at the pixel centres (the lens
    uniforms from a numpy seed, else the lens centre), held to the port's."""
    ii, jj = np.meshgrid(np.arange(n, dtype=np.float32), np.arange(n, dtype=np.float32),
                         indexing="ij")
    pi, pj = ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5
    if lens_seed is None:
        u1 = u2 = np.zeros(n * n, np.float32)
    else:
        u1, u2 = np.random.default_rng(lens_seed).random((2, n * n), dtype=np.float32)
    o, d = (np.array(x) for x in JCamera.create(**cam_kw, width=n, height=n).generate_rays(
        pi, pj, u1, u2))
    to, td = Camera.create(**cam_kw, width=n, height=n).generate_rays(
        *(torch.from_numpy(x) for x in (pi, pj, u1, u2)))
    np.testing.assert_allclose(to.numpy(), o, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), d, rtol=0, atol=1e-6)
    return o, d


def _run(host, cam_kw, n, seed, grad, lens_seed=None, **scene_kw):
    """Per-ray radiance of both packages on the same uniforms (JAX op by
    op) and the port's gradient of its sum to the atlas texels; with
    `grad` JAX's too (`jax.grad`, op by op)."""
    jscene = jax_build_scene(host, **scene_kw)
    scene = build_scene(host, "cpu", **scene_kw)
    o, d = _rays(cam_kw, n, lens_seed)
    key = jax.random.key(seed)

    def radiance(rgb):
        mats = dataclasses.replace(jscene.materials, atlas=dataclasses.replace(
            jscene.materials.atlas, rgb=rgb))
        col = jint.trace_paths(dataclasses.replace(jscene, materials=mats), o, d, key,
                               level=LEVEL, hittable_pdf_weight=WEIGHT)
        return col.sum(), col

    out = {}
    with jax.disable_jit():
        if grad:
            jg, ref = jax.grad(radiance, has_aux=True)(jscene.materials.atlas.rgb)
            out["jax_grad"] = np.asarray(jg)
        else:
            ref = radiance(jscene.materials.atlas.rgb)[1]
    out["jax"] = np.asarray(ref)
    textured = scene.materials.atlas.rgb.shape[0] > 1
    rgb = scene.materials.atlas.rgb.clone().requires_grad_(textured)
    with torch.set_grad_enabled(textured):
        col = integrator.trace_paths(
            optim._substitute(scene, {"atlas_rgb": rgb}), torch.from_numpy(o),
            torch.from_numpy(d), level=LEVEL, hittable_pdf_weight=WEIGHT,
            uniforms=torch.from_numpy(torch_parity.uniforms_from_key(key, LEVEL, n * n)))
    if textured:
        (out["grad"],) = (g.numpy() for g in torch.autograd.grad(col.sum(), rgb))
        atlas = host.atlas
        k = atlas.names.index("checker.png")
        out["checker_rows"] = slice(int(atlas.offsets[k]),
                                    int(atlas.offsets[k] + atlas.heights[k] * atlas.widths[k]))
    out["port"] = col.detach().numpy()
    return out


@pytest.fixture(scope="module")
def wall_host(tmp_path_factory):
    folder = tmp_path_factory.mktemp("wall")
    _make_textured_scene(folder, bump=True)
    return obj_io.load_scene(folder, "wall.obj")


def _wall(host, grad):
    return _run(host, WALL_CAM, SIDE, 5, grad, sky_emission=(1.0, 1.0, 1.0), sky_image=SKY)


@pytest.fixture(scope="module")
def wall_bump(wall_host):
    return _wall(wall_host, grad=True)


@pytest.fixture(scope="module")
def wall_flat(wall_host):
    """The wall without `map_Bump` (the atlas keeps the bump image, unread,
    so the shapes and JAX's op-by-op compiles are the bumped wall's)."""
    return _wall(chip_smoke.without_bump(wall_host), grad=False)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    host = chip_smoke.textured_mesh_host(tmp_path_factory.mktemp("mesh"), 2, checker=256,
                                         bump_side=64)
    return _run(host, chip_smoke.MESH_CAM, SIDE, 6, grad=False, sky_emission=(1.0, 1.0, 1.0),
                sky_image=chip_smoke.sky_image(32, 64, chip_smoke.TEX["sky_band"]))


@pytest.fixture(scope="module")
def glass_host(tmp_path_factory):
    folder = tmp_path_factory.mktemp("glass")
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2, glass_priority=True)
    return obj_io.load_scene(folder, "box.obj")


@pytest.fixture(scope="module")
def glass(glass_host):
    return _run(glass_host, GLASS_CAM, SIDE, 7, grad=False, lens_seed=3)


@pytest.mark.parametrize("case", ["wall_bump", "wall_flat", "mesh", "glass"])
def test_trace_paths_per_ray_matches_jax(request, case):
    run = request.getfixturevalue(case)
    got, ref = run["port"], run["jax"]
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-7).all(axis=-1)
    assert close.all(), (close.mean(), np.nonzero(~close)[0][:10])
    assert np.isfinite(got).all() and (ref.sum(-1) > 0).mean() > 0.25


def test_atlas_gradient_matches_jax(wall_bump):
    """With `map_Bump`: `jax.grad`'s rows, NaN on the same rows (the bump
    branch's, a reference behaviour: the default texel and some bump
    texels), equal on every finite row."""
    got, ref = wall_bump["grad"], wall_bump["jax_grad"]
    nan = np.isnan(ref).any(axis=-1)
    np.testing.assert_array_equal(np.isnan(got).any(axis=-1), nan)
    assert nan[0] and nan.sum() > 1
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-4, atol=0)
    assert (np.abs(ref[~nan]).sum(axis=-1) > 0).sum() > 20  # the checker's texels get gradient


@pytest.mark.parametrize("case", ["wall_flat", "mesh"])
def test_atlas_gradient_finite_without_bump_map(request, case):
    """Without `map_Bump` no texel gradient is NaN; on the bumped mesh (its
    tangents NaN: the default frame) none of the checker's texels is NaN.
    Either way more than 20 checker texels get a gradient."""
    run = request.getfixturevalue(case)
    got = run["grad"]
    nan = np.isnan(got).any(axis=-1)
    if case == "mesh":
        assert not nan[run["checker_rows"]].any()
    else:
        assert not nan.any()
    assert (np.abs(got[run["checker_rows"]]).sum(axis=-1) > 0).sum() > 20


def test_texel_gather_backward_sums_in_float64():
    """A texel gradient summed over 65,536 lookups whole, or in two halves
    as two ranks sum it, is the float64 sum rounded once (rtol 2e-7, as the
    material table's gather)."""
    rng = np.random.default_rng(1)
    atlas = texture.Atlas(
        rgb=torch.rand((1 + 16, 3), generator=torch.Generator().manual_seed(1)).requires_grad_(True),
        offsets=torch.tensor([0, 1], dtype=torch.int32), heights=torch.tensor([1, 4], dtype=torch.int32),
        widths=torch.tensor([1, 4], dtype=torch.int32))
    n = 65536
    slot = torch.from_numpy(rng.integers(0, 2, n)).to(torch.int32)
    uv = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
    g = torch.from_numpy(rng.random((n, 3), dtype=np.float32) * 1e-3)
    (whole,) = torch.autograd.grad(texture.lookup(atlas, slot, uv), atlas.rgb, g)
    halves = sum(torch.autograd.grad(texture.lookup(atlas, slot[s], uv[s]), atlas.rgb, g[s])[0]
                 for s in (slice(0, n // 2), slice(n // 2, None)))
    with torch.no_grad():
        idx = texture.texel_index(atlas, slot, uv)
        assert torch.equal(texture.lookup(atlas, slot, uv), atlas.rgb[idx])
    want = np.zeros((17, 3))
    np.add.at(want, idx.numpy(), g.numpy().astype(np.float64))
    np.testing.assert_allclose(whole.numpy(), want, rtol=2e-7)
    np.testing.assert_allclose(halves.numpy(), want, rtol=2e-7)


def test_lookups_of_nan_coordinates_match_jax():
    """A NaN uv or direction (a path can carry one: the texel steps of
    `optimize` zero an albedo) reads index 0 along its axis as in the
    reference, whose float-to-int conversion maps NaN to 0; torch's would
    index out of the atlas (an IndexError here, a fault on the card)."""
    from gpu_pathtracer_tpu.ops import texture as jtexture

    rng = np.random.default_rng(4)
    rgb = rng.random((1 + 12 + 6, 3), dtype=np.float32)
    offsets, heights, widths = (np.array(x, np.int32) for x in ([0, 1, 13], [1, 3, 2], [1, 4, 3]))
    slot = np.array([1, 1, 2, 2, 1, 0], np.int32)
    uv = np.array([[np.nan, 0.3], [0.7, np.nan], [np.inf, -np.inf], [np.nan, np.nan],
                   [1.25, -0.5], [np.nan, 0.0]], np.float32)
    d = np.array([[np.nan, 0.0, 1.0], [0.0, np.nan, 0.0], [np.nan] * 3, [0.6, 0.0, -0.8]],
                 np.float32)
    emission = np.array([1.0, 0.5, 2.0], np.float32)
    want = jtexture.lookup(jtexture.Atlas(rgb, offsets, heights, widths), slot, uv)
    got = texture.lookup(texture.Atlas(*(torch.from_numpy(x) for x in (rgb, offsets, heights,
                                                                       widths))),
                         torch.from_numpy(slot), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jtexture.lookup_sky(rgb[1:13], 3, 4, d, emission)
    got = texture.lookup_sky(torch.from_numpy(rgb[1:13]), 3, 4, torch.from_numpy(d),
                             torch.from_numpy(emission))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_atlas_texel_recovery(tmp_path):
    """`optimize(param_names=("atlas_rgb",))` pulls the dimmed checker
    texels back toward the target's (`test_optim.py`'s scene and bounds)."""
    from test_optim import _make_tex_wall

    _make_tex_wall(tmp_path)
    scene = build_scene(obj_io.load_scene(tmp_path, "wall.obj"), "cpu",
                        sky_emission=(1.0, 1.0, 1.0))
    n = 12
    cam = Camera.create(**WALL_CAM, width=n, height=n)
    with torch.no_grad():
        target = integrator.render_image(scene, cam, n, n, sample_size=4, level=2,
                                         generator=torch.Generator().manual_seed(7))
    true_rgb = scene.materials.atlas.rgb.numpy().copy()
    dimmed = optim._substitute(scene, {"atlas_rgb": scene.materials.atlas.rgb * 0.4})
    base = optim.render_loss_fn(dimmed, cam, target, width=n, height=n, sample_size=4, level=2)
    # the target's generator seed: a fixed loss surface with its zero at the truth
    params, losses = optim.optimize(
        dimmed, cam, target, param_names=("atlas_rgb",), steps=30, lr=0.05,
        loss_fn=lambda params, _gen: base(params, torch.Generator().manual_seed(7)))
    assert losses[-1] < 0.25 * losses[0], losses
    got = params["atlas_rgb"].numpy()[1:]
    err0 = np.abs(true_rgb[1:] * 0.4 - true_rgb[1:]).mean()
    err1 = np.abs(got - true_rgb[1:]).mean()
    assert err1 < 0.6 * err0, (err0, err1, losses)


def test_glass_dof_region_means_match_jax(glass_host):
    """The bench's glass + DoF leg at 16x16: `dof_sample_size` 2, 64
    samples a pixel, level 3; 4x4 region means within 5 sigma of JAX's."""
    w = h = 16
    level, batches, spp, dof = 3, 8, 4, 2
    jimg = np.asarray(jint.render_image(
        jax_build_scene(glass_host), JCamera.create(**GLASS_CAM, width=w, height=h),
        jax.random.key(8), width=w, height=h, sample_size=batches * spp, dof_sample_size=dof,
        level=level, hittable_pdf_weight=WEIGHT))
    scene = build_scene(glass_host, "cpu")
    cam = Camera.create(**GLASS_CAM, width=w, height=h)
    with torch.no_grad():
        parts = np.stack([integrator.render_image(
            scene, cam, w, h, sample_size=spp, dof_sample_size=dof, level=level,
            hittable_pdf_weight=WEIGHT, generator=torch.Generator().manual_seed(100 + b)).numpy()
            for b in range(batches)])
    regions = parts.reshape(batches, h // 4, 4, w // 4, 4, 3).mean(axis=(2, 4))
    port = regions.mean(axis=0)
    jref = jimg.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    sigma = np.sqrt(2.0) * regions.std(axis=0, ddof=1) / np.sqrt(batches)
    assert np.all(np.abs(port - jref) <= 5.0 * sigma + 1e-4), (np.abs(port - jref).max(),
                                                                sigma.max())
    assert abs(port.mean() - jref.mean()) <= 0.05 * jref.mean()


def test_cli_renders_sky_image_master_file(tmp_path):
    """The checker wall under a sky image named in the master file
    (`texture_bg_path`), through the port's command line."""
    from PIL import Image

    _make_textured_scene(tmp_path)
    sky = np.full((16, 32, 3), 160, np.uint8)
    sky[:4] = 255
    Image.fromarray(sky).save(tmp_path / "sky.png")
    n = 16
    cfg = config.RenderConfig(
        input_folder_path=f"{tmp_path}/", obj_filename="wall.obj", texture_bg_path="sky.png",
        image_output_path=str(tmp_path / "out.ppm"), image_width=n, image_height=n,
        pathtracing_sample_size=4, pathtracing_level=2, sky_emission_r=1.0,
        sky_emission_g=1.0, sky_emission_b=1.0, eye_x=0.5, eye_y=0.5, eye_z=1.2,
        center_x=0.5, center_y=0.5, center_z=0.0, fovy=50.0)
    config.write_master_file(cfg, tmp_path / "master.txt")
    out = tmp_path / "cli.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.cli", str(tmp_path / "master.txt"),
         str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    img = load_ppm(out).astype(np.float32)
    assert img.shape == (n, n, 3) and np.isfinite(img).all()
    red, blue = img[..., 0], img[..., 2]
    assert (red > 2 * blue).sum() > 0.2 * n * n and (blue > 2 * red).sum() > 0.2 * n * n
