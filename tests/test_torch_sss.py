"""Sub-surface scattering in the PyTorch port vs the JAX package: the cases
of tests/test_sss.py, each also held against the JAX function on the same
arrays and the same uniforms.

The scene is the Cornell box whose white sphere carries `path_length 0.15`;
the port's scene is made from the JAX scene's own arrays (`models.convert`).
Tolerances: sampled points and gathers to rtol 1e-5 (the same float32
expressions; XLA may contract a product and a sum), the first pass's point
colours on >= 97% of the points to 1e-3 with the same uniforms (a path
splits where a float32 difference flips a branch) and in the mean within 2%;
the 16x16 render in the means over the sphere's pixels and over the rest
within 15%, each package with its own random numbers.
"""

import dataclasses
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.models.scene import SSSPoints as JSSSPoints
from gpu_pathtracer_tpu.models.scene import build_scene as jbuild_scene
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu.render import sss as jsss
from gpu_pathtracer_tpu.utils import obj_io, testscenes
from gpu_pathtracer_tpu_torch import renderer, tracing
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import SSSPoints
from gpu_pathtracer_tpu_torch.render import integrator, sss
from gpu_pathtracer_tpu_torch.utils import config

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
SPHERE_C, SPHERE_R = np.array([0.3, 0.2, 0.4]), 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


def make_sss_box(folder: pathlib.Path) -> None:
    """The fixture of tests/test_sss.py: the Cornell box whose first sphere
    (the white one) gets the `skin` material with a scattering path length."""
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=1)
    mtl = (folder / "box.mtl").read_text()
    mtl += "\nnewmtl skin\nKd 0.8 0.5 0.4\nKs 0 0 0\nd 1.0\nNs 1\npath_length 0.15\n"
    (folder / "box.mtl").write_text(mtl)
    lines = (folder / "box.obj").read_text().splitlines()
    seen = 0
    for i, line in enumerate(lines):
        if line == "usemtl white":
            seen += 1
            if seen == 4:  # 3 wall groups + the first sphere
                lines[i] = "usemtl skin"
                break
    (folder / "box.obj").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def box():
    with tempfile.TemporaryDirectory() as tmp:
        make_sss_box(pathlib.Path(tmp))
        jscene = jbuild_scene(obj_io.load_scene(tmp, "box.obj"))
    return jscene, convert.scene_from_numpy(torch_parity.flatten(jscene), "cpu")


def _point_uniforms(key, oid: int, p: int) -> np.ndarray:
    """(1, 3, P): `sample_sss_points` folds its key by the object id, then 0-2."""
    okey = jax.random.fold_in(key, oid)
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(okey, j), (p,)))
                     for j in range(3)])[None]


@pytest.fixture(scope="module")
def clouds(box):
    """64 points sampled by both packages from the same uniforms."""
    jscene, scene = box
    key = jax.random.key(0)
    jpts = jsss.sample_sss_points(jscene, key, 64)
    (oid,) = sss.sss_object_ids(scene)
    pts = sss.sample_sss_points(scene, 64, uniforms=_t(_point_uniforms(key, oid, 64)))
    return jpts, pts


def test_sample_points_match_jax_and_lie_on_the_sphere(box, clouds):
    jpts, pts = clouds
    assert pts.pos.shape == (64, 3) and pts.obj_id.dtype == torch.int32
    for name in ("pos", "normal", "filter", "color"):
        np.testing.assert_allclose(getattr(pts, name).numpy(), np.asarray(getattr(jpts, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(pts.obj_id.numpy(), np.asarray(jpts.obj_id))
    assert bool(pts.valid.all())
    d = np.linalg.norm(pts.pos.numpy() - SPHERE_C, axis=-1)
    assert (np.abs(d - SPHERE_R) < 0.02).all()
    np.testing.assert_allclose(pts.filter.numpy(), np.tile([[0.8, 0.5, 0.4]], (64, 1)), atol=1e-6)
    # from a generator: other points, the same surface; no SSS object: None
    gen_pts = sss.sample_sss_points(box[1], 32, generator=torch.Generator().manual_seed(1))
    d = np.linalg.norm(gen_pts.pos.numpy() - SPHERE_C, axis=-1)
    assert (np.abs(d - SPHERE_R) < 0.02).all()
    assert sss.sample_sss_points(torch_parity.cornell_scenes()[2], 8) is None


def _first_pass_uniforms(key, samples: int, level: int, s: int):
    dirs, paths = [], []
    for i in range(samples):
        skey = jax.random.fold_in(key, i)
        dirs.append(np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(skey, j), (s,)))
                              for j in range(2)]))
        paths.append(torch_parity.uniforms_from_key(jax.random.fold_in(skey, 2), level, s))
    return {"dir": _t(np.stack(dirs)), "paths": _t(np.stack(paths))}


def test_first_pass_matches_jax_and_gathers(box, clouds):
    jscene, scene = box
    jpts, pts = clouds
    key = jax.random.key(1)
    jdone = jsss.run_first_pass(jscene, jpts, key, sample_size=4, level=3)
    with torch.no_grad():
        done = sss.run_first_pass(scene, pts, sample_size=4, level=3,
                                  uniforms=_first_pass_uniforms(key, 4, 3, 64))
    col, jcol = done.color.numpy(), np.asarray(jdone.color)
    assert np.isfinite(col).all() and (col >= 0).all() and col.mean() > 0
    close = np.isclose(col, jcol, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.97, close.mean()
    assert abs(col.mean() - jcol.mean()) <= 0.02 * jcol.mean()

    # gather at the top of the sphere, on the JAX pass's colours in both
    done = dataclasses.replace(done, color=_t(jcol))
    hit = np.array([[0.3, 0.4, 0.4]], np.float32)
    obj = done.obj_id[0:1]
    kd = np.array([[0.8, 0.5, 0.4]], np.float32)
    out = sss.gather_sss(done, _t(hit), obj, torch.tensor([0.15]), _t(kd), torch.tensor([True]))
    jout = jsss.gather_sss(jdone, hit, jdone.obj_id[0:1], jnp.array([0.15]), kd,
                           jnp.array([True]))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5)
    assert float(out.sum()) > 0
    far = sss.gather_sss(done, torch.full((1, 3), 10.0), obj, torch.tensor([0.15]),
                         torch.ones((1, 3)), torch.tensor([True]))
    assert float(far.sum()) == 0.0
    off = sss.gather_sss(done, _t(hit), obj, torch.tensor([0.15]), _t(kd), torch.tensor([False]))
    assert float(off.sum()) == 0.0


def _synthetic_cloud(seed: int, s: int, r: int):
    rng = np.random.default_rng(seed)
    cloud = dict(
        pos=rng.uniform(size=(s, 3)).astype(np.float32),
        normal=np.tile(np.array([0.0, 1.0, 0.0], np.float32), (s, 1)),
        filter=np.ones((s, 3), np.float32),
        color=rng.uniform(size=(s, 3)).astype(np.float32),
        obj_id=rng.integers(0, 3, s).astype(np.int32),
        valid=rng.uniform(size=s) < 0.9,
    )
    query = (rng.uniform(size=(r, 3)).astype(np.float32), rng.integers(0, 3, r).astype(np.int32),
             rng.uniform(0.05, 0.2, r).astype(np.float32),
             rng.uniform(size=(r, 3)).astype(np.float32), rng.uniform(size=r) < 0.8)
    return cloud, query


def test_gathers_match_jax_and_each_other():
    """Dense and hash-grid gathers on a synthetic cloud of three objects with
    invalid points: each equals the JAX function, and the grid the dense."""
    cloud, query = _synthetic_cloud(21, 800, 128)
    pts = SSSPoints(**{k: _t(v) for k, v in cloud.items()})
    jpts = JSSSPoints(**{k: jnp.asarray(v) for k, v in cloud.items()})
    tq = tuple(_t(x) for x in query)
    dense = sss.gather_sss(pts, *tq).numpy()
    grid = sss.gather_sss_grid(pts, *tq, k_per_cell=64).numpy()
    assert dense.sum() > 0 and (dense[~query[4]] == 0).all()
    np.testing.assert_allclose(grid, dense, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(dense, np.asarray(jsss.gather_sss(jpts, *query)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        grid, np.asarray(jsss.gather_sss_grid(jpts, *query, k_per_cell=64)), rtol=1e-5, atol=1e-7)
    # the size dispatch gathers for the enabled rays only, with the same values
    tracing.reset("loop_exit")
    np.testing.assert_allclose(sss.gather_sss_auto(pts, *tq).numpy(), dense, rtol=1e-6, atol=1e-8)
    none = sss.gather_sss_auto(pts, *tq[:4], torch.zeros(128, dtype=torch.bool))
    assert tracing.totals["loop_exit"] == 2 and float(none.abs().sum()) == 0.0


def test_gather_auto_takes_the_grid_above_dense_max(monkeypatch):
    cloud, query = _synthetic_cloud(5, sss.SSS_DENSE_MAX + 500, 64)
    pts = SSSPoints(**{k: _t(v) for k, v in cloud.items()})
    tq = tuple(_t(x) for x in query)
    taken = []

    def recording(name):
        inner = getattr(sss, name)

        def call(*args, **kw):
            taken.append(name)
            return inner(*args, **kw)

        return call

    for name in ("gather_sss", "gather_sss_grid"):
        monkeypatch.setattr(sss, name, recording(name))
    out = sss.gather_sss_auto(pts, *tq)
    assert taken == ["gather_sss_grid"]
    small = dataclasses.replace(pts, **{f.name: getattr(pts, f.name)[:100]
                                        for f in dataclasses.fields(pts)})
    sss.gather_sss_auto(small, *tq)
    assert taken == ["gather_sss_grid", "gather_sss"]
    assert torch.isfinite(out).all() and float(out.sum()) > 0


def test_box_render_region_means_match_jax(box):
    """16x16, level 4, weight 0.5: the means over the sphere's pixels and over
    the rest against the JAX render, each with its own random numbers and its
    own 256-point cloud."""
    jscene, scene = box
    w = h = 16
    spp, level = 24, 4
    jsc = jsss.attach_sss(jscene, jax.random.key(2), pts_per_object=256, sample_size=8, level=3,
                          hittable_pdf_weight=0.5)
    jimg = np.asarray(jint.render_image(
        jsc, JCamera.create(**CAM, width=w, height=h), jax.random.key(3), width=w, height=h,
        sample_size=spp, level=level, hittable_pdf_weight=0.5))
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        sc = sss.attach_sss(scene, 256, sample_size=8, level=3, hittable_pdf_weight=0.5,
                            generator=gen)
        assert sc.sss.pos.shape == (256, 3) and float(sc.sss.color.mean()) > 0
        img = integrator.render_image(sc, Camera.create(**CAM, width=w, height=h), w, h,
                                      sample_size=spp, level=level, hittable_pdf_weight=0.5,
                                      generator=gen).numpy()
        no_sss = integrator.render_image(scene, Camera.create(**CAM, width=w, height=h), w, h,
                                         sample_size=4, level=level, hittable_pdf_weight=0.5,
                                         generator=gen).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.005
    # the sphere's pixels: where the primary ray meets the sphere (its silhouette)
    cam = JCamera.create(**CAM, width=w, height=h)
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                         np.arange(w, dtype=np.float32) + 0.5, indexing="ij")
    o, d = (np.asarray(x) for x in cam.generate_rays(
        jnp.asarray(ii.reshape(-1)), jnp.asarray(jj.reshape(-1)), jnp.zeros(w * h), jnp.zeros(w * h)))
    oc = o - SPHERE_C
    b = (oc * d).sum(-1)
    on_sphere = ((b * b - ((oc * oc).sum(-1) - (0.9 * SPHERE_R) ** 2)) > 0).reshape(h, w)
    assert 6 <= on_sphere.sum() <= 60
    for mask in (on_sphere, ~on_sphere):
        assert abs(img[mask].mean() - jimg[mask].mean()) <= 0.15 * jimg[mask].mean(), (
            img[mask].mean(), jimg[mask].mean())
    # the gather changes the sphere: tinted by the skin's kd, unlike the plain diffuse path
    skin = img[on_sphere].mean(axis=0)
    assert skin[0] > skin[2] and not np.allclose(img[on_sphere].mean(), no_sss[on_sphere].mean(),
                                                 rtol=0.02)


def test_renderer_runs_the_sss_stage_and_writes_the_splat(tmp_path):
    """`render_from_config` on the CPU with `sss_pts_per_object` above
    SSS_DENSE_MAX: the cloud goes through the grid gather, the `_pts.ppm`
    splat is written, the image is finite; and a scene round-trips its cloud
    through `convert`."""
    make_sss_box(tmp_path)
    cfg = config.RenderConfig(
        input_folder_path=f"{tmp_path}/", obj_filename="box.obj",
        image_output_path=str(tmp_path / "out.ppm"), image_width=12, image_height=12,
        render_mode=1, pathtracing_sample_size=2, pathtracing_level=3, dof_sample_size=1,
        hittable_pdf_weight=0.5, sss_pts_per_object=sss.SSS_DENSE_MAX + 200,
        eye_x=0.5, eye_y=0.5, eye_z=2.4, center_x=0.5, center_y=0.5, center_z=0.0, fovy=40.0)
    master = tmp_path / "master.txt"
    config.write_master_file(cfg, master)
    img = renderer.render_from_config(config.parse_master_file(master), device="cpu")
    assert img.shape == (12, 12, 3) and np.isfinite(img).all() and img.mean() > 0.005
    assert (tmp_path / "out_pts.ppm").stat().st_size > 0

    cloud, _ = _synthetic_cloud(1, 50, 1)
    scene = dataclasses.replace(torch_parity.cornell_scenes()[2],
                                sss=SSSPoints(**{k: _t(v) for k, v in cloud.items()}))
    back = convert.scene_from_numpy(convert.scene_to_numpy(scene), "cpu")
    for f in dataclasses.fields(SSSPoints):
        assert torch.equal(getattr(back.sss, f.name), getattr(scene.sss, f.name)), f.name
