"""PyTorch port vs the JAX package: the SPPM slice, module by module and as a
whole.

Inputs are made from seeds and handed to both packages; the port's uniforms
are rebuilt from the JAX key exactly as `gpu_pathtracer_tpu.render.sppm`
folds it (`torch_parity.photon_uniforms_from_key`, `eye_uniforms_from_key`),
and JAX's photon map and hit points are carried across as numpy arrays
(`models.convert`).  On the CPU the reference derives the gathers'
visibility bits from its dense closest hit and the port runs the any-hit
kernels' plain versions; the two agree except on rays that lie in a
triangle's plane (a ceiling point looking at the light in the ceiling),
where the count of visible photons may differ while the flux does not (such
a photon travels in the plane, so its cosine factor is 0).

Tolerances, each stated where it is used: integer tables exactly; float32
pure functions rtol 1e-6; walks of several bounces rtol 1e-4 on >= 97% of
the rays and rtol 1e-3 on all (XLA fuses the jitted loop bodies and may
contract a*b+c, PyTorch rounds every op); gathers rtol 1e-5; whole renders,
each package with its own random numbers, 5 sigma of the Monte-Carlo spread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.ops import bounding_sphere as jbs
from gpu_pathtracer_tpu.ops import hashgrid as jhashgrid
from gpu_pathtracer_tpu.ops import materials as jmaterials
from gpu_pathtracer_tpu.ops import sampling as jsampling
from gpu_pathtracer_tpu.render import splat as jsplat
from gpu_pathtracer_tpu.render import sppm as jsppm
from gpu_pathtracer_tpu.utils.config import RenderConfig as JRenderConfig
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import bounding_sphere, hashgrid, materials, sampling
from gpu_pathtracer_tpu_torch.render import splat, sppm
from gpu_pathtracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
T = torch.from_numpy


def _pixels(n):
    ii, jj = np.meshgrid(np.arange(n, dtype=np.float32), np.arange(n, dtype=np.float32),
                         indexing="ij")
    return ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5


def _close_share(a, b, rtol, atol=1e-6):
    """Share of rows of `a` all of whose entries are close to `b`'s."""
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


# ---------------------------------------------------------------------------
# (b) the small modules
# ---------------------------------------------------------------------------

def test_hg_and_silverman_match_jax():
    """Pure float32 functions: rtol 1e-6 (1e-5 where a pow is involved)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_allclose(sampling.silverman_biweight(T(x)).numpy(),
                               np.asarray(jsampling.silverman_biweight(jnp.asarray(x))),
                               rtol=1e-6)
    g = rng.choice(np.array([0.0, 1e-9, 0.3, -0.6, 0.9], np.float32), 500)
    u = rng.uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_allclose(
        sampling.henyey_greenstein_cos_theta(T(g), T(u)).numpy(),
        np.asarray(jsampling.henyey_greenstein_cos_theta(jnp.asarray(g), jnp.asarray(u))),
        rtol=1e-6, atol=1e-7)
    d1 = rng.normal(size=(500, 3)).astype(np.float32)
    d2 = rng.normal(size=(500, 3)).astype(np.float32)
    d2[0] = 0.0  # a degenerate direction
    np.testing.assert_allclose(
        sampling.henyey_greenstein_pdf(T(g), T(d1), T(d2)).numpy(),
        np.asarray(jsampling.henyey_greenstein_pdf(jnp.asarray(g), jnp.asarray(d1),
                                                   jnp.asarray(d2))),
        rtol=1e-5)


def test_bounding_sphere_matches_jax():
    """Predicates exactly; `sphere_union` rtol 1e-6."""
    rng = np.random.default_rng(1)
    c = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts = (c + rng.normal(size=(300, 3)) * 0.3).astype(np.float32)
    r = rng.uniform(0.1, 0.6, 300).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    j = jnp.asarray
    for name, args in (("is_inside", (c, r, pts)), ("is_inside_sq", (c, r, pts)),
                       ("is_inside_disc", (c, r, pts, nrm)),
                       ("sphere_box_intersect", (c - 0.2, c + 0.3, pts, r))):
        got = getattr(bounding_sphere, name)(*map(T, args)).numpy()
        want = np.asarray(getattr(jbs, name)(*map(j, args)))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.any() and not got.all(), name
    c2 = c.copy()
    c2[:5] = pts[:5] = c[:5]  # coincident centres: the fallback
    r2 = rng.uniform(0.1, 0.6, 300).astype(np.float32)
    cc, rr = bounding_sphere.sphere_union(T(c), T(r), T(pts), T(r2))
    jc, jr = jbs.sphere_union(j(c), j(r), j(pts), j(r2))
    np.testing.assert_allclose(cc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rr.numpy(), np.asarray(jr), rtol=1e-6)


def test_hashgrid_matches_jax_exactly():
    """Integer tables and masks: `sorted_idx` (a stable sort in both),
    `bucket_start`, candidate rows, masks and drop counts, all equal; the
    hash wraps in int32 (cells far from the origin)."""
    rng = np.random.default_rng(2)
    p = 700
    pos = rng.uniform(-3, 3, (p, 3)).astype(np.float32)
    pos[:40] = np.repeat(pos[40:50], 4, axis=0) + rng.normal(size=(40, 3)).astype(np.float32) * 1e-4  # crowded cells
    valid = rng.random(p) < 0.85
    pos[~valid] = np.inf
    cell = np.float32(0.011)  # ~550 cells a side: ix * 73856093 overflows int32
    jg = jhashgrid.build_grid(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(cell))
    g = hashgrid.build_grid(T(pos), T(valid), torch.tensor(cell))
    np.testing.assert_array_equal(g.sorted_idx.numpy(), np.asarray(jg.sorted_idx))
    np.testing.assert_array_equal(g.bucket_start.numpy(), np.asarray(jg.bucket_start))
    assert g.sorted_idx.dtype == torch.int32 and g.bucket_start.dtype == torch.int32
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
    ix = np.floor((pos[valid] - np.asarray(jg.origin)) / cell).astype(np.int64)
    assert (np.abs(ix * 73856093) > 2**31).any(), "the test does not reach the int32 wrap"

    q = np.concatenate([pos[valid][:200] + rng.normal(size=(200, 3)).astype(np.float32) * 0.004,
                        rng.uniform(-3, 3, (56, 3)).astype(np.float32)])
    for k in (2, 8):
        jidx, jok, jdrop = jhashgrid.query_candidates(jg, jnp.asarray(q), k, with_stats=True)
        idx, ok, drop = hashgrid.query_candidates(g, T(q), k, with_stats=True)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(idx.numpy()[ok.numpy()], np.asarray(jidx)[np.asarray(jok)])
        np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
        jst, jok3, jdrop2 = jhashgrid.query_cell_ranges(jg, jnp.asarray(q), k, with_stats=True)
        st, ok3, drop2 = hashgrid.query_cell_ranges(g, T(q), k, with_stats=True)
        np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(ok3.numpy(), np.asarray(jok3))
        np.testing.assert_array_equal(drop2.numpy(), np.asarray(jdrop2))
        payload = pos[np.asarray(jg.sorted_idx)]
        payload[~np.isfinite(payload)] = 0.0
        got = hashgrid.gather_cell_slices(T(payload), st, k).numpy()
        want = np.asarray(jhashgrid.gather_cell_slices(jnp.asarray(payload), jst, k))
        np.testing.assert_array_equal(got, want)
    assert ok.any() and drop.numpy().sum() == 0
    assert int(hashgrid.query_candidates(g, T(q), 2, with_stats=True)[2].sum()) > 0


def test_camera_project_and_splat_match_jax():
    """Pixel indices equal; the splat image equal (every pixel gets at most
    one of these points, so no write order is involved)."""
    cam = Camera.create(**CAM, width=24, height=16)
    jcam = JCamera.create(**CAM, width=24, height=16)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    pts[5] = np.inf
    pts[6] = (0.5, 0.5, 5.0)  # behind the eye
    d = pts - np.asarray(CAM["eye"], np.float32)
    d = np.nan_to_num(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    i, j = cam.project(T(d))
    ji, jj = jcam.project(jnp.asarray(d))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    # one point per pixel: keep the first point of every pixel
    flat = np.asarray(ji) * 24 + np.asarray(jj)
    _, first = np.unique(flat, return_index=True)
    valid = np.zeros(200, bool)
    valid[first] = True
    colors = rng.uniform(0.1, 1, (200, 3)).astype(np.float32)
    img = splat.splat_points(cam, T(pts), T(colors), 24, 16, T(valid)).numpy()
    jimg = np.asarray(jsplat.splat_points(jcam, jnp.asarray(pts), jnp.asarray(colors), 24, 16,
                                          jnp.asarray(valid)))
    np.testing.assert_array_equal(img, jimg)
    assert img.shape == (16, 24, 3) and (img.sum(-1) > 0).sum() > 50


def test_transparent_subset_matches_jax(tmp_path):
    """`build_scene` on the same host arrays: the transparent GeometrySet has
    the reference's order, triangles and boxes, and tiles of its own;
    `scene_from_numpy` / `scene_to_numpy` carry it."""
    from gpu_pathtracer_tpu.utils import obj_io, testscenes

    jscene, carried = torch_parity.sppm_scenes(True)
    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=0, fog=True)
    scene = build_scene(obj_io.load_scene(tmp_path, "box.obj"), "cpu")
    jt = jscene.transparent
    for tset in (scene.transparent, carried.transparent):
        assert tset is not None and tset.num_tris == jt.num_tris == 40
        np.testing.assert_array_equal(tset.bvh.order.numpy(), np.asarray(jt.bvh.order))
        np.testing.assert_array_equal(tset.mat_id.numpy(), np.asarray(jt.mat_id))
        np.testing.assert_array_equal(tset.valid.numpy(), np.asarray(jt.valid))
        np.testing.assert_allclose(tset.p.numpy(), np.asarray(jt.p), rtol=1e-6)
        np.testing.assert_allclose(tset.bvh.aabb_min.numpy(), np.asarray(jt.bvh.aabb_min),
                                   rtol=1e-6)
        np.testing.assert_allclose(tset.bvh.aabb_max.numpy(), np.asarray(jt.bvh.aabb_max),
                                   rtol=1e-6)
        assert tset.tiles.shape[1:] == (10, 128) and tset.tile_aabb.shape[1] == 8
    flat = convert.scene_to_numpy(carried)
    assert "transparent.p" in flat and "transparent.tiles" in flat
    again = convert.scene_from_numpy(flat, "cpu")
    assert torch.equal(again.transparent.tiles, carried.transparent.tiles)
    # a scene without transparent materials has none
    from gpu_pathtracer_tpu_torch.utils import testscenes as tts
    assert build_scene(tts.make_mesh_scene_host(subdiv=1), "cpu").transparent is None


def test_sample_bsdf_force_refract_matches_jax():
    """`force_refract` on the fog box's glass and fog interfaces, the same
    uniforms: discrete fields equal, directions and filters rtol 1e-5."""
    jscene, scene = torch_parity.sppm_scenes(True)
    rng = np.random.default_rng(4)
    r = 400
    t_r = scene.materials.t_r.numpy()
    mat = rng.choice(np.nonzero(t_r > 0)[0], r).astype(np.int32)
    nrm = rng.normal(size=(r, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    v_in = rng.normal(size=(r, 3)).astype(np.float32)
    v_in /= np.linalg.norm(v_in, axis=-1, keepdims=True)
    pt = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (r, 2)).astype(np.float32)
    key = jax.random.key(8)
    jids, jlen = jmaterials.stack_init((r,), 8)
    jref = jmaterials.sample_bsdf(jscene.materials, jnp.asarray(mat), jnp.asarray(pt),
                                  jnp.asarray(v_in), jnp.asarray(nrm), jnp.asarray(uv),
                                  jids, jlen, key, force_refract=True)
    ids, length = materials.stack_init((r,), 8)
    u = T(torch_parity.bsdf_uniforms_from_key(key, r))
    ref = materials.sample_bsdf(scene.materials, T(mat), T(pt), T(v_in), T(nrm), T(uv), ids,
                                length, u, force_refract=True)
    free = materials.sample_bsdf(scene.materials, T(mat), T(pt), T(v_in), T(nrm), T(uv), ids,
                                 length, u)
    for name in ("refracted", "reflected", "entering", "bent", "false_hit", "next_mat"):
        np.testing.assert_array_equal(getattr(ref, name).numpy(), np.asarray(getattr(jref, name)),
                                      err_msg=name)
    assert ref.refracted.all() and not free.refracted.all()
    for name in ("dir", "filter", "filter_2", "k"):
        np.testing.assert_allclose(getattr(ref, name).numpy(), np.asarray(getattr(jref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# (c) the passes, same uniforms
# ---------------------------------------------------------------------------

PHOTONS, PHOTON_BOUNCE = 512, 6


@pytest.fixture(scope="module")
def fog_photons():
    """JAX's photon map of the fog box, and the key it was made from."""
    jscene, _ = torch_parity.sppm_scenes(True)
    key = jax.random.key(4)
    return key, jsppm.photon_pass(jscene, key, n_photons=PHOTONS, max_bounce=PHOTON_BOUNCE)


def _check_photons(jp, tp):
    jv, tv = np.asarray(jp.valid), tp.valid.numpy()
    assert (jv == tv).mean() >= 0.99
    assert (np.asarray(jp.on_surface) == tp.on_surface.numpy()).mean() >= 0.99
    both = jv & tv
    assert both.sum() > 50
    # atol 5e-5: coordinates in a unit box after a march of several bounces
    for name in ("pos", "color", "direction", "prev"):
        np.testing.assert_allclose(getattr(tp, name).numpy()[both],
                                   np.asarray(getattr(jp, name))[both], rtol=1e-4, atol=5e-5,
                                   err_msg=name)


def test_photon_pass_box_matches_jax():
    """valid / on_surface equal on >= 99% of photons, deposits rtol 1e-4
    (atol 5e-5)."""
    jscene, scene = torch_parity.sppm_scenes(False)
    key = jax.random.key(3)
    jp = jsppm.photon_pass(jscene, key, n_photons=PHOTONS, max_bounce=PHOTON_BOUNCE)
    uni = torch_parity.as_tensors(
        torch_parity.photon_uniforms_from_key(key, PHOTONS, PHOTON_BOUNCE))
    before = tracing.totals["loop_exit"]
    tp = sppm.photon_pass(scene, PHOTONS, max_bounce=PHOTON_BOUNCE, uniforms=uni)
    _check_photons(jp, tp)
    assert tp.on_surface[tp.valid].all()  # a closed diffuse box has no medium
    assert 0 < tracing.totals["loop_exit"] - before <= 4 * PHOTON_BOUNCE + 33
    # the generator form draws its own numbers: same shape of result
    own = sppm.photon_pass(scene, PHOTONS, max_bounce=PHOTON_BOUNCE,
                           generator=torch.Generator().manual_seed(1))
    assert abs(int(own.valid.sum()) - int(tp.valid.sum())) < 0.25 * PHOTONS
    pos = own.pos[own.valid].numpy()
    assert (pos > -0.01).all() and (pos < 1.01).all()


def test_photon_pass_fog_matches_jax(fog_photons):
    key, jp = fog_photons
    _, scene = torch_parity.sppm_scenes(True)
    uni = torch_parity.as_tensors(
        torch_parity.photon_uniforms_from_key(key, PHOTONS, PHOTON_BOUNCE))
    tp = sppm.photon_pass(scene, PHOTONS, max_bounce=PHOTON_BOUNCE, uniforms=uni)
    _check_photons(jp, tp)
    assert (tp.valid & ~tp.on_surface).sum() > 20, "no volume photons in the fog"


def test_init_material_stack_inside_fog_matches_jax():
    """A point inside the fog sphere starts with the fog on its stack, one
    outside with the bare stack; ids and lengths equal the reference's."""
    jscene, scene = torch_parity.sppm_scenes(True)
    pts = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, 2.4], [0.45, 0.55, 0.6]], np.float32)
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    key = jax.random.key(0)
    jids, jlen = jsppm.init_material_stack(jscene, jnp.asarray(pts), jnp.asarray(dirs), key)
    ids, length = sppm.init_material_stack(
        scene, T(pts), T(dirs), uniforms=T(torch_parity.stack_uniforms_from_key(key, 3)))
    np.testing.assert_array_equal(length.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert length.tolist()[0] >= 2 and length.tolist()[1] == 1
    fog_id = int(scene.materials.scattering_coef.argmax())
    assert fog_id in ids[0].tolist()


@pytest.fixture(scope="module")
def fog_eye(fog_photons):
    """One eye pass of both packages on the fog box at 16x16 (below the
    compaction width), the same uniforms, JAX's photon map in both."""
    jscene, scene = torch_parity.sppm_scenes(True)
    _, jp = fog_photons
    n, r, bounces = 16, 256, 16
    pi, pj = _pixels(n)
    key = jax.random.key(6)
    vol_r = np.full(r, 0.1, np.float32)
    jout = jsppm.eye_pass(jscene, JCamera.create(**CAM, width=n, height=n), key, jnp.asarray(pi),
                          jnp.asarray(pj), jp, jnp.asarray(vol_r), init=False,
                          max_bounce=bounces, return_stats=True)
    photons = convert.photons_from_numpy(torch_parity.flatten(jp), "cpu")
    uni = torch_parity.as_tensors(torch_parity.eye_uniforms_from_key(key, r, bounces))
    args = (scene, Camera.create(**CAM, width=n, height=n), T(pi), T(pj), photons, T(vol_r))
    tout = sppm.eye_pass(*args, init=False, max_bounce=bounces, return_stats=True, uniforms=uni)
    tgrid = sppm.eye_pass(*args, init=False, max_bounce=bounces, return_stats=True, uniforms=uni,
                          volume_grid=True)
    return jout, tout, tgrid, photons


def test_eye_pass_matches_jax(fog_eye):
    """`found` equal on >= 99% of pixels; where both found: loc, normal,
    filter, direct and the volume gather within rtol 1e-4 on >= 97% of the
    pixels and within rtol 1e-3 on >= 99% (a shadow chain that grazes an
    emitter's edge may end differently)."""
    jout, tout, tgrid, _ = fog_eye
    jf, tf = np.asarray(jout[5]), tout[5].numpy()
    assert (jf == tf).mean() >= 0.99 and jf.mean() > 0.9
    both = jf & tf
    for i, name in enumerate(("loc", "normal", "filter", "direct", "tmp_lm")):
        a, b = np.asarray(jout[i])[both], tout[i].numpy()[both]
        assert _close_share(a, b, 1e-3, atol=1e-5) >= 0.99, name
        assert _close_share(a, b, 1e-4) >= 0.97, name
    assert np.isinf(tout[0].numpy()[~tf]).all()
    assert tout[4].sum() > 0, "no volume radiance gathered in the fog"
    assert tout[6] == {k: int(v) for k, v in jout[6].items()}
    # the grid beam gather inside the eye pass equals the dense one
    np.testing.assert_allclose(tgrid[4].numpy(), tout[4].numpy(), rtol=1e-5, atol=1e-7)
    assert tgrid[6]["beam_steps_dropped"] == 0


def test_eye_pass_compaction_statistically_equivalent():
    """Compaction changes the random numbers after a stage, not the
    estimator: found share within 0.05, mean direct radiance within 25%
    (the reference's own tolerance for its compaction)."""
    _, scene = torch_parity.sppm_scenes(False)
    n = 40  # 1,600 rays: one compaction stage of 1,024
    pi, pj = _pixels(n)
    cam = Camera.create(**CAM, width=n, height=n)
    vol_r = torch.full((n * n,), float("inf"))
    outs = {}
    for label, cmin in (("plain", 0), ("compact", 1)):
        outs[label] = sppm.eye_pass(scene, cam, T(pi), T(pj), None, vol_r, init=False,
                                    max_bounce=16, compact_min=cmin,
                                    generator=torch.Generator().manual_seed(6))
    assert sppm._compaction_widths(n * n) == [1024]
    assert sppm._compaction_widths(512 * 512) == [32768, 4096, 1024]
    (loc_a, _, _, dir_a, _, val_a), (loc_b, _, _, dir_b, _, val_b) = outs["plain"], outs["compact"]
    assert abs(float(val_a.float().mean()) - float(val_b.float().mean())) < 0.05
    ma, mb = float(dir_a[val_a].mean()), float(dir_b[val_b].mean())
    assert ma > 0 and abs(ma - mb) < 0.25 * ma
    for loc, val in ((loc_a, val_a), (loc_b, val_b)):
        pts = loc[val].numpy()
        assert (pts > -0.01).all() and (pts < 1.01).all()


# ---------------------------------------------------------------------------
# (d) JAX's photons and hit points carried across
# ---------------------------------------------------------------------------

def test_surface_gathers_match_jax(fog_photons, fog_eye):
    """Flux rtol 1e-5 (atol 1e-4 on sums of ~30), overflow equal, count equal
    on >= 97% of the pixels (rays in a triangle's plane, see the module
    docstring).  The dense gather at `k_nearest` 4 (the cap drops photons in
    both alike), the grid gather at 16 with a cell cap of 2 (likewise); the
    port's grid form also against the reference's dense one."""
    jscene, scene = torch_parity.sppm_scenes(True)
    _, jp = fog_photons
    jout, _, _, photons = fog_eye
    rad = np.full(256, 0.15, np.float32)
    jargs = (jscene, jp, jout[0], jout[1], jnp.asarray(rad), jout[5])
    targs = (scene, photons, T(np.asarray(jout[0])), T(np.asarray(jout[1])), T(rad),
             T(np.asarray(jout[5])))
    jd = jsppm.surface_gather(*jargs, k_nearest=4, return_overflow=True)
    jg = jsppm.surface_gather_grid(*jargs, k_nearest=16, k_per_cell=2, return_overflow=True)
    td = sppm.surface_gather(*targs, k_nearest=4, return_overflow=True)
    tg = sppm.surface_gather_grid(*targs, k_nearest=16, k_per_cell=2, return_overflow=True)
    tg4 = sppm.surface_gather_grid(*targs, k_nearest=4, k_per_cell=8, chunk=100,
                                   return_overflow=True)
    assert np.asarray(jd[0]).sum() > 100
    for got, want, label in ((td, jd, "dense"), (tg, jg, "grid"), (tg4, jd, "grid vs dense")):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4,
                                   err_msg=label)
        assert (got[1].numpy() == np.asarray(want[1])).mean() >= 0.97, label
        assert int(got[2]) == int(want[2]) > 0, label


def test_volume_gathers_dense_and_grid():
    """Synthetic volume photons and random segments (tests/test_sppm.py's
    set-up, from numpy): the port's dense gather against the reference's
    (rtol 1e-5), and the port's grid gather against its dense one."""
    jscene, scene = torch_parity.sppm_scenes(True)
    rng = np.random.default_rng(9)
    p, r, s = 512, 64, 4
    fog_id = int(scene.materials.scattering_coef.argmax())
    f = lambda *shape: rng.uniform(0, 1, shape).astype(np.float32)  # noqa: E731
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    pos = f(p, 3)
    ph = dict(pos=pos, color=f(p, 3), direction=unit(rng.normal(size=(p, 3))), prev=pos,
              on_surface=np.zeros(p, bool), valid=rng.random(p) < 0.8)
    seg = (f(r, s, 3), unit(rng.normal(size=(r, s, 3))),
           rng.uniform(0.1, 1.2, (r, s)).astype(np.float32), np.full((r, s), fog_id, np.int32),
           f(r, s, 3), rng.random((r, s)) < 0.7, rng.uniform(0.02, 0.08, r).astype(np.float32))
    jdense = jsppm.volume_gather_segments_dense(
        jscene.materials, jsppm.Photons(**{k: jnp.asarray(v) for k, v in ph.items()}),
        *map(jnp.asarray, seg))
    photons = convert.photons_from_numpy(ph, "cpu")
    dense = sppm.volume_gather_segments_dense(scene.materials, photons, *map(T, seg))
    grid = sppm.volume_gather_segments_grid(scene.materials, photons, *map(T, seg), chunk=100)
    assert dense.sum() > 0
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grid.numpy(), dense.numpy(), rtol=1e-5, atol=1e-7)


def test_update_matches_jax_schedule(fog_eye):
    """JAX's hit points through the port's `update`: the radius schedule and
    the flux -> radiance fold, rtol 1e-6, iterations 1 (no shrink) and 3."""
    jout, _, _, _ = fog_eye
    r = 256
    rng = np.random.default_rng(5)
    fields = dict(loc=np.asarray(jout[0]), normal=np.asarray(jout[1]), filter=np.asarray(jout[2]),
                  direct=np.asarray(jout[3]), indirect=rng.uniform(0, 1, (r, 3)).astype(np.float32),
                  tmp_lm=np.asarray(jout[4]),
                  surface_radius=rng.uniform(0.01, 0.1, r).astype(np.float32),
                  volume_radius=rng.uniform(0.02, 0.2, r).astype(np.float32),
                  valid=np.asarray(jout[5]))
    fields["surface_radius"][3] = 0.0  # flux / 0: scrubbed
    flux = rng.uniform(0, 5, (r, 3)).astype(np.float32)
    hp = convert.hit_points_from_numpy(fields, "cpu")
    n_phot, alpha = 512, 0.7
    for it in (1, 3):
        got = convert.hit_points_to_numpy(sppm.update(hp, T(flux), it, n_phot, alpha))
        ratio = np.float32((it + alpha) / (it + 1.0))
        shrink, shrink_v = (np.sqrt(ratio), np.cbrt(ratio)) if it >= 2 else (1.0, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            surf = fields["filter"] * flux / (n_phot * np.pi * fields["surface_radius"][:, None] ** 2)
        surf[~np.isfinite(surf)] = 0.0
        want = fields["indirect"] + surf + fields["tmp_lm"] / n_phot
        np.testing.assert_allclose(got["indirect"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["surface_radius"], fields["surface_radius"] * shrink,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["volume_radius"], fields["volume_radius"] * shrink_v,
                                   rtol=1e-6)
        assert not got["tmp_lm"].any() and np.array_equal(got["loc"], fields["loc"])


# ---------------------------------------------------------------------------
# (e) the slice as a whole
# ---------------------------------------------------------------------------

def _cfg(cls, **kw):
    base = dict(image_width=16, image_height=16, ppm_num_photon_per_pass=PHOTONS, ppm_num_pass=2,
                ppm_max_bounce=PHOTON_BOUNCE, ppm_alpha=0.7, ppm_radius_scaling_factor=1.0)
    return cls(**{**base, **kw})


@pytest.mark.parametrize("fog", [False, True])
def test_render_sppm_matches_jax_statistically(fog, capsys):
    """Each package renders with its own random numbers (16x16, 512 photons,
    2 passes).  The 4x4-pixel region means of the reference's render lie
    within 5 sigma of the mean of three of the port's renders, sigma being the
    spread of the port's renders (floored at 0.03) times sqrt(1 + 1/3); the
    image means within 15%."""
    jscene, scene = torch_parity.sppm_scenes(fog)
    jimg = jsppm.render_sppm(jscene, JCamera.create(**CAM, width=16, height=16),
                             _cfg(JRenderConfig), jax.random.key(5))
    cam = Camera.create(**CAM, width=16, height=16)
    log = []
    imgs = np.stack([sppm.render_sppm(scene, cam, _cfg(RenderConfig), seed, pass_log=log)
                     for seed in range(3)])
    assert imgs.shape == (3, 16, 16, 3) and np.isfinite(imgs).all() and (imgs >= 0).all()

    def regions(im):
        return im.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3, 4))

    per_run = np.stack([regions(i) for i in imgs])
    sigma = np.maximum(per_run.std(axis=0, ddof=1), 0.03) * np.sqrt(4 / 3)
    diff = np.abs(regions(jimg) - per_run.mean(axis=0))
    assert (diff <= 5 * sigma).all(), (diff / sigma).round(2)
    assert abs(imgs.mean() - jimg.mean()) < 0.15 * jimg.mean()
    assert len(log) == 6 and all(not p["grid"] and p["host_syncs"] > 0 for p in log)
    assert (sum(p["volume_photons"] for p in log) > 0) == fog
    assert all(p["tmp_lm_finite"] for p in log) and (sum(p["tmp_lm_sum"] for p in log) > 0) == fog
    assert "[capstats] render totals:" in capsys.readouterr().out


def test_render_sppm_grid_gathers_match_dense(monkeypatch):
    """The switch at pixels * photons: with the threshold lowered the render
    takes the hash-grid gathers and gives the dense render's image (same
    seed, same photons and hit points): rtol 1e-4.  On the box without fog:
    the beam gather's cell cap is never raised (in the reference neither), so
    at this size's radii the fog's grid gather drops photons the dense keeps."""
    _, scene = torch_parity.sppm_scenes(False)
    cam = Camera.create(**CAM, width=16, height=16)
    dense_log, grid_log = [], []
    dense = sppm.render_sppm(scene, cam, _cfg(RenderConfig), 3, pass_log=dense_log)
    monkeypatch.setattr(sppm, "GRID_MIN_PAIRS", 1000)
    grid = sppm.render_sppm(scene, cam, _cfg(RenderConfig), 3, pass_log=grid_log)
    assert all(p["grid"] for p in grid_log) and not any(p["grid"] for p in dense_log)
    assert all(p["dropped"] <= 0.01 * 256 * 16 for p in grid_log)
    np.testing.assert_allclose(grid, dense, rtol=1e-4, atol=1e-5)


def test_auto_caps_match_unbounded_gather(monkeypatch):
    """As tests/test_sppm.py's auto-caps test: with huge initial radii the
    default render raises its caps and equals a render whose `k_nearest` is
    the photon count from the start; with raising off it under-gathers."""
    _, scene = torch_parity.sppm_scenes(False)
    cam = Camera.create(**CAM, width=8, height=8)
    cfg = _cfg(RenderConfig, image_width=8, image_height=8, ppm_num_photon_per_pass=128,
               ppm_num_pass=1, ppm_max_bounce=4, ppm_radius_scaling_factor=30.0)
    log = []
    auto = sppm.render_sppm(scene, cam, cfg, 3, pass_log=log)
    assert log[0]["k_nearest"] > sppm.K_NEAREST
    monkeypatch.setattr(sppm, "AUTO_CAPS_MAX", sppm.K_NEAREST)  # no raise possible
    capped = sppm.render_sppm(scene, cam, cfg, 3)
    monkeypatch.setattr(sppm, "K_NEAREST", 128)
    monkeypatch.setattr(sppm, "AUTO_CAPS_MAX", 128)
    oracle = sppm.render_sppm(scene, cam, cfg, 3)
    assert np.abs(capped - oracle).max() > 1e-3, "the scene does not exercise the cap"
    np.testing.assert_allclose(auto, oracle, rtol=1e-6, atol=1e-7)


def test_checkpoint_resume_and_fingerprint_refusal(tmp_path):
    """A render stopped after 2 of 3 passes and resumed equals the
    uninterrupted one bit for bit (a generator per pass); a checkpoint of
    another seed or photon count is refused; debug images are written."""
    _, scene = torch_parity.sppm_scenes(False)
    cam = Camera.create(**CAM, width=8, height=8)
    kw = dict(image_width=8, image_height=8, ppm_num_photon_per_pass=128, ppm_max_bounce=4,
              ppm_image_output_iteration=2)
    whole = sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=3, **kw), 7,
                             output_prefix=str(tmp_path / "out"))
    for suffix in ("_hit_point", "_direct", "_indirect", "", "_surface_photon", "_volume_photon"):
        assert (tmp_path / f"out{suffix}.ppm").stat().st_size > 0
    ckpt = tmp_path / "ckpt"
    sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=2, **kw), 7,
                     checkpoint_dir=str(ckpt), checkpoint_every=1)
    assert sorted(p.name for p in ckpt.iterdir()) == ["pass_0.pt", "pass_1.pt"]
    log = []
    resumed = sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=3, **kw), 7,
                               checkpoint_dir=str(ckpt), checkpoint_every=1, pass_log=log)
    assert [p["it"] for p in log] == [2]
    np.testing.assert_array_equal(resumed, whole)
    assert sorted(p.name for p in ckpt.iterdir()) == ["pass_1.pt", "pass_2.pt"]
    with pytest.raises(ValueError, match="different run.*'seed'"):
        sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=3, **kw), 8,
                         checkpoint_dir=str(ckpt))
    with pytest.raises(ValueError, match="different run.*'n_phot'"):
        sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=3, **kw), 7,
                         checkpoint_dir=str(ckpt), n_photons_override=64)
    state = torch.load(ckpt / "pass_2.pt", weights_only=True)
    assert set(state["hit_points"]) == {f.name for f in dataclasses.fields(sppm.HitPoints)}
    del state["meta"]
    torch.save(state, ckpt / "pass_2.pt")
    with pytest.raises(ValueError, match="no run metadata"):
        sppm.render_sppm(scene, cam, _cfg(RenderConfig, ppm_num_pass=3, **kw), 7,
                         checkpoint_dir=str(ckpt))


def test_cli_renders_sppm_on_the_cpu(tmp_path):
    """`render_mode 2` through the renderer's entry point with `--device
    cpu`; without a device it requires the card."""
    from gpu_pathtracer_tpu_torch import renderer
    from gpu_pathtracer_tpu_torch.utils import config, testscenes
    from gpu_pathtracer_tpu_torch.utils.image import load_ppm

    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=0)
    cfg = config.RenderConfig(
        input_folder_path=f"{tmp_path}/", obj_filename="box.obj", image_width=8, image_height=8,
        render_mode=2, ppm_num_photon_per_pass=64, ppm_num_pass=1, ppm_max_bounce=4,
        eye_x=0.5, eye_y=0.5, eye_z=2.4, center_x=0.5, center_y=0.5, center_z=0.0, fovy=40.0)
    master = tmp_path / "master.txt"
    config.write_master_file(cfg, master)
    out = tmp_path / "sppm.ppm"
    assert renderer.main([str(master), str(out), "--device", "cpu"]) == 0
    img = load_ppm(out)
    assert img.shape == (8, 8, 3) and img.mean() > 0
    assert (tmp_path / "sppm_hit_point.ppm").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            renderer.main([str(master), str(out)])
