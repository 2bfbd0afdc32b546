"""The sparse (many-lights) regime of the PyTorch port's light tree vs the JAX
package: the cases of tests/test_lights.py, each also held against the JAX
function on the same arrays and the same uniforms.

The port's trees are made from the JAX trees' own arrays
(`models.convert`), so both walk the same nodes.  Tolerances: pdf sums and
the pdfs of shallow trees to rtol 1e-5 against JAX (the same float32
expressions; XLA may contract a product and a sum); a selection pdf is a
product of up to `depth` branch ratios, each a few float32 steps apart, so
the walk pdfs are held to 1e-4 (2 of 2,112 differ by 2.9e-5 at 33 emitters);
2e-4 between the walk and the matmul form as in tests/test_lights.py;
collected leaves, validity masks, drop counts and picked leaves are integers
and must be equal.  The 16x16 panel render is compared in 4x4 region means
and in the image mean within 15%, each package with its own random numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.models.scene import build_scene as jbuild_scene
from gpu_pathtracer_tpu.ops import lights as jlights
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu.utils import obj_io, testscenes
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.constants import LIGHT_TREE_DENSE_MAX
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.ops import intersect, lights
from gpu_pathtracer_tpu_torch.render import integrator

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_tree(jlt) -> lights.LightTree:
    return convert._light_tree(torch_parity.flatten(jlt, "light_tree."), "cpu")


def _random_trees(seed: int, e: int, random_normals: bool = False):
    """(JAX tree, port tree from the same arrays) over e random emitters."""
    rng = np.random.default_rng(seed)
    tri_p = rng.uniform(-2.0, 2.0, (e, 3, 3)).astype(np.float32)
    tri_n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (e, 3, 1))
    energy = rng.uniform(0.1, 5.0, (e, 3)).astype(np.float32)
    jlt = jlights.build_light_tree(jnp.asarray(tri_p), jnp.asarray(tri_n), jnp.zeros((e, 3, 2)),
                                   jnp.asarray(energy), jnp.arange(e, dtype=jnp.int32))
    if random_normals:
        n = rng.normal(size=(e, 3)).astype(np.float32)
        jlt = dataclasses.replace(
            jlt, avg_normal=jnp.asarray(n / np.linalg.norm(n, axis=-1, keepdims=True)))
    return jlt, _port_tree(jlt)


def _points(seed: int, r: int):
    rng = np.random.default_rng(seed)
    point = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    _, pivot = torch_parity.random_rays(rng, r)
    _, direction = torch_parity.random_rays(rng, r)
    return point, pivot, direction


@pytest.mark.parametrize("e", [1, 2, 7, 33])
def test_walk_pdf_matches_jax_and_dense(e):
    jlt, lt = _random_trees(e, e)
    point, pivot, _ = _points(100 + e, 64)
    walk = lights.leaf_node_pdfs_walk(lt, _t(point), _t(pivot)).numpy()
    jwalk = np.asarray(jlights.leaf_node_pdfs_walk(jlt, point, pivot))
    np.testing.assert_allclose(walk, jwalk, rtol=1e-4, atol=1e-9)
    dense = lights.leaf_node_pdfs(lt, _t(point), _t(pivot)).numpy()
    np.testing.assert_allclose(dense, walk, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(walk.sum(-1), 1.0, rtol=1e-4)


@pytest.mark.parametrize("e", [2, 33])
def test_node_pdf_walk_subset_matches_jax_and_dense(e):
    jlt, lt = _random_trees(100 + e, e)
    point, pivot, _ = _points(200 + e, 32)
    leaf = np.random.default_rng(e).integers(0, e, (32, min(5, e))).astype(np.int32)
    got = lights.node_pdf_walk(lt, _t(leaf), _t(point), _t(pivot)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlights.node_pdf_walk(jlt, leaf, point, pivot)),
                               rtol=1e-4, atol=1e-9)
    dense = lights.leaf_node_pdfs(lt, _t(point), _t(pivot)).numpy()
    np.testing.assert_allclose(got, np.take_along_axis(dense, leaf, axis=-1), rtol=2e-4,
                               atol=1e-7)


def test_collect_hit_leaves_equals_jax_and_is_a_superset():
    e, r = 64, 128
    jlt, lt = _random_trees(7, e)
    origin, _, direction = _points(8, r)
    tracing.reset("loop_exit")
    cand, ok, dropped = lights.collect_hit_leaves(lt, _t(origin), _t(direction), max_k=64)
    assert 0 < tracing.totals["loop_exit"] <= 4 * e // lights.COLLECT_SYNC_STEPS + 1
    jcand, jok, jdropped = jlights.collect_hit_leaves(jlt, origin, direction, max_k=64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(np.where(ok.numpy(), cand.numpy(), -1),
                                  np.where(np.asarray(jok), np.asarray(jcand), -1))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    assert (dropped.numpy() == 0).all() and ok.any()
    _, _, hit = intersect.intersect_tris(_t(origin), _t(direction), lt.tri_p[None], lt.tol[None],
                                         float("inf"))
    for i in range(r):
        hit_set = set(np.nonzero(hit[i].numpy())[0].tolist())
        assert hit_set <= set(cand[i][ok[i]].tolist()), i
    # a small cap drops the rest, and says how many
    cand8, ok8, drop8 = lights.collect_hit_leaves(lt, _t(origin), _t(direction), max_k=2)
    jcand8, jok8, jdrop8 = jlights.collect_hit_leaves(jlt, origin, direction, max_k=2)
    np.testing.assert_array_equal(drop8.numpy(), np.asarray(jdrop8))
    np.testing.assert_array_equal(ok8.sum(-1).numpy() + drop8.numpy(), ok.sum(-1).numpy())
    assert int(drop8.sum()) > 0


def test_hittable_pdf_sum_sparse_matches_jax_and_dense():
    e, r = 48, 256
    jlt, lt = _random_trees(11, e)
    origin, pivot, direction = _points(12, r)
    args = (_t(origin), _t(direction), _t(pivot))
    sparse, dropped = lights.hittable_pdf_sum_sparse(lt, *args, max_k=64, with_stats=True)
    jsparse = jlights.hittable_pdf_sum_sparse(jlt, origin, direction, pivot, max_k=64)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), rtol=1e-5, atol=1e-9)
    dense = lights.hittable_pdf_sum(lt, *args)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=2e-4, atol=1e-6)
    assert int(dropped.sum()) == 0 and float(sparse.sum()) > 0


def test_mis_cap_overflow_counted_and_parity_at_capacity():
    """96 parallel emitter triangles stacked along +x, all stabbed and hit by
    one axial ray: the drop count is exactly the overflow, the capped sum is
    biased low and never high, and at a cap of 128 the sparse sum equals the
    dense one."""
    e = 96
    xs = np.linspace(0.5, 5.0, e, dtype=np.float32)
    tri = np.zeros((e, 3, 3), np.float32)
    tri[:, :, 0] = xs[:, None]
    tri[:, 0, 1:] = (-0.1, -0.1)
    tri[:, 1, 1:] = (0.2, -0.1)
    tri[:, 2, 1:] = (-0.1, 0.2)
    tri_n = np.tile(np.array([-1.0, 0.0, 0.0], np.float32), (e, 3, 1))
    jlt = jlights.build_light_tree(jnp.asarray(tri), jnp.asarray(tri_n), jnp.zeros((e, 3, 2)),
                                   jnp.ones((e, 3)), jnp.arange(e, dtype=jnp.int32))
    lt = _port_tree(jlt)
    origin = np.zeros((4, 3), np.float32)
    direction = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    args = (_t(origin), _t(direction), _t(direction))
    dense = lights.hittable_pdf_sum(lt, *args).numpy()
    full, drop_full = lights.hittable_pdf_sum_sparse(lt, *args, max_k=128, with_stats=True)
    assert (drop_full.numpy() == 0).all()
    np.testing.assert_allclose(full.numpy(), dense, rtol=2e-4)
    capped, dropped = lights.hittable_pdf_sum_sparse(lt, *args, with_stats=True)  # the cap of 32
    jcapped, jdropped = jlights.hittable_pdf_sum_sparse(jlt, origin, direction, direction,
                                                        max_k=32, with_stats=True)
    np.testing.assert_array_equal(dropped.numpy(), e - 32)
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    np.testing.assert_allclose(capped.numpy(), np.asarray(jcapped), rtol=1e-5)
    assert (capped.numpy() <= dense * (1 + 1e-4)).all() and (capped.numpy() < 0.9 * dense).all()


def test_overflow_count_at_a_leaf_plane_turns_on_the_origins_last_ulp():
    """A ray that starts on a flat emitter's plane (a hit on that emitter)
    does not stab the emitter's leaf box; one float32 ulp before the plane it
    does, so its drop count is one higher.  JAX counts alike.  A hit point
    rounded differently (the card's and the CPU's sums part by an ulp) thus
    moves the overflow count of such rays (`chip_smoke.py` phase 21.3)."""
    e, k = 96, 10
    xs = np.linspace(0.5, 5.0, e, dtype=np.float32)
    tri = np.zeros((e, 3, 3), np.float32)
    tri[:, :, 0] = xs[:, None]
    tri[:, 0, 1:] = (-0.1, -0.1)
    tri[:, 1, 1:] = (0.2, -0.1)
    tri[:, 2, 1:] = (-0.1, 0.2)
    tri_n = np.tile(np.array([-1.0, 0.0, 0.0], np.float32), (e, 3, 1))
    jlt = jlights.build_light_tree(jnp.asarray(tri), jnp.asarray(tri_n), jnp.zeros((e, 3, 2)),
                                   jnp.ones((e, 3)), jnp.arange(e, dtype=jnp.int32))
    lt = _port_tree(jlt)
    x = np.array([xs[k], np.nextafter(xs[k], np.float32(-np.inf))], np.float32)
    origin = np.stack([x, np.zeros(2, np.float32), np.zeros(2, np.float32)], -1)
    direction = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (2, 1))
    _, _, dropped = lights.collect_hit_leaves(lt, _t(origin), _t(direction))
    _, _, jdropped = jlights.collect_hit_leaves(jlt, origin, direction, max_k=32)
    np.testing.assert_array_equal(dropped.numpy(), [e - k - 1 - 32, e - k - 32])
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))


def _descent_uniforms(key, steps: int, r: int) -> np.ndarray:
    """(steps, R): `pick_light` folds its key by the step."""
    return np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, s), (r,)))
                     for s in range(max(steps, 1))])


def test_pick_light_descent_equals_jax_and_its_histogram_the_walk_pdf():
    e, r = 8, 20000
    jlt, lt = _random_trees(3, e)
    point = np.tile(np.array([[0.0, 3.0, 0.0]], np.float32), (r, 1))
    pivot = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (r, 1))
    key = jax.random.key(4)
    u = _descent_uniforms(key, lights.descent_steps(lt), r)
    leaf = lights.pick_light(lt, _t(point), _t(pivot), uniforms=_t(u)).numpy()
    jleaf = np.asarray(jlights.pick_light(jlt, point, pivot, key))
    assert leaf.dtype == np.int32 and (leaf == jleaf).mean() >= 0.9995  # a u at a branch's edge
    want = lights.node_pdf_walk(lt, torch.arange(e, dtype=torch.int32)[None, :],
                                _t(point[:1]), _t(pivot[:1])).numpy()[0]
    np.testing.assert_allclose(np.bincount(leaf, minlength=e) / r, want, atol=0.02)
    # from a generator: the same distribution; too few rows of uniforms are refused
    leaf_g = lights.pick_light(lt, _t(point), _t(pivot),
                               generator=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_allclose(np.bincount(leaf_g, minlength=e) / r, want, atol=0.02)
    with pytest.raises(ValueError, match="rows"):
        lights.pick_light(lt, _t(point), _t(pivot), uniforms=_t(u[:1]))


@pytest.mark.parametrize("e", [9, 33])
def test_bounding_cones_match_jax_and_contain_leaf_normals(e):
    jlt, lt = _random_trees(200 + e, e, random_normals=True)
    axis, t0, te = (x.numpy() for x in lights.build_node_cones(lt))
    jaxis, jt0, jte = (np.asarray(x) for x in jlights.build_node_cones(jlt))
    np.testing.assert_allclose(t0, jt0, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(axis, jaxis, atol=5e-4)
    np.testing.assert_allclose(te, np.pi / 2.0, atol=1e-6)
    np.testing.assert_allclose(te, jte, atol=1e-6)
    parent = lt.tree.parent.numpy()
    normals = lt.avg_normal.numpy()
    for k in range(e):
        node = e - 1 + k
        while node >= 0:
            ang = np.arccos(np.clip(np.dot(axis[node], normals[k]), -1, 1))
            assert ang <= t0[node] + 2e-3, (k, node, ang, t0[node])
            node = parent[node]


def test_sparse_tree_is_built_without_dense_tables_like_jax():
    e = LIGHT_TREE_DENSE_MAX + 8
    rng = np.random.default_rng(1)
    tri_p = rng.uniform(-2.0, 2.0, (e, 3, 3)).astype(np.float32)
    tri_n = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (e, 3, 1))
    energy = rng.uniform(0.1, 5.0, (e, 3)).astype(np.float32)
    lt = lights.build_light_tree(_t(tri_p), _t(tri_n), torch.zeros((e, 3, 2)), _t(energy),
                                 torch.arange(e, dtype=torch.int32))
    jlt = jlights.build_light_tree(jnp.asarray(tri_p), jnp.asarray(tri_n), jnp.zeros((e, 3, 2)),
                                   jnp.asarray(energy), jnp.arange(e, dtype=jnp.int32))
    assert not lt.dense and not jlt.dense and lt.anc.shape == (1, 1) and lt.num_lights == e
    assert lt.depth == jlt.depth
    for name in ("node_energy", "tri_p", "geom_slot", "sib", "centroid"):
        np.testing.assert_allclose(getattr(lt, name).numpy(), np.asarray(getattr(jlt, name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(lt.tree.parent.numpy(), np.asarray(jlt.tree.parent))
    forced = lights.build_light_tree(_t(tri_p[:40]), _t(tri_n[:40]), torch.zeros((40, 3, 2)),
                                     _t(energy[:40]), torch.arange(40, dtype=torch.int32),
                                     dense_tables=False)
    assert not forced.dense and forced.anc.shape == (1, 1)
    assert not _port_tree(jlt).dense


@pytest.fixture(scope="module")
def panel():
    """The 2,048-emitter panel of tests/test_lights.py: (JAX scene, port scene
    from the JAX scene's arrays)."""
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        testscenes.make_emitter_panel(pathlib.Path(tmp), nx=32, ny=32)
        jscene = jbuild_scene(obj_io.load_scene(tmp, "panel.obj"))
    return jscene, convert.scene_from_numpy(torch_parity.flatten(jscene), "cpu")


def _pick_uniforms_from_key(key, level: int, steps: int, r: int) -> np.ndarray:
    """(level, steps, R): per bounce i the descent's key is
    fold_in(fold_in(fold_in(key, i), 23), 1), folded by the step."""
    return np.stack([
        _descent_uniforms(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, i), 23), 1),
                          steps, r)
        for i in range(level)])


def test_trace_paths_sparse_regime_same_uniforms_as_jax(panel):
    """The same camera rays and the same uniforms through both packages'
    `trace_paths` in the sparse regime: >= 97% of the rays agree to 1e-3 (a
    ray splits where a float32 difference flips a branch), the image means
    within 2%, and the drop totals within 2%."""
    jscene, scene = panel
    assert scene.num_lights == 2048 and not scene.light_tree.dense
    w = h = 12
    r, level = w * h, 3
    jcam = JCamera.create(**CAM, width=w, height=h)
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                         np.arange(w, dtype=np.float32) + 0.5, indexing="ij")
    o, d = jcam.generate_rays(jnp.asarray(ii.reshape(-1)), jnp.asarray(jj.reshape(-1)),
                              jnp.zeros((r,)), jnp.zeros((r,)))
    key = jax.random.key(5)
    jcol, jstats = jint.trace_paths(jscene, o, d, key, level=level, hittable_pdf_weight=0.5,
                                    return_stats=True)
    uni = torch_parity.uniforms_from_key(key, level, r)
    pick = _pick_uniforms_from_key(key, level, lights.descent_steps(scene.light_tree), r)
    with torch.no_grad():
        col, stats = integrator.trace_paths(
            scene, _t(np.asarray(o)), _t(np.asarray(d)), level=level, hittable_pdf_weight=0.5,
            uniforms=_t(uni), pick_uniforms=_t(pick), return_stats=True)
    col, jcol = col.numpy(), np.asarray(jcol)
    close = np.isclose(col, jcol, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.97, close.mean()
    assert abs(col.mean() - jcol.mean()) <= 0.02 * jcol.mean()
    dropped, jdropped = int(stats["mis_targets_dropped"]), int(jstats["mis_targets_dropped"])
    assert abs(dropped - jdropped) <= max(2, 0.02 * jdropped), (dropped, jdropped)


def test_panel_render_region_means_match_jax(panel):
    """16x16, level 3, weight 0.5, each package with its own random numbers;
    the port renders through the sparse regime with a generator."""
    jscene, scene = panel
    w = h = 16
    spp, level = 16, 3
    jimg = np.asarray(jint.render_image(
        jscene, JCamera.create(**CAM, width=w, height=h), jax.random.key(0), width=w, height=h,
        sample_size=spp, level=level, hittable_pdf_weight=0.5))
    tracing.reset("loop_exit")
    with torch.no_grad():
        img = integrator.render_image(
            scene, Camera.create(**CAM, width=w, height=h), w, h, sample_size=spp, level=level,
            hittable_pdf_weight=0.5, generator=torch.Generator().manual_seed(3)).numpy()
    assert tracing.totals["loop_exit"] >= spp * level
    assert np.isfinite(img).all() and (img >= 0).all()
    port = img.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3, 4))
    jref = jimg.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3, 4))
    np.testing.assert_allclose(port, jref, rtol=0.15, atol=0.15 * jref.mean())
    assert abs(img.mean() - jimg.mean()) <= 0.15 * jimg.mean(), (img.mean(), jimg.mean())
