"""PyTorch port vs the JAX package: camera rays, BSDF sampling with the
nested-dielectric stack, the light tree's dense pdfs and pick, and NEE/MIS.

Both packages get the same uniforms: the JAX side draws them from the keys
it folds (materials.sample_bsdf: fold_in(key, 0..3); integrator._nee_mis:
fold_in(key, 0..3), the pick drawn as (R, 1) as lights.pick_light_dense
draws it), and the port is handed those numbers.  Tolerances: rtol 1e-5 /
atol 1e-6 for float outputs (sin, cos, pow, exp and log differ by a few ulps
between XLA:CPU and PyTorch; the Phong lobes raise them to large powers, so
a relative bound is the right one); boolean decisions exactly, except where
a uniform lands within rounding of a threshold, which these seeds avoid
(checked: any split would show as a mismatch in `dir`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.ops import lights as jlights
from gpu_pathtracer_tpu.ops import materials as jmat
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.ops import lights, materials

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _uniforms(key, r, pick_shape=None):
    """The four uniforms a JAX stage folds from `key`, as numpy (4, R)."""
    out = []
    for j in range(4):
        shape = pick_shape if (j == 1 and pick_shape) else (r,)
        out.append(np.asarray(jax.random.uniform(jax.random.fold_in(key, j), shape)).reshape(r))
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def cornell():
    return torch_parity.cornell_scenes()


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_camera_rays_match_jax(aperture):
    rng = np.random.default_rng(4)
    kw = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0,
              width=48, height=32, aperture=aperture, focus_dist=2.1)
    i = rng.uniform(0, 32, 500).astype(np.float32)
    j = rng.uniform(0, 48, 500).astype(np.float32)
    u1, u2 = rng.random(500, dtype=np.float32), rng.random(500, dtype=np.float32)
    jo, jd = JCamera.create(**kw).generate_rays(i, j, u1, u2)
    o, d = Camera.create(**kw).generate_rays(_t(i), _t(j), _t(u1), _t(u2))
    np.testing.assert_allclose(_np(o), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_np(d), np.asarray(jd), **TOL)


def _surface_points(jscene, rng, r):
    """Random points on random scene triangles, with interpolated normals."""
    p = np.asarray(jscene.geom.p)
    n = np.asarray(jscene.geom.n)
    valid = np.nonzero(np.asarray(jscene.geom.valid))[0]
    tri = rng.choice(valid, r)
    b = rng.dirichlet(np.ones(3), r).astype(np.float32)
    point = np.einsum("rk,rkc->rc", b, p[tri]).astype(np.float32)
    nrm = np.einsum("rk,rkc->rc", b, n[tri])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    return tri, point, nrm


def _bsdf_inputs(jscene, seed, r=512):
    rng = np.random.default_rng(seed)
    names = jscene.materials  # ids: 0 white, 1 red, 2 green, 3 light, 4 metal, 5 glass
    n_mat = np.asarray(names.kd).shape[0]
    mat_id = rng.integers(0, n_mat, r).astype(np.int32)
    mat_id[: r // 4] = n_mat - 1  # plenty of glass hits
    _, point, normal = _surface_points(jscene, rng, r)
    v_in = _unit(rng, r)
    uv = rng.random((r, 2), dtype=np.float32)
    ids, length = jmat.stack_init((r,), 8)
    ids, length = np.array(ids), np.array(length)
    inside = rng.random(r) < 0.4  # rays travelling inside the glass
    ids[inside, 1] = n_mat - 1
    length[inside] = 2
    return mat_id, point, v_in, normal, uv, ids, length


def test_sample_bsdf_matches_jax(cornell):
    _, jscene, scene = cornell
    mat_id, point, v_in, normal, uv, ids, length = _bsdf_inputs(jscene, 5)
    key = jax.random.key(17)
    jref = jmat.sample_bsdf(jscene.materials, mat_id, point, v_in, normal, uv, ids, length, key)
    ref = materials.sample_bsdf(scene.materials, _t(mat_id), _t(point), _t(v_in), _t(normal),
                                _t(uv), _t(ids), _t(length), _t(_uniforms(key, len(mat_id))))
    refracted_glass = _np(ref.refracted) & (mat_id == mat_id.max())
    assert refracted_glass.sum() > 20 and _np(ref.entering)[refracted_glass].any()
    assert (~_np(ref.entering)[refracted_glass]).any()  # exits through a non-empty stack
    for f in ("diffuse", "reflected", "refracted", "false_hit", "entering", "bent", "sss",
              "next_mat"):
        np.testing.assert_array_equal(_np(getattr(ref, f)), np.asarray(getattr(jref, f)), err_msg=f)
    for f in ("origin", "dir", "k", "filter", "filter_2", "perfect_dir", "pdf", "n"):
        np.testing.assert_allclose(_np(getattr(ref, f)), np.asarray(getattr(jref, f)),
                                   err_msg=f, **TOL)


def test_stack_rearrange_and_priorities_match_jax(cornell):
    _, jscene, scene = cornell
    rng = np.random.default_rng(6)
    r, size = 400, 4
    ids = np.full((r, size), -2, np.int32)
    length = rng.integers(1, size + 1, r).astype(np.int32)
    for k in range(r):
        ids[k, : length[k]] = rng.integers(-1, 6, length[k])
    mat = rng.integers(0, 6, r).astype(np.int32)
    flags = [rng.random(r) < 0.5 for _ in range(4)]
    jids, jlen = jmat.stack_rearrange(ids, length, mat, *flags)
    pids, plen = materials.stack_rearrange(_t(ids), _t(length), _t(mat), *map(_t, flags))
    np.testing.assert_array_equal(_np(pids), np.asarray(jids))
    np.testing.assert_array_equal(_np(plen), np.asarray(jlen))
    jh = jmat.find_highest_prioritised(jscene.materials, ids, length)
    ph = materials.find_highest_prioritised(scene.materials, _t(ids), _t(length))
    for a, b in zip(ph, jh):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.fixture(scope="module")
def many_lights():
    """37 random emitters: a light tree with real depth (Cornell has 2)."""
    rng = np.random.default_rng(9)
    e = 37
    tri = torch_parity.random_tris(rng, e, lo=-1.0, hi=1.0)
    nrm = np.repeat(_unit(rng, e)[:, None], 3, axis=1)
    uv = np.zeros((e, 3, 2), np.float32)
    energy = rng.uniform(0.5, 5.0, (e, 3)).astype(np.float32)
    slot = np.arange(e, dtype=np.int32)
    jlt = jlights.build_light_tree(*(jnp.asarray(a) for a in (tri, nrm, uv, energy, slot)))
    lt = lights.build_light_tree(*(_t(a) for a in (tri, nrm, uv, energy, slot)))
    return jlt, lt


def test_light_tree_and_dense_pdfs_match_jax(many_lights):
    jlt, lt = many_lights
    ref, got = torch_parity.flatten(jlt), {}
    from gpu_pathtracer_tpu_torch.models.convert import scene_to_numpy

    got = scene_to_numpy(lt)
    for k, v in got.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    rng = np.random.default_rng(10)
    r = 300
    point = rng.uniform(-2, 2, (r, 3)).astype(np.float32)
    pivot = _unit(rng, r)
    jpdf = jlights.leaf_node_pdfs(jlt, point, pivot)
    pdf = lights.leaf_node_pdfs(lt, _t(point), _t(pivot))
    np.testing.assert_allclose(_np(pdf), np.asarray(jpdf), **TOL)
    np.testing.assert_allclose(_np(pdf).sum(-1), 1.0, rtol=1e-4)

    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, (r, 1)))
    jleaf = jlights.pick_light_dense(jlt, jpdf, key)
    leaf = lights.pick_light_dense(lt, pdf, _t(u[:, 0]))
    assert (_np(leaf) == np.asarray(jleaf)).mean() >= 0.99  # cdf ties at a few ulps

    # directions at points on the emitters, so the mixture pdf sums real hits
    target = lights.sample_point_on_light(lt, leaf, _t(u[:, 0]), _t(1.0 - u[:, 0]))
    jtarget = jlights.sample_point_on_light(jlt, jleaf, u[:, 0], 1.0 - u[:, 0])
    np.testing.assert_allclose(_np(target)[_np(leaf) == np.asarray(jleaf)],
                               np.asarray(jtarget)[_np(leaf) == np.asarray(jleaf)], **TOL)
    d = _np(target) - point
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jh = jlights.hittable_pdf_sum(jlt, point, d, pivot, node_pdf=jpdf)
    h = lights.hittable_pdf_sum(lt, _t(point), _t(d), _t(pivot), node_pdf=pdf)
    assert (_np(h) > 0).mean() > 0.9
    np.testing.assert_allclose(_np(h), np.asarray(jh), rtol=1e-4, atol=1e-6)


def test_nee_mis_matches_jax(cornell):
    """nee_mis on Cornell hit points with the same BSDF and NEE uniforms."""
    _, jscene, scene = cornell
    mat_id, point, v_in, normal, uv, ids, length = _bsdf_inputs(jscene, 8)
    bkey, nkey = jax.random.key(21), jax.random.key(23)
    jref = jmat.sample_bsdf(jscene.materials, mat_id, point, v_in, normal, uv, ids, length, bkey)
    ref = materials.sample_bsdf(scene.materials, _t(mat_id), _t(point), _t(v_in), _t(normal),
                                _t(uv), _t(ids), _t(length), _t(_uniforms(bkey, len(mat_id))))
    jout = jint._nee_mis(jscene, jref, normal, v_in, 0.5, nkey)
    out = lights.nee_mis(scene.light_tree, ref, _t(normal), _t(v_in), 0.5,
                         _t(_uniforms(nkey, len(mat_id), pick_shape=(len(mat_id), 1))))
    for a, b, name in zip(out, jout[:3], ("new_dir", "new_filter", "factor")):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, rtol=1e-4, atol=1e-6)
    assert (_np(out[2]) > 0).mean() > 0.3
