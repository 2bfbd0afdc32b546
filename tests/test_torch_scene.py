"""PyTorch port vs the JAX package: math leaves, intersection, Morton codes,
BVH build, device scene build and the numpy scene bridge.

Inputs are made with numpy from fixed seeds and given to both packages.
Tolerances:
* exactly equal where both sides do the same IEEE float32 operations in the
  same order with no transcendental function (cross, reflect, Morton codes,
  BVH topology and boxes, triangle SoA, tolerances) — a mismatch there is a
  porting bug, not rounding;
* rtol 1e-6 for float fields built by the same float32 expressions where
  XLA and PyTorch may fuse or reduce in a different order (sums of three
  products, norms);
* rtol 1e-5 / atol 1e-6 where sin, cos, pow, exp or log enter: XLA:CPU and
  PyTorch use different libm-grade implementations, a few ulps apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.ops import bvh as jbvh
from gpu_pathtracer_tpu.ops import intersect as jisect
from gpu_pathtracer_tpu.ops import linalg as jlinalg
from gpu_pathtracer_tpu.ops import morton as jmorton
from gpu_pathtracer_tpu.ops import sampling as jsampling
from gpu_pathtracer_tpu_torch.models.convert import scene_from_numpy, scene_to_numpy
from gpu_pathtracer_tpu_torch.ops import bvh, intersect, linalg, morton, sampling

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(port.detach().numpy() if isinstance(port, torch.Tensor) else port),
        np.asarray(ref), rtol=rtol, atol=atol,
    )


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_linalg_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _unit(rng, 64), rng.normal(size=(64, 3)).astype(np.float32)
    b[:4] = 0.0  # degenerate rows for normalize(eps)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    # same float32 ops in the same order: exact
    np.testing.assert_array_equal(linalg.cross(_t(a), _t(b)).numpy(), np.asarray(jlinalg.cross(a, b)))
    np.testing.assert_array_equal(linalg.reflect(_t(a), _t(b)).numpy(), np.asarray(jlinalg.reflect(a, b)))
    _close(linalg.normalize(_t(b), 1e-5), jlinalg.normalize(jnp.asarray(b), 1e-5))
    _close(linalg.normalize(_t(a)), jlinalg.normalize(jnp.asarray(a)))
    for p, r in zip(linalg.onb_from_z(_t(a)), jlinalg.onb_from_z(jnp.asarray(a))):
        _close(p, r, atol=1e-7)
    for p, r in zip(linalg.onb_from_z_tangent(_t(a), _t(b[4:5]).expand(64, 3)),
                    jlinalg.onb_from_z_tangent(jnp.asarray(a), jnp.broadcast_to(b[4:5], (64, 3)))):
        _close(p, r, atol=1e-7)
    x, y, z = linalg.onb_from_z(_t(a))
    jx, jy, jz = jlinalg.onb_from_z(jnp.asarray(a))
    _close(linalg.to_world(x, y, z, _t(b)), jlinalg.to_world(jx, jy, jz, jnp.asarray(b)), atol=1e-6)
    _close(linalg.rodrigues_rotate(_t(b), _t(a), _t(ang)),
           jlinalg.rodrigues_rotate(jnp.asarray(b), jnp.asarray(a), jnp.asarray(ang)),
           rtol=1e-5, atol=1e-6)
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    _close(linalg.mat3_vec(_t(m), _t(b)), jlinalg.mat3_vec(m, b), atol=1e-6)
    np.testing.assert_array_equal(linalg.max_dimension(_t(b)).numpy(), np.asarray(jlinalg.max_dimension(b)))
    base = np.abs(rng.normal(size=64)).astype(np.float32)
    base[:8] = 0.0
    ex = rng.uniform(0, 3, 64).astype(np.float32)
    ex[:2] = 0.0
    _close(linalg.safe_pow(_t(base), _t(ex)), jlinalg.safe_pow(jnp.asarray(base), jnp.asarray(ex)),
           rtol=1e-5, atol=1e-7)
    _close(linalg.safe_sqrt(_t(base - 0.5)), jlinalg.safe_sqrt(jnp.asarray(base - 0.5)))
    _close(linalg.safe_rsqrt(_t(base)), jlinalg.safe_rsqrt(jnp.asarray(base)))
    np.testing.assert_array_equal(linalg.mat3_from_rows(_t(a), _t(b), _t(a)).numpy(),
                                  np.asarray(jlinalg.mat3_from_rows(a, b, a)))
    bad = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(linalg.de_nan(_t(bad)).numpy(), np.asarray(jlinalg.de_nan(bad)))


def test_sampling_matches_jax():
    rng = np.random.default_rng(1)
    r = 256
    u1, u2 = rng.random(r, dtype=np.float32), rng.random(r, dtype=np.float32)
    n = rng.uniform(0.5, 2000.0, r).astype(np.float32)
    n[:16] = np.inf  # mirror limit
    n[16:32] = 1e6
    nrm, main, out = _unit(rng, r), _unit(rng, r), _unit(rng, r)
    ju1, ju2, jn = jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(n)
    tol = dict(rtol=1e-5, atol=1e-6)
    _close(sampling.sample_hemisphere_cos(_t(u1), _t(u2)), jsampling.sample_hemisphere_cos(ju1, ju2), **tol)
    _close(sampling.sample_hemisphere_ref(_t(u1), _t(u2)), jsampling.sample_hemisphere_ref(ju1, ju2), **tol)
    _close(sampling.sample_phong_lobe(_t(n), _t(u1), _t(u2)), jsampling.sample_phong_lobe(jn, ju1, ju2), **tol)
    _close(sampling.sample_unit_circle(_t(u1), _t(u2)), jsampling.sample_unit_circle(ju1, ju2), **tol)
    for mode in (0, 1, 2):
        m = np.full(r, mode, np.int32)
        _close(sampling.generate_direction(_t(main), _t(nrm), _t(m), _t(n), _t(u1), _t(u2)),
               jsampling.generate_direction(main, nrm, m, jn, ju1, ju2), **tol)
    refr = rng.random(r) < 0.5
    diff = rng.random(r) < 0.5
    _close(sampling.diffuse_sampling_pdf(_t(nrm), _t(out)), jsampling.diffuse_sampling_pdf(nrm, out), **tol)
    _close(sampling.specular_sampling_pdf(_t(main), _t(out), _t(nrm), _t(main), _t(n), _t(refr)),
           jsampling.specular_sampling_pdf(main, out, nrm, main, jn, refr), **tol)
    _close(sampling.sampling_pdf_2(_t(nrm), _t(out), _t(diff), _t(n), _t(main), _t(main), _t(refr)),
           jsampling.sampling_pdf_2(nrm, out, diff, jn, main, main, refr), **tol)
    _close(sampling.scattering_pdf(_t(nrm), _t(out), _t(diff), _t(main), _t(refr)),
           jsampling.scattering_pdf(nrm, out, diff, main, refr), **tol)
    ior = rng.uniform(1.0, 2.0, r).astype(np.float32)
    _close(sampling.schlick_reflectance(_t(u1), _t(ior), 1.0),
           jsampling.schlick_reflectance(ju1, jnp.asarray(ior), 1.0), **tol)
    k = rng.random((r, 3), dtype=np.float32)
    _close(sampling.phong_filter(_t(k), _t(n), _t(main), _t(out)),
           jsampling.phong_filter(k, jn, main, out), **tol)
    _close(sampling.phong_filter_2(_t(k), _t(n), _t(main), _t(out)),
           jsampling.phong_filter_2(k, jn, main, out), **tol)


def _intersect_both(o, d, tris, t_max=float("inf")):
    tol = jisect.triangle_tolerance(jnp.asarray(tris))
    # edge norms: XLA and PyTorch sum the squares in another order (1 ulp)
    np.testing.assert_allclose(intersect.triangle_tolerance(_t(tris)).numpy(), np.asarray(tol), rtol=1e-6)
    jt, jb, jh = jisect.intersect_tris(o, d, tris[None], tol[None], t_max)
    t, b, h = intersect.intersect_tris(_t(o), _t(d), _t(tris)[None], _t(np.asarray(tol))[None], t_max)
    return (t.numpy(), b.numpy(), h.numpy()), (np.asarray(jt), np.asarray(jb), np.asarray(jh))


@pytest.mark.parametrize("n_rays,n_tris", [(64, 16), (300, 48)])
def test_intersect_tris_matches_jax_random(n_rays, n_tris):
    rng = np.random.default_rng(n_rays + n_tris)
    tris = rng.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    o, d = torch_parity.random_rays(rng, n_rays, 2.0)
    (t, b, h), (jt, jb, jh) = _intersect_both(o, d, tris)
    # same float32 ops, same order: exact hit masks, t to rounding
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_allclose(t[h], jt[h], rtol=1e-6)
    np.testing.assert_allclose(b[h], jb[h], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        intersect.triangle_area(_t(tris)).numpy(), np.asarray(jisect.triangle_area(tris)), rtol=1e-6
    )


def test_intersect_edge_and_vertex_cases_match_jax():
    """tests/test_intersect.py's watertight cases: the compensated fallback
    must flag the same hits on shared edges and through a vertex."""
    edge_tris = np.array([[[0, 0, 0], [1, 0, 0], [1, 0.5, 0]],
                          [[0, 0, 0], [1, 0.5, 0], [0, 0.5, 0]]], np.float32)
    s = np.linspace(0.05, 0.95, 7, dtype=np.float32)
    o = np.stack([s, 0.5 * s, np.ones_like(s)], axis=-1)
    d = np.broadcast_to(np.array([0, 0, -1], np.float32), (7, 3)).copy()
    (t, b, h), (jt, jb, jh) = _intersect_both(o, d, edge_tris)
    np.testing.assert_array_equal(h, jh)
    assert h.any(axis=-1).all()
    np.testing.assert_allclose(b[h], jb[h], rtol=1e-6, atol=1e-7)

    apex = np.array([[[0, 0, 0], [1, 0, 0], [0.5, 1, 0]]], np.float32)
    (t, b, h), (jt, jb, jh) = _intersect_both(
        np.array([[0.5, 1.0, 1.0]], np.float32), np.array([[0, 0, -1]], np.float32), apex
    )
    np.testing.assert_array_equal(h, jh)
    assert h.any()

    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    o1, d1 = np.array([[0.2, 0.2, 1.0]], np.float32), np.array([[0, 0, -1]], np.float32)
    (t, b, h), (jt, jb, jh) = _intersect_both(o1, d1, tri)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(b[0, 0], [0.6, 0.2, 0.2], atol=1e-5)
    (t, b, h), (jt, jb, jh) = _intersect_both(o1, d1, tri, t_max=0.5)
    assert not h.any() and not jh.any()


def test_morton_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.random((512, 3), dtype=np.float32)
    p[:5] = [0.0, 1.0, 0.5]  # duplicate codes
    codes = morton.morton_3d(_t(p))
    jcodes = jmorton.morton_3d(jnp.asarray(p))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    v = rng.integers(0, 1024, 256)
    np.testing.assert_array_equal(
        morton.expand_bits(_t(v)).numpy(), np.asarray(jmorton.expand_bits(jnp.asarray(v))).astype(np.int64)
    )
    srt = np.sort(np.asarray(jcodes))
    i = np.arange(511, dtype=np.int32)
    for j in (i + 1, i - 1, i + 7, i - 300):
        np.testing.assert_array_equal(
            morton.lcp(_t(srt), _t(i), _t(j.astype(np.int32)), 512).numpy(),
            np.asarray(jmorton.lcp(jnp.asarray(srt), jnp.asarray(i), jnp.asarray(j), 512)),
        )
    c = rng.random((40, 3), dtype=np.float32) * 5
    np.testing.assert_array_equal(
        morton.normalized_centroids(_t(c)).numpy(), np.asarray(jmorton.normalized_centroids(c))
    )


@pytest.mark.parametrize("n,leaf", [(1, 4), (37, 1), (500, 4)])
def test_build_bvh_matches_jax(n, leaf):
    rng = np.random.default_rng(n)
    tris = torch_parity.random_tris(rng, n)
    tris[: n // 3] = tris[0]  # duplicate centroids -> duplicate Morton codes
    pmin, pmax = tris.min(axis=1), tris.max(axis=1)
    port = bvh.build_bvh(_t(pmin), _t(pmax), leaf_size=leaf)
    ref = jbvh.build_bvh(jnp.asarray(pmin), jnp.asarray(pmax), leaf_size=leaf)
    assert port.num_leaves == ref.num_leaves and port.leaf_size == ref.leaf_size
    for f in ("order", "escape", "left", "parent", "aabb_min", "aabb_max"):
        got = getattr(port, f)
        assert got.dtype == (torch.float32 if f.startswith("aabb") else torch.int32), f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    fails = bvh.validate(port, pmin, pmax)
    assert all(v == 0 for v in fails.values()), fails


@pytest.fixture(scope="module")
def cornell():
    return torch_parity.cornell_scenes()


def test_build_scene_matches_jax(cornell):
    host, jscene, scene = cornell
    assert scene.geom.num_tris == jscene.geom.num_tris == 972
    # the two triangles of each box quad share an AABB centre, so the
    # Morton codes have duplicates; both packages sort stably, and the
    # orders below agree exactly
    codes = np.asarray(jmorton.morton_3d(jmorton.normalized_centroids(
        0.5 * (jnp.min(host.tri_p, axis=1) + jnp.max(host.tri_p, axis=1)))))
    assert len(np.unique(codes)) < len(codes)

    ref, got = torch_parity.flatten(jscene), scene_to_numpy(scene)
    float_keys, int_keys = [], []
    for k, v in got.items():
        if k.endswith((".tiles", ".tile_aabb")) or k not in ref:
            continue  # the port's own tile packing (checked in test_torch_closest_hit)
        (float_keys if v.dtype.kind == "f" else int_keys).append(k)
        if v.dtype.kind == "f":
            assert v.dtype == np.float32, k
        elif v.dtype.kind == "i":
            assert v.dtype == np.int32 or v.ndim == 0, (k, v.dtype)
    for k in int_keys:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in float_keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    for k in ("geom.p", "geom.tol", "geom.attr", "geom.mat_id", "light_tree.anc",
              "light_tree.node_energy", "materials.kd", "materials.n_s"):
        assert k in float_keys + int_keys, k
    assert scene.transparent.num_tris == jscene.transparent.num_tris > 0
    assert "transparent.p" in float_keys and scene.light_tree.num_lights == 2


def test_scene_from_numpy_round_trip(cornell):
    _, jscene, _ = cornell
    flat = torch_parity.flatten(jscene)
    scene = scene_from_numpy(flat, "cpu")
    back = scene_to_numpy(scene)
    compared = 0
    for k, v in back.items():
        if k.endswith((".tiles", ".tile_aabb")):
            continue  # port-only packing, rebuilt from p / tol / valid of each set
        assert k in flat, k
        if v.dtype.kind == "f":
            assert v.dtype == np.float32, k
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
        compared += 1
    assert compared > 40
    # the tiles rebuilt from the flat arrays equal the directly built scene's
    _, _, direct = cornell
    np.testing.assert_array_equal(scene.geom.tiles.numpy(), direct.geom.tiles.numpy())
    np.testing.assert_array_equal(scene.geom.tile_aabb.numpy(), direct.geom.tile_aabb.numpy())
