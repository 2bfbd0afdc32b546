"""The closest-hit edge prefilter of the PyTorch port vs the JAX package.

`ops.closest_hit.pack_edge_tiles` is the port's `pack_edge_cols`, and
`closest_hit_mxu_reference` the plain version of `csrc/closest_hit_mxu.cu`
(the double-buffered closest hit with a bf16 Pluecker-edge test in front of
the exact pair test).  Both are held against the JAX package's packer and its
`_closest_kernel_big_pipe_mxu` in interpret mode (`closest_hit_pallas(...,
big=True, edge_cols=)`, as tests/test_pallas.py runs it) on inputs made with
numpy from a seed.

Tolerances: the packed weights are the same bfloat16 values after re-layout
(both round the same float32 products; XLA may contract a product and a sum,
so a weight may differ by one bfloat16 step: >= 99.9% equal, the rest within
2^-7 relative) and the margin scales agree to 2^-7 relative (the reference
stores them in bfloat16).  The plain version equals the plain version
without the prefilter bit for bit.  Against the JAX kernel: equal hit masks,
equal slots except at coplanar or shared-edge ties between triangles of
different tiles (the two tile widths visit them in another order; >= 99% of
the hits), t to rtol 1e-5 as in tests/test_torch_bigmesh.py (the same float32
Woop expressions, with XLA free to contract a*b+c: one t in 127 is off by
1.02e-6 relative here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.ops import intersect as jintersect
from gpu_pathtracer_tpu.ops import pallas_trace
from gpu_pathtracer_tpu_torch.models import convert
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import closest_hit, intersect, trace
from gpu_pathtracer_tpu_torch.render import integrator
from gpu_pathtracer_tpu_torch.utils import testscenes

torch.set_num_threads(1)
TILE = closest_hit.TILE


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def soup():
    """1,300 triangles with an invalid one; 384 rays, every 5th dead, every
    3rd with a t_max of 2."""
    rng = np.random.default_rng(3)
    tris = torch_parity.random_tris(rng, 1300)
    valid = np.ones(1300, bool)
    valid[17] = False
    o, d = torch_parity.random_rays(rng, 384)
    i = np.arange(384)
    t_max = np.where(i % 5 == 0, -1.0, np.where(i % 3 == 0, 2.0, np.inf)).astype(np.float32)
    p = _t(tris)
    tiles, aabb = closest_hit.pack_tiles(p, intersect.triangle_tolerance(p), _t(valid))
    edge_tiles, wsum = closest_hit.pack_edge_tiles(p, _t(valid))
    return dict(tris=tris, valid=valid, o=o, d=d, t_max=t_max, tiles=tiles, aabb=aabb,
                edge_tiles=edge_tiles, wsum=wsum)


def test_pack_edge_tiles_matches_pack_edge_cols(soup):
    ecols = pallas_trace.pack_edge_cols(jnp.asarray(soup["tris"]), jnp.asarray(soup["valid"]))
    n_tiles = soup["tiles"].shape[0]
    assert soup["edge_tiles"].shape == (n_tiles, 3 * TILE, closest_hit.EDGE_K)
    assert soup["edge_tiles"].dtype == torch.bfloat16 and soup["wsum"].shape == (n_tiles, 3, TILE)
    jedge, jwsum = convert.edge_cols_to_tiles(np.asarray(ecols.astype(jnp.float32)), n_tiles)
    edge = soup["edge_tiles"].float().numpy()
    assert (edge == jedge).mean() >= 0.999
    np.testing.assert_allclose(edge, jedge, rtol=2.0 ** -7, atol=1e-30)
    assert (edge[..., 6:] == 0).all()
    wsum = soup["wsum"].numpy()
    np.testing.assert_allclose(wsum, jwsum, rtol=2.0 ** -7)
    # -1 on the invalid triangle and on the padding rows, positive elsewhere
    flat = wsum.transpose(0, 2, 1).reshape(-1, 3)
    assert (flat[17] == -1).all() and (flat[1300:] == -1).all()
    assert (np.delete(flat[:1300], 17, axis=0) > 0).all()
    assert (jwsum.transpose(0, 2, 1).reshape(-1, 3)[[17, 1300, n_tiles * TILE - 1]] == -1).all()


def _prepared(soup):
    rays = closest_hit.prepare_rays(soup["aabb"], _t(soup["o"]), _t(soup["d"]), _t(soup["t_max"]))
    order = closest_hit.block_tile_order(rays, soup["aabb"], rays.shape[0] // closest_hit.RAY_BLOCK)
    return rays, order


def test_mxu_plain_equals_pipe_plain_bit_for_bit(soup):
    rays, order = _prepared(soup)
    t0, s0, _ = closest_hit.closest_hit_pipe_reference(rays, soup["tiles"], soup["aabb"], order)
    _, _, c0 = closest_hit.closest_hit_block_reference(rays, soup["tiles"], soup["aabb"], order)
    t1, s1, c1 = closest_hit.closest_hit_mxu_reference(
        rays, soup["tiles"], soup["edge_tiles"], soup["wsum"], soup["aabb"], order)
    assert torch.equal(t0, t1) and torch.equal(s0, s1)
    # the prefilter kernel keeps the 128-ray block walk
    assert c1.shape == (3, 5) and torch.equal(c0, c1[:, :3])
    passed, culled = c1[:, 3], c1[:, 4]
    assert torch.equal(passed + culled, c1[:, 2] * closest_hit.RAY_BLOCK * TILE)
    assert int(culled.sum()) > 0 and int(passed.sum()) > 0
    assert 0.2 < float((s1[:384] >= 0).float().mean()) < 0.9


def test_mxu_plain_matches_pallas_mxu_kernel(soup):
    tris, valid = jnp.asarray(soup["tris"]), jnp.asarray(soup["valid"])
    cols, jaabb = pallas_trace.pack_tri_cols(tris, jintersect.triangle_tolerance(tris), valid)
    ecols = pallas_trace.pack_edge_cols(tris, valid)
    jt, jslot, jhit = pallas_trace.closest_hit_pallas(
        cols, jaabb, soup["o"], soup["d"], soup["t_max"], interpret=True, big=True,
        edge_cols=ecols)
    t, slot, hit = closest_hit.closest_hit_tiles(
        soup["tiles"], soup["aabb"], _t(soup["o"]), _t(soup["d"]), _t(soup["t_max"]), big=True,
        edge=(soup["edge_tiles"], soup["wsum"]))
    assert closest_hit.launch_closest_hit_mxu.launches == 0  # CPU: plain version only
    jt, jslot, jhit = np.asarray(jt), np.asarray(jslot), np.asarray(jhit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    assert not jhit[::5].any() and 0.2 < jhit.mean() < 0.9
    same = (slot.numpy() == jslot) & jhit
    assert same.sum() >= 0.99 * jhit.sum()
    np.testing.assert_allclose(t.numpy()[same], jt[same], rtol=1e-5)
    assert not (slot.numpy() == 17).any()
    assert float(t[hit & (torch.arange(384) % 3 == 0)].max()) <= 2.0


def test_prefilter_never_culls_an_accepted_pair(soup):
    """Pair by pair on the first two tiles: every pair the exact test accepts
    is a candidate, dead rays and invalid columns never are, and most pairs
    are culled."""
    rays = closest_hit.prepare_rays(soup["aabb"], _t(soup["o"]), _t(soup["d"]), _t(soup["t_max"]))
    ctx = closest_hit.woop_ctx(rays)
    best_t = torch.clamp(rays[:, 6:7], max=3.4e38)
    total = culled = 0
    for ti in range(2):
        tv = [row[None, :] for row in soup["tiles"][ti]]
        t, ok = closest_hit.pair_t(ctx, tv)
        accepted = ok & (t <= rays[:, 6:7])
        cand = closest_hit.prefilter_candidates(rays, soup["edge_tiles"][ti], soup["wsum"][ti],
                                                best_t)
        assert cand.shape == accepted.shape == (rays.shape[0], TILE)
        assert not bool((accepted & ~cand).any())
        assert not bool(cand[rays[:, 6] <= 0].any())
        total += cand.numel()
        culled += int((~cand).sum())
        if ti == 0:
            assert not bool(cand[:, 17].any())  # the invalid triangle's column
        assert int(accepted.sum()) > 0
    assert culled > 0.5 * total


@pytest.fixture(scope="module")
def mesh_host():
    return testscenes.make_mesh_scene_host(subdiv=3)  # 1,284 triangles


def test_build_scene_routes_to_the_prefilter(mesh_host, monkeypatch):
    plain = build_scene(mesh_host, "cpu", edge_prefilter=True)
    assert plain.geom.edge_tiles is None  # below PALLAS_MAX: nothing packed
    monkeypatch.setattr(trace, "PALLAS_MAX", 1000)
    scene = build_scene(mesh_host, "cpu", edge_prefilter=True)
    without = build_scene(mesh_host, "cpu")
    g = scene.geom
    assert without.geom.edge_tiles is None and trace.edge_operand(without.geom) is None
    assert g.edge_tiles.shape == (g.tiles.shape[0], 3 * TILE, closest_hit.EDGE_K)
    assert trace.pallas_big(g) and trace.edge_operand(g) is not None

    calls = []
    pipe_walk, group_walk = closest_hit._pipe_walk, closest_hit._group_walk

    def recording(rays, tiles, aabb, order, edge):
        calls.append(edge is not None)
        return pipe_walk(rays, tiles, aabb, order, edge)

    def recording_group(rays, tiles, aabb, order, ring):
        calls.append(False)  # the group walk of closest_hit_pipe.cu: no prefilter
        return group_walk(rays, tiles, aabb, order, ring)

    monkeypatch.setattr(closest_hit, "_pipe_walk", recording)
    monkeypatch.setattr(closest_hit, "_group_walk", recording_group)
    rng = np.random.default_rng(5)
    o = np.tile(np.array([[0.5, 0.8, 2.2]], np.float32), (300, 1))
    d = rng.uniform([0.0, 0.0, 0.0], [1.0, 1.2, 1.0], (300, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    uni = torch.rand((3, integrator.N_UNIFORMS, 300), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = integrator.trace_paths(scene, _t(o), _t(d), level=3, hittable_pdf_weight=0.5,
                                   uniforms=uni)
        n_with = len(calls)
        b = integrator.trace_paths(without, _t(o), _t(d), level=3, hittable_pdf_weight=0.5,
                                   uniforms=uni)
    assert n_with == 3 and all(calls[:3]) and not any(calls[3:]) and len(calls) == 6
    assert torch.equal(a, b) and float(a.mean()) > 0


def test_convert_round_trips_the_edge_tiles(mesh_host, monkeypatch):
    monkeypatch.setattr(trace, "PALLAS_MAX", 1000)
    scene = build_scene(mesh_host, "cpu", edge_prefilter=True)
    flat = convert.scene_to_numpy(scene)
    assert flat["geom.edge_tiles"].dtype == np.float32
    back = convert.scene_from_numpy(flat, "cpu")
    assert back.geom.edge_tiles.dtype == torch.bfloat16
    assert torch.equal(back.geom.edge_tiles, scene.geom.edge_tiles)
    assert torch.equal(back.geom.edge_wsum, scene.geom.edge_wsum)
    # from the reference's own layout
    g = scene.geom
    ecols = pallas_trace.pack_edge_cols(jnp.asarray(g.p.numpy()), jnp.asarray(g.valid.numpy()))
    flat = {k: v for k, v in flat.items() if not k.startswith("geom.edge_")}
    flat["geom.edge_cols"] = np.asarray(ecols.astype(jnp.float32))
    from_ref = convert.scene_from_numpy(flat, "cpu")
    same = from_ref.geom.edge_tiles.float() == g.edge_tiles.float()
    assert float(same.float().mean()) >= 0.999
    assert bool(((from_ref.geom.edge_wsum < 0) == (g.edge_wsum < 0)).all())
    flat.pop("geom.edge_cols")
    assert convert.scene_from_numpy(flat, "cpu").geom.edge_tiles is None


@pytest.mark.parametrize("what", ["cpu_tensors", "edge_without_big"])
def test_prefilter_entry_points_refuse(soup, what):
    rays, order = _prepared(soup)
    if what == "cpu_tensors":
        with pytest.raises(ValueError, match="CUDA"):
            closest_hit.launch_closest_hit_mxu(rays, soup["tiles"], soup["edge_tiles"],
                                               soup["wsum"], soup["aabb"], order)
    else:
        with pytest.raises(ValueError, match="big"):
            closest_hit.closest_hit_tiles(soup["tiles"], soup["aabb"], _t(soup["o"]),
                                          _t(soup["d"]), edge=(soup["edge_tiles"], soup["wsum"]))
