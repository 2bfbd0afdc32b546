"""The large-mesh path of the PyTorch port vs the JAX package: the
double-buffered closest-hit query (`big=True`) and the mesh render.

On the CPU the port's `big` route runs `closest_hit_pipe_reference`, the
plain version of `csrc/closest_hit_pipe.cu`: per group of 8 rays the
front-to-back tile walk of its 128-ray row, 32 entries at a time, with the
slab votes and the early exit (tests/test_torch_group_walk.py holds its
counts).  The count tests below hold the 128-ray block walk with the lagging
prefetch decision (`closest_hit_block_reference`), which the prefilter
kernel `csrc/closest_hit_mxu.cu` keeps.  It is held against the JAX package's `_closest_kernel_big_pipe`
in interpret mode (`closest_hit_pallas(..., big=True)`, as
tests/test_bigmesh.py runs it) on the displaced icosphere at subdiv=4 (5,124
triangles), built by both packages from the same host arrays.

Tolerances: equal hit masks; equal slots except at coplanar or shared-edge
ties between triangles of different tiles (the two tile widths, 128 and
2,048, visit them in another order): >= 99% of the hits; t to rtol 1e-5
(tests/test_bigmesh.py's), the same float32 Woop expressions with XLA free to
contract a*b+c.  The plain versions of the port's two kernels agree bit for
bit.  The 16x16 mesh render is compared by 4x4-pixel region means within 5
sigma of the Monte-Carlo error (sigma from the spread of the port's
batches) and by the image mean within 10%.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.models.scene import build_scene as jbuild_scene
from gpu_pathtracer_tpu.ops import pallas_trace
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import closest_hit, intersect, trace
from gpu_pathtracer_tpu_torch.render import integrator
from gpu_pathtracer_tpu_torch.utils import testscenes

torch.set_num_threads(1)
CAM = dict(eye=(0.5, 0.8, 2.2), center=(0.5, 0.45, 0.5), up=(0, 1, 0), fovy_deg=45.0)


@pytest.fixture(scope="module")
def mesh():
    host = testscenes.make_mesh_scene_host(subdiv=4)
    return jbuild_scene(host), build_scene(host, "cpu")


def _rays(n, seed):
    """Rays from the bench's eye towards points of the scene's box."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.5, 0.8, 2.2]], np.float32), (n, 1))
    d = rng.uniform([0.0, 0.0, 0.0], [1.0, 1.2, 1.0], (n, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pipe_plain_matches_pallas_big_kernel(mesh):
    jscene, scene = mesh
    jg, g = jscene.geom, scene.geom
    assert g.num_tris == 5124 and g.tiles.shape[0] == 41
    np.testing.assert_array_equal(g.p.numpy(), np.asarray(jg.p))  # the same sorted SoA
    o, d = _rays(256, 3)
    jt, jslot, jhit = pallas_trace.closest_hit_pallas(
        jg.tri_cols, jg.tile_aabb, o, d, interpret=True, big=True)
    t, slot, hit = closest_hit.closest_hit_tiles(g.tiles, g.tile_aabb, _t(o), _t(d), big=True)
    assert closest_hit.launch_closest_hit_pipe.launches == 0  # CPU: plain version only
    jt, jslot, jhit = np.asarray(jt), np.asarray(jslot), np.asarray(jhit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    assert 0.3 < jhit.mean() < 1.0
    np.testing.assert_allclose(t.numpy()[jhit], jt[jhit], rtol=1e-5)
    assert (slot.numpy() == jslot)[jhit].mean() >= 0.99
    assert (slot.numpy()[~jhit] == -1).all() and np.isinf(t.numpy()[~jhit]).all()


def _soup_query():
    """A soup with an invalid triangle, dead rays, a t_max and a ragged tail."""
    rng = np.random.default_rng(17)
    tris = _t(torch_parity.random_tris(rng, 1500))
    o, d = (_t(a) for a in torch_parity.random_rays(rng, 700))
    valid = torch.ones(1500, dtype=torch.bool)
    valid[11] = False
    tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris), valid)
    i = torch.arange(700)
    t_max = torch.where(i % 5 == 0, -1.0, torch.where(i % 3 == 0, 2.5, float("inf")))
    return tiles, aabb, o, d, t_max


def test_pipe_plain_equals_plain_load_plain_bit_for_bit():
    tiles, aabb, o, d, t_max = _soup_query()
    t1, s1, h1 = closest_hit.closest_hit_tiles_reference(tiles, aabb, o, d, t_max)
    t2, s2, h2 = closest_hit.closest_hit_tiles_reference(tiles, aabb, o, d, t_max, big=True)
    assert torch.equal(t1, t2) and torch.equal(s1, s2) and torch.equal(h1, h2)
    assert t1.shape == (700,) and 0.2 < float(h1.float().mean()) < 0.8
    assert not h1[::5].any() and not (s1 == 11).any()
    assert float(t1[h1 & (torch.arange(700) % 3 == 0)].max()) <= 2.5


@pytest.mark.parametrize("coherent", [True, False])
def test_lagging_prefetch_counts(mesh, coherent):
    """Per block: every scanned tile was fetched, at most one fetched tile is
    not scanned (the one in flight when the walk ends), and the walk stops
    early.  Coherent blocks scan few tiles; a block of scattered rays scans
    more."""
    _, scene = mesh
    g = scene.geom
    o, d = _rays(512, 5)
    if coherent:
        perm = np.lexsort((d[:, 1], d[:, 0] > 0))
        o, d = o[perm], d[perm]
    rays = closest_hit.prepare_rays(g.tile_aabb, _t(o), _t(d))
    order = closest_hit.block_tile_order(rays, g.tile_aabb, 4)
    t, slot, counts = closest_hit.closest_hit_block_reference(rays, g.tiles, g.tile_aabb, order)
    steps, fetched, scanned = counts.numpy().T
    assert ((fetched - scanned >= 0) & (fetched - scanned <= 1)).all(), counts
    assert (steps >= scanned).all() and (steps <= 41).all() and (scanned >= 1).all()
    assert (scanned < 41).all()  # the cull skipped tiles in every block
    rt, rslot = closest_hit.closest_hit_rays_reference(rays, g.tiles)
    assert torch.equal(t, rt) and (slot == rslot).float().mean() >= 0.99


def test_prefetch_decision_lags_one_tile():
    """Two one-triangle tiles behind each other.  The nearer one is hit by
    every ray, so the up-to-date cull never needs the farther one; the
    pipelined walk has already fetched it on the best_t from before the
    nearer tile's pairs, and leaves without scanning it."""
    def wall(z):
        return [[-5.0, -5.0, z], [5.0, -5.0, z], [0.0, 8.0, z]]

    p = torch.zeros((256, 3, 3))
    p[0], p[128] = torch.tensor(wall(-1.0)), torch.tensor(wall(-2.0))
    valid = torch.zeros(256, dtype=torch.bool)
    valid[0] = valid[128] = True
    tiles, aabb = closest_hit.pack_tiles(p, intersect.triangle_tolerance(p), valid)
    o = torch.zeros((128, 3))
    o[:, 0] = torch.linspace(-0.1, 0.1, 128)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(128, 1)
    rays = closest_hit.prepare_rays(aabb, o, d)
    order = closest_hit.block_tile_order(rays, aabb, 1)
    assert order.tolist() == [[0, 1]]
    t, slot, counts = closest_hit.closest_hit_block_reference(rays, tiles, aabb, order)
    assert counts.tolist() == [[2, 2, 1]]  # steps, fetched, scanned
    assert (slot == 0).all() and torch.allclose(t, torch.ones(128))
    # seen from behind, the order flips; the t_max of 1.5 ends the walk before
    # the other wall's tile, which is never fetched
    rays = closest_hit.prepare_rays(aabb, o - torch.tensor([0.0, 0.0, 3.0]), -d,
                                    torch.full((128,), 1.5))
    order = closest_hit.block_tile_order(rays, aabb, 1)
    t, slot, counts = closest_hit.closest_hit_block_reference(rays, tiles, aabb, order)
    assert order.tolist() == [[1, 0]] and (slot == 128).all()
    assert counts.tolist() == [[2, 1, 1]]


def test_walk_stops_at_once_for_dead_blocks():
    tiles, aabb, o, d, _ = _soup_query()
    rays = closest_hit.prepare_rays(aabb, o[:256], d[:256], torch.full((256,), -1.0))
    order = closest_hit.block_tile_order(rays, aabb, 2)
    t, slot, counts = closest_hit.closest_hit_block_reference(rays, tiles, aabb, order)
    assert (slot == -1).all()
    np.testing.assert_array_equal(counts.numpy(), [[1, 0, 0], [1, 0, 0]])


def test_dispatch_picks_the_pipelined_entry_above_pallas_max(mesh, monkeypatch):
    _, scene = mesh
    g = scene.geom
    calls = []
    inner = closest_hit.closest_hit_tiles

    def recording(*args, big=False, **kw):
        calls.append(big)
        return inner(*args, big=big, **kw)

    monkeypatch.setattr(trace, "closest_hit_tiles", recording)
    o, d = (_t(a) for a in _rays(64, 7))
    assert trace.PALLAS_MAX == 131072 and not trace.pallas_big(g)
    small = trace.closest_hit(g, o, d)
    monkeypatch.setattr(trace, "PALLAS_MAX", g.p.shape[0] - 1)
    assert trace.pallas_big(g)
    big = trace.closest_hit(g, o, d)
    monkeypatch.setattr(trace, "PALLAS_MAX", g.p.shape[0])
    assert not trace.pallas_big(g)  # "above", as in the reference package
    assert calls == [False, True]
    for a, b in zip(small, big):
        assert torch.equal(a, b)


def test_pipe_launcher_refuses_cpu_tensors(mesh):
    _, scene = mesh
    g = scene.geom
    rays = closest_hit.prepare_rays(g.tile_aabb, *(_t(a) for a in _rays(128, 1)))
    order = closest_hit.block_tile_order(rays, g.tile_aabb, 1)
    with pytest.raises(ValueError, match="CUDA"):
        closest_hit.launch_closest_hit_pipe(rays, g.tiles, g.tile_aabb, order)


def test_mesh_render_region_means_match_jax(mesh, monkeypatch):
    """16x16, spp 2 per batch, level 3, each package with its own random
    numbers; the port renders through the `big` route."""
    jscene, scene = mesh
    monkeypatch.setattr(trace, "PALLAS_MAX", 0)
    w = h = 16
    level, batches, spp = 3, 12, 2
    jimg = np.asarray(jint.render_image(
        jscene, JCamera.create(**CAM, width=w, height=h), jax.random.key(2), width=w, height=h,
        sample_size=batches * spp, level=level, hittable_pdf_weight=0.5))
    cam = Camera.create(**CAM, width=w, height=h)
    with torch.no_grad():
        parts = np.stack([
            integrator.render_image(scene, cam, w, h, sample_size=spp, level=level,
                                    hittable_pdf_weight=0.5,
                                    generator=torch.Generator().manual_seed(200 + b)).numpy()
            for b in range(batches)
        ])
    assert np.isfinite(parts).all() and (parts >= 0).all() and parts.mean() > 1e-3
    regions = parts.reshape(batches, h // 4, 4, w // 4, 4, 3).mean(axis=(2, 4))
    port = regions.mean(axis=0)
    jref = jimg.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    # the JAX estimator has the same variance, so the difference has sqrt(2) sigma
    sigma = np.sqrt(2.0) * regions.std(axis=0, ddof=1) / np.sqrt(batches)
    assert np.all(np.abs(port - jref) <= 5.0 * sigma + 1e-3), (
        np.abs(port - jref).max(), sigma.max())
    assert abs(port.mean() - jref.mean()) <= 0.10 * jref.mean(), (port.mean(), jref.mean())
