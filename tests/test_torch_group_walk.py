"""The group walk of the closest-hit kernels B1, B2 and B5 (`csrc/closest_hit.cu`,
`csrc/closest_hit_pipe.cu`, `csrc/closest_hit_mxu.cu`): its plain version on
the CPU.

`closest_hit_pipe_reference` walks the tile order in groups of GROUP_RAYS
rays, WALK_BATCH entries at a time (`ops.closest_hit._group_walk`).  It is
held bit for bit against the TPU kernel's 128-ray block walk
(`closest_hit_block_reference`) and, to >= 99.9% of the slots with t
to rtol 1e-6, against the plain version that scans every tile in index order
(`closest_hit_rays_reference`; a ray may split only at an exact tie between
triangles that the two visit in another order), on a triangle soup and on
the displaced icosphere at subdiv=5 (20,484 triangles).  The counts are held
to what the walk guarantees.  No JAX: the JAX package's big kernel is held
against this plain version in tests/test_torch_bigmesh.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import closest_hit, intersect
from gpu_pathtracer_tpu_torch.utils import testscenes

torch.set_num_threads(1)
CSRC = pathlib.Path(closest_hit.__file__).resolve().parents[1] / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def soup():
    """1,500 triangles with an invalid one; 640 rays, every 5th dead, every
    3rd with a t_max of 2.5, a ragged tail."""
    rng = np.random.default_rng(23)
    tris = _t(torch_parity.random_tris(rng, 1500))
    o, d = (_t(a) for a in torch_parity.random_rays(rng, 640))
    valid = torch.ones(1500, dtype=torch.bool)
    valid[11] = False
    tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris), valid)
    i = torch.arange(640)
    t_max = torch.where(i % 5 == 0, -1.0, torch.where(i % 3 == 0, 2.5, float("inf")))
    rays = closest_hit.prepare_rays(aabb, o, d, t_max)
    return tiles, aabb, rays


@pytest.fixture(scope="module")
def mesh5():
    """The subdiv=5 icosphere and 1,024 coherence-ordered rays from the
    bench's eye (sorted by direction, as the main path's sort groups them),
    every 6th dead."""
    g = build_scene(testscenes.make_mesh_scene_host(subdiv=5), "cpu").geom
    rng = np.random.default_rng(31)
    n = 1024
    o = np.tile(np.array([[0.5, 0.8, 2.2]], np.float32), (n, 1))
    d = rng.uniform([0.0, 0.0, 0.0], [1.0, 1.2, 1.0], (n, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    perm = np.lexsort((d[:, 1], np.round(d[:, 0] * 8)))
    t_max = np.where(np.arange(n) % 6 == 0, -1.0, np.inf).astype(np.float32)
    rays = closest_hit.prepare_rays(g.tile_aabb, _t(o[perm]), _t(d[perm]), _t(t_max))
    return g.tiles, g.tile_aabb, rays


def _walks(tiles, aabb, rays):
    order = closest_hit.block_tile_order(rays, aabb, rays.shape[0] // closest_hit.RAY_BLOCK)
    group = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order)
    block = closest_hit.closest_hit_block_reference(rays, tiles, aabb, order)
    return order, group, block


@pytest.mark.parametrize("scene", ["soup", "mesh5"])
def test_group_walk_equals_block_walk_and_every_tile(scene, request):
    tiles, aabb, rays = request.getfixturevalue(scene)
    _, (t, slot, counts), (bt, bslot, _) = _walks(tiles, aabb, rays)
    assert torch.equal(t, bt) and torch.equal(slot, bslot)
    rt, rslot = closest_hit.closest_hit_rays_reference(rays, tiles)
    same = slot == rslot
    assert float(same.float().mean()) >= 0.999
    hit = same & (slot >= 0)
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-6, atol=0.0)
    assert 0.2 < float((slot >= 0).float().mean()) < 0.9
    assert counts.shape == (rays.shape[0] // closest_hit.GROUP_RAYS, 3)


@pytest.mark.parametrize("scene", ["soup", "mesh5"])
def test_group_walk_counts(scene, request):
    """Per group: every scanned tile was fetched, at most PIPE_RING fetched
    tiles are not scanned (the ring's copies in flight when the walk ends),
    the walk ends within the row, and with ring 0 (the plain-load kernel)
    fetched equals scanned with the same walk."""
    tiles, aabb, rays = request.getfixturevalue(scene)
    order, (t, slot, counts), _ = _walks(tiles, aabb, rays)
    walked, fetched, scanned = counts.numpy().T.astype(np.int64)
    extra = fetched - scanned
    assert ((extra >= 0) & (extra <= closest_hit.PIPE_RING)).all(), counts
    assert (walked >= 1).all() and (walked <= tiles.shape[0]).all() and (walked >= scanned).all()
    t0, slot0, counts0 = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order, ring=0)
    assert torch.equal(t0, t) and torch.equal(slot0, slot)
    assert torch.equal(counts0[:, 0], counts[:, 0]) and torch.equal(counts0[:, 2], counts[:, 2])
    assert torch.equal(counts0[:, 1], counts0[:, 2])
    if scene == "mesh5":
        assert (scanned < tiles.shape[0] // 2).all()  # coherent groups: the cull skips most tiles


def _two_walls():
    """Two one-triangle tiles behind each other and 128 rays hitting both."""
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
    return tiles, aabb, o, d


def test_ring_fetches_ahead_of_the_early_exit():
    """Both walls are candidates of the first batch (every ray's budget is
    unbounded when the batch is voted), so the ring starts the farther wall's
    copy before its re-check (a ring of two with the nearer one's, a ring of
    one as soon as the nearer one is scanned); the nearer wall's hits then
    end the walk at that re-check: two entries walked, two fetched, one
    scanned.  The plain-load kernel stages only the one it scans."""
    tiles, aabb, o, d = _two_walls()
    rays = closest_hit.prepare_rays(aabb, o, d)
    order = closest_hit.block_tile_order(rays, aabb, 1)
    assert order.tolist() == [[0, 1]]
    groups = closest_hit.RAY_BLOCK // closest_hit.GROUP_RAYS
    t, slot, counts = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order)
    assert counts.tolist() == [[2, min(2, 1 + closest_hit.PIPE_RING), 1]] * groups
    assert (slot == 0).all() and torch.allclose(t, torch.ones(128))
    for ring, fetched in ((0, 1), (1, 2), (2, 2)):
        _, _, c = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order, ring=ring)
        assert c.tolist() == [[2, fetched, 1]] * groups, ring
    # seen from behind with a t_max of 1.5: the batch's bound ends the walk
    # at the second entry before it is voted in
    rays = closest_hit.prepare_rays(aabb, o - torch.tensor([0.0, 0.0, 3.0]), -d,
                                    torch.full((128,), 1.5))
    order = closest_hit.block_tile_order(rays, aabb, 1)
    t, slot, counts = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order)
    assert order.tolist() == [[1, 0]] and (slot == 128).all()
    assert counts.tolist() == [[2, 1, 1]] * groups


def test_group_walk_stops_at_once_for_dead_groups(soup):
    tiles, aabb, rays = soup
    dead = rays[:256].clone()
    dead[:, 6] = -1.0
    order = closest_hit.block_tile_order(dead, aabb, 2)
    t, slot, counts = closest_hit.closest_hit_pipe_reference(dead, tiles, aabb, order)
    assert (slot == -1).all()
    assert counts.tolist() == [[1, 0, 0]] * (256 // closest_hit.GROUP_RAYS)


def test_batches_cross_the_row(mesh5):
    """A row longer than a batch: scattered ray groups walk several batches,
    and the walk still gives the answer of the 128-ray block walk, which
    steps through the row one entry at a time."""
    tiles, aabb, rays = mesh5
    rays = rays[:256]
    order = closest_hit.block_tile_order(rays, aabb, 2)
    t, slot, counts = closest_hit.closest_hit_pipe_reference(rays, tiles, aabb, order)
    assert int(counts[:, 0].max()) > 2 * closest_hit.WALK_BATCH
    bt, bslot, _ = closest_hit.closest_hit_block_reference(rays, tiles, aabb, order)
    assert torch.equal(t, bt) and torch.equal(slot, bslot)


def test_kernel_constants_match_the_plain_version():
    """The walk's shape is fixed in the sources; the plain version's
    constants must be the same numbers."""
    def constant(path, name):
        found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / path).read_text())
        assert len(found) == 1, (path, name, found)
        return int(found[0])

    assert constant("closest_hit_common.cuh", "kGroupRays") == closest_hit.GROUP_RAYS
    assert constant("closest_hit_common.cuh", "kBatch") == closest_hit.WALK_BATCH
    assert constant("closest_hit_common.cuh", "kBlock") == closest_hit.RAY_BLOCK
    assert constant("closest_hit_pipe.cu", "kRing") == closest_hit.PIPE_RING
    # B5 fetches what B2 fetches, and culls at the plain version's granularity
    assert constant("closest_hit_mxu.cu", "kRing") == closest_hit.PIPE_RING
    assert constant("closest_hit_mxu.cu", "kPerRay") == 0
    assert closest_hit.RAY_BLOCK % closest_hit.GROUP_RAYS == 0
