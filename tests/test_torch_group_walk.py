"""The group walk of the tile kernels: the closest-hit kernels B1, B2 and B5
(`csrc/closest_hit.cu`, `csrc/closest_hit_pipe.cu`, `csrc/closest_hit_mxu.cu`)
and the any-hit kernels B3 and B4 (`csrc/anyhit.cu`, `csrc/anyhit_pipe.cu`):
its plain version on the CPU.

`closest_hit_pipe_reference` walks the tile order in groups of GROUP_RAYS
rays, WALK_BATCH entries at a time (`ops.closest_hit._group_walk`).  It is
held bit for bit against the TPU kernel's 128-ray block walk
(`closest_hit_block_reference`) and, to >= 99.9% of the slots with t
to rtol 1e-6, against the plain version that scans every tile in index order
(`closest_hit_rays_reference`; a ray may split only at an exact tie between
triangles that the two visit in another order), on a triangle soup and on
the displaced icosphere at subdiv=5 (20,484 triangles).  The counts are held
to what the walk guarantees.  The window mode (`anyhit_pipe_reference`, the
any-hit kernels' plain version) is held bit for bit against the bits that
the brute-force closest hit and the 128-ray block walk's closest hit give,
and its per-group budget against a scene built to show it.  No JAX: the JAX
package's kernels are held against these plain versions in
tests/test_torch_bigmesh.py and tests/test_torch_anyhit.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import anyhit, closest_hit, intersect
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
    # B4 fetches what B2 fetches
    assert constant("anyhit_pipe.cu", "kRing") == closest_hit.PIPE_RING
    assert closest_hit.RAY_BLOCK % closest_hit.GROUP_RAYS == 0
    # every tile kernel walks in groups through the one walk and its stagers:
    # a block a group, or (the any-hit kernels) live groups pulled by blocks
    for name in ("closest_hit", "closest_hit_pipe", "closest_hit_mxu", "anyhit", "anyhit_pipe"):
        text = (CSRC / f"{name}.cu").read_text()
        assert "__launch_bounds__(kGroupThreads)" in text, name
        if name.startswith("anyhit"):
            assert "walk_live(" in text and "launch_window(" in text, name
        else:
            assert "group_walk(blockIdx.x," in text and "kGroupRays, kGroupThreads" in text, name
    for name in ("closest_hit_pipe", "closest_hit_mxu", "anyhit_pipe"):
        assert "RingStager<kRing," in (CSRC / f"{name}.cu").read_text(), name


def _window(rng, n):
    """Window caps around the mesh's hit distances from the bench's eye for
    the first `n` rays (a ragged tail), every 6th dead, every other far cap
    infinite."""
    t_near = rng.uniform(1.0, 2.6, n).astype(np.float32)
    t_far = np.where(np.arange(n) % 2 == 0, t_near + rng.uniform(0.0, 0.5, n),
                     np.inf).astype(np.float32)
    dead = np.arange(n) % 6 == 0
    return (_t(np.where(dead, -1.0, t_near).astype(np.float32)),
            _t(np.where(dead, -1.0, t_far).astype(np.float32)))


def test_window_walk_bits_equal_the_closest_hit_bits(mesh5):
    """On the subdiv=5 mesh, with dead rays and a ragged tail: the window
    mode's bits equal, on every ray, the bits derived from the brute-force
    closest hit and from the 128-ray block walk's closest hit (the walk the
    any-hit kernels took before the group walk) on the same rays: near = a
    hit below t_near, far = a hit within t_far."""
    tiles, aabb, mesh_rays = mesh5
    n = 1000
    t_near, t_far = _window(np.random.default_rng(5), n)
    rays = anyhit.prepare_rays_window(aabb, mesh_rays[:n, 0:3], mesh_rays[:n, 3:6], t_near, t_far)
    assert rays.shape == (1024, 8)
    order = closest_hit.block_tile_order(rays, aabb, 8)
    near, far, counts = anyhit.anyhit_pipe_reference(rays, tiles, aabb, order)
    as_closest = rays.clone()
    as_closest[:, 7] = 0.0  # the far cap is the closest hit's budget
    t, slot = closest_hit.closest_hit_rays_reference(as_closest, tiles)
    bt, bslot, _ = closest_hit.closest_hit_block_reference(as_closest, tiles, aabb, order)
    for tt, ss in ((t, slot), (bt, bslot)):
        hit = ss >= 0
        assert torch.equal(near, hit & (tt < rays[:, 7])) and torch.equal(far, hit)
    assert bool(near.any()) and bool((far & ~near).any()) and not bool(far[n:].any())
    assert not bool(far[:n][::6].any()) and bool((~far[:n]).any())
    assert (counts[:, 2] < tiles.shape[0] // 2).all()


def _tilted_walls():
    """Tile 0: a wall tilted away from 128 rays along -z (its box begins at
    z = -1, the rays meet it at t = 1 + 10/13); tile 1: a wall at z = -1.5,
    behind the first one's box front but in front of where the rays meet it,
    so the closest hit must scan both tiles."""
    p = torch.zeros((256, 3, 3))
    p[0] = torch.tensor([[-5.0, -5.0, -1.0], [5.0, -5.0, -1.0], [0.0, 8.0, -3.0]])
    p[128] = torch.tensor([[-5.0, -5.0, -1.5], [5.0, -5.0, -1.5], [0.0, 8.0, -1.5]])
    valid = torch.zeros(256, dtype=torch.bool)
    valid[0] = valid[128] = True
    tiles, aabb = closest_hit.pack_tiles(p, intersect.triangle_tolerance(p), valid)
    o = torch.zeros((128, 3))
    o[:, 0] = torch.linspace(-0.1, 0.1, 128)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(128, 1)
    return tiles, aabb, o, d


def test_settled_group_leaves_at_its_next_entry():
    """The per-group budget: when every ray of a group sets its near bit on
    the first tile it scans, the group's budget is -1 and the re-check of
    the batch's next candidate ends the walk there (two entries walked, one
    scanned; the ring has fetched the second).  Rays whose window stays open
    after the first tile (far set, t_near beyond tile 1's bound) walk on and
    scan tile 1, as the closest hit does."""
    tiles, aabb, o, d = _tilted_walls()
    groups = closest_hit.RAY_BLOCK // closest_hit.GROUP_RAYS
    cap = closest_hit.prepare_rays(aabb, o, d)
    order = closest_hit.block_tile_order(cap, aabb, 1)
    assert order.tolist() == [[0, 1]]
    t, slot, counts = closest_hit.closest_hit_pipe_reference(cap, tiles, aabb, order)
    assert (slot == 128).all() and counts.tolist() == [[2, 2, 2]] * groups

    settled = anyhit.prepare_rays_window(aabb, o, d, float("inf"))
    for ring, reference in ((0, anyhit.anyhit_reference),
                            (closest_hit.PIPE_RING, anyhit.anyhit_pipe_reference)):
        near, far, c = reference(settled, tiles, aabb, order)
        assert near.all() and far.all()
        assert c.tolist() == [[2, min(2, 1 + ring), 1]] * groups, ring
    open_window = anyhit.prepare_rays_window(aabb, o, d, 1.6)  # tile 0's hits lie beyond 1.6
    near, far, c = anyhit.anyhit_pipe_reference(open_window, tiles, aabb, order)
    assert near.all() and far.all() and c.tolist() == [[2, 2, 2]] * groups
    # one ray of each group keeps its window open: its group walks on
    mixed = settled.clone()
    mixed[:: closest_hit.GROUP_RAYS] = open_window[:: closest_hit.GROUP_RAYS]
    _, _, c = anyhit.anyhit_reference(mixed, tiles, aabb, order)
    assert c.tolist() == [[2, 2, 2]] * groups
