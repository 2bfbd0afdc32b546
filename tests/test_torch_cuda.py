"""The port's CUDA kernels on the card (tests marked `cuda`; they skip
without an NVIDIA GPU).

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: `tests/conftest.py` configures JAX for the reference
package's tests.)  Tolerances: the kernel and its plain version compute the
same float32 expressions without FMA contraction, so where slots agree t
agrees to rtol 1e-6; slots agree on >= 99.9% of rays (a ray may split only
at an exact tie between triangles that the two visit in another order).
The three closest-hit kernels share their arithmetic, their walk (groups
of 8 rays over each 128-ray row of the tile order) and the order, so the
ring-buffered one equals the plain-load one bit for bit, and the prefilter
kernel (the same ring and walk) equals both, with the same walk counts.  The any-hit
kernels walk the same way and return bits: both bits equal their plain
versions', each other's and the bits derived from the closest-hit kernel on
every ray, and the per-group counts equal the plain versions'.
"""

import os

import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import anyhit, closest_hit, intersect, trace
from gpu_pathtracer_tpu_torch.render.integrator import render_image
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _assert_agree(t, slot, rt, rslot):
    t, slot, rt, rslot = (x.cpu().numpy() for x in (t, slot, rt, rslot))
    same = slot == rslot
    assert same.mean() >= 0.999, (same.mean(), np.nonzero(~same)[0][:10])
    hit = same & (slot >= 0)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-6, atol=0.0)
    assert np.isinf(t[same & (slot < 0)]).all()


def test_kernel_matches_plain_on_cuda(cuda):
    """Random soup with an invalid triangle, dead rays and a ragged tail."""
    rng = np.random.default_rng(21)
    tris = torch.from_numpy(torch_parity.random_tris(rng, 2000)).to(cuda)
    o, d = (torch.from_numpy(a).to(cuda) for a in torch_parity.random_rays(rng, 5000))
    valid = torch.ones(2000, dtype=torch.bool, device=cuda)
    valid[3] = False
    tiles, taabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris), valid)
    t_max = torch.where(torch.arange(5000, device=cuda) % 7 == 0, -1.0, float("inf"))
    before = tracing.totals["launch.closest_hit"]
    t, slot, _ = closest_hit.closest_hit_tiles(tiles, taabb, o, d, t_max)
    torch.cuda.synchronize()
    assert tracing.totals["launch.closest_hit"] == before + 1
    rt, rslot, _ = closest_hit.closest_hit_tiles_reference(tiles, taabb, o, d, t_max)
    _assert_agree(t, slot, rt, rslot)
    slot = slot.cpu().numpy()
    assert (slot[::7] == -1).all() and not (slot == 3).any() and (slot >= 0).mean() > 0.2


def test_launch_refuses_what_the_kernel_does_not_take(cuda):
    tris = torch.rand((300, 3, 3), device=cuda)
    tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris),
                                         torch.ones(300, dtype=torch.bool, device=cuda))
    rays = closest_hit.prepare_rays(aabb, torch.zeros((256, 3), device=cuda),
                                    torch.ones((256, 3), device=cuda))
    order = closest_hit.block_tile_order(rays, aabb, 2)
    shifted = torch.empty((aabb.numel() + 1,), device=cuda)[1:].view_as(aabb).copy_(aabb)
    bad = [
        (rays, tiles, shifted, order),  # tile boxes not 16-byte aligned
        (rays.double(), tiles, aabb, order),  # dtype
        (rays[:200], tiles, aabb, order),  # not a multiple of the ray block
        (rays.t().contiguous().t(), tiles, aabb, order),  # not contiguous
        (rays, tiles, aabb, order[:1]),  # order shape
        (rays, tiles.cpu(), aabb, order),  # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            closest_hit.launch_closest_hit(*args)


def _mesh_query(cuda, n_rays):
    """The displaced icosphere at subdiv=5 (20,484 triangles, 161 tiles) and
    rays from the bench's eye, every 6th dead, a ragged count."""
    g = build_scene(testscenes.make_mesh_scene_host(subdiv=5), cuda).geom
    rng = np.random.default_rng(31)
    o = torch.tensor([[0.5, 0.8, 2.2]], device=cuda).repeat(n_rays, 1)
    target = torch.from_numpy(rng.uniform([0, 0, 0], [1, 1.2, 1], (n_rays, 3)).astype(np.float32))
    d = target.to(cuda) - o
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.where(torch.arange(n_rays, device=cuda) % 6 == 0, -1.0, float("inf"))
    return g, o, d, t_max


def test_pipe_kernel_matches_plain_and_plain_load_kernel(cuda):
    g, o, d, t_max = _mesh_query(cuda, 3000)
    before = (tracing.totals["launch.closest_hit_pipe"], tracing.totals["launch.closest_hit"])
    t, slot, hit = closest_hit.closest_hit_tiles(g.tiles, g.tile_aabb, o, d, t_max, big=True)
    t1, slot1, _ = closest_hit.closest_hit_tiles(g.tiles, g.tile_aabb, o, d, t_max)
    torch.cuda.synchronize()
    assert tracing.totals["launch.closest_hit_pipe"] == before[0] + 1
    assert tracing.totals["launch.closest_hit"] == before[1] + 1
    assert torch.equal(t, t1) and torch.equal(slot, slot1)
    rt, rslot, _ = closest_hit.closest_hit_tiles_reference(g.tiles, g.tile_aabb, o, d, t_max,
                                                           big=True)
    _assert_agree(t, slot, rt, rslot)
    assert not hit[::6].any() and 0.3 < float(hit.float().mean()) < 0.9


def test_pipe_kernel_counts_match_plain(cuda):
    """Per group of GROUP_RAYS rays: the ring kernel's counts equal its plain
    version's, the plain-load kernel's equal the same walk's with nothing
    fetched ahead (ring 0), and at most PIPE_RING tiles are fetched and not
    scanned."""
    g, o, d, t_max = _mesh_query(cuda, 2048)
    rays = closest_hit.prepare_rays(g.tile_aabb, o, d, t_max)
    order = closest_hit.block_tile_order(rays, g.tile_aabb, 16)
    t, slot, counts = closest_hit.launch_closest_hit_pipe(rays, g.tiles, g.tile_aabb, order,
                                                          counts=True)
    rt, rslot, rcounts = closest_hit.closest_hit_pipe_reference(rays, g.tiles, g.tile_aabb, order)
    same = slot == rslot
    assert float(same.float().mean()) >= 0.999
    hit = same & (slot >= 0)
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-6, atol=0.0)
    assert counts.shape == (2048 // closest_hit.GROUP_RAYS, 3)
    assert torch.equal(counts, rcounts)
    extra = (counts[:, 1] - counts[:, 2]).cpu().numpy()
    assert ((extra >= 0) & (extra <= closest_hit.PIPE_RING)).all() and (counts[:, 2] < 161).all()
    t1, slot1, counts1 = closest_hit.launch_closest_hit(rays, g.tiles, g.tile_aabb, order,
                                                        counts=True)
    _, _, rcounts1 = closest_hit.closest_hit_pipe_reference(rays, g.tiles, g.tile_aabb, order,
                                                            ring=0)
    assert torch.equal(t1, t) and torch.equal(slot1, slot)
    assert torch.equal(counts1, rcounts1)


@pytest.mark.parametrize("kernel", ["closest_hit", "closest_hit_pipe", "anyhit", "anyhit_pipe"])
def test_group_walk_cycles(cuda, kernel):
    """The per-group cycles output: the walk's cycles cover the part spent
    staging and scanning, a group that scans nothing spends nothing there,
    and asking for the cycles changes no result (closest hit: (t, slot);
    any hit: the two bits)."""
    g, o, d, t_max = _mesh_query(cuda, 2048)
    if kernel.startswith("anyhit"):
        t_near, t_far, _ = _window(np.random.default_rng(43), 2048, cuda)
        rays = anyhit.prepare_rays_window(g.tile_aabb, o, d, t_near, t_far)
        launch = getattr(anyhit, f"launch_{kernel}")
    else:
        rays = closest_hit.prepare_rays(g.tile_aabb, o, d, t_max)
        launch = getattr(closest_hit, f"launch_{kernel}")
    order = closest_hit.block_tile_order(rays, g.tile_aabb, 16)
    t, slot = launch(rays, g.tiles, g.tile_aabb, order)
    t2, slot2, counts, cycles = launch(rays, g.tiles, g.tile_aabb, order, counts=True, cycles=True)
    torch.cuda.synchronize()
    assert torch.equal(t, t2) and torch.equal(slot, slot2)
    assert cycles.shape == (2048 // closest_hit.GROUP_RAYS, 2) and cycles.dtype == torch.int64
    walk, scan = cycles[:, 0], cycles[:, 1]
    assert bool((walk > 0).all()) and bool((scan >= 0).all()) and bool((scan <= walk).all())
    assert bool((scan[counts[:, 2] == 0] == 0).all()) and bool((scan[counts[:, 2] > 0] > 0).all())


def test_mxu_kernel_bit_equal_to_pipe_kernel_and_counts_near_plain(cuda):
    """The kernel with the tensor-core edge prefilter: (t, slot) equal the
    ring kernel's bit for bit and the walk counts (walked, fetched, scanned)
    are the same group by group; the prefilter's pair counts are within 1%
    of the plain version's (the accumulation order inside the mma is the
    hardware's, so a pair at the margin may fall on either side), add up to
    the scanned tiles' pairs, and it culls pairs.  Asking for the cycles
    changes no result."""
    g, o, d, t_max = _mesh_query(cuda, 3000)
    edge_tiles, wsum = closest_hit.pack_edge_tiles(g.p, g.valid)
    rays = closest_hit.prepare_rays(g.tile_aabb, o, d, t_max)
    order = closest_hit.block_tile_order(rays, g.tile_aabb, rays.shape[0] // 128)
    before = tracing.totals["launch.closest_hit_mxu"]
    t, slot, counts = closest_hit.launch_closest_hit_mxu(rays, g.tiles, edge_tiles, wsum,
                                                         g.tile_aabb, order, counts=True)
    t2, slot2, counts2 = closest_hit.launch_closest_hit_pipe(rays, g.tiles, g.tile_aabb, order,
                                                             counts=True)
    t4, slot4, counts4, cycles = closest_hit.launch_closest_hit_mxu(
        rays, g.tiles, edge_tiles, wsum, g.tile_aabb, order, counts=True, cycles=True)
    torch.cuda.synchronize()
    assert tracing.totals["launch.closest_hit_mxu"] == before + 2
    assert torch.equal(t, t2) and torch.equal(slot, slot2)
    assert torch.equal(t4, t) and torch.equal(slot4, slot) and torch.equal(counts4, counts)
    assert counts.shape == (rays.shape[0] // closest_hit.GROUP_RAYS, 5)
    assert torch.equal(counts[:, :3], counts2)
    assert cycles.shape == (counts.shape[0], 2) and bool((cycles[:, 1] <= cycles[:, 0]).all())
    rt, rslot, rcounts = closest_hit.closest_hit_mxu_reference(rays, g.tiles, edge_tiles, wsum,
                                                               g.tile_aabb, order)
    same = slot == rslot
    assert float(same.float().mean()) >= 0.999
    hit = same & (slot >= 0)
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-6, atol=0.0)
    assert torch.equal(counts[:, :3], rcounts[:, :3])
    passed, culled = counts[:, 3].long(), counts[:, 4].long()
    pairs = counts[:, 2].long() * closest_hit.GROUP_RAYS * closest_hit.TILE
    assert torch.equal(passed + culled, pairs) and int(culled.sum()) > 0
    rpassed = int(rcounts[:, 3].sum())
    assert abs(int(passed.sum()) - rpassed) <= 0.01 * rpassed, (int(passed.sum()), rpassed)
    # through the public entry point
    t3, slot3, _ = closest_hit.closest_hit_tiles(g.tiles, g.tile_aabb, o, d, t_max, big=True,
                                                 edge=(edge_tiles, wsum))
    assert torch.equal(t3, torch.where(slot2[:3000] >= 0, t2[:3000], float("inf")))
    assert torch.equal(slot3, slot2[:3000])
    with pytest.raises(ValueError):
        closest_hit.launch_closest_hit_mxu(rays, g.tiles, edge_tiles.float(), wsum, g.tile_aabb,
                                           order)


def test_pipe_launch_refuses_what_the_kernel_does_not_take(cuda):
    tris = torch.rand((300, 3, 3), device=cuda)
    tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris),
                                         torch.ones(300, dtype=torch.bool, device=cuda))
    rays = closest_hit.prepare_rays(aabb, torch.zeros((256, 3), device=cuda),
                                    torch.ones((256, 3), device=cuda))
    order = closest_hit.block_tile_order(rays, aabb, 2)
    closest_hit.launch_closest_hit_pipe(rays, tiles, aabb, order)  # the good call goes through
    shifted = torch.empty((tiles.numel() + 1,), device=cuda)[1:].view_as(tiles).copy_(tiles)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    narrow = tiles[:, :, :126].contiguous()  # 126 % 4 != 0
    wide = torch.zeros((1, 10, 1024), device=cuda)  # above the kernel's 512
    bad = [
        (rays, shifted, aabb, order),  # not 16-byte aligned
        (rays, narrow, aabb, order),
        (rays, wide, aabb[:1], order[:, :1].contiguous()),
        (rays.double(), tiles, aabb, order),
        (rays[:200], tiles, aabb, order),
        (rays, tiles, aabb, order[:1]),
        (rays, tiles.cpu(), aabb, order),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            closest_hit.launch_closest_hit_pipe(*args)


def test_closest_hit_on_cuda_matches_cpu(cuda, tmp_path):
    """`trace.closest_hit` on the Cornell box with spheres: the card (kernel,
    coherence-sorted, one launch) against the CPU (plain version)."""
    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=2)
    hs = obj_io.load_scene(tmp_path, "box.obj")
    rng = np.random.default_rng(5)
    r = 20000  # above trace.RAY_SORT_MIN: the sorted path
    cam = Camera.create(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0),
                        fovy_deg=40.0, width=64, height=64)
    pix = torch.from_numpy(rng.uniform(0, 64, (2, r)).astype(np.float32))
    zeros = torch.zeros(r)
    o, d = cam.generate_rays(pix[0], pix[1], zeros, zeros)
    live = torch.from_numpy(rng.random(r) < 0.7)
    out = {}
    for dev in ("cpu", cuda):
        g = build_scene(hs, dev).geom
        before = tracing.totals["launch.closest_hit"]
        out[str(dev)] = [x.cpu() for x in trace.closest_hit(g, o.to(dev), d.to(dev),
                                                           live=live.to(dev))]
        launched = tracing.totals["launch.closest_hit"] - before
        assert launched == (1 if dev == cuda else 0), launched
    (t, slot, bary, hit), (rt, rslot, rbary, rhit) = out[str(cuda)], out["cpu"]
    _assert_agree(t, slot, rt, rslot)
    assert not hit[~live].any() and hit[live].float().mean() > 0.9
    same = (slot == rslot) & hit
    np.testing.assert_allclose(bary[same].numpy(), rbary[same].numpy(), rtol=1e-5, atol=1e-6)


def test_traced_frame_on_cuda(cuda, tmp_path):
    """A captured `render_image` frame on the card: the image bit for bit the
    untraced one's, the step tree with device times that tile the frame, one
    `launch.closest_hit` inside each `kernel.closest_hit`, the synchronising
    calls counted, and the sync debug mode restored."""
    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=2)
    scene = build_scene(obj_io.load_scene(tmp_path, "box.obj"), cuda)
    cam = Camera.create(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0),
                        fovy_deg=40.0, width=128, height=128, device=cuda)

    def render():
        with torch.no_grad():
            return render_image(scene, cam, 128, 128, sample_size=2, level=4,
                                hittable_pdf_weight=0.5, ray_chunk=128 * 128,
                                generator=torch.Generator(device=cuda).manual_seed(3))

    off = render()
    tracing.clear()
    mode = torch.cuda.get_sync_debug_mode()
    with tracing.capture():
        on = render()
    torch.cuda.synchronize()
    assert torch.equal(on, off) and torch.cuda.get_sync_debug_mode() == mode
    (frame,) = tracing.frames()
    steps = frame.named("integrator.step")
    assert len(steps) == 2 * 4 and frame.sync_hook
    assert sum(s.device_ms for s in steps) <= frame.root.device_ms
    for s in steps:
        kids = frame.children(s)
        assert [k.name for k in kids] == ["dispatch.closest_hit", "shading.surface",
                                          "shading.nee", "shading.accumulate"]
        assert 0 < sum(k.device_ms for k in kids) <= s.device_ms
    kernels = frame.named("kernel.closest_hit")
    assert len(kernels) == 8 and all(k.counters == {"launch.closest_hit": 1} for k in kernels)
    assert all(k.parent.name == "dispatch.closest_hit" and k.device_ms > 0 for k in kernels)
    assert frame.counter("host_sync") >= 8  # park_dead's constant, a step at least


def _window(rng, n_rays, cuda):
    """Near and far caps around typical hit distances; every 6th ray dead."""
    t_near = torch.from_numpy(rng.uniform(0.3, 3.0, n_rays).astype(np.float32)).to(cuda)
    t_far = t_near + torch.from_numpy(rng.uniform(0.0, 2.0, n_rays).astype(np.float32)).to(cuda)
    dead = torch.arange(n_rays, device=cuda) % 6 == 0
    return torch.where(dead, -1.0, t_near), torch.where(dead, -1.0, t_far), dead


@pytest.mark.parametrize("big", [False, True])
def test_anyhit_kernels_match_plain_and_closest_hit(cuda, big):
    """Soup and the subdiv=5 mesh: the kernel of the route (the ring kernel
    on the mesh) against its plain version (bits; per-group counts), the
    plain-load kernel's bits equal to it on every ray with the same entries
    walked and tiles scanned group by group, both against the closest hit."""
    rng = np.random.default_rng(41)
    if big:
        g, o, d, _ = _mesh_query(cuda, 3000)
        tiles, aabb = g.tiles, g.tile_aabb
    else:
        tris = torch.from_numpy(torch_parity.random_tris(rng, 2000)).to(cuda)
        o, d = (torch.from_numpy(a).to(cuda) for a in torch_parity.random_rays(rng, 3000))
        tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris),
                                             torch.ones(2000, dtype=torch.bool, device=cuda))
    t_near, t_far, dead = _window(rng, 3000, cuda)
    rays = anyhit.prepare_rays_window(aabb, o, d, t_near, t_far)
    order = closest_hit.block_tile_order(rays, aabb, rays.shape[0] // closest_hit.RAY_BLOCK)
    launch = anyhit.launch_anyhit_pipe if big else anyhit.launch_anyhit
    reference = anyhit.anyhit_pipe_reference if big else anyhit.anyhit_reference
    counter = "launch.anyhit_pipe" if big else "launch.anyhit"
    before = tracing.totals[counter]
    with tracing.capture(), tracing.frame("render.frame", cuda):
        near, far, counts = launch(rays, tiles, aabb, order, counts=True)
    torch.cuda.synchronize()
    assert tracing.totals[counter] == before + 1
    (span,) = tracing.frames()[-1].named("kernel.anyhit")  # the launch's span, by its kernel
    assert span.counters == {counter: 1} and span.device_ms > 0
    rnear, rfar, rcounts = reference(rays, tiles, aabb, order)
    assert torch.equal(near, rnear) and torch.equal(far, rfar)
    assert counts.shape == (rays.shape[0] // closest_hit.GROUP_RAYS, 3)
    assert torch.equal(counts, rcounts)
    n1, f1, c1 = anyhit.launch_anyhit(rays, tiles, aabb, order, counts=True)
    assert torch.equal(near, n1) and torch.equal(far, f1)
    assert torch.equal(c1[:, 0], counts[:, 0]) and torch.equal(c1[:, 2], counts[:, 2])
    assert torch.equal(c1[:, 1], c1[:, 2])
    extra = (counts[:, 1] - counts[:, 2]).cpu().numpy()
    assert ((extra >= 0) & (extra <= (closest_hit.PIPE_RING if big else 0))).all()
    t, _, hit = closest_hit.closest_hit_tiles(tiles, aabb, o, d)
    assert torch.equal(near[:3000], hit & (t < t_near))
    assert torch.equal(far[:3000], hit & (t <= t_far))
    assert not near[:3000][dead].any() and not far[:3000][dead].any() and not far[3000:].any()
    assert 0.05 < float(far.float().mean()) < 0.9 and bool((far & ~near).any())


def test_anyhit_launch_refuses_what_the_kernels_do_not_take(cuda):
    tris = torch.rand((300, 3, 3), device=cuda)
    tiles, aabb = closest_hit.pack_tiles(tris, intersect.triangle_tolerance(tris),
                                         torch.ones(300, dtype=torch.bool, device=cuda))
    rays = anyhit.prepare_rays_window(aabb, torch.zeros((256, 3), device=cuda),
                                      torch.ones((256, 3), device=cuda), 1.0)
    order = closest_hit.block_tile_order(rays, aabb, 2)
    for launch in (anyhit.launch_anyhit, anyhit.launch_anyhit_pipe):
        launch(rays, tiles, aabb, order)  # the good call goes through
        for args in [(rays.double(), tiles, aabb, order), (rays[:200], tiles, aabb, order),
                     (rays, tiles, aabb, order[:1]), (rays, tiles.cpu(), aabb, order)]:
            with pytest.raises(ValueError):
                launch(*args)
    with pytest.raises(ValueError):
        anyhit.launch_anyhit_pipe(rays, tiles[:, :, :126].contiguous(), aabb, order)


def test_occluded_window_on_cuda_matches_cpu(cuda, tmp_path):
    """`trace.occluded_window` on the Cornell box with spheres: the card (one
    any-hit launch, coherence-sorted, no closest-hit launch) against the CPU."""
    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=2)
    hs = obj_io.load_scene(tmp_path, "box.obj")
    rng = np.random.default_rng(6)
    r = 20000
    o = torch.from_numpy(rng.uniform(0.05, 0.95, (r, 3)).astype(np.float32))
    d = torch.from_numpy(torch_parity.random_rays(rng, r)[1])
    t_near = torch.from_numpy(rng.uniform(0.05, 1.0, r).astype(np.float32))
    live = torch.from_numpy(rng.random(r) < 0.7)
    out = {}
    for dev in ("cpu", cuda):
        g = build_scene(hs, dev).geom
        before = (tracing.totals["launch.anyhit"], tracing.totals["launch.closest_hit"])
        out[str(dev)] = [x.cpu() for x in trace.occluded_window(
            g, o.to(dev), d.to(dev), t_near.to(dev), live=live.to(dev))]
        after = (tracing.totals["launch.anyhit"], tracing.totals["launch.closest_hit"])
        assert (after[0] - before[0], after[1] - before[1]) == ((1, 0) if dev == cuda else (0, 0))
    (near, far), (rnear, rfar) = out[str(cuda)], out["cpu"]
    assert float((near == rnear).float().mean()) >= 0.999
    assert float((far == rfar).float().mean()) >= 0.999
    assert not far[~live].any() and far[live].float().mean() > 0.7 and bool(near.any())


def test_differentiable_sppm_on_cuda(cuda, tmp_path):
    """A 16x16 differentiable SPPM render of the SPPM box on the card: its
    gathers' visibility runs on `anyhit` (the box is below PALLAS_MAX, so no
    ring-buffered launch), its traces on `closest_hit`, and the gradient of
    the image mean to `ke` is finite and not zero on the light's row."""
    import dataclasses

    from gpu_pathtracer_tpu_torch.render import sppm

    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=0)
    mtl = tmp_path / "box.mtl"
    mtl.write_text(mtl.read_text().replace("newmtl light\nKd 0 0 0",
                                           "newmtl light\nKd 0.78 0.78 0.78"))
    scene = build_scene(obj_io.load_scene(tmp_path, "box.obj"), cuda)
    cam = Camera.create(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0),
                        fovy_deg=40.0, width=16, height=16, device=cuda)
    ke = scene.materials.ke.clone().requires_grad_(True)
    scn = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, ke=ke))
    before = (tracing.totals["launch.anyhit"], tracing.totals["launch.anyhit_pipe"],
              tracing.totals["launch.closest_hit"])
    img = sppm.render_sppm_differentiable(scn, cam, 16, 16, n_photons=512, num_pass=2,
                                          max_bounce=4, eye_bounce=6, seed=3)
    (grad,) = torch.autograd.grad(img.mean(), ke)
    torch.cuda.synchronize()
    b3, b4, b1 = (after - b for after, b in zip(
        (tracing.totals["launch.anyhit"], tracing.totals["launch.anyhit_pipe"],
         tracing.totals["launch.closest_hit"]), before))
    assert b3 == 2 and b4 == 0 and b1 > 0, (b3, b4, b1)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    light = scene.materials.ke.amax(dim=-1) > 0
    assert bool(torch.isfinite(grad).all()) and bool((grad[light] != 0).any())


def test_render_image_distributed_nccl_world_of_one(cuda, tmp_path):
    """A world-size-1 NCCL group on the card: `render_image_distributed`
    (through the group's all-gather) is `render_image` bit for bit."""
    import socket

    import torch.distributed as dist

    from gpu_pathtracer_tpu_torch.parallel import dist as pdist
    from gpu_pathtracer_tpu_torch.parallel import shard
    from gpu_pathtracer_tpu_torch.render.integrator import render_image

    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=2)
    scene = build_scene(obj_io.load_scene(tmp_path, "box.obj"), cuda)
    cam = Camera.create(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0),
                        fovy_deg=40.0, width=64, height=64, device=cuda)
    kw = dict(sample_size=2, level=4, hittable_pdf_weight=0.5)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"GPT_TPU_COORDINATOR": f"127.0.0.1:{port}", "GPT_TPU_NUM_PROCESSES": "1",
           "GPT_TPU_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert pdist.init_distributed(backend="nccl", timeout=60)
        mesh = shard.make_mesh()
        assert mesh.size == 1 and mesh.group is not None
        before = tracing.totals["collective.all_gather"]
        with torch.no_grad():
            got = shard.render_image_distributed(
                scene, cam, 64, 64, mesh, generator=torch.Generator(device=cuda).manual_seed(3),
                **kw)
            want = render_image(scene, cam, 64, 64,
                                generator=torch.Generator(device=cuda).manual_seed(3), **kw)
        assert tracing.totals["collective.all_gather"] == before + 1
        assert torch.equal(got, want) and float(want.mean()) > 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _texture_inputs(rng, n):
    """An atlas of the white default and two images (8x8, 5x3), and lookups
    with wrapping uvs and directions over the whole sphere."""
    from gpu_pathtracer_tpu_torch.ops import texture

    rgb = torch.from_numpy(rng.random((1 + 64 + 15, 3), dtype=np.float32))
    atlas = texture.Atlas(rgb=rgb, offsets=torch.tensor([0, 1, 65], dtype=torch.int32),
                          heights=torch.tensor([1, 8, 3], dtype=torch.int32),
                          widths=torch.tensor([1, 8, 5], dtype=torch.int32))
    slot = torch.from_numpy(rng.integers(0, 3, n)).to(torch.int32)
    uv = torch.from_numpy(rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    return atlas, slot, uv, d / d.norm(dim=-1, keepdim=True)


def test_texture_lookups_on_cuda_match_cpu(cuda):
    """`lookup` and `lookup_sky` on the card equal the CPU's bit for bit."""
    import dataclasses

    from gpu_pathtracer_tpu_torch.ops import texture

    atlas, slot, uv, d = _texture_inputs(np.random.default_rng(31), 65536)
    on_card = dataclasses.replace(atlas, **{f.name: getattr(atlas, f.name).to(cuda)
                                            for f in dataclasses.fields(atlas)})
    assert torch.equal(texture.lookup(on_card, slot.to(cuda), uv.to(cuda)).cpu(),
                       texture.lookup(atlas, slot, uv))
    sky, emission = atlas.rgb[1:65], torch.tensor([1.0, 0.5, 2.0])
    assert torch.equal(
        texture.lookup_sky(sky.to(cuda), 8, 8, d.to(cuda), emission.to(cuda)).cpu(),
        texture.lookup_sky(sky, 8, 8, d, emission))


def test_texel_gradient_on_cuda_halves_equal_whole(cuda):
    """The texel gather's backward on the card: summed over 65,536 lookups
    whole or in two halves (two ranks' shares), both the float64 sum
    rounded once (rtol 2e-7)."""
    from gpu_pathtracer_tpu_torch.ops import texture

    rng = np.random.default_rng(32)
    atlas, slot, uv, _ = _texture_inputs(rng, 65536)
    g = torch.from_numpy(rng.random((65536, 3), dtype=np.float32) * 1e-3)
    idx = texture.texel_index(atlas, slot, uv)
    want = np.zeros(tuple(atlas.rgb.shape))
    np.add.at(want, idx.numpy(), g.numpy().astype(np.float64))
    rgb = atlas.rgb.to(cuda).requires_grad_(True)
    card = texture.Atlas(rgb=rgb, offsets=atlas.offsets.to(cuda), heights=atlas.heights.to(cuda),
                         widths=atlas.widths.to(cuda))
    slot, uv, g = slot.to(cuda), uv.to(cuda), g.to(cuda)
    (whole,) = torch.autograd.grad(texture.lookup(card, slot, uv), rgb, g)
    halves = sum(torch.autograd.grad(texture.lookup(card, slot[s], uv[s]), rgb, g[s])[0]
                 for s in (slice(0, 32768), slice(32768, None)))
    np.testing.assert_allclose(whole.cpu().numpy(), want, rtol=2e-7)
    np.testing.assert_allclose(halves.cpu().numpy(), want, rtol=2e-7)
