"""The closest-hit query's dispatch kernels (`csrc/query_key.cu`,
`csrc/query_pack.cu`, `csrc/query_finish.cu`) and the query's rule for
taking them (`trace.closest_hit`).

This file imports no JAX.  The card's tests are marked `cuda` and skip
without an NVIDIA GPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dispatch.py -q

They hold `trace.launch_query` to the plain version,
`trace.closest_hit_reference`, bit for bit in t, slot, hit and bary, the
key kernel's permutation to `coherence_perm`'s and the packed rows to
`prepare_rays`' of the sorted rays: on the queries that `trace_paths` makes
(recorded through the integrator's call) on the Cornell box, the textured
bump-mapped mesh on the ring-buffered and the prefilter routes, and a box of
nested dielectrics with fog and a scattering material; and on planted edges:
dead rays with NaN or infinite origins and directions, live rays with NaN
or infinite origins, an all-dead batch, a batch below `RAY_SORT_MIN`, a
one-tile scene, a count that is not a multiple of 128, axis-parallel
directions and rays through a triangle's edge or vertex (the Dekker
fallback of the edge functions).  A card render with the kernels equals one
without them bit for bit.

The CPU tests check the routing: one launch of each query kernel a wavefront
step for a render without gradients (the router's call is stood in for by a
counting spy, since a CPU tensor takes the plain version; the key kernel
only where the batch sorts), none for a gradient render,
`render_image_value_and_grad`, rays that require grad, a tensor budget or
`kernels=False`; and the kernels' root-box table.
"""

import dataclasses
import math

import pytest
import torch

import chip_smoke
import test_torch_shade_surface as shade_tests
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import closest_hit, trace
from gpu_pathtracer_tpu_torch.render import integrator
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

CAM = chip_smoke.CORNELL_CAM
CPU = torch.device("cpu")
SIDE, SPP, LEVEL = (8, 4), 2, 2
QUERY_KERNELS = ("query_key", "query_pack", "query_finish")


_render = shade_tests._render


def _spy(monkeypatch, record=None):
    """Stand in for the query's call of `closest_hit_query`: count the
    launches `launch_query` makes on the card (the key kernel where the
    batch sorts), keep its arguments, run the real one."""
    real = trace.closest_hit_query

    def spy(g, origin, direction, t_max, live):
        if trace._sorts(g, origin.shape[0]):
            tracing.count("launch.query_key")
        tracing.count("launch.query_pack")
        tracing.count("launch.query_finish")
        if record is not None:
            record.append((g, origin, direction, t_max, live))
        return real(g, origin, direction, t_max, live)

    monkeypatch.setattr(trace, "closest_hit_query", spy)


def _counts():
    return {k: tracing.totals[f"launch.{k}"] for k in QUERY_KERNELS}


# ---------------------------------------------------------------------------
# The CPU: the routing rule and the root box
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return shade_tests._scene(tmp_path_factory.mktemp("cornell"), "cornell", CPU)[0]


def test_each_kernel_once_a_step_for_a_render_without_gradients(cornell, monkeypatch):
    assert cornell.geom.tiles.shape[0] >= trace.RAY_SORT_MIN_TILES
    _spy(monkeypatch)
    tracing.reset("launch.")
    monkeypatch.setattr(trace, "RAY_SORT_MIN", 16)  # the 32-ray wavefront sorts
    _render(cornell, CAM, SIDE, SPP, LEVEL, CPU)
    steps = SPP * LEVEL
    assert _counts() == {k: steps for k in QUERY_KERNELS}
    # below RAY_SORT_MIN: no sort, so no key kernel
    monkeypatch.setattr(trace, "RAY_SORT_MIN", 8192)
    _render(cornell, CAM, SIDE, SPP, LEVEL, CPU)
    assert _counts() == {"query_key": steps, "query_pack": 2 * steps, "query_finish": 2 * steps}
    # grad mode on: the kernels unless an input of the query requires grad
    w, h = SIDE
    o, d = Camera.create(**CAM, width=w, height=h).generate_rays(
        torch.rand(w * h) * h, torch.rand(w * h) * w, torch.rand(w * h), torch.rand(w * h))
    integrator.trace_paths(cornell, o, d, level=LEVEL, hittable_pdf_weight=0.5,
                           generator=torch.Generator().manual_seed(2))
    assert _counts()["query_finish"] == 2 * steps + LEVEL


@pytest.mark.parametrize("case", ["value_and_grad", "gradient_render", "rays_require_grad"])
def test_no_launch_where_a_gradient_is_asked_for(case, tmp_path, monkeypatch):
    """`render_image_value_and_grad`'s `wrt` are scene tensors that require
    grad: neither its pass without a graph nor its replay takes the kernels;
    nor does a graph-recording render or a step whose rays require grad."""
    scene = shade_tests._scene(tmp_path, "cornell", CPU)[0]
    _spy(monkeypatch)
    tracing.reset("launch.")
    {"value_and_grad": shade_tests._value_and_grad,
     "gradient_render": shade_tests._gradient_render,
     "rays_require_grad": shade_tests._rays_require_grad}[case](scene)
    assert _counts() == {k: 0 for k in QUERY_KERNELS}


def test_the_router_keeps_the_plain_version_for_its_other_cases(cornell, monkeypatch):
    """A tensor budget, `kernels=False` and attr rows that require grad take
    the plain version; a number budget with grad mode on and nothing that
    requires grad takes the kernels, with the plain version's results."""
    g = cornell.geom
    gen = torch.Generator().manual_seed(7)
    o = torch.rand((64, 3), generator=gen) * 0.8 + 0.1
    d = torch.nn.functional.normalize(torch.randn((64, 3), generator=gen), dim=-1)
    live = torch.rand(64, generator=gen) < 0.8
    _spy(monkeypatch)
    tracing.reset("launch.")
    plain = trace.closest_hit_reference(g, o, d, 2.0, live)
    for kw in (dict(t_max=torch.full((64,), 2.0)), dict(t_max=2.0, kernels=False)):
        got = trace.closest_hit(g, o, d, live=live, **kw)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    attr = g.attr.clone().requires_grad_(True)
    with torch.enable_grad():
        trace.closest_hit(dataclasses.replace(g, attr=attr), o, d, 2.0, live)
    assert _counts()["query_finish"] == 0
    with torch.enable_grad():
        got = trace.closest_hit(g, o, d, 2.0, live)
    assert _counts()["query_finish"] == 1
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_the_root_box_is_the_plain_versions_and_follows_its_tiles(cornell):
    """`root_box` rows: `park_dead`'s corner, `coherence_perm`'s span and
    `root_exit_cap`'s high corner (over the non-empty tiles, so an empty
    tile's inverted box moves none of them); rebuilt after an in-place write
    to the tile boxes."""
    g = dataclasses.replace(cornell.geom, tile_aabb=cornell.geom.tile_aabb.clone())
    box = trace.root_box(g)
    aabb = g.tile_aabb
    corner, _ = trace.park_dead(g, torch.zeros((1, 3)), torch.zeros((1, 3)),
                                torch.zeros(1, dtype=torch.bool))
    assert torch.equal(box[0], corner[0])
    assert torch.equal(box[1], torch.clamp(aabb[:, 3:6].amax(0) - aabb[:, 0:3].amin(0), min=1e-12))
    assert torch.equal(box[2], aabb[:, 3:6].amax(0))
    assert trace.root_box(g) is box
    g.tile_aabb[0, 3] += 1.0
    assert float(trace.root_box(g)[2, 0]) == float(aabb[:, 3].amax())
    assert trace.root_box(g) is not box


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits_equal(a, b):
    """Same dtype and shape, the same bits (any NaN equal to any NaN)."""
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.is_floating_point:
        same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    else:
        same = a == b
    return bool(same.all()), int((~same).sum())


def _assert_query_matches_plain(g, origin, direction, t_max=math.inf, live=None):
    """`launch_query` against `closest_hit_reference` on the same inputs,
    every output bit for bit; the key kernel's permutation against
    `coherence_perm`'s and the packed rows against `prepare_rays`' of the
    parked, sorted rays.  Returns the plain version's (t, slot, bary, hit)."""
    r = origin.shape[0]
    before = _counts()
    with torch.no_grad():
        got = trace.launch_query(g, origin, direction, t_max, live)
        want = trace.closest_hit_reference(g, origin, direction, t_max, live)
    torch.cuda.synchronize()
    sorts = trace._sorts(g, r)
    assert _counts() == {k: before[k] + (k != "query_key" or sorts) for k in QUERY_KERNELS}
    for name, a, b in zip(("t", "slot", "bary", "hit"), got, want):
        ok, n_bad = _bits_equal(a, b)
        assert ok, f"{name}: {n_bad} of {r} rays differ"
    with torch.no_grad():
        tm = torch.full((r,), float(t_max), device=origin.device)
        po, pd = origin, direction
        if live is not None:
            tm = torch.where(live, tm, -1.0)
            po, pd = trace.park_dead(g, origin, direction, live)
        perm = None
        if sorts:
            perm = torch.sort(trace.launch_query_key(g, origin, direction, live),
                              stable=True).indices
            assert torch.equal(perm, trace.coherence_perm(g, po, pd, live))
            po, pd, tm = po[perm], pd[perm], tm[perm]
        rays = trace.launch_query_pack(g, origin, direction, t_max, live, perm)
        ok, n_bad = _bits_equal(rays, closest_hit.prepare_rays(g.tile_aabb, po, pd, tm))
        assert ok, f"packed rows: {n_bad} values differ"
    return want


def _recorded_queries(folder, name, dev, monkeypatch, side=(256, 256), level=8):
    scene, cam_kw = shade_tests._scene(folder, name, dev)
    queries = []
    _spy(monkeypatch, queries)
    _render(scene, cam_kw, side, 1, level, dev)
    monkeypatch.undo()
    assert len(queries) == level
    return scene, queries


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "textured-pipe", "textured-mxu", "nested"])
def test_kernels_match_plain_on_recorded_queries(cuda, name, tmp_path, monkeypatch):
    """Every bounce of a 256x256 wavefront (above RAY_SORT_MIN); the textured
    mesh with PALLAS_MAX lowered, so that it takes the ring-buffered kernel
    (and, built with the edge tiles, the prefilter's)."""
    scene_name, _, route = name.partition("-")
    if route:
        monkeypatch.setattr(trace, "PALLAS_MAX", 64)
        if route == "mxu":
            real = build_scene
            monkeypatch.setattr(shade_tests, "build_scene",
                                lambda host, dev: real(host, dev, edge_prefilter=True))
    tile_before = {k: tracing.totals[f"launch.{k}"]
                   for k in ("closest_hit", "closest_hit_pipe", "closest_hit_mxu")}
    with monkeypatch.context() as m:
        scene, queries = _recorded_queries(tmp_path, scene_name, cuda, m)
    launched = {k: tracing.totals[f"launch.{k}"] - n for k, n in tile_before.items()}
    want_kernel = {"": "closest_hit", "pipe": "closest_hit_pipe", "mxu": "closest_hit_mxu"}[route]
    assert launched[want_kernel] == len(queries), launched
    hits = 0
    for g, origin, direction, t_max, live in queries:
        assert trace._sorts(g, origin.shape[0])
        _, _, _, hit = _assert_query_matches_plain(g, origin, direction, t_max, live)
        hits += int(hit.sum())
    assert hits > 0


def _unit(v):
    return v / v.norm(dim=-1, keepdim=True)


@pytest.mark.cuda
def test_kernels_match_plain_on_planted_edges(cuda, tmp_path, monkeypatch):
    _, queries = _recorded_queries(tmp_path / "cornell", "cornell", cuda, monkeypatch, level=2)
    g, o, d, t_max, live = queries[1]
    r = o.shape[0]
    idx = torch.arange(r, device=cuda)
    nan, inf = math.nan, math.inf

    # dead rays with NaN or infinite origins and directions
    o2, d2, dead = o.clone(), d.clone(), idx % 5 == 0
    o2[dead & (idx % 2 == 0)] = nan
    o2[dead & (idx % 2 == 1), 1] = -inf
    d2[dead & (idx % 3 == 0)] = nan
    d2[dead & (idx % 3 == 1), 0] = inf
    _assert_query_matches_plain(g, o2, d2, t_max, live & ~dead)

    # live rays with NaN or infinite origins, and no live mask at all
    o3 = o.clone()
    o3[idx % 97 == 3, 1] = nan
    o3[idx % 89 == 5] = inf
    o3[idx % 83 == 7, 2] = -inf
    _assert_query_matches_plain(g, o3, d, t_max, torch.ones_like(live))
    _assert_query_matches_plain(g, o3, d, 2.5, None)

    # an all-dead batch: nothing hits
    _, _, _, hit = _assert_query_matches_plain(g, o, d, t_max, torch.zeros_like(live))
    assert not bool(hit.any())

    # below RAY_SORT_MIN (no sort), and a count that is not a multiple of 128
    small = trace.RAY_SORT_MIN - 1
    _assert_query_matches_plain(g, o[:small], d[:small], t_max, live[:small])
    _assert_query_matches_plain(g, o[:r - 37], d[:r - 37], t_max, live[:r - 37])

    # axis-parallel directions, with -0 components and components below 1e-20
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                         [-0.0, -0.0, -1], [1e-30, -1e-25, -1], [0.6, -0.0, -0.8]],
                        dtype=torch.float32, device=cuda)
    d4 = axes[idx % axes.shape[0]]
    _, _, _, hit = _assert_query_matches_plain(g, o, d4, t_max, live)
    assert bool(hit.any())

    # rays through the edges and vertices of the walls' triangles: straight
    # down onto the floor's diagonal x == z and into the back wall's diagonal
    # x == y, and from the box's centre at its corners
    s = (torch.arange(4096, device=cuda) + 0.5) / 4096
    down = torch.stack([s, torch.full_like(s, 0.5), s], dim=-1)
    back = torch.stack([s, s, torch.full_like(s, 0.9)], dim=-1)
    corners = torch.tensor([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0)
                            for z in (0.0, 1.0)], device=cuda)
    centre = torch.full((8, 3), 0.5, device=cuda)
    o5 = torch.cat([down, back, centre])
    d5 = torch.cat([torch.tensor([0.0, -1.0, 0.0], device=cuda).expand(4096, 3),
                    torch.tensor([0.0, 0.0, -1.0], device=cuda).expand(4096, 3),
                    _unit(corners - centre)])
    o5, d5 = o5.repeat(2, 1), d5.repeat(2, 1)  # above RAY_SORT_MIN: the sorted path
    _, _, bary, hit = _assert_query_matches_plain(g, o5, d5, math.inf, None)
    on_edge = hit & (bary == 0).any(dim=-1)
    assert int(on_edge.sum()) > 1000, int(on_edge.sum())

    # a one-tile scene (the box without its spheres): never sorts
    testscenes.make_cornell_box(tmp_path / "box", spheres=False)
    box = build_scene(obj_io.load_scene(tmp_path / "box", "box.obj"), cuda).geom
    assert box.tiles.shape[0] == 1 and not trace._sorts(box, r)
    _assert_query_matches_plain(box, o, d, t_max, live)
    _assert_query_matches_plain(box, o5, d5, math.inf, None)


@pytest.mark.cuda
def test_render_with_and_without_the_kernels(cuda, tmp_path, monkeypatch):
    scene, _ = shade_tests._scene(tmp_path, "cornell", cuda)
    spp, level = 2, 8
    tracing.reset("launch.")
    with_kernels = _render(scene, CAM, (128, 128), spp, level, cuda)
    assert _counts() == {k: spp * level for k in QUERY_KERNELS}
    monkeypatch.setattr(trace, "closest_hit_query", trace.closest_hit_reference)
    without = _render(scene, CAM, (128, 128), spp, level, cuda)
    assert _counts() == {k: spp * level for k in QUERY_KERNELS}
    assert torch.equal(with_kernels, without)
    assert float(without.mean()) > 0.01
