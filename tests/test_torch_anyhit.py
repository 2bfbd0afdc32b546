"""PyTorch port vs the JAX package: the windowed any-hit query.

Inputs are made with numpy from a seed and handed to both packages.  The
port's plain versions (`anyhit_reference`, `anyhit_pipe_reference`: the group
walk in its window mode, what the CUDA kernels are held against on the card)
are compared with the reference's Pallas kernels run in interpret mode, as the
reference's own tests run them.
Tolerance: none.  The outputs are bits, and both packages define them by the
same Woop pair test, so both bits are equal on every ray; they are also equal
to the bits derived from either package's closest hit (some hit with
t < t_near  <=>  the closest t < t_near), except where a hit distance equals a
cap to the last float32 bit, which these seeds do not produce.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.ops import intersect as jintersect
from gpu_pathtracer_tpu.ops import pallas_trace
from gpu_pathtracer_tpu.ops import trace as jtrace
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops import anyhit, closest_hit, intersect, trace

torch.set_num_threads(1)


def _soup(seed, n, r):
    rng = np.random.default_rng(seed)
    tris = torch_parity.random_tris(rng, n)
    o, d = torch_parity.random_rays(rng, r)
    t_near = rng.uniform(0.2, 5.0, r).astype(np.float32)
    t_far = (t_near + rng.uniform(0.0, 3.0, r)).astype(np.float32)
    return rng, tris, o, d, t_near, t_far


def _port_tiles(tris):
    p = torch.from_numpy(tris)
    return closest_hit.pack_tiles(p, intersect.triangle_tolerance(p),
                                  torch.ones(p.shape[0], dtype=torch.bool))


def _jax_tiles(tris):
    jt = jnp.asarray(tris)
    tol = jintersect.triangle_tolerance(jt)
    valid = jnp.ones((tris.shape[0],), bool)
    return jt, tol, valid, pallas_trace.pack_tri_cols(jt, tol, valid)


@pytest.mark.parametrize("n,r,big", [(700, 256, False), (1300, 300, True)])
def test_plain_versions_match_pallas_interpret(n, r, big):
    """Every other ray has a finite far cap, the rest t_far = inf."""
    _, tris, o, d, t_near, t_far = _soup(100 + n + r, n, r)
    far = np.where(np.arange(r) % 2 == 0, t_far, np.float32(np.inf)).astype(np.float32)
    jt, tol, valid, (cols, jaabb) = _jax_tiles(tris)
    jn, jf = pallas_trace.occluded_window_pallas(
        cols, jaabb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_near), jnp.asarray(far),
        interpret=True, big=big)
    tiles, aabb = _port_tiles(tris)
    near, far_bit = anyhit.occluded_window_tiles(
        tiles, aabb, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_near),
        torch.from_numpy(far), big=big)
    np.testing.assert_array_equal(np.asarray(jn), near.numpy())
    np.testing.assert_array_equal(np.asarray(jf), far_bit.numpy())
    assert near.any() and (far_bit & ~near).any() and not far_bit.all()

    # the bits derived from the closest hit, the port's and the reference's
    t, _, hit = closest_hit.closest_hit_tiles(tiles, aabb, torch.from_numpy(o),
                                              torch.from_numpy(d))
    assert torch.equal(near, hit & (t < torch.from_numpy(t_near)))
    assert torch.equal(far_bit, hit & (t <= torch.from_numpy(far)))
    t_ref, _, _, hit_ref = jtrace.closest_hit_dense(jt, tol, valid, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(hit_ref & (t_ref < t_near)), near.numpy())
    np.testing.assert_array_equal(np.asarray(hit_ref & (t_ref <= far)), far_bit.numpy())


def test_the_two_plain_versions_agree_and_count_their_walk():
    """The group walk in its window mode, counted for the plain-load kernel
    (nothing fetched ahead) and for the ring (PIPE_RING buffers): the same
    bits, the same entries walked and tiles scanned group by group, at most
    PIPE_RING tiles fetched and not scanned; a group of dead or padding rays
    walks one entry and scans nothing."""
    _, tris, o, d, t_near, t_far = _soup(7, 1300, 600)
    t_near[512:] = -1.0  # rays 512.. are dead: the groups from 64 on are all dead or padding
    t_far[512:] = -1.0
    tiles, aabb = _port_tiles(tris)
    rays = anyhit.prepare_rays_window(aabb, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(t_near), torch.from_numpy(t_far))
    assert rays.shape == (640, 8)
    order = closest_hit.block_tile_order(rays, aabb, 5)
    n0, f0, c0 = anyhit.anyhit_reference(rays, tiles, aabb, order)
    n1, f1, c1 = anyhit.anyhit_pipe_reference(rays, tiles, aabb, order)
    assert c0.shape == c1.shape == (640 // closest_hit.GROUP_RAYS, 3)
    assert torch.equal(n0, n1) and torch.equal(f0, f1)
    assert torch.equal(c0[:, 0], c1[:, 0]) and torch.equal(c0[:, 2], c1[:, 2])
    extra = c1[:, 1] - c1[:, 2]
    assert bool(((extra >= 0) & (extra <= closest_hit.PIPE_RING)).all())
    assert torch.equal(c0[:, 1], c0[:, 2])
    dead = 512 // closest_hit.GROUP_RAYS
    assert c0[dead:].tolist() == [[1, 0, 0]] * (80 - dead) and torch.equal(c1[dead:], c0[dead:])
    assert not n0[512:].any() and not f0[512:].any()
    assert bool((c0[:dead, 2] > 0).all()) and bool((c0[:, 0] <= tiles.shape[0]).all())


def test_prepare_rays_window_layout():
    """[o, d, t_far capped at the root exit, min(t_near, t_far)], clamped to
    3.4e38; a ray that misses the root box and the padding rows get -1 caps."""
    _, tris, o, d, t_near, _ = _soup(3, 300, 130)
    o[0] = (50.0, 50.0, 50.0)
    d[0] = (1.0, 0.0, 0.0)  # points away from the soup
    tiles, aabb = _port_tiles(tris)
    rays = anyhit.prepare_rays_window(aabb, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(t_near))
    assert rays.shape == (256, 8) and rays.dtype == torch.float32 and rays.is_contiguous()
    cap = closest_hit.root_exit_cap(aabb, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.full((130,), float("inf")))
    assert torch.equal(rays[:130, 6], cap) and bool((cap[1:] < 3.4e38).all())
    assert torch.equal(rays[:130, 7], torch.minimum(torch.from_numpy(t_near), cap))
    assert rays[0, 6] == -1.0 and rays[0, 7] == -1.0
    pad = rays[130:]
    assert bool((pad[:, 6:8] == -1.0).all()) and bool((pad[:, 5] == 1.0).all())
    assert bool((pad[:, 0:5] == 0.0).all())


@pytest.mark.parametrize("sort_min", [64, 1 << 30])
def test_occluded_window_live_mask_matches_jax(monkeypatch, sort_min):
    """`trace.occluded_window` with a live mask, with and without the
    coherence sort, against the reference's `trace.occluded_window`."""
    monkeypatch.setattr(trace, "RAY_SORT_MIN", sort_min)
    rng, tris, o, d, t_near, _ = _soup(21, 900, 512)
    live = rng.random(512) < 0.7
    jt, tol, valid, (cols, jaabb) = _jax_tiles(tris)
    jg = SimpleNamespace(p=jt, tol=tol, valid=valid, tri_cols=cols, tile_aabb=jaabb)
    jn, jf = jtrace.occluded_window(jg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_near),
                                    live=jnp.asarray(live))
    tiles, aabb = _port_tiles(tris)
    g = SimpleNamespace(p=torch.from_numpy(tris), tiles=tiles, tile_aabb=aabb)
    near, far = trace.occluded_window(g, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(t_near), live=torch.from_numpy(live))
    np.testing.assert_array_equal(np.asarray(jn), near.numpy())
    np.testing.assert_array_equal(np.asarray(jf), far.numpy())
    assert not near[~live].any() and not far[~live].any() and near[live].any()


def test_occluded_window_dispatch_and_no_closest_hit(monkeypatch):
    """Above PALLAS_MAX rows the query takes the ring kernel's plain version,
    below it the plain-load one's; it never goes through the closest hit."""
    _, tris, o, d, t_near, _ = _soup(5, 300, 128)
    tiles, aabb = _port_tiles(tris)
    g = SimpleNamespace(p=torch.from_numpy(tris), tiles=tiles, tile_aabb=aabb)
    calls = []
    for name in ("anyhit_reference", "anyhit_pipe_reference"):
        inner = getattr(anyhit, name)
        monkeypatch.setattr(anyhit, name,
                            lambda *a, _n=name, _f=inner: (calls.append(_n), _f(*a))[1])

    def no_closest(*a, **k):
        raise AssertionError("occluded_window went through the closest hit")

    monkeypatch.setattr(trace, "closest_hit_tiles", no_closest)
    args = (g, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_near))
    out_small = trace.occluded_window(*args)
    monkeypatch.setattr(trace, "PALLAS_MAX", 299)
    out_big = trace.occluded_window(*args)
    assert calls == ["anyhit_reference", "anyhit_pipe_reference"]
    assert torch.equal(out_small[0], out_big[0]) and torch.equal(out_small[1], out_big[1])


def test_wrappers_refuse_cpu_tensors_and_other_devices():
    """The launchers take CUDA tensors only; `occluded_window_tiles` picks the
    plain version by the tensor's device and refuses what is neither."""
    _, tris, o, d, t_near, _ = _soup(5, 300, 128)
    tiles, aabb = _port_tiles(tris)
    rays = anyhit.prepare_rays_window(aabb, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(t_near))
    order = closest_hit.block_tile_order(rays, aabb, 1)
    for name, launch in (("anyhit", anyhit.launch_anyhit),
                         ("anyhit_pipe", anyhit.launch_anyhit_pipe)):
        before = tracing.totals[f"launch.{name}"]
        with pytest.raises(ValueError, match="CUDA"):
            launch(rays, tiles, aabb, order)
        assert tracing.totals[f"launch.{name}"] == before
    meta = [x.to("meta") for x in (tiles, aabb, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(t_near))]
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        anyhit.occluded_window_tiles(*meta)


def test_dead_rays_cannot_poison_their_block(monkeypatch):
    """Dead rays may carry NaN directions or infinite origins (an absorbed
    photon, an invalid hit point).  The kernels take the origin box and |d|
    bound of each 128-ray row of the tile order, so such a ray would cull its
    row's live
    rays as well; the dispatchers park dead rays first.  Shown on the
    walk-based plain versions (what the kernels compute): live rays get the
    answers of a query without the dead rays' garbage."""
    monkeypatch.setattr(trace, "PALLAS_MAX", 100)  # the walk-based plain versions
    rng, tris, o, d, t_near, _ = _soup(33, 600, 256)
    live = rng.random(256) < 0.6
    tiles, aabb = _port_tiles(tris)
    g = SimpleNamespace(p=torch.from_numpy(tris), tiles=tiles, tile_aabb=aabb)
    clean = [torch.from_numpy(x) for x in (o, d, t_near)]
    o_bad, d_bad = o.copy(), d.copy()
    o_bad[~live] = np.inf
    d_bad[~live] = np.nan
    dirty = [torch.from_numpy(x) for x in (o_bad, d_bad, t_near)]
    lv = torch.from_numpy(live)
    t0, s0, h0 = trace.closest_hit_sorted(g, clean[0], clean[1], live=lv)
    t1, s1, h1 = trace.closest_hit_sorted(g, dirty[0], dirty[1], live=lv)
    assert torch.equal(s0, s1) and torch.equal(t0, t1) and h1[lv].float().mean() > 0.3
    n0, f0 = trace.occluded_window(g, *clean, live=lv)
    n1, f1 = trace.occluded_window(g, *dirty, live=lv)
    assert torch.equal(n0, n1) and torch.equal(f0, f1) and f1[lv].any() and not f1[~lv].any()
    # unparked, the same rays lose their block: the fault this guards against
    tm = torch.where(lv, float("inf"), -1.0)
    _, _, h_raw = closest_hit.closest_hit_tiles(tiles, aabb, dirty[0], dirty[1], tm, big=True)
    assert not h_raw.any()
