"""The port's closest-hit tile query vs the JAX package's Pallas kernel
(interpret mode on the CPU, as tests/test_pallas.py runs it).

On the CPU `closest_hit_tiles` runs its plain version, which does the CUDA
kernel's arithmetic over the port's 128-wide tiles; the Pallas kernel uses
512-wide tiles.  Tolerances: slots agree on >= 99.9% of rays (a ray may
split at a coplanar or shared-edge tie between triangles in different
tiles, which the two tilings visit in another order), and t agrees to
rtol 1e-6 plus atol 1e-7 where slots agree against Pallas: the same float32
Woop expressions, but XLA:CPU may contract a*b+c into an FMA where PyTorch
rounds each op, and t = ts/det carries that cancellation as an absolute
error of about one ulp of the vertex coordinates (~1e-7), which is a large
relative error only for t near 0.  The CUDA kernel against its plain
version is in tests/test_torch_cuda.py.
"""

import ast
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.ops import intersect as jisect
from gpu_pathtracer_tpu.ops import pallas_trace
from gpu_pathtracer_tpu.ops import trace as jtrace
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops import _build, closest_hit, trace

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _soup(seed, n, r, invalid=()):
    rng = np.random.default_rng(seed)
    tris = torch_parity.random_tris(rng, n)
    o, d = torch_parity.random_rays(rng, r)
    tol = np.asarray(jisect.triangle_tolerance(jnp.asarray(tris)))
    valid = np.ones(n, bool)
    valid[list(invalid)] = False
    return tris, tol, valid, o, d


def _port_tiles(tris, tol, valid):
    return closest_hit.pack_tiles(_t(tris), _t(tol), _t(valid))


def _assert_agree(t, slot, jt, jslot):
    t, slot = t.numpy(), slot.numpy()
    jt, jslot = np.asarray(jt), np.asarray(jslot)
    same = slot == jslot
    assert same.mean() >= 0.999, (same.mean(), np.nonzero(~same)[0][:10])
    hit = same & (slot >= 0)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6, atol=1e-7)
    assert np.isinf(t[same & (slot < 0)]).all()


def test_package_imports_no_jax():
    """No file of gpu_pathtracer_tpu_torch, nor chip_smoke.py, bench_torch.py or
    bench_scaling_torch.py, imports jax or anything of the reference package
    `gpu_pathtracer_tpu`, none of them imports chip_smoke, and
    bench_scaling_torch.py does not import bench_torch (AST scan: jax is
    already loaded in this process, so sys.modules cannot tell here;
    tests/test_torch_host.py asks a fresh interpreter)."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((repo / "gpu_pathtracer_tpu_torch").rglob("*.py")) + [
        repo / "chip_smoke.py", repo / "bench_torch.py", repo / "bench_scaling_torch.py"]
    assert len(files) >= 30
    assert {"sppm.py", "splat.py", "anyhit.py", "hashgrid.py", "bounding_sphere.py", "dist.py",
            "shard.py", "sppm_shard.py", "launch.py", "bench_scaling_torch.py"} <= {
        f.name for f in files}
    offenders = []
    refused_everywhere = ("jax", "jaxlib", "flax", "optax", "orbax", "gpu_pathtracer_tpu",
                          "chip_smoke")
    for f in files:
        refused = refused_everywhere + (
            ("bench_torch",) if f.name == "bench_scaling_torch.py" else ())
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                if n.split(".")[0] in refused:
                    offenders.append(f"{f.relative_to(repo)}: {n}")
    assert not offenders, offenders


def _port_modules(repo):
    pkg = repo / "gpu_pathtracer_tpu_torch"
    return {str(f.relative_to(pkg)): ast.parse(f.read_text()) for f in sorted(pkg.rglob("*.py"))}


def test_render_layer_has_no_kernel_abi():
    """No module under gpu_pathtracer_tpu_torch/render/ imports ctypes or
    `ops._build`: the kernels' calling convention stays in ops/ (AST scan)."""
    modules = _port_modules(pathlib.Path(__file__).resolve().parents[1])
    render = {name: tree for name, tree in modules.items() if name.startswith("render/")}
    assert {"render/integrator.py", "render/sppm.py"} <= render.keys()
    offenders = []
    for name, tree in render.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                found = [f"{node.module}.{a.name}" for a in node.names] + [node.module or ""]
            else:
                continue
            offenders += [f"{name}: {n}" for n in found
                          if n.split(".")[0] == "ctypes" or n.endswith("ops._build")]
    assert not offenders, offenders


def test_only_the_build_module_binds_native_code():
    """Outside ops/_build.py no module of the port sets `argtypes` or opens a
    `ctypes.CDLL`, apart from utils/native.py (the host parser's binding, a
    copy of the JAX package's module) (AST scan)."""
    modules = _port_modules(pathlib.Path(__file__).resolve().parents[1])
    binders = set()
    for name, tree in modules.items():
        for node in ast.walk(tree):
            sets_argtypes = isinstance(node, ast.Attribute) and node.attr == "argtypes" and (
                isinstance(node.ctx, ast.Store))
            opens = isinstance(node, ast.Call) and (
                getattr(node.func, "attr", None) == "CDLL" or getattr(node.func, "id", None) == "CDLL")
            if sets_argtypes or opens:
                binders.add(name)
    assert binders == {"ops/_build.py", "utils/native.py"}, binders


@pytest.mark.parametrize("n,r", [(50, 64), (700, 256), (1300, 512)])
def test_plain_matches_pallas(n, r):
    tris, tol, valid, o, d = _soup(n + r, n, r)
    cols, aabb = pallas_trace.pack_tri_cols(jnp.asarray(tris), jnp.asarray(tol), jnp.asarray(valid))
    jt, jslot, _ = pallas_trace.closest_hit_pallas(cols, aabb, o, d, interpret=True)
    tiles, taabb = _port_tiles(tris, tol, valid)
    t, slot, hit = closest_hit.closest_hit_tiles(tiles, taabb, _t(o), _t(d))
    assert tracing.totals["launch.closest_hit"] == 0  # CPU: plain version only
    _assert_agree(t, slot, jt, jslot)
    assert hit.numpy().mean() > 0.05  # the soup is hit, so slots are informative


def test_plain_t_max_and_padding_match_pallas():
    """Ragged ray and triangle counts, one invalid triangle, per-ray t_max."""
    n, r = 130, 100
    tris, tol, valid, _, d = _soup(7, n, r, invalid=[5])
    o = np.zeros((r, 3), np.float32)
    t_max = np.random.default_rng(8).uniform(0.5, 4.0, r).astype(np.float32)
    cols, aabb = pallas_trace.pack_tri_cols(jnp.asarray(tris), jnp.asarray(tol), jnp.asarray(valid))
    jt, jslot, _ = pallas_trace.closest_hit_pallas(cols, aabb, o, d, t_max, interpret=True)
    tiles, taabb = _port_tiles(tris, tol, valid)
    t, slot, _ = closest_hit.closest_hit_tiles(tiles, taabb, _t(o), _t(d), _t(t_max))
    _assert_agree(t, slot, jt, jslot)
    assert not (slot.numpy() == 5).any()


def test_sorted_dead_rays_match_pallas(monkeypatch):
    """closest_hit_sorted with a live mask: rays are coherence-sorted (the
    threshold is lowered so this batch sorts), dead rays get a budget of -1
    and miss; live rays match the Pallas path through its own sort."""
    monkeypatch.setattr(jtrace, "RAY_SORT_MIN", 64)
    monkeypatch.setattr(trace, "RAY_SORT_MIN", 64)
    n, r = 1300, 384
    tris, tol, valid, o, d = _soup(11, n, r)
    live = np.random.default_rng(12).random(r) < 0.6
    cols, aabb = pallas_trace.pack_tri_cols(jnp.asarray(tris), jnp.asarray(tol), jnp.asarray(valid))
    jg = SimpleNamespace(p=jnp.asarray(tris), tol=jnp.asarray(tol), valid=jnp.asarray(valid),
                         tri_cols=cols, tile_aabb=aabb)
    jt, jslot, _ = jtrace.closest_hit_pallas_sorted(jg, o, d, live=jnp.asarray(live))
    tiles, taabb = _port_tiles(tris, tol, valid)
    g = SimpleNamespace(p=_t(tris), tiles=tiles, tile_aabb=taabb)
    t, slot, hit = trace.closest_hit_sorted(g, _t(o), _t(d), live=_t(live))
    _assert_agree(t, slot, jt, jslot)
    assert not hit.numpy()[~live].any() and (slot.numpy()[~live] == -1).all()
    # the permutation is the reference's for the same tile boxes (stable sort)
    jperm = jtrace._coherence_perm(jg, o, d, jnp.asarray(live))
    perm = trace.coherence_perm(SimpleNamespace(tile_aabb=_t(np.asarray(aabb))), _t(o), _t(d), _t(live))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_pack_tiles_layout_matches_pallas_rows():
    """Rows 0-9 of the reference's tile columns at the same tile width are
    the port's tiles; empty rows have tol = inf; empty tiles are inverted."""
    tris, tol, valid, _, _ = _soup(3, 300, 1, invalid=[0, 299])
    tiles, taabb = _port_tiles(tris, tol, valid)
    cols, aabb = pallas_trace.pack_tri_cols(
        jnp.asarray(tris), jnp.asarray(tol), jnp.asarray(valid), tile=closest_hit.TILE)
    assert tiles.shape == (3, 10, closest_hit.TILE) and tiles.dtype == torch.float32
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(cols)[:, :10])
    np.testing.assert_array_equal(taabb.numpy(), np.asarray(aabb))
    flat_tol = tiles[:, 9].reshape(-1).numpy()
    assert np.isinf(flat_tol[[0, 299]]).all() and np.isinf(flat_tol[300:]).all()
    empty, eaabb = _port_tiles(tris[:1], tol[:1], np.zeros(1, bool))
    assert empty.shape[0] == 1 and (eaabb[:, 0:3] > eaabb[:, 3:6]).all()


def test_block_tile_order_and_root_exit_cap_match_jax():
    rng = np.random.default_rng(5)
    nt, nb, rb = 9, 6, 32
    lo = rng.uniform(-2, 2, (nt, 3)).astype(np.float32)
    aabb = np.concatenate([lo, lo + rng.uniform(0, 1, (nt, 3)), np.zeros((nt, 2))], 1).astype(np.float32)
    aabb[4, 0:3], aabb[4, 3:6] = 3.4e38, -3.4e38  # an empty (inverted) tile
    o, d = torch_parity.random_rays(rng, nb * rb, 2.5)
    o[: rb * 2] = o[0]  # equal blocks -> many lb ties, resolved by the stable sort
    rays = np.concatenate([o, d, np.zeros((nb * rb, 2), np.float32)], 1)
    np.testing.assert_array_equal(
        closest_hit.block_tile_order(_t(rays), _t(aabb), nb).numpy(),
        np.asarray(pallas_trace._block_tile_order(jnp.asarray(rays), jnp.asarray(aabb), nb)),
    )
    t_max = rng.uniform(0.1, 5, nb * rb).astype(np.float32)
    t_max[:10] = np.inf
    cap = closest_hit.root_exit_cap(_t(aabb), _t(o), _t(d), _t(t_max))
    jcap = pallas_trace._root_exit_cap(jnp.asarray(aabb), o, d, jnp.asarray(t_max))
    np.testing.assert_array_equal(cap.numpy(), np.asarray(jcap))
    assert (cap.numpy() == -1).any() and (cap.numpy() > 0).any()


def test_prepare_rays_pads_with_zero_budget_rays():
    rng = np.random.default_rng(6)
    o, d = torch_parity.random_rays(rng, 130)
    aabb = _t(np.array([[-1, -1, -1, 1, 1, 1, 0, 0]], np.float32))
    rays = closest_hit.prepare_rays(aabb, _t(o), _t(d))
    assert rays.shape == (256, 8) and rays.dtype == torch.float32
    pad = rays[130:].numpy()
    assert (pad[:, 5] == 1).all() and (pad[:, [0, 1, 2, 3, 4, 6, 7]] == 0).all()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc -> a clear RuntimeError, and nothing half-built is left."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "CUDA_ROOTS", (str(tmp_path / "no_cuda_either"),))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("closest_hit")
    assert not (tmp_path / "build").exists()


def test_build_hash_covers_included_headers(monkeypatch, tmp_path):
    """A kernel's build is keyed by its source and by every header it
    includes with quotes, directly or through another header."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n  #  include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int kB = 1;\n")
    (tmp_path / "other.cuh").write_text("constexpr int kOther = 1;\n")
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("constexpr int kOther = 2;\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("#pragma once\nconstexpr int kB = 2;\n")
    second = _build.library_path("k")
    assert second != first and second.name == "libk.so"
    # the real kernels share the walk's header, the ring kernels also the ring's
    monkeypatch.undo()
    for name in ("closest_hit", "anyhit"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "closest_hit_common.cuh"]
    for name in ("closest_hit_pipe", "closest_hit_mxu", "anyhit_pipe"):
        assert sorted(p.name for p in _build.sources(name)) == sorted(
            [f"{name}.cu", "closest_hit_common.cuh", "tile_ring.cuh"])


def test_arg_block_refuses_a_field_list_of_the_wrong_length():
    """The int64 argument block of an N1/N2-style entry point holds exactly
    the kernel's slots: a short list would hand the kernel zeros for
    pointers, a long one fields it never reads."""
    block = _build.arg_block([1, 2, -3], 3)
    assert list(block) == [1, 2, -3]
    for fields in ([1, 2], [1, 2, 3, 4]):
        with pytest.raises(ValueError, match="3 slots"):
            _build.arg_block(fields, 3)


def test_launch_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version for a tensor it was
    handed: CPU tensors are refused, not silently computed."""
    rays = torch.zeros((128, 8))
    tiles, aabb = closest_hit.pack_tiles(torch.zeros((1, 3, 3)), torch.ones(1), torch.ones(1, dtype=torch.bool))
    order = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        closest_hit.launch_closest_hit(rays, tiles, aabb, order)


def test_winner_bary_matches_jax():
    tris, tol, valid, o, d = _soup(13, 200, 300)
    tiles, taabb = _port_tiles(tris, tol, valid)
    _, slot, hit = closest_hit.closest_hit_tiles(tiles, taabb, _t(o), _t(d))
    jb = jtrace.winner_bary(jnp.asarray(tris), jnp.asarray(tol), o, d,
                            jnp.asarray(slot.numpy()), jnp.asarray(hit.numpy()))
    b = trace.winner_bary(_t(tris), _t(tol), _t(o), _t(d), slot, hit)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)
