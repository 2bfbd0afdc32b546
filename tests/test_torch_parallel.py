"""Scale-out of the port (`gpu_pathtracer_tpu_torch/parallel/`) on two real
gloo processes, against the single-process renders and against the JAX
package's photon-map all-gather.

One job of two ranks (started like `tests/test_multiprocess.py`, with the
`GPT_TPU_*` variables) runs every sharded function at 16x16 on the Cornell box
(spp 2, level 3) and the SPPM box (256 photons, 4 bounces); rank 0 saves the
results, and while the ranks run this process computes the references:

* `render_image_distributed` (also at 15x15, where the ranks' columns
  differ in width) and `render_from_config` with `shard_rays 1`: bit for bit
  `render_image` (the columns of a chunk are traced by the rank
  that owns them from the numbers the whole chunk draws);
* `render_image_shard_map`: deterministic, its mean within 0.3x of the
  unsharded render's (`tests/test_parallel.py`'s bound);
* `train_step_distributed` against the single-process step (rtol 1e-5);
* `photon_pass_distributed` against the two rank streams traced in one
  process (`photon_pass_local`), and, fed each rank's uniforms derived from
  JAX's shard key, against JAX's `photon_pass_distributed` on two devices;
* the sharded eye pass with compaction (1,600 rays, one 1,024-ray stage)
  against the unsharded one;
* `render_sppm_distributed` (the grid gathers forced) against `render_sppm`
  with the rank streams emulated, and the sharded `sppm_loss_fn` step against
  the emulated one (loss rtol 1e-5, gradient rtol 1e-4 / atol 1e-7).

The launch cannot stall or race: each rank writes its output to a file (no
pipe to fill while the references run), rank 0 binds the rendezvous port
that the OS picks and hands it on (`chip_smoke.rendezvous`), gloo is pinned
to the loopback interface, and the job has one time limit counted from the
ranks' start, besides the process group's limit on any one wait.  A rank
that fails is named with its exit code or signal, its seconds and the tail
of its log (each rank logs the seconds at which it ends each part).
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_parity
from gpu_pathtracer_tpu_torch import optim, tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.parallel import shard, sppm_shard
from gpu_pathtracer_tpu_torch.render import sppm
from gpu_pathtracer_tpu_torch.render.integrator import render_image, render_image_value_and_grad
from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

REPO = pathlib.Path(__file__).resolve().parents[1]
SIDE, SPP, LEVEL, WEIGHT, SEED = 16, 2, 3, 0.5, 7
PHOTONS, BOUNCE, PASSES = 256, 4, 2
COMPACT_SIDE = 40  # 1,600 rays: one compaction stage of 1,024
ODD = 15  # 225 pixels: the ranks' columns differ in width
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
JAX_KEY = 3
# the ranks take ~8 s on an idle 8-CPU box and 23 s on 2 CPUs beside the
# other five workers of the tier-1 run: 10x and 5x that
RANK_TIMEOUT = 240  # seconds from the ranks' start to their exit
GROUP_TIMEOUT = 120  # seconds that the rendezvous or one collective may wait
GRID_MIN_PAIRS = 1000  # the forward SPPM render takes the hash-grid gathers at 16x16

CHILD = r'''
import functools, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import numpy as np
import torch
torch.set_num_threads(1)
from gpu_pathtracer_tpu_torch import optim, renderer, tracing
from gpu_pathtracer_tpu_torch.parallel import dist as pdist, shard, sppm_shard
from gpu_pathtracer_tpu_torch.render import sppm
from gpu_pathtracer_tpu_torch.utils import config
import chip_smoke
import test_torch_parallel as T

store = chip_smoke.rendezvous(int(os.environ["MP_RANK"]), 2,
                              os.path.join(os.environ["MP_DIR"], "port"), T.GROUP_TIMEOUT)
assert pdist.init_distributed(timeout=T.GROUP_TIMEOUT)
mesh = shard.make_mesh(device="cpu")
assert mesh.size == 2
step = lambda name: print(f"{time.perf_counter() - t0:7.1f} s  {name}", flush=True)
step("process group")
sppm.GRID_MIN_PAIRS = T.GRID_MIN_PAIRS
cornell, box, cam, cam40 = T.scenes(os.environ["MP_DIR"])
cam_odd = T.Camera.create(**T.CAM, width=T.ODD, height=T.ODD)
out = {}
with torch.no_grad():
    out["gspmd"] = shard.render_image_distributed(
        cornell, cam, T.SIDE, T.SIDE, mesh, generator=torch.Generator().manual_seed(T.SEED),
        **T.PT_KW).numpy()
    out["gspmd_odd"] = shard.render_image_distributed(
        cornell, cam_odd, T.ODD, T.ODD, mesh, generator=torch.Generator().manual_seed(T.SEED),
        **T.PT_KW).numpy()
    out["config"] = renderer.render_from_config(
        config.parse_master_file(os.path.join(os.environ["MP_DIR"], "shard_master.txt")),
        device="cpu")
    for run in range(2):
        out[f"shard_map_{run}"] = shard.render_image_shard_map(
            cornell, cam, T.SEED, T.SIDE, T.SIDE, mesh, **T.PT_KW).numpy()
step("renders")
loss, new = shard.train_step_distributed(
    cornell, cam, T.train_params(cornell), T.train_target(), torch.Generator().manual_seed(11),
    mesh, width=T.SIDE, height=T.SIDE, **T.PT_KW)
out["train_loss"], out["train_ke"] = float(loss), new["ke"].numpy()
step("train step")
with torch.no_grad():
    ph = sppm_shard.photon_pass_distributed(box, T.PHOTONS, mesh, max_bounce=T.BOUNCE,
                                            generator=T.photon_generator())
    out.update({f"photons_{k}": v.numpy() for k, v in T.photon_fields(ph).items()})
    uni = np.load(os.environ["MP_UNIFORMS"])
    mine = {k.split("_", 1)[1]: torch.from_numpy(uni[k]) for k in uni.files
            if k.startswith(f"{mesh.rank}_")}
    ph = sppm_shard.photon_pass_distributed(box, T.PHOTONS, mesh, max_bounce=T.BOUNCE,
                                            uniforms=mine)
    out.update({f"jax_photons_{k}": v.numpy() for k, v in T.photon_fields(ph).items()})
    step("photon passes")
    n = T.COMPACT_SIDE * T.COMPACT_SIDE
    cols = sppm.Columns.share(mesh, n)
    pi, pj = T.pixels(T.COMPACT_SIDE)
    eye = sppm.eye_pass(box, cam40, pi[cols.lo:cols.hi], pj[cols.lo:cols.hi], None,
                        torch.full((cols.hi - cols.lo,), float("inf")), init=False,
                        max_bounce=16, compact_min=1, generator=torch.Generator().manual_seed(6),
                        cols=cols)
    for i, x in enumerate(eye):
        out[f"eye_{i}"] = mesh.all_gather(x).numpy()
    step("eye pass")
    out["sppm"] = sppm_shard.render_sppm_distributed(box, cam, T.sppm_config(os.environ["MP_DIR"]),
                                                     T.SEED, mesh)
step("sppm render")
loss, grads = T.sppm_step(box, cam, functools.partial(sppm_shard.photon_pass_distributed,
                                                      mesh=mesh), mesh)
step("sppm loss step")
out["sppm_loss"], out["sppm_grad"] = float(loss), grads["ke"].numpy()
if mesh.rank == 0:
    np.savez(os.environ["MP_OUT"], **out)
step(f"rank {mesh.rank} ok, collectives {tracing.counts('collective.')}")
'''

PT_KW = dict(sample_size=SPP, level=LEVEL, hittable_pdf_weight=WEIGHT)


# ---------------------------------------------------------------------------
# shared by the ranks and the references (the ranks import this module)
# ---------------------------------------------------------------------------

def make_folders(root) -> None:
    """The Cornell box with spheres and its `shard_rays 1` master file; the
    SPPM box (the light given a diffuse component) and its master file."""
    root = pathlib.Path(root)
    testscenes.make_cornell_box(root / "cornell", spheres=True, sphere_subdiv=2)
    testscenes.make_cornell_box(root / "box", spheres=True, sphere_subdiv=0)
    mtl = root / "box" / "box.mtl"
    mtl.write_text(mtl.read_text().replace("newmtl light\nKd 0 0 0",
                                           "newmtl light\nKd 0.78 0.78 0.78"))
    master = testscenes.cornell_master_file(root / "cornell", width=SIDE, height=SIDE, spp=SPP,
                                            level=LEVEL)
    cfg = config.parse_master_file(master)
    cfg.hittable_pdf_weight, cfg.seed, cfg.shard_rays = WEIGHT, SEED, True
    cfg.focus_dist = 1.0  # `CAM`'s camera (the aperture is 0: one lens sample a pixel)
    config.write_master_file(cfg, root / "shard_master.txt")
    box = root / "box"
    config.write_master_file(config.RenderConfig(
        input_folder_path=f"{box}/", obj_filename="box.obj", image_output_path=str(box / "s.ppm"),
        image_width=SIDE, image_height=SIDE, render_mode=2, ppm_num_photon_per_pass=PHOTONS,
        ppm_num_pass=PASSES, ppm_max_bounce=BOUNCE, eye_x=0.5, eye_y=0.5, eye_z=2.4,
        center_x=0.5, center_y=0.5, center_z=0.0, fovy=40.0), root / "sppm_master.txt")


def scenes(root):
    root = pathlib.Path(root)
    cornell = build_scene(obj_io.load_scene(root / "cornell", "box.obj"), "cpu")
    box = build_scene(obj_io.load_scene(root / "box", "box.obj"), "cpu")
    return (cornell, box, Camera.create(**CAM, width=SIDE, height=SIDE),
            Camera.create(**CAM, width=COMPACT_SIDE, height=COMPACT_SIDE))


def sppm_config(root):
    return config.parse_master_file(pathlib.Path(root) / "sppm_master.txt")


def pixels(side: int):
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32),
                            torch.arange(side, dtype=torch.float32), indexing="ij")
    return ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5


def train_params(scene) -> dict:
    return {"ke": scene.materials.ke * 0.9}


def train_target() -> torch.Tensor:
    return torch.full((SIDE, SIDE, 3), 0.3)


def photon_generator() -> torch.Generator:
    return sppm.pass_generator(SEED, 1000, "cpu")


def photon_fields(ph) -> dict:
    return {k: getattr(ph, k) for k in ("pos", "color", "direction", "prev", "on_surface",
                                        "valid")}


def sppm_step(box, cam, photon_pass_fn, mesh=None):
    """One `sppm_loss_fn` step (d loss / d ke) through the grid gathers."""
    target = torch.full((SIDE, SIDE, 3), 0.05)
    kw = {} if mesh is None else dict(pixel_sharding=mesh)
    fn = optim.sppm_loss_fn(box, cam, target, n_photons=PHOTONS, num_pass=PASSES,
                            max_bounce=BOUNCE, eye_bounce=BOUNCE, seed=SEED, gather_grid=True,
                            photon_pass_fn=photon_pass_fn, **kw)
    return fn({"ke": box.materials.ke})


# ---------------------------------------------------------------------------
# the job and the references
# ---------------------------------------------------------------------------

def _failure(rank: int, rc: int, seconds: float, timed_out: bool, log: pathlib.Path) -> str:
    how = chip_smoke.exit_reason(rc)
    if timed_out:
        how += f" at the job's limit of {RANK_TIMEOUT} s"
    return f"rank {rank} {how} after {seconds:.1f} s; its log ends:\n{log.read_text()[-4000:]}"


def _jax_photons(n_ranks: int):
    """JAX's `photon_pass_distributed` on `n_ranks` virtual devices, and each
    rank's uniforms for the port derived from JAX's shard key."""
    from gpu_pathtracer_tpu.parallel.shard import make_mesh as jax_mesh
    from gpu_pathtracer_tpu.parallel.sppm_shard import photon_pass_distributed as jax_pass

    jscene, _ = torch_parity.sppm_scenes(False)
    key = jax.random.key(JAX_KEY)
    ph = jax_pass(jscene, key, n_photons=PHOTONS, mesh=jax_mesh(jax.devices()[:n_ranks]),
                  max_bounce=BOUNCE)
    uniforms = {}
    for r in range(n_ranks):
        rkey = jax.random.fold_in(jax.random.fold_in(key, 0x5BBD << 12), r)
        u = torch_parity.photon_uniforms_from_key(rkey, PHOTONS // n_ranks, BOUNCE)
        uniforms.update({f"{r}_{k}": v for k, v in u.items()})
    return {k: np.asarray(getattr(ph, k)) for k in ("pos", "color", "valid")}, uniforms


def _references(root) -> dict:
    torch.set_num_threads(1)
    cornell, box, cam, cam40 = scenes(root)
    ref = {}
    with torch.no_grad():
        ref["image"] = render_image(cornell, cam, SIDE, SIDE,
                                    generator=torch.Generator().manual_seed(SEED),
                                    **PT_KW).numpy()
        ref["image_odd"] = render_image(cornell, Camera.create(**CAM, width=ODD, height=ODD), ODD,
                                        ODD, generator=torch.Generator().manual_seed(SEED),
                                        **PT_KW).numpy()
    params = train_params(cornell)
    leaves = [params["ke"].detach().requires_grad_(True)]
    target = train_target()
    loss, _, (grad,) = render_image_value_and_grad(
        optim._substitute(cornell, {"ke": leaves[0]}), cam, SIDE, SIDE,
        lambda img: torch.mean((img - target) ** 2), leaves,
        generator=torch.Generator().manual_seed(11), **PT_KW)
    ref["train_loss"], ref["train_ke0"] = float(loss), params["ke"].numpy()
    ref["train_ke"] = torch.clamp(params["ke"] - 0.05 * grad, min=0.0).numpy()
    emulate = functools.partial(sppm_shard.photon_pass_local, n_shards=2)
    grid_min = sppm.GRID_MIN_PAIRS
    sppm.GRID_MIN_PAIRS = GRID_MIN_PAIRS
    try:
        with torch.no_grad():
            ph = emulate(box, PHOTONS, max_bounce=BOUNCE, generator=photon_generator())
            ref.update({f"photons_{k}": v.numpy() for k, v in photon_fields(ph).items()})
            pi, pj = pixels(COMPACT_SIDE)
            eye = sppm.eye_pass(box, cam40, pi, pj, None, torch.full((pi.shape[0],), float("inf")),
                                init=False, max_bounce=16, compact_min=1,
                                generator=torch.Generator().manual_seed(6))
            ref.update({f"eye_{i}": x.numpy() for i, x in enumerate(eye)})
            ref["sppm"] = sppm.render_sppm(box, cam, sppm_config(root), SEED,
                                           n_photons_override=PHOTONS, photon_pass_fn=emulate)
        loss, grads = sppm_step(box, cam, emulate)
    finally:
        sppm.GRID_MIN_PAIRS = grid_min
    ref["sppm_loss"], ref["sppm_grad"] = float(loss), grads["ke"].numpy()
    return ref


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(rank 0's results, the single-process references, JAX's photon map)."""
    root = tmp_path_factory.mktemp("parallel")
    make_folders(root)
    jax_map, uniforms = _jax_photons(2)
    np.savez(root / "uniforms.npz", **uniforms)
    procs, logs = [], [root / f"rank{pid}.log" for pid in range(2)]
    t0 = time.monotonic()
    for pid in range(2):
        env = dict(os.environ, MP_RANK=str(pid), MP_DIR=str(root), MP_OUT=str(root / "out.npz"),
                   MP_UNIFORMS=str(root / "uniforms.npz"), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="", GLOO_SOCKET_IFNAME="lo", PYTHONUNBUFFERED="1")
        with open(logs[pid], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD % {"repo": str(REPO), "tests": str(REPO / "tests")}],
                env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT))
    timed_out = False
    try:
        ref = _references(root)
        for p in procs:
            p.wait(timeout=max(0.0, t0 + RANK_TIMEOUT - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.monotonic() - t0
    for pid, p in enumerate(procs):
        assert p.returncode == 0, _failure(pid, p.returncode, seconds, timed_out, logs[pid])
    got = dict(np.load(root / "out.npz"))
    return got, ref, jax_map


def _bit_for_bit(a, b):
    """Equal bits on every pixel, or on >= 99.9% of them with the rest within
    atol 1e-6 / rtol 1e-5 (a coplanar tie that a rank's ray groups break
    otherwise; the JAX package's own tolerance)."""
    same = (a == b).all(axis=-1)
    if same.all():
        return
    assert same.mean() >= 0.999, f"{int((~same).sum())} of {same.size} pixels differ"
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gspmd", "config", "gspmd_odd"])
def test_sharded_path_tracing_is_the_unsharded_render(two_ranks, name):
    """`render_image_distributed`, `shard_rays` through the renderer, and the
    former at 15x15 (a chunk of 225 columns: the ranks hold 112 and 113)."""
    got, ref, _ = two_ranks
    want = ref["image_odd" if name == "gspmd_odd" else "image"]
    assert got[name].shape == want.shape and got[name].mean() > 0
    _bit_for_bit(got[name], want)


def test_shard_map_render_deterministic_and_unbiased(two_ranks):
    got, ref, _ = two_ranks
    a, b = got["shard_map_0"], got["shard_map_1"]
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.shape == (SIDE, SIDE, 3)
    assert abs(a.mean() - ref["image"].mean()) < 0.3 * ref["image"].mean()
    assert not np.array_equal(a, ref["image"])  # the rank streams are others


def test_train_step_matches_single_process(two_ranks):
    got, ref, _ = two_ranks
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["train_ke"], ref["train_ke"], rtol=1e-5, atol=1e-7)
    assert not np.array_equal(got["train_ke"], ref["train_ke0"])


@pytest.mark.parametrize("source", ["streams", "jax"])
def test_photon_map_allgather(two_ranks, source):
    """The map of two ranks: against the rank streams traced in one process
    (`valid` equal, every field rtol 1e-6), or against JAX's on two devices
    fed each rank's uniforms from JAX's shard key (`valid` equal, positions
    and colours to the tolerances of `tests/test_torch_sppm.py`'s
    photon-pass case)."""
    got, ref, jax_map = two_ranks
    if source == "streams":
        np.testing.assert_array_equal(got["photons_valid"], ref["photons_valid"])
        np.testing.assert_array_equal(got["photons_on_surface"], ref["photons_on_surface"])
        v = ref["photons_valid"]
        assert v.sum() > 20
        for k in ("pos", "color", "direction", "prev"):
            np.testing.assert_allclose(got[f"photons_{k}"][v], ref[f"photons_{k}"][v], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        return
    tv, jv = got["jax_photons_valid"], jax_map["valid"]
    np.testing.assert_array_equal(tv, jv)
    both = tv & jv
    assert both.sum() > 20
    for k in ("pos", "color"):
        np.testing.assert_allclose(got[f"jax_photons_{k}"][both], jax_map[k][both], rtol=1e-4,
                                   atol=5e-5, err_msg=k)


def test_sharded_eye_pass_compaction(two_ranks):
    """1,600 rays on two ranks with one compaction stage: every output is the
    unsharded pass's (the live rays take the stage's columns rank by rank)."""
    got, ref, _ = two_ranks
    valid = ref["eye_5"]
    np.testing.assert_array_equal(got["eye_5"], valid)
    assert valid.mean() > 0.5
    for i in range(5):
        a, b = got[f"eye_{i}"][valid], ref[f"eye_{i}"][valid]
        _bit_for_bit(a, b)


def test_sppm_render_distributed(two_ranks):
    """`render_sppm_distributed` against `render_sppm` with the rank streams
    emulated, both through the grid gathers: rtol 1e-5, atol 1e-7."""
    got, ref, _ = two_ranks
    assert got["sppm"].shape == (SIDE, SIDE, 3) and got["sppm"].mean() > 0
    np.testing.assert_allclose(got["sppm"], ref["sppm"], rtol=1e-5, atol=1e-7)


def test_sharded_sppm_loss_step(two_ranks):
    """The sharded `sppm_loss_fn` step against the emulated one: loss rtol
    1e-5, d loss / d ke rtol 1e-4 (atol 1e-7), nonzero."""
    got, ref, _ = two_ranks
    np.testing.assert_allclose(got["sppm_loss"], ref["sppm_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["sppm_grad"], ref["sppm_grad"], rtol=1e-4, atol=1e-7)
    assert np.abs(ref["sppm_grad"]).max() > 0


def test_rank_streams_apart_from_pass_and_step_seeds():
    """The photon and shard-map rank streams' seeds (ranks < 16, passes <
    4,096) are distinct and are none of the run's `pass_generator` or
    `step_generator` seeds."""
    for seed in (0, SEED, 2**31 - 2):
        plain = {(seed << 20) + i for i in range(1000 + 4096)}  # step, init and pass seeds
        ranks = set()
        for it in range(4096):
            base = sppm_shard.photon_base_seed(sppm.pass_generator(seed, 1000 + it, "cpu"))
            ranks.update(shard.shard_seed(base, r, sppm_shard.PHOTON_TAG) for r in range(16))
        ranks.update(shard.shard_seed(seed, r, shard.SHARD_MAP_TAG) for r in range(16))
        assert len(ranks) == 4096 * 16 + 16
        assert not ranks & plain
        assert optim.step_generator(seed, 5, "cpu").initial_seed() in plain


def test_mesh_of_one_process():
    """Without a process group the mesh is this process alone: no collective
    is issued, and every gather and reduction returns its input."""
    mesh = shard.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    before = sum(tracing.counts("collective.").values())
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_gather(x) is x and mesh.all_reduce(x, "max") is x
    assert mesh.columns(10) == slice(0, 10) and shard.Mesh(None, 1, 3, "cpu").bounds(10) == [
        (0, 3), (3, 6), (6, 10)]
    assert sum(tracing.counts("collective.").values()) == before
    from gpu_pathtracer_tpu_torch.parallel import dist as pdist
    assert pdist.host_local_slice(8, mesh) == slice(0, 8)


def test_material_gather_backward_sums_in_float64():
    """The material table's row gather sums its backward in float64: a
    gradient summed over 65,536 rays whole, or in two halves as two ranks
    sum it, is the float64 sum rounded once (a float32 running sum drifts by
    ~1e-4 of it, and the halves' by another amount)."""
    from gpu_pathtracer_tpu_torch.ops import materials

    rng = np.random.default_rng(0)
    table = torch.rand((4, 3), generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    mat = torch.from_numpy(rng.integers(-1, 4, 65536)).to(torch.int32)
    g = torch.from_numpy(rng.random((65536, 3), dtype=np.float32) * 1e-3)
    (whole,) = torch.autograd.grad(materials._take(table, mat), table, g)
    halves = sum(torch.autograd.grad(materials._take(table, mat[s]), table, g[s])[0]
                 for s in (slice(0, 32768), slice(32768, None)))
    want = np.zeros((4, 3))
    np.add.at(want, np.clip(mat.numpy(), 0, None), g.numpy().astype(np.float64))
    np.testing.assert_allclose(whole.numpy(), want, rtol=2e-7)
    np.testing.assert_allclose(halves.numpy(), want, rtol=2e-7)
    with torch.no_grad():  # no record: the plain float32 gather, the same values
        assert torch.equal(materials._take(table, mat), table[torch.clamp(mat, min=0).long()])
