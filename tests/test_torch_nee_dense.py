"""The dense light tree's NEE/MIS kernel (`csrc/nee_dense.cu`) and the NEE/MIS
stage's rule for taking it (`lights.nee`).

This file imports no JAX.  The card's tests are marked `cuda` and skip
without an NVIDIA GPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nee_dense.py -q

They hold the kernel to its plain version, `lights.nee_dense_reference`, on
the inputs that `trace_paths` hands it (recorded through the integrator's
call) and on edited inputs for the edge cases.  Tolerances: next_dir,
filter and factor within rtol 1e-5 (the plain version sums the log-pdfs in
cuBLAS's order, the kernel along each leaf's path, and on another card or
torch build aten's reductions may group their sums otherwise), and the
picked emitter the same on >= 99.999% of the rays that take the light (a
pick splits only where u * total lands within rounding of a prefix sum).
A card render with the kernel matches one without it within 1e-4 relative
on >= 99.9% of pixels.

The CPU tests check the routing: one `launch.nee_dense` a wavefront step
for a dense scene rendered without gradients, none for the sparse regime,
a gradient render or rays that require grad (the kernel's launcher is
stood in for by a counting spy, since a CPU tensor takes the plain
version), and the plain path equal to the torch path bit for bit.  One
more checks that the kernels' derived tables follow in-place writes to the
tensors they come from.
"""

import dataclasses

import pytest
import torch

from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import linalg, lights, materials
from gpu_pathtracer_tpu_torch.render import integrator
from gpu_pathtracer_tpu_torch.render.integrator import render_image, render_image_value_and_grad
from gpu_pathtracer_tpu_torch.utils import obj_io, testscenes

CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)


def _cornell(folder):
    return testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=1)


def _one_emitter(folder):
    """The Cornell box with one triangle of its light quad: E = 1."""
    obj, mtl = _cornell(folder)
    lines = (folder / obj).read_text().splitlines()
    light = lines.index("usemtl light")
    del lines[light + 6]  # the quad's second face
    (folder / obj).write_text("\n".join(lines) + "\n")
    return obj, mtl


def _panel(folder):
    return testscenes.make_emitter_panel(folder, nx=4, ny=4)  # E = 32


def _scene(folder, make, dev):
    obj, _ = make(folder)
    return build_scene(obj_io.load_scene(folder, obj), dev)


def _render(scene, side, spp, level, dev, seed=1):
    w, h = side
    with torch.no_grad():
        return render_image(scene, Camera.create(**CAM, width=w, height=h, device=dev), w, h,
                            sample_size=spp, level=level, hittable_pdf_weight=0.5,
                            ray_chunk=w * h,
                            generator=torch.Generator(device=dev).manual_seed(seed))


def _spy(monkeypatch, record=None):
    """Stand in for the NEE/MIS stage's call of `lights.nee_dense`: count it
    as the launch it makes on the card, keep its arguments, run the real one."""
    real = lights.nee_dense

    def spy(*args):
        tracing.count("launch.nee_dense")
        if record is not None:
            record.append(args)
        return real(*args)

    monkeypatch.setattr(lights, "nee_dense", spy)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _recorded_steps(tmp_path, make, dev, monkeypatch, level=4):
    scene = _scene(tmp_path, make, dev)
    steps = []
    _spy(monkeypatch, steps)
    _render(scene, (256, 256), 1, level, dev)
    monkeypatch.undo()
    return scene.light_tree, steps


def _kernel_pick(lt, ref, u, next_dir):
    """The emitter whose sampled point lies along `next_dir`, (R,)."""
    leaves = torch.arange(lt.num_lights, device=ref.origin.device)
    target = lights.sample_point_on_light(lt, leaves[None, :], u[2][:, None], u[3][:, None])
    dirs = linalg.normalize(target - ref.origin[:, None, :], 1e-5)
    return torch.argmin(torch.sum((dirs - next_dir[:, None, :]) ** 2, dim=-1), dim=-1)


def _assert_same(a, b):
    torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


def _assert_kernel_matches_plain(lt, args, picks=True):
    _, ref, normal, coming, weight, u, do_nee = args
    with torch.no_grad():
        got = lights.launch_nee_dense(lt, ref, normal, coming, weight, u, do_nee)
        want = lights.nee_dense_reference(lt, ref, normal, coming, weight, u, do_nee)
    torch.cuda.synchronize()
    same = torch.ones_like(do_nee)
    if picks:
        pivot = torch.where(ref.diffuse[..., None], normal, ref.perfect_dir)
        plain_pick = lights.pick_light_dense(lt, lights.leaf_node_pdfs(lt, ref.origin, pivot), u[1])
        took = do_nee & (u[0] < torch.where(torch.isinf(ref.n), 0.0, weight))
        same = ~took | (_kernel_pick(lt, ref, u, got[0]) == plain_pick.long())
        assert float(same[took].float().mean()) >= 0.99999, int((~same).sum())
    for a, b in zip(got, want):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-7, equal_nan=True)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell-0", "cornell-3", "one_emitter", "panel"])
def test_kernel_matches_plain_on_recorded_steps(cuda, case, tmp_path, monkeypatch):
    make, bounce, e = {"cornell-0": (_cornell, 0, 2), "cornell-3": (_cornell, 3, 2),
                       "one_emitter": (_one_emitter, 1, 1), "panel": (_panel, 1, 32)}[case]
    lt, steps = _recorded_steps(tmp_path, make, cuda, monkeypatch)
    assert lt.dense and lt.num_lights == e and len(steps) == 4
    before = tracing.totals["launch.nee_dense"]
    got, _ = _assert_kernel_matches_plain(lt, steps[bounce])
    assert tracing.totals["launch.nee_dense"] == before + 1
    do_nee = steps[bounce][-1]
    assert 0.1 < float(do_nee.float().mean()) and float((got[2][do_nee] > 0).float().mean()) > 0.1


@pytest.mark.cuda
def test_kernel_edge_cases(cuda, tmp_path, monkeypatch):
    """Rays without NEE pass the lobe's direction and filter with factor 1;
    a mirror lobe (n = inf) has w = 0 and takes no light; a light tree whose
    energies are all 0 has every branch ratio NaN, taken as 0.5; a pick
    uniform of 0 picks leaf 0.  (An all-zero pdf row cannot reach the
    kernel: sibling ratios sum to 1 and a NaN ratio becomes 0.5, so some
    leaf has a pdf >= 0.5^depth; `pick_light_dense` gives it pick 0, which
    `test_an_all_zero_pdf_row_picks_leaf_0` holds.)"""
    lt, steps = _recorded_steps(tmp_path, _cornell, cuda, monkeypatch)
    _, ref, normal, coming, weight, u, do_nee = steps[1]
    r = do_nee.shape[0]
    alt = torch.arange(r, device=cuda) % 3 == 0
    no_nee = do_nee & ~alt
    (dir_, filt, factor), _ = _assert_kernel_matches_plain(
        lt, (lt, ref, normal, coming, weight, u, no_nee))
    off = ~no_nee  # dead rays carry NaN directions through
    _assert_same(dir_[off], ref.dir[off])
    _assert_same(filt[off], ref.filter[off])
    assert bool((factor[off] == 1.0).all())

    mirror = dataclasses.replace(ref, n=torch.where(alt, float("inf"), ref.n))
    (dir_, _, _), _ = _assert_kernel_matches_plain(
        lt, (lt, mirror, normal, coming, weight, u, do_nee))
    _assert_same(dir_[alt], ref.dir[alt])

    dark = dataclasses.replace(lt, node_energy=torch.zeros_like(lt.node_energy))
    pivot = torch.where(ref.diffuse[..., None], normal, ref.perfect_dir)
    half = torch.tensor(0.5, device=cuda)
    assert torch.allclose(lights.leaf_node_pdfs(dark, ref.origin, pivot), half)
    _assert_kernel_matches_plain(dark, (dark, ref, normal, coming, weight, u, do_nee))

    u0 = u.clone()
    u0[1] = torch.where(alt, 0.0, u[1])
    u0[0] = 0.0  # every NEE ray takes the light
    (dir_, _, _), _ = _assert_kernel_matches_plain(
        lt, (lt, ref, normal, coming, weight, u0, do_nee))
    took = do_nee & alt & ~torch.isinf(ref.n)
    assert bool((_kernel_pick(lt, ref, u0, dir_)[took] == 0).all())


@pytest.mark.cuda
def test_render_with_and_without_the_kernel(cuda, tmp_path, monkeypatch):
    scene = _scene(tmp_path, _cornell, cuda)
    spp, level = 2, 8
    tracing.reset("launch.")
    with_kernel = _render(scene, (128, 128), spp, level, cuda)
    assert tracing.totals["launch.nee_dense"] == spp * level
    monkeypatch.setattr(lights, "NEE_DENSE_MAX_LIGHTS", 0)
    without = _render(scene, (128, 128), spp, level, cuda)
    assert tracing.totals["launch.nee_dense"] == spp * level
    close = torch.isclose(with_kernel, without, rtol=1e-4, atol=0.0).all(dim=-1)
    assert float(close.float().mean()) >= 0.999
    assert float(without.mean()) > 0.01


# ---------------------------------------------------------------------------
# The CPU: the routing rule and the plain path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return _scene(tmp_path_factory.mktemp("cornell"), _cornell, torch.device("cpu"))


CPU = torch.device("cpu")
SIDE, SPP, LEVEL = (8, 4), 2, 2


def test_one_launch_a_step_for_a_dense_render_without_gradients(cornell, tmp_path, monkeypatch):
    _spy(monkeypatch)
    tracing.reset("launch.")
    _render(cornell, SIDE, SPP, LEVEL, CPU)
    assert tracing.totals["launch.nee_dense"] == SPP * LEVEL
    panel = _scene(tmp_path, lambda f: testscenes.make_emitter_panel(f, nx=17, ny=16), CPU)
    assert not panel.light_tree.dense  # 544 emitters: the sparse regime
    _render(panel, SIDE, SPP, LEVEL, CPU)
    assert tracing.totals["launch.nee_dense"] == SPP * LEVEL
    # grad mode on: the kernel unless an input of the step requires grad
    w, h = SIDE
    cam = Camera.create(**CAM, width=w, height=h)
    o, d = cam.generate_rays(torch.rand(w * h) * h, torch.rand(w * h) * w,
                             torch.rand(w * h), torch.rand(w * h))
    integrator.trace_paths(cornell, o, d, level=LEVEL, hittable_pdf_weight=0.5,
                           generator=torch.Generator().manual_seed(2))
    assert tracing.totals["launch.nee_dense"] == SPP * LEVEL + LEVEL
    integrator.trace_paths(cornell, o.requires_grad_(True), d, level=LEVEL,
                           hittable_pdf_weight=0.5, generator=torch.Generator().manual_seed(2))
    assert tracing.totals["launch.nee_dense"] == SPP * LEVEL + LEVEL


def test_a_gradient_render_keeps_the_torch_path(tmp_path, monkeypatch):
    """`render_image_value_and_grad`'s `wrt` are scene tensors that require
    grad: neither its pass without a graph nor its replay takes the kernel."""
    scene = _scene(tmp_path, _cornell, CPU)
    kd = scene.materials.kd.requires_grad_(True)
    _spy(monkeypatch)
    tracing.reset("launch.")
    w, h = SIDE
    cam = Camera.create(**CAM, width=w, height=h)
    loss, _, (grad,) = render_image_value_and_grad(
        scene, cam, w, h, lambda img: img.mean(), [kd], sample_size=SPP, level=LEVEL,
        hittable_pdf_weight=0.5, generator=torch.Generator().manual_seed(3))
    assert tracing.totals["launch.nee_dense"] == 0
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_the_plain_path_is_the_torch_path_bit_for_bit(cornell, monkeypatch):
    """On the CPU `nee_dense` runs `nee_dense_reference`: `nee_mis` and the
    integrator's selects, the same ops as the torch path."""
    steps = []
    _spy(monkeypatch, steps)
    routed = _render(cornell, SIDE, SPP, LEVEL, CPU)
    monkeypatch.setattr(lights, "NEE_DENSE_MAX_LIGHTS", 0)
    _assert_same(routed, _render(cornell, SIDE, SPP, LEVEL, CPU))
    lt, ref, normal, coming, weight, u, do_nee = steps[1]
    new_dir, new_filter, factor, _ = lights.nee_mis(lt, ref, normal, coming, weight, u)
    got = lights.nee_dense(lt, ref, normal, coming, weight, u, do_nee)
    want = (torch.where(do_nee[..., None], new_dir, ref.dir),
            torch.where(do_nee[..., None], new_filter, ref.filter),
            torch.where(do_nee, factor, 1.0))
    for a, b in zip(got, want):
        _assert_same(a, b)


def test_an_all_zero_pdf_row_picks_leaf_0(cornell):
    lt = cornell.light_tree
    pdf = torch.zeros((5, lt.num_lights))
    pick = lights.pick_light_dense(lt, pdf, torch.tensor([0.0, 0.3, 0.5, 0.9, 1.0]))
    assert pick.tolist() == [0] * 5


def test_kernel_tables_follow_in_place_writes(tmp_path):
    """`lights.nee_tables` and `materials.surface_tables` are kept on the
    tree and the table, and rebuilt when a tensor they come from is updated
    in place: the light tree's energies, and `n_s`, where the benchmark
    plants its fault."""
    scene = _scene(tmp_path, _cornell, CPU)
    lt, table = scene.light_tree, scene.materials
    node = lights.nee_tables(lt)[0]
    assert lights.nee_tables(lt)[0] is node
    with torch.no_grad():
        lt.node_energy[0] *= 2.0
    rebuilt = lights.nee_tables(lt)[0]
    assert rebuilt is not node
    _assert_same(rebuilt[0, 3:6], lt.node_energy[0])
    mat_f = materials.surface_tables(table)[0]
    assert materials.surface_tables(table)[0] is mat_f
    with torch.no_grad():
        table.n_s[1] = 123.0
    assert float(materials.surface_tables(table)[0][1, 9]) == 123.0
