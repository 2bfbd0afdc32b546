"""The port's path tracer against the reference-semantics oracle.

`gpu_pathtracer_tpu/validation/oracle.py` transcribes the reference CUDA
estimator one ray at a time in NumPy; it shares nothing with the port but
the scene constants and the camera math.  Agreement here is evidence that
the port computes the reference's estimator, not merely the JAX package's.

The fixtures, sample counts and bounds are those of
tests/test_reference_oracle.py, copied here (that file is the JAX package's
and is not imported): the large-light Cornell box with a glossy block at
hittable_pdf_weight 0 and 0.5, level 4, and the nested glass box at level 8;
10x10 pixels; 768 samples a pixel for the port, 96 / 64 for the oracle; the
region-mean comparison `_compare` with its bounds unchanged.

The port's image is `render_image`'s estimator traced in one wavefront: the
camera samples every pixel at its centre (aperture 0), so the 768 samples of
the 100 pixels are 76,800 camera rays through `trace_paths`, each sample
de-NaN'd, then averaged per pixel, as `render_image` does sample by sample
(which at 100 rays a wavefront takes ~33 s a render on one CPU thread, the
single wavefront ~5 s at level 4).  The oracle's scene is built with
`oracle_scene_from_repo` from the JAX scene of the same OBJ, and the port's
CPU scene must give the same `OracleScene` arrays.
"""

import pathlib
import tempfile

import numpy as np
import pytest
import torch

from gpu_pathtracer_tpu.models.scene import build_scene as jax_build_scene
from gpu_pathtracer_tpu.utils.obj_io import load_scene as jax_load_scene
from gpu_pathtracer_tpu.validation import oracle as orc
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import linalg
from gpu_pathtracer_tpu_torch.render.integrator import trace_paths
from gpu_pathtracer_tpu_torch.utils.obj_io import load_scene

torch.set_num_threads(1)
W = H = 10
LEVEL = 4
SPP_PORT = 768

# Cornell-style box with a LARGE ceiling light and a glossy block: the diffuse
# and phong picks, the pure-emitter 0/0-NaN branch (light: Kd 0 Ks 0), the sky
# miss, the NEE redirect and the mixture pdf
_OBJ = """
mtllib box.mtl
v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 0 1
v 0 1 0\nv 1 1 0\nv 1 1 1\nv 0 1 1
v 0.15 0.998 0.15\nv 0.85 0.998 0.15\nv 0.85 0.998 0.85\nv 0.15 0.998 0.85
v 0.45 0 0.35\nv 0.75 0 0.35\nv 0.75 0 0.65\nv 0.45 0 0.65
v 0.45 0.45 0.35\nv 0.75 0.45 0.35\nv 0.75 0.45 0.65\nv 0.45 0.45 0.65
usemtl white
f 1 3 2\nf 1 4 3
f 5 6 7\nf 5 7 8
f 1 2 6\nf 1 6 5
usemtl red
f 1 5 8\nf 1 8 4
usemtl green
f 2 3 7\nf 2 7 6
usemtl light
f 9 10 11\nf 9 11 12
usemtl gloss
f 13 17 18\nf 13 18 14
f 14 18 19\nf 14 19 15
f 15 19 20\nf 15 20 16
f 16 20 17\nf 16 17 13
f 17 20 19\nf 17 19 18
"""

_MTL = """
newmtl white\nKd 0.68 0.68 0.68\nKs 0.06 0.06 0.06\nNs 8\nd 1.0
newmtl red\nKd 0.65 0.05 0.05\nKs 0 0 0\nNs 1\nd 1.0
newmtl green\nKd 0.12 0.45 0.15\nKs 0 0 0\nNs 1\nd 1.0
newmtl light\nKd 0 0 0\nKs 0 0 0\nKe 4 4 4\nd 1.0\nNs 1
newmtl gloss\nKd 0.2 0.25 0.3\nKs 0.5 0.45 0.4\nNs 40\nd 1.0
"""

# the Cornell room with a mirror-smooth glass cube (priority 1) holding a
# second glass cube of lower priority: refraction, the dielectric stack, Tf
# filtering, NEE's forced w=0 on mirror lobes and priority false hits
_GLASS_OBJ = """
mtllib glassbox.mtl
v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 0 1
v 0 1 0\nv 1 1 0\nv 1 1 1\nv 0 1 1
v 0.15 0.998 0.15\nv 0.85 0.998 0.15\nv 0.85 0.998 0.85\nv 0.15 0.998 0.85
usemtl white
f 1 3 2\nf 1 4 3
f 5 6 7\nf 5 7 8
f 1 2 6\nf 1 6 5
usemtl red
f 1 5 8\nf 1 8 4
usemtl green
f 2 3 7\nf 2 7 6
usemtl light
f 9 10 11\nf 9 11 12
usemtl glass
{outer}
usemtl innerglass
{inner}
"""

_GLASS_MTL = """
newmtl white\nKd 0.68 0.68 0.68\nKs 0.06 0.06 0.06\nNs 8\nd 1.0
newmtl red\nKd 0.65 0.05 0.05\nKs 0 0 0\nNs 1\nd 1.0
newmtl green\nKd 0.12 0.45 0.15\nKs 0 0 0\nNs 1\nd 1.0
newmtl light\nKd 0 0 0\nKs 0 0 0\nKe 4 4 4\nd 1.0\nNs 1
newmtl glass\nKd 0 0 0\nKs 1 1 1\nNs 10000000\nNi 1.5\nTr 1\nTf 0.92 0.96 0.98\npriority 1
newmtl innerglass\nKd 0 0 0\nKs 1 1 1\nNs 10000000\nNi 1.3\nTr 1\nTf 0.98 0.9 0.9\npriority 2
"""


def _cube_obj(lo, hi, vbase):
    """OBJ v/f lines of an axis-aligned cube with outward winding (no vn:
    the loader's geometric normals)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = [
        (x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1),
        (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
    ]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (4, 3, 7, 8), (1, 5, 6, 2), (1, 4, 8, 5), (2, 6, 7, 3)]
    lines = [f"v {a} {b} {c}" for a, b, c in v]
    for a, b, c, d in quads:
        lines.append(f"f {vbase + a} {vbase + b} {vbase + c}")
        lines.append(f"f {vbase + a} {vbase + c} {vbase + d}")
    return "\n".join(lines)


def _scenes(obj_name, obj_text, mtl_name, mtl_text):
    """(JAX scene, port CPU scene) of the same OBJ."""
    folder = pathlib.Path(tempfile.mkdtemp(prefix="torch_oracle_"))
    (folder / obj_name).write_text(obj_text.strip() + "\n")
    (folder / mtl_name).write_text(mtl_text.strip() + "\n")
    return (jax_build_scene(jax_load_scene(str(folder), obj_name)),
            build_scene(load_scene(str(folder), obj_name), "cpu"))


@pytest.fixture(scope="module")
def cornell():
    return _scenes("box.obj", _OBJ, "box.mtl", _MTL)


@pytest.fixture(scope="module")
def glassbox():
    outer = _cube_obj((0.3, 0.05, 0.3), (0.7, 0.55, 0.7), 12)
    inner = _cube_obj((0.4, 0.15, 0.4), (0.6, 0.45, 0.6), 20)
    return _scenes("glassbox.obj", _GLASS_OBJ.strip().format(outer=outer, inner=inner),
                   "glassbox.mtl", _GLASS_MTL)


@pytest.fixture(scope="module")
def cam():
    return Camera.create(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0),
                         fovy_deg=40.0, width=W, height=H)


def _np_pinhole(cam):
    """NumPy form of `Camera.generate_rays` for aperture 0 (camera.h:68-83)."""
    eye = cam.eye.double().numpy()
    u, v, w_ = cam.u.double().numpy(), cam.v.double().numpy(), cam.w.double().numpy()
    tanx, tany = float(cam.tan_half_fovx), float(cam.tan_half_fovy)

    def make(i, j):
        alpha = tanx * (j - W / 2.0) / (W / 2.0)
        beta = tany * (H / 2.0 - i) / (H / 2.0)
        d = alpha * u + beta * v - w_
        return eye, d / np.linalg.norm(d)

    return make


def _compare(img_repo, img_orc, spp_orc):
    """Region-mean comparison: 2x2 pixel blocks, tolerance from the
    cross-render pooled spread.  Specular fireflies make single-pixel
    comparisons meaningless at these sample counts; block means at
    4 * spp_orc effective samples are stable to ~10-20%."""
    a = img_repo.reshape(H // 2, 2, W // 2, 2, 3).mean(axis=(1, 3))
    b = img_orc.reshape(H // 2, 2, W // 2, 2, 3).mean(axis=(1, 3))
    lum_a = a.mean(axis=-1)
    lum_b = b.mean(axis=-1)
    # global mean: integrates all samples — tight
    assert abs(img_repo.mean() - img_orc.mean()) < 0.08 * max(
        img_repo.mean(), 0.05
    ), (img_repo.mean(), img_orc.mean())
    # per-region: loose MC bound (abs floor for near-black regions)
    diff = np.abs(lum_a - lum_b)
    tol = 0.06 + 0.35 * np.maximum(lum_a, lum_b)
    frac_bad = (diff > tol).mean()
    assert frac_bad <= 0.08, (
        frac_bad, np.stack([lum_a, lum_b], axis=-1).round(3).tolist()
    )


def _render(scene, cam, level, weight, seed):
    """(H, W, 3) mean of SPP_PORT de-NaN'd samples a pixel, every sample a
    camera ray through the pixel's centre, traced in one wavefront."""
    ii, jj = torch.meshgrid(torch.arange(float(H)), torch.arange(float(W)), indexing="ij")
    pix_i = (ii.reshape(-1) + 0.5).repeat(SPP_PORT)
    pix_j = (jj.reshape(-1) + 0.5).repeat(SPP_PORT)
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((2, pix_i.shape[0]), generator=gen)
    o, d = cam.generate_rays(pix_i, pix_j, u[0], u[1])
    with torch.no_grad():
        col = linalg.de_nan(trace_paths(scene, o, d, level=level, hittable_pdf_weight=weight,
                                        generator=gen))
    return col.reshape(SPP_PORT, H, W, 3).mean(dim=0).double().numpy()


def _oracle_scene(jscene, scene):
    """The oracle's scene from the JAX scene; the port's scene must give the
    same arrays and materials."""
    osc = orc.oracle_scene_from_repo(jscene)
    mine = orc.oracle_scene_from_repo(scene)
    for name in ("p", "n", "tolerance", "sky_emission"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(osc, name), err_msg=name)
    assert len(mine.mats) == len(osc.mats)
    for a, b in zip(mine.mats, osc.mats):  # eq=False dataclasses: field by field
        for f in vars(b):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    return osc


@pytest.mark.parametrize("weight", [0.0, 0.5])
def test_port_matches_reference_oracle(cornell, cam, weight):
    """Path tracing with NEE off (weight 0: the BSDF-sampling estimator) and
    on (weight 0.5: the light-tree mixture estimator of change_ref_ray)."""
    jscene, scene = cornell
    img = _render(scene, cam, LEVEL, weight, seed=3)
    osc = _oracle_scene(jscene, scene)
    spp = 96
    img_orc = orc.render_oracle(osc, _np_pinhole(cam), W, H, sample_size=spp, level=LEVEL,
                                hittable_pdf_weight=weight, seed=11)
    _compare(img, np.asarray(img_orc), spp)


def test_port_matches_reference_oracle_glass(glassbox, cam):
    """Refraction and the nested-dielectric priority stack; level 8, so that
    a camera path can enter the outer cube, pass both inner false hits, leave
    and still reach a wall and the light."""
    jscene, scene = glassbox
    img = _render(scene, cam, 8, 0.5, seed=5)
    osc = _oracle_scene(jscene, scene)
    spp = 64
    img_orc = orc.render_oracle(osc, _np_pinhole(cam), W, H, sample_size=spp, level=8,
                                hittable_pdf_weight=0.5, seed=17)
    _compare(img, np.asarray(img_orc), spp)
