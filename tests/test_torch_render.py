"""PyTorch port vs the JAX package: the path-tracing slice end to end.

* Per ray: `trace_paths` on 1,024 Cornell camera rays, level 4, with the
  uniforms rebuilt from the JAX key exactly as JAX folds it.  Against JAX
  run op by op (`jax.disable_jit()`, each primitive rounded on its own as in
  PyTorch): >= 99% of rays allclose (rtol 1e-4, atol 1e-5; measured: all of
  them, ~97% bitwise) and the mean within 1%.  Against the jitted JAX
  function: >= 98% of rays and the mean within 1%.  XLA fuses the jitted
  scan and may contract a*b+c into FMAs; about 1% of the paths (NEE from
  ceiling points 1e-3 above the light plane, at grazing angles) amplify
  that one-ulp difference past rtol 1e-4 over the later bounces, while the
  image mean agrees to ~1e-6.  (JAX on the CPU also answers closest hits
  with its dense path; on these rays it picks the same triangles.)
* Image: `render_image` of both packages (each with its own RNG) at 16x16,
  spp 64, level 4; 4x4-pixel region means agree within 5 sigma of their
  Monte-Carlo error, sigma estimated from the spread of the port's eight
  8-spp batches.
* CLI: the port's command line renders a Cornell master file to a PPM.
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_parity
from gpu_pathtracer_tpu.models.camera import Camera as JCamera
from gpu_pathtracer_tpu.render import integrator as jint
from gpu_pathtracer_tpu.utils import testscenes
from gpu_pathtracer_tpu.utils.image import load_ppm
from gpu_pathtracer_tpu_torch import renderer
from gpu_pathtracer_tpu_torch.utils.config import parse_master_file
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.convert import scene_from_numpy
from gpu_pathtracer_tpu_torch.render import integrator

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)


@pytest.fixture(scope="module")
def cornell():
    _, jscene, _ = torch_parity.cornell_scenes()
    # the port gets the JAX scene's own arrays
    return jscene, scene_from_numpy(torch_parity.flatten(jscene), "cpu")


@pytest.mark.parametrize("jitted,min_frac", [(False, 0.99), (True, 0.98)])
def test_trace_paths_per_ray_matches_jax(cornell, jitted, min_frac):
    jscene, scene = cornell
    w = h = 32
    level = 4
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    pi, pj = ii.reshape(-1) + 0.5, jj.reshape(-1) + 0.5
    zeros = np.zeros(w * h, np.float32)
    jo, jd = JCamera.create(**CAM, width=w, height=h).generate_rays(pi, pj, zeros, zeros)
    o, d = np.array(jo), np.array(jd)
    key = jax.random.key(2024)
    with contextlib.nullcontext() if jitted else jax.disable_jit():
        ref = np.asarray(jint.trace_paths(jscene, o, d, key, level=level, hittable_pdf_weight=0.5))
    with torch.no_grad():
        got = integrator.trace_paths(
            scene, torch.from_numpy(o), torch.from_numpy(d), level=level, hittable_pdf_weight=0.5,
            uniforms=torch.from_numpy(torch_parity.uniforms_from_key(key, level, w * h)),
        ).numpy()
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= min_frac, (close.mean(), np.nonzero(~close)[0][:10])
    assert abs(got.mean() - ref.mean()) <= 0.01 * ref.mean(), (got.mean(), ref.mean())
    assert (ref.sum(-1) > 0).mean() > 0.5  # most paths carry light


def test_render_image_region_means_match_jax(cornell):
    jscene, scene = cornell
    w = h = 16
    level, batches, spp = 4, 8, 8
    jimg = np.asarray(jint.render_image(
        jscene, JCamera.create(**CAM, width=w, height=h), jax.random.key(7), width=w, height=h,
        sample_size=batches * spp, level=level, hittable_pdf_weight=0.5,
    ))
    cam = Camera.create(**CAM, width=w, height=h)
    with torch.no_grad():
        parts = np.stack([
            integrator.render_image(
                scene, cam, w, h, sample_size=spp, level=level, hittable_pdf_weight=0.5,
                generator=torch.Generator().manual_seed(100 + b),
            ).numpy()
            for b in range(batches)
        ])
    regions = parts.reshape(batches, h // 4, 4, w // 4, 4, 3).mean(axis=(2, 4))
    port = regions.mean(axis=0)
    jref = jimg.reshape(h // 4, 4, w // 4, 4, 3).mean(axis=(1, 3))
    # sigma of a 64-spp region mean, from the port's batch spread; the JAX
    # estimator has the same variance, so the difference has sqrt(2) sigma
    sigma = np.sqrt(2.0) * regions.std(axis=0, ddof=1) / np.sqrt(batches)
    assert np.all(np.abs(port - jref) <= 5.0 * sigma + 1e-4), (
        np.abs(port - jref).max(), sigma.max()
    )
    assert abs(port.mean() - jref.mean()) <= 0.05 * jref.mean()


def test_cli_renders_cornell_master_file(tmp_path):
    testscenes.make_cornell_box(tmp_path, spheres=True, sphere_subdiv=2)
    master = testscenes.cornell_master_file(tmp_path, width=8, height=8, spp=1, level=2)
    out = tmp_path / "out.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_pathtracer_tpu_torch.cli", str(master), str(out),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "[gpu_pathtracer_tpu_torch] path-tracing render done" in proc.stdout
    img = load_ppm(out)
    assert img.shape == (8, 8, 3) and img.max() > 0


def test_renderer_refuses_what_is_not_ported(tmp_path):
    """Nothing of the master file is refused any more: `shard_rays` renders
    (on one process, over that one), path tracing bit for bit the unsharded
    image and SPPM through the sharded photon pass; SSS is ported too.  The
    renderer still refuses to pick the CPU by itself."""
    testscenes.make_cornell_box(tmp_path, spheres=False)
    master = testscenes.cornell_master_file(tmp_path, width=4, height=4, spp=1, level=1)
    plain = renderer.render_from_config(parse_master_file(master), device="cpu")
    cfg = parse_master_file(master)
    cfg.shard_rays = True
    np.testing.assert_array_equal(renderer.render_from_config(cfg, device="cpu"), plain)
    cfg.render_mode, cfg.ppm_num_photon_per_pass, cfg.ppm_num_pass = 2, 64, 1
    cfg.ppm_max_bounce = 2
    sharded = renderer.render_from_config(cfg, device="cpu")
    assert sharded.shape == (4, 4, 3) and np.isfinite(sharded).all() and sharded.max() > 0
    # SSS is ported: on a scene without an SSS material the stage changes nothing
    cfg = parse_master_file(master)
    cfg.sss_pts_per_object = 8
    img = renderer.render_from_config(cfg, device="cpu")
    assert img.shape == (4, 4, 3) and np.isfinite(img).all()
    if not torch.cuda.is_available():
        # no CUDA device and no explicit device: refused, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            renderer.render_from_config(parse_master_file(master))
