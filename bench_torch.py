#!/usr/bin/env python3
"""Benchmark of the PyTorch port on one NVIDIA GPU: `bench.py`'s legs, scenes,
sizes and key names, run through `gpu_pathtracer_tpu_torch`.

    python3 bench_torch.py                    # from the root of a checkout; on the CUDA card
    BENCH_SCENE=mesh python3 bench_torch.py   # the forward leg on the 327,684-triangle mesh

Knobs (environment variables, `bench.py`'s, with its defaults): BENCH_SIZE
(512), BENCH_SPP (8), BENCH_LEVEL (8), BENCH_SCENE (cornell | mesh),
BENCH_SKIP_EXTRAS, BENCH_REPEATS (3), BENCH_PHOTONS (200,000),
BENCH_SKIP_GLASS, BENCH_SKIP_MESH, BENCH_SKIP_SPPM, BENCH_SKIP_DIFF_SPPM,
BENCH_SPPM_SIZE (512), BENCH_SPPM_PHOTONS (50,000), BENCH_DIFF_SPPM_SIZE
(256), BENCH_DIFF_SPPM_PHOTONS (16,384).  `--device cpu` runs the kernels'
plain versions on the CPU and exists for tests; without it the run needs a
CUDA device.

The legs, each a warm-up call (which also builds the kernels at their first
use) and then BENCH_REPEATS timed calls, each ended by a device
synchronization:
  forward      the Cornell box with spheres through `render_image` (spp,
               level, hittable_pdf_weight 0.5); rays = W*H*spp*level;
  backward     the L2 loss of a render with spp // 4 against the forward
               image, differentiated to `ke` by path replay
               (`render_image_value_and_grad`: the paths traced twice, the
               memory of one chunk's graph);
  photon_pass  `sppm.photon_pass` with BENCH_PHOTONS photons, 8 bounces;
  glass_dof    the box with `glass_priority` dielectrics through a thin lens
               (aperture 0.08, focus 2.0), spp // 2 x 2 lens samples;
  mesh         the forward leg on `make_mesh_scene_host(subdiv=7)`, built
               outside the timed calls;
  sppm_cornell, sppm_fog
               one full SPPM iteration as `bench.py` composes it (photon
               pass, eye pass, surface gather, `bench.py`'s own update of the
               flux and the surface radius) on the SPPM box and its fog
               variant; pass 0 is the warm-up;
  diff_sppm    `render_sppm_differentiable` (2 passes, 8 photon and 8 eye
               bounces) and the gradient of its image mean to `ke`.
With BENCH_SCENE=mesh only the first three run, on the mesh.

Output: one JSON line per finished leg ({"leg", "seconds": every timed
call's, "median_s", "peak_gb": the device memory's peak over the timed
calls, "launches": each kernel's launches in each timed call, and the keys
the leg adds to `detail`}), so a failing leg leaves the lines of the legs
before it; then, last, `bench.py`'s line {"metric", "value", "unit",
"vs_baseline", "detail"}, `detail` with `bench.py`'s keys and the card's
name (`device`) and power limit (`power_limit`).  `vs_baseline` is null: the
port has no baseline figure of its own.  The median is `bench.py`'s
(the upper one of an even count).  No leg's failure is caught.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import sys
import tempfile
import time

import torch

from gpu_pathtracer_tpu_torch import optim, tracing
from gpu_pathtracer_tpu_torch.device import nvidia_smi, resolve_device
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch.ops import _build
from gpu_pathtracer_tpu_torch.render import sppm
from gpu_pathtracer_tpu_torch.render.integrator import render_image, render_image_value_and_grad
from gpu_pathtracer_tpu_torch.utils import testscenes
from gpu_pathtracer_tpu_torch.utils.obj_io import load_scene

MESH_SUBDIV = 7  # 327,684 triangles
CORNELL_CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
MESH_CAM = dict(eye=(0.5, 0.8, 2.2), center=(0.5, 0.45, 0.5), up=(0, 1, 0), fovy_deg=45.0)


def _env(name: str, default: str) -> int:
    return int(os.environ.get(name, default))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _finite(t: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"bench_torch: {what} is not finite")


def _time_leg(name: str, call, dev: torch.device, repeats: int):
    """`call(0)` as the warm-up, then `call(1)` .. `call(repeats)` timed, each
    ended by a device synchronization.  Returns (the leg's record, the
    warm-up's result)."""
    warm = call(0)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seconds, launches = [], {k: [] for k in _build.KERNELS}
    for i in range(1, max(1, repeats) + 1):
        before = tracing.launches()
        t0 = time.perf_counter()
        call(i)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        for k, n in tracing.launches().items():
            launches[k].append(n - before[k])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    record = {"leg": name, "seconds": seconds, "median_s": sorted(seconds)[len(seconds) // 2],
              "peak_gb": peak, "launches": launches}
    return record, warm


def _emit(record: dict, detail: dict, **keys) -> None:
    """Adds the leg's keys to `detail` and prints its line."""
    detail.update(keys)
    print(json.dumps({**record, **keys}), flush=True)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _cornell_scene(folder: pathlib.Path, dev: torch.device, **box):
    folder.mkdir()
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=2, **box)
    return build_scene(load_scene(folder, "box.obj"), dev)


def _mesh_scene(dev: torch.device):
    return build_scene(testscenes.make_mesh_scene_host(subdiv=MESH_SUBDIV), dev)


def _sppm_box_scene(folder: pathlib.Path, dev: torch.device, fog: bool):
    """The SPPM box: octahedron spheres, the light given a diffuse Kd."""
    folder.mkdir()
    testscenes.make_cornell_box(folder, spheres=True, sphere_subdiv=0, fog=fog)
    mtl = folder / "box.mtl"
    mtl.write_text(mtl.read_text().replace("newmtl light\nKd 0 0 0",
                                           "newmtl light\nKd 0.78 0.78 0.78"))
    return build_scene(load_scene(folder, "box.obj"), dev)


def _sppm_iteration(name: str, scene, camera, side: int, n_phot: int, dev, repeats: int):
    """One full SPPM iteration as `bench.py` composes it: the init pass and
    the initial radius once, then per pass the photon pass, the eye pass
    (given the photons when the scene has a medium), the surface gather and
    `bench.py`'s update (only the surface radius shrinks).  Pass 0 is the
    warm-up.  Returns the leg's record."""
    r = side * side
    ii, jj = torch.meshgrid(torch.arange(side, dtype=torch.float32, device=dev),
                            torch.arange(side, dtype=torch.float32, device=dev), indexing="ij")
    pix_i, pix_j = ii.reshape(-1), jj.reshape(-1)
    use_grid = r * n_phot > sppm.GRID_MIN_PAIRS
    has_medium = bool(torch.any(scene.materials.scattering_coef
                                + scene.materials.absorption_coef > 0))

    def eye(*args, **kw):
        return sppm.eye_pass(*args, **kw, max_bounce=64, volume_grid=use_grid)

    gen0 = sppm.pass_generator(5, 0, dev)
    vol_r = torch.full((r,), float("inf"), device=dev)
    loc, nrm, filt, direct, _, valid = eye(scene, camera, pix_i + 0.5, pix_j + 0.5, None, vol_r,
                                           init=True, generator=gen0)
    radius = sppm.initial_radius(lambda *a, **k: eye(*a, **k, generator=gen0), scene, camera,
                                 pix_i, pix_j, loc, valid, 1.0)
    zeros3 = torch.zeros((r, 3), device=dev)
    hp = sppm.HitPoints(
        loc=torch.where(valid[..., None], loc, float("inf")), normal=nrm, filter=filt,
        direct=direct, indirect=zeros3, tmp_lm=zeros3, surface_radius=radius,
        volume_radius=2.0 * radius, valid=valid)
    gather = sppm.surface_gather_grid if use_grid else sppm.surface_gather

    def one_pass(it: int):
        nonlocal hp
        gen = sppm.pass_generator(5, 1000 + it, dev)
        photons = sppm.photon_pass(scene, n_phot, max_bounce=8, generator=gen)
        jitter = torch.rand((2, r), generator=gen, device=dev)
        loc, nrm, filt, direct, tmp_lm, valid = eye(
            scene, camera, pix_i + jitter[0], pix_j + jitter[1],
            photons if has_medium else None, hp.volume_radius, init=False, generator=gen)
        hp = dataclasses.replace(
            hp, loc=torch.where(valid[..., None], loc, float("inf")), normal=nrm, filter=filt,
            direct=hp.direct + direct, tmp_lm=tmp_lm, valid=valid)
        with torch.no_grad():
            flux = gather(scene, photons, hp.loc, hp.normal, hp.surface_radius, hp.valid,
                          k_nearest=16)[0]
            iteration = it + 1
            shrink = math.sqrt((iteration + 0.7) / (iteration + 1.0)) if iteration >= 2 else 1.0
            surf = hp.filter * flux / (n_phot * math.pi * hp.surface_radius[..., None] ** 2)
            hp = dataclasses.replace(
                hp, indirect=hp.indirect + torch.nan_to_num(surf) + hp.tmp_lm / n_phot,
                surface_radius=hp.surface_radius * shrink, tmp_lm=torch.zeros_like(hp.tmp_lm))

    record, _ = _time_leg(name, one_pass, dev, repeats)
    _finite(hp.indirect, f"{name}: the indirect radiance")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' is for tests)")
    dev = resolve_device(ap.parse_args(argv).device)

    width = height = _env("BENCH_SIZE", "512")
    spp = _env("BENCH_SPP", "8")
    level = _env("BENCH_LEVEL", "8")
    scene_kind = os.environ.get("BENCH_SCENE", "cornell")
    skip_extras = os.environ.get("BENCH_SKIP_EXTRAS")
    repeats = _env("BENCH_REPEATS", "3")
    cornell = scene_kind == "cornell"

    with tempfile.TemporaryDirectory(prefix="bench_torch_") as tmp:
        tmp = pathlib.Path(tmp)
        if cornell:
            scene = _cornell_scene(tmp / "cornell", dev)
            camera = Camera.create(**CORNELL_CAM, width=width, height=height, device=dev)
        else:
            scene = _mesh_scene(dev)
            camera = Camera.create(**MESH_CAM, width=width, height=height, device=dev)
        kw = dict(width=width, height=height, sample_size=spp, level=level,
                  hittable_pdf_weight=0.5)
        rays = width * height * spp * level

        def forward(scn, cam, seeds, **changes):
            def call(i):
                with torch.no_grad():
                    return render_image(scn, cam, generator=_generator(dev, seeds[min(i, 1)]),
                                        **dict(kw, **changes))
            return call

        # ---- forward ----------------------------------------------------------------
        record, img = _time_leg("forward", forward(scene, camera, (0, 1)), dev, repeats)
        _finite(img, "the forward image")
        fwd_dt = record["median_s"]
        detail = {"size": width, "spp": spp, "level": level, "scene": scene_kind}
        _emit(record, detail, num_tris=scene.geom.num_tris, seconds_fwd=fwd_dt)
        detail["backend"] = dev.type

        if not skip_extras:
            # ---- backward (grad-rays/s) ---------------------------------------------
            bw_spp = max(1, spp // 4)
            target = img
            ke0 = scene.materials.ke

            def grad_call(i):
                ke = (ke0 if i == 0 else ke0 * 1.01).detach().requires_grad_(True)
                return render_image_value_and_grad(
                    optim._substitute(scene, {"ke": ke}), camera, width, height,
                    lambda im: torch.mean((im - target) ** 2), [ke], sample_size=bw_spp,
                    level=level, hittable_pdf_weight=0.5, generator=_generator(dev, 2))[2][0]

            record, grad = _time_leg("backward", grad_call, dev, repeats)
            _finite(grad, "the gradient to ke")
            _emit(record, detail,
                  grad_rays_per_sec=width * height * bw_spp * level / record["median_s"],
                  seconds_bwd=record["median_s"])

            # ---- SPPM photon pass (photons/s) ---------------------------------------
            if scene.light_tree is not None:
                n_phot = _env("BENCH_PHOTONS", "200000")
                record, _ = _time_leg("photon_pass", lambda i: sppm.photon_pass(
                    scene, n_phot, max_bounce=8, generator=_generator(dev, 3 if i == 0 else 4)),
                    dev, repeats)
                _emit(record, detail, sppm_photons_per_sec=n_phot / record["median_s"],
                      seconds_photon_pass=record["median_s"])

            # ---- glass nested dielectrics + depth of field --------------------------
            if cornell and not os.environ.get("BENCH_SKIP_GLASS"):
                gscene = _cornell_scene(tmp / "glass", dev, glass_priority=True)
                gcam = Camera.create(**CORNELL_CAM, width=width, height=height, aperture=0.08,
                                     focus_dist=2.0, device=dev)
                gspp = max(1, spp // 2)
                record, gimg = _time_leg("glass_dof", forward(
                    gscene, gcam, (8, 9), dof_sample_size=2, sample_size=gspp), dev, repeats)
                _finite(gimg, "the glass + DoF image")
                _emit(record, detail,
                      rays_per_sec_fwd_glass_dof=width * height * gspp * 2 * level
                      / record["median_s"],
                      seconds_fwd_glass_dof=record["median_s"])

            # ---- the 327k-triangle mesh ---------------------------------------------
            if cornell and not os.environ.get("BENCH_SKIP_MESH"):
                mscene = _mesh_scene(dev)
                mcam = Camera.create(**MESH_CAM, width=width, height=height, device=dev)
                record, mimg = _time_leg("mesh", forward(mscene, mcam, (12, 13)), dev, repeats)
                _finite(mimg, "the mesh image")
                _emit(record, detail, rays_per_sec_fwd_mesh=rays / record["median_s"],
                      seconds_fwd_mesh=record["median_s"], mesh_num_tris=mscene.geom.num_tris)

            # ---- one full SPPM iteration (Cornell and fog) --------------------------
            if cornell and not os.environ.get("BENCH_SKIP_SPPM"):
                side = _env("BENCH_SPPM_SIZE", "512")
                n_phot = _env("BENCH_SPPM_PHOTONS", "50000")
                for tag, fog in (("cornell", False), ("fog", True)):
                    scam = Camera.create(**CORNELL_CAM, width=side, height=side, device=dev)
                    record = _sppm_iteration(
                        f"sppm_{tag}", _sppm_box_scene(tmp / f"sppm_{tag}", dev, fog), scam,
                        side, n_phot, dev, repeats)
                    _emit(record, detail, **{
                        f"sppm_pass_seconds_{tag}": record["median_s"],
                        f"sppm_pixels_per_sec_{tag}": side * side / record["median_s"],
                        "sppm_pass_size": side, "sppm_pass_photons": n_phot})

            # ---- differentiable SPPM step -------------------------------------------
            if cornell and not os.environ.get("BENCH_SKIP_DIFF_SPPM"):
                dsz = _env("BENCH_DIFF_SPPM_SIZE", "256")
                dphot = _env("BENCH_DIFF_SPPM_PHOTONS", "16384")
                dscene = _sppm_box_scene(tmp / "diff_sppm", dev, fog=False)
                dcam = Camera.create(**CORNELL_CAM, width=dsz, height=dsz, device=dev)
                kwd = dict(width=dsz, height=dsz, n_photons=dphot, num_pass=2, max_bounce=8,
                           eye_bounce=8)
                dke0 = dscene.materials.ke

                def diff_step(i):
                    ke = (dke0 if i == 0 else dke0 * 1.01).detach().requires_grad_(True)
                    out = sppm.render_sppm_differentiable(
                        optim._substitute(dscene, {"ke": ke}), dcam, seed=6, **kwd)
                    return torch.autograd.grad(out.mean(), ke)[0]

                record, dgrad = _time_leg("diff_sppm", diff_step, dev, repeats)
                _finite(dgrad, "the differentiable SPPM gradient to ke")
                _emit(record, detail, sppm_diff_step_seconds=record["median_s"],
                      sppm_diff_pixels_per_sec=dsz * dsz * kwd["num_pass"] / record["median_s"],
                      sppm_diff_size=dsz, sppm_diff_photons=dphot)

    on_card = dev.type == "cuda"
    detail["device"] = torch.cuda.get_device_name(dev) if on_card else str(dev)
    detail["power_limit"] = nvidia_smi() if on_card else None
    print(json.dumps({
        "metric": "rays_per_sec_fwd_512" if cornell else f"rays_per_sec_fwd_{scene_kind}_{width}",
        "value": rays / fwd_dt,
        "unit": "rays/s",
        "vs_baseline": None,
        "detail": detail,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
