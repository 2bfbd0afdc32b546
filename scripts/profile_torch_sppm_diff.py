#!/usr/bin/env python3
"""Where a step of the port's differentiable SPPM render spends its time on
the card.

    python3 scripts/profile_torch_sppm_diff.py

The step is `chip_smoke.py`'s phase 17, the bench's differentiable-SPPM leg:
`render_sppm_differentiable` on the SPPM box (72 triangles) at 256x256,
16,384 photons a pass, 2 passes, 8 photon and 8 eye bounces (the hash-grid
gathers), and the gradient of the image mean to `ke`.  After a warm-up step
it prints:

* the wall time of one step's forward and backward, unprofiled;
* the forward's parts in another step, each call wrapped in a synchronize
  (host clock): the init pass with its four corner passes, the photon
  passes, the eye passes, the surface gathers, and the rest;
* from `torch.profiler` over one more step, the forward and the backward
  apart: the device's busy time and its share of the unprofiled wall, the
  kernels by count, the tile kernels' time and launches (an any-hit launch
  is its settle pass and its walk), and the ten largest kernels; the host
  synchronizations of the step.
Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gpu_pathtracer_tpu_torch import optim, tracing  # noqa: E402
from gpu_pathtracer_tpu_torch.device import require_cuda  # noqa: E402
from gpu_pathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from gpu_pathtracer_tpu_torch.models.scene import build_scene  # noqa: E402
from gpu_pathtracer_tpu_torch.render import sppm  # noqa: E402
from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes  # noqa: E402


# the tile kernels' device functions: every any-hit launch runs
# `settle_dead_groups` (the dead groups' pass) and then its walk
TILE_KERNELS = ("closest_hit", "anyhit", "settle_dead_groups")


def main() -> int:
    dev = require_cuda()
    print(f"card: {chip_smoke.nvidia_smi()}; torch {torch.__version__}", flush=True)
    d = chip_smoke.DIFF_SPPM
    folder = pathlib.Path(tempfile.mkdtemp(prefix="profile_sppm_diff_"))
    chip_smoke.sppm_box_master(folder, False, config, testscenes)
    scene = build_scene(obj_io.load_scene(folder, "box.obj"), dev)
    side = d["side"]
    cam = Camera.create(**chip_smoke.CORNELL_CAM, width=side, height=side, device=dev)
    kw = dict(width=side, height=side, n_photons=d["photons"], num_pass=d["passes"],
              max_bounce=d["max_bounce"], eye_bounce=d["eye_bounce"], seed=d["seed"])
    ke0 = scene.materials.ke * 1.01

    def step():
        return chip_smoke.diff_sppm_step(scene, cam, kw, ke0)

    step()  # warm-up
    _, _, fwd, bwd = step()
    print(f"differentiable SPPM step, {side}x{side}, {d['photons']} photons x {d['passes']} "
          f"passes: forward {fwd * 1e3:.1f} ms + backward {bwd * 1e3:.1f} ms unprofiled",
          flush=True)

    # the forward's parts: every call of the pieces wrapped in a synchronize
    parts = collections.defaultdict(float)
    originals = {n: getattr(sppm, n) for n in ("photon_pass", "eye_pass", "surface_gather_grid")}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            label = name(kwargs) if callable(name) else name
            parts[label] += time.perf_counter() - t0
            return out
        return wrapper

    sppm.photon_pass = timed("photon passes", originals["photon_pass"])
    sppm.eye_pass = timed(lambda k: "init pass + 4 corner passes" if k["init"] else "eye passes",
                          originals["eye_pass"])
    sppm.surface_gather_grid = timed("surface gathers", originals["surface_gather_grid"])
    try:
        _, _, fwd_parts, _ = step()
    finally:
        for n, fn in originals.items():
            setattr(sppm, n, fn)
    parts["rest (update, set-up)"] = fwd_parts - sum(parts.values())
    print(f"forward in parts ({fwd_parts * 1e3:.1f} ms with a synchronize around each call):")
    for name, s in parts.items():
        print(f"  {s * 1e3:9.1f} ms  {name}")

    from torch.profiler import ProfilerActivity, profile

    def report(what, prof, wall):
        averages = prof.key_averages()
        events = [e for e in averages  # a tracer span's mark on the device is no work
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in tracing.SPANS]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        launches = sum(e.count for e in events)
        print(f"{what}: device busy {busy:.1f} ms = {busy / 1e3 / wall:.3f} of its unprofiled "
              f"wall ({wall * 1e3:.1f} ms); {launches} kernels")
        for e in events:
            if any(name in e.key for name in TILE_KERNELS):
                print(f"  kernel {e.key}: {e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                      "launches")
        for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:7d} calls  {e.key[:70]}")

    ke = ke0.detach().clone().requires_grad_(True)
    tracing.reset("loop_exit")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof_f:
        img = sppm.render_sppm_differentiable(optim._substitute(scene, {"ke": ke}), cam, **kw)
        loss = img.mean()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof_b:
        torch.autograd.grad(loss, ke)
        torch.cuda.synchronize()
    report("forward", prof_f, fwd)
    report("backward", prof_b, bwd)
    print(f"host syncs of the step: {tracing.totals['loop_exit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
