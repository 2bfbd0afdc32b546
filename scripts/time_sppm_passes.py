#!/usr/bin/env python3
"""Seconds of the SPPM passes of two `chip_smoke.py` paths on the card, part
by part, with the any-hit kernels' device time beside them.

    python3 scripts/time_sppm_passes.py [--repeat N] [--profile]

Run from the root of a checkout with one CUDA card.  The Cornell SPPM box of
the bench's SPPM leg (512x512, 50,000 photons a pass, ppm_max_bounce 8,
`chip_smoke.SPPM`'s passes after the init pass, through
`renderer.render_from_config`; its gathers' visibility checks run on
`anyhit`) and one pass of the 327,684-triangle mesh after its init pass
(`render_sppm`; its gathers run on `anyhit_pipe`).  After a warm-up of both,
each is run N times unprofiled, printing every pass of `pass_log` (photon
pass, eye pass and gather + update seconds, host clock, synchronised, and
the pass's any-hit launches); with `--profile` once more under
`torch.profiler`, printing the device time of every any-hit kernel over the
whole render (init pass included) and of all kernels (a minute or two for
the Cornell render's kernels).  To compare two versions, run it from each
checkout in turns (another version's tree unpacked into the git-ignored
`build/`, this script copied in): it uses only entry points that the any-hit
kernels have had since they were ported.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gpu_pathtracer_tpu_torch import renderer  # noqa: E402
from gpu_pathtracer_tpu_torch.device import require_cuda  # noqa: E402
from gpu_pathtracer_tpu_torch.models.camera import Camera  # noqa: E402
from gpu_pathtracer_tpu_torch.models.scene import build_scene  # noqa: E402
from gpu_pathtracer_tpu_torch.render import sppm  # noqa: E402
from gpu_pathtracer_tpu_torch.utils import config, testscenes  # noqa: E402

ANYHIT_KERNELS = ("anyhit", "settle_dead_groups")  # names of the any-hit launches' kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=2, help="unprofiled runs of each path")
    ap.add_argument("--profile", action="store_true", help="also one profiled run of each")
    args = ap.parse_args()
    dev = require_cuda()
    print(cs.nvidia_smi(), flush=True)
    folder = pathlib.Path(tempfile.mkdtemp(prefix="time_sppm_"))
    mesh = build_scene(testscenes.make_mesh_scene_host(subdiv=cs.MESH_SUBDIV), dev)
    mcam = Camera.create(**cs.MESH_CAM, width=cs.SPPM["width"], height=cs.SPPM["height"],
                         device=dev)
    mcfg = config.RenderConfig(image_width=cs.SPPM["width"], image_height=cs.SPPM["height"],
                               ppm_num_photon_per_pass=cs.SPPM["photons"], ppm_num_pass=1,
                               ppm_max_bounce=cs.SPPM["max_bounce"])

    def cornell(pass_log):
        renderer.render_from_config(cs.sppm_box_master(folder, False, config, testscenes),
                                    pass_log=pass_log)

    def mesh_pass(pass_log):
        with torch.no_grad():
            sppm.render_sppm(mesh, mcam, mcfg, 12, pass_log=pass_log)

    paths = (("Cornell SPPM", cornell), ("mesh SPPM", mesh_pass))
    for _, run in paths:  # warm-up: builds the kernels
        run([])
    for name, run in paths:
        for r in range(args.repeat):
            pass_log = []
            run(pass_log)
            for p in pass_log:
                print(f"{name}, run {r}, pass {p['it'] + 1}: photon pass {p['photon_s']:.4f}s, eye "
                      f"pass {p['eye_s']:.4f}s, gather + update {p['gather_s']:.4f}s, "
                      f"{p['anyhit_launches']} any-hit launches", flush=True)
        if not args.profile:
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run([])
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        for e in kernels:
            if any(k in e.key for k in ANYHIT_KERNELS):
                print(f"{name}, profiled: kernel {e.key} {e.self_device_time_total / 1e3:.3f} ms in "
                      f"{e.count} launches", flush=True)
        print(f"{name}, profiled: all kernels {total / 1e3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
