#!/usr/bin/env python3
"""The sharded differentiable SPPM step's gradient against the same step in
one process, on the card.

    python3 scripts/sppm_shard_grad.py        # from the root of a checkout; one CUDA card

On `chip_smoke.py` phase 17's step (the SPPM box, 256x256, 16,384 photons x
2 passes, 8 + 8 bounces, d mean(img) / d ke), with the photon streams of two
ranks traced in this process (`parallel.sppm_shard.photon_pass_local`):
the gradient with the material table gathered as the port gathers it (its
backward sums in float64) and with a plain float32 gather swapped in, three
steps each in turns (forward and backward seconds, whether repeated steps
give the same bits), and the same step on two gloo ranks sharing the card
(`chip_smoke.py --scale-out-rank`, started by `parallel.launch.run_ranks`).
Prints each gradient, their largest differences and the card's name and
power limit; writes
`chiprun_out/sppm_shard_grad.json`.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from gpu_pathtracer_tpu_torch import optim
    from gpu_pathtracer_tpu_torch.device import require_cuda
    from gpu_pathtracer_tpu_torch.models.camera import Camera
    from gpu_pathtracer_tpu_torch.models.scene import build_scene
    from gpu_pathtracer_tpu_torch.ops import _build, materials
    from gpu_pathtracer_tpu_torch.parallel import launch, sppm_shard
    from gpu_pathtracer_tpu_torch.render import sppm
    from gpu_pathtracer_tpu_torch.utils import config, obj_io, testscenes

    dev = require_cuda()
    card = cs.nvidia_smi()
    _build.build_many(("closest_hit", "anyhit"))
    box_dir = pathlib.Path(tempfile.mkdtemp(prefix="sppm_shard_grad_"))
    cs.sppm_box_master(box_dir, False, config, testscenes)
    box = build_scene(obj_io.load_scene(box_dir, "box.obj"), dev)
    side = cs.DIFF_SPPM["side"]
    cam = Camera.create(**cs.CORNELL_CAM, width=side, height=side, device=dev)
    emulate = functools.partial(sppm_shard.photon_pass_local, n_shards=2)

    def step():
        ke = box.materials.ke.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sppm.render_sppm_differentiable(
            optim._substitute(box, {"ke": ke}), cam, **cs.diff_sppm_kw(),
            seed=cs.DIFF_SPPM["seed"], photon_pass_fn=emulate)
        loss = img.mean()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (grad,) = torch.autograd.grad(loss, ke)
        torch.cuda.synchronize()
        return float(loss.detach()), grad.cpu().numpy(), t1 - t0, time.perf_counter() - t1

    def float32_take(table, mat_id):
        return table[torch.clamp(mat_id, min=0).long()]

    gathers = {"float64_sum": materials._take, "float32_sum": float32_take}
    runs = {name: [] for name in gathers}
    try:
        for _ in range(3):
            for name, take in gathers.items():
                materials._take = take
                runs[name].append(step())
    finally:
        materials._take = gathers["float64_sum"]

    # the same step on two ranks sharing the card
    cornell_dir = pathlib.Path(tempfile.mkdtemp(prefix="sppm_shard_grad_cornell_"))
    testscenes.make_cornell_box(cornell_dir, spheres=True, sphere_subdiv=2)
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="sppm_shard_grad_ranks_"))
    launch.run_ranks([sys.executable, ROOT / "chip_smoke.py", "--scale-out-rank", out_dir,
                      cornell_dir, box_dir], 2, out_dir, cs.RANK_TIMEOUT)
    sharded = np.load(out_dir / "results.npz")["diff_grad"]
    rank_seconds = [json.loads((out_dir / f"rank{r}.json").read_text())["seconds"]
                    ["diff_sppm_step"] for r in range(2)]

    ref = runs["float64_sum"][0][1]
    nz = np.abs(ref) > 0

    def apart(g):
        d = np.abs(g - ref)
        return {"max_abs": float(d.max()), "max_rel": float((d[nz] / np.abs(ref[nz])).max())}

    record = {"card": card, "step": "phase 17's", "gradients": {},
              "rank_step_seconds": rank_seconds}
    for name, rs in runs.items():
        record["gradients"][name] = {
            "loss": rs[0][0], "grad": rs[0][1].tolist(),
            "same_bits_every_step": all(np.array_equal(r[1], rs[0][1]) for r in rs),
            "forward_s": [r[2] for r in rs], "backward_s": [r[3] for r in rs],
            "apart_from_float64_sum": apart(rs[0][1])}
    record["gradients"]["two_ranks"] = {"grad": sharded.tolist(),
                                        "apart_from_float64_sum": apart(sharded)}
    for name, g in record["gradients"].items():
        print(f"{name}: {json.dumps({k: v for k, v in g.items() if k != 'grad'})}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sppm_shard_grad.json").write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
