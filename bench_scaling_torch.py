#!/usr/bin/env python3
"""Scaling-efficiency harness of the PyTorch port: `bench_scaling.py`'s
render, sweep, knobs and line, over the ranks of a `torch.distributed` job
instead of JAX devices.

    python3 bench_scaling_torch.py               # one rank a GPU over NCCL: N up to the card count
    python3 bench_scaling_torch.py --virtual 4   # 4 gloo ranks sharing one card: N = 1, 2, 4

The render is `bench_scaling.py`'s: the Cornell box with spheres (972
triangles), eye (0.5, 0.5, 2.4) looking at (0.5, 0.5, 0), fovy 40 degrees,
hittable_pdf_weight 0.5, through `parallel.shard.render_image_distributed`
(every rank draws the whole frame's numbers and traces its own columns, so
the image is the one-rank image bit for bit).  Knobs (environment
variables, `bench_scaling.py`'s, with its defaults): BENCH_SIZE (256),
BENCH_SPP (4), BENCH_LEVEL (4).

One job of V ranks runs the whole sweep, N in (1, 2, 4, 8, 16, 32) with
N <= V: V is the card count over NCCL, or the `--virtual V` ranks that share
one device over gloo (NCCL refuses two ranks on one GPU).  This process
holds no rank: it writes the scene, builds the kernels, starts the ranks
(`parallel.launch.run_ranks`) and prints the line.  For each N, the first N
ranks form a group and make a warm-up call (generator seeded 0) and a timed
call (seeded 1); the other ranks wait.  The timed window runs from a
barrier of every rank to the next one after the members' device
synchronization: the slowest member's wall.  Rank 0 holds each N's image
against the N = 1 image of the same seed, bit for bit; a mismatch exits
non-zero after the line is printed.

On one card a virtual sweep measures the sharding machinery and the host
(every member still draws the whole frame's numbers and runs every
wavefront step, and the ranks' CUDA contexts share the card in turns), not
scaling across GPUs; the NCCL sweep over several GPUs measures that.
`--device cpu` runs the ranks on the CPU with the kernels' plain versions
and exists for tests; without it the run needs a CUDA device.

Prints ONE JSON line, `bench_scaling.py`'s {"metric": "scaling_efficiency",
"value", "unit", "vs_baseline", "detail"}; `detail` adds
`collective_backend`, the card's name (`device`) and power limit
(`power_limit`), and each sweep entry adds `bit_for_bit` and, member by
member, its seconds, each kernel's launches, the collectives and the peak
device memory of the timed call.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from gpu_pathtracer_tpu_torch.device import nvidia_smi, resolve_device
from gpu_pathtracer_tpu_torch.models.camera import Camera
from gpu_pathtracer_tpu_torch.models.scene import build_scene
from gpu_pathtracer_tpu_torch import tracing
from gpu_pathtracer_tpu_torch.ops import _build
from gpu_pathtracer_tpu_torch.parallel import dist as pdist
from gpu_pathtracer_tpu_torch.parallel import launch, shard
from gpu_pathtracer_tpu_torch.utils import testscenes
from gpu_pathtracer_tpu_torch.utils.obj_io import load_scene

SIZES = (1, 2, 4, 8, 16, 32)
CAM = dict(eye=(0.5, 0.5, 2.4), center=(0.5, 0.5, 0.0), up=(0, 1, 0), fovy_deg=40.0)
RANK_TIMEOUT = 600  # seconds from the ranks' start to their exit; also any one collective's limit


def _args(argv):
    ap = argparse.ArgumentParser(prog="bench_scaling_torch.py")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="'cpu' runs the ranks on the CPU (for tests; default: the CUDA devices)")
    ap.add_argument("--virtual", type=int, default=None, metavar="V",
                    help="V gloo ranks sharing one device (default: one rank a GPU over NCCL)")
    ap.add_argument("--out", help=argparse.SUPPRESS)  # a rank's: the job's folder
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.virtual is not None and args.virtual < 1:
        ap.error("--virtual takes a rank count of 1 or more")
    return args


def _knobs() -> tuple[int, int, int]:
    return (int(os.environ.get("BENCH_SIZE", "256")), int(os.environ.get("BENCH_SPP", "4")),
            int(os.environ.get("BENCH_LEVEL", "4")))


def _layout(args) -> tuple[int, str]:
    """The job's rank count and collective backend."""
    if args.virtual is not None:
        return args.virtual, "gloo"
    if args.device == "cpu":
        return 1, "gloo"
    return torch.cuda.device_count(), "nccl"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank(args) -> int:
    """One rank of the job: the sweep's renders; writes its records to
    OUT/rank<r>.json (rank 0's also say whether each image is the one-rank
    image bit for bit)."""
    out = pathlib.Path(args.out)
    world, backend = _layout(args)
    size, spp, level = _knobs()
    store = launch.rendezvous(args.rank, world, out / "port", RANK_TIMEOUT)  # noqa: F841
    pdist.init_distributed(backend=backend, timeout=RANK_TIMEOUT)
    dev = resolve_device(args.device)  # under NCCL cuda:LOCAL_RANK, else cuda:0 or the CPU
    scene = build_scene(load_scene(out / "scene", "box.obj"), dev)
    camera = Camera.create(**CAM, width=size, height=size, device=dev)
    barrier = dist.new_group(backend="gloo")  # the timing barriers, on the host

    def render(mesh, seed):
        with torch.no_grad():
            img = shard.render_image_distributed(
                scene, camera, size, size, mesh, sample_size=spp, level=level,
                hittable_pdf_weight=0.5, generator=torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
        return img

    records, first = [], None
    for n in (n for n in SIZES if n <= world):
        group = dist.new_group(ranks=list(range(n)))  # collective: every rank, in order
        member = args.rank < n
        if member:
            mesh = shard.make_mesh(group, dev)
            render(mesh, 0)
        dist.barrier(group=barrier)
        before = tracing.launches()
        tracing.reset("collective.")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if member:
            img = render(mesh, 1)
            own = time.perf_counter() - t0
        dist.barrier(group=barrier)
        wall = time.perf_counter() - t0
        if not member:
            continue
        rec = {"n": n, "seconds": own, "wall": wall,
               "launches": {k: c - before[k] for k, c in tracing.launches().items()},
               "collectives": tracing.counts("collective."),
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None}
        if args.rank == 0:
            img = img.cpu()
            first = img if first is None else first  # N = 1 comes first
            rec["bit_for_bit"] = bool(torch.equal(img, first))
        records.append(rec)
    (out / f"rank{args.rank}.json").write_text(json.dumps({"rank": args.rank, "sweep": records}))
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _args(argv)
    if args.rank is not None:
        return _rank(args)
    dev = resolve_device(args.device)
    world, backend = _layout(args)
    size, spp, level = _knobs()
    with tempfile.TemporaryDirectory(prefix="bench_scaling_torch_") as tmp:
        out = pathlib.Path(tmp)
        (out / "scene").mkdir()
        testscenes.make_cornell_box(out / "scene", spheres=True, sphere_subdiv=2)
        if dev.type == "cuda":
            _build.build_many(list(_build.KERNELS))  # once, before V ranks would build them at once
        env = dict(os.environ, OMP_NUM_THREADS="1") if dev.type == "cpu" else None
        rank_argv = [sys.executable, pathlib.Path(__file__).resolve(), "--out", out]
        if args.device:
            rank_argv += ["--device", args.device]
        if args.virtual is not None:
            rank_argv += ["--virtual", str(args.virtual)]
        launch.run_ranks(rank_argv, world, out, RANK_TIMEOUT, env)
        ranks = [json.loads((out / f"rank{r}.json").read_text())["sweep"] for r in range(world)]
    ranks = [{rec["n"]: rec for rec in recs} for recs in ranks]  # each rank's records by N

    rays = size * size * spp * level
    results = []
    for n, lead in ranks[0].items():
        members = [recs[n] for recs in ranks[:n]]
        dt = max(m["wall"] for m in members)  # each rank starts its clock as it leaves the barrier
        results.append({"n": n, "seconds": round(dt, 4),
                        "rays_per_sec": round(rays / dt, 1), "bit_for_bit": lead["bit_for_bit"],
                        **{f"member_{k}": [m[k] for m in members]
                           for k in ("seconds", "launches", "collectives", "peak_gb")}})
    t1 = results[0]["seconds"]
    for rec in results:
        rec["efficiency"] = round(t1 / (rec["n"] * rec["seconds"]), 3)

    eff_at_max = results[-1]["efficiency"] if len(results) > 1 else 1.0
    on_card = dev.type == "cuda"
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": eff_at_max,
        "unit": f"t1/(N*tN) at N={results[-1]['n']}",
        "vs_baseline": round(eff_at_max / 0.8, 3),  # BASELINE's target efficiency, 0.8
        "detail": {
            "sweep": results,
            "size": size,
            "spp": spp,
            "level": level,
            "backend": dev.type,
            "virtual_mesh": args.virtual is not None,
            "collective_backend": backend,
            "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
            "power_limit": nvidia_smi() if on_card else None,
        },
    }), flush=True)
    wrong = [rec["n"] for rec in results if not rec["bit_for_bit"]]
    if wrong:
        print(f"bench_scaling_torch: the image at N = {wrong} is not the one-rank image bit for "
              "bit", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
