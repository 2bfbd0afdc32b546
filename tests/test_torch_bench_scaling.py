"""`bench_scaling_torch.py`, the port's counterpart of `bench_scaling.py`, and
the rank launch under it (`gpu_pathtracer_tpu_torch/parallel/launch.py`), on
the CPU: the final line's keys are `bench_scaling.py`'s (read from its
source, which is not imported: it imports JAX) plus the port's additions; a
two-rank virtual sweep over gloo at 8x8 gives the one-rank image bit for bit
at N = 2 and `bench_scaling.py`'s arithmetic; without `--device` and without
a card the run stops at `require_cuda` before it starts a rank; a failed
rank is named with how it ended and its log's tail; `make_mesh` refuses a
group that this process is not a member of.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import pathlib
import sys
import types

import pytest
import torch

import bench_scaling_torch
import bench_torch
import chip_smoke
from gpu_pathtracer_tpu_torch import device
from gpu_pathtracer_tpu_torch.ops import _build
from gpu_pathtracer_tpu_torch.parallel import launch

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = dict(BENCH_SIZE="8", BENCH_SPP="1", BENCH_LEVEL="2")
RANK_TIMEOUT = 240  # seconds for a two-rank job of the tier-1 run, whose six workers share the CPUs
DETAIL_ADDED = {"collective_backend", "device", "power_limit"}
SWEEP_ADDED = {"bit_for_bit", "member_seconds", "member_launches", "member_collectives",
               "member_peak_gb"}


def bench_scaling_keys() -> tuple[set[str], set[str], set[str]]:
    """The keys of `bench_scaling.py`'s final line, of its `detail` and of a
    sweep record (the dict it appends, and `rec["..."] = ...` after)."""
    tree = ast.parse((REPO / "bench_scaling.py").read_text())
    dicts = [node for node in ast.walk(tree) if isinstance(node, ast.Dict)]

    def keys(d):
        return {k.value for k in d.keys}

    final = next(d for d in dicts if "metric" in keys(d))
    detail = final.values[[k.value for k in final.keys].index("detail")]
    record = keys(next(d for d in dicts if "rays_per_sec" in keys(d)))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            record |= {t.slice.value for t in node.targets if isinstance(t, ast.Subscript)
                       and isinstance(t.value, ast.Name) and t.value.id == "rec"}
    return keys(final), keys(detail), record


def run_harness(mp: pytest.MonkeyPatch, argv) -> tuple[list[str], BaseException | None]:
    """`bench_scaling_torch.main(argv)` with the knobs at `TOY`; returns the
    lines it printed and the exception it raised."""
    for k, v in TOY.items():
        mp.setenv(k, v)
    mp.setattr(bench_scaling_torch, "RANK_TIMEOUT", RANK_TIMEOUT)
    out, raised = io.StringIO(), None
    with contextlib.redirect_stdout(out):
        try:
            assert bench_scaling_torch.main(argv) == 0
        except RuntimeError as e:
            raised = e
    return out.getvalue().splitlines(), raised


@pytest.fixture(scope="module")
def virtual_run():
    """The lines of a `--device cpu --virtual 2` run at 8x8, spp 1, level 2."""
    with pytest.MonkeyPatch.context() as mp:
        lines, raised = run_harness(mp, ["--device", "cpu", "--virtual", "2"])
    assert raised is None, raised
    return lines


def test_line_keys_are_bench_scaling_keys(virtual_run):
    final_keys, detail_keys, record_keys = bench_scaling_keys()
    assert final_keys == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert detail_keys == {"sweep", "size", "spp", "level", "backend", "virtual_mesh"}
    assert record_keys == {"n", "seconds", "rays_per_sec", "efficiency"}
    line = json.loads(virtual_run[-1])
    assert set(line) == final_keys
    assert set(line["detail"]) == detail_keys | DETAIL_ADDED
    assert all(set(rec) == record_keys | SWEEP_ADDED for rec in line["detail"]["sweep"])
    # phase 23 of chip_smoke.py holds the card's runs to the same keys
    assert chip_smoke.SCALING_KEYS == final_keys
    assert chip_smoke.SCALING_DETAIL_KEYS == detail_keys | DETAIL_ADDED
    assert chip_smoke.SCALING_SWEEP_KEYS == record_keys | SWEEP_ADDED
    assert chip_smoke.SCALING_SIZES == bench_scaling_torch.SIZES


def test_virtual_sweep_is_bit_for_bit(virtual_run):
    """N = 1 and 2 over gloo; the two-rank image is the one-rank image bit for
    bit; each member names its seconds, launches (none: the plain versions on
    the CPU), collectives (the image's one all-gather) and peak memory (none
    on the CPU)."""
    sweep = json.loads(virtual_run[-1])["detail"]["sweep"]
    assert [rec["n"] for rec in sweep] == [1, 2]
    for rec in sweep:
        n = rec["n"]
        assert rec["bit_for_bit"] is True
        assert len(rec["member_seconds"]) == n
        assert all(0 < t <= rec["seconds"] + 1e-4 for t in rec["member_seconds"])
        assert rec["member_launches"] == [{k: 0 for k in _build.KERNELS}] * n
        assert rec["member_collectives"] == [{"all_gather": 1}] * n
        assert rec["member_peak_gb"] == [None] * n


def test_virtual_line_is_bench_scaling_arithmetic(virtual_run):
    line = json.loads(virtual_run[-1])
    detail, sweep = line["detail"], line["detail"]["sweep"]
    t1 = sweep[0]["seconds"]
    for rec in sweep:
        assert rec["seconds"] > 0 and rec["seconds"] == round(rec["seconds"], 4)
        assert rec["efficiency"] == round(t1 / (rec["n"] * rec["seconds"]), 3)
        assert math.isclose(rec["rays_per_sec"] * rec["seconds"], 8 * 8 * 1 * 2, rel_tol=1e-2)
    assert line["metric"] == "scaling_efficiency"
    assert line["value"] == sweep[-1]["efficiency"]
    assert line["unit"] == "t1/(N*tN) at N=2"
    assert line["vs_baseline"] == round(line["value"] / 0.8, 3)
    assert (detail["size"], detail["spp"], detail["level"]) == (8, 1, 2)
    assert detail["virtual_mesh"] is True and detail["backend"] == "cpu"
    assert detail["collective_backend"] == "gloo"
    assert detail["device"] == "cpu" and detail["power_limit"] is None
    assert len(virtual_run) == 1  # the JSON line is the last line, and the only one


def test_without_device_requires_cuda(monkeypatch):
    """No card and no `--device`: `require_cuda`'s error before any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "run_ranks", lambda *a, **k: pytest.fail("a rank was started"))
    lines, raised = run_harness(monkeypatch, [])
    assert lines == [] and "no CUDA device is available" in str(raised)


RANK_CHILD = r'''
import os, sys, time
rank = int(sys.argv[sys.argv.index("--rank") + 1])
print("LOCAL_RANK", os.environ["LOCAL_RANK"], "GPT_TPU", sorted(k for k in os.environ
      if k.startswith("GPT_TPU_")), "GLOO", os.environ["GLOO_SOCKET_IFNAME"], flush=True)
if rank == 1:
    print("rank 1's last words", flush=True)
    if sys.argv[1] == "exit":
        sys.exit(3)
    time.sleep(60)
'''


@pytest.mark.parametrize("how", ["exit", "limit"])
def test_run_ranks_names_the_failed_rank(tmp_path, monkeypatch, how):
    """A rank that exits 3, or one still running at the job's limit, is named
    with how it ended, its seconds and its log's tail; the other rank is not
    named.  Each rank's environment has its `LOCAL_RANK` and no inherited
    `GPT_TPU_*` variable."""
    monkeypatch.setenv("GPT_TPU_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(RuntimeError) as err:
        launch.run_ranks([sys.executable, "-c", RANK_CHILD, how], 2, tmp_path,
                         timeout=30 if how == "exit" else 5)
    msg = str(err.value)
    assert msg.startswith("1 of 2 ranks failed")
    want = ("rank 1 exited with code 3 after" if how == "exit" else
            "rank 1 killed by SIGKILL at the job's limit of 5 s after")
    assert want in msg and "rank 0 " not in msg
    assert "rank 1's last words" in msg and "LOCAL_RANK 1 GPT_TPU [] GLOO lo" in msg
    assert (tmp_path / "rank0.log").read_text().startswith("LOCAL_RANK 0 GPT_TPU [] GLOO lo")


MESH_CHILD = r'''
import pathlib, sys
sys.path.insert(0, %(repo)r)
import torch.distributed as dist
from gpu_pathtracer_tpu_torch.parallel import dist as pdist, launch, shard
rank, out = int(sys.argv[sys.argv.index("--rank") + 1]), pathlib.Path(sys.argv[1])
store = launch.rendezvous(rank, 2, out / "port", %(timeout)d)
assert pdist.init_distributed(backend="gloo", timeout=%(timeout)d)
group = dist.new_group(ranks=[0])  # collective: both ranks
try:
    mesh = shard.make_mesh(group, device="cpu")
    print("member", mesh.rank, mesh.size, flush=True)
except ValueError as e:
    print("refused:", e, flush=True)
world = shard.make_mesh(device="cpu")
print("world", world.rank, world.size, flush=True)
dist.barrier()
dist.destroy_process_group()
'''


def test_make_mesh_refuses_a_group_without_this_process(tmp_path):
    """A group of rank 0 alone: rank 0 builds its mesh of one, rank 1 gets a
    ValueError (`get_rank(group)` is -1 there); both build the world's."""
    code = MESH_CHILD % {"repo": str(REPO), "timeout": RANK_TIMEOUT}
    launch.run_ranks([sys.executable, "-c", code, tmp_path], 2, tmp_path, RANK_TIMEOUT,
                     dict(os.environ, OMP_NUM_THREADS="1"))
    logs = [[line for line in (tmp_path / f"rank{r}.log").read_text().splitlines()
             if line.startswith(("member", "refused", "world"))] for r in range(2)]  # not c10d's
    assert logs[0] == ["member 0 1", "world 0 2"]
    assert logs[1][0].startswith("refused: this process (rank 1 of the job) is not a member")
    assert logs[1][1:] == ["world 1 2"]


def test_one_card_query(monkeypatch):
    """`device.nvidia_smi` is the one copy of the card query: the bench, the
    harness and chip_smoke.py all call it."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\nsecond card\n")

    monkeypatch.setattr(device.subprocess, "run", run)
    assert device.nvidia_smi() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert chip_smoke.nvidia_smi() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert bench_torch.nvidia_smi is device.nvidia_smi
    assert bench_scaling_torch.nvidia_smi is device.nvidia_smi
    assert calls == [["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]] * 2
