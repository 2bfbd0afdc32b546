"""`bench_torch.py`, the port's counterpart of `bench.py`, on the CPU at toy
sizes: the final line's `detail` keys are the ones `bench.py` writes (read
from its source, which is not imported: it imports JAX) plus the card's name
and power limit; every leg prints its line before the final one; without
`--device` and without a card the run stops at `require_cuda`'s error; a
failing leg leaves the lines of the legs before it.  The mesh is built at
subdiv 2 (324 triangles) through `bench_torch.MESH_SUBDIV`.
"""

from __future__ import annotations

import ast
import contextlib
import io
import itertools
import json
import math
import os
import pathlib

import pytest
import torch

import bench_torch
import chip_smoke
from gpu_pathtracer_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = dict(BENCH_SIZE="8", BENCH_SPP="1", BENCH_LEVEL="2", BENCH_PHOTONS="64",
           BENCH_SPPM_SIZE="8", BENCH_SPPM_PHOTONS="64", BENCH_DIFF_SPPM_SIZE="8",
           BENCH_DIFF_SPPM_PHOTONS="64", BENCH_REPEATS="1")
LEGS = ["forward", "backward", "photon_pass", "glass_dof", "mesh", "sppm_cornell", "sppm_fog",
        "diff_sppm"]


def bench_py_detail_keys() -> set[str]:
    """The keys `bench.py` writes into `detail`: its `detail = {...}`
    literal and every `detail["..."]` / `detail[f"..."]`, an f-string
    expanded over the values that its loop variables take."""
    tree = ast.parse((REPO / "bench.py").read_text())
    loop_values = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Tuple):
            rows = ast.literal_eval(node.iter)
            for k, name in enumerate(node.target.elts):
                loop_values[name.id] = [row[k] for row in rows]
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "detail" for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
              and node.value.id == "detail"):
            key = node.slice
            if isinstance(key, ast.Constant):
                keys.add(key.value)
                continue
            names = [part.value.id for part in key.values if isinstance(part, ast.FormattedValue)]
            for combo in itertools.product(*(loop_values[n] for n in names)):
                values = dict(zip(names, combo))
                keys.add("".join(str(values[part.value.id]) if isinstance(part, ast.FormattedValue)
                                 else part.value for part in key.values))
    return keys


def run_bench(mp: pytest.MonkeyPatch, argv, **env):
    """`bench_torch.main(argv)` with every knob at its toy size (`env` on
    top); returns the lines it printed, parsed, and the exception it raised."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            mp.delenv(k)
    for k, v in {**TOY, **env}.items():
        mp.setenv(k, v)
    mp.setattr(bench_torch, "MESH_SUBDIV", 2)
    out, raised = io.StringIO(), None
    with contextlib.redirect_stdout(out):
        try:
            assert bench_torch.main(argv) == 0
        except RuntimeError as e:
            raised = e
    return [json.loads(line) for line in out.getvalue().splitlines()], raised


@pytest.fixture(scope="module")
def cornell_run():
    with pytest.MonkeyPatch.context() as mp:
        lines, raised = run_bench(mp, ["--device", "cpu"])
    assert raised is None, raised
    return lines


def test_detail_keys_are_bench_py_keys(cornell_run):
    keys = bench_py_detail_keys()
    assert len(keys) == 26 and {"sppm_pass_seconds_fog", "grad_rays_per_sec"} <= keys
    assert set(cornell_run[-1]["detail"]) == keys | {"device", "power_limit"}
    # phase 22 of chip_smoke.py holds the card's run to the same keys
    assert chip_smoke.BENCH_DETAIL_KEYS == keys | {"device", "power_limit"}
    assert chip_smoke.BENCH_LEGS == tuple(LEGS)


def test_cpu_run_prints_a_line_per_leg(cornell_run):
    legs, final = cornell_run[:-1], cornell_run[-1]
    assert [leg["leg"] for leg in legs] == LEGS
    detail = final["detail"]
    for leg in legs:
        assert len(leg["seconds"]) == 1 and leg["median_s"] == leg["seconds"][0] > 0
        assert leg["peak_gb"] is None  # no device memory on the CPU
        # the plain versions on the CPU: no kernel launched
        assert leg["launches"] == {k: [0] for k in _build.KERNELS}
        mine = {k: v for k, v in leg.items()
                if k not in ("leg", "seconds", "median_s", "peak_gb", "launches")}
        assert mine and all(detail[k] == v for k, v in mine.items()), leg
    assert final["metric"] == "rays_per_sec_fwd_512" and final["unit"] == "rays/s"
    assert final["vs_baseline"] is None
    assert math.isclose(final["value"] * detail["seconds_fwd"], 8 * 8 * 1 * 2, rel_tol=1e-9)
    assert detail["seconds_fwd"] == legs[0]["median_s"]
    assert detail["backend"] == "cpu" and detail["device"] == "cpu"
    assert detail["power_limit"] is None
    assert (detail["size"], detail["spp"], detail["level"], detail["scene"]) == (8, 1, 2, "cornell")
    assert detail["num_tris"] == 972 and detail["mesh_num_tris"] == 324
    assert (detail["sppm_pass_size"], detail["sppm_pass_photons"]) == (8, 64)
    assert (detail["sppm_diff_size"], detail["sppm_diff_photons"]) == (8, 64)
    assert math.isclose(detail["grad_rays_per_sec"] * detail["seconds_bwd"], 8 * 8 * 1 * 2)
    assert math.isclose(detail["sppm_pixels_per_sec_fog"] * detail["sppm_pass_seconds_fog"], 64)


def test_without_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_torch, "render_image", lambda *a, **k: pytest.fail("rendered"))
    with pytest.MonkeyPatch.context() as mp:
        lines, raised = run_bench(mp, [])
    assert lines == [] and "no CUDA device is available" in str(raised)


def test_mesh_scene_names_its_metric(monkeypatch):
    lines, raised = run_bench(monkeypatch, ["--device", "cpu"], BENCH_SCENE="mesh")
    assert raised is None
    assert [line.get("leg") for line in lines[:-1]] == ["forward", "backward", "photon_pass"]
    final = lines[-1]
    assert final["metric"] == "rays_per_sec_fwd_mesh_8"
    assert final["detail"]["scene"] == "mesh" and final["detail"]["num_tris"] == 324


def test_a_failing_leg_keeps_the_lines_before_it(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("photon pass broke")

    monkeypatch.setattr(bench_torch.sppm, "photon_pass", broken)
    lines, raised = run_bench(monkeypatch, ["--device", "cpu"], BENCH_SCENE="mesh")
    assert str(raised) == "photon pass broke"
    assert [line.get("leg") for line in lines] == ["forward", "backward"]
