"""`BENCHMARK.json` against the contract's shapes, every cell resolving its
files by name, and the frozen inputs.

    python -m pytest benchmark/tests -q
"""

import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import run  # noqa: E402
from reference import pathtrace, scene_input  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_every_name_uses_only_letters_digits_underscore_dot_and_dash(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_short_unit_a_direction_and_a_source(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    allowed = ({"host_clock", "device_trace"} if "bound" in metric else
               {"device_trace", "program_span", "program_counter", "host_clock"})
    assert metric["source"] in allowed


def test_the_spec_keeps_to_the_contracts_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and 1 <= len(c["source"]) <= 200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    r = run.resolve(SPEC, cell)
    assert (BENCH / "loops" / f"{r['traffic']['loop']}.py").is_file()
    assert (BENCH / "scenes" / f"{r['config']['scene']['generator']}.py").is_file()
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(run.load_module(BENCH / "metrics" / f"{m['name']}.py").read)
    assert "setup_s" in {m["name"] for m in r["end_to_end"]} and len(r["end_to_end"]) >= 2
    assert r["per_layer"]


@pytest.mark.parametrize("config, triangles", [("cornell", 972)])
def test_the_frozen_generators_give_the_configurations_triangle_counts(config, triangles, tmp_path):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    gen = run.load_module(BENCH / "scenes" / f"{cfg['scene']['generator']}.py")
    arrays = scene_input.read_scene(gen.make(tmp_path, **cfg["scene"]["params"]))
    assert arrays["tri_p"].shape == (triangles, 3, 3) == (cfg["triangles"], 3, 3)
    assert np.isfinite(arrays["tri_n"]).all()
    ke = np.asarray(arrays["materials"]["ke"])[arrays["mat_idx"]]
    assert int((np.abs(ke).max(axis=1) > 0).sum()) == cfg["emitters"]


def test_the_references_reading_of_the_cornell_box_is_the_ports(tmp_path):
    from gpu_pathtracer_tpu_torch.utils.obj_io import load_scene

    gen = run.load_module(BENCH / "scenes" / "cornell_box.py")
    inputs = gen.make(tmp_path, spheres=True, sphere_subdiv=2)
    mine = scene_input.read_scene(inputs)
    port = load_scene(inputs["folder"], inputs["obj"])
    np.testing.assert_array_equal(mine["tri_p"], port.tri_p)
    np.testing.assert_array_equal(mine["tri_n"], port.tri_n)
    np.testing.assert_array_equal(mine["mat_idx"], port.mat_idx)
    for key in ("kd", "ks", "ke", "tf", "n_s", "n_i", "t_r", "priority"):
        np.testing.assert_array_equal(mine["materials"][key], getattr(port.materials, key), key)


@pytest.mark.parametrize("count", [2, 7, 33])
def test_the_references_light_tree_picks_as_the_ports(count):
    """Leaf order and selection pdfs of the reference's emitter tree against
    the port's, on random emitters."""
    from gpu_pathtracer_tpu_torch.ops import intersect, lights

    rng = np.random.default_rng(count)
    p = rng.random((count, 3, 3)).astype(np.float32)
    p[: count // 3] = p[0]  # equal boxes: ties in the Morton codes
    n = rng.standard_normal((count, 3, 3)).astype(np.float32)
    energy = (rng.random((count, 3)) * 10).astype(np.float32)
    mine = pathtrace._light_tree(p, n, energy, torch.device("cpu"), torch.float32)
    pt = torch.as_tensor(p)
    theirs = lights.build_light_tree(pt, torch.as_tensor(n), torch.zeros((count, 3, 2)),
                                     torch.as_tensor(energy),
                                     torch.arange(count, dtype=torch.int32))
    torch.testing.assert_close(mine.tri_p, theirs.tri_p, rtol=0, atol=0)
    torch.testing.assert_close(mine.area, intersect.triangle_area(theirs.tri_p))
    point = torch.as_tensor(rng.random((64, 3)).astype(np.float32)) * 2 - 0.5
    pivot = pathtrace.normalize(torch.as_tensor(rng.standard_normal((64, 3)).astype(np.float32)))
    torch.testing.assert_close(pathtrace.leaf_pdfs(mine, point, pivot),
                               lights.leaf_node_pdfs(theirs, point, pivot), rtol=1e-5, atol=1e-7)


def test_idle_share_leaves_the_profilers_cost_out():
    """Busy seconds a traced frame against an untraced frame's seconds, not
    against the traced window, which the profiler lengthens."""
    import types

    import devtrace

    read = run.load_module(BENCH / "metrics" / "idle_share.fwd.py").read
    trace = devtrace.Trace(window_s=7.0, busy_s=5.4, device={"k": (1, 5.4)}, idle_by_host={})
    run_ = types.SimpleNamespace(trace=trace, units=2, untraced_unit_s=3.0)
    assert read(run_) == pytest.approx(10.0)
    assert read(types.SimpleNamespace(trace=trace, units=2, untraced_unit_s=None)) is None
    assert read(types.SimpleNamespace(trace=None, units=0, untraced_unit_s=None)) is None
