"""What the benchmark imports: never JAX nor the JAX package, and its
reference nothing of the program.  Top-level module names are compared
whole (`gpu_pathtracer_tpu_torch` begins with `gpu_pathtracer_tpu`).

    python -m pytest benchmark/tests -q
"""

import ast
import json
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_pathtracer_tpu"}
PORT = "gpu_pathtracer_tpu_torch"


def _imported_tops(path: pathlib.Path) -> set:
    """Top-level names of every import statement in a file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def _harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_file_of_the_benchmark_or_the_port_imports_jax_or_the_jax_package():
    files = _harness_files() + list((ROOT / PORT).rglob("*.py"))
    found = {str(p.relative_to(ROOT)): sorted(_imported_tops(p) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = _imported_tops(path)
        assert PORT not in tops and not tops & FORBIDDEN, path


def test_a_run_loads_no_jax_module():
    """A whole (tiny, CPU) run of each cell, then the process's modules."""
    code = f"""
import sys, json, torch
torch.set_num_threads(1)
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import run
spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
for wl in [w["name"] for w in spec["workloads"]]:
    res = run.run_cell(wl, 2**33 + 5, 0.05, False, torch.device("cpu"),
                       overrides={{"traffic": dict(width=16, height=9, spp=1, level=2)}})
    assert res["correct"], res
print(json.dumps({{"forbidden": run.forbidden_modules(),
                  "port": any(m.split(".")[0] == {PORT!r} for m in sys.modules)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"forbidden": [], "port": True}


def test_the_reference_alone_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r})
from reference import pathtrace, scene_input
import check
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN | {PORT})!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_run_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    monkeypatch.setitem(sys.modules, "gpu_pathtracer_tpu_torch_probe", object())
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in FORBIDDEN]
    assert "gpu_pathtracer_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpu_pathtracer_tpu.probe", object())
    assert "gpu_pathtracer_tpu.probe" in run.forbidden_modules()
