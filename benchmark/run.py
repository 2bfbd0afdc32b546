"""The benchmark of the PyTorch and CUDA port (`gpu_pathtracer_tpu_torch`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (it exits non-zero, printing no result, without them).  Everything is
found by name from `BENCHMARK.json`: the cell's configuration file, its
traffic mix `benchmark/traffic/<traffic>.json`, the window loop that the
mix names (`benchmark/loops/<loop>.py`), and one reader a metric
(`benchmark/metrics/<metric>.py`, `read(run)` -> a number, or None when the
run has nothing to read).

A run: set-up (imports, CUDA context, the loop's scene and warm-up, which
builds the kernels into the checkout's `build/`), timed from the first line
of this file (`setup_s`); then the window.  With `--trace 0` the window runs
the loop's units of work back to back until `--seconds` have passed and
the end-to-end metrics are read; with `--trace 1` it times the mix's
`untraced_frames` units, then runs its `trace_frames` units under
`torch.profiler`, and the per-layer metrics are read.  After the window the device's memory peak is read, the program's
state is freed and the loop's check decides `correct`.  The last line of
standard output is the result; the numbers compared, with their limits, are
the last lines of standard error and the last key of the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_pathtracer_tpu")


def load_module(path: pathlib.Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(spec: dict, workload: str) -> dict:
    """The cell, its configuration, its traffic mix and its metrics, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "cell": cell,
        "config": json.loads((ROOT / config["file"]).read_text()),
        "traffic": traffic,
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def measure(loop, seconds: float, trace: bool, trace_units: int, untraced_units: int,
            device) -> types.SimpleNamespace:
    """The window; returns what the metric readers take.  A traced window
    first times `untraced_units` units without the profiler (the host-clock
    seconds of a unit as an untraced run sees it), then profiles
    `trace_units` units."""
    import torch

    import devtrace

    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = types.SimpleNamespace(setup_s=time.perf_counter() - T0, trace=None,
                                untraced_unit_s=None)
    units = 0
    if trace:
        t_free = time.perf_counter()
        for _ in range(untraced_units):
            loop.unit()
        if untraced_units:
            run.untraced_unit_s = (time.perf_counter() - t_free) / untraced_units
    t_start = time.perf_counter()
    if trace:
        run.trace = devtrace.profile_units(loop.unit, trace_units)
        units = trace_units
    else:
        while True:
            loop.unit()
            units += 1
            if time.perf_counter() - t_start >= seconds:
                break
    run.window_s = time.perf_counter() - t_start
    run.units = units
    run.work = units * loop.work_per_unit
    run.window_peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.memory_peak_bytes = max(setup_peak, run.window_peak_bytes)
    return run


def read_metrics(metrics: list, run) -> dict:
    out = {}
    for m in metrics:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, spec=None,
             loop_factory=None, overrides=None) -> dict:
    """One run of a cell on `device`: the result line's object (the numbers
    compared under its last key, "checks").  `overrides` ({"traffic": {...},
    "scene": {...}}) shrinks a cell for a test on the CPU."""
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    r = resolve(spec, workload)
    if overrides:
        r["traffic"].update(overrides.get("traffic", {}))
        r["config"]["scene"]["params"].update(overrides.get("scene", {}))
    if loop_factory is None:
        loop_factory = load_module(BENCH / "loops" / f"{r['traffic']['loop']}.py").Loop
    loop = loop_factory(r["config"], r["traffic"], seed, device)
    loop.setup()
    run = measure(loop, seconds, trace, r["traffic"].get("trace_frames", 1),
                  r["traffic"].get("untraced_frames", 0), device)
    loop.release()
    verdict = loop.check()
    metrics = read_metrics(r["per_layer"] if trace else r["end_to_end"], run)
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": r["cell"]["chips"], "memory_peak_bytes": run.memory_peak_bytes,
           "power_limit": power_limit() if device.type == "cuda" else None}
    result = {"correct": verdict["correct"], "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check_seconds"] = verdict["seconds"]
    result["checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program stays at a fixed place in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = resolve(spec, args.workload)["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"devices: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), spec)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
