"""The readings that a cell's limit is set from, on the card at the cell's
own size (not part of a benchmark run).

    python3 benchmark/control.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--fault-seeds <n> ...]

One process builds the cell's scene once, then for each seed renders the
run's first frame through the timed path and prints one JSON line: the
number compared for the program's frame (the lower reading); for the seeds
in `--control-seeds` the same number for the control, the reference
computed in bfloat16 and put in the program's place (the upper reading);
and for the seeds in `--fault-seeds` the number for the frame rendered with
each fault of `faults.py` planted in the timed path.  Each line also gives
the frame's seconds and the check's.
"""

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import check
    import faults

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    r = run.resolve(json.loads((run.ROOT / "BENCHMARK.json").read_text()), args.workload)
    loop = run.load_module(BENCH / "loops" / f"{r['traffic']['loop']}.py").Loop(
        r["config"], r["traffic"], args.seeds[0], device)
    loop.setup()
    def frame(seed):
        loop.seed, loop.frames, loop.failed = seed, [], 0
        loop.unit()

    for seed in args.seeds:
        t0 = time.perf_counter()
        frame(seed)
        t1 = time.perf_counter()
        pairs = loop.sample()
        ref = loop.reference_pixels(pairs)
        program, lit = check.mismatch_share(loop.program_pixels(pairs), ref)
        line = {"workload": args.workload, "seed": seed, "program": program, "lit": lit,
                "failed": loop.failed, "frame_s": t1 - t0,
                "check_s": time.perf_counter() - t1}
        if seed in args.fault_seeds:
            line["faults"] = {}
            for name, plant in sorted(faults.FAULTS.items()):
                undo = plant(loop)
                try:
                    frame(seed)
                finally:
                    undo()
                line["faults"][name] = check.mismatch_share(loop.program_pixels(pairs), ref)[0]
        if seed in args.control_seeds:
            t2 = time.perf_counter()
            low = loop.reference_pixels(pairs, torch.bfloat16)
            line["control"] = check.mismatch_share(low, ref)[0]
            line["control_s"] = time.perf_counter() - t2
            line["control_finite"] = bool(np.isfinite(low).all())
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
