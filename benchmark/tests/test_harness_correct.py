"""The comparison that decides `correct`, shown to fail: a whole run of each
cell on the CPU at a small frame (the look for a chip skipped), sound, with
the control in the program's place, and with the timed path broken
underneath in each way of `faults.py`.

    python -m pytest benchmark/tests -q
"""

import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import faults  # noqa: E402
import run  # noqa: E402

CELLS = ["cornell.forward"]
SEED = 2**33 + 17


def small(cell):
    """The cell's own sampling on a 24x14 frame."""
    return {"traffic": dict(width=24, height=14)}


def loop_class():
    return run.load_module(BENCH / "loops" / "render_frames.py").Loop


def run_small(cell, factory=None):
    torch.set_num_threads(1)
    return run.run_cell(cell, SEED, 0.05, False, torch.device("cpu"),
                        loop_factory=factory, overrides=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(cell):
    """The reference computed in bfloat16 (the precision below the
    configuration's float32) in the program's place."""
    base = loop_class()

    class Control(base):
        def check(self):
            return base.check(self, reference_dtype=torch.bfloat16)

    res = run_small(cell, Control)
    share = res["checks"]["mismatch_share"]
    assert not res["correct"] and share["value"] > share["limit"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    base = loop_class()

    class Broken(base):
        def setup(self):
            base.setup(self)
            self.undo = faults.FAULTS[fault](self)

        def release(self):
            self.undo()
            base.release(self)

    res = run_small(cell, Broken)
    assert not res["correct"], res["checks"]
