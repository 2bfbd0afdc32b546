"""The comparison that decides `correct` for rendered frames.

A pixel of a frame is judged against the reference's value of the same
pixel from the same uniforms (`reference/pathtrace.py`): it matches when every
channel lies within RTOL of the larger of the two values, or of a floor of
FLOOR times the mean reference value of the checked pixels, whichever is
larger.  Pixels that are black on both sides are not counted.  The number
compared is the share of the remaining pixels that do not match; its limit
is the configuration's `check.mismatch_share`.
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-3
FLOOR = 1e-2


def mismatch_share(program: np.ndarray, reference: np.ndarray) -> tuple[float, int]:
    """(share of the lit pixels that do not match, lit pixels counted) for
    (K, 3) pixel values of the program and of the reference."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    finite = np.isfinite(program).all(axis=1)
    lit = (np.abs(program).max(axis=1) > 0) | (np.abs(reference).max(axis=1) > 0) | ~finite
    if not lit.any():
        return 0.0, 0
    floor = FLOOR * float(np.abs(reference[lit]).mean())
    scale = np.maximum(np.maximum(np.abs(program), np.abs(reference)), floor)
    bad = (np.abs(program - reference) > RTOL * scale).any(axis=1) | ~finite
    return float(bad[lit].mean()), int(lit.sum())
