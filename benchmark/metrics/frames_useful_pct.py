"""frames_useful_pct (program counter): 100 x the frames of the input over
the rows the device encoded for them, counters ``pipeline.frames_real`` and
``pipeline.frames_encoded`` over the window: a batch padded to its
power-of-two bucket encodes rows it throws away."""

import sys

from harness.program import arm, counts  # noqa: F401


def read(run):
    c = counts(run)
    if not c or not c.get("pipeline.frames_encoded"):
        return None
    real, encoded = c.get("pipeline.frames_real", 0), c["pipeline.frames_encoded"]
    print(f"frames_useful_pct: {real} frames of {encoded} rows encoded", file=sys.stderr)
    return 100.0 * real / encoded
