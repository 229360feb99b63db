"""clip_p95_ms (host clock): the 95th percentile (linear between ranks) of
the wall time of every call in the window, one call a clip; a call that
failed counts as never returning."""

import sys

import numpy as np


def read(run):
    if not run.calls:
        return None
    walls = [(c.end - c.start) * 1e3 if c.ok else float("inf") for c in run.calls]
    print(f"clip_p95_ms over {len(walls)} calls", file=sys.stderr)
    return float(np.percentile(walls, 95))
