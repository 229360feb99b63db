"""collect_wait_ms_per_min (program span): host milliseconds the collect
waited for the device, the span ``pipeline.wait`` (the fetch of a batch's
frame sizes, which returns once the batch's device work is done), summed
over the window's calls, per minute of audio encoded."""

from harness.program import arm, total_ms, totals  # noqa: F401
from harness.readers import per_minute


def read(run):
    t = totals(run)
    if t is None or "pipeline.wait" not in t:
        return None
    return per_minute(run, total_ms(t, "pipeline.wait"))
