"""h2d_ms_per_min (program span): host milliseconds of the pipeline's
copies to the device, the span ``pipeline.h2d`` (the int16 narrowing, the
pinned staging and the issue of the copy), summed over the window's calls,
per minute of audio encoded; the bytes (counter ``pipeline.h2d_bytes``) and
their rate over the span go to stderr."""

from harness.program import arm, counts, rate, total_ms, totals  # noqa: F401
from harness.readers import per_minute


def read(run):
    t = totals(run)
    if t is None or "pipeline.h2d" not in t:
        return None
    rate("h2d_ms_per_min", t, "pipeline.h2d", (counts(run) or {}).get("pipeline.h2d_bytes"))
    return per_minute(run, total_ms(t, "pipeline.h2d"))
