"""dispatch_ms_per_min (program span): host milliseconds of the pipeline's
dispatch, the self time of the spans ``pipeline.dispatch_batch`` and
``pipeline.dispatch_tail`` (the pad to the bucket and the issue of the
batch program; their ``pipeline.h2d`` children left out), summed over the
window's calls, per minute of audio encoded."""

from harness.program import arm, self_ms, show, totals  # noqa: F401
from harness.readers import per_minute

SPANS = ("pipeline.dispatch_batch", "pipeline.dispatch_tail")


def read(run):
    t = totals(run)
    if t is None or not any(n in t for n in SPANS):
        return None
    show("dispatch_ms_per_min", t, SPANS)
    return per_minute(run, self_ms(t, *SPANS))
