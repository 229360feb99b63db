"""collect_ms_per_min (program span): host milliseconds of the collect
besides the wait for the device: the self time of the spans
``pipeline.collect_batch`` (the bookkeeping, and the issue of any overflow
re-encode) and their ``pipeline.d2h`` (the copy back) and
``pipeline.assemble`` (the byte swap and the frames laid end to end)
children, plus ``pipeline.join`` (the frame chunks and sizes joined),
summed over the window's calls, per minute of audio encoded. Left out: the
``pipeline.wait`` children (``collect_wait_ms_per_min``) and the
``pipeline.h2d`` of a re-encode (``h2d_ms_per_min``), so that the encode
metrics split a call without counting a span twice. The d2h bytes (counter
``pipeline.d2h_bytes``) and their rate go to stderr."""

from harness.program import arm, counts, rate, self_ms, show, total_ms, totals  # noqa: F401
from harness.readers import per_minute

SPANS = ("pipeline.collect_batch", "pipeline.wait", "pipeline.d2h", "pipeline.assemble",
         "pipeline.join")


def read(run):
    t = totals(run)
    if t is None or "pipeline.collect_batch" not in t:
        return None
    show("collect_ms_per_min", t, SPANS)
    rate("collect_ms_per_min", t, "pipeline.d2h", (counts(run) or {}).get("pipeline.d2h_bytes"))
    ms = self_ms(t, "pipeline.collect_batch") + total_ms(t, "pipeline.d2h", "pipeline.assemble",
                                                         "pipeline.join")
    return per_minute(run, ms)
