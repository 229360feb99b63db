"""decode_collect_ms_per_min (program span): host milliseconds of the
decoder's collect, the spans ``decoder.d2h`` (the wait for the synthesis
and the copy back), ``decoder.widen`` (to int64, the divergence check, the
frames laid end to end) and ``decoder.concat`` (the batches joined), summed
over the window's calls, per minute of audio decoded; the d2h bytes
(counter ``decoder.d2h_bytes``) and their rate go to stderr."""

from harness.program import arm, counts, rate, show, total_ms, totals  # noqa: F401
from harness.readers import per_minute

SPANS = ("decoder.d2h", "decoder.widen", "decoder.concat")


def read(run):
    t = totals(run)
    if t is None or not any(n in t for n in SPANS):
        return None
    show("decode_collect_ms_per_min", t, SPANS)
    rate("decode_collect_ms_per_min", t, "decoder.d2h",
         (counts(run) or {}).get("decoder.d2h_bytes"))
    return per_minute(run, total_ms(t, *SPANS))
