"""feed_ms_per_min (program span): host milliseconds of the WAV feeder,
the spans ``wav.parse`` (``WavReader.from_bytes``), ``wav.planar_samples``
(the de-interleave) and ``wav.raw_copy`` (the copy of the raw PCM the MD5
covers), summed over the window's calls, per minute of audio encoded."""

from harness.program import arm, show, total_ms, totals  # noqa: F401
from harness.readers import per_minute

SPANS = ("wav.parse", "wav.planar_samples", "wav.raw_copy")


def read(run):
    t = totals(run)
    if t is None or not any(n in t for n in SPANS):
        return None
    show("feed_ms_per_min", t, SPANS)
    return per_minute(run, total_ms(t, *SPANS))
