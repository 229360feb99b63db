"""session_ms_per_min (program span): host milliseconds of the encode
session around the pipeline, the spans ``session.setup`` (the config,
STREAMINFO and ``Encoder``), ``session.md5`` (the STREAMINFO MD5 of the raw
PCM, while the device works) and ``session.finish`` (the metadata blocks
and the output's join), summed over the window's calls, per minute of audio
encoded; each span is printed to stderr."""

from harness.program import arm, show, total_ms, totals  # noqa: F401
from harness.readers import per_minute

SPANS = ("session.setup", "session.md5", "session.finish")


def read(run):
    t = totals(run)
    if t is None or not any(n in t for n in SPANS):
        return None
    show("session_ms_per_min", t, SPANS)
    return per_minute(run, total_ms(t, *SPANS))
