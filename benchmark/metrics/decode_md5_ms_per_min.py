"""decode_md5_ms_per_min (program span): host milliseconds of the
decoder's STREAMINFO MD5 check, the span ``decoder.md5`` (its children
``decoder.md5.serialize``, the samples back to the WAV's bytes, and
``decoder.md5.hash``, printed to stderr), summed over the window's calls,
per minute of audio decoded."""

from harness.program import arm, show, total_ms, totals  # noqa: F401
from harness.readers import per_minute


def read(run):
    t = totals(run)
    if t is None or "decoder.md5" not in t:
        return None
    show("decode_md5_ms_per_min", t, ("decoder.md5", "decoder.md5.serialize", "decoder.md5.hash"))
    return per_minute(run, total_ms(t, "decoder.md5"))
