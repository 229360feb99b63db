"""decode_parse_ms_per_min (program counter): the host seconds of the
decoder's frame parse (``decoder.STATS["parse_s"]``, the C++
``parse_frames``) over the window, in milliseconds per minute of audio."""

from harness.readers import arm_decoder as arm, decoder_stats, per_minute  # noqa: F401


def read(run):
    s = decoder_stats().get("parse_s")
    return None if s is None or not run.done else per_minute(run, s * 1e3)
