"""synth_ms_per_min (program span): CUDA-event milliseconds around each
synthesis launch of the decoder (``decoder.STATS["synth_events"]``) over
the window, per minute of audio."""

from harness.readers import arm_decoder as arm, decoder_stats, per_minute  # noqa: F401


def read(run):
    ev = decoder_stats().get("synth_events")
    if not ev or not run.done:
        return None
    return per_minute(run, sum(a.elapsed_time(b) for a, b in ev))
