"""analysis_ms_per_min (program span): stream milliseconds from each
batch's ``begin`` mark to its ``analysis`` mark (``utils/stages.py`` CUDA
events: the analysis's device time and the host's issue gaps inside it),
summed over the window's batches, per minute of audio encoded."""

from harness.readers import arm_stages as arm, per_minute, stage_ms  # noqa: F401


def read(run):
    ms = stage_ms(run, lambda stage: stage == "analysis")
    return None if ms is None else per_minute(run, ms)
