"""pack_ms_per_min (program span): stream milliseconds from each batch's
``analysis`` mark to its ``compaction`` mark (``utils/stages.py`` CUDA
events over the symbols, deposit, CRC-16 and compaction stages), summed
over the window's batches, per minute of audio encoded."""

from harness.readers import arm_stages as arm, per_minute, stage_ms  # noqa: F401


def read(run):
    ms = stage_ms(run, lambda stage: stage != "analysis")
    return None if ms is None else per_minute(run, ms)
