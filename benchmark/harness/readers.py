"""Arithmetic shared by the metric readers in ``benchmark/metrics/``."""

from __future__ import annotations

import sys


def rate(run):
    """Seconds of audio of the calls that came back, over the window."""
    return run.audio_s / run.window_s if run.done else None


def idle_pct(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, name: str):
    """The least time of the window's work (the entry's ``work``) over the
    device time of its non-copy operations."""
    from . import spec

    t = run.trace
    if t is None or t.noncopy_s <= 0:
        return None
    entry = spec.entry(run.traffic["entry"])
    work = [entry.work(run, i, out) for (i, out), c in zip(run.outputs, run.calls) if c.ok]
    least = sum(w["s"] for w in work)
    bound = "/".join(sorted({w["bound"] for w in work}))
    print(f"{name}: least {least} s ({bound}), device {t.noncopy_s} s", file=sys.stderr)
    return 100.0 * least / t.noncopy_s


def per_minute(run, ms: float):
    return ms / (run.audio_s / 60.0)


def arm_stages(run):
    if run.cuda:
        from zigflac_tpu_torch.utils import stages

        stages.EVENTS = []


def stage_ms(run, keep):
    """Stream milliseconds of the window's batches, summed over the stages
    (``utils/stages.py`` marks) for which ``keep(stage)`` holds."""
    from zigflac_tpu_torch.utils import stages

    if not stages.EVENTS or not run.done:
        return None
    return sum(v for b in stages.batch_ms(stages.EVENTS) for k, v in b.items() if keep(k))


def arm_decoder(run):
    from zigflac_tpu_torch import decoder

    decoder.STATS = {}


def decoder_stats():
    from zigflac_tpu_torch import decoder

    return decoder.STATS or {}
