"""The program's own spans and counters, read over a traced window.

``zigflac_tpu_torch/utils/stages.py`` keeps them while ``SPANS`` and
``COUNTS`` are set: each span is ``(name, call_id, parent_index, t0_ns,
t1_ns)`` on the host's ``perf_counter_ns`` clock, each counter a sum. The
readers arm the tracer after the warm-up (as ``readers.arm_stages`` does
for the CUDA-event marks) and read it once the window has ended. A program
without the tracer gives every reader ``None``.
"""

from __future__ import annotations

import sys


def _stages():
    from zigflac_tpu_torch.utils import stages

    return stages if hasattr(stages, "totals") else None


def arm(run):
    stages = _stages()
    if stages is not None:
        stages.SPANS = []
        stages.COUNTS = {}


def totals(run):
    """``{span name: (count, total_ms, self_ms)}`` over the window, or
    None where the program recorded no span."""
    stages = _stages()
    if stages is None or not stages.SPANS or not run.done:
        return None
    return stages.totals()


def counts(run):
    stages = _stages()
    if stages is None or not stages.COUNTS or not run.done:
        return None
    return stages.COUNTS


def total_ms(t, *names):
    return sum(t[n][1] for n in names if n in t)


def self_ms(t, *names):
    return sum(t[n][2] for n in names if n in t)


def show(name: str, t, names) -> None:
    """Print each span's count, total and self milliseconds to stderr."""
    parts = [f"{n} {t[n][0]} x {t[n][1]:.3f} ms (self {t[n][2]:.3f})" for n in names if n in t]
    print(f"{name}: " + "; ".join(parts), file=sys.stderr)


def rate(name: str, t, span: str, nbytes) -> None:
    """Print the bytes a span moved and their rate over its time."""
    ms = total_ms(t, span)
    if nbytes is not None and ms > 0:
        print(f"{name}: {nbytes} B in {ms:.3f} ms, {nbytes / ms / 1e6:.3f} GB/s",
              file=sys.stderr)


def unspanned_pct(run, root: str):
    """100 x the time of the ``root`` entry-point spans that no child span
    covers, over their whole time."""
    t = totals(run)
    if t is None or root not in t or t[root][1] <= 0:
        return None
    n, total, own = t[root]
    print(f"unspanned of {root}: {own:.3f} of {total:.3f} ms over {n} calls", file=sys.stderr)
    return 100.0 * own / total
