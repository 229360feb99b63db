"""What a traced window's ``torch.profiler`` record says: the device's busy
time, the device time of its non-copy operations, the operations that took
the most, and the longest idle gaps named by what the host was doing.

Busy time is the union of the device-side intervals (kernels, copies,
memsets) inside the window; host-side op entries, which carry their
kernels' time too, and the device-side ranges of user annotations (the
spans below) are left out (the arithmetic of ``chip_smoke.py``
phase 4-breakdown). The window is the span of the ``WINDOW`` annotation the
harness records around its timed loop.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW = "bench.window"
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    noncopy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union(spans):
    """Merged, sorted intervals of (start, end) pairs."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def reduce(prof) -> Trace:
    """Everything the readers take from one profiler record, read from its
    raw Kineto events (times in ns), which skips the profiler's slow
    Python-side parse of every event."""
    from torch.autograd import DeviceType

    events = [(e.name(), e.device_type(), e.start_ns(), e.end_ns(), e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()]
    win = [(a, b) for n, d, a, b, _ in events if n == WINDOW and d == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = win[0]
    dev, host = [], []
    for n, d, a, b, note in events:
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        if d == DeviceType.CUDA:
            if not note:  # a span's device-side range is no work
                dev.append((a, b, n))
        elif n != WINDOW:
            host.append((a, b, n))
    busy = union((a, b) for a, b, _ in dev)
    busy_ns = sum(b - a for a, b in busy)
    noncopy_ns = sum(b - a for a, b, n in dev if not is_copy(n))
    per_op = {}
    for a, b, n in dev:
        per_op[n] = per_op.get(n, 0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps: between merged busy intervals, and at the window's ends
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:TOP]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        named.append((min(inner)[1] if inner else "host (no span)", length / 1e9))
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, noncopy_s=noncopy_ns / 1e9,
                 device_ops=[(n[:120], ns / 1e9) for n, ns in ops], idle_gaps=named)


@contextlib.contextmanager
def spans(targets):
    """Name the host's work in the trace: while open, each (object,
    attribute, span name) in ``targets`` runs inside a ``record_function``
    of that name. A target the program no longer has is left out."""
    import torch

    undo = []
    for obj, attr, name in targets:
        raw = obj.__dict__.get(attr) if isinstance(obj, type) else getattr(obj, attr, None)
        if raw is None:
            continue
        is_cm = isinstance(raw, classmethod)
        fn = raw.__func__ if is_cm else raw

        def wrap(fn=fn, name=name):
            @functools.wraps(fn)
            def inner(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return inner

        new = classmethod(wrap()) if is_cm else wrap()
        setattr(obj, attr, new)
        undo.append((obj, attr, raw))
    try:
        yield
    finally:
        for obj, attr, raw in reversed(undo):
            setattr(obj, attr, raw)
