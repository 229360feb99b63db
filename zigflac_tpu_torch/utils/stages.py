"""Optional per-stage CUDA-event marks on the encode path, and the host's
spans and counters.

Off by default: while ``EVENTS`` is None, ``mark`` does nothing. Set
``EVENTS = []`` and every batch the pipeline runs on a CUDA device records
one event at its start ("begin") and one at the end of each stage
(analysis, symbols, deposit, crc, compaction); ``batch_ms`` turns them into
per-batch stage times once the device has finished.

Host spans and counters are off the same way: while ``SPANS`` is None,
``span`` and ``entry`` return one shared no-op context manager (no clock
read, no allocation), and while ``COUNTS`` is None, ``count`` does nothing.
Set ``SPANS = []`` and every span appends ``(name, call_id, parent_index,
t0_ns, t1_ns)`` on the ``time.perf_counter_ns`` clock: ``parent_index`` is
the index in ``SPANS`` of the span that was open when it began (-1 for
none), and ``call_id`` numbers the entry-point call it belongs to. While a
``torch.profiler`` records, each span is also a ``record_function`` of its
name, so it lands in the profiler's record beside the device operations.
Spans are kept per process and assume one thread: the program opens them
only on its calling thread.

The LPC window search has a device interval of its own: while ``SEARCH``
is a list, every LPC search on a CUDA device appends a pair of CUDA events
around it (``lpc.search``: the lag sums to the chosen window's Rice
estimate), apart from the stage marks, so the ``analysis`` stage stays one
interval. While ``WINDOW_WINS`` is a dict, a search over several windows
adds, on the device and without waiting for it, the planes whose subframe
became LPC to the count of the window that won them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

EVENTS: Optional[List[Tuple[str, "torch.cuda.Event"]]] = None
# (name, call_id, parent_index, t0_ns, t1_ns); t1_ns is 0 while the span is open
SPANS: Optional[List[Tuple[str, int, int, int, int]]] = None
COUNTS: Optional[Dict[str, int]] = None
SEARCH: Optional[List[Tuple["torch.cuda.Event", "torch.cuda.Event"]]] = None
# window labels -> int64 [W] on the device: the LPC subframes each window won
WINDOW_WINS: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None

_open: List[int] = []  # indices in SPANS of the spans open now, innermost last
_calls = 0  # call ids handed out


def mark(stage: str) -> None:
    """Record a CUDA event on the current stream closing ``stage``."""
    if EVENTS is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        EVENTS.append((stage, ev))


def search_start(device: torch.device):
    """The start event of an ``lpc.search`` interval on ``device``: None
    while ``SEARCH`` is None or the device is not a card."""
    if SEARCH is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def search_end(start) -> None:
    """Close the interval ``search_start`` opened (nothing for None)."""
    if start is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        SEARCH.append((start, ev))


def tally_windows(windows, won: torch.Tensor, lpc: torch.Tensor) -> None:
    """Add each plane where ``lpc`` holds to ``WINDOW_WINS`` under the
    index ``won`` of its window, keyed by the windows' labels."""
    if WINDOW_WINS is None:
        return
    key = tuple(w.label for w in windows)
    tally = WINDOW_WINS.get(key)
    if tally is None:
        tally = WINDOW_WINS[key] = torch.zeros(len(key), dtype=torch.int64, device=won.device)
    tally.scatter_add_(0, won.reshape(-1), lpc.reshape(-1).to(torch.int64))


def batch_ms(events: List[Tuple[str, "torch.cuda.Event"]]) -> List[Dict[str, float]]:
    """One dict per batch: stage -> device milliseconds since the mark
    before it. Call after ``torch.cuda.synchronize()``."""
    out: List[Dict[str, float]] = []
    prev = None
    for stage, ev in events:
        if stage == "begin":
            out.append({})
        else:
            out[-1][stage] = prev.elapsed_time(ev)
        prev = ev
    return out


_OFF = contextlib.nullcontext()  # every span while tracing is off


class _Span:
    __slots__ = ("name", "spans", "index", "rf")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        global _calls
        spans = self.spans = SPANS
        if _open:
            parent = _open[-1]
            call = spans[parent][1]
        else:
            parent, _calls = -1, _calls + 1
            call = _calls
        self.index = len(spans)
        spans.append((self.name, call, parent, time.perf_counter_ns(), 0))
        _open.append(self.index)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        # read before the profiler's range closes, as before it opened: both
        # ends take the same side of the range's own cost, which keeps a span
        # within tens of microseconds of its profiler event
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.pop()
        name, call, parent, t0, _ = self.spans[self.index]
        self.spans[self.index] = (name, call, parent, t0, t1)
        return False


def span(name: str):
    """A context manager timing the host work inside it as ``name``."""
    return _OFF if SPANS is None else _Span(name)


def entry(name: str):
    """The span of a public entry point: a root with a new call id where
    no span is open; inside another span (one entry point calling another)
    it records nothing, so a call is counted once."""
    return _OFF if SPANS is None or _open else _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]``."""
    if COUNTS is not None:
        COUNTS[name] = COUNTS.get(name, 0) + n


def totals(spans=None) -> Dict[str, Tuple[int, float, float]]:
    """``{name: (count, total_ms, self_ms)}`` over the closed spans of
    ``spans`` (default ``SPANS``). Self time is a span's duration less the
    durations of its child spans, which lie inside it and do not overlap."""
    spans = SPANS if spans is None else spans
    if not spans:
        return {}
    child_ns = [0] * len(spans)
    for s in spans:
        if s[4] and s[2] >= 0:
            child_ns[s[2]] += s[4] - s[3]
    out: Dict[str, Tuple[int, float, float]] = {}
    for i, s in enumerate(spans):
        if not s[4]:
            continue
        n, tot, own = out.get(s[0], (0, 0.0, 0.0))
        d = s[4] - s[3]
        out[s[0]] = (n + 1, tot + d / 1e6, own + (d - child_ns[i]) / 1e6)
    return out
