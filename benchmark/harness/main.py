"""One run of one cell: set-up, the timed window, the readers, the check.

The cell's traffic mix names its pool (sizes and count), the entry point it
drives and how the outputs are checked. Set-up makes the pool from the
seed, prepares the entry and warms it up on the pool's sizes. The window is
a closed loop with one client: calls one item after another in a seeded
order, starting at the first call after the warm-up and ending when the
last call that started before ``--seconds`` ran out has returned. The items
whose outputs are compared in full are drawn from the seed before the
window; of every other call the window keeps only the entry's short digest,
so what a run holds does not grow with the rate. Then the metrics' readers
run, the program's state is freed, the outputs are checked against the
plain reference, and one JSON line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time
import traceback
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import nojax, signal, spec
from . import trace as tr


@dataclass
class Call:
    item: int
    start: float
    end: float
    ok: bool


@dataclass
class Run:
    """What a run knows: what readers and checks read."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any
    traced: bool
    pool: list = field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: List[Call] = field(default_factory=list)
    checked: List[int] = field(default_factory=list)     # items compared in full
    outputs: List[tuple] = field(default_factory=list)   # (item, the entry's keep())
    trace: Optional[tr.Trace] = None
    state: Dict[str, Any] = field(default_factory=dict)  # the entry's and readers'

    @property
    def done(self) -> List[Call]:
        return [c for c in self.calls if c.ok]

    @property
    def audio_s(self) -> float:
        return sum(self.pool[c.item].seconds for c in self.done)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: the entry's control (the plain reference computed with one "
                        "of the configuration's guarantees broken) in the program's place")
    return p.parse_args(argv)


def warm_items(traffic: dict, pool: list) -> list:
    """``warmup`` items spread evenly over the pool sorted by length, the
    shortest and the longest among them."""
    k = min(int(traffic["warmup"]), len(pool))
    by_len = sorted(range(len(pool)), key=lambda i: pool[i].samples)
    if k <= 1:
        return by_len[:k]
    return sorted({by_len[round(j * (len(pool) - 1) / (k - 1))] for j in range(k)})


def checked_items(seed: int, traffic: dict, pool: list) -> list:
    """The mix's ``check.items`` items whose outputs are compared in full:
    the longest, then the items of the window's first calls in their
    seeded order."""
    k = min(int(traffic["check"]["items"]), len(pool))
    if k == 0:
        return []
    longest = max(range(len(pool)), key=lambda i: (pool[i].samples, -i))
    first = itertools.islice(signal.call_order(seed, len(pool)), len(pool))
    return [longest] + [i for i in first if i != longest][: k - 1]


def main(argv, t0: float, device=None, traffic_overrides: Optional[dict] = None) -> int:
    """Exit code 0 with the result line printed, else non-zero and no
    result. ``device`` and ``traffic_overrides`` are for the harness's own
    tests, which run on the CPU at a small size."""
    args = parse(argv)
    import torch

    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("torch.cuda.is_available() is false", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} cards, {torch.cuda.device_count()} "
                  "visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = Run(cell=cell, config=spec.config(bench, cell["config"]),
              traffic=dict(spec.traffic(cell["traffic"]), **(traffic_overrides or {})),
              seed=args.seed, seconds=args.seconds, device=torch.device(device),
              traced=bool(args.trace))
    entry = spec.entry(run.traffic["entry"])
    metrics = spec.metrics_of(bench, cell["name"], run.traced)
    readers = {m["name"]: spec.metric(m["name"]) for m in metrics}

    # -- set-up: the pool, the entry, the warm-up on the pool's sizes
    marks = [("imports", time.perf_counter())]
    run.pool = signal.make_pool(args.seed, run.traffic, run.config["format"], run.device)
    marks.append(("pool", time.perf_counter()))
    run.checked = checked_items(args.seed, run.traffic, run.pool)
    entry.prepare(run)
    marks.append(("prepare", time.perf_counter()))
    call = entry.control if args.control else entry.call
    for i in warm_items(run.traffic, run.pool):
        call(run, i)
    marks.append(("warm-up", time.perf_counter()))
    if run.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for r in readers.values():
        if hasattr(r, "arm"):
            r.arm(run)
    order = signal.call_order(args.seed, len(run.pool))
    per_item = int(run.traffic["check"]["per_item"])
    full_left = Counter({i: per_item for i in run.checked})
    prof = contextlib.nullcontext()
    if run.traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda else [])
        prof = profile(activities=acts)

    # -- the window
    with prof as p, (tr.spans(entry.spans()) if run.traced else contextlib.nullcontext()):
        with (torch.profiler.record_function(tr.WINDOW) if run.traced
              else contextlib.nullcontext()):
            w0 = time.perf_counter()
            deadline = w0 + args.seconds
            while time.perf_counter() < deadline:
                i = next(order)
                s = time.perf_counter()
                try:
                    out, ok = call(run, i), True
                except Exception:
                    traceback.print_exc(file=sys.stderr)
                    out, ok = None, False
                run.calls.append(Call(i, s, time.perf_counter(), ok))
                full = full_left[i] > 0
                full_left[i] -= full
                run.outputs.append((i, entry.keep(run, i, out, full) if ok else None))
                del out
            w1 = time.perf_counter()
    run.setup_s = w0 - t0
    run.window_s = w1 - w0
    if run.cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    if run.traced:
        run.trace = tr.reduce(p)
        del p, prof
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- the check, once the program's state is freed
    entry.release(run)
    if run.cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks = entry.check(run)
    marks.append(("check", time.perf_counter()))
    failed = sum(not c.ok for c in run.calls)
    checks["calls_failed"] = (failed, 0)
    correct = all(v <= lim for v, lim in checks.values())

    bad = nojax.loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    device_info = {
        "platform": "gpu" if run.cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
        "count": cell["chips"] if run.cuda else 0,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": len(run.calls), "failed": failed,
              "metrics": values, "device": device_info}
    if run.traced:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    print(f"calls {len(run.calls)} in {run.window_s} s, audio {run.audio_s} s, "
          f"setup {run.setup_s} s", file=sys.stderr)
    steps, prev = [], t0
    for name, at in marks:
        steps.append(f"{name} {at - (c0 if name == 'check' else prev):.3f}")
        prev = at
    print("seconds: " + ", ".join(steps), file=sys.stderr)
    walls = sorted(c.end - c.start for c in run.done)
    if walls:
        q = [walls[int(f * (len(walls) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
        print("call walls (min, quartiles, max) s: " + " ".join(f"{x:.4f}" for x in q),
              file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
