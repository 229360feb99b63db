"""What the port's host tracer (``zigflac_tpu_torch/utils/stages.py``) costs.

Runs one benchmark cell in turns with the tracer off and armed (``SPANS``
and ``COUNTS`` set from the start, no profiler), each run a process of its
own with its own seed, off and armed alternating which goes first, and
prints every run's end-to-end metrics, each side's median and the armed
runs' spans a call. Then, in this process, the cost of one span off and
armed on this host. From the root of a checkout, on a machine with a card:

    python3 tools/torch_trace_cost.py --workload cd-clips-encode --pairs 3 --seed 3150000301
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one run of the benchmark's harness, the tracer armed first where argv[1] is "1"
CHILD = """
import sys, time
t0 = time.perf_counter()
sys.path[:0] = [{root!r}, {bench!r}]
armed = sys.argv[1] == "1"
if armed:
    from zigflac_tpu_torch.utils import stages
    stages.SPANS, stages.COUNTS = [], {{}}
from harness.main import main
rc = main(sys.argv[2:], t0)
if armed:
    roots = sum(s[2] == -1 for s in stages.SPANS)
    print(f"armed: {{len(stages.SPANS)}} spans over {{roots}} calls", file=sys.stderr)
sys.exit(rc)
"""


def one_run(workload: str, seed: int, seconds: float, armed: bool) -> dict:
    code = CHILD.format(root=ROOT, bench=os.path.join(ROOT, "benchmark"))
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    out = subprocess.run([sys.executable, "-c", code, "1" if armed else "0", *argv], cwd=ROOT,
                         capture_output=True, text=True, check=False)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"run failed: {workload} seed {seed} armed {armed}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    spans = [line for line in out.stderr.splitlines() if line.startswith("armed:")]
    return {"armed": armed, "seed": seed, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "spans": spans[0] if spans else None}


def span_cost(n: int = 200_000) -> dict:
    """Microseconds of one ``with stages.span(...)`` off and armed, no
    profiler, and of an empty call beside them."""
    sys.path.insert(0, ROOT)
    from zigflac_tpu_torch.utils import stages

    def timed(fn):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    def one():
        with stages.span("x"):
            pass

    out = {"empty_call_us": timed(lambda: None), "off_us": timed(one)}
    stages.SPANS, stages.COUNTS = [], {}
    try:
        out["armed_us"] = timed(one)
    finally:
        stages.SPANS = stages.COUNTS = None
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="cd-clips-encode")
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--seed", type=int, default=3150000301)
    p.add_argument("--seconds", type=float, default=51)
    args = p.parse_args()
    runs = []
    for i in range(args.pairs):
        for armed in ((False, True) if i % 2 == 0 else (True, False)):
            r = one_run(args.workload, args.seed + len(runs), args.seconds, armed)
            print(json.dumps(r), flush=True)
            runs.append(r)
    summary = {}
    for armed in (False, True):
        side = [r["metrics"] for r in runs if r["armed"] == armed]
        summary["armed" if armed else "off"] = {
            k: statistics.median(m[k] for m in side) for k in side[0]}
    summary["all_correct"] = all(r["correct"] for r in runs)
    summary["span_cost"] = span_cost()
    print(json.dumps(summary))
    return 0 if summary["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
