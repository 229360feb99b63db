"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is the entry's ``file``; the mix is
``benchmark/traffic/<traffic>.json``; the entry point a mix drives is
``benchmark/entries/<entry>.py``; each metric is read by
``benchmark/metrics/<metric>.py``; the configuration names its plain
reference. Adding a cell, a mix, an entry or a
metric adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(kind: str, name: str, path: Path = None):
    """benchmark/<kind>/<name>.py (or ``path``) as a module; names may hold
    dots."""
    path = path or BENCH_DIR / kind / f"{name}.py"
    key = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_").replace("/", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return _module("entries", name)


def metric(name: str):
    return _module("metrics", name)


def reference(cfg: dict):
    """The plain reference a configuration names (a path from the root)."""
    return _module("reference", cfg["reference"], ROOT / cfg["reference"])


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metrics, as (spec entry) dicts: its end-to-end metrics in
    a run with tracing off, its per-layer metrics in a traced run. A metric
    without ``workloads`` belongs to every cell that reports the metric it
    moves (or, end to end, to every cell)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
