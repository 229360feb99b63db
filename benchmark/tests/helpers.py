"""Small runs of the harness for the tests: each cell's own traffic mix, cut
to a pool and lengths that a test run holds."""

import json
import time

from harness.main import main

SMALL = {
    "encode_wav_bytes": {"pool": 3, "seconds": {"dist": "uniform", "min": 1.5, "max": 3.0},
                         "warmup": 1, "check": {"items": 2, "per_item": 1}},
    "decode_flac": {"pool": 2, "seconds": {"dist": "uniform", "min": 1.5, "max": 3.0},
                    "warmup": 1, "check": {"items": 2, "per_item": 1}},
}
CLIPS = {"pool": 4, "seconds": {"dist": "loguniform", "min": 0.3, "max": 1.2}, "warmup": 2,
         "check": {"items": 3, "per_item": 2}}


def small(cell: dict, traffic: dict) -> dict:
    if traffic["seconds"]["dist"] == "loguniform":
        return CLIPS
    return SMALL[traffic["entry"]]


def run_cell(capsys, cell: dict, traffic: dict, seed: int = 2**33 + 7, device="cpu",
             extra=(), seconds: float = 1.0, mix=None):
    """(exit code, the last stdout line as JSON or None, stderr); ``mix``
    replaces keys of the small mix."""
    argv = ["--workload", cell["name"], "--seed", str(seed), "--seconds", str(seconds), *extra]
    overrides = dict(small(cell, traffic), **(mix or {}))
    rc = main(argv, time.perf_counter(), device=device, traffic_overrides=overrides)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
