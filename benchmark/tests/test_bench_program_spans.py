"""The readers of the program's spans and counters: a traced CPU run of each
cell reads every one of its metrics sourced from the program as a number,
and the share of the entry points' time no span covers stays below 100."""

import pytest

from harness import spec
from helpers import run_cell

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM = {"feed_ms_per_min", "session_ms_per_min", "h2d_ms_per_min", "dispatch_ms_per_min",
           "collect_wait_ms_per_min", "collect_ms_per_min", "frames_useful_pct",
           "decode_md5_ms_per_min", "decode_collect_ms_per_min", "unspanned_pct.encode",
           "unspanned_pct.decode"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_program_spans(capsys, name):
    from zigflac_tpu_torch.utils import stages

    cell = spec.workload(BENCH, name)
    want = {m["name"] for m in spec.metrics_of(BENCH, name, True)} & PROGRAM
    assert want
    try:
        rc, res, err = run_cell(capsys, cell, spec.traffic(cell["traffic"]),
                                extra=("--trace", "1"))
    finally:
        stages.SPANS = stages.COUNTS = None
    assert rc == 0 and res is not None and res["correct"], err
    got = res["metrics"]
    assert want <= set(got), err
    for m in want:
        assert isinstance(got[m]["value"], float) and got[m]["value"] >= 0, m
    for m in want & {"unspanned_pct.encode", "unspanned_pct.decode"}:
        assert got[m]["value"] < 100, err
    if "frames_useful_pct" in want:
        assert 0 < got["frames_useful_pct"]["value"] <= 100
    # the breakdown's idle gaps are named (on the CPU there is no device
    # operation, so the one gap is the window)
    assert res["breakdown"]["idle_gaps"]


def test_an_untraced_run_leaves_the_tracer_off(capsys):
    from zigflac_tpu_torch.utils import stages

    cell = spec.workload(BENCH, CELLS[0])
    rc, res, err = run_cell(capsys, cell, spec.traffic(cell["traffic"]))
    assert rc == 0 and res["correct"], err
    assert stages.SPANS is None and stages.COUNTS is None
    assert not set(res["metrics"]) & PROGRAM


ENCODE_LAYERS = ("feed_ms_per_min", "session_ms_per_min", "h2d_ms_per_min",
                 "dispatch_ms_per_min", "collect_wait_ms_per_min", "collect_ms_per_min")


@pytest.mark.parametrize("ladder", [None, ((0.05, 0.1), (1.15, None))], ids=["tier0", "re-encode"])
def test_encode_metrics_split_the_call(monkeypatch, ladder):
    """The encode layers' metrics and the unspanned share add up to the
    calls' whole time, each span counted once, re-encodes in the collect
    included."""
    import io
    from types import SimpleNamespace

    import numpy as np

    import zigflac_tpu_torch as zt
    from zigflac_tpu_torch.models import pipeline
    from zigflac_tpu_torch.utils import stages
    from zigflac_tpu_torch.wav import write_wav

    if ladder is not None:
        monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ladder)
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    write_wav(buf, rng.integers(-3000, 3000, (2, 3 * 4096 + 50)).astype(np.int32), 44100, 16)
    run = SimpleNamespace(done=[True], audio_s=60.0)  # per minute of audio = per call
    spec.metric("feed_ms_per_min").arm(run)
    try:
        for _ in range(2):
            zt.encode_wav_bytes(buf.getvalue(), zt.EncoderConfig(block_size=4096), device="cpu")
        whole = stages.totals()["encode.call"][1]
        parts = sum(spec.metric(m).read(run) for m in ENCODE_LAYERS)
        unspanned = spec.metric("unspanned_pct.encode").read(run) / 100 * whole
        waits = stages.totals()["pipeline.wait"][0]
    finally:
        stages.SPANS = stages.COUNTS = None
    assert parts + unspanned == pytest.approx(whole, rel=1e-9)
    assert waits == (2 if ladder is None else 3) * 2
