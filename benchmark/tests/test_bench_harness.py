"""The harness: every file found by its name in BENCHMARK.json, the file's
contract, seeded pools, the result line's keys, the no-JAX guard."""

import re
import shutil
import subprocess
import sys

import pytest
import torch

from harness import nojax, signal, spec
from harness.main import checked_items, warm_items
from helpers import run_cell

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cell(name):
    cell = spec.workload(BENCH, name)
    return cell, spec.traffic(cell["traffic"])


@pytest.mark.parametrize("name", CELLS)
def test_every_file_found_by_name(name):
    cell, traffic = _cell(name)
    cfg = spec.config(BENCH, cell["config"])
    assert cfg["name"] == cell["config"]
    assert {"encoder", "format", "control", "reduced", "assumed"} <= set(cfg)
    entry = spec.entry(traffic["entry"])
    for fn in ("spans", "prepare", "call", "control", "work", "release", "check"):
        assert callable(getattr(entry, fn)), fn
    for traced in (False, True):
        metrics = spec.metrics_of(BENCH, name, traced)
        assert metrics
        for m in metrics:
            assert callable(spec.metric(m["name"]).read)


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
    for name in CELLS:
        got = {m["name"] for m in spec.metrics_of(BENCH, name, False)}
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics_of(BENCH, name, True)
        for m in spec.metrics_of(BENCH, name, True):  # what it moves, the cell reports
            assert m["moves"] in got


@pytest.mark.parametrize("name", CELLS)
def test_pool_is_made_from_the_seed(name):
    cell, traffic = _cell(name)
    fmt = spec.config(BENCH, cell["config"])["format"]
    traffic = dict(traffic, pool=3, seconds={"dist": traffic["seconds"]["dist"],
                                             "min": 2.5, "max": 3.0})
    a = signal.make_pool(2**40 + 3, traffic, fmt, "cpu")
    b = signal.make_pool(2**40 + 3, traffic, fmt, "cpu")
    c = signal.make_pool(2**40 + 4, traffic, fmt, "cpu")
    assert [x.wav for x in a] == [x.wav for x in b]
    assert all(x.wav != y.wav for x, y in zip(a, c))
    # every seed gets the same sizes; the order of calls differs
    assert sorted(x.samples for x in a) == sorted(x.samples for x in c)
    take = lambda s: [next(g) for g in [signal.call_order(s, 3)] for _ in range(9)]  # noqa: E731
    assert take(5) == take(5) and sorted(take(5)) == sorted(take(6))


def test_track_has_silence_and_fits_its_depth():
    x = signal.make_track(11, 0, 3 * 44100, 44100, 16, 2, signal.track_params(11, 1)[0], "cpu")
    assert (x[:, :22050] == 0).all() and (x[:, -11025:] == 0).all()
    assert int(x.abs().max()) < 32768 and x.dtype == torch.int64


def test_warm_up_spans_the_sizes():
    class It:
        def __init__(self, n):
            self.samples = n
    pool = [It(n) for n in (5, 1, 9, 3, 7)]
    assert warm_items({"warmup": 2}, pool) == [1, 2]
    assert warm_items({"warmup": 9}, pool) == [0, 1, 2, 3, 4]
    assert warm_items({"warmup": 1}, pool) == [1]


def test_checked_items_are_the_longest_and_the_first_calls():
    class It:
        def __init__(self, n):
            self.samples = n
    pool = [It(n) for n in (5, 1, 9, 3, 7, 2)]
    first = [next(signal.call_order(77, 6)) for _ in range(1)]
    got = checked_items(77, {"check": {"items": 3}}, pool)
    assert got[0] == 2 and len(set(got)) == 3
    assert got[1] == (first[0] if first[0] != 2 else got[1])
    assert checked_items(77, {"check": {"items": 3}}, pool) == got
    assert sorted(checked_items(77, {"check": {"items": 9}}, pool)) == list(range(6))
    assert checked_items(77, {"check": {"items": 0}}, pool) == []


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_result_line_has_the_contract_keys(capsys, name, traced):
    cell, traffic = _cell(name)
    rc, res, err = run_cell(capsys, cell, traffic, extra=("--trace", str(traced)))
    assert rc == 0 and res is not None, err
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in spec.metrics_of(BENCH, name, False)}
        assert set(res["metrics"]) == want
    assert err.rstrip().splitlines()[-1].startswith("check calls_failed")


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    from harness.main import main

    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_jax_guard_compares_whole_top_level_names():
    assert nojax.loaded(["zigflac_tpu_torch", "zigflac_tpu_torch.ops.lpc", "jaxtyping",
                         "numpy"]) == []
    assert nojax.loaded(["zigflac_tpu.golden"]) == ["zigflac_tpu"]
    assert nojax.loaded(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_harness_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['.', 'benchmark']; "
            "import harness.main, reference.flac_ref; "
            "from harness import spec, nojax; b = spec.load(); "
            "[spec.entry(t) for t in ('encode_wav_bytes', 'decode_flac')]; "
            "[spec.metric(m['name']) for m in b['end_to_end'] + b['per_layer']]; "
            "import zigflac_tpu_torch; print(nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_roofline_counts_read_the_algorithm():
    from harness import roofline

    cfg = spec.config(BENCH, "cd-wav2flac")["encoder"]
    w = roofline.encode_work(44100, 2, 16, 100_000, cfg)
    assert w["bytes"] == 44100 * 2 * 2 + 100_000 and w["bound"] == "operations"
    lpc = spec.config(BENCH, "hires-flac5-lpc8")["encoder"]
    assert roofline.encode_work(44100, 2, 16, 100_000, lpc)["ops"] > w["ops"]
    head = b"fLaC" + bytes([0]) + (34).to_bytes(3, "big") + bytes(34)
    vc = bytes([0x84]) + (8).to_bytes(3, "big") + bytes(8)
    assert roofline.flac_frame_bytes(head + vc + b"x" * 17) == 17
