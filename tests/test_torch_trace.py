"""The port's host spans and counters (``zigflac_tpu_torch/utils/stages.py``):
off by default and silent there, and, once armed, one call id a call, the
spans of the encode and decode paths under their parents, self times that
add up, the pipeline's frame and byte counters, and the same spans in a
``torch.profiler`` record."""

import gc
import io
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.models import encoder, pipeline
from zigflac_tpu_torch.utils import stages
from zigflac_tpu_torch.wav import write_wav

BLOCK = 4096
TAIL = 100

# span -> its parent's name, on the paths of one encode_wav_bytes and one
# decode_flac call on the CPU (a 16-bit stereo WAV of 3 full blocks and a
# tail); the encode takes the PCM route, so its pipeline.h2d spans are the
# staging copies of the WAV's bytes and the frame numbers under each dispatch
ENCODE = {
    "encode.call": None,
    "wav.parse": "encode.call",
    "session.setup": "encode.call",
    "pipeline.dispatch_batch": "encode.call",
    "pipeline.dispatch_tail": "encode.call",
    "pipeline.h2d": ("pipeline.dispatch_batch", "pipeline.dispatch_tail"),
    "session.md5": "encode.call",
    "pipeline.collect_batch": "encode.call",
    "pipeline.wait": "pipeline.collect_batch",
    "pipeline.d2h": "pipeline.collect_batch",
    "pipeline.assemble": "pipeline.collect_batch",
    "pipeline.join": "encode.call",
    "session.finish": "encode.call",
}
DECODE = {
    "decode.call": None,
    "decoder.metadata": "decode.call",
    "decoder.parse": "decode.call",
    "decoder.h2d": ("decode.call", "decoder.synth"),
    "decoder.synth": "decode.call",
    "decoder.d2h": "decode.call",
    "decoder.widen": "decode.call",
    "decoder.concat": "decode.call",
    "decoder.md5": "decode.call",
    "decoder.md5.serialize": "decoder.md5",
    "decoder.md5.hash": "decoder.md5",
}


@pytest.fixture(scope="module")
def wav():
    rng = np.random.default_rng(1515)
    buf = io.BytesIO()
    write_wav(buf, make_signal(rng, 3 * BLOCK + TAIL, channels=2, depth=16), 44100, 16)
    return buf.getvalue()


@pytest.fixture(scope="module")
def flac(wav):
    return zt.encode_wav_bytes(wav, EncoderConfig(block_size=BLOCK), device="cpu")


@pytest.fixture
def armed():
    """The tracer on for one test, off again after it."""
    stages.SPANS, stages.COUNTS = [], {}
    try:
        yield stages
    finally:
        stages.SPANS = stages.COUNTS = None


def _encode(wav):
    return zt.encode_wav_bytes(wav, EncoderConfig(block_size=BLOCK), device="cpu")


def _names(spans):
    return {s[0] for s in spans}


def test_off_by_default_records_nothing(wav, flac):
    """Off, an encode and a decode leave SPANS and COUNTS None, the span is
    one shared object, and a profiler's record holds no span of the
    program."""
    assert stages.SPANS is None and stages.COUNTS is None
    assert stages.span("a") is stages.span("b") is stages.entry("c")
    stages.count("pipeline.frames_real", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert _encode(wav) == flac
        assert zt.decode_flac(flac, device="cpu").md5_ok
    assert stages.SPANS is None and stages.COUNTS is None
    seen = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not seen & (set(ENCODE) | set(DECODE))


@pytest.mark.parametrize("path,table", [("encode", ENCODE), ("decode", DECODE)])
def test_spans_of_one_call_and_their_parents(armed, wav, flac, path, table):
    """Every span of the path, all under one call id, each under its parent;
    self time <= total, and the children's self times together no more
    than the root's total."""
    if path == "encode":
        assert _encode(wav) == flac
    else:
        assert zt.decode_flac(flac, device="cpu").md5_ok
    spans = armed.SPANS
    assert _names(spans) == set(table)
    assert len({s[1] for s in spans}) == 1
    (root,) = [i for i, s in enumerate(spans) if s[2] == -1]
    assert table[spans[root][0]] is None
    for name, call, parent, t0, t1 in spans:
        assert 0 < t0 <= t1
        if parent >= 0:
            want = table[name]
            assert spans[parent][0] in (want if isinstance(want, tuple) else (want,)), name
            assert spans[parent][3] <= t0 and t1 <= spans[parent][4]
    tot = armed.totals()
    for name, (n, total, own) in tot.items():
        assert n >= 1 and 0 <= own <= total + 1e-9
    root_name = spans[root][0]
    assert sum(own for name, (_, _, own) in tot.items()) <= tot[root_name][1] + 1e-6


def test_two_calls_two_call_ids(armed, wav, flac):
    _encode(wav)
    zt.decode_flac(flac, device="cpu")
    roots = [s for s in armed.SPANS if s[2] == -1]
    assert [s[0] for s in roots] == ["encode.call", "decode.call"]
    assert roots[0][1] != roots[1][1]
    assert {s[1] for s in armed.SPANS} == {roots[0][1], roots[1][1]}


def test_nested_entry_points_count_once(armed, flac, tmp_path, wav):
    """verify_flac calls decode_flac, encode_file calls the streaming
    encode: one root each."""
    assert zt.verify_flac(flac, device="cpu")
    path = tmp_path / "in.wav"
    path.write_bytes(wav)
    zt.encode_file(str(path), str(tmp_path / "out.flac"), EncoderConfig(block_size=BLOCK),
                   device="cpu")
    assert (tmp_path / "out.flac").read_bytes() == flac
    roots = [s[0] for s in armed.SPANS if s[2] == -1]
    assert roots == ["decode.call", "encode.call"]
    assert armed.totals()["decode.call"][0] == 1


def test_frame_and_byte_counters(armed, wav, flac):
    """3 full blocks and a tail: the bucket of 4 rows and the tail's 1, 4
    of them frames of the input; h2d carries the WAV's PCM bytes of the
    real rows (the unpack pads to the bucket on the device) and the frame
    numbers of every row, the decoder's d2h its int32 samples."""
    _encode(wav)
    c = armed.COUNTS
    assert c["pipeline.frames_real"] == 4 and c["pipeline.frames_encoded"] == 5
    assert c["pipeline.h2d_bytes"] == (3 * 2 * BLOCK * 2 + 4 * 8) + (2 * TAIL * 2 + 8)
    assert c["pipeline.d2h_bytes"] > 0
    zt.decode_flac(flac, device="cpu")
    assert c["decoder.d2h_bytes"] == (3 * 2 * BLOCK + 2 * TAIL) * 4
    assert c["decoder.batches"] == 2  # the full frames, then the tail's block size
    assert c["decoder.h2d_bytes"] >= (3 * 2 * BLOCK + 2 * TAIL) * 8
    assert not any(k.startswith("decoder.") for k in ("h2d_bytes", "d2h_bytes", "batches")
                   if k in (zt.decoder.STATS or {}))


def test_overflow_re_encodes_count_their_rows(armed, wav, flac, monkeypatch):
    """A tier-0 budget the batch of full frames does not fit (the tail's
    fixed slack holds it): the batch encodes again at the next tier, inside
    its collect, from the frames its dispatch unpacked, and its rows count
    twice; the bytes are unchanged."""
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ((0.05, 0.1), (1.15, None)))
    assert _encode(wav) == flac
    c = armed.COUNTS
    assert c["pipeline.frames_real"] == 4 + 3 and c["pipeline.frames_encoded"] == 5 + 4
    spans = armed.SPANS
    inner_h2d = [s for s in spans if s[0] == "pipeline.h2d"
                 and spans[s[2]][0] == "pipeline.collect_batch"]
    assert len(inner_h2d) == 1  # the frame numbers alone


def test_mesh_shards_count_their_rows(armed, wav):
    """On a mesh of the CPU twice each shard's copy is a pipeline.h2d
    span under the dispatch, and each shard's rows are counted."""
    from zigflac_tpu_torch.models.encoder import Encoder
    from zigflac_tpu_torch.parallel.mesh import default_mesh
    from zigflac_tpu_torch.wav import WavReader

    reader = WavReader.from_bytes(wav)
    enc = Encoder(EncoderConfig(block_size=BLOCK), 16, "cpu")
    enc.pipeline = pipeline.DevicePipeline(enc.config, 16, "cpu",
                                           mesh=default_mesh(["cpu"] * 2))
    samples = reader.planar_samples()
    info = reader.flac_streaminfo(BLOCK)
    stream = enc.encode_stream(samples, info)
    assert stream == _encode(wav)
    c = armed.COUNTS
    # the mesh run: two shards of 2 rows, 3 of them real; then the tail;
    # then the single-device run: the bucket of 4 and the tail
    assert c["pipeline.frames_encoded"] == (2 + 2 + 1) + (4 + 1)
    assert c["pipeline.frames_real"] == (3 + 1) + (3 + 1)
    first = [s for s in armed.SPANS if s[1] == armed.SPANS[0][1]]
    assert armed.SPANS[0][0] == "encode.call"  # Encoder.encode_stream is an entry point
    h2d_parents = {first[s[2]][0] for s in first if s[0] == "pipeline.h2d"}
    assert h2d_parents == {"pipeline.dispatch_batch", "pipeline.dispatch_tail"}


def _md5_here(raw, samples=None, bit_depth=0) -> Future:
    """``encoder._start_md5`` with the job run on the calling thread."""
    job = Future()
    job.set_result(encoder._md5_job(raw, samples, bit_depth))
    return job


def _profiled_spans(wav, flac):
    """(the profiler's {name: durations in order}, the tracer's) of one
    encode and one decode under a CPU profiler, the garbage collector
    waiting and the MD5 job run on the calling thread, so that no other
    thread takes the interpreter between a span's two clock reads."""
    stages.SPANS = []
    gc.disable()
    try:
        with pytest.MonkeyPatch.context() as m, torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            m.setattr(encoder, "_start_md5", _md5_here)
            _encode(wav)
            zt.decode_flac(flac, device="cpu")
    finally:
        gc.enable()
    names = set(ENCODE) | set(DECODE)
    theirs = {}
    for e in sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns()):
        if e.name() in names:
            theirs.setdefault(e.name(), []).append(e.end_ns() - e.start_ns())
    mine = {}
    for s in stages.SPANS:
        mine.setdefault(s[0], []).append(s[4] - s[3])
    return theirs, mine


def test_spans_land_in_the_profiler_record(armed, wav, flac):
    """Under a CPU profiler every span is also a record_function of its
    name: the same spans, in the same order, each as long as the tracer's
    within 20% or 50 us. The first profiled run also loads what the
    profiler's ranges load on first use, and a host shared with other test
    processes can hold either clock's reader off the core for longer than
    that: of up to four runs, one must agree in every span."""
    names = set(ENCODE) | set(DECODE)
    for _ in range(4):
        theirs, mine = _profiled_spans(wav, flac)
        assert set(theirs) == set(mine) == names
        assert {n: len(d) for n, d in theirs.items()} == {n: len(d) for n, d in mine.items()}
        off = [(n, a, b) for n in names for a, b in zip(mine[n], theirs[n])
               if abs(a - b) > max(0.2 * b, 50_000)]
        if not off:
            return
    raise AssertionError(f"spans and profiler events disagree: {off}")


def test_totals_subtract_the_children():
    spans = [("r", 1, -1, 0, 100), ("a", 1, 0, 10, 40), ("b", 1, 1, 15, 25),
             ("a", 1, 0, 50, 60), ("open", 1, 0, 70, 0)]
    got = stages.totals(spans)
    assert got == {"r": (1, 100e-6, pytest.approx(60e-6)), "a": (2, 40e-6, pytest.approx(30e-6)),
                   "b": (1, 10e-6, 10e-6)}
    assert stages.totals([]) == {}
