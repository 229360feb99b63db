"""The STREAMINFO MD5 on the encoder's worker thread
(``zigflac_tpu_torch/models/encoder.py``: ``_start_md5``, ``_md5_job``,
``_md5_digest``), on the CPU.

Every route that ends in ``Encoder._finish`` or ``encode_to_file`` (the
planar route of ``encode_wav_bytes``, ``Encoder.encode_stream`` with the
samples serialized on the worker, and the card-fed route that
``encode_wav_bytes`` takes on one CUDA device) writes the MD5 of the WAV's
PCM bytes and the golden oracle's stream. An error in the job is raised by
the call; an error in the dispatch is raised without waiting for the job,
and the next call gets its own digest. Spans and counters are touched only
on the calling thread: one ``session.md5`` span, the wait, under the call,
and ``session.md5_hash_ns``, the job's time. Every wait in these tests is
bounded.

Tolerance: exact equality of digests and bytes."""

import hashlib
import io
import threading

import numpy as np
import pytest

import zigflac_tpu
import zigflac_tpu_torch
from conftest import make_signal
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.models import encoder, pipeline
from zigflac_tpu_torch.models.encoder import Encoder
from zigflac_tpu_torch.utils import stages
from zigflac_tpu_torch.wav import WavReader, write_wav

BLOCK = 256
WAIT_S = 60  # no call here takes a second; a hang fails instead of stalling the run
ROUTES = ["planar", "card_fed"]


def _wav(seed, n=2 * BLOCK + 37, channels=2, depth=16):
    buf = io.BytesIO()
    write_wav(buf, make_signal(np.random.default_rng(seed), n, channels=channels, depth=depth),
              44100, depth)
    return buf.getvalue()


def _config(channels=2):
    return EncoderConfig(block_size=BLOCK, channels="stereo_auto" if channels == 2 else channels)


def _pcm_md5(wav):
    return hashlib.md5(WavReader.from_bytes(wav).raw_pcm_bytes()).digest()


def _streaminfo_md5(flac):
    """The MD5 field of the STREAMINFO block that follows 'fLaC'."""
    assert flac[:4] == b"fLaC" and flac[4] & 0x7F == 0
    return flac[8 + 18 : 8 + 34]


def _within(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on a thread of its own, waited for at most
    ``WAIT_S``: its result, or its exception raised here."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # handed to the caller below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive(), f"{fn.__name__} did not return within {WAIT_S} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture
def route(request, monkeypatch):
    """``encode_wav_bytes`` on the CPU device takes the planar route, or,
    with ``card_fed`` set as on one CUDA device, ``Encoder.encode_pcm``."""
    if request.param == "card_fed":
        monkeypatch.setattr(pipeline.DevicePipeline, "card_fed",
                            property(lambda self: self._mesh is None))
    return request.param


def _encode(wav, channels=2):
    return zigflac_tpu_torch.encode_wav_bytes(wav, config=_config(channels), device="cpu")


@pytest.mark.parametrize("channels", [1, 2, 6])
@pytest.mark.parametrize("depth", [8, 12, 16, 20, 24])
def test_every_route_writes_the_pcm_md5_and_the_golden_stream(monkeypatch, depth, channels):
    wav = _wav(depth * 10 + channels, channels=channels, depth=depth)
    fields = dict(block_size=BLOCK, channels="stereo_auto" if channels == 2 else channels)
    want = zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(**fields), backend="golden")
    assert _streaminfo_md5(want) == _pcm_md5(wav)

    assert _encode(wav, channels) == want  # planar route, the job started at the parse
    reader = WavReader.from_bytes(wav)
    enc = Encoder(_config(channels), depth, "cpu")
    # no raw bytes: the job serializes the samples on the worker
    assert enc.encode_stream(reader.planar_samples(), reader.flac_streaminfo(BLOCK)) == want
    monkeypatch.setattr(pipeline.DevicePipeline, "card_fed",
                        property(lambda self: self._mesh is None))
    assert _encode(wav, channels) == want  # card-fed route


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_a_hasher_that_raises_fails_the_call_and_the_next_call_succeeds(monkeypatch, route):
    wav = _wav(1)

    def boom(*args):
        raise RuntimeError("hasher failed")

    with monkeypatch.context() as m:
        m.setattr(encoder, "_md5_job", boom)
        with pytest.raises(RuntimeError, match="hasher failed"):
            _within(_encode, wav)
    flac = _within(_encode, wav)
    assert _streaminfo_md5(flac) == _pcm_md5(wav)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_a_dispatch_that_raises_fails_the_call_without_waiting_for_the_hash(monkeypatch,
                                                                             route):
    """The job is held until the failed call has returned: the call raised
    without waiting for it. The next call's job queues behind it and that
    call gets its own digest, not the failed call's."""
    failed_wav, next_wav = _wav(2), _wav(3)
    gate = threading.Event()
    jobs = []
    real_job, real_start = encoder._md5_job, encoder._start_md5

    def held_job(*args):
        assert gate.wait(WAIT_S)
        return real_job(*args)

    def start(*args, **kwargs):
        jobs.append(real_start(*args, **kwargs))
        return jobs[-1]

    def boom(*args, **kwargs):
        raise RuntimeError("dispatch failed")

    with monkeypatch.context() as m:
        m.setattr(encoder, "_md5_job", held_job)
        m.setattr(encoder, "_start_md5", start)
        name = "dispatch_pcm" if route == "card_fed" else "dispatch_batch"
        m.setattr(pipeline.DevicePipeline, name, boom)
        with pytest.raises(RuntimeError, match="dispatch failed"):
            _within(_encode, failed_wav)
        assert len(jobs) == 1 and not jobs[0].done()
        gate.set()
    assert _within(jobs[0].result)[0] == _pcm_md5(failed_wav)
    flac = _within(_encode, next_wav)
    assert _streaminfo_md5(flac) == _pcm_md5(next_wav) != _pcm_md5(failed_wav)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_one_md5_span_a_call_all_on_the_calling_thread(monkeypatch, route):
    """One ``session.md5`` span, under the call's root, and a positive
    ``session.md5_hash_ns``; the job ran on another thread, and every span
    and count came from this one; no span is left open."""
    wav = _wav(4)
    me = threading.get_ident()
    seen, job_threads = set(), set()
    real_span, real_count, real_job = stages.span, stages.count, encoder._md5_job

    def span(name):
        seen.add(threading.get_ident())
        return real_span(name)

    def count(name, n=1):
        seen.add(threading.get_ident())
        real_count(name, n)

    def job(*args):
        job_threads.add(threading.get_ident())
        return real_job(*args)

    monkeypatch.setattr(stages, "span", span)
    monkeypatch.setattr(stages, "count", count)
    monkeypatch.setattr(encoder, "_md5_job", job)
    stages.SPANS, stages.COUNTS = [], {}
    try:
        flac = _encode(wav)
        spans, counts, still_open = list(stages.SPANS), dict(stages.COUNTS), list(stages._open)
    finally:
        stages.SPANS = stages.COUNTS = None
    assert _streaminfo_md5(flac) == _pcm_md5(wav)
    assert seen == {me} and job_threads and me not in job_threads
    md5 = [s for s in spans if s[0] == "session.md5"]
    assert len(md5) == 1
    (root,) = [s for s in spans if s[2] == -1]
    assert root[0] == "encode.call"
    name, call, parent, t0, t1 = md5[0]
    assert call == root[1] and spans[parent] == root and 0 < t0 <= t1
    assert counts["session.md5_hash_ns"] > 0
    assert not still_open and all(s[4] for s in spans)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_back_to_back_calls_never_mix_digests(route):
    wavs = [_wav(5), _wav(6, n=3 * BLOCK + 11)]
    want = [_encode(w) for w in wavs]
    assert _streaminfo_md5(want[0]) != _streaminfo_md5(want[1])
    for k in range(20):
        i = k % 2
        flac = _within(_encode, wavs[i])
        assert flac == want[i] and _streaminfo_md5(flac) == _pcm_md5(wavs[i]), k


def test_concurrent_callers_share_one_worker_and_keep_their_digests(monkeypatch):
    """More calling threads than cores, with the interpreter switching
    threads every 10 us, start the worker at once: one worker thread is
    made, and each call writes its own WAV's digest."""
    import os
    import sys

    pools, job_threads = [], set()
    real_pool, real_job = encoder.ThreadPoolExecutor, encoder._md5_job

    def pool(*args, **kwargs):
        pools.append(real_pool(*args, **kwargs))
        return pools[-1]

    def job(*args):
        job_threads.add(threading.get_ident())
        return real_job(*args)

    monkeypatch.setattr(encoder, "_md5_pool", None)
    monkeypatch.setattr(encoder, "ThreadPoolExecutor", pool)
    monkeypatch.setattr(encoder, "_md5_job", job)
    wavs = [_wav(100 + i, n=BLOCK + 13 * i) for i in range(2 * (os.cpu_count() or 1) + 2)]
    got = [None] * len(wavs)
    start = threading.Barrier(len(wavs))

    def caller(i):
        start.wait(WAIT_S)
        got[i] = _encode(wavs[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,), daemon=True)
                   for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        for p in pools:
            p.shutdown(wait=True)
    assert len(pools) == 1 and len(job_threads) == 1
    for wav, flac in zip(wavs, got):
        assert flac is not None and _streaminfo_md5(flac) == _pcm_md5(wav)


def test_a_forked_child_starts_a_worker_of_its_own():
    """The parent's worker thread does not exist in a forked child: the
    child's first MD5 starts a new one instead of queueing on a pool with
    no thread. The child runs no torch op and leaves with ``os._exit``."""
    import os
    import time
    import warnings

    assert encoder._start_md5(b"warm").result(WAIT_S)[0] == hashlib.md5(b"warm").digest()
    data = bytes(range(256)) * 64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # fork of a threaded process
        pid = os.fork()
    if pid == 0:
        try:
            digest = encoder._start_md5(data).result(WAIT_S)[0]
            os._exit(0 if digest == hashlib.md5(data).digest() else 1)
        except BaseException:
            os._exit(2)
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.01)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        raise AssertionError("the forked child's MD5 never finished")
    assert os.waitstatus_to_exitcode(status) == 0
