"""The port end to end: zigflac_tpu_torch.encode_wav_bytes on the CPU
against the JAX package's device backend, all 22 pinned regression corpus
streams and the golden oracle's frames, for fixed and LPC prediction at
every depth up to 32.

Tolerance: exact equality of the FLAC bytes."""

import hashlib
import io
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch

import zigflac_tpu
import zigflac_tpu_torch
from conftest import make_signal
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from zigflac_tpu import golden
from zigflac_tpu.metadata import StreamInfo as JaxStreamInfo
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch import EncoderConfig, StreamInfo
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.models.encoder import Encoder
from zigflac_tpu_torch.wav import WavReader, write_wav


def _wav(rng, n, channels, depth, kind="mixed", rate=44100):
    buf = io.BytesIO()
    write_wav(buf, make_signal(rng, n, channels=channels, depth=depth, kind=kind), rate, depth)
    return buf.getvalue()


@pytest.mark.parametrize(
    "n,channels,depth,block",
    [(3 * 4096 + 1000, 2, 16, 4096), (2 * 1024 + 300, 1, 24, 1024), (4096 + 77, 8, 16, 4096)],
)
def test_equals_jax_device_backend(rng, n, channels, depth, block):
    wav = _wav(rng, n, channels, depth)
    fields = dict(block_size=block, channels="stereo_auto" if channels == 2 else channels)
    want = zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(**fields), backend="device")
    got = zigflac_tpu_torch.encode_wav_bytes(wav, config=EncoderConfig(**fields), device="cpu")
    assert got == want


@pytest.mark.parametrize(
    "depth,fields",
    [(16, dict(prediction="lpc")), (24, dict(prediction="lpc", lpc_order=12)),
     (32, dict(prediction="fixed")), (32, dict(prediction="lpc"))],
    ids=["lpc16", "lpc24", "fixed32", "lpc32"],
)
def test_lpc_and_depth32_equal_jax_device_backend(rng, depth, fields):
    """The JAX device backend sweeps speculatively at tier 0; the port
    sweeps once, exactly. A tail under 64 samples goes to the JAX
    package's host oracle and through the port's device path."""
    wav = _wav(rng, 2 * 1024 + 37, 2, depth)
    cfg = dict(block_size=1024, **fields)
    want = zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(**cfg), backend="device")
    assert zigflac_tpu_torch.encode_wav_bytes(wav, config=EncoderConfig(**cfg),
                                              device="cpu") == want


def test_small_batches_equal_one_batch(rng):
    """Five frames in batches of 2 (the last padded to its power of two)
    give the same stream as one batch; metadata options ride along."""
    wav = _wav(rng, 5 * 1024 + 10, 2, 16)
    reader = WavReader.from_bytes(wav)
    cfg = EncoderConfig(block_size=1024)
    streams = []
    for batch_size in (2, 1024):
        enc = Encoder(cfg, 16, "cpu")
        enc.pipeline.batch_size = batch_size
        streams.append(enc.encode_stream(
            reader.planar_samples(), reader.flac_streaminfo(1024),
            raw_pcm_bytes=bytes(reader.raw_pcm_bytes()), seek_interval=2048, padding=64,
        ))
    assert streams[0] == streams[1]
    want = zigflac_tpu.encode_wav_bytes(
        wav, config=JaxConfig(block_size=1024), backend="device", seek_interval=2048,
        padding=64,
    )
    assert streams[0] == want


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_corpus_byte_identity(case):
    flac = zigflac_tpu_torch.encode_wav_bytes(
        _wav_bytes(case), config=EncoderConfig(**asdict(_case_config(case))), device="cpu"
    )
    with open(os.path.join(VEC_DIR, case["name"] + ".flac"), "rb") as f:
        pinned = f.read()
    assert hashlib.sha256(flac).hexdigest() == hashlib.sha256(pinned).hexdigest()


@pytest.mark.parametrize("rem", range(1, 71))
def test_tail_equals_golden_frame(rem):
    """A ragged tail of every length 1..70 encodes on the device path at its
    exact block size, identical to the golden oracle's frame."""
    rng = np.random.default_rng(rem)
    for channels in (2, 1):
        pipe = pipeline.DevicePipeline(EncoderConfig.default(channels), 16, "cpu")
        info = StreamInfo(44100, channels, 16, rem, 4096, 4096)
        jinfo = JaxStreamInfo(44100, channels, 16, rem, 4096, 4096)
        for kind in ("mixed", "noise", "sine", "extreme", "constant"):
            x = make_signal(rng, rem, channels=channels, kind=kind)
            got, sizes = pipe.encode_frames_stream(
                np.zeros((0, channels, 4096), np.int32), 7, info, tail=x
            )
            want = golden.encode_frame(
                [x[c] for c in range(channels)], 7, jinfo, JaxConfig.default(channels)
            )
            assert got == want, (channels, kind)
            assert sizes.tolist() == [len(want)]


@pytest.mark.parametrize("rem", range(1, 41))
def test_lpc_tail_equals_golden_frame(rem):
    """LPC tails 1..40 at orders 8 and 32: a tail of at most max(4, order)
    samples is constant or verbatim, a longer one may take an LPC
    subframe; every one equals the golden oracle's frame."""
    rng = np.random.default_rng(1000 + rem)
    for channels, lpc_order in ((2, 8), (1, 8), (2, 32)):
        cfg = dict(channels="stereo_auto" if channels == 2 else channels,
                   prediction="lpc", lpc_order=lpc_order)
        pipe = pipeline.DevicePipeline(EncoderConfig(**cfg), 16, "cpu")
        info = StreamInfo(44100, channels, 16, rem, 4096, 4096)
        jinfo = JaxStreamInfo(44100, channels, 16, rem, 4096, 4096)
        for kind in ("mixed", "noise", "sine", "extreme", "constant"):
            x = make_signal(rng, rem, channels=channels, kind=kind)
            got, _ = pipe.encode_frames_stream(
                np.zeros((0, channels, 4096), np.int32), 7, info, tail=x
            )
            want = golden.encode_frame([x[c] for c in range(channels)], 7, jinfo,
                                       JaxConfig(**cfg))
            assert got == want, (channels, lpc_order, kind)


def test_encode_frames_splits_the_stream(rng):
    """encode_frames returns each full frame's bytes, each equal to the
    golden oracle's frame."""
    x = make_signal(rng, 3 * 1024, channels=2)
    frames = x.reshape(2, 3, 1024).transpose(1, 0, 2)
    pipe = pipeline.DevicePipeline(EncoderConfig(block_size=1024), 16, "cpu")
    got = pipe.encode_frames(frames, 5, StreamInfo(44100, 2, 16, 3 * 1024, 1024, 1024))
    jinfo = JaxStreamInfo(44100, 2, 16, 3 * 1024, 1024, 1024)
    want = [golden.encode_frame(list(frames[i]), 5 + i, jinfo, JaxConfig(block_size=1024))
            for i in range(3)]
    assert got == want


@pytest.mark.parametrize("ladder", [((0.05, 0.1), (1.15, None)), ((0.05, 0.1), (0.1, 0.2))])
def test_capacity_ladder_overflow_reencodes(rng, monkeypatch, ladder):
    """Batches that out-size tier 0 re-encode at tier 1, and past it on the
    exact-capacity words path, to the same bytes."""
    wav = _wav(rng, 3 * 1024 + 99, 2, 16, kind="noise")
    cfg = EncoderConfig(block_size=1024)
    want = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ladder)
    assert zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu") == want


def test_capacity_ladder_depth32_exact_tier(rng, monkeypatch):
    """32-bit noise forced past tier 0 re-encodes at the exact tier, whose
    rows (max_frame_words at depth 32) are the widest the packer sees."""
    wav = _wav(rng, 2 * 1024 + 99, 2, 32, kind="noise")
    cfg = EncoderConfig(block_size=1024)
    want = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ((0.05, 0.1), (1.15, None)))
    assert zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu") == want
    assert want == zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(block_size=1024),
                                                backend="golden")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Encoder(EncoderConfig(), 16, "cuda")


def test_default_device_is_the_card(rng, monkeypatch):
    """Without a device argument both entry points take cuda, and without
    a card they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Encoder(EncoderConfig(prediction="lpc"), 32)
    with pytest.raises(RuntimeError, match="cuda"):
        zigflac_tpu_torch.encode_wav_bytes(_wav(rng, 1000, 2, 16))


def test_stage_marks_group_by_batch():
    """batch_ms splits the marks at each "begin" and times every stage from
    the mark before it; with EVENTS off, mark records nothing."""
    from zigflac_tpu_torch.utils import stages

    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

    names = ["begin", "analysis", "symbols", "deposit", "crc", "compaction",
             "begin", "analysis", "symbols", "deposit"]
    times = [0.0, 2.0, 3.5, 3.75, 5.0, 5.5, 6.0, 7.0, 9.0, 10.0]
    got = stages.batch_ms([(n, Ev(t)) for n, t in zip(names, times)])
    assert got == [
        {"analysis": 2.0, "symbols": 1.5, "deposit": 0.25, "crc": 1.25, "compaction": 0.5},
        {"analysis": 1.0, "symbols": 2.0, "deposit": 1.0},
    ]
    assert stages.EVENTS is None
    stages.mark("begin")
    assert stages.EVENTS is None
