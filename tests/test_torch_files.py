"""The port's file entry points on the CPU against the JAX package:
streaming ``encode_file``, the fused multi-file ``encode_files`` /
``encode_wav_bytes_many`` (BASELINE config 4), ``encode_to_file`` and
Ogg-FLAC output. Inputs are made from a seed with numpy; the JAX side runs
its device backend under JAX_PLATFORMS=cpu (tails under 64 samples go to its
host oracle there, while the port encodes every tail on the device path).

Tolerance: exact equality of the output bytes."""

import io

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu import golden
from zigflac_tpu.metadata import StreamInfo as JaxStreamInfo
from zigflac_tpu.models import encoder as jax_encoder
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch.metadata import build_seekpoints, parse_cue_sheet, picture_block
from zigflac_tpu_torch.models import encoder, pipeline
from zigflac_tpu_torch.wav import WavStreamReader, write_wav

PNG = b"\x89PNG\r\n\x1a\n" + bytes(range(200))
CUE = "TRACK 01 AUDIO\nINDEX 01 00:00:00\nTRACK 02 AUDIO\nINDEX 01 00:00:02\n"


def _write(path, rng, n, channels=2, depth=16, rate=44100, kind="mixed"):
    write_wav(str(path), make_signal(rng, n, channels=channels, depth=depth, kind=kind),
              rate, depth)
    return str(path)


def _channels(channels):
    return "stereo_auto" if channels == 2 else channels


@pytest.mark.parametrize("prediction", ["fixed", "lpc"])
@pytest.mark.parametrize("depth,channels", [(8, 1), (24, 2), (32, 2)])
def test_streaming_with_metadata_equals_in_memory_and_jax(tmp_path, rng, depth, channels,
                                                          prediction):
    """Chunks of 3 frames and a ragged tail, with the full metadata chain:
    tags, a SEEKTABLE reserved up front and patched on the seek-back,
    PADDING, PICTURE and CUESHEET."""
    n = 5 * 1024 + 37
    path = _write(tmp_path / "in.wav", rng, n, channels, depth)
    fields = dict(block_size=1024, channels=_channels(channels), prediction=prediction)
    extra = [picture_block(PNG, "image/png", is_last=False), parse_cue_sheet(CUE, 44100, n)]
    kw = dict(tags=[("TITLE", "stream"), ("ARTIST", "zf")], seek_interval=2048, padding=64,
              extra_metadata=extra)
    out = tmp_path / "port.flac"
    zt.encode_file_streaming(path, str(out), config=zt.EncoderConfig(**fields), device="cpu",
                             frames_per_chunk=3, **kw)
    got = out.read_bytes()
    with open(path, "rb") as f:
        assert got == zt.encode_wav_bytes(f.read(), config=zt.EncoderConfig(**fields),
                                          device="cpu", **kw)
    ref = tmp_path / "jax.flac"
    jax_encoder.encode_file(path, str(ref), config=JaxConfig(**fields), backend="device", **kw)
    assert got == ref.read_bytes()


def test_count_seekpoints_equals_jax():
    for total in (0, 1, 100, 255, 256, 257, 10000, 4096 * 7 + 3):
        for block in (1, 16, 256, 4096):
            for interval in (1, 100, 1000, 44100):
                got = encoder._count_seekpoints(total, block, interval)
                assert got == jax_encoder._count_seekpoints(total, block, interval)
                sizes = np.full(-(-total // block), 100, np.int64)
                assert got == len(build_seekpoints(sizes, block, interval, total))


def _wav_bytes(rng, n, channels, depth, rate, kind="mixed"):
    buf = io.BytesIO()
    write_wav(buf, make_signal(rng, n, channels=channels, depth=depth, kind=kind), rate, depth)
    return buf.getvalue()


def test_wav_bytes_many_mixed_formats_equals_jax(rng):
    """Three format groups (16/44.1 stereo, 24/96 stereo, 16/48 mono): the
    shared config takes each group's channel mode."""
    wavs = [
        _wav_bytes(rng, 4096 + 10, 2, 16, 44100),
        _wav_bytes(rng, 4096, 2, 24, 96000, "sine"),
        _wav_bytes(rng, 2 * 4096, 1, 16, 48000, "ramp"),
        _wav_bytes(rng, 4096 + 40, 2, 16, 44100, "quiet_noise"),
    ]
    got = zt.encode_wav_bytes_many(wavs, config=zt.EncoderConfig(), device="cpu")
    assert got == jax_encoder.encode_wav_bytes_many(wavs, config=JaxConfig(), backend="device")
    assert got == [zt.encode_wav_bytes(w, device="cpu") for w in wavs]


def _count_batches(monkeypatch):
    """Spy on the port's batch dispatches: (batches, batches holding
    frames of more than one file, tails). A batch's frame numbers are one
    consecutive run exactly when it holds one file, since every file
    numbers its frames from 0."""
    seen = {"batches": 0, "mixed": 0, "tails": 0}
    batch, tail = pipeline.DevicePipeline.dispatch_batch, pipeline.DevicePipeline.dispatch_tail

    def spy_batch(self, chunk, fns, info):
        seen["batches"] += 1
        seen["mixed"] += bool(np.any(np.diff(fns) != 1))
        return batch(self, chunk, fns, info)

    def spy_tail(self, samples, frame_number, info):
        seen["tails"] += 1
        return tail(self, samples, frame_number, info)

    monkeypatch.setattr(pipeline.DevicePipeline, "dispatch_batch", spy_batch)
    monkeypatch.setattr(pipeline.DevicePipeline, "dispatch_tail", spy_tail)
    return seen


def test_encode_files_crosses_file_boundaries(tmp_path, rng, monkeypatch):
    """frames_per_chunk=4 is smaller than most files: batches hold frames of
    two or three files, files span several batches, and each file's tail
    lands after its last full frames."""
    sigs = [(256 * 7 + 90, "mixed"), (256 * 3, "sine"), (256 * 9 + 70, "quiet_noise"),
            (256 + 65, "ramp")]
    ins = [_write(tmp_path / f"t{i}.wav", rng, n, kind=k) for i, (n, k) in enumerate(sigs)]
    outs = [str(tmp_path / f"t{i}.flac") for i in range(len(ins))]
    cfg = zt.EncoderConfig(block_size=256)
    seen = _count_batches(monkeypatch)
    zt.encode_files(ins, outs, config=cfg, device="cpu", frames_per_chunk=4)
    assert seen == {"batches": 5, "mixed": 3, "tails": 3}
    for i, o in zip(ins, outs):
        with open(i, "rb") as f, open(o, "rb") as g:
            assert g.read() == zt.encode_wav_bytes(f.read(), config=cfg, device="cpu")


def test_multifile_small_tails_equal_jax(tmp_path, rng):
    """Tails of 1, 2, 3 and 63 samples (the JAX package's host oracle) and
    64 (its device path) all encode on the port's device path, fused."""
    cases = [(2, 1), (1, 2), (3, 3), (1, 63), (2, 64)]
    ins = [_write(tmp_path / f"s{i}.wav", rng, k * 256 + rem)
           for i, (k, rem) in enumerate(cases)]
    outs = [str(tmp_path / f"s{i}.flac") for i in range(len(ins))]
    refs = [str(tmp_path / f"s{i}.jax.flac") for i in range(len(ins))]
    zt.encode_files(ins, outs, config=zt.EncoderConfig(block_size=256), device="cpu",
                    frames_per_chunk=4)
    jax_encoder.encode_files(ins, refs, config=JaxConfig(block_size=256), backend="device",
                             frames_per_chunk=4)
    for o, r in zip(outs, refs):
        with open(o, "rb") as f, open(r, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("n", [0, 1, 50])
def test_zero_frame_and_short_wavs_finalize(tmp_path, rng, n):
    """A WAV with no samples and WAVs shorter than one block finalize with
    their STREAMINFO, through encode_file and through encode_files."""
    path = _write(tmp_path / "in.wav", rng, n)
    cfg, jcfg = zt.EncoderConfig(block_size=256), JaxConfig(block_size=256)
    out, ref = tmp_path / "port.flac", tmp_path / "jax.flac"
    zt.encode_file(path, str(out), config=cfg, device="cpu")
    jax_encoder.encode_file(path, str(ref), config=jcfg, backend="device")
    assert out.read_bytes() == ref.read_bytes()
    zt.encode_files([path], [str(out)], config=cfg, device="cpu")
    jax_encoder.encode_files([path], [str(ref)], config=jcfg, backend="device")
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("entry", ["encode_file", "encode_files"])
def test_ogg_output_equals_jax(tmp_path, rng, entry):
    ins = [_write(tmp_path / "a.wav", rng, 256 * 5 + 37),
           _write(tmp_path / "b.wav", rng, 256 * 3 + 5, kind="sine")]
    cfg, jcfg = zt.EncoderConfig(block_size=256), JaxConfig(block_size=256)
    outs = [str(tmp_path / f"{i}.oga") for i in range(2)]
    refs = [str(tmp_path / f"{i}.jax.oga") for i in range(2)]
    if entry == "encode_file":
        ins, outs, refs = ins[:1], outs[:1], refs[:1]
        extra = [picture_block(PNG, "image/png", is_last=False),
                 parse_cue_sheet(CUE, 44100, 256 * 5 + 37)]
        kw = dict(tags=[("TITLE", "ogg")], seek_interval=512, padding=32, extra_metadata=extra)
        zt.encode_file(ins[0], outs[0], config=cfg, device="cpu", ogg=True, **kw)
        jax_encoder.encode_file(ins[0], refs[0], config=jcfg, backend="device", ogg=True, **kw)
    else:
        zt.encode_files(ins, outs, config=cfg, device="cpu", ogg=True)
        jax_encoder.encode_files(ins, refs, config=jcfg, backend="device", ogg=True)
    for o, r in zip(outs, refs):
        with open(o, "rb") as f, open(r, "rb") as g:
            got = f.read()
            assert got[:4] == b"OggS" and got == g.read()


def test_encode_to_file_equals_in_memory_and_jax(tmp_path, rng):
    wav = _wav_bytes(rng, 5 * 256 + 37, 2, 16, 44100)
    reader = zt.WavReader.from_bytes(wav)
    cfg = zt.EncoderConfig(block_size=256)
    out = io.BytesIO()
    info = zt.encode_to_file(out, reader.planar_samples(), reader.flac_streaminfo(256),
                             config=cfg, device="cpu")
    assert out.getvalue() == zt.encode_wav_bytes(wav, config=cfg, device="cpu")
    ref = io.BytesIO()
    jinfo = jax_encoder.encode_to_file(ref, reader.planar_samples(),
                                       JaxStreamInfo(44100, 2, 16, reader.samples_count, 256, 256),
                                       config=JaxConfig(block_size=256), backend="device")
    assert out.getvalue() == ref.getvalue()
    assert info.md5 == jinfo.md5


def test_encode_frame_and_batch_equal_golden(rng):
    """Encoder.encode_frame (one tail dispatch on the device path) and
    encode_frames_batch equal the golden oracle's frames."""
    x = make_signal(rng, 3 * 256 + 40, channels=2)
    info = zt.StreamInfo(44100, 2, 16, x.shape[1], 256, 256)
    jinfo = JaxStreamInfo(44100, 2, 16, x.shape[1], 256, 256)
    enc = zt.Encoder(zt.EncoderConfig(block_size=256), 16, "cpu")
    frames = x[:, : 3 * 256].reshape(2, 3, 256).transpose(1, 0, 2)
    jcfg = JaxConfig(block_size=256)
    assert enc.encode_frames_batch(frames, 4, info) == [
        golden.encode_frame(list(frames[i]), 4 + i, jinfo, jcfg) for i in range(3)]
    for planes, fn in (([x[0, :256], x[1, :256]], 4), ([x[0, 768:], x[1, 768:]], 7)):
        assert enc.encode_frame(planes, fn, info) == golden.encode_frame(planes, fn, jinfo, jcfg)


def test_encode_file_is_streaming_and_bounded(tmp_path, rng, monkeypatch):
    """encode_file goes through the chunked reader and never asks it for
    more than one batch (batch_size * block samples) at a time."""
    path = _write(tmp_path / "in.wav", rng, 256 * 40)
    cfg = zt.EncoderConfig(block_size=256)
    asked = []
    read = WavStreamReader.read_samples

    def spy(self, m):
        asked.append(m)
        return read(self, m)

    monkeypatch.setattr(WavStreamReader, "read_samples", spy)
    out = tmp_path / "o.flac"
    zt.encode_file(path, str(out), config=cfg, device="cpu")
    assert asked and max(asked) <= pipeline.DEFAULT_BATCH * 256
    with open(path, "rb") as f:
        assert out.read_bytes() == zt.encode_wav_bytes(f.read(), config=cfg, device="cpu")


@pytest.mark.parametrize("ogg", [False, True])
def test_failed_encode_leaves_no_partial_output(tmp_path, rng, monkeypatch, ogg):
    path = _write(tmp_path / "in.wav", rng, 256 * 9 + 3)
    out = tmp_path / "o.flac"

    def fail(self, pending, info):
        raise RuntimeError("collect failed")

    monkeypatch.setattr(pipeline.DevicePipeline, "collect_batch", fail)
    with pytest.raises(RuntimeError, match="collect failed"):
        zt.encode_file_streaming(path, str(out), config=zt.EncoderConfig(block_size=256),
                                 device="cpu", frames_per_chunk=2, ogg=ogg)
    assert not out.exists()


@pytest.mark.parametrize("entry", ["encode_file", "encode_files", "encode_wav_bytes_many",
                                   "encode_to_file"])
def test_new_entry_points_default_to_the_card(tmp_path, rng, monkeypatch, entry):
    """Without a device argument every entry point takes cuda, and without
    a card it raises instead of falling back to the CPU; encode_file writes
    nothing."""
    path = _write(tmp_path / "in.wav", rng, 1000)
    out = tmp_path / "o.flac"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "encode_file":
            zt.encode_file(path, str(out))
        elif entry == "encode_files":
            zt.encode_files([path], [str(out)])
        elif entry == "encode_wav_bytes_many":
            with open(path, "rb") as f:
                zt.encode_wav_bytes_many([f.read()])
        else:
            reader = zt.WavReader.from_file(path)
            zt.encode_to_file(io.BytesIO(), reader.planar_samples(), reader.flac_streaminfo(4096))
    if entry == "encode_file":
        assert not out.exists()
