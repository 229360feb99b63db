"""The port's decoder (``zigflac_tpu_torch/decoder.py``) on the CPU against
the JAX package's: ``decode_flac(device="cpu")`` against the scalar host
decoder (``backend="host"``) field by field, on every stream shape the
encoder emits and on the 22 pinned corpus streams; the port's own round
trip; ``backend="native"``, ``decode_file``, ``decode_range`` and
``verify_flac``; and the errors. Streams are encoded once per module and
shared between cases. The C++ frame parser is built with g++ at first use;
a test that cannot build it fails.

Tolerance: exact equality of samples, counts, verdicts and files."""

import io
import json
import os
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu import decoder as jax_decoder
from zigflac_tpu_torch import decoder, ogg
from zigflac_tpu_torch.ops import _build, synth
from zigflac_tpu_torch.wav import WavReader, write_wav

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "vectors", "corpus")
with open(os.path.join(CORPUS_DIR, "manifest.json")) as _f:
    CORPUS = sorted(json.load(_f)["cases"])

BLOCK = 256
# name -> (samples, depth, channels, signal kind, encoder fields)
STREAMS = {
    **{f"kind_{k}": (BLOCK * 5 + 100, 16, 2, k, {})
       for k in ("silence", "constant", "sine", "mixed", "noise", "alternating")},
    **{f"depth_{d}": (BLOCK * 4 + 33, d, c, "mixed", {})
       for d, c in ((8, 1), (12, 2), (16, 2), (20, 2), (24, 2), (32, 2))},
    "lpc": (BLOCK * 6 + 17, 16, 2, "sine", dict(prediction="lpc", lpc_order=8)),
    "lpc32_order12": (BLOCK * 3 + 9, 32, 2, "mixed", dict(prediction="lpc", lpc_order=12)),
    "wasted": (BLOCK * 4, 16, 2, "wasted", dict(wasted_bits=True)),
    "verbatim_escape": (BLOCK * 3 + 55, 16, 2, "noise", {}),
    "multibatch": (BLOCK * 530, 16, 2, "sine", {}),  # more frames than one parse batch (512)
    "eight_channels": (BLOCK * 2 + 5, 16, 8, "mixed", {}),
    "seek": (BLOCK * 9 + 77, 16, 2, "mixed", {}),
}


def _wav_of(name):
    n, depth, channels, kind, _ = STREAMS[name]
    rng = np.random.default_rng(sorted(STREAMS).index(name))
    if kind == "wasted":
        sig = make_signal(rng, n, depth=depth, kind="mixed") & ~0x7
    else:
        sig = make_signal(rng, n, channels=channels, depth=depth, kind=kind)
    buf = io.BytesIO()
    write_wav(buf, sig, 44100, depth)
    # the samples as the encoder reads them (the 1-byte container's read
    # quirk moves 8-bit samples)
    return buf.getvalue(), WavReader.from_bytes(buf.getvalue()).planar_samples()


@pytest.fixture(scope="module")
def stream():
    """name -> (FLAC bytes from the port on the CPU, the WAV's samples),
    encoded on first use and kept for the module."""
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            wav, sig = _wav_of(name)
            channels, fields = STREAMS[name][2], STREAMS[name][4]
            cfg = zt.EncoderConfig(block_size=BLOCK,
                                   channels="stereo_auto" if channels == 2 else channels,
                                   **fields)
            cache[key] = zt.encode_wav_bytes(wav, config=cfg, device="cpu", **kw), sig
        return cache[key]

    return get


def _assert_same_as_host(flac):
    """Every field of the port's decode equals the scalar host decoder's."""
    want = jax_decoder.decode_flac(flac, backend="host")
    synth.reset_counts()
    got = decoder.decode_flac(flac, device="cpu")
    assert synth.PLAIN_CALLS > 0 and synth.KERNEL_LAUNCHES == 0
    assert got.samples.dtype == np.int64 and got.samples.shape == want.samples.shape
    np.testing.assert_array_equal(got.samples, want.samples)
    assert got.frame_count == want.frame_count
    assert got.md5_ok and want.md5_ok
    assert (got.tags, got.seektable, got.vendor) == (want.tags, want.seektable, want.vendor)
    assert asdict(got.info) == asdict(want.info)  # one dataclass per package
    return got


@pytest.mark.parametrize("name", [n for n in STREAMS if n != "seek"])
def test_decode_equals_host_decoder(stream, name):
    flac, sig = stream(name)
    got = _assert_same_as_host(flac)
    np.testing.assert_array_equal(got.samples, sig)


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_decode_equals_host_decoder(name):
    with open(os.path.join(CORPUS_DIR, name + ".flac"), "rb") as f:
        _assert_same_as_host(f.read())


def test_tags_and_seektable_equal_host_decoder(stream):
    flac, _ = stream("seek", tags=(("TITLE", "decoder"), ("ARTIST", "zf")),
                     seek_interval=BLOCK * 2, padding=64)
    got = _assert_same_as_host(flac)
    assert got.tags == [("TITLE", "decoder"), ("ARTIST", "zf")] and len(got.seektable) == 5


def test_short_last_frame_ends_its_batch(stream):
    """A batch stops at the frame whose block size differs and the caller
    comes back for it: 5 full frames, then the 100-sample tail alone."""
    flac, sig = stream("kind_mixed")
    info, _, _, _, pos = decoder._parse_metadata(flac)
    cpu = torch.device("cpu")
    first, n1, pos1 = decoder._decode_batch(flac, pos, info, True, cpu)
    tail, n2, pos2 = decoder._decode_batch(flac, pos1, info, True, cpu)
    assert (n1, first.shape, n2, tail.shape, pos2) == (5, (2, 5 * BLOCK), 1, (2, 100), len(flac))
    np.testing.assert_array_equal(np.concatenate([first, tail], 1), sig)
    assert decoder._decode_batch(flac, pos2, info, True, cpu)[1] == 0
    # a frame budget smaller than the run of equal frames
    assert decoder._decode_batch(flac, pos, info, True, cpu, max_frames=2)[1] == 2


@pytest.mark.parametrize("prediction", ["fixed", "lpc"])
@pytest.mark.parametrize("depth", [16, 24, 32])
def test_port_round_trip(depth, prediction):
    """WAV -> FLAC -> PCM through the port alone, at the default block."""
    rng = np.random.default_rng(depth)
    sig = make_signal(rng, 4096 + 700, depth=depth, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, sig, 48000, depth)
    flac = zt.encode_wav_bytes(buf.getvalue(), config=zt.EncoderConfig(prediction=prediction),
                               device="cpu")
    got = zt.decode_flac(flac, device="cpu")
    np.testing.assert_array_equal(got.samples, sig)
    assert got.md5_ok and got.frame_count == 2 and got.info.sample_rate == 48000
    assert zt.verify_flac(flac, device="cpu")


@pytest.mark.parametrize("name", ["kind_mixed", "depth_8", "depth_32", "lpc", "wasted",
                                  "multibatch", "eight_channels"])
def test_native_backend_equals_device_backend(stream, name):
    flac, sig = stream(name)
    synth.reset_counts()
    got = decoder.decode_flac(flac, backend="native")
    assert (synth.PLAIN_CALLS, synth.KERNEL_LAUNCHES) == (0, 0)  # no torch on this path
    want = decoder.decode_flac(flac, device="cpu")
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.samples, sig)
    assert got.md5_ok and got.frame_count == want.frame_count


@pytest.mark.parametrize("how", ["device", "threads1", "threads4"])
@pytest.mark.parametrize("name", ["seek", "depth_8", "depth_24", "depth_32"])
def test_decode_file_equals_jax(stream, tmp_path, name, how):
    """The WAV that decode_file writes, through the device backend and the
    all-C++ path on 1 and 4 threads, is the JAX package's and the input's."""
    flac, _ = stream(name)
    (tmp_path / "a.flac").write_bytes(flac)
    kw = dict(device="cpu") if how == "device" else dict(backend="native", threads=int(how[-1]))
    info = decoder.decode_file(str(tmp_path / "a.flac"), str(tmp_path / "port.wav"),
                               verify=True, **kw)
    want = jax_decoder.decode_file(str(tmp_path / "a.flac"), str(tmp_path / "jax.wav"),
                                   verify=True, backend="host")
    assert asdict(info) == asdict(want)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    if name != "depth_8":  # the 1-byte container's read quirk is not undone
        assert (tmp_path / "port.wav").read_bytes() == _wav_of(name)[0]


def test_decode_file_takes_threads_only_on_the_native_backend(stream, tmp_path):
    (tmp_path / "a.flac").write_bytes(stream("seek")[0])
    with pytest.raises(ValueError):
        decoder.decode_file(str(tmp_path / "a.flac"), str(tmp_path / "o.wav"), device="cpu",
                            threads=2)
    with pytest.raises(ValueError):
        decoder.decode_flac(stream("seek")[0], device="cpu", backend="host")


@pytest.mark.parametrize("backend", ["device", "native"])
@pytest.mark.parametrize("seektable", [True, False])
def test_decode_range(stream, seektable, backend):
    flac, sig = stream("seek", **(dict(seek_interval=BLOCK * 2) if seektable else {}))
    for start, n in [(0, 100), (BLOCK * 3 + 5, 300), (BLOCK * 8, BLOCK + 77), (BLOCK * 9, 77),
                     (BLOCK * 4 + 1, 99)]:
        got = decoder.decode_range(flac, start, n, device="cpu", backend=backend)
        np.testing.assert_array_equal(got, sig[:, start : start + n])
        np.testing.assert_array_equal(got, jax_decoder.decode_range(flac, start, n,
                                                                    backend="host"))
    with pytest.raises(decoder.FlacDecodeError):
        decoder.decode_range(flac, BLOCK * 9, 100, device="cpu", backend=backend)  # past the end
    with pytest.raises(decoder.FlacDecodeError):
        decoder.decode_range(flac, -1, 10, device="cpu", backend=backend)


@pytest.mark.parametrize("backend", ["device", "native"])
def test_flipped_frame_byte_raises_crc(stream, backend):
    flac = bytearray(stream("kind_mixed")[0])
    assert decoder.verify_flac(bytes(flac), device="cpu", backend=backend)
    flac[len(flac) // 2] ^= 0xFF  # mid-frame
    with pytest.raises(decoder.FlacDecodeError, match="CRC mismatch"):
        decoder.decode_flac(bytes(flac), device="cpu", backend=backend)
    assert not decoder.verify_flac(bytes(flac), device="cpu", backend=backend)
    assert not jax_decoder.verify_flac(bytes(flac))


def test_flipped_md5_is_reported_not_raised(stream, tmp_path):
    flac = bytearray(stream("kind_mixed")[0])
    flac[26] ^= 0xFF  # a byte inside the STREAMINFO MD5 field
    got = decoder.decode_flac(bytes(flac), device="cpu")
    assert not got.md5_ok and not jax_decoder.decode_flac(bytes(flac), backend="host").md5_ok
    np.testing.assert_array_equal(got.samples, stream("kind_mixed")[1])
    assert not decoder.verify_flac(bytes(flac), device="cpu")
    (tmp_path / "bad.flac").write_bytes(bytes(flac))
    decoder.decode_file(str(tmp_path / "bad.flac"), str(tmp_path / "x.wav"), device="cpu")
    for kw in (dict(device="cpu"), dict(backend="native", threads=1)):
        with pytest.raises(decoder.FlacDecodeError, match="MD5 mismatch"):
            decoder.decode_file(str(tmp_path / "bad.flac"), str(tmp_path / "y.wav"),
                                verify=True, **kw)


@pytest.mark.parametrize("cut", [40, 1000, "metadata", "signature"])
def test_truncated_input_fails_verification(stream, cut):
    flac = stream("kind_mixed")[0]
    bad = {"metadata": flac[:20], "signature": b"fLa"}.get(cut) or flac[: len(flac) - cut]
    assert not decoder.verify_flac(bad, device="cpu")
    assert not decoder.verify_flac(bad, backend="native")
    assert not jax_decoder.verify_flac(bad)


def test_diverging_stream_raises_the_guard_as_the_jax_decoder_does(stream):
    """Single-bit flips in the first frame's LPC parameters of a 32-bit
    stream, CRC checks off: each decodes, fails to parse or diverges past
    2^40, and the port says what the JAX decoder's device backend says,
    sample for sample where there are samples."""
    flac, _ = stream("lpc32_order12")
    pos = decoder._parse_metadata(flac)[4]
    outcomes = set()
    for off in range(pos + 39, pos + 46):  # the shift and the first coefficients
        for bit in range(8):
            bad = bytearray(flac)
            bad[off] ^= 1 << bit
            results = []
            for fn in (lambda b: decoder.decode_flac(b, check_crc=False, device="cpu"),
                       lambda b: decoder.decode_flac(b, check_crc=False, backend="native"),
                       lambda b: jax_decoder.decode_flac(b, check_crc=False, backend="device")):
                try:
                    results.append(fn(bytes(bad)).samples)
                except ValueError as e:  # FlacDecodeError of either package
                    results.append(str(e))
            port, native, want = results
            assert type(port) is type(want) is type(native), (off, bit, port, want)
            if isinstance(want, str):
                assert port == want == native, (off, bit)
                outcomes.add(want)
            else:
                np.testing.assert_array_equal(port, want)
                np.testing.assert_array_equal(native, want)
                outcomes.add("decoded")
    assert outcomes == {"synthesis diverged — corrupt stream", "bad subframe", "decoded"}


@pytest.mark.parametrize("name", ["kind_mixed", "lpc", "depth_24"])
def test_ogg_flac_input_decodes(stream, tmp_path, name):
    """The port's own transmux (which reaches the port's decoder for the
    metadata and the repository root's C++ runtime for the frame scan)
    makes the Ogg-FLAC input."""
    flac, sig = stream(name)
    buf = io.BytesIO()
    ogg.flac_to_ogg(flac, buf)
    oga = buf.getvalue()
    assert oga[:4] == b"OggS" and decoder.verify_flac(oga, device="cpu")
    assert ogg.ogg_to_flac(oga) == flac
    (tmp_path / "a.oga").write_bytes(oga)
    decoder.decode_file(str(tmp_path / "a.oga"), str(tmp_path / "o.wav"), device="cpu",
                        verify=True)
    np.testing.assert_array_equal(
        WavReader.from_bytes((tmp_path / "o.wav").read_bytes()).planar_samples(), sig)
    bad = bytearray(oga)
    bad[len(bad) // 2] ^= 0x55  # a page CRC fails
    assert not decoder.verify_flac(bytes(bad), device="cpu")
    (tmp_path / "bad.oga").write_bytes(bytes(bad))
    with pytest.raises(decoder.FlacDecodeError):
        decoder.decode_file(str(tmp_path / "bad.oga"), str(tmp_path / "x.wav"), device="cpu")


def test_default_device_is_cuda_and_no_card_raises(stream, monkeypatch, tmp_path):
    """Without a card every entry point raises; none falls back to the CPU,
    and verify_flac does not take the missing card for a bad stream."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flac = stream("kind_mixed")[0]
    (tmp_path / "a.flac").write_bytes(flac)
    synth.reset_counts()
    for call in (lambda: decoder.decode_flac(flac), lambda: decoder.verify_flac(flac),
                 lambda: decoder.decode_range(flac, 0, 10),
                 lambda: decoder.decode_file(str(tmp_path / "a.flac"), str(tmp_path / "o.wav"))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert synth.PLAIN_CALLS == 0 and not (tmp_path / "o.wav").exists()


def test_parser_is_built_from_source_under_its_own_name():
    """The parser is the tracked C++ source built into the build directory
    and loaded from its file: it is not the module that ``import
    _zf_native`` finds, and building it does not displace that module."""
    before = sys.modules.get("_zf_native")
    mod = _build.native_module()
    assert mod is _build.native_module()
    assert os.path.dirname(mod.__file__) == str(_build.BUILD_DIR)
    assert sys.modules.get("_zf_native") is before and mod is not before
    for fn in ("parse_frames", "synthesize", "decode_frames_pcm", "decode_frames_pcm_mt"):
        assert callable(getattr(mod, fn))


def test_parser_that_cannot_be_built_raises_with_the_compiler_output(stream, monkeypatch,
                                                                     tmp_path):
    """No Python bit parser stands behind the C++ one."""
    broken = tmp_path / "zf_native.cpp"
    broken.write_text("#include <Python.h>\nthis is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_SOURCE", broken)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_native", None)
    for call in (lambda: decoder.decode_flac(stream("kind_mixed")[0], device="cpu"),
                 lambda: decoder.verify_flac(stream("kind_mixed")[0], backend="native")):
        with pytest.raises(RuntimeError, match=r"g\+\+ failed(.|\n)*error"):
            call()
    assert not list((tmp_path / "build").glob("*.so"))
