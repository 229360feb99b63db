"""The PCM unpack (zigflac_tpu_torch/csrc/unpack_steps.cuh, ops/unpack.py)
and the card-fed encode route that takes it, on the CPU.

The kernel's arithmetic is built for the host with g++ behind a loop that
runs csrc/unpack.cu's threads (one a sample frame) one after another; it
and the plain version are held to ``WavReader.planar_samples`` (the host
de-interleave, ``native.deinterleave``) at containers of 1-4 bytes, depths
4-32 (the 8-bit read quirk with 0x80 bytes, left-justified 12- and 20-bit
samples, 32 bits), 1-8 channels, bucket rows past ``nreal`` and ragged
tails. Then ``Encoder.encode_pcm`` on the CPU device (through the plain
version) against the pinned corpus streams and the planar route, capacity
re-encodes included, and the spans and counters of the route.

Tolerance: exact equality of samples and bytes."""

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

import zigflac_tpu_torch
from test_regression_corpus import CASES, VEC_DIR, _case_config, _wav_bytes
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.models.encoder import Encoder
from zigflac_tpu_torch.ops import unpack
from zigflac_tpu_torch.utils import stages
from zigflac_tpu_torch.wav import WavReader, write_wav

CSRC = Path(__file__).resolve().parent.parent / "zigflac_tpu_torch" / "csrc"

# csrc/unpack.cu's grid with its threads run in turn
HOST_HARNESS = r"""
#include "unpack_steps.cuh"

template <int NB>
static void run(const uint8_t* src, int32_t* dst, int channels, int depth, int64_t block,
                int64_t nreal, int64_t n) {
  for (int64_t row = 0; row < n; ++row)
    for (int64_t col = 0; col < block; ++col)
      zf_unpack_frame<NB>(src, dst, channels, depth, block, nreal, row, col);
}

extern "C" int zf_unpack_pcm_host(const uint8_t* src, int32_t* dst, int channels, int nb,
                                  int depth, int64_t block, int64_t nreal, int64_t n) {
  switch (nb) {
    case 1: run<1>(src, dst, channels, depth, block, nreal, n); return 0;
    case 2: run<2>(src, dst, channels, depth, block, nreal, n); return 0;
    case 3: run<3>(src, dst, channels, depth, block, nreal, n); return 0;
    case 4: run<4>(src, dst, channels, depth, block, nreal, n); return 0;
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """unpack_steps.cuh built for the host with g++ behind the kernel's
    grid loop: host(data uint8, channels, nb, depth, block, nreal, n) ->
    int32 [n, channels, block]."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the kernel's arithmetic cannot be built on the host")
    d = tmp_path_factory.mktemp("unpack_host")
    (d / "host.cpp").write_text(HOST_HARNESS)
    so = d / "host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-Wno-unknown-pragmas", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "host.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.zf_unpack_pcm_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_int64] * 3
    lib.zf_unpack_pcm_host.restype = ctypes.c_int

    def run(data, channels, nb, depth, block, nreal, n):
        src = np.ascontiguousarray(data, np.uint8)
        out = np.full((n, channels, block), 0x5A5A5A5A, np.int32)
        assert lib.zf_unpack_pcm_host(src.ctypes.data, out.ctypes.data, channels, nb, depth,
                                      block, nreal, n) == 0
        return out

    return run


def _pcm(seed, nbytes):
    """Random bytes with runs of 0x80 (the 8-bit quirk's wrap), 0x00 and
    0xff (the extremes of every width)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, nbytes, dtype=np.uint8)
    pick = rng.random(nbytes)
    b[pick < 0.1] = 0x80
    b[(pick >= 0.1) & (pick < 0.15)] = 0x00
    b[(pick >= 0.15) & (pick < 0.2)] = 0xFF
    return b


def _want(data, channels, nb, depth, block, nreal, n):
    """The host de-interleave's frames, cut into rows and padded as the
    pipeline pads a bucket."""
    wav = WavReader(sample_rate=44100, bit_depth=depth, channels=channels, bytes_per_sample=nb,
                    samples_count=nreal * block, data=memoryview(data.tobytes()))
    planar = wav.planar_samples()
    frames = planar.reshape(channels, nreal, block).transpose(1, 0, 2)
    return np.concatenate([frames, np.repeat(frames[-1:], n - nreal, 0)])


# (bytes a sample, depth, channels): every container, the 8-bit quirk at
# depths 4-8, left-justified 12 and 20 bits, 32 bits, 1-8 channels
LAYOUTS = [
    (1, 4, 1), (1, 5, 2), (1, 8, 1), (1, 8, 2), (1, 8, 7),
    (2, 9, 1), (2, 12, 2), (2, 16, 1), (2, 16, 2), (2, 16, 3), (2, 16, 4), (2, 16, 5),
    (2, 16, 6), (2, 16, 7), (2, 16, 8),
    (3, 17, 1), (3, 20, 2), (3, 24, 2), (3, 24, 6),
    (4, 25, 1), (4, 28, 3), (4, 32, 2), (4, 32, 8),
]


@pytest.mark.parametrize("nb,depth,channels", LAYOUTS,
                         ids=[f"nb{a}_d{b}_c{c}" for a, b, c in LAYOUTS])
def test_unpack_matches_planar_samples(host, nb, depth, channels):
    """Three rows of 37 frames into a bucket of 5: rows 3 and 4 repeat row
    2. The harness and the plain version equal the host de-interleave."""
    block, nreal, n = 37, 3, 5
    data = _pcm(nb * 100 + depth * 10 + channels, nreal * block * channels * nb)
    want = _want(data, channels, nb, depth, block, nreal, n)
    np.testing.assert_array_equal(host(data, channels, nb, depth, block, nreal, n), want)
    got = unpack.unpack_pcm_plain(torch.from_numpy(data), channels, nb, depth, block, nreal, n)
    assert got.is_contiguous() and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block", [1, 4095, 4096])
@pytest.mark.parametrize("nb,depth,channels", [(2, 16, 2), (3, 24, 2), (1, 8, 1), (4, 32, 3)])
def test_unpack_of_a_tail_row(host, block, nb, depth, channels):
    """A ragged tail is one row of ``rem`` frames (and a full block one row
    of 4096): no padding row, the bytes of the last sample frame read."""
    data = _pcm(block + nb, block * channels * nb)
    want = _want(data, channels, nb, depth, block, 1, 1)
    np.testing.assert_array_equal(host(data, channels, nb, depth, block, 1, 1), want)
    np.testing.assert_array_equal(
        unpack.unpack_pcm(torch.from_numpy(data), channels, nb, depth, block, 1, 1).numpy(), want)


@pytest.mark.parametrize("depth,values", [(8, [127, -1, -2, 126, -128]),
                                          (4, [7, -1, -1, 7, -8])])
def test_unpack_reads_the_8_bit_quirk(host, depth, values):
    """The reference's 1-byte read: 128 >> (8 - depth) is subtracted from the
    top-justified value in u32 (not from the byte), so 0x80 wraps past
    INT32_MIN to the top of the range."""
    data = np.array([0x80, 0x00, 0xFF, 0x7F, 0x81], np.uint8)
    assert _want(data, 1, 1, depth, 5, 1, 1).flatten().tolist() == values
    assert host(data, 1, 1, depth, 5, 1, 1).flatten().tolist() == values
    got = unpack.unpack_pcm_plain(torch.from_numpy(data), 1, 1, depth, 5, 1, 1)
    assert got.flatten().tolist() == values


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    data = torch.from_numpy(_pcm(3, 2 * 10 * 2 * 2 + 7))  # spare bytes are not read
    unpack.reset_counts()
    got = unpack.unpack_pcm(data, 2, 2, 16, 10, 2, 4)
    assert (unpack.KERNEL_LAUNCHES, unpack.PLAIN_CALLS) == (0, 1)
    assert torch.equal(got, unpack.unpack_pcm_plain(data, 2, 2, 16, 10, 2, 4))


@pytest.mark.parametrize("args,exc", [
    ((torch.zeros(16, dtype=torch.int16), 2, 2, 16, 2, 1, 1), TypeError),
    ((torch.zeros((2, 8), dtype=torch.uint8), 2, 2, 16, 2, 1, 1), TypeError),
    ((torch.zeros(32, dtype=torch.uint8)[::2], 2, 2, 16, 2, 1, 1), TypeError),
    ((torch.zeros(16, dtype=torch.uint8), 0, 2, 16, 2, 1, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 9, 2, 16, 2, 1, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 2, 5, 16, 2, 1, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 2, 2, 17, 2, 1, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 2, 2, 16, 0, 1, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 2, 2, 16, 2, 2, 1), ValueError),
    ((torch.zeros(16, dtype=torch.uint8), 2, 2, 16, 2, 0, 1), ValueError),
    ((torch.zeros(15, dtype=torch.uint8), 2, 2, 16, 2, 2, 2), ValueError),
    ((torch.zeros(16, dtype=torch.uint8, device="meta"), 2, 2, 16, 2, 1, 1),
     NotImplementedError),
], ids=["int16", "2d", "strided", "no_channel", "9_channels", "5_bytes", "depth_over_container",
        "empty_block", "nreal_over_n", "no_row", "short_data", "meta_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, exc):
    with pytest.raises(exc):
        unpack.unpack_pcm(*args)


# -- the card-fed route on the CPU device -----------------------------------------------


def _route(wav_bytes, cfg):
    """``Encoder.encode_pcm`` of a WAV on the CPU device: the card-fed
    route, through the plain unpack."""
    wav = WavReader.from_bytes(wav_bytes)
    enc = Encoder(cfg, wav.bit_depth, "cpu")
    return enc.encode_pcm(wav.raw_pcm_bytes(), wav.bytes_per_sample,
                          wav.flac_streaminfo(cfg.block_size))


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_card_fed_route_gives_the_corpus_streams(name):
    """Every pinned corpus stream (the JAX package's bytes, 8-32 bits, 1-8
    channels, fixed and LPC) through the card-fed route."""
    case = next(c for c in CASES if c["name"] == name)
    unpack.reset_counts()
    flac = _route(_wav_bytes(case), EncoderConfig(**asdict(_case_config(case))))
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert hashlib.sha256(flac).digest() == hashlib.sha256(f.read()).digest()
    assert unpack.PLAIN_CALLS > 0 and unpack.KERNEL_LAUNCHES == 0


def _wav(depth, n, seed, lim=None):
    """Stereo white noise, full scale unless ``lim`` is given."""
    rng = np.random.default_rng(seed)
    lim = lim or 1 << (depth - 1)
    buf = io.BytesIO()
    write_wav(buf, rng.integers(-lim, lim, (2, n)), 44100, depth)
    return buf.getvalue()


@pytest.fixture
def armed():
    stages.SPANS, stages.COUNTS = [], {}
    yield
    stages.SPANS = stages.COUNTS = None


@pytest.mark.parametrize("ladder", [((0.05, 0.1), (1.15, None)), ((0.05, 0.1), (0.1, 0.2))],
                         ids=["tier1", "exact"])
@pytest.mark.parametrize("depth", [16, 24])
def test_card_fed_route_re_encodes_from_its_frames(armed, monkeypatch, depth, ladder):
    """Noise past the first tier (and, with a ladder too small for it, past
    every tier to the exact words path) re-encodes from the frames the
    dispatch unpacked: one unpack a dispatch, the planar route's bytes, and
    every encoded row counted as unpacked."""
    wav = _wav(depth, 3 * 1024 + 321, depth)
    cfg = EncoderConfig(block_size=1024)
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ladder)
    want = zigflac_tpu_torch.encode_wav_bytes(wav, cfg, device="cpu")
    stages.SPANS, stages.COUNTS = [], {}
    unpack.reset_counts()
    assert _route(wav, cfg) == want
    t = stages.totals()
    assert unpack.PLAIN_CALLS == t["pipeline.dispatch_batch"][0] + t["pipeline.dispatch_tail"][0]
    c = stages.COUNTS
    assert c["pipeline.frames_unpacked"] == c["pipeline.frames_encoded"] > 4 + 2
    # the re-encodes send no PCM, only their rows' frame numbers
    assert c["pipeline.h2d_bytes"] == (len(WavReader.from_bytes(wav).raw_pcm_bytes())
                                       + 8 * c["pipeline.frames_encoded"])


@pytest.fixture
def card_fed(monkeypatch):
    """``encode_wav_bytes`` on the CPU device takes the card-fed route, as
    it does on a single CUDA device."""
    monkeypatch.setattr(pipeline.DevicePipeline, "card_fed",
                        property(lambda self: self._mesh is None))


def test_encode_wav_bytes_routes_by_the_pipeline(armed):
    """The planar route on the CPU device: the host de-interleave, the MD5
    of the WAV's own bytes with no raw copy for it, and no row from the
    unpack."""
    wav = _wav(16, 2 * 4096 + 99, 5, 3000)
    assert not pipeline.DevicePipeline(EncoderConfig(), 16, "cpu").card_fed
    zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu")
    t = stages.totals()
    assert t["wav.planar_samples"][0] == t["session.md5"][0] == 1
    assert "wav.raw_copy" not in t
    assert stages.COUNTS["pipeline.frames_unpacked"] == 0


@pytest.mark.parametrize("seek", [None, 4096])
def test_card_fed_encode_wav_bytes_spans_split_the_call(armed, card_fed, seek):
    """On the card-fed route ``encode_wav_bytes`` gives the planar route's
    bytes, opens no ``wav.planar_samples`` or ``wav.raw_copy``, counts
    every encoded row as unpacked, and its layers' spans still add up to the
    call: feed + session + h2d + dispatch (self) + wait + collect + the
    call's own time."""
    wav = _wav(16, 2 * 4096 + 99, 6, 300)
    got = zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu", seek_interval=seek,
                                             tags=[("TITLE", "x")])
    t = stages.totals()
    c = dict(stages.COUNTS)
    stages.SPANS, stages.COUNTS = None, None
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu", seek_interval=seek,
                                                     tags=[("TITLE", "x")])
    assert "wav.planar_samples" not in t and "wav.raw_copy" not in t
    assert t["session.md5"][0] == 1 and t["pipeline.h2d"][0] == 4  # two dispatches' bytes and frame numbers
    assert c["pipeline.frames_unpacked"] == c["pipeline.frames_encoded"] == 3
    assert c["pipeline.frames_real"] == 3

    def tot(*names):
        return sum(t[n][1] for n in names if n in t)

    def own(*names):
        return sum(t[n][2] for n in names if n in t)

    parts = (tot("wav.parse", "session.setup", "session.md5", "session.finish", "pipeline.h2d",
                 "pipeline.wait", "pipeline.d2h", "pipeline.assemble", "pipeline.join")
             + own("pipeline.dispatch_batch", "pipeline.dispatch_tail",
                   "pipeline.collect_batch", "encode.call"))
    assert parts == pytest.approx(t["encode.call"][1], rel=1e-9)


def test_card_fed_route_refuses_a_tail_before_any_batch(card_fed, monkeypatch):
    """A tail whose partition order the analysis cannot hold is refused
    before a single batch is unpacked, as on the planar route."""
    cfg = EncoderConfig(block_size=4096)
    wav = _wav(16, 4096 + 3000, 7, 3000)
    calls = []
    monkeypatch.setattr(pipeline, "unpack_pcm", lambda *a: calls.append(a))
    monkeypatch.setattr(pipeline, "check_partition_order", _refuse_under(4096))
    with pytest.raises(ValueError):
        zigflac_tpu_torch.encode_wav_bytes(wav, cfg, device="cpu")
    assert calls == []


def _refuse_under(block):
    def check(b, max_rice_order):
        if b < block:
            raise ValueError(f"refused block {b}")
    return check
