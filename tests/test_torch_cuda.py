"""The port on a CUDA card: the deposit, synthesis, analysis, CRC-16,
frame symbols and PCM unpack kernels against their plain versions, and whole encodes and
decodes on the card against the CPU path. Every test skips where
torch.cuda.is_available() is false. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: exact equality of words and bytes."""

import io

import numpy as np
import pytest
import torch

import zigflac_tpu_torch
from zigflac_tpu_torch import EncoderConfig
from zigflac_tpu_torch.models import pipeline
from zigflac_tpu_torch.ops import deposit, synth, unpack
from zigflac_tpu_torch.utils.apodization import TUKEY_HALF, windows_of
from zigflac_tpu_torch.wav import write_wav

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return np.random.default_rng(0xC0DA)


def _stream(rng, n, s, max_nbv=65, gap=9, junk=False):
    nbv = rng.integers(0, max_nbv, (n, s))
    nb = np.where(nbv > 0, nbv + rng.integers(0, gap, (n, s)), 0)
    val = rng.integers(-(2**63), 2**63 - 1, (n, s), dtype=np.int64, endpoint=True)
    if not junk:
        val &= np.where(nbv >= 64, -1, (np.int64(1) << np.minimum(nbv, 63)) - 1)
    return np.cumsum(nb, 1).astype(np.int32), val, nbv.astype(np.int32)


@pytest.mark.parametrize(
    "n,s,max_nbv,gap,junk,budget",
    [
        (3, 300, 65, 9, False, 1.0),   # values up to 64 bits
        (2, 300, 65, 9, True, 1.0),    # bits above nbv ignored
        (2, 300, 34, 4, False, 0.5),   # word budget clamp
        (4, 20000, 40, 12, False, 1.0),  # row over the shared-memory budget
        (1024, 64, 20, 4, False, 1.0),   # many short frames
    ],
)
def test_kernel_matches_plain(rng, n, s, max_nbv, gap, junk, budget):
    d_cum, val, nbv = _stream(rng, n, s, max_nbv, gap, junk)
    W = max(1, int((int(d_cum.max()) // 32 + 3) * budget))
    args = [torch.from_numpy(a).cuda() for a in (d_cum, val, nbv)]
    deposit.reset_counts()
    got = deposit.deposit_words(*args, W)
    assert (deposit.KERNEL_LAUNCHES, deposit.PLAIN_CALLS) == (1, 0)
    torch.testing.assert_close(got, deposit.deposit_words_plain(*args, W), rtol=0, atol=0)


def _wav(rng, n, channels=2, depth=16, rate=44100):
    t = np.arange(n)
    x = 0.3 * (1 << (depth - 1)) * np.sin(2 * np.pi * 440 * t / rate)
    x = x + rng.normal(0, 1 << (depth - 8), (channels, n))
    lim = 1 << (depth - 1)
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -lim, lim - 1).astype(np.int64), rate, depth)
    return buf.getvalue()


@pytest.mark.parametrize("channels,depth,block", [(2, 16, 4096), (1, 24, 1024), (8, 16, 4096)])
def test_encode_on_card_equals_cpu(rng, channels, depth, block):
    wav = _wav(rng, 3 * block + 1000, channels, depth)
    cfg = EncoderConfig(block_size=block,
                        channels="stereo_auto" if channels == 2 else channels)
    deposit.reset_counts()
    got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


@pytest.mark.parametrize(
    "depth,fields",
    [(16, dict(prediction="lpc")), (24, dict(prediction="lpc", lpc_order=32, channels=2)),
     (32, dict(prediction="fixed")), (32, dict(prediction="lpc", wasted_bits=True))],
    ids=["lpc16", "lpc24_o32_indep", "fixed32", "lpc32"],
)
def test_lpc_and_depth32_on_card_equal_cpu(rng, depth, fields):
    wav = _wav(rng, 2 * 4096 + 777, 2, depth)
    cfg = EncoderConfig(**fields)
    deposit.reset_counts()
    got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


def test_lpc_largest_block_on_card_equals_cpu(rng):
    """LPC at the format's largest block, 65535 samples, on quiet
    negative-DC content, whose lag sums run past 2^15 products."""
    noise = -4 + rng.integers(-2, 3, (2, 65535 + 300))
    buf = io.BytesIO()
    write_wav(buf, noise, 44100, 16)
    wav = buf.getvalue()
    cfg = EncoderConfig(block_size=65535, prediction="lpc")
    deposit.reset_counts()
    got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


def test_depth32_exact_tier_on_card(rng, monkeypatch):
    """A 32-bit batch forced past tier 0 re-encodes at the exact tier,
    whose 73 KB rows take the kernel's global-memory branch."""
    n = 2 * 4096 + 99
    noise = rng.integers(-(1 << 31), 1 << 31, (2, n))
    buf = io.BytesIO()
    write_wav(buf, noise, 44100, 32)
    wav = buf.getvalue()
    want = zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu")
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ((0.05, 0.1), (1.15, None)))
    deposit.reset_counts()
    assert zigflac_tpu_torch.encode_wav_bytes(wav, device="cuda") == want
    assert deposit.GLOBAL_ROW_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0


def test_capacity_ladder_on_card(rng, monkeypatch):
    """Tier 0 and tier 1 overflow, so the batch re-encodes on the exact
    words path; the bytes do not change."""
    wav = _wav(rng, 3 * 4096 + 99, depth=16)
    want = zigflac_tpu_torch.encode_wav_bytes(wav, device="cuda")
    monkeypatch.setattr(pipeline, "CAPACITY_LADDER", ((0.05, 0.1), (0.1, 0.2)))
    assert zigflac_tpu_torch.encode_wav_bytes(wav, device="cuda") == want


def test_stage_marks_on_card(rng, monkeypatch):
    """An encode on the card with stage marks on records every stage of
    every batch, each a non-negative device time."""
    from zigflac_tpu_torch.utils import stages

    monkeypatch.setattr(stages, "EVENTS", [])
    zigflac_tpu_torch.encode_wav_bytes(_wav(rng, 2 * 4096 + 99), device="cuda")
    torch.cuda.synchronize()
    got = stages.batch_ms(stages.EVENTS)
    assert len(got) == 2  # one batch of full frames, then the tail
    for b in got:
        assert list(b) == ["analysis", "symbols", "deposit", "crc", "compaction"]
        assert all(v >= 0 for v in b.values())


def test_encode_files_on_card_equals_cpu(rng, tmp_path):
    """A 3-file directory in two format groups (16-bit stereo with a
    ragged and a short tail, 24-bit mono), fused on the card."""
    specs = [(5 * 1024 + 33, 2, 16), (2 * 1024 + 1, 1, 24), (700, 2, 16)]
    for i, (n, channels, depth) in enumerate(specs):
        (tmp_path / f"t{i}.wav").write_bytes(_wav(rng, n, channels, depth))
    ins = [str(tmp_path / f"t{i}.wav") for i in range(3)]
    outs = [str(tmp_path / f"t{i}.flac") for i in range(3)]
    refs = [str(tmp_path / f"t{i}.cpu.flac") for i in range(3)]
    cfg = EncoderConfig(block_size=1024)
    deposit.reset_counts()
    zigflac_tpu_torch.encode_files(ins, outs, config=cfg, device="cuda", frames_per_chunk=4)
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    zigflac_tpu_torch.encode_files(ins, refs, config=cfg, device="cpu", frames_per_chunk=4)
    for o, r in zip(outs, refs):
        with open(o, "rb") as f, open(r, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("frames_per_chunk", [None, 3])
def test_encode_file_on_card_equals_in_memory(rng, tmp_path, frames_per_chunk):
    """encode_file in one batch, and the streaming path in chunks of 3
    frames with 2 batches in flight, with tags, SEEKTABLE and PADDING."""
    wav = _wav(rng, 7 * 4096 + 555)
    path, out = tmp_path / "in.wav", tmp_path / "o.flac"
    path.write_bytes(wav)
    kw = dict(tags=[("TITLE", "card")], seek_interval=8192, padding=128)
    deposit.reset_counts()
    if frames_per_chunk is None:
        zigflac_tpu_torch.encode_file(str(path), str(out), device="cuda", **kw)
    else:
        zigflac_tpu_torch.encode_file_streaming(str(path), str(out), device="cuda",
                                                frames_per_chunk=frames_per_chunk, **kw)
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    assert out.read_bytes() == zigflac_tpu_torch.encode_wav_bytes(wav, device="cuda", **kw)


@pytest.mark.parametrize("ogg", [False, True])
def test_cli_on_card_equals_cpu(rng, tmp_path, ogg):
    from zigflac_tpu_torch import cli

    path = tmp_path / "in.wav"
    path.write_bytes(_wav(rng, 3 * 4096 + 17))
    flags = ["--tag", "TITLE=card", "--seek-interval", "0.1"] + (["--ogg"] if ogg else [])
    deposit.reset_counts()
    assert cli.main([str(path), str(tmp_path / "gpu.flac"), "--device", "cuda", *flags]) == 0
    assert deposit.KERNEL_LAUNCHES > 0 and deposit.PLAIN_CALLS == 0
    assert cli.main([str(path), str(tmp_path / "cpu.flac"), "--device", "cpu", *flags]) == 0
    got = (tmp_path / "gpu.flac").read_bytes()
    assert got == (tmp_path / "cpu.flac").read_bytes()
    assert got[:4] == (b"OggS" if ogg else b"fLaC")


def _subframes(rng, m, b, max_order=32, bits=33, wrap=False):
    """Random normalized subframes: orders 0..max_order with coefficients
    zero beyond the order, shifts 0-15, wasted 0-3; ``wrap`` takes values
    and coefficients of 62 bits, so the sums pass 2^63."""
    order = rng.integers(0, max_order + 1, m)
    qbits = 62 if wrap else 15
    q = rng.integers(-(1 << (qbits - 1)), 1 << (qbits - 1), (m, 32))
    q[np.arange(32)[None, :] >= order[:, None]] = 0
    vbits = 62 if wrap else bits
    values = rng.integers(-(1 << (vbits - 1)), 1 << (vbits - 1), (m, b))
    return values, q, rng.integers(0, 16, m), order, rng.integers(0, 4, m)


@pytest.mark.parametrize(
    "m,b,kw",
    [
        (1024, 4096, dict(max_order=4)),   # a batch of fixed predictors
        (1024, 4096, dict(max_order=8)),   # LPC order 8
        (100, 4096, dict()),               # orders up to 32
        (3001, 257, dict()),               # M not a multiple of the warp
        (1, 4096, dict()),
        (37, 1, dict()),                   # a one-sample tail
        (5, 65535, dict()),                # the format's largest block
        (64, 1000, dict(wrap=True)),       # sums past 2^63 wrap as int64
        (40, 31, dict()),                  # one ragged tile
        (40, 32, dict()),                  # one whole tile
        (40, 33, dict()),                  # a tile and one position
    ],
)
def test_synth_kernel_matches_plain(rng, m, b, kw):
    args = [torch.from_numpy(a).cuda() for a in _subframes(rng, m, b, **kw)]
    synth.reset_counts()
    got = synth.synthesize_batch(*args)
    assert (synth.KERNEL_LAUNCHES, synth.PLAIN_CALLS) == (1, 0)
    torch.testing.assert_close(got, synth.synthesize_batch_plain(*args), rtol=0, atol=0)


def _quiet(rng, m, b, order, shift=12, wasted=0):
    """m stable subframes of one order: 16-bit values, coefficients whose
    magnitudes sum to under 2^shift with the last one non-zero, so every
    sample stays far inside int32."""
    q = np.zeros((m, 32), np.int64)
    if order:
        q[:, :order] = rng.integers(-100, 101, (m, order))
        q[:, order - 1] = rng.choice([-7, 9], m)
    values = rng.integers(-(1 << 15), 1 << 15, (m, b))
    return [values, q, np.full(m, shift), np.full(m, min(order, b)), np.full(m, wasted)]


def _fixed(rng, m, b, max_order=4):
    """Fixed predictors as a stream's batch has them: orders 0-max_order
    mixed (row 0 has the largest), binomial coefficients, shift 0, and as
    values the order-th differences of a 15-bit signal."""
    binomial = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]
    order = rng.integers(0, max_order + 1, m)
    order[0] = max_order
    q = np.zeros((m, 32), np.int64)
    values = rng.integers(-(1 << 14), 1 << 14, (m, b))
    for i in range(m):
        o = min(int(order[i]), b)
        q[i, :o] = binomial[o]
        values[i, o:] = np.diff(values[i], n=o)
    return [values, q, np.zeros(m, np.int64), np.minimum(order, b), np.zeros(m, np.int64)]


NARROW, WIDE = 0, 1


def _kernel_with_report(monkeypatch, arrays):
    """Kernel == plain on the card; returns the launch's variant report,
    [taps, ended wide, tile at which it went wide or -1] per block of 32
    subframes."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    monkeypatch.setattr(synth, "STATS", {})
    synth.reset_counts()
    got = synth.synthesize_batch(*args)
    assert (synth.KERNEL_LAUNCHES, synth.PLAIN_CALLS) == (1, 0)
    torch.testing.assert_close(got, synth.synthesize_batch_plain(*args), rtol=0, atol=0)
    (report,) = synth.STATS["variants"]
    return report.cpu().tolist()


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 23, 24, 25, 31, 32])
def test_synth_kernel_every_tap_count(rng, monkeypatch, order):
    """Orders just below, at and above each compiled tap count run the
    smallest count that covers them, in the int32 arithmetic."""
    report = _kernel_with_report(monkeypatch, _quiet(rng, 33, 100, order))
    want = order if order <= 4 else 8 if order <= 8 else 16 if order <= 16 else \
        24 if order <= 24 else 32
    assert report == [[want, NARROW, -1]] * 2


@pytest.mark.parametrize("coeff,start", [
    ((1 << 31) - 1, NARROW), (-(1 << 31), NARROW), (1 << 31, WIDE), (-(1 << 31) - 1, WIDE),
    (-(1 << 62), WIDE)])
def test_synth_kernel_coefficient_width(rng, monkeypatch, coeff, start):
    """A block starts in int32 arithmetic exactly if all its coefficients fit."""
    values, q, shift, order, wasted = _quiet(rng, 64, 80, 2, shift=31)
    q[36, 0], q[36, 1] = coeff, 1
    values[36] = rng.integers(-3, 4, 80)
    report = _kernel_with_report(monkeypatch, (values, q, shift, order, wasted))
    assert report == [[2, NARROW, -1], [2, start, 0 if start == WIDE else -1]]


@pytest.mark.parametrize("b,at", [(100, 0), (100, 5), (200, 32 * 3 + 17), (200, 32 * 3 + 31),
                                  (200, 32 * 4), (110, 32 * 3 + 9), (4096, 4000)],
                         ids=["first_sample", "first_tile", "mid_tile", "tile_end",
                              "tile_start", "ragged_tile", "late"])
@pytest.mark.parametrize("back", [False, True], ids=["stays_out", "comes_back"])
def test_synth_kernel_sample_leaves_int32(rng, monkeypatch, b, at, back):
    """A running sum that steps to 2^31 at ``at`` (and back below it three
    positions on) takes its block wide in that tile, and no other block."""
    values, q, shift, order, wasted = _quiet(rng, 64, b, 2)
    values[7] = 0
    values[7, at] = 1 << 31
    if back and at + 3 < b:
        values[7, at + 3] = -(1 << 31) - 5
    q[7] = 0
    q[7, 0], shift[7], order[7] = 1, 0, min(1, at)
    report = _kernel_with_report(monkeypatch, (values, q, shift, order, wasted))
    assert report == [[2, WIDE, at // 32], [2, NARROW, -1]]


@pytest.mark.parametrize("max_order", [1, 2, 3, 4])
@pytest.mark.parametrize("at", [None, 3, 40, 95, 130], ids=lambda at: f"leaves_at_{at}")
def test_synth_kernel_fixed_predictors(rng, monkeypatch, max_order, at):
    """Blocks whose shifts are all 0 (the 32-bit multiply-add for the low
    word), quiet and with a row whose value at ``at`` is 2^32 too large."""
    values, q, shift, order, wasted = _fixed(rng, 40, 140, max_order)
    if at is not None:
        values[5, at] += 1 << 32
    report = _kernel_with_report(monkeypatch, (values, q, shift, order, wasted))
    want = [max_order, NARROW, -1] if at is None else [max_order, WIDE, at // 32]
    assert report == [want, [int(order[32:].max()), NARROW, -1]]


@pytest.mark.parametrize("value", [(1 << 31) - 1, -(1 << 31), 1 << 31, -(1 << 32)])
def test_synth_kernel_int32_edge_values(rng, monkeypatch, value):
    values, q, shift, order, wasted = _quiet(rng, 5, 70, 4)
    values[2, 40] = value
    q[2], order[2] = 0, 0  # verbatim: the sample is the value
    report = _kernel_with_report(monkeypatch, (values, q, shift, order, wasted))
    fits = -(1 << 31) <= value < (1 << 31)
    assert report == [[4, NARROW, -1] if fits else [4, WIDE, 1]]


def test_synth_kernel_copies_order_0_with_wasted_bits(rng, monkeypatch):
    args = _quiet(rng, 6, 65, 0, wasted=7)
    args[0][0] = 1234  # a constant subframe
    assert _kernel_with_report(monkeypatch, args) == [[0, NARROW, -1]]


@pytest.mark.parametrize("row", [17, 37])
def test_synth_kernel_ragged_last_block(rng, monkeypatch, row):
    """40 subframes are a block of 32 and one of 8: a row that leaves int32
    takes only its own block wide."""
    values, q, shift, order, wasted = _quiet(rng, 40, 100, 8)
    values[row, 50] = 1 << 33
    report = _kernel_with_report(monkeypatch, (values, q, shift, order, wasted))
    want = [[8, NARROW, -1], [8, NARROW, -1]]
    want[row // 32] = [8, WIDE, 1]
    assert report == want


def test_synth_kernel_records_nothing_by_default(rng):
    assert synth.STATS is None
    args = [torch.from_numpy(a).cuda() for a in _subframes(rng, 4, 64)]
    synth.synthesize_batch(*args)
    assert synth.STATS is None


def test_synth_kernel_refuses_what_it_does_not_take(rng):
    v, q, sh, o, w = [torch.from_numpy(a).cuda() for a in _subframes(rng, 4, 64)]
    with pytest.raises(TypeError):
        synth.synthesize_batch(v.to(torch.int32), q, sh, o, w)
    with pytest.raises(ValueError):
        synth.synthesize_batch(v.t().contiguous().t(), q, sh, o, w)
    with pytest.raises(ValueError):
        synth.synthesize_batch(v, q, sh + 64, o, w)
    with pytest.raises(ValueError):
        synth.synthesize_batch(v, q.cpu(), sh, o, w)


@pytest.mark.parametrize("depth,fields", [(16, dict()), (24, dict(prediction="lpc")),
                                          (32, dict(prediction="lpc", wasted_bits=True))],
                         ids=["fixed16", "lpc24", "lpc32"])
def test_decode_on_card_equals_cpu(rng, depth, fields):
    from zigflac_tpu_torch import decoder
    from zigflac_tpu_torch.wav import WavReader

    wav = _wav(rng, 3 * 4096 + 777, 2, depth)
    flac = zigflac_tpu_torch.encode_wav_bytes(wav, config=EncoderConfig(**fields), device="cuda")
    synth.reset_counts()
    got = decoder.decode_flac(flac, device="cuda")
    assert synth.KERNEL_LAUNCHES == 2 and synth.PLAIN_CALLS == 0  # full frames, then the tail
    want = decoder.decode_flac(flac, device="cpu")
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.samples, WavReader.from_bytes(wav).planar_samples())
    assert got.md5_ok and want.md5_ok and got.frame_count == want.frame_count == 4
    assert decoder.verify_flac(flac, device="cuda")
    np.testing.assert_array_equal(
        decoder.decode_range(flac, 4000, 5000, device="cuda"), want.samples[:, 4000:9000])


def test_decode_cli_on_card(rng, tmp_path):
    from zigflac_tpu_torch import cli

    wav, flac, back = tmp_path / "in.wav", tmp_path / "a.flac", tmp_path / "back.wav"
    wav.write_bytes(_wav(rng, 2 * 4096 + 17))
    assert cli.main([str(wav), str(flac), "--device", "cuda", "--verify"]) == 0
    synth.reset_counts()
    assert cli.main(["-d", str(flac), str(back), "--device", "cuda", "--verify"]) == 0
    assert synth.KERNEL_LAUNCHES > 0 and synth.PLAIN_CALLS == 0
    assert back.read_bytes() == wav.read_bytes()
    assert cli.main(["-t", str(flac), "--device", "cuda"]) == 0
    bad = bytearray(flac.read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    (tmp_path / "bad.flac").write_bytes(bytes(bad))
    assert cli.main(["-t", str(tmp_path / "bad.flac"), "--device", "cuda"]) == 2


def test_decoder_synthesis_call_does_not_synchronize(rng, monkeypatch):
    """The decoder's synthesis call (range checked on the host) runs under
    torch.cuda.set_sync_debug_mode("error"): it never waits for the card.
    Public synthesize_batch keeps its range check and its ValueError."""
    from zigflac_tpu_torch import decoder

    wav = _wav(rng, 2 * 4096 + 33)
    flac = zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu")
    real, calls = synth._synthesize_unchecked, []

    def strict(*args):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(synth, "_synthesize_unchecked", strict)
    decoder.decode_flac(flac, device="cuda")  # the kernel built and loaded
    got = decoder.decode_flac(flac, device="cuda")
    assert got.md5_ok and len(calls) == 4
    args = [torch.zeros((2, 8), dtype=torch.int64, device="cuda"),
            torch.zeros((2, 32), dtype=torch.int64, device="cuda"),
            torch.tensor([0, 64], device="cuda"), torch.zeros(2, dtype=torch.int64, device="cuda"),
            torch.zeros(2, dtype=torch.int64, device="cuda")]
    with pytest.raises(ValueError, match="0..63"):
        synth.synthesize_batch(*args)


@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("fields", [dict(), dict(prediction="lpc")], ids=["fixed", "lpc"])
def test_sharded_on_one_card_equals_single(rng, ndev, fields):
    """A mesh of the one card repeated: every full batch launches the
    deposit kernel once a shard, and the bytes equal the CPU's single
    device, with a ragged last batch whose noisy first shard alone
    re-encodes through the capacity ladder."""
    from zigflac_tpu_torch.metadata import StreamInfo
    from zigflac_tpu_torch.parallel.mesh import default_mesh

    B, bs = 1024, 4 * ndev
    nf = 2 * bs + ndev + 1  # two full batches, then ndev + 1 frames: 2 a shard
    t = np.arange(nf * B)
    x = 0.3 * 32767 * np.sin(2 * np.pi * 440 * t / 44100) + rng.normal(0, 256, (2, nf * B))
    frames = np.round(x).astype(np.int32).reshape(2, nf, B).transpose(1, 0, 2).copy()
    frames[2 * bs : 2 * bs + 2] = rng.integers(-(1 << 15), 1 << 15, (2, 2, B))
    info = StreamInfo(44100, 2, 16, nf * B, B, B)
    cfg = EncoderConfig(block_size=B, **fields)
    sharded = pipeline.DevicePipeline(cfg, 16, "cuda", batch_size=bs,
                                      mesh=default_mesh([torch.device("cuda", 0)] * ndev))
    deposit.reset_counts()
    got = sharded.encode_frames_stream(frames, 0, info)
    torch.cuda.synchronize()
    # full batches, the ragged batch's shards with a real frame, the ladder
    assert deposit.KERNEL_LAUNCHES == 2 * ndev + (ndev + 2) // 2 + 1
    assert deposit.PLAIN_CALLS == 0
    want = pipeline.DevicePipeline(cfg, 16, "cpu", batch_size=bs).encode_frames_stream(
        frames, 0, info)
    assert got[0] == want[0] and got[1].tolist() == want[1].tolist()


# -- the analysis and CRC-16 kernels ---------------------------------------------------


def _analysis_planes(rng, p, b, depth):
    """Planes of every kind the encoder meets: noise, a tone with noise,
    constant, alternating full scale, quiet +-1."""
    lim = 1 << (depth - 1)
    t = np.arange(b)
    tone = 0.4 * lim * np.sin(2 * np.pi * 440 * t / 44100)
    rows = [rng.integers(-lim, lim, b), np.round(tone + rng.normal(0, lim >> 8, b)),
            np.full(b, lim // 3), np.where(t % 2 == 0, lim - 1, -lim), rng.integers(-1, 2, b)]
    x = np.stack([rows[i % len(rows)] for i in range(p)])
    return np.clip(x, -lim, lim - 1).astype(np.int64 if depth > 32 else np.int32)


def _assert_fixed_equal(planes, wide, max_rice_order, max_param):
    from zigflac_tpu_torch.ops import analyze

    x = torch.from_numpy(planes).cuda()
    analyze.reset_counts()
    got = analyze.analyze_fixed(x, wide, max_rice_order, max_param)
    assert (analyze.KERNEL_LAUNCHES, analyze.PLAIN_CALLS) == (1, 0)
    want = analyze.analyze_fixed_plain(x, wide, max_rice_order, max_param)
    for name in analyze.FixedAnalysis._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    return got


@pytest.mark.parametrize("depth,b,max_rice_order,max_param", [
    (8, 4096, 8, 14), (16, 4096, 8, 14), (24, 4096, 8, 30), (28, 4096, 8, 30),
    (32, 4096, 8, 30), (33, 4096, 8, 30), (16, 1, 8, 14), (16, 5, 8, 14), (16, 17, 8, 14),
    (16, 1972, 8, 14), (16, 4608, 8, 14), (16, 65535, 8, 14), (16, 512, 0, 14),
    (16, 4096, 15, 30), (24, 32768, 15, 30)])
def test_analysis_kernel_matches_plain(rng, depth, b, max_rice_order, max_param):
    """zf_analyze_fixed == the plain order search, residual and Rice
    estimate, every field; depth 33 is the int64 side plane, from 28 on the
    search is wide. max_rice_order 15 at B = 4096 and 32768 (partition
    orders 12 and 15) is refused as the JAX package refuses it: ValueError
    before any launch."""
    from zigflac_tpu_torch.ops import analyze

    p = 2 if b >= 32768 else 11
    planes = _analysis_planes(rng, p, b, depth)
    if min(max_rice_order, (b & -b).bit_length() - 1) > 8:
        x = torch.from_numpy(planes).cuda()
        analyze.reset_counts()
        with pytest.raises(ValueError, match="partition order"):
            analyze.analyze_fixed(x, depth >= 28, max_rice_order, max_param)
        assert (analyze.KERNEL_LAUNCHES, analyze.PLAIN_CALLS) == (0, 0)
        return
    _assert_fixed_equal(planes, depth >= 28, max_rice_order, max_param)


@pytest.mark.parametrize("k", range(5))
def test_analysis_kernel_wide_disqualification(rng, k):
    """Alternating +-A with 2^k A just past 2^31 - 1: orders k..4 are out;
    at k = 0 no order is usable."""
    a = -(-(1 << 31) // (1 << k))
    alt = np.where(np.arange(300) % 2 == 0, a, -a).astype(np.int64)
    got = _assert_fixed_equal(np.stack([alt, alt + 1, np.full(300, 1 << 32)]), True, 8, 30)
    assert got.ok.tolist() == [k > 0, k > 0, True]


def test_rice_kernel_matches_plain(rng):
    """zf_rice_estimate == rice_estimate for orders 0-32 (partitions shorter
    than the order at B = 256), quiet rows and full-range residuals, blocks
    not a multiple of 4 or 16 (66, 1972, 4098: the runs' word loads),
    partitions shorter than a run (66 at order 1), several tiles (4098,
    65535), and rows that do not start on 16 bytes; at max_rice_order 15 and
    B = 4096 both refuse (ValueError, no launch)."""
    from zigflac_tpu_torch.ops import analyze

    for b, max_rice_order in ((4096, 8), (256, 8), (4608, 6), (66, 8), (1972, 8), (4098, 8),
                              (65535, 8), (4096, 15)):
        if b == 4096 and max_rice_order == 15:
            res = torch.zeros((4, b), dtype=torch.int32, device="cuda")
            order = torch.zeros(4, dtype=torch.int64, device="cuda")
            analyze.reset_counts()
            for call in (lambda: analyze.rice_estimate_planes(res, order, 15, 30),
                         lambda: analyze.rice_estimate(res, order, b, 15, 30)):
                with pytest.raises(ValueError, match="partition order"):
                    call()
            assert (analyze.RICE_KERNEL_LAUNCHES, analyze.PLAIN_CALLS) == (0, 0)
            continue
        order = np.arange(33).repeat(2)
        res = rng.integers(-3000, 3000, (order.size, b)).astype(np.int32)
        res[np.arange(b)[None, :] < order[:, None]] = 0
        res[1::4] >>= 10
        res[3::4] = rng.integers(-(1 << 31), 1 << 31, (res[3::4].shape)).astype(np.int32)
        flat = torch.from_numpy(np.concatenate([[7], res.reshape(-1)]).astype(np.int32)).cuda()
        o = torch.from_numpy(order).cuda()
        for r in (torch.from_numpy(res).cuda(), flat[1:].view(order.size, b)):
            for max_param in (14, 30):
                analyze.reset_counts()
                got = analyze.rice_estimate_planes(r, o, max_rice_order, max_param)
                assert (analyze.RICE_KERNEL_LAUNCHES, analyze.PLAIN_CALLS) == (1, 0)
                want = analyze.rice_estimate(r, o, b, max_rice_order, max_param)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (b, max_param)


@pytest.mark.parametrize("lim", [(1 << 23) - 1, 1 << 23])
def test_analysis_kernel_narrow_limit(rng, lim):
    """Planes whose largest |x| is the narrow arithmetic's limit (every warp
    narrow) and one past it (the warps holding it go 64-bit), plain and wide
    mode."""
    t = np.arange(4096)
    noise = rng.integers(-lim + 1, lim, 4096)
    noise[700] = -lim
    planes = np.stack([np.where(t % 2 == 0, lim, -lim), np.full(4096, -lim), noise])
    for wide in (False, True):
        _assert_fixed_equal(planes.astype(np.int32), wide, 8, 30)


@pytest.mark.parametrize("b,max_rice_order", [
    (4096, 4), (8192, 8), (256, 8), (64, 8), (1152, 8), (2304, 12), (4608, 8), (1972, 8)])
def test_analysis_kernel_partitions_against_runs(rng, b, max_rice_order):
    """Top partitions of one 16-sample run, of whole runs (a segmented sum
    across lanes, across warps at 4096 / order 4, two tiles at 8192), shorter
    than a run (256, 64, 1152, 2304 at order 8) and neither (4608, 1972);
    max_rice_order 12 at 2304 (ctz 8) is legal."""
    planes = np.concatenate([_analysis_planes(rng, 5, b, 16), _analysis_planes(rng, 3, b, 24)])
    _assert_fixed_equal(planes, False, max_rice_order, 30)


def test_encode_refuses_partition_order_above_8_before_the_card(rng):
    """max_rice_order 12 at block 4096 (partition order 12): ValueError, as
    the JAX package raises, and no kernel launched; at block 1152 (order 7)
    the card's bytes equal the CPU's."""
    from zigflac_tpu_torch.ops import analyze

    wav = _wav(rng, 3 * 4096 + 100)
    analyze.reset_counts()
    deposit.reset_counts()
    with pytest.raises(ValueError, match="partition order 12"):
        zigflac_tpu_torch.encode_wav_bytes(
            wav, config=EncoderConfig(block_size=4096, max_rice_order=12), device="cuda")
    assert (analyze.KERNEL_LAUNCHES, deposit.KERNEL_LAUNCHES) == (0, 0)
    cfg = EncoderConfig(block_size=1152, max_rice_order=12)
    assert zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda") == \
        zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


def test_crc_kernel_matches_plain(rng):
    """zf_crc16_frames == crc16_words + deposit_crc16: random rows of lengths
    0-20 (every residue mod 4 and 16), about a round of the frame's lanes
    and about the row's end, frames over the row, rows of one to three
    words, rows that do not start on 16 bytes (the word branch), and both
    write modes."""
    from zigflac_tpu_torch.ops import crc16

    for w, offset in ((1, 0), (2, 0), (3, 0), (37, 0), (5504, 0), (5504, 1), (18432, 0),
                      (18432, 3)):
        lens = np.array(sorted({*range(21), 1023, 1024, 1025, 4095, 4096, 4097, 4 * w - 2,
                                4 * w - 1, 4 * w, 4 * w + 9}))
        be = rng.integers(0, 256, (lens.size, 4 * w), dtype=np.uint8)
        be[np.arange(4 * w)[None, :] >= lens[:, None]] = 0
        rows = be.view(">i4").astype(np.int32)
        flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32),
                                                rows.reshape(-1)])).cuda()
        words = flat[offset:].view(lens.size, w)
        byte_len = torch.from_numpy(lens).cuda()
        want = crc16.crc16_frames_plain(words, byte_len)
        crc16.reset_counts()
        crcs_ro, same = crc16.crc16_frames(words, byte_len, write=False)
        assert same is words and torch.equal(crcs_ro, want[0])
        crcs, out = crc16.crc16_frames(words, byte_len)
        assert out is words  # in place
        assert (crc16.KERNEL_LAUNCHES, crc16.PLAIN_CALLS) == (2, 0)
        assert torch.equal(crcs, want[0]) and torch.equal(out, want[1]), (w, offset)


def test_kernels_refuse_what_they_do_not_take(rng):
    from zigflac_tpu_torch.ops import analyze, crc16

    x = torch.zeros((64, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        analyze.analyze_fixed(x.t(), False, 8, 14)
    with pytest.raises(ValueError, match="is on"):
        analyze.rice_estimate_planes(x, torch.zeros(64, dtype=torch.int64), 8, 14)
    with pytest.raises(ValueError, match="contiguous"):
        crc16.crc16_frames(x.t(), torch.zeros(3, dtype=torch.int64, device="cuda"))


def test_encode_on_card_launches_every_kernel(rng):
    """An encode on the card goes through the analysis, symbols, deposit and
    CRC kernels, and an LPC encode through the Rice kernel, with no plain
    version called; the tail too."""
    from zigflac_tpu_torch.ops import analyze, crc16, symbols

    wav = _wav(rng, 2 * 4096 + 1972)
    for cfg, rice in ((EncoderConfig(), 0), (EncoderConfig(prediction="lpc"), 2)):
        for m in (analyze, crc16, deposit, symbols):
            m.reset_counts()
        got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
        counts = (analyze.KERNEL_LAUNCHES, analyze.RICE_KERNEL_LAUNCHES, crc16.KERNEL_LAUNCHES,
                  deposit.KERNEL_LAUNCHES, symbols.KERNEL_LAUNCHES)
        assert counts == (2, rice, 2, 2, 2)
        assert (analyze.PLAIN_CALLS == crc16.PLAIN_CALLS == deposit.PLAIN_CALLS
                == symbols.PLAIN_CALLS == 0)
        assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


@pytest.mark.parametrize("depth", range(4, 33))
def test_unpack_kernel_matches_plain(rng, depth):
    """zf_unpack_pcm == the plain version at every depth (its container of
    (depth + 7) // 8 bytes, 1-8 channels): a bucket with rows past nreal,
    a one-sample tail row and a 4095-sample one."""
    nb, c = (depth + 7) // 8, 1 + depth % 8
    data = torch.from_numpy(rng.integers(0, 256, 6 * 4095 * c * nb, dtype=np.uint8)).cuda()
    for block, nreal, n in ((4095, 6, 8), (1, 1, 1), (4095, 1, 1), (300, 3, 3)):
        unpack.reset_counts()
        got = unpack.unpack_pcm(data, c, nb, depth, block, nreal, n)
        assert (unpack.KERNEL_LAUNCHES, unpack.PLAIN_CALLS) == (1, 0)
        torch.cuda.synchronize()
        assert torch.equal(got, unpack.unpack_pcm_plain(data, c, nb, depth, block, nreal, n))


def test_unpack_kernel_refuses_without_launching(rng):
    data = torch.zeros(64, dtype=torch.uint8, device="cuda")
    unpack.reset_counts()
    with pytest.raises(ValueError):
        unpack.unpack_pcm(data, 2, 2, 16, 32, 1, 1)  # 64 bytes hold 16 frames
    with pytest.raises(TypeError):
        unpack.unpack_pcm(data.view(torch.int8), 2, 2, 16, 4, 1, 1)
    assert unpack.KERNEL_LAUNCHES == 0


@pytest.mark.parametrize("depth,fields", [(16, dict()), (24, dict(prediction="lpc"))])
def test_card_fed_encode_spans_and_counts(rng, depth, fields):
    """encode_wav_bytes on the card takes the card-fed route: the CPU
    device's bytes, one unpack a dispatch, every encoded row from the
    unpack, no ``wav.planar_samples`` or ``wav.raw_copy`` span, and the
    layers' spans add up to the call."""
    from zigflac_tpu_torch.utils import stages

    wav = _wav(rng, 3 * 4096 + 1234, 2, depth)
    cfg = EncoderConfig(**fields)
    unpack.reset_counts()
    stages.SPANS, stages.COUNTS = [], {}
    try:
        got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda:0")
        t, c = stages.totals(), dict(stages.COUNTS)
        launches, plain = unpack.KERNEL_LAUNCHES, unpack.PLAIN_CALLS
    finally:
        stages.SPANS = stages.COUNTS = None
    # the CPU device takes the same route, through the plain unpack
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")
    assert "wav.planar_samples" not in t and "wav.raw_copy" not in t
    assert launches == t["pipeline.dispatch_batch"][0] + t["pipeline.dispatch_tail"][0] == 2
    assert plain == 0
    assert c["pipeline.frames_unpacked"] == c["pipeline.frames_encoded"] >= 5
    parts = sum(t[n][1] for n in ("wav.parse", "session.setup", "session.md5", "session.finish",
                                  "pipeline.h2d", "pipeline.wait", "pipeline.d2h",
                                  "pipeline.assemble", "pipeline.join") if n in t)
    parts += sum(t[n][2] for n in ("pipeline.dispatch_batch", "pipeline.dispatch_tail",
                                   "pipeline.collect_batch", "encode.call") if n in t)
    assert parts == pytest.approx(t["encode.call"][1], rel=1e-9)


@pytest.mark.parametrize("depth", [16, 24])
def test_card_fed_streaminfo_md5_is_the_pcm_md5(rng, depth):
    """On the card-fed route (every encoded row from the unpack kernel) the
    worker's STREAMINFO MD5 is the MD5 of the WAV's PCM bytes, and the
    stream is the CPU device's, byte for byte."""
    import hashlib

    from zigflac_tpu_torch.utils import stages
    from zigflac_tpu_torch.wav import WavReader

    wav = _wav(rng, 5 * 4096 + 777, 2, depth)
    unpack.reset_counts()
    stages.SPANS, stages.COUNTS = [], {}
    try:
        got = zigflac_tpu_torch.encode_wav_bytes(wav, device="cuda:0")
        c = dict(stages.COUNTS)
    finally:
        stages.SPANS = stages.COUNTS = None
    assert unpack.KERNEL_LAUNCHES > 0 and unpack.PLAIN_CALLS == 0
    assert c["pipeline.frames_unpacked"] == c["pipeline.frames_encoded"] > 0
    assert got[26:42] == hashlib.md5(WavReader.from_bytes(wav).raw_pcm_bytes()).digest()
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, device="cpu")


def test_card_fed_staging_and_unpack_do_not_synchronize(rng):
    """The card-fed dispatch's own steps, the pinned copy and the unpack,
    never wait for the card once the pinned pool holds a block of the
    batch's size; the frames equal the host de-interleave's."""
    from zigflac_tpu_torch.wav import WavReader

    r = WavReader.from_bytes(_wav(rng, 8 * 4096, 2, 16))
    pipe = pipeline.DevicePipeline(EncoderConfig(), 16, "cuda:0")
    pcm = r.raw_pcm_bytes()
    pipe._stage_pcm(pcm)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = unpack.unpack_pcm(pipe._stage_pcm(pcm), 2, 2, 16, 4096, 8, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = r.planar_samples().reshape(2, 8, 4096).transpose(1, 0, 2)
    assert np.array_equal(frames.cpu().numpy(), want)


def test_plan_frames_on_card_does_not_synchronize(rng):
    """The analysis of a batch (plan_frames with the kernel) never waits for
    the card: it runs under torch.cuda.set_sync_debug_mode("error")."""
    from zigflac_tpu_torch.ops import analyze

    frames = torch.from_numpy(_analysis_planes(rng, 2 * 16, 4096, 16).reshape(16, 2, 4096))
    frames = frames.cuda()
    analyze.plan_frames(frames, 16, EncoderConfig())  # the kernel built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = analyze.plan_frames(frames, 16, EncoderConfig())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = analyze.plan_frames(frames.cpu(), 16, EncoderConfig())
    for name in analyze.FrameWirePlan._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


FLAC8 = dict(prediction="lpc", max_rice_order=6, lpc_order=12, lpc_precision=12,
             apodization=("tukey(5e-1)", "partial_tukey(2)", "punchout_tukey(3)"))


@pytest.mark.parametrize("fields", [dict(prediction="lpc", lpc_precision=15), FLAC8],
                         ids=["one-window", "flac-8"])
def test_lpc_search_on_card_does_not_synchronize(rng, fields):
    """The LPC analysis of a batch, one window or six, with the search's
    device interval and window tally armed, never waits for the card, and
    decides what the CPU decides."""
    from zigflac_tpu_torch.ops import analyze
    from zigflac_tpu_torch.utils import stages

    cfg = EncoderConfig(**fields)
    frames = torch.from_numpy(_analysis_planes(rng, 2 * 16, 4096, 16).reshape(16, 2, 4096))
    frames = frames.cuda()
    analyze.plan_frames(frames, 16, cfg)  # the kernels built and loaded
    torch.cuda.synchronize()
    stages.SEARCH, stages.WINDOW_WINS = [], {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = analyze.plan_frames(frames, 16, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        search, wins = stages.SEARCH, stages.WINDOW_WINS
        stages.SEARCH = stages.WINDOW_WINS = None
    want = analyze.plan_frames(frames.cpu(), 16, cfg)
    for name in analyze.FrameWirePlan._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.cuda.synchronize()
    assert len(search) == 1 and search[0][0].elapsed_time(search[0][1]) > 0
    assert len(wins) == (1 if fields is FLAC8 else 0)
    for tally in wins.values():
        assert tally.device.type == "cuda" and tally.shape == (6,)


def test_window_list_on_card_equals_cpu(rng):
    """flac -8's six windows at order 12, 12-bit coefficients, through
    encode_wav_bytes on the card (the card-fed route): the CPU's bytes, and
    the card's decoder gives the samples back with the MD5 checked."""
    wav = _wav(rng, 3 * 4096 + 1000, 2, 16)
    cfg = EncoderConfig(**FLAC8)
    got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")
    synth.reset_counts()
    back = zigflac_tpu_torch.decode_flac(got, device="cuda")
    assert back.md5_ok and synth.KERNEL_LAUNCHES > 0
    assert np.array_equal(back.samples, zigflac_tpu_torch.decode_flac(got, device="cpu").samples)


# -- the lag sums kernel ----------------------------------------------------------------


@pytest.mark.parametrize("depth,wins,order,sample_bits", [
    (17, "tukey", 8, 17), (17, "flac8", 12, 17), (17, "flac8", 12, None), (24, "tukey", 8, 25),
    (17, "tukey", 32, 17), (33, "tukey", 8, 33), (17, "flac8", 32, None),
], ids=["config3", "flac8", "flac8-limbs", "hires", "order32", "side33", "flac8-order32"])
def test_lag_sums_kernel_matches_plain(rng, depth, wins, order, sample_bits):
    """zf_lag_sums == the plain lag_sums on the card at the main path's
    batch (4 x 1024 planes of 4096; the int64 side plane 1024 x 4096): one
    Tukey(0.5) or flac -8's six windows, orders 8, 12 and 32, in the narrow
    arithmetic and in the limbs; one launch a call, no plain call, the
    planes x windows counted."""
    from zigflac_tpu_torch.ops import lpc
    from zigflac_tpu_torch.utils import stages

    p = 1024 if depth > 32 else 4 * 1024
    shape = (p,) if depth > 32 else (4, 1024)
    x = torch.from_numpy(_analysis_planes(rng, p, 4096, depth)).cuda().view(*shape, 4096)
    ws = (TUKEY_HALF,) if wins == "tukey" else windows_of(EncoderConfig(**FLAC8))
    wt = lpc.windows_tensor(ws, 4096, x.device)
    lpc.reset_counts()
    stages.COUNTS = {}
    try:
        got = lpc.lag_sums_planes(x, order, wt, sample_bits)
    finally:
        counts, stages.COUNTS = stages.COUNTS, None
    assert (lpc.LAG_KERNEL_LAUNCHES, lpc.PLAIN_CALLS) == (1, 0)
    assert counts == {"lpc.lag_kernel_evals": p * len(ws)}
    want = lpc.lag_sums(x.unsqueeze(0), order,
                        wt.view((len(ws),) + (1,) * (x.dim() - 1) + (4096,)))
    assert got.shape == want.shape and torch.equal(got, want)


def test_lag_sums_kernel_refuses_without_launching(rng):
    from zigflac_tpu_torch.ops import lpc

    x = torch.zeros((3, 64), dtype=torch.int32, device="cuda")
    w = lpc.windows_tensor((TUKEY_HALF,), 64, x.device)
    lpc.reset_counts()
    for args, exc in (((x, 33, w), ValueError), ((x, 0, w), ValueError),
                      ((x, 8, w.long()), TypeError), ((x, 8, w.cpu()), ValueError),
                      ((x, 8, w.expand(33, 64).contiguous()), ValueError),
                      ((x.t().contiguous().t(), 8, w), ValueError),
                      ((torch.zeros((1, 65536), dtype=torch.int32, device="cuda"), 8,
                        torch.zeros((1, 65536), dtype=torch.int16, device="cuda")), ValueError)):
        with pytest.raises(exc):
            lpc.lag_sums_planes(*args)
    assert (lpc.LAG_KERNEL_LAUNCHES, lpc.PLAIN_CALLS) == (0, 0)


@pytest.mark.parametrize("fields", [dict(prediction="lpc"), FLAC8], ids=["config3", "flac-8"])
def test_lpc_encode_through_the_lag_kernel_equals_cpu(rng, fields):
    """An LPC encode on the card (config 3's settings: one Tukey(0.5) at
    order 8; flac -8's six windows at order 12) launches the lag sums kernel
    once an LPC analysis (the batch and the tail), for every plane and
    window the search counts, and writes the CPU path's bytes, which are
    the plain version's."""
    from zigflac_tpu_torch.ops import lpc
    from zigflac_tpu_torch.utils import stages

    wav = _wav(rng, 3 * 4096 + 1000, 2, 16)
    cfg = EncoderConfig(**fields)
    lpc.reset_counts()
    stages.COUNTS = {}
    try:
        got = zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cuda")
    finally:
        counts, stages.COUNTS = stages.COUNTS, None
    assert (lpc.LAG_KERNEL_LAUNCHES, lpc.PLAIN_CALLS) == (2, 0)
    assert counts["lpc.lag_kernel_evals"] == counts["lpc.window_evals"] > 0
    assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=cfg, device="cpu")


FILM = dict(FLAC8, channels=6, lpc_precision=15)


def test_film_batch_on_card_equals_cpu_through_global_rows(rng):
    """The film-5.1-48k-24bit settings (six independent 24-bit channels at
    48 kHz, flac -8's six windows at order 12, 15-bit coefficients) on the
    card: the CPU's bytes through the card-fed route, and every deposit
    launch's rows over the kernel's shared-memory row (the global-memory
    branch: ~95 KB a 4096-sample frame, ~70 KB the 3,000-sample tail's); a
    CD stereo encode takes that branch in no launch."""
    from zigflac_tpu_torch.utils import stages

    film = _wav(rng, 3 * 4096 + 3000, 6, 24, 48000)
    cd = _wav(rng, 3 * 4096 + 1000, 2, 16)
    cfg = EncoderConfig(**FILM)
    counts = []
    for wav, c in ((film, cfg), (cd, EncoderConfig())):
        deposit.reset_counts()
        stages.COUNTS = {}
        try:
            got = zigflac_tpu_torch.encode_wav_bytes(wav, config=c, device="cuda")
        finally:
            counts.append((deposit.KERNEL_LAUNCHES, deposit.GLOBAL_ROW_LAUNCHES, stages.COUNTS))
            stages.COUNTS = None
        assert got == zigflac_tpu_torch.encode_wav_bytes(wav, config=c, device="cpu")
    (film_k, film_g, film_c), (cd_k, cd_g, _) = counts
    assert film_g == film_k > 0
    assert film_c["pipeline.frames_unpacked"] == film_c["pipeline.frames_encoded"] > 0
    assert cd_k > 0 and cd_g == 0


# -- the frame symbols kernel ----------------------------------------------------------


def _smoke():
    """chip_smoke.py's symbols watch list and plan generator (it imports no
    jax)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def _symbols_case(smoke, case):
    from zigflac_tpu_torch.ops import analyze
    from zigflac_tpu_torch.ops.header import header_static

    n, w, b, mro, lpc_order, depth, side, wasted = case
    rng = np.random.default_rng(b * 31 + w * 7 + mro + lpc_order + depth)
    plan = analyze.FrameWirePlan(*(t.cuda() for t in smoke.synthetic_plan(
        rng, n, w, b, mro, lpc_order, depth, side, wasted)))
    fns = torch.tensor([smoke.SYMBOL_FRAME_NUMBERS[(i * 3) % len(smoke.SYMBOL_FRAME_NUMBERS)]
                        for i in range(n)], device="cuda")
    hs = header_static(b, smoke.SYMBOL_RATES[b % len(smoke.SYMBOL_RATES)], depth)
    return plan, fns, hs, b, mro, lpc_order, 15


@pytest.mark.parametrize("index", range(18))
def test_symbols_kernel_matches_plain(rng, index):
    """zf_frame_symbols == bitpack.frame_symbol_stream, every column, on the
    smoke's watch list (SYMBOL_WATCH); one launch, no plain call."""
    from zigflac_tpu_torch.ops import bitpack, symbols

    smoke = _smoke()
    assert len(smoke.SYMBOL_WATCH) == 18
    args = _symbols_case(smoke, smoke.SYMBOL_WATCH[index])
    symbols.reset_counts()
    got = symbols.frame_symbols(*args)
    assert (symbols.KERNEL_LAUNCHES, symbols.PLAIN_CALLS) == (1, 0)
    d, tb, v, nb = bitpack.frame_symbol_stream(*args)
    for g, w in zip(got, (d.to(torch.int32), tb, v, nb.to(torch.int32))):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("index", range(3))
def test_symbols_kernel_long_codes(rng, index):
    """Frames past 2^32 bits (the smoke's SYMBOL_LONG_CODES): two ~2^32-bit
    codes inside a warp's run, across two warps' runs and across two tiles,
    under 4-bit params with the N1 fallback; kernel == plain, every column."""
    from zigflac_tpu_torch.ops import analyze, bitpack, symbols
    from zigflac_tpu_torch.ops.header import header_static

    smoke = _smoke()
    assert len(smoke.SYMBOL_LONG_CODES) == 3
    b, at = smoke.SYMBOL_LONG_CODES[index]
    plan = analyze.FrameWirePlan(*(t.cuda() for t in smoke.long_code_plan(b, at)))
    args = (plan, torch.arange(16, device="cuda"), header_static(b, 44100, 16), b, 2, 0, 15)
    got = symbols.frame_symbols(*args)
    d, tb, v, nb = bitpack.frame_symbol_stream(*args)
    for g, w in zip(got, (d.to(torch.int32), tb, v, nb.to(torch.int32))):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[1].max()) >= 1 << 32


def test_symbols_kernel_does_not_synchronize(rng):
    """The wrapper reads shapes, not values: it runs under
    torch.cuda.set_sync_debug_mode("error")."""
    from zigflac_tpu_torch.ops import symbols

    args = _symbols_case(_smoke(), _smoke().SYMBOL_WATCH[0])
    symbols.frame_symbols(*args)  # the kernel built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        symbols.frame_symbols(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_symbols_kernel_raises_without_the_library(rng, monkeypatch):
    """A CUDA plan with no kernel library raises: no fall back to the plain
    version."""
    from zigflac_tpu_torch.ops import _build, symbols

    def missing():
        raise RuntimeError("CUDA toolkit not found")

    args = _symbols_case(_smoke(), _smoke().SYMBOL_WATCH[1])
    monkeypatch.setattr(_build, "library", missing)
    symbols.reset_counts()
    with pytest.raises(RuntimeError, match="toolkit"):
        symbols.frame_symbols(*args)
    assert (symbols.KERNEL_LAUNCHES, symbols.PLAIN_CALLS) == (0, 0)
