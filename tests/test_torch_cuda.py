"""The port on a CUDA card: the deposit and synthesis kernels against their
plain versions, and whole encodes and decodes on the card against the CPU
path. Every test skips where
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
from zigflac_tpu_torch.ops import deposit, synth
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


def _wav(rng, n, channels=2, depth=16):
    t = np.arange(n)
    x = 0.3 * (1 << (depth - 1)) * np.sin(2 * np.pi * 440 * t / 44100)
    x = x + rng.normal(0, 1 << (depth - 8), (channels, n))
    lim = 1 << (depth - 1)
    buf = io.BytesIO()
    write_wav(buf, np.clip(np.round(x), -lim, lim - 1).astype(np.int64), 44100, depth)
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
    ],
)
def test_synth_kernel_matches_plain(rng, m, b, kw):
    args = [torch.from_numpy(a).cuda() for a in _subframes(rng, m, b, **kw)]
    synth.reset_counts()
    got = synth.synthesize_batch(*args)
    assert (synth.KERNEL_LAUNCHES, synth.PLAIN_CALLS) == (1, 0)
    torch.testing.assert_close(got, synth.synthesize_batch_plain(*args), rtol=0, atol=0)


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
