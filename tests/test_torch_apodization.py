"""The LPC window list (``apodization``): the port against the benchmark's
plain reference with windows (``benchmark/reference/flac_ref_windows.py``)
byte for byte on seeded audio at small sizes, the decoder reading the
streams back sample for sample, the one-window default path against the
JAX package, the window search's counter and tally, and the setting's
refusals; and the ``film-5.1-48k-24bit`` configuration's settings (flac -8
on 24-bit / 48 kHz independent channels): its encoder block, the reference's
bytes at 3, 6 and 8 channels, the frame header's codes and its control.

Tolerance: exact equality of bytes, samples and integers."""

import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zigflac_tpu
import zigflac_tpu_torch as zt
from conftest import make_signal
from zigflac_tpu.utils.config import EncoderConfig as JaxConfig
from zigflac_tpu_torch.ops import analyze, lpc
from zigflac_tpu_torch.utils import stages
from zigflac_tpu_torch.utils.apodization import TUKEY_HALF, windows_of
from zigflac_tpu_torch.wav import write_wav

ROOT = Path(__file__).resolve().parent.parent
FLAC8 = ("tukey(5e-1)", "partial_tukey(2)", "punchout_tukey(3)")
SIX = ("tukey(0.5)", "partial_tukey(2)[0]", "partial_tukey(2)[1]", "punchout_tukey(3)[0]",
       "punchout_tukey(3)[1]", "punchout_tukey(3)[2]")
CD8 = dict(block_size=4096, prediction="lpc", channels="stereo_auto", max_rice_order=6,
           max_rice_param=30, lpc_order=12, lpc_precision=12)
HIRES = dict(block_size=4096, prediction="lpc", channels="stereo_auto", max_rice_order=5,
             max_rice_param=30, lpc_order=8, lpc_precision=15)
FILM_CONFIG = json.loads((ROOT / "benchmark" / "configs" / "film-5.1-48k-24bit.json").read_text())
FILM = FILM_CONFIG["encoder"]


def _reference():
    key = "test_flac_ref_windows"
    if key not in sys.modules:
        path = ROOT / "benchmark" / "reference" / "flac_ref_windows.py"
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _wav(pcm, rate, depth):
    buf = io.BytesIO()
    write_wav(buf, pcm, rate, depth)
    return buf.getvalue()


def _encode_both(pcm, rate, depth, fields):
    wav = _wav(pcm, rate, depth)
    got = zt.encode_wav_bytes(wav, zt.EncoderConfig(**fields), device="cpu")
    ref = _reference().encode(torch.from_numpy(pcm).long(), rate, depth, fields,
                              memoryview(wav)[44:])
    return got, ref


@pytest.fixture(scope="module")
def cd_pcm():
    """16-bit stereo of three blocks and a 1,000-sample tail: a tone that
    swells and is cut off inside blocks, over noise, so that windows which
    leave part of a block out can predict better than the Tukey."""
    n = 3 * 4096 + 1000
    rng = np.random.default_rng(0xF8)
    t = np.arange(n)
    env = np.where((t % 4096 < 1700) | (t % 5000 > 4200), 0.05, 1.0) * (1 + t / n)
    tone = 9000 * env * np.sin(2 * np.pi * 311 * t / 44100 + 0.3 * np.sin(t / 900))
    x = np.stack([tone + rng.normal(0, 90, n), 0.7 * tone + rng.normal(0, 90, n)])
    return np.clip(np.round(x), -32768, 32767).astype(np.int32)


@pytest.mark.parametrize("apodization", [(w,) for w in FLAC8] + [("tukey(0.25)",), FLAC8],
                         ids=["tukey", "partial_tukey", "punchout_tukey", "tukey-0.25", "flac-8"])
def test_port_matches_the_reference(cd_pcm, apodization):
    """Each entry of flac -8's list alone (the default path for the first,
    the search over two and three parts for the others), a Tukey of another
    taper alone, and the whole list, at order 12 with 12-bit coefficients
    (the 17-bit side plane of 16-bit stereo among the planes, a tail block),
    byte for byte; the decoder gives the samples back."""
    fields = dict(CD8, apodization=apodization)
    got, ref = _encode_both(cd_pcm, 44100, 16, fields)
    assert got == ref
    back = zt.decode_flac(got, device="cpu")
    assert back.md5_ok and np.array_equal(back.samples, cd_pcm)


def _film_pcm(channels):
    """24-bit channels of two 4096-sample blocks and a 777-sample tail: per
    channel a tone that swells and is cut off inside blocks, over noise of
    its own; channel 3 (the LFE of 5.1) constant where there are four or
    more."""
    n = 2 * 4096 + 777
    rng = np.random.default_rng(0xF11 + channels)
    t = np.arange(n)
    env = np.where((t % 4096 < 1500) | (t % 5000 > 4300), 0.05, 1.0) * (1 + t / n)
    x = np.stack([2.2e6 * 0.85 ** c * env * np.sin(2 * np.pi * (97 + 61 * c) * t / 48000 + c)
                  + rng.normal(0, 400 * (c + 1), n) for c in range(channels)])
    if channels >= 4:
        x[3] = -70_000
    return np.clip(np.round(x), -(1 << 23), (1 << 23) - 1).astype(np.int32)


@pytest.mark.parametrize("kind,n,channels", [("noise", 2 * 4096 + 13, 2), ("quiet_noise", 4096 + 700, 2),
                                             ("alternating", 4096 + 5, 2), ("mixed", 2 * 4096 + 100, 1),
                                             *(("film", 2 * 4096 + 777, c) for c in (3, 6, 8))])
def test_whole_list_matches_the_reference_on_other_content(kind, n, channels):
    """Verbatim and escaped partitions, tiny residuals, a 5-sample tail (no
    LPC below 13 samples) and independent channels, under the six windows;
    and the film settings (24-bit / 48 kHz, 15-bit coefficients) on 3, 6
    and 8 independent channels, one of them constant."""
    if kind == "film":
        pcm, rate, depth, fields = _film_pcm(channels), 48000, 24, dict(FILM, channels=channels)
    else:
        pcm, rate, depth = make_signal(np.random.default_rng(n), n, channels, 16, kind), 44100, 16
        fields = dict(CD8, apodization=FLAC8, channels="stereo_auto" if channels == 2 else 1)
    got, ref = _encode_both(pcm, rate, depth, fields)
    assert got == ref
    back = zt.decode_flac(got, device="cpu")
    assert back.md5_ok and np.array_equal(back.samples, pcm)
    assert (back.info.sample_rate, back.info.bit_depth) == (rate, depth)


def test_film_configuration_is_accepted():
    cfg = zt.EncoderConfig(**FILM)
    assert cfg.num_channels == 6 and not cfg.stereo_auto
    assert (cfg.lpc_order, cfg.lpc_precision, cfg.max_rice_order) == (12, 15, 6)
    assert len(windows_of(cfg)) == 6
    assert FILM_CONFIG["format"] == {"sample_rate": 48000, "bit_depth": 24, "channels": 6}


def test_film_frame_header_codes_and_control():
    """The first frame of the 5.1 stream: rate code 10 (48 kHz), channel code 5
    (six independent channels, FL FR FC LFE BL/SL BR/SR), 24 bits; the
    configuration's control (the first window alone) writes other bytes."""
    pcm = _film_pcm(6)
    six = zt.encode_wav_bytes(_wav(pcm, 48000, 24), zt.EncoderConfig(**FILM), device="cpu")
    pos = 4  # past fLaC and the metadata blocks
    while True:
        last, size = six[pos] & 0x80, int.from_bytes(six[pos + 1 : pos + 4], "big")
        pos += 4 + size
        if last:
            break
    assert six[pos : pos + 2] == b"\xff\xf8"
    assert six[pos + 2] & 0x0F == 10
    assert six[pos + 3] >> 4 == 5 and (six[pos + 3] >> 1) & 7 == 6
    control = zt.EncoderConfig(**dict(FILM, **FILM_CONFIG["control"]))
    one = zt.encode_wav_bytes(_wav(pcm, 48000, 24), control, device="cpu")
    assert six != one and len(six) <= len(one)


def test_window_list_changes_the_stream(cd_pcm):
    """The control of the cd-flac8 configuration (the first window alone)
    writes other bytes than the six windows: the search is not idle."""
    six, _ = _encode_both(cd_pcm, 44100, 16, dict(CD8, apodization=FLAC8))
    one, _ = _encode_both(cd_pcm, 44100, 16, dict(CD8, apodization=FLAC8[:1]))
    assert six != one and len(six) <= len(one)


@pytest.mark.parametrize("n", [13, 16, 1000, 4095, 4096])
def test_windows_equal_the_reference_windows(n):
    """The port's Q8 windows, each in [0, 256], equal the reference's,
    which builds them sample by sample."""
    got = [lpc.window_qw(w, n) for w in windows_of(zt.EncoderConfig(apodization=FLAC8))]
    want = _reference().windows_q8(FLAC8, n)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes() and 0 <= g.min() and g.max() <= 256


def test_labels_expand_in_list_order():
    assert tuple(w.label for w in windows_of(zt.EncoderConfig(apodization=FLAC8))) == SIX
    assert tuple(w.label for w in windows_of(zt.EncoderConfig())) == ("tukey(0.5)",)
    assert windows_of(JaxConfig(prediction="lpc")) == (TUKEY_HALF,)
    assert windows_of(zt.EncoderConfig(apodization=FLAC8[:1])) == (TUKEY_HALF,)
    assert zt.EncoderConfig(apodization=list(FLAC8)).apodization == FLAC8


@pytest.mark.parametrize("names", [("hann",), ("tukey(0)",), ("tukey(1.5)",), ("tukey(x)",),
                                   ("partial_tukey(1)",), ("partial_tukey(2)[0]",),
                                   ("punchout_tukey(3",), ("",), (), ("punchout_tukey(32)",
                                                                      "tukey(0.5)")],
                         ids=["unknown", "p0", "p1.5", "notanumber", "oneparts", "one-part-alone",
                              "unclosed", "empty-name", "no-windows", "33-windows"])
def test_bad_windows_are_refused(names):
    with pytest.raises(ValueError):
        zt.EncoderConfig(prediction="lpc", apodization=names)


def test_one_window_through_the_search_equals_the_default_path(rng):
    """The window search over the one Tukey(0.5) window decides what the
    one-window path decides, field for field, on 16-bit planes and the
    17-bit side."""
    planes = torch.from_numpy(make_signal(rng, 4 * 4096, 4, 17)).reshape(4, 4, 4096)
    wins = lpc.windows_tensor((TUKEY_HALF,), 4096, torch.device("cpu"))
    found = analyze.lpc_window_search(planes, wins, 12, 12, 6, 14)
    order, res, qc, shift, ok = lpc.analyze_lpc(planes, 12, 12)
    bits, method, po, params = analyze.rice_estimate_planes(res, order, 6, 14)
    assert (found.window == 0).all()
    for a, b in [(found.order, order), (found.residuals, res), (found.qcoeffs, qc),
                 (found.shift, shift), (found.ok, ok), (found.method, method),
                 (found.part_order, po), (found.params, params)]:
        assert torch.equal(a, b)
    assert torch.equal(found.cost, torch.where(ok, bits + 9 + order * 12, analyze.I64_MAX))


@pytest.mark.parametrize("j", range(6), ids=SIX)
def test_each_window_alone_gives_the_references_candidate(rng, monkeypatch, j):
    """The window search over one of flac -8's six windows alone gives, on
    every plane (16-bit planes and the 17-bit side), the reference's LPC
    candidate under that window: order, coefficients, shift, whether it is
    usable and, where it is, the residual."""
    planes = torch.from_numpy(make_signal(rng, 2 * 4096, 6, 17)).reshape(12, 4096)
    win = windows_of(zt.EncoderConfig(apodization=FLAC8))[j]
    found = analyze.lpc_window_search(
        planes, lpc.windows_tensor((win,), 4096, torch.device("cpu")), 12, 12, 6, 14)
    ref = _reference().ref
    monkeypatch.setattr(ref, "tukey_q8", lambda n: lpc.window_qw(win, n))
    x = planes.long()
    order, q, shift, ok = ref.lpc_analysis(x, ref.Settings(prediction="lpc", lpc_order=12,
                                                           lpc_precision=12))
    res, fits = ref.lpc_residuals(x, q, shift, order)
    ok = ok & fits
    assert (found.window == 0).all() and ok.any()
    assert torch.equal(found.order, order) and torch.equal(found.shift, shift)
    assert torch.equal(found.qcoeffs[:, :12], q) and not found.qcoeffs[:, 12:].any()
    assert torch.equal(found.ok, ok)
    assert torch.equal(found.residuals[ok].long(), res[ok])


@pytest.fixture
def armed():
    stages.COUNTS, stages.WINDOW_WINS, stages.SEARCH = {}, {}, []
    try:
        yield stages
    finally:
        stages.COUNTS = stages.WINDOW_WINS = stages.SEARCH = None


def test_default_config_counts_planes_and_writes_the_jax_bytes(armed):
    """On the hi-res settings the default one-window config counts one
    window evaluation a plane (four planes a stereo row, padding rows
    included), tallies nothing, records no device interval on the CPU, and
    writes the JAX package's bytes."""
    wav = _wav(make_signal(np.random.default_rng(7), 2 * 4096 + 300, 2, 24), 96000, 24)
    got = zt.encode_wav_bytes(wav, zt.EncoderConfig(**HIRES), device="cpu")
    c = armed.COUNTS
    assert c["lpc.window_evals"] == 4 * c["pipeline.frames_encoded"] > 0
    assert armed.WINDOW_WINS == {} and armed.SEARCH == []
    assert got == zigflac_tpu.encode_wav_bytes(wav, config=JaxConfig(**HIRES), backend="device")


def test_window_list_counts_and_tallies(armed, cd_pcm):
    """Six windows count six evaluations a plane, and the tally of the
    windows that won holds every plane whose subframe became LPC."""
    cfg = zt.EncoderConfig(**CD8, apodization=FLAC8)
    zt.encode_wav_bytes(_wav(cd_pcm, 44100, 16), cfg, device="cpu")
    assert armed.COUNTS["lpc.window_evals"] == 6 * 4 * armed.COUNTS["pipeline.frames_encoded"]
    armed.WINDOW_WINS.clear()
    frames = torch.from_numpy(cd_pcm[:, : 3 * 4096]).reshape(2, 3, 4096).transpose(0, 1)
    left, right = frames[:, 0].long(), frames[:, 1].long()
    lrms = torch.stack([left, right, (left + right) >> 1, left - right]).to(torch.int32)
    a = analyze.analyze_planes(lrms, 32, 16, 4096, cfg)
    tally = armed.WINDOW_WINS[SIX]
    assert tally.shape == (6,) and int(tally.sum()) == int((a.kind == 3).sum()) > 0
