"""The ``cd-flac8`` configuration's window list against its own plain
reference (``benchmark/reference/flac_ref_windows.py``) on the CPU at tiny
sizes, and ``correct`` false for its control and for a planted fault: one
window's taper altered in the program."""

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from harness import signal, spec
from helpers import run_cell
from zigflac_tpu_torch.ops import lpc
from zigflac_tpu_torch.utils.apodization import TUKEY_HALF

BENCH = spec.load()
CONFIG = spec.config(BENCH, "cd-flac8")
ENCODE = spec.workload(BENCH, "cd-album-encode-flac8")


def _pcm(seed, n):
    p = dict(signal.track_params(seed, 1)[0], lead_s=0.01, fade_s=0.05, quiet_s=0.01)
    fmt = CONFIG["format"]
    return signal.make_track(seed, 0, n, fmt["sample_rate"], fmt["bit_depth"], 2, p, "cpu")


@pytest.mark.parametrize("n", [4096 * 3 + 1000, 4096 + 16, 12])
def test_program_matches_the_configurations_reference(n):
    """The program's bytes are the reference's the configuration names,
    and the reference's own decisions restore the PCM."""
    fmt, ref = CONFIG["format"], spec.reference(CONFIG)
    pcm = _pcm(n, n)
    wav = signal.wav_bytes(pcm, fmt["sample_rate"], fmt["bit_depth"])
    want = ref.encode(pcm, fmt["sample_rate"], fmt["bit_depth"], CONFIG["encoder"],
                      memoryview(wav)[44:])
    got = zt.encode_wav_bytes(wav, zt.EncoderConfig(**CONFIG["encoder"]), device="cpu")
    assert got == want
    assert torch.equal(ref.decode_samples(pcm, fmt["bit_depth"], CONFIG["encoder"]), pcm)
    back = zt.decode_flac(got, device="cpu")
    assert back.md5_ok and np.array_equal(back.samples, pcm.numpy())


def test_control_is_not_correct(capsys):
    """The control, the first window alone, writes other frames."""
    rc, res, err = run_cell(capsys, ENCODE, spec.traffic(ENCODE["traffic"]),
                            extra=("--control", "1"))
    assert rc == 0 and res is not None, err
    assert res["correct"] is False and res["checks"]["frames_wrong"]["value"] > 0


def test_altered_taper_is_caught(capsys, monkeypatch):
    """The program with the first window's raised-cosine taper flattened
    (every value between 0 and 256 raised to 256): frames_wrong sees it."""
    real = lpc.window_qw

    def altered(win, n):
        w = real(win, n)
        return np.where(w > 0, 256, 0) if win == TUKEY_HALF else w

    lpc.windows_tensor.cache_clear()
    monkeypatch.setattr(lpc, "window_qw", altered)
    try:
        rc, res, err = run_cell(capsys, ENCODE, spec.traffic(ENCODE["traffic"]))
    finally:
        lpc.windows_tensor.cache_clear()
    assert rc == 0 and res is not None, err
    assert res["correct"] is False and res["checks"]["frames_wrong"]["value"] > 0, res["checks"]
