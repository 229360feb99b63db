"""``correct`` has to come out false for the control and for every fault a
cell can have. The control (``--control 1``) is the plain reference in the
program's place with one of the configuration's guarantees broken. The
faults are planted in the program under a whole run with the card's look
skipped: an answer altered where it is produced, a call that hands back the
previous call's answer (its state unchanged), half of each answer left out,
a repeated call's answer altered, and for the decode cell an encoder that
writes other valid streams.
A run on one card has no exchange between cards to leave out. At full size
the control is run on the card with ``benchmark/run.py --control 1``."""

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from harness import spec
from helpers import run_cell

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell(name):
    cell = spec.workload(BENCH, name)
    return cell, spec.traffic(cell["traffic"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(capsys, name):
    cell, traffic = _cell(name)
    rc, res, err = run_cell(capsys, cell, traffic, extra=("--control", "1"))
    assert rc == 0 and res is not None, err
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _altered(out):
    if isinstance(out, bytes):
        b = bytearray(out)
        b[len(b) * 2 // 3] ^= 0x10
        return bytes(b)
    out.samples[0, out.samples.shape[1] // 2] += 1
    return out


def _half(out):
    if isinstance(out, bytes):
        return out[: len(out) // 2]
    out.samples[:, out.samples.shape[1] // 2 :] = 0
    return out


def _repeat(out):
    """A repeated call's answer with its second half zeroed: the same
    length and STREAMINFO, so only the later outputs' probes see it."""
    if isinstance(out, bytes):
        return out[: len(out) // 2] + bytes(len(out) - len(out) // 2)
    out.samples[:, out.samples.shape[1] // 2 :] = 0
    return out


FAULTS = ["altered", "stale", "half", "repeat"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(capsys, monkeypatch, name, fault):
    cell, traffic = _cell(name)
    attr = "decode_flac" if traffic["entry"] == "decode_flac" else "encode_wav_bytes"
    real = getattr(zt, attr)
    last = []

    def broken(*a, **k):
        out = real(*a, **k)
        seen = [o for x, o in last if x is not a[0]]
        repeat = len(seen) < len(last)
        last.append((a[0], out))
        if fault == "stale":  # the answer to the last other input
            return seen[-1] if seen else out
        if fault == "repeat":
            return _repeat(out) if repeat else out
        return _altered(out) if fault == "altered" else _half(out)

    monkeypatch.setattr(zt, attr, broken)
    # every item warmed up, so that each call of the window, even the only
    # one on a loaded host, has a stale answer or repeats an input; for a
    # repeat every item is checked and no output kept whole, so only the
    # probes see it
    mix = {"stale": {"warmup": 99},
           "repeat": {"warmup": 99, "check": {"items": 99, "per_item": 0}}}.get(fault)
    rc, res, err = run_cell(capsys, cell, traffic, seconds=1.5, mix=mix)
    assert rc == 0 and res is not None, err
    assert res["correct"] is False, res["checks"]
    if fault == "repeat":
        assert res["checks"]["probe_wrong"]["value"] > 0, res["checks"]


def test_decode_input_held_to_the_reference(capsys, monkeypatch):
    """An encoder that writes other valid streams (fixed prediction where
    the configuration states LPC) decodes to the right samples; the decode
    cell's check of its input streams fails it."""
    name = next(w["name"] for w in BENCH["workloads"]
                if spec.traffic(w["traffic"])["entry"] == "decode_flac")
    cell, traffic = _cell(name)
    real = zt.encode_wav_bytes

    def fixed(wav, cfg, **k):
        return real(wav, zt.EncoderConfig(**dict(vars(cfg), prediction="fixed")), **k)

    monkeypatch.setattr(zt, "encode_wav_bytes", fixed)
    rc, res, err = run_cell(capsys, cell, traffic)
    assert rc == 0 and res is not None, err
    assert res["correct"] is False and res["checks"]["stream_wrong"]["value"] > 0
    assert res["checks"]["samples_wrong"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(capsys, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the program's CUDA kernels")
    cell, traffic = _cell(name)
    rc, res, err = run_cell(capsys, cell, traffic, device=None, extra=("--trace", "1"))
    assert rc == 0 and res["correct"] is True, err
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert np.isfinite([m["value"] for m in res["metrics"].values()]).all()
