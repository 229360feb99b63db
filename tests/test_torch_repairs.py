"""Three repairs of the port, on the CPU: its host runtime from a checkout
where ``_zf_native`` was never built in place (the port builds the same C++
source itself), the decoder's synthesis call that no longer waits for the
device (the range check moved to the host), and the package's exports; and
the copied libsndfile binding.

Tolerance: exact equality of the bytes."""

import ctypes.util
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import zigflac_tpu
import zigflac_tpu_torch
from conftest import make_signal
from zigflac_tpu_torch import decoder
from zigflac_tpu_torch.ops import synth
from zigflac_tpu_torch.wav import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flac():
    rng = np.random.default_rng(0xF1)
    buf = io.BytesIO()
    write_wav(buf, make_signal(rng, 3 * 1024 + 77, kind="mixed"), 44100, 16)
    return zigflac_tpu.encode_wav_bytes(buf.getvalue(),
                                        config=zigflac_tpu.EncoderConfig(block_size=1024),
                                        backend="golden", tags=[("TITLE", "ogg")])


# A fresh checkout, as far as the C++ runtime goes: the package is reached
# through a link in another directory, so the repository root (where
# ``python native/setup.py build_ext --inplace`` drops _zf_native) is not
# on sys.path.
FRESH = r"""
import importlib.util, json, sys
assert importlib.util.find_spec("_zf_native") is None
from zigflac_tpu_torch import native, ogg
with open(sys.argv[1], "rb") as f, open(sys.argv[2], "wb") as out:
    ogg.flac_to_ogg(f.read(), out)
print(json.dumps({"have_native": native.HAVE_NATIVE, "module": native._n.__name__,
                  "crc": native.crc16(b"123456789")}))
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the C++ runtime")
def test_host_runtime_from_a_fresh_checkout(flac, tmp_path):
    """Without an in-place ``_zf_native`` the port takes its own g++ build
    of native/zf_native.cpp: HAVE_NATIVE is true, and Ogg-FLAC output
    (whose frame scan needs the C++ parser) equals the JAX package's."""
    pytest.importorskip("_zf_native")  # the JAX package's Ogg needs it here
    from zigflac_tpu import ogg as jax_ogg

    (tmp_path / "zigflac_tpu_torch").symlink_to(os.path.join(ROOT, "zigflac_tpu_torch"))
    (tmp_path / "in.flac").write_bytes(flac)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", FRESH, "in.flac", "out.oga"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got == {"have_native": True, "module": "zigflac_tpu_torch.ops._zf_native",
                   "crc": 0xFEE8}
    want = io.BytesIO()
    jax_ogg.flac_to_ogg(flac, want)
    assert (tmp_path / "out.oga").read_bytes() == want.getvalue()


def test_decoder_synthesis_call_does_not_check_on_the_device(flac, monkeypatch):
    """The decoder calls the unchecked entry, whose call never waits for the
    device; public synthesize_batch keeps its checks."""
    def refuse(*args):
        raise AssertionError("the decoder called the checked wrapper")

    monkeypatch.setattr(synth, "synthesize_batch", refuse)
    want = zigflac_tpu.decode_flac(flac)
    got = zigflac_tpu_torch.decode_flac(flac, device="cpu")
    assert got.md5_ok and np.array_equal(got.samples, want.samples)


@pytest.mark.parametrize("column,value", [(0, 64), (0, -1), (2, 64), (2, -3)],
                         ids=["shift64", "shift-1", "wasted64", "wasted-3"])
def test_decoder_range_check_on_the_host(flac, monkeypatch, column, value):
    """A shift or wasted-bits count outside 0..63 from the parser raises the
    typed decode error before anything reaches the device."""
    parser = decoder._parser()

    class Doctored:
        def parse_frames(self, *args):
            out = list(parser.parse_frames(*args))
            sow = np.frombuffer(out[5], np.int32).copy().reshape(-1, 3)
            sow[1, column] = value
            out[5] = sow.tobytes()
            return tuple(out)

    monkeypatch.setattr(decoder, "_parser", lambda: Doctored())
    with pytest.raises(decoder.FlacDecodeError, match="0..63"):
        zigflac_tpu_torch.decode_flac(flac, device="cpu")


def test_exports_match_the_jax_package():
    from zigflac_tpu_torch import BlockType, __version__

    assert __version__ == zigflac_tpu.__version__ == "0.1.0"
    assert [(b.name, int(b)) for b in BlockType] == [
        (b.name, int(b)) for b in zigflac_tpu.BlockType]
    assert set(zigflac_tpu.__all__) <= set(zigflac_tpu_torch.__all__)


def test_sndfile_copy_agrees_with_the_original():
    from zigflac_tpu.utils import sndfile as original
    from zigflac_tpu_torch.utils import sndfile

    assert sndfile.available() == original.available()


@pytest.mark.skipif(ctypes.util.find_library("sndfile") is None, reason="no libsndfile here")
def test_sndfile_decodes_the_port_stream():
    """Xiph libFLAC, through the copied binding, decodes the port's FLAC to
    the WAV's samples."""
    from zigflac_tpu_torch.utils import sndfile

    if not sndfile.available():
        pytest.skip("libsndfile found but not loadable")
    rng = np.random.default_rng(0xF2)
    x = make_signal(rng, 2 * 4096 + 11, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, x, 44100, 16)
    got, rate = sndfile.decode_flac(
        zigflac_tpu_torch.encode_wav_bytes(buf.getvalue(), device="cpu"), 16)
    assert rate == 44100 and np.array_equal(got, x)
