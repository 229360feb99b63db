"""The plain reference against zigflac_tpu_torch on the CPU at tiny sizes,
for both configurations: the same bytes from the same PCM, and the
reference's own decisions restoring the PCM exactly. The reference imports
nothing of the program (checked in a subprocess)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import zigflac_tpu_torch as zt
from harness import signal, spec
from reference import flac_ref

BENCH = spec.load()
CONFIGS = {c["name"]: spec.config(BENCH, c["name"]) for c in BENCH["configs"]}


def _signal(kind, seed, fmt, n):
    depth = fmt["bit_depth"]
    g = torch.Generator().manual_seed(seed)
    top = 2 ** (depth - 1)
    if kind == "track":
        p = signal.track_params(seed, 1)[0]
        p = dict(p, lead_s=0.01, fade_s=0.05, quiet_s=0.01)
        return signal.make_track(seed, 0, n, fmt["sample_rate"], depth, 2, p, "cpu")
    if kind == "noise":  # verbatim subframes and escapes
        return (torch.randn(2, n, generator=g) * top * 0.9).round().long().clamp(-top, top - 1)
    if kind == "quiet":  # constant frames, tiny residuals, wrapped Rice estimates
        x = (torch.randn(2, n, generator=g) * 3).round().long()
        x[:, n // 3 : 2 * n // 3] = 0
        x[1, : n // 4] = 5
        return x
    x = torch.zeros(2, n, dtype=torch.long)  # "spikes": full-scale impulses
    x[:, ::97] = top - 1
    x[0, 3::55] = -top
    return x


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind,n", [("track", 4096 * 3 + 1000), ("noise", 4096 * 2 + 333),
                                    ("quiet", 4096 * 2 + 100), ("spikes", 4096 + 40),
                                    ("track", 4096 + 16), ("track", 12), ("track", 4096)])
def test_reference_matches_the_program(config, kind, n):
    cfg = CONFIGS[config]
    fmt = cfg["format"]
    pcm = _signal(kind, n + len(kind), fmt, n)
    wav = signal.wav_bytes(pcm, fmt["sample_rate"], fmt["bit_depth"])
    ref = flac_ref.encode(pcm, fmt["sample_rate"], fmt["bit_depth"], cfg["encoder"],
                          memoryview(wav)[44:])
    got = zt.encode_wav_bytes(wav, zt.EncoderConfig(**cfg["encoder"]), device="cpu")
    assert ref == got
    back = zt.decode_flac(got, device="cpu")
    assert back.md5_ok and np.array_equal(back.samples, pcm.numpy())
    mine = flac_ref.decode_samples(pcm, fmt["bit_depth"], cfg["encoder"])
    assert torch.equal(mine, pcm)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_control_breaks_the_stream(config):
    """Each configuration's control settings change the bytes, and the
    float32 synthesis of the decode control changes 24-bit samples (16-bit
    prediction sums fit float32's 24-bit mantissa: no decode cell runs it)."""
    cfg = CONFIGS[config]
    fmt = cfg["format"]
    pcm = _signal("track", 3, fmt, 4096 * 4)
    raw = signal.wav_bytes(pcm, fmt["sample_rate"], fmt["bit_depth"])[44:]
    ref = flac_ref.encode(pcm, fmt["sample_rate"], fmt["bit_depth"], cfg["encoder"], raw)
    ctl = flac_ref.encode(pcm, fmt["sample_rate"], fmt["bit_depth"],
                          dict(cfg["encoder"], **cfg["control"]), raw)
    assert ref != ctl
    if fmt["bit_depth"] >= 24:
        f32 = flac_ref.decode_samples(pcm, fmt["bit_depth"], cfg["encoder"], torch.float32)
        assert not torch.equal(f32, pcm)


def test_crc16_distance_table_is_the_crc():
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, n).astype(np.int64) for n in (1, 2, 3, 17, 300)]
    buf = torch.from_numpy(np.concatenate(frames))
    length = torch.tensor([len(f) for f in frames])
    off = torch.cumsum(length, 0) - length
    got = flac_ref.crc16_frames(buf, off, length, block=7).tolist()
    assert got == [flac_ref.crc16_bytes(bytes(f.astype(np.uint8))) for f in frames]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'benchmark'); import reference.flac_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'zigflac_tpu', 'zigflac_tpu_torch', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
