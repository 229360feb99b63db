"""The benchmark's audio: a pool of tracks made from the seed.

bench.py's recipe (two tones and Gaussian noise, the right channel a scaled
copy of the left) widened so that a pool holds distinct material: each
track has its own tone frequencies, levels, noise and a slow pan, opens
with exact digital silence and ends with a fade into silence, so constant
subframes and stereo-mode changes occur. Every seed deals the same set of
lengths and parameters to the pool's tracks, in its own order, and draws
its own noise, so seeds differ in order and samples, not in the work. The noise is drawn on
the device with a ``torch.Generator`` in one call a track; the PCM goes to
the host as the WAV bytes the encoder reads and as planar int32 samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Item:
    """One pool entry: its WAV bytes, planar samples [C, n] int32, format."""
    index: int
    wav: bytes
    pcm: np.ndarray
    rate: int
    depth: int

    @property
    def channels(self) -> int:
        return self.pcm.shape[0]

    @property
    def samples(self) -> int:
        return self.pcm.shape[1]

    @property
    def seconds(self) -> float:
        return self.samples / self.rate

    @property
    def raw_pcm(self) -> memoryview:
        """The WAV's data chunk: the bytes the STREAMINFO MD5 covers."""
        return memoryview(self.wav)[44:]


def sub_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one part of the run, from the run's seed (any whole
    number) and the part's indices."""
    words = [seed & (2**64 - 1), (seed >> 64) & (2**64 - 1), *parts]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def lengths(spec: dict, count: int) -> list:
    """Seconds of each of ``count`` items: the midpoints of ``count`` equal
    strata of the distribution, so that every seed gets the same sizes."""
    lo, hi = float(spec["min"]), float(spec["max"])
    us = [(i + 0.5) / count for i in range(count)]
    if spec["dist"] == "uniform":
        return [lo + u * (hi - lo) for u in us]
    if spec["dist"] == "loguniform":
        return [math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))) for u in us]
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def wav_header(n: int, channels: int, rate: int, depth: int) -> bytes:
    nb = (depth + 7) // 8
    data = n * channels * nb
    return (b"RIFF" + (36 + data).to_bytes(4, "little") + b"WAVEfmt "
            + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + channels.to_bytes(2, "little") + rate.to_bytes(4, "little")
            + (rate * channels * nb).to_bytes(4, "little")
            + (channels * nb).to_bytes(2, "little") + depth.to_bytes(2, "little")
            + b"data" + data.to_bytes(4, "little"))


# each track's parameters: the same ``pool`` values of every range at every
# seed (midpoints of equal strata), dealt to the tracks in a seeded order
PARAMS = {
    "f1": (80.0, 1000.0), "f2": (40.0, 300.0), "a1": (4000.0, 12000.0),
    "a2": (1000.0, 5000.0), "sigma": (40.0, 400.0), "pan_hz": (0.02, 0.1),
    "phase": (0.0, 2 * math.pi), "lead_s": (0.5, 2.0), "fade_s": (3.0, 8.0),
    "quiet_s": (0.25, 0.25), "gain": (0.5, 1.0),
}


def track_params(seed: int, pool: int, ranges: dict = None) -> list:
    """Each track's parameters; ``ranges`` (a traffic mix's ``params``)
    replaces some of the ranges above."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    out = [{} for _ in range(pool)]
    for name, (lo, hi) in dict(PARAMS, **(ranges or {})).items():
        for i, k in enumerate(rng.permutation(pool)):
            out[i][name] = lo + (k + 0.5) / pool * (hi - lo)
    return out


def make_track(seed: int, index: int, n: int, rate: int, depth: int, channels: int,
               p: dict, device) -> torch.Tensor:
    """Planar int64 samples [channels, n] of one track, on ``device``."""
    scale = 2.0 ** (depth - 16)
    lead, fade = int(p["lead_s"] * rate), int(p["fade_s"] * rate)
    quiet = int(p["quiet_s"] * rate)
    gains = [p["gain"] * (0.9 ** c) for c in range(channels)]
    t = torch.arange(n, dtype=torch.float64, device=device)
    w = 2 * math.pi / rate
    base = scale * (p["a1"] * torch.sin(w * p["f1"] * t) + p["a2"] * torch.sin(w * p["f2"] * t))
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 2, index))
    noise = torch.randn((channels, n), generator=g, device=device, dtype=torch.float32)
    pan = w * p["pan_hz"] * t + p["phase"]
    x = torch.empty((channels, n), dtype=torch.float64, device=device)
    for c in range(channels):
        x[c] = gains[c] * base * (0.6 + 0.4 * torch.cos(pan + c * math.pi / 2))
    x += noise.double() * (p["sigma"] * scale)
    env = torch.ones(n, dtype=torch.float64, device=device)
    end = max(n - quiet, 0)
    start = max(end - fade, 0)
    if end > start:
        env[start:end] = torch.linspace(1.0, 0.0, end - start, dtype=torch.float64, device=device)
    env[end:] = 0.0
    env[: min(lead, n)] = 0.0
    lim = float(1 << (depth - 1))
    return torch.clamp(torch.round(x * env), -lim, lim - 1).to(torch.int64)


def wav_bytes(pcm: torch.Tensor, rate: int, depth: int) -> bytes:
    """Little-endian interleaved PCM of planar int64 samples, with the
    header: the bytes are laid out on the samples' device."""
    c, n = pcm.shape
    nb = (depth + 7) // 8
    inter = pcm.t().reshape(-1)
    b = torch.stack([(inter >> (8 * k)) & 0xFF for k in range(nb)], 1).to(torch.uint8)
    return wav_header(n, c, rate, depth) + b.cpu().numpy().tobytes()


def make_pool(seed: int, traffic: dict, fmt: dict, device) -> list:
    """Every pool item of a traffic mix in the configuration's format."""
    rate, depth, channels = fmt["sample_rate"], fmt["bit_depth"], fmt["channels"]
    items = []
    params = track_params(seed, traffic["pool"], traffic.get("params"))
    for i, sec in enumerate(lengths(traffic["seconds"], traffic["pool"])):
        n = max(1, round(sec * rate))
        pcm = make_track(seed, i, n, rate, depth, channels, params[i], device)
        items.append(Item(i, wav_bytes(pcm, rate, depth), pcm.to(torch.int32).cpu().numpy(),
                          rate, depth))
        del pcm
    return items


def call_order(seed: int, pool: int):
    """The window's calls, without end: the pool in a fresh seeded
    permutation each round."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    while True:
        yield from rng.permutation(pool).tolist()
