"""Plain reference FLAC encoder with a list of LPC apodization windows: the
bytes an encode with ``apodization`` must give, worked out again from the
PCM alone.

``flac_ref.py`` with one change to the subframe choice: each plane's
subframe is chosen by ``flac_ref.choose`` once for each window of the
configuration's list, that window in place of its Q8 Tukey(0.5) (the
windowed exact lag sums, the Q28 Levinson, the candidate order, the
quantised coefficients, the residual and its Rice coding, against the best
fixed order under strict ``<``), and the choice with the fewest estimated
bits is kept, the first window in the list on a tie. That is the cheapest
window's LPC candidate (Rice bits + 9 + order * precision; an unusable
candidate never wins) set against the best fixed order. Everything else
(the fixed search, the Rice choice, the stereo modes, the frame and stream
bytes, the synthesis) is ``flac_ref.py``'s: this file runs a copy of that
module of its own whose ``Settings`` carry the list and whose ``choose``
and window are this file's.

The windows follow libFLAC 1.3's window functions (src/libFLAC/window.c,
as this file's author knows them; no copy is in this repository):
``tukey(P)``, and ``partial_tukey(N)`` / ``punchout_tukey(N)`` expanded into
N windows, part m spanning [m, m + 1 + u) / (N + u) of the block with u = 1
/ (1 - overlap) - 1, overlap 0.1 (partial) or 0.2 (punchout), each part's
taper 0.2. Each is computed in float64 and quantised to Q8 (round half to
even), where libFLAC applies float windows to float samples: that Q8 step
is a departure, and the stated list defines the bytes.

Plain PyTorch integer ops; imports nothing of the program under test.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch


def _flac_ref():
    """A copy of ``flac_ref.py`` of this module's own, which it then alters."""
    key = f"{__name__}.flac_ref"
    spec = importlib.util.spec_from_file_location(key, Path(__file__).with_name("flac_ref.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


ref = _flac_ref()

OVERLAP = {"partial_tukey": 0.1, "punchout_tukey": 0.2}
TAPER = 0.2


@dataclass(frozen=True)
class Settings(ref.Settings):
    apodization: tuple = ("tukey(0.5)",)

    @staticmethod
    def of(d: Dict) -> "Settings":
        keys = Settings.__dataclass_fields__
        s = {k: v for k, v in d.items() if k in keys}
        if "apodization" in s:
            s["apodization"] = tuple(s["apodization"])
        return Settings(**s)


# -- the windows -------------------------------------------------------------------


def _raised_cosine(w: np.ndarray, lo: int, hi: int, taper: int) -> None:
    """w[lo:hi] = 1, each end's ``taper`` samples on 0.5 - 0.5 cos(pi i /
    taper): i = 1, 2, .. taper going in from ``lo``, and the same coming out
    to ``hi``."""
    for n in range(lo, hi):
        i = min(n - lo + 1, hi - n)
        w[n] = 1.0 if i > taper else 0.5 - 0.5 * np.cos(np.pi * i / taper)


def window_float(name: str, n: int) -> List[np.ndarray]:
    """The float64 windows of one ``apodization`` entry, for blocks of ``n``."""
    m = re.fullmatch(r"tukey\((.+)\)", name)
    if m:
        p = float(m.group(1))
        if n == 1:
            return [np.ones(1)]
        t = np.linspace(0.0, 1.0, n)
        w = np.ones(n)
        lo, hi = t < p / 2.0, t >= 1.0 - p / 2.0
        w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / p - 1.0)))
        w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / p - 2.0 / p + 1.0)))
        return [w]
    m = re.fullmatch(r"(partial_tukey|punchout_tukey)\((\d+)\)", name)
    if not m:
        raise ValueError(f"unknown window {name!r}")
    kind, parts = m.group(1), int(m.group(2))
    units = 1.0 / (1.0 - OVERLAP[kind]) - 1.0
    out = []
    for part in range(parts):
        start = int(part / (parts + units) * n)
        end = int((part + 1 + units) / (parts + units) * n)
        w = np.zeros(n)
        if kind == "partial_tukey":
            _raised_cosine(w, start, end, int(TAPER / 2.0 * (end - start)))
        else:
            _raised_cosine(w, 0, start, int(TAPER / 2.0 * start))
            _raised_cosine(w, end, n, int(TAPER / 2.0 * (n - end)))
        out.append(w)
    return out


@lru_cache(maxsize=64)
def windows_q8(names: tuple, n: int) -> List[np.ndarray]:
    """Every window of the list, Q8 int64, in list order."""
    return [np.round(w * 256.0).astype(np.int64) for name in names
            for w in window_float(name, n)]


# -- the subframe choice ------------------------------------------------------------


_choose, _tukey_q8 = ref.choose, ref.tukey_q8


def choose(x: torch.Tensor, bits_of_t: int, depth: int, s: Settings) -> "ref.Subframes":
    """``flac_ref.choose`` under each window of the list in turn; per plane,
    the choice with the fewest estimated bits, the first window on a tie."""
    if s.prediction != "lpc":
        return _choose(x, bits_of_t, depth, s)
    best = None
    try:
        for window in windows_q8(s.apodization, x.shape[1]):
            ref.tukey_q8 = lambda n, w=window: w
            sub = _choose(x, bits_of_t, depth, s)
            if best is None:
                best = sub
                continue
            better = sub.est < best.est
            best = ref.Subframes(**{
                k: torch.where(better.view(-1, *[1] * (getattr(sub, k).dim() - 1)),
                               getattr(sub, k), getattr(best, k))
                for k in ref.Subframes.__dataclass_fields__})
    finally:
        ref.tukey_q8 = _tukey_q8
    return best


# this file's copy of flac_ref.py reads the list and chooses over it
ref.Settings, ref.choose = Settings, choose
encode_parts, encode, decode_samples = ref.encode_parts, ref.encode, ref.decode_samples
plan_frames, describe = ref.plan_frames, ref.describe
