"""Optional binding to a system libsndfile (canonical Xiph libFLAC inside).

The environment carries no FLAC tooling of its own, but pygame vendors
``libsndfile`` (linked against the reference Xiph ``libFLAC``) — a fully
independent third-party FLAC implementation. This module dlopens it when
present and exposes minimal decode/encode helpers, used to

* validate this framework's encoder output against the CANONICAL decoder
  (closing the oracle-trust gap: golden.py mirrors the Zig reference's
  decisions, and libFLAC independently confirms the streams are valid
  FLAC that round-trips the PCM), and
* validate this framework's decoder against CANONICAL encoder output
  (subframe/partition layouts chosen by libFLAC itself, not by us).

Everything degrades gracefully: ``available()`` is False when no
libsndfile exists, and the validation tests skip.

libsndfile C API (sndfile.h): SF_INFO{frames i64, samplerate, channels,
format, sections, seekable}; sf_readf_int returns samples LEFT-justified
in 32 bits (a 16-bit FLAC sample comes back as v << 16).
"""

from __future__ import annotations

import ctypes
import glob
import os
import tempfile
from typing import Optional, Tuple

import numpy as np

SF_FORMAT_TYPEMASK = 0x0FFF0000
SF_FORMAT_SUBMASK = 0x0000FFFF
SF_FORMAT_FLAC = 0x170000
_SUB_FOR_DEPTH = {8: 0x0001, 16: 0x0002, 24: 0x0003}  # PCM_S8/16/24
SFM_READ, SFM_WRITE = 0x10, 0x20


class _SFInfo(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.c_int64),
        ("samplerate", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("format", ctypes.c_int),
        ("sections", ctypes.c_int),
        ("seekable", ctypes.c_int),
    ]


_lib = None
_tried = False


def _candidate_dirs():
    import sysconfig

    site = sysconfig.get_paths().get("purelib", "")
    return [
        os.path.join(site, "pygame.libs"),
        "/usr/lib/x86_64-linux-gnu",
        "/usr/lib",
        "/usr/local/lib",
    ]


def load() -> Optional[ctypes.CDLL]:
    """dlopen libsndfile (idempotent); None when unavailable. Vendored
    copies (pygame.libs) carry hash-renamed dependencies resolved only via
    their own directory, so every shared object in that directory is
    preloaded RTLD_GLOBAL first (multi-pass for ordering)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for d in _candidate_dirs():
        hits = sorted(glob.glob(os.path.join(d, "libsndfile*.so*")))
        if not hits:
            continue
        names = sorted(os.listdir(d)) if "pygame.libs" in d else []
        loaded = set()
        for _ in range(4):  # dependency order unknown: fixpoint passes
            for nm in names:
                if nm in loaded or ".so" not in nm:
                    continue
                try:
                    ctypes.CDLL(os.path.join(d, nm), mode=ctypes.RTLD_GLOBAL)
                    loaded.add(nm)
                except OSError:
                    pass
        try:
            lib = ctypes.CDLL(hits[0])
        except OSError:
            continue
        lib.sf_open.restype = ctypes.c_void_p
        lib.sf_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_SFInfo)
        ]
        lib.sf_readf_int.restype = ctypes.c_int64
        lib.sf_readf_int.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int64
        ]
        lib.sf_writef_int.restype = ctypes.c_int64
        lib.sf_writef_int.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int64
        ]
        lib.sf_close.argtypes = [ctypes.c_void_p]
        lib.sf_strerror.restype = ctypes.c_char_p
        lib.sf_strerror.argtypes = [ctypes.c_void_p]
        lib.sf_command.restype = ctypes.c_int
        lib.sf_command.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int
        ]
        _lib = lib
        return _lib
    return None


def available() -> bool:
    return load() is not None


def decode_flac(data: bytes, bit_depth: int) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream with the canonical libFLAC (via libsndfile).

    Returns (samples int32 [channels, n] right-justified at ``bit_depth``,
    sample_rate). Raises RuntimeError when the library rejects the stream
    (invalid FLAC) — that rejection IS the validation signal."""
    lib = load()
    if lib is None:
        raise RuntimeError("libsndfile unavailable")
    with tempfile.NamedTemporaryFile(suffix=".flac", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        info = _SFInfo()
        h = lib.sf_open(path.encode(), SFM_READ, ctypes.byref(info))
        if not h:
            raise RuntimeError(
                "libFLAC rejected stream: "
                + lib.sf_strerror(None).decode(errors="replace")
            )
        try:
            if (info.format & SF_FORMAT_TYPEMASK) != SF_FORMAT_FLAC:
                raise RuntimeError(
                    f"not detected as FLAC (format=0x{info.format:x})"
                )
            n, c = int(info.frames), int(info.channels)
            buf = np.empty(n * c, np.int32)
            got = lib.sf_readf_int(
                h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n
            )
            if got != n:
                raise RuntimeError(f"short read: {got}/{n} frames")
        finally:
            lib.sf_close(h)
    finally:
        os.unlink(path)
    # left-justified 32-bit -> right-justified at the true FLAC bit depth
    pcm = buf.reshape(n, c).T >> np.int32(32 - bit_depth)
    return np.ascontiguousarray(pcm), int(info.samplerate)


SFC_SET_COMPRESSION_LEVEL = 0x1301


def encode_flac(
    samples: np.ndarray, sample_rate: int, bit_depth: int,
    compression_level: Optional[int] = None,
) -> bytes:
    """Encode PCM with the canonical libFLAC (via libsndfile): independent
    encoder output for decoder validation. ``samples`` int32 [channels, n]
    right-justified at ``bit_depth`` (8/16/24 supported by libFLAC 1.3).

    ``compression_level`` selects the canonical preset 0..8 (``flac -N``):
    libsndfile maps its 0.0–1.0 knob to ``lrint(x * 8)`` (flac.c,
    SFC_SET_COMPRESSION_LEVEL), so level N ships as N/8. None keeps the
    library default (level 5)."""
    lib = load()
    if lib is None:
        raise RuntimeError("libsndfile unavailable")
    if bit_depth not in _SUB_FOR_DEPTH:
        raise ValueError(f"unsupported depth {bit_depth}")
    c, n = samples.shape
    info = _SFInfo()
    info.samplerate = sample_rate
    info.channels = c
    info.format = SF_FORMAT_FLAC | _SUB_FOR_DEPTH[bit_depth]
    path = tempfile.mktemp(suffix=".flac")
    h = lib.sf_open(path.encode(), SFM_WRITE, ctypes.byref(info))
    if not h:
        raise RuntimeError(
            "libFLAC writer open failed: "
            + lib.sf_strerror(None).decode(errors="replace")
        )
    try:
        if compression_level is not None:
            if not 0 <= compression_level <= 8:
                raise ValueError(f"compression level {compression_level}")
            knob = ctypes.c_double(compression_level / 8.0)
            lib.sf_command(
                h, SFC_SET_COMPRESSION_LEVEL, ctypes.byref(knob),
                ctypes.sizeof(knob),
            )
        # right-justified -> left-justified 32-bit interleaved
        inter = np.ascontiguousarray(
            (samples.T.astype(np.int32)) << np.int32(32 - bit_depth)
        )
        wrote = lib.sf_writef_int(
            h, inter.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n
        )
        if wrote != n:
            raise RuntimeError(f"short write: {wrote}/{n} frames")
    finally:
        lib.sf_close(h)
    try:
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
