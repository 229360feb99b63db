"""Optional C++ host runtime (native/zf_native.cpp) with Python fallbacks.

The accelerator owns the compute path; this module covers the serial host
runtime the reference implements natively: MD5 over raw PCM bytes, CRC
tables, WAV de-interleave, and frame-stream assembly. The extension is
``_zf_native`` where it was built in place (``python native/setup.py
build_ext --inplace``), else the port's own g++ build of the same source
(``_host_runtime.py``, built at the first import in a checkout). Falls back
to hashlib/numpy implementations where neither exists: a machine without
g++ or ``Python.h``.
"""

from __future__ import annotations

import hashlib

import numpy as np

try:
    from ._host_runtime import module as _n

    HAVE_NATIVE = True
except ImportError:  # pragma: no cover - environment dependent
    _n = None
    HAVE_NATIVE = False


def md5(data) -> bytes:
    if _n is not None:
        return _n.md5(data)
    return hashlib.md5(data).digest()


class Md5Stream:
    """Incremental MD5 over the raw PCM byte stream — the streaming feeder's
    hash (the reference hashes block-by-block as it encodes,
    src/wav2flac.zig:64-75). Uses the native context when built, hashlib
    otherwise; both produce the digest ``md5()`` would over the
    concatenation."""

    __slots__ = ("_ctx", "_h")

    def __init__(self) -> None:
        if _n is not None and hasattr(_n, "md5_init"):
            self._ctx = _n.md5_init()
            self._h = None
        else:
            self._ctx = None
            self._h = hashlib.md5()

    def update(self, data) -> None:
        if self._ctx is not None:
            self._ctx = _n.md5_update(self._ctx, data)
        else:
            self._h.update(data)

    def digest(self) -> bytes:
        if self._ctx is not None:
            return _n.md5_final(self._ctx)
        return self._h.copy().digest()


def crc16(data, init: int = 0) -> int:
    if _n is not None:
        return _n.crc16(data, init)
    from .crc import crc16 as _py

    return _py(bytes(data), init)


def crc8(data, init: int = 0) -> int:
    if _n is not None:
        return _n.crc8(data, init)
    from .crc import crc8 as _py

    return _py(bytes(data), init)


def deinterleave(data, channels: int, bytes_per_sample: int, bit_depth: int,
                 n_samples: int) -> np.ndarray:
    """Raw interleaved LE PCM bytes -> planar [channels, n] int32 with the
    reference WavReader's top-justify / subtract / sign-extend semantics."""
    if _n is not None:
        raw = _n.deinterleave(bytes(data), channels, bytes_per_sample, bit_depth)
        return np.frombuffer(raw, dtype=np.int32).reshape(channels, n_samples)
    # numpy fallback (same as WavReader.planar_samples core)
    b = np.frombuffer(data, dtype=np.uint8).reshape(
        n_samples, channels, bytes_per_sample
    )
    top = np.zeros((n_samples, channels, 4), dtype=np.uint8)
    top[:, :, 4 - bytes_per_sample:] = b
    s = top.view("<u4").reshape(n_samples, channels).astype(np.uint32)
    s = s.view(np.int32).T.copy()
    if bytes_per_sample == 1:
        s -= np.int32(128 >> (8 - bit_depth))
    if bit_depth != 32:
        s >>= np.int32(32 - bit_depth)
    return s


def assemble_ranges(stream_words_be: bytes, word_offsets: np.ndarray,
                    byte_lens: np.ndarray) -> bytes:
    """Word-aligned concatenated frame stream -> exact byte concatenation
    (drops the <=3 alignment pad bytes after each frame)."""
    offs = np.ascontiguousarray(word_offsets.astype(np.int64))
    lens = np.ascontiguousarray(byte_lens.astype(np.int64))
    if _n is not None:
        return _n.assemble_ranges(stream_words_be, offs.tobytes(), lens.tobytes())
    out = bytearray()
    for o, L in zip(offs.tolist(), lens.tolist()):
        out += stream_words_be[4 * o : 4 * o + L]
    return bytes(out)


def assemble_frames(words: np.ndarray, byte_lens: np.ndarray,
                    crcs: np.ndarray) -> bytes:
    """Padded per-frame words (u32 MSB-first) + lengths + CRC-16s -> one
    contiguous frame-stream byte string."""
    w_be = np.ascontiguousarray(words.astype(">u4"))
    lens = np.ascontiguousarray(byte_lens.astype(np.int64))
    c = np.ascontiguousarray(crcs.astype(np.uint32))
    if _n is not None:
        return _n.assemble(w_be.tobytes(), words.shape[1] * 4, lens.tobytes(),
                           c.tobytes())
    raw = w_be.tobytes()
    stride = words.shape[1] * 4
    out = bytearray()
    for i in range(words.shape[0]):
        L = int(lens[i])
        out += raw[i * stride : i * stride + L]
        out += int(c[i]).to_bytes(2, "big")
    return bytes(out)
