"""Parallel CRC-16/UMTS over packed frame words (libFLAC/Crc16.zig).

CRC is GF(2)-linear: CRC(M) = sum_i b_i(x) * x^(8*(L-1-i)+16) mod G. Over
the fixed-width padded word buffer every byte position has a static
distance from the end, so each word's contribution is a carry-less product
with a per-column constant. The CRC of the real (shorter) frame follows by
multiplying with x^(-8*pad) mod G, one 16x16 GF(2) product per frame.

That is the plain version. ``crc16_frames`` routes by device: a CUDA tensor
launches the hand-written kernel ``zf_crc16_frames`` (``csrc/crc16.cu``, one
CTA a frame; it ORs the CRC bytes into the words in place) or raises, a CPU
tensor takes ``crc16_words`` and ``bitpack.deposit_crc16``.
``KERNEL_LAUNCHES`` and ``PLAIN_CALLS`` count each.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..crc import CRC16_POLY, xpow_neg8_table, xpow_shift_table
from .bitpack import deposit_crc16

KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def reset_counts() -> None:
    global KERNEL_LAUNCHES, PLAIN_CALLS
    KERNEL_LAUNCHES = 0
    PLAIN_CALLS = 0


@lru_cache(maxsize=16)
def _tables(max_bytes: int):
    """(t_hi [W], t_lo [W], inv [max_bytes + 1]) as numpy int64: the
    multipliers of each word's high and low 16-bit halves, and x^(-8k)."""
    tpos = xpow_shift_table(max_bytes)[::-1].astype(np.int64)
    return tpos[1::4].copy(), tpos[3::4].copy(), xpow_neg8_table(max_bytes).astype(np.int64)


def _tree_xor(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis (torch has no XOR reduction)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def _reduce31(acc: torch.Tensor) -> torch.Tensor:
    """A carry-less product of two 16-bit polynomials (< 2^31) mod G."""
    for i in range(30, 15, -1):
        acc = torch.where((acc >> i) & 1 == 1, acc ^ (CRC16_POLY << (i - 16)), acc)
    return acc


def _clmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less product of 16-bit operands, unreduced (< 2^31)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.int64,
                      device=a.device)
    for i in range(16):
        acc ^= torch.where((a >> i) & 1 == 1, b << i, 0)
    return acc


def crc16_words(words: torch.Tensor, byte_len: torch.Tensor) -> torch.Tensor:
    """CRC-16/UMTS of the first ``byte_len`` bytes of each frame.

    ``words``: int32 [N, W] holding u32 bit patterns, MSB-first stream;
    bytes at and beyond ``byte_len`` must be zero. Returns int64 [N].
    """
    n, w = words.shape
    max_bytes = w * 4
    t_hi, t_lo, inv = (torch.from_numpy(t).to(words.device) for t in _tables(max_bytes))
    wd = words.to(torch.int64)
    hi = (wd >> 16) & 0xFFFF
    lo = wd & 0xFFFF
    # XOR never carries, so reducing mod G once per frame after the XOR
    # tree equals reducing every word's product first
    crc = _reduce31(_tree_xor(_clmul16(hi, t_hi) ^ _clmul16(lo, t_lo)))
    # cancel the zero padding; an over-budget frame (byte_len > max_bytes)
    # gets a meaningless CRC and is re-encoded at a larger capacity
    pad = (max_bytes - byte_len.to(torch.int64)).clamp(0, max_bytes)
    return _reduce31(_clmul16(crc, inv[pad]))


def crc16_frames_plain(words: torch.Tensor, byte_len: torch.Tensor, write: bool = True):
    """``crc16_frames`` as plain torch ops; the words come back as a copy."""
    crcs = crc16_words(words, byte_len)
    return crcs, deposit_crc16(words, byte_len, crcs) if write else words


def crc16_frames(words: torch.Tensor, byte_len: torch.Tensor, write: bool = True):
    """(crcs int64 [N], words): the CRC-16 of each frame's first
    ``byte_len`` bytes (words int32 [N, W], MSB-first, zero at and past
    ``byte_len``; byte_len int64 [N]) and, with ``write``, the words with
    the CRC's two bytes ORed in big-endian at ``byte_len`` (a position past
    the row is dropped). On a CUDA device the kernel updates ``words`` in
    place and returns it; on the CPU the plain version returns a copy. A
    frame over the row (byte_len > 4W) gets a CRC its caller must not
    read."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if words.dim() != 2 or tuple(byte_len.shape) != (words.shape[0],):
        raise ValueError(f"words must be [N, W] and byte_len [N], got {tuple(words.shape)} "
                         f"and {tuple(byte_len.shape)}")
    for name, t, dt in (("words", words, torch.int32), ("byte_len", byte_len, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.shape[1] < 1:
        raise ValueError("words must have at least one column")
    if words.device.type == "cpu":
        PLAIN_CALLS += 1
        return crc16_frames_plain(words, byte_len, write)
    if words.device.type != "cuda":
        raise NotImplementedError(f"no CRC-16 kernel for device {words.device}")
    from ._build import library

    lib = library()
    n, w = words.shape
    crcs = torch.empty(n, dtype=torch.int64, device=words.device)
    with torch.cuda.device(words.device):
        err = lib.zf_crc16_frames(words.data_ptr(), byte_len.data_ptr(), n, w, bool(write),
                                  crcs.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CRC-16 kernel launch failed: {lib.zf_error_string(err).decode()}")
    KERNEL_LAUNCHES += 1
    return crcs, words
