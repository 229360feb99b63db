"""Batched frame-header construction on torch tensors.

A FLAC frame header is byte-aligned: 2 sync bytes, 1 byte of
(block-size|rate) codes, 1 byte of (channel|depth) codes, a 1-7 byte
UTF-8-style frame number, optional uncommon-size tail bytes, and a CRC-8.
Only the channel code, frame number and CRC-8 vary per frame, so the header
builds as a small [N, 16] byte tensor (reference:
libFLAC/FrameWriter.zig:136-247).

The uncommon-sample-rate tail reproduces the reference's bug of writing
``block_size`` instead of the rate (FrameWriter.zig:240-244), masked to the
field width.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ..crc import CRC8_TABLE

MAX_HEADER_BYTES = 16

RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


class HeaderStatic(NamedTuple):
    """Per-run static header pieces."""

    byte2: int          # (block_size_code << 4) | rate_code
    depth_code: int
    tail_bytes: List[int]  # uncommon block-size + sample-rate tail bytes


def header_static(block_size: int, sample_rate: int, bit_depth: int) -> HeaderStatic:
    # block size code (FrameWriter.zig:149-169, incl. the dead 144*2^n branch)
    ctz = _ctz(block_size)
    bs_tail: List[int] = []
    if block_size == (1 << ctz) and 8 <= ctz <= 15:
        bs_code = ctz
    elif block_size == 192:
        bs_code = 1
    elif (block_size >> ctz) == 144 and 2 <= ctz <= 5:
        bs_code = ctz
    elif block_size < 0x100:
        bs_code = 0b0110
        bs_tail = [(block_size - 1) & 0xFF]
    else:
        bs_code = 0b0111
        bs_tail = [((block_size - 1) >> 8) & 0xFF, (block_size - 1) & 0xFF]

    sr_tail: List[int] = []
    if sample_rate == 0:
        rate_code = 0
    elif sample_rate in RATE_CODES:
        rate_code = RATE_CODES[sample_rate]
    elif sample_rate <= 255:
        rate_code = 12
        sr_tail = [block_size & 0xFF]  # reference bug preserved
    elif sample_rate <= 65535:
        rate_code = 13
        v = block_size & 0xFFFF
        sr_tail = [(v >> 8) & 0xFF, v & 0xFF]
    else:
        rate_code = 14
        v = (block_size // 10) & 0xFFFF
        sr_tail = [(v >> 8) & 0xFF, v & 0xFF]

    # 12/20-bit are extensions (the reference hits `unreachable`,
    # libFLAC/FrameWriter.zig:202-214); any other 4-32-bit depth encodes
    # via frame depth code 0b000 (depth-from-STREAMINFO, FLAC spec §9.1.3)
    # — the reference merely ACCEPTS those WAVs (src/WavReader.zig:140-143)
    # and then crashes, so this strictly dominates its envelope.
    if not 4 <= bit_depth <= 32:
        raise ValueError(f"bit depth {bit_depth} cannot be frame-encoded")
    depth_codes = {8: 2, 12: 4, 16: 8, 20: 10, 24: 12, 32: 14}
    return HeaderStatic(
        byte2=(bs_code << 4) | rate_code,
        depth_code=depth_codes.get(bit_depth, 0),
        tail_bytes=bs_tail + sr_tail,
    )


def utf8_frame_number_bytes(fn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes i64 [N, 7], length i64 [N]): the reference's UTF-8-style coded
    frame number (FrameWriter.zig:216-232). Byte 0 is the leading byte."""
    fn = fn.to(torch.int64)
    # values <= 0x7F are one raw byte (FrameWriter.zig:216-217); else the
    # continuation count is the number of i where (fn >> 6i) > (63 >> i)
    single = fn <= 0x7F
    i_cont = torch.zeros_like(fn)
    for i in range(7):
        i_cont += ((fn >> (6 * i)) > (63 >> i)).to(torch.int64)
    length = torch.where(single, 1, i_cont + 1)
    lead = torch.where(
        single, fn, ((0xFE << (6 - i_cont)) | (fn >> (6 * i_cont))) & 0xFF
    )
    cols = [lead]
    for j in range(1, 7):
        shift = (6 * (i_cont - j)).clamp(min=0)
        cols.append(0x80 | ((fn >> shift) & 0x3F))
    return torch.stack(cols, dim=-1), length


# CRC8_TABLE on each device it was asked for: one host copy a device, not
# one a batch (a pageable copy waits for the card)
_CRC8_TABLES: dict = {}


def _crc8_table(dev: torch.device) -> torch.Tensor:
    table = _CRC8_TABLES.get(dev)
    if table is None:
        table = _CRC8_TABLES[dev] = torch.from_numpy(CRC8_TABLE.astype("int64")).to(dev)
    return table


def build_headers(
    frame_numbers: torch.Tensor,
    channels_code: torch.Tensor,
    static: HeaderStatic,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(header_bytes i64 [N, 16], header_len i64 [N]) including the CRC-8."""
    n = frame_numbers.shape[0]
    dev = frame_numbers.device
    fn_bytes, fn_len = utf8_frame_number_bytes(frame_numbers)
    idx = torch.arange(MAX_HEADER_BYTES, device=dev).expand(n, MAX_HEADER_BYTES)

    b = torch.zeros((n, MAX_HEADER_BYTES), dtype=torch.int64, device=dev)
    b[:, 0] = 0xFF
    b[:, 1] = 0xF8
    b[:, 2] = static.byte2
    b[:, 3] = (channels_code.to(torch.int64) << 4) | static.depth_code
    fn_pos = idx - 4
    in_fn = (fn_pos >= 0) & (fn_pos < fn_len[:, None])
    b = torch.where(in_fn, fn_bytes.gather(1, fn_pos.clamp(0, 6)), b)
    tail_start = 4 + fn_len
    for tt, tv in enumerate(static.tail_bytes):
        b = torch.where(idx == (tail_start + tt)[:, None], tv, b)
    crc_pos = tail_start + len(static.tail_bytes)

    # CRC-8 over bytes [0, crc_pos): the plain table form
    table = _crc8_table(dev)
    crc = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(MAX_HEADER_BYTES - 1):
        crc = torch.where(j < crc_pos, table[crc ^ b[:, j]], crc)
    b = torch.where(idx == crc_pos[:, None], crc[:, None], b)
    return b, crc_pos + 1
