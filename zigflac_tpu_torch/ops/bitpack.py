"""Bitstream packing on torch tensors: prefix-sum bit offsets + one deposit.

The reference packs bits serially through a u64 buffer
(libFLAC/FrameWriter.zig:36-114). Here the whole frame becomes one symbol
tensor: every field of the frame (header bytes, subframe headers, warmup
samples, Rice params, every residual code) is one symbol with

    nb  — total field width in bits (a Rice code's width includes its
          unary quotient run),
    val — the deposited value, right-aligned in the field (the quotient's
          zeros and the 1-terminator + remainder are ``(1<<k) | rem`` at the
          field's end),
    nbv — the deposited value's width.

An inclusive prefix sum of ``nb`` gives every field's end bit, and the
deposit (``ops/deposit.py``: a CUDA kernel on the card, its plain version on
the CPU) ORs every value into the frame's MSB-first u32 words. Masked-off
symbols have nb = 0 and deposit nothing. Words travel as int32 holding the
u32 bit pattern.

The functions here up to ``frame_symbol_stream`` are the symbols stage's
plain version; ``pack_frames`` takes the stage through ``ops/symbols.py``,
which launches the kernel on a CUDA plan.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import deposit, symbols
from .analyze import FrameWirePlan, bit_length, zigzag_u32
from .header import MAX_HEADER_BYTES, HeaderStatic, build_headers
from ..utils import stages
from ..utils.config import MAX_FIXED_ORDER

# Compacted frames start on ALIGN_W-word (512-byte) boundaries, mirrored by
# the host offsets in models/pipeline._collect_aligned and by
# max_frame_words' rounding. The pad never reaches the FLAC bytes.
ALIGN_W = 128


def _mask(nbits: torch.Tensor) -> torch.Tensor:
    """(1 << nbits) - 1 for nbits in [0, 62]."""
    return (1 << nbits) - 1


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same bit pattern."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def channel_symbols(
    kind: torch.Tensor,         # [N]: 0 const, 1 verbatim, 2 fixed, 3 lpc
    order: torch.Tensor,        # [N]
    method: torch.Tensor,       # [N]
    part_order: torch.Tensor,   # [N]
    sample_size: torch.Tensor,  # [N]
    params: torch.Tensor,       # [N, 256]
    plane: torch.Tensor,        # i32 or i64 [N, B]
    residuals: torch.Tensor,    # i32 [N, B]
    qcoeffs: torch.Tensor,      # [N, 32] quantized LPC coefficients
    qshift: torch.Tensor,       # [N] LPC coefficient shift
    wasted: torch.Tensor,       # [N] shaved bits (extension)
    block_size: int,
    max_rice_order: int,
    lpc_order: int,             # analyze.lpc_order_of(config); 0: LPC off
    lpc_precision: int,
):
    """Symbols of one subframe: header byte, (wasted-bits unary), warmup,
    (LPC precision/shift and coefficients), method/part-order, then per
    grid group one partition-param column and its residual codes
    (reference serializers: FrameWriter.zig:251-361; the LPC layout is the
    FLAC format's, the reference stubs it). Returns int64 (widths [N, S],
    deposit values, deposit value bits)."""
    n, B = plane.shape
    dev = plane.device
    is_const = kind == 0
    is_verb = kind == 1
    is_lpc = kind == 3
    is_pred = (kind == 2) | is_lpc
    ss = sample_size
    p64 = plane.to(torch.int64)
    nb_cols, val_cols, nbv_cols = [], [], []

    def add(nb, val, nbv):
        nb_cols.append(nb)
        val_cols.append(val)
        nbv_cols.append(nbv)

    # subframe header byte (bit 0 = wasted-bits flag), then the unary
    # wasted-bits field: k-1 zeros and a 1 terminator (k bits in all)
    hdr = torch.where(
        is_const, 0,
        torch.where(is_verb, 2, torch.where(is_lpc, (0x20 | (order - 1)) << 1, (8 | order) << 1)),
    )
    hdr = hdr | (wasted > 0).to(torch.int64)
    eight = torch.full((n, 1), 8, dtype=torch.int64, device=dev)
    add(eight, hdr[:, None], eight)
    wb_nb = torch.where(wasted > 0, wasted, 0)[:, None]
    add(wb_nb, (wb_nb > 0).to(torch.int64), (wb_nb > 0).to(torch.int64))

    # warmup samples; a frame of B <= max(4, lpc_order) samples is never
    # predicted, and slicing min(B, ...) columns keeps short frames in shape
    mw = min(B, max(MAX_FIXED_ORDER, lpc_order))
    w_idx = torch.arange(mw, device=dev)
    w_active = is_pred[:, None] & (w_idx < order[:, None])
    w_nb = torch.where(w_active, ss[:, None], 0)
    add(w_nb, p64[:, :mw] & _mask(w_nb), w_nb)

    if lpc_order:
        # precision-1 (4 bits) and shift (5 bits), then ``order``
        # coefficients of ``lpc_precision`` bits each
        ps_nb = torch.where(is_lpc, 9, 0)[:, None]
        add(ps_nb, torch.where(is_lpc, ((lpc_precision - 1) << 5) | qshift, 0)[:, None], ps_nb)
        c_idx = torch.arange(lpc_order, device=dev)
        c_nb = torch.where(is_lpc[:, None] & (c_idx < order[:, None]), lpc_precision, 0)
        add(c_nb, qcoeffs[:, :lpc_order] & _mask(c_nb), c_nb)

    # method(2) + partition order(4)
    m_nb = torch.where(is_pred, 6, 0)[:, None]
    add(m_nb, torch.where(is_pred, (method << 4) | part_order, 0)[:, None], m_nb)

    # per-partition escape analysis at the chosen partition order: bps is
    # 0 for an all-zero partition, else the bit length of its widest
    # |residual| (posmag: r ^ (r >> 31)) plus the sign bit
    po_top = min(max_rice_order, (B & -B).bit_length() - 1)
    G = B >> po_top
    posmag = (residuals ^ (residuals >> 31)).to(torch.int64)
    top_max = posmag.reshape(n, 1 << po_top, G).amax(-1)
    top_any = (residuals != 0).reshape(n, 1 << po_top, G).any(-1)
    lv_max, lv_any = [top_max], [top_any]
    for _ in range(po_top):
        lv_max.insert(0, torch.maximum(lv_max[0][:, 0::2], lv_max[0][:, 1::2]))
        lv_any.insert(0, lv_any[0][:, 0::2] | lv_any[0][:, 1::2])
    pad = lambda x: torch.nn.functional.pad(x, (0, 256 - x.shape[1]))
    sel = part_order[None, :, None].expand(1, n, 256)
    res_max = torch.stack([pad(x) for x in lv_max]).gather(0, sel)[0]
    any_nz = torch.stack([pad(x) for x in lv_any]).gather(0, sel)[0]
    bps = torch.where(~any_nz, 0, bit_length(res_max) + 1)

    param_len = (4 + method)[:, None]
    escape_code = (1 << (4 + method))[:, None] - 1
    is_esc = params == escape_code
    fallback = is_esc & (bps >= 32)
    esc_live = is_esc & ~fallback
    eff_param = torch.where(fallback, 30, params)
    packed = (
        params | (eff_param << 5) | (esc_live.to(torch.int64) << 10)
        | (fallback.to(torch.int64) << 11) | (bps << 12)
    )
    # each sample's partition, then its partition's packed fields
    r_idx = torch.arange(B, device=dev)
    psize = B >> part_order
    per_sample = packed.gather(1, r_idx[None, :] // psize[:, None])
    param_i = per_sample & 31
    k = (per_sample >> 5) & 31
    r_esc = ((per_sample >> 10) & 1) == 1
    r_fallback = ((per_sample >> 11) & 1) == 1
    r_bps = (per_sample >> 12) & 63

    zz = zigzag_u32(residuals)
    rice_nb = (zz >> k) + k + 1
    rice_val = (1 << k) | (zz & _mask(k))
    esc_val = residuals.to(torch.int64) & _mask(r_bps)

    r_active = is_pred[:, None] & (r_idx >= order[:, None])
    fx_nb = torch.where(r_active, torch.where(r_esc, r_bps, rice_nb), 0)
    fx_nbv = torch.where(r_active, torch.where(r_esc, r_bps, k + 1), 0)
    fx_val = torch.where(r_active, torch.where(r_esc, esc_val, rice_val), 0)

    vb_nb = ss[:, None].expand(n, B)
    vb_val = p64 & _mask(vb_nb)
    first = r_idx == 0
    ct_nb = torch.where(first, ss[:, None], 0)
    ct_val = torch.where(first, vb_val, 0)

    verb, const = is_verb[:, None], is_const[:, None]
    s_nb = torch.where(verb, vb_nb, torch.where(const, ct_nb, fx_nb))
    s_nbv = torch.where(verb, vb_nb, torch.where(const, ct_nb, fx_nbv))
    s_val = torch.where(verb, vb_val, torch.where(const, ct_val, fx_val))

    # Every partition start lies on the grid of multiples of G, so one
    # param column per grid point, placed before its G residual columns,
    # puts each partition's param where the wire needs it.
    starts = r_idx[None, ::G] % psize[:, None] == 0
    slot = is_pred[:, None] & starts
    plen = torch.where(r_esc, param_len + 5, param_len)[:, ::G]
    vparam = torch.where(
        r_esc, (param_i << 5) | r_bps, torch.where(r_fallback, 30, param_i)
    )[:, ::G]
    pg_nb = torch.where(slot, plen, 0)
    pg_val = torch.where(slot, vparam, 0)

    n_grid = 1 << po_top

    def inter(pg, s):
        return torch.cat([pg[:, :, None], s.reshape(n, n_grid, G)], 2).reshape(n, -1)

    add(inter(pg_nb, s_nb), inter(pg_val, s_val), inter(pg_nb, s_nbv))
    return torch.cat(nb_cols, 1), torch.cat(val_cols, 1), torch.cat(nbv_cols, 1)


def header_symbols(header_bytes: torch.Tensor, header_len: torch.Tensor):
    idx = torch.arange(MAX_HEADER_BYTES, device=header_bytes.device)
    nb = torch.where(idx < header_len[:, None], 8, 0)
    return nb, torch.where(nb > 0, header_bytes, 0), nb


def frame_symbol_stream(
    plan: FrameWirePlan,
    frame_numbers: torch.Tensor,
    hstatic: HeaderStatic,
    block_size: int,
    max_rice_order: int,
    lpc_order: int,
    lpc_precision: int,
):
    """The whole-frame deposit stream: header bytes + every channel's
    subframe symbols, with the offset prefix sum. ``lpc_order`` is
    ``analyze.lpc_order_of(config)``. Returns int64
    (dep_cum [N, S], total_bits [N], dep_val [N, S], dep_nbv [N, S]):
    ``dep_cum`` is each field's end bit."""
    hb, hlen = build_headers(frame_numbers, plan.channels_code, hstatic)
    parts = [header_symbols(hb, hlen)]
    for c in range(plan.kind.shape[0]):  # plan arrays are wire-major
        parts.append(channel_symbols(
            plan.kind[c], plan.order[c], plan.method[c], plan.part_order[c],
            plan.sample_size[c], plan.params[c], plan.planes[c],
            plan.residuals[c], plan.qcoeffs[c], plan.qshift[c], plan.wasted[c],
            block_size, max_rice_order, lpc_order, lpc_precision,
        ))
    nb, val, nbv = (torch.cat(cols, 1) for cols in zip(*parts))
    dep_cum = nb.cumsum(1)
    return dep_cum, dep_cum[:, -1], val, nbv


def pack_frames(
    plan: FrameWirePlan,
    frame_numbers: torch.Tensor,
    hstatic: HeaderStatic,
    block_size: int,
    max_rice_order: int,
    max_words: int,
    lpc_order: int,
    lpc_precision: int,
):
    """Full frames (header + subframes) -> (words int32 [N, max_words],
    total_bits int64 [N]). Deposits past ``max_words`` are dropped; the
    caller sees the frame's size in ``total_bits`` and re-encodes at a
    larger capacity. ``lpc_order`` is ``analyze.lpc_order_of(config)``."""
    dep_cum, total_bits, dep_val, dep_nbv = symbols.frame_symbols(
        plan, frame_numbers, hstatic, block_size, max_rice_order,
        lpc_order, lpc_precision,
    )
    stages.mark("symbols")
    words = deposit.deposit_words(dep_cum, dep_val, dep_nbv, max_words)
    stages.mark("deposit")
    return words, total_bits


def deposit_crc16(
    words: torch.Tensor, byte_len: torch.Tensor, crcs: torch.Tensor
) -> torch.Tensor:
    """OR each frame's big-endian CRC-16 into the two bytes at byte_len
    (the pad bytes there are zero). A position past the row is dropped."""
    n, w = words.shape
    rows = torch.arange(n, device=words.device)
    words = words.clone()
    for byte_val, pos in (((crcs >> 8) & 0xFF, byte_len), (crcs & 0xFF, byte_len + 1)):
        wi = pos >> 2
        inside = wi < w
        wi = wi.clamp(max=w - 1)
        cur = words[rows, wi].to(torch.int64) & 0xFFFFFFFF
        new = cur | (byte_val << (8 * (3 - (pos & 3))))
        words[rows, wi] = u32_to_i32(torch.where(inside, new, cur))
    return words


def compact_stream_aligned(
    words: torch.Tensor, frame_bytes: torch.Tensor, capw: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate each frame's used words, its bytes rounded up to
    ALIGN_W-word groups, into one dense int32 stream.

    Returns (stream int32 [ceil(capw / ALIGN_W) * ALIGN_W], total_words).
    The caller checks total_words against the stream size. The host
    offsets in models/pipeline._collect_aligned mirror this layout.
    """
    n, W = words.shape
    if W % ALIGN_W:
        raise ValueError("frame word capacity must be ALIGN_W-aligned")
    Wg = W // ALIGN_W
    capg = -(-capw // ALIGN_W)
    dev = words.device
    gcnt = (frame_bytes + 4 * ALIGN_W - 1) // (4 * ALIGN_W)
    goff = gcnt.cumsum(0) - gcnt
    total_g = goff[-1] + gcnt[-1]
    g = torch.arange(capg, device=dev)
    f = torch.searchsorted(goff, g, right=True) - 1  # frame of each group
    j = g - goff[f]  # group index inside its frame
    src = (f * Wg + j).clamp(0, n * Wg - 1)
    rows = words.reshape(n * Wg, ALIGN_W)[src]
    out = torch.where((g < total_g)[:, None], rows, 0)
    return out.reshape(-1), total_g * ALIGN_W


def max_frame_words(
    block_size: int, n_wire: int, depth: int, ratio: float | None = None
) -> int:
    """Static per-frame word capacity.

    ``ratio=None`` gives the provable worst case: actual Rice bits can
    exceed the flake estimate by at most ~part_size/2 per partition (the
    estimate is a truncated mean), so estimate < verbatim(bits_of_t * B)
    implies actual < (bits_of_t + 6) * B + headers.

    A float ratio gives a practical capacity of ``ratio`` x the frame's raw
    PCM bytes + header slack — packing and CRC cost scale with this, and
    overflowing frames are detected and re-run at the exact capacity.
    """
    if ratio is not None:
        raw = block_size * n_wire * max(depth, 8) // 8
        per_ch_overhead = 8 + 32 * 34 + 9 + 32 * 15 + 6 + 256 * 10
        total_bits = (
            MAX_HEADER_BYTES * 8
            + int(raw * 8 * ratio)
            + n_wire * per_ch_overhead
            + 64
        )
        return -(-((total_bits + 31) // 32) // ALIGN_W) * ALIGN_W
    bits_of_t = 64 if depth == 32 else 32
    per_ch = (
        8 + 32 * 34 + 9 + 32 * 15 + 6 + 256 * 10
        + block_size * (bits_of_t + 6)
    )
    total_bits = MAX_HEADER_BYTES * 8 + n_wire * per_ch + 64
    # rounded to the compaction alignment so per-frame rows regroup exactly
    return -(-((total_bits + 31) // 32) // ALIGN_W) * ALIGN_W
