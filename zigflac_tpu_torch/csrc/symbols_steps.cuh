// Per-column arithmetic of the frame symbols kernel (symbols.cu), shared with
// a host build that the CPU tests compile with g++.
//
// A frame's symbol stream is the plain version's (ops/bitpack.py
// frame_symbol_stream, channel_symbols, header_symbols; ops/header.py
// build_headers), column by column, zero-width columns included:
//
//   16 header columns (8 bits each up to the header's length, CRC-8 last),
//   then for each wire channel C = chan_cols columns:
//     0               subframe header byte (bit 0: wasted-bits flag)
//     1               wasted-bits unary field (`wasted` bits, value 1)
//     2 .. 2+mw       warmup samples, mw = min(B, max(4, lpc_order))
//     (LPC on)        precision-1 and shift (9 bits), lpc_order coefficients
//     r0 - 1          method (2 bits) and partition order (4 bits)
//     r0 ..           n_grid groups: one param column, then G residual codes
//
// with po_top = min(max_rice_order, ctz(B)), n_grid = 2^po_top and G = B >>
// po_top. Every partition at the chosen order starts on a grid point, so a
// grid point's param column is live where it starts a partition of a
// predicted subframe.
//
// A symbol is (nb, val, nbv): the field's width in bits (a Rice code's
// width includes its unary run, so nb can reach 2^32 + 31), the value
// deposited right-aligned at the field's end, and the value's width. The
// kernel writes the inclusive prefix sum of nb in 64 bits and stores its low
// 32 bits (the plain version's `.to(torch.int32)`), val in int64 and nbv in
// int32: the deposit kernel's inputs (ops/deposit.py).
//
// Escapes: a partition's bps is 0 where all its residuals are zero, else the
// bit length of its widest r ^ (r >> 31) plus the sign bit. The kernel keeps
// one 32-bit key a residual, 0 for r == 0 and (r ^ (r >> 31)) + 1 otherwise
// (at most 2^31), and takes the partition's largest: bps follows from it
// alone. An escape param (2^(4 + method) - 1) with bps >= 32 falls back to
// Rice param 30 (the reference's "TODO 32bits bug", ROADMAP sec. 3 N1): its
// param column holds the value 30 in param_len bits, unmasked, as the plain
// version writes it.
//
// Integer policy: every field is the plain version's int64 arithmetic.
// Masks take widths 0..64 without a shift by the full width; no shift count
// here reaches its operand's width.
#pragma once

#include <stdint.h>

#ifndef ZF_HD
#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif
#endif

constexpr int kZfSymHeaderCols = 16;  // MAX_HEADER_BYTES
constexpr int kZfSymParamCols = 256;  // params a plane (partitions of order 8)
constexpr int kZfSymCoeffCols = 32;   // qcoeffs a plane
constexpr int kZfSymMaxFixedOrder = 4;
constexpr int kZfCrc8Poly = 0x07;

struct ZfCrc8Table {
  uint8_t t[256];
};

ZF_HD constexpr ZfCrc8Table zf_crc8_make_table() {
  ZfCrc8Table t{};
  for (int i = 0; i < 256; ++i) {
    uint32_t crc = (uint32_t)i;
    for (int b = 0; b < 8; ++b) crc = crc & 0x80u ? ((crc << 1) ^ kZfCrc8Poly) & 0xFFu : (crc << 1) & 0xFFu;
    t.t[i] = (uint8_t)crc;
  }
  return t;
}

// (1 << n) - 1 for n in [0, 64].
ZF_HD uint64_t zf_sym_mask(int64_t n) {
  return n <= 0 ? 0ull : n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

ZF_HD int zf_sym_bitlen32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 32 - __clz((int)x);
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

ZF_HD int zf_sym_ctz(int64_t v) {
  int c = 0;
  while (v > 0 && !(v & 1)) {
    v >>= 1;
    ++c;
  }
  return c;
}

struct ZfSym {
  int64_t nb;   // field width in bits
  int64_t val;  // value, right-aligned at the field's end
  int32_t nbv;  // value width in bits
};

ZF_HD ZfSym zf_sym_make(int64_t nb, int64_t val, int64_t nbv) {
  ZfSym s;
  s.nb = nb;
  s.val = val;
  s.nbv = (int32_t)nbv;
  return s;
}

// The static layout of one launch's frames.
struct ZfSymLayout {
  int64_t w, b;                    // wire channels, block size
  int64_t mw, lpc_order, lpc_precision;
  int64_t po_top, g;               // top partition order, samples a grid group
  int64_t r0, chan_cols, s;        // first residual-section column, columns a channel, a frame
};

ZF_HD ZfSymLayout zf_sym_layout(int64_t w, int64_t b, int64_t max_rice_order, int64_t lpc_order,
                                int64_t lpc_precision) {
  ZfSymLayout l;
  l.w = w;
  l.b = b;
  const int64_t warm = lpc_order > kZfSymMaxFixedOrder ? lpc_order : kZfSymMaxFixedOrder;
  l.mw = b < warm ? b : warm;
  l.lpc_order = lpc_order;
  l.lpc_precision = lpc_precision;
  const int64_t ctz = zf_sym_ctz(b);
  l.po_top = max_rice_order < ctz ? max_rice_order : ctz;
  l.g = b >> l.po_top;
  l.r0 = 2 + l.mw + (lpc_order ? 1 + lpc_order : 0) + 1;
  l.chan_cols = l.r0 + ((int64_t)1 << l.po_top) * (l.g + 1);
  l.s = kZfSymHeaderCols + w * l.chan_cols;
  return l;
}

// The static header pieces (ops/header.py HeaderStatic): byte 2, the depth
// code, and up to four tail bytes, tail byte t in bits 8t..8t+7 of `tail`.
struct ZfSymHeaderStatic {
  int64_t byte2, depth_code, tail, ntail;
};

struct ZfSymHeader {
  int64_t bytes[kZfSymHeaderCols];
  int64_t len;
};

// A frame header: sync, codes, the UTF-8 frame number
// (ops/header.py utf8_frame_number_bytes), the tail bytes and the CRC-8 of
// bytes [0, crc_pos) at crc_pos; bytes past it 0. Frame numbers are below
// 2^36 (seven bytes at most).
ZF_HD ZfSymHeader zf_sym_header(int64_t fn, int64_t channels_code, const ZfSymHeaderStatic& hs,
                                const ZfCrc8Table& crc8) {
  ZfSymHeader h;
  for (int j = 0; j < kZfSymHeaderCols; ++j) h.bytes[j] = 0;
  h.bytes[0] = 0xFF;
  h.bytes[1] = 0xF8;
  h.bytes[2] = hs.byte2;
  h.bytes[3] = (channels_code << 4) | hs.depth_code;
  const bool single = fn <= 0x7F;
  int64_t i_cont = 0;
  for (int i = 0; i < 7; ++i) i_cont += (fn >> (6 * i)) > (63 >> i);
  const int64_t fn_len = single ? 1 : i_cont + 1;
  const int64_t lead_shift = 6 - i_cont > 0 ? 6 - i_cont : 0;
  h.bytes[4] = single ? fn : ((0xFE << lead_shift) | (fn >> (6 * i_cont))) & 0xFF;
  for (int j = 1; j < fn_len; ++j) {
    const int64_t shift = 6 * (i_cont - j) > 0 ? 6 * (i_cont - j) : 0;
    h.bytes[4 + j] = 0x80 | ((fn >> shift) & 0x3F);
  }
  const int64_t tail_start = 4 + fn_len;
  for (int t = 0; t < hs.ntail; ++t) h.bytes[tail_start + t] = (hs.tail >> (8 * t)) & 0xFF;
  const int64_t crc_pos = tail_start + hs.ntail;
  uint32_t crc = 0;
  for (int j = 0; j < crc_pos; ++j) crc = crc8.t[(crc ^ (uint32_t)h.bytes[j]) & 0xFFu];
  h.bytes[crc_pos] = crc;
  h.len = crc_pos + 1;
  return h;
}

ZF_HD ZfSym zf_sym_header_column(const ZfSymHeader& h, int64_t j) {
  return j < h.len ? zf_sym_make(8, h.bytes[j], 8) : zf_sym_make(0, 0, 0);
}

// One wire channel's fields of one frame, as the plan holds them.
struct ZfSymChannel {
  int64_t kind;  // 0 constant, 1 verbatim, 2 fixed, 3 LPC
  int64_t order, method, part_order, ss, qshift, wasted;
};

ZF_HD bool zf_sym_pred(const ZfSymChannel& c) { return c.kind == 2 || c.kind == 3; }

// A residual's partition key: 0 for r == 0, else (r ^ (r >> 31)) + 1.
ZF_HD uint32_t zf_sym_key(int32_t r) {
  return r == 0 ? 0u : ((uint32_t)(r ^ (r >> 31))) + 1u;
}

// bps of a partition from its largest key.
ZF_HD int64_t zf_sym_bps(uint32_t key) { return key == 0 ? 0 : zf_sym_bitlen32(key - 1u) + 1; }

// The grid groups that one partition at the chosen order spans, as a
// shift: partition p covers groups [p << d, (p + 1) << d).
ZF_HD int64_t zf_sym_part_shift(const ZfSymLayout& l, const ZfSymChannel& c) {
  const int64_t d = l.po_top - c.part_order;
  return d > 0 ? d : 0;
}

// The Rice fields of a partition: its param (low 5 bits), the param its
// codes use (30 in the N1 fallback), and whether it escapes.
struct ZfSymPart {
  int64_t param, k, bps;
  bool live_escape, fallback;
};

ZF_HD ZfSymPart zf_sym_part(const ZfSymChannel& c, int64_t param, uint32_t key) {
  ZfSymPart p;
  p.bps = zf_sym_bps(key);
  const bool is_esc = param == ((int64_t)1 << (4 + c.method)) - 1;
  p.fallback = is_esc && p.bps >= 32;
  p.live_escape = is_esc && !p.fallback;
  p.param = param & 31;
  p.k = (p.fallback ? 30 : param) & 31;
  return p;
}

// Column `col` (0 <= col < chan_cols) of one channel. plane[i * plane_step]
// and res[i * res_step] are sample i; params, qcoeffs and keys are the
// channel's 256 params, 32 coefficients and per-partition largest keys.
template <typename T>
ZF_HD ZfSym zf_sym_column(const ZfSymLayout& l, const ZfSymChannel& c, int64_t col,
                          const T* plane, int64_t plane_step, const int32_t* res,
                          int64_t res_step, const int64_t* params, const int64_t* qcoeffs,
                          const uint32_t* keys) {
  const bool pred = zf_sym_pred(c), lpc = c.kind == 3;
  if (col == 0) {
    const int64_t hdr = c.kind == 0 ? 0
                        : c.kind == 1 ? 2
                        : lpc         ? (0x20 | (c.order - 1)) << 1
                                      : (8 | c.order) << 1;
    return zf_sym_make(8, hdr | (c.wasted > 0), 8);
  }
  if (col == 1) {
    const int64_t nb = c.wasted > 0 ? c.wasted : 0;
    return zf_sym_make(nb, nb > 0, nb > 0);
  }
  if (col < 2 + l.mw) {
    const int64_t j = col - 2;
    const int64_t nb = pred && j < c.order ? c.ss : 0;
    return zf_sym_make(nb, (int64_t)((uint64_t)(int64_t)plane[j * plane_step] & zf_sym_mask(nb)),
                       nb);
  }
  const int64_t m_col = l.r0 - 1;
  if (col < m_col) {  // LPC: precision and shift, then the coefficients
    const int64_t j = col - 2 - l.mw;
    if (j == 0) {
      const int64_t nb = lpc ? 9 : 0;
      return zf_sym_make(nb, lpc ? ((l.lpc_precision - 1) << 5) | c.qshift : 0, nb);
    }
    const int64_t nb = lpc && j - 1 < c.order ? l.lpc_precision : 0;
    return zf_sym_make(nb, (int64_t)((uint64_t)qcoeffs[j - 1] & zf_sym_mask(nb)), nb);
  }
  if (col == m_col) {
    const int64_t nb = pred ? 6 : 0;
    return zf_sym_make(nb, pred ? (c.method << 4) | c.part_order : 0, nb);
  }
  // the residual section: group g, slot 0 its param column, slots 1..G its
  // samples (32-bit division: a channel has fewer than 2^31 columns)
  const uint32_t q = (uint32_t)(col - l.r0), gsz = (uint32_t)(l.g + 1);
  const int64_t g = q / gsz, slot = q - (uint32_t)g * gsz;
  const int64_t d = zf_sym_part_shift(l, c);
  if (slot == 0) {
    const bool starts = (g & (((int64_t)1 << d) - 1)) == 0;
    if (!(pred && starts)) return zf_sym_make(0, 0, 0);
    const int64_t p = g >> d;
    const ZfSymPart pt = zf_sym_part(c, params[p], keys[p]);
    const int64_t plen = 4 + c.method + (pt.live_escape ? 5 : 0);
    const int64_t v = pt.live_escape ? (pt.param << 5) | pt.bps : pt.fallback ? 30 : pt.param;
    return zf_sym_make(plen, v, plen);
  }
  const int64_t i = g * l.g + slot - 1;
  if (c.kind == 1 || (c.kind == 0 && i == 0)) {
    return zf_sym_make(c.ss,
                       (int64_t)((uint64_t)(int64_t)plane[i * plane_step] & zf_sym_mask(c.ss)),
                       c.ss);
  }
  if (!pred || i < c.order) return zf_sym_make(0, 0, 0);
  const int64_t p = g >> d;
  const ZfSymPart pt = zf_sym_part(c, params[p], keys[p]);
  const int32_t r = res[i * res_step];
  if (pt.live_escape)
    return zf_sym_make(pt.bps, (int64_t)((uint64_t)(int64_t)r & zf_sym_mask(pt.bps)), pt.bps);
  const uint32_t zz = ((uint32_t)r << 1) ^ (uint32_t)(r >> 31);
  return zf_sym_make((int64_t)(zz >> pt.k) + pt.k + 1,
                     (int64_t)((1ull << pt.k) | (zz & zf_sym_mask(pt.k))), pt.k + 1);
}
