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
// width includes its unary run, so nb can reach 2^32 + 30), the value
// deposited right-aligned at the field's end, and the value's width. The
// kernel stores the low 32 bits of the inclusive prefix sum of nb (the plain
// version's `.to(torch.int32)`), val in int64 and nbv in int32: the deposit
// kernel's inputs (ops/deposit.py). The low 32 bits of a sum are the sum of
// the low 32 bits mod 2^32, so the scan runs in 32 bits; only total_bits,
// the frame's sum, is taken in 64.
//
// Escapes: a partition's bps is 0 where all its residuals are zero, else the
// bit length of its widest r ^ (r >> 31) plus the sign bit. It matters only
// where the param is the escape code (2^(4 + method) - 1): the kernel keeps
// one 32-bit key a residual of such a partition, 0 for r == 0 and (r ^ (r >>
// 31)) + 1 otherwise (at most 2^31), and takes the partition's largest: bps
// follows from it alone. An escape with bps >= 32 falls back to Rice param
// 30 (the reference's "TODO 32bits bug", ROADMAP sec. 3 N1): its param
// column holds the value 30 in param_len bits, unmasked, as the plain
// version writes it.
//
// Integer policy: every field equals the plain version's int64 arithmetic.
// A code's value and width fit 32 bits (params and bps below 32), a Rice
// code's unary run may not, so its width is taken in 64 bits; warmup and
// verbatim samples take 64-bit masks (33-bit side samples). Masks take
// widths 0..64 without a shift by the full width.
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
constexpr int kZfSymMaxChannels = 8;  // FLAC's channel limit
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

// q / d without a division, for q < 2^20 and 2 <= d <= 2^17: m = ceil(2^k /
// d) = (2^k + e) / d with 0 <= e < d, so q m / 2^k = q / d + q e / (d 2^k),
// whose floor is q / d while (q mod d) + q e / 2^k < d, which q e < 2^k
// ensures: k = max(32, 20 + bitlen(d)) > 20 + log2(e), and m < 2^32. The
// kernel's quotients: columns of a frame (q < 2^20) by a channel's columns
// (d < 2^17), of a residual section by G + 1, samples by G (G >= 2).
struct ZfSymDiv {
  uint32_t m, s;  // q / d = (q m >> 32) >> s
};

ZF_HD ZfSymDiv zf_sym_divider(int64_t d) {
  int bl = 0;
  while (bl < 63 && ((int64_t)1 << bl) <= d) ++bl;
  const int k = 20 + bl > 32 ? 20 + bl : 32;
  ZfSymDiv v;
  v.m = d < 2 ? 0u : (uint32_t)((((uint64_t)1 << k) + (uint64_t)d - 1) / (uint64_t)d);
  v.s = (uint32_t)(k - 32);
  return v;
}

ZF_HD uint32_t zf_sym_div(uint32_t q, ZfSymDiv v) {
#ifdef __CUDA_ARCH__
  return __umulhi(q, v.m) >> v.s;
#else
  return (uint32_t)(((uint64_t)q * v.m) >> 32) >> v.s;
#endif
}

// A load of the plan's planes or residuals (read-only for the kernel's life).
template <typename T>
ZF_HD T zf_sym_ld(const T* p) {
#ifdef __CUDA_ARCH__
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "int32 or int64");
  if constexpr (sizeof(T) == 8) return (T)__ldg(reinterpret_cast<const long long*>(p));
  else return (T)__ldg(reinterpret_cast<const int*>(p));
#else
  return *p;
#endif
}

struct ZfSym {
  uint64_t nb;   // field width in bits
  uint64_t val;  // value, right-aligned at the field's end
  uint32_t nbv;  // value width in bits
};

ZF_HD ZfSym zf_sym_make(uint64_t nb, uint64_t val, uint32_t nbv) {
  ZfSym s;
  s.nb = nb;
  s.val = val;
  s.nbv = nbv;
  return s;
}

// The static layout of one launch's frames.
struct ZfSymLayout {
  int64_t w, b;                    // wire channels, block size
  int64_t mw, lpc_order, lpc_precision;
  int64_t po_top, g;               // top partition order, samples a grid group
  int64_t r0, chan_cols, s;        // first residual-section column, columns a channel, a frame
  ZfSymDiv d_g, d_grid, d_chan;    // zf_sym_divider of G (G >= 2), G + 1 and chan_cols
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
  l.d_g = zf_sym_divider(l.g);
  l.d_grid = zf_sym_divider(l.g + 1);
  l.d_chan = zf_sym_divider(l.chan_cols);
  return l;
}

// The static header pieces (ops/header.py HeaderStatic): byte 2, the depth
// code, and up to four tail bytes, tail byte t in bits 8t..8t+7 of `tail`.
struct ZfSymHeaderStatic {
  int64_t byte2, depth_code, tail, ntail;
};

// A frame header: sync, codes, the UTF-8 frame number
// (ops/header.py utf8_frame_number_bytes), the tail bytes and the CRC-8 of
// bytes [0, len - 1) at len - 1; bytes past it 0. Frame numbers are below
// 2^36 (seven bytes at most).
struct ZfSymHeader {
  uint32_t bytes[kZfSymHeaderCols];
  int32_t len;
};

// The UTF-8 frame number's continuation bytes, as the plain version counts
// them (also for a frame number that takes one byte).
ZF_HD int zf_sym_utf8_cont(int64_t fn) {
  int c = 0;
  for (int i = 0; i < 7; ++i) c += (fn >> (6 * i)) > (63 >> i);
  return c;
}

ZF_HD int zf_sym_utf8_len(int64_t fn) { return fn <= 0x7F ? 1 : zf_sym_utf8_cont(fn) + 1; }

// The CRC-8's position in the header.
ZF_HD int zf_sym_header_crc_pos(int64_t fn, const ZfSymHeaderStatic& hs) {
  return 4 + zf_sym_utf8_len(fn) + (int)hs.ntail;
}

// Byte j (0 <= j < 16) of a frame header, 0 from the CRC-8's position on.
ZF_HD uint32_t zf_sym_header_byte(int j, int64_t fn, int64_t channels_code,
                                  const ZfSymHeaderStatic& hs) {
  if (j < 4) {
    if (j < 2) return j == 0 ? 0xFFu : 0xF8u;
    return j == 2 ? (uint32_t)hs.byte2 : (uint32_t)((channels_code << 4) | hs.depth_code);
  }
  const int cont = zf_sym_utf8_cont(fn), fn_len = fn <= 0x7F ? 1 : cont + 1;
  if (j == 4) {
    const int lead_shift = 6 - cont > 0 ? 6 - cont : 0;
    if (fn <= 0x7F) return (uint32_t)fn;
    return (uint32_t)(((0xFE << lead_shift) | (fn >> (6 * cont))) & 0xFF);
  }
  if (j < 4 + fn_len) {
    const int shift = 6 * (cont - (j - 4)) > 0 ? 6 * (cont - (j - 4)) : 0;
    return 0x80u | (uint32_t)((fn >> shift) & 0x3F);
  }
  const int t = j - 4 - fn_len;
  return t < hs.ntail ? (uint32_t)((hs.tail >> (8 * t)) & 0xFF) : 0u;
}

// The header's CRC-8 over bytes [0, crc_pos), written at crc_pos.
ZF_HD void zf_sym_header_crc(ZfSymHeader& h, int crc_pos, const ZfCrc8Table& crc8) {
  uint32_t crc = 0;
#pragma unroll
  for (int j = 0; j < kZfSymHeaderCols - 1; ++j)
    if (j < crc_pos) crc = crc8.t[(crc ^ h.bytes[j]) & 0xFFu];
  h.bytes[crc_pos] = crc;
  h.len = crc_pos + 1;
}

ZF_HD ZfSym zf_sym_header_column(const ZfSymHeader& h, uint32_t j) {
  return (int32_t)j < h.len ? zf_sym_make(8, h.bytes[j], 8) : zf_sym_make(0, 0, 0);
}

ZF_HD bool zf_sym_pred(int32_t kind) { return kind == 2 || kind == 3; }

// A residual's partition key: 0 for r == 0, else (r ^ (r >> 31)) + 1.
ZF_HD uint32_t zf_sym_key(int32_t r) {
  return r == 0 ? 0u : ((uint32_t)(r ^ (r >> 31))) + 1u;
}

// bps of a partition from its largest key.
ZF_HD int64_t zf_sym_bps(uint32_t key) { return key == 0 ? 0 : zf_sym_bitlen32(key - 1u) + 1; }

ZF_HD bool zf_sym_is_escape(int64_t method, int64_t param) {
  return param == ((int64_t)1 << (4 + method)) - 1;
}

// The fields of a grid group's columns, packed for the column pass (one
// 8-byte load from shared memory): x holds the mask of a code's value (bits
// 0-30) and, in bit 31, a live escape; y the Rice param of the codes (bits
// 0-4; 30 in the N1 fallback), the codes' value width (bits 8-13: k + 1, or
// bps for a live escape), and the group's param column, its width (bits
// 16-21) and value (bits 22-31), both 0 where the group does not start a
// partition. `key` is the partition's largest key; it is read only for an
// escape.
struct ZfSymGroup {
  uint32_t x, y;
};

// y of a group whose partition escapes, until its key is known (no group's
// fields have a width of 63).
constexpr uint32_t kZfSymPending = 0xFFFFFFFFu;

ZF_HD ZfSymGroup zf_sym_group(int64_t method, int64_t param, uint32_t key, bool starts) {
  const uint32_t bps = (uint32_t)zf_sym_bps(key);
  const bool esc = zf_sym_is_escape(method, param), fallback = esc && bps >= 32;
  const bool live = esc && !fallback;
  const uint32_t p5 = (uint32_t)(param & 31), k = fallback ? 30u : p5;
  const uint32_t plen = (uint32_t)(4 + method + (live ? 5 : 0));
  const uint32_t v = live ? (p5 << 5) | bps : fallback ? 30u : p5;
  ZfSymGroup e;
  e.x = live ? ((1u << bps) - 1u) | 0x80000000u : (1u << k) - 1u;
  e.y = (live ? 0u : k) | (live ? bps : k + 1u) << 8 | (starts ? plen : 0u) << 16 |
        (starts ? v : 0u) << 22;
  return e;
}

// One wire channel's fields of one frame, and its rows of the plan's planes
// and residuals, as 16-byte loads from shared memory take them: a column of
// a predicted subframe's residual section reads the first 24 bytes, a
// verbatim one the first 40.
template <typename T>
struct alignas(16) ZfSymChannel {
  int32_t kind;  // 0 constant, 1 verbatim, 2 fixed, 3 LPC
  int32_t order, ss;
  int32_t ds;    // the grid groups a partition spans, as a shift
  const int32_t* res;
  const T* plane;
  uint64_t ss_mask;  // zf_sym_mask(ss)
  int32_t method, part_order, qshift, wasted;
};

// Column col < r0 of one channel: its header, wasted bits, warmup, LPC and
// method fields. c.plane[i * plane_step] is sample i; qcoeffs the channel's
// 32 coefficients.
template <typename T>
ZF_HD ZfSym zf_sym_preamble_column(const ZfSymLayout& l, const ZfSymChannel<T>& c, int64_t col,
                                   int64_t plane_step, const int64_t* qcoeffs) {
  const bool pred = zf_sym_pred(c.kind), lpc = c.kind == 3;
  if (col == 0) {
    const int64_t hdr = c.kind == 0 ? 0
                        : c.kind == 1 ? 2
                        : lpc         ? (0x20 | (c.order - 1)) << 1
                                      : (8 | c.order) << 1;
    return zf_sym_make(8, (uint64_t)(hdr | (c.wasted > 0)), 8);
  }
  if (col == 1) {
    const int64_t nb = c.wasted > 0 ? c.wasted : 0;
    return zf_sym_make((uint64_t)nb, nb > 0, nb > 0);
  }
  if (col < 2 + l.mw) {
    const int64_t j = col - 2;
    const int64_t nb = pred && j < c.order ? c.ss : 0;
    return zf_sym_make((uint64_t)nb, (uint64_t)(int64_t)c.plane[j * plane_step] & zf_sym_mask(nb),
                       (uint32_t)nb);
  }
  const int64_t m_col = l.r0 - 1;
  if (col < m_col) {  // LPC: precision and shift, then the coefficients
    const int64_t j = col - 2 - l.mw;
    if (j == 0) {
      const int64_t nb = lpc ? 9 : 0;
      const int64_t v = lpc ? ((l.lpc_precision - 1) << 5) | c.qshift : 0;
      return zf_sym_make((uint64_t)nb, (uint64_t)v, (uint32_t)nb);
    }
    const int64_t nb = lpc && j - 1 < c.order ? l.lpc_precision : 0;
    return zf_sym_make((uint64_t)nb, (uint64_t)qcoeffs[j - 1] & zf_sym_mask(nb), (uint32_t)nb);
  }
  const int64_t nb = pred ? 6 : 0;
  return zf_sym_make((uint64_t)nb, pred ? (uint64_t)((c.method << 4) | c.part_order) : 0,
                     (uint32_t)nb);
}

// Column r0 + q of one channel's residual section: group g = q / (G + 1),
// whose slot 0 is its param column and slot s its sample g G + s - 1 = q - g
// - 1. groups holds the channel's group fields (zf_sym_group). A predicted
// subframe's column selects its fields without a branch on its slot: the
// param column, a warmup sample, an escape or a Rice code; only a Rice
// code's width takes 64 bits.
template <typename T>
ZF_HD ZfSym zf_sym_residual_column(const ZfSymLayout& l, const ZfSymChannel<T>& c, uint32_t q,
                                   const ZfSymGroup* groups, int64_t plane_step,
                                   int64_t res_step) {
  const uint32_t g = zf_sym_div(q, l.d_grid), i = q - g - 1;
  const bool param_col = q == g * (uint32_t)(l.g + 1);
  if (zf_sym_pred(c.kind)) {
    const ZfSymGroup e = groups[g];
    const bool warm = !param_col && i < (uint32_t)c.order;
    const int32_t r = param_col || warm ? 0 : zf_sym_ld(c.res + (int64_t)i * res_step);
    const bool live = e.x >> 31;
    const uint32_t mask = e.x & 0x7FFFFFFFu, k = e.y & 31u, width = (e.y >> 8) & 63u;
    const uint32_t zz = ((uint32_t)r << 1) ^ (uint32_t)(r >> 31);
    uint32_t val = live ? (uint32_t)r & mask : (zz & mask) | (mask + 1u);
    uint32_t nbv = width;
    uint64_t nb = live ? (uint64_t)width : (uint64_t)(zz >> k) + width;
    if (param_col) {
      nbv = (e.y >> 16) & 63u;
      nb = nbv;
      val = e.y >> 22;
    }
    if (warm) nb = val = nbv = 0;
    return zf_sym_make(nb, val, nbv);
  }
  // constant: sample 0 only; verbatim: every sample
  if (param_col || (c.kind == 0 && i != 0)) return zf_sym_make(0, 0, 0);
  return zf_sym_make((uint64_t)c.ss,
                     (uint64_t)(int64_t)zf_sym_ld(c.plane + (int64_t)i * plane_step) & c.ss_mask,
                     (uint32_t)c.ss);
}

// One launch's arguments: the plan's fields (int64 [w, n] each, params
// [w, n, 256], qcoeffs [w, n, 32], contiguous), planes and residuals through
// their element strides, the outputs.
template <typename T>
struct ZfSymArgs {
  const int64_t *frame_numbers, *channels_code;            // [N]
  const int64_t *kind, *order, *method, *part_order, *ss;  // [W, N]
  const int64_t *qshift, *wasted;                          // [W, N]
  const int64_t *params, *qcoeffs;                         // [W, N, 256], [W, N, 32]
  const T* planes;
  int64_t pl_w, pl_n, pl_b;  // element strides of planes [W, N, B]
  const int32_t* res;
  int64_t rs_w, rs_n, rs_b;  // element strides of residuals [W, N, B]
  int64_t n;
  ZfSymLayout lay;
  ZfSymHeaderStatic hs;
  int32_t* dep_cum;
  int64_t* val;
  int32_t* nbv;
  int64_t* total_bits;
};

// Channel c of frame f, from the plan.
template <typename T>
ZF_HD ZfSymChannel<T> zf_sym_channel(const ZfSymArgs<T>& a, int64_t c, int64_t f) {
  const int64_t wn = c * a.n + f, po = a.part_order[wn];
  ZfSymChannel<T> ch;
  ch.kind = (int32_t)a.kind[wn];
  ch.order = (int32_t)a.order[wn];
  ch.ss = (int32_t)a.ss[wn];
  // partition p covers groups [p << ds, (p + 1) << ds)
  ch.ds = (int32_t)(a.lay.po_top - po > 0 ? a.lay.po_top - po : 0);
  ch.res = a.res + c * a.rs_w + f * a.rs_n;
  ch.plane = a.planes + c * a.pl_w + f * a.pl_n;
  ch.ss_mask = zf_sym_mask(ch.ss);
  ch.method = (int32_t)a.method[wn];
  ch.part_order = (int32_t)po;
  ch.qshift = (int32_t)a.qshift[wn];
  ch.wasted = (int32_t)a.wasted[wn];
  return ch;
}

// The group fields of frame f's (channel, group) pairs idx = start, start +
// step, ... (groups[c * 256 + g]; at most 256 groups, po_top <= 8), read
// from the plan's fields; an escape's are kZfSymPending until its
// partition's largest key, set to 0 in keys[c * 256 + p] here, is known.
// With `finish`, the escapes' fields from those keys, read from chan.
// Returns whether it met an escape.
template <typename T>
ZF_HD bool zf_sym_group_fields(const ZfSymArgs<T>& a, int64_t f, const ZfSymChannel<T>* chan,
                               ZfSymGroup* groups, uint32_t* keys, bool finish, int start,
                               int step) {
  const ZfSymLayout& l = a.lay;
  bool esc = false;
  for (int idx = start; idx < l.w * kZfSymParamCols; idx += step) {
    const int c = idx / kZfSymParamCols, g = idx % kZfSymParamCols;
    const int64_t wn = c * a.n + f;
    const int64_t kind = finish ? chan[c].kind : a.kind[wn];
    if (g >= ((int64_t)1 << l.po_top) || !zf_sym_pred((int32_t)kind)) continue;
    const int64_t po = finish ? chan[c].part_order : a.part_order[wn];
    const int64_t method = finish ? chan[c].method : a.method[wn];
    const int ds = (int)(l.po_top - po > 0 ? l.po_top - po : 0), p = g >> ds;
    const bool starts = (g & ((1 << ds) - 1)) == 0;
    const int64_t param = a.params[wn * kZfSymParamCols + p];
    const bool e = zf_sym_is_escape(method, param);
    uint32_t& key = keys[c * kZfSymParamCols + p];
    if (finish && e) groups[idx] = zf_sym_group(method, param, key, starts);
    if (!finish && e && starts) key = 0;
    if (!finish)
      groups[idx] = e ? ZfSymGroup{0u, kZfSymPending} : zf_sym_group(method, param, 0, starts);
    esc = esc || e;
  }
  return esc;
}

// Column col of frame f: header, channel preamble or residual section. hdr,
// chan and groups are the frame's header, channels and group fields
// (groups[c * 256 + g]).
template <typename T>
ZF_HD ZfSym zf_sym_frame_column(const ZfSymArgs<T>& a, int64_t f, uint32_t col,
                                const ZfSymHeader& hdr, const ZfSymChannel<T>* chan,
                                const ZfSymGroup* groups) {
  const ZfSymLayout& l = a.lay;
  if (col < (uint32_t)kZfSymHeaderCols) return zf_sym_header_column(hdr, col);
  const uint32_t q0 = col - kZfSymHeaderCols, c = zf_sym_div(q0, l.d_chan);
  const uint32_t cc = q0 - c * (uint32_t)l.chan_cols;
  if (cc < (uint32_t)l.r0)
    return zf_sym_preamble_column(l, chan[c], cc, a.pl_b,
                                  a.qcoeffs + (c * a.n + f) * kZfSymCoeffCols);
  return zf_sym_residual_column(l, chan[c], cc - (uint32_t)l.r0, groups + c * kZfSymParamCols,
                                a.pl_b, a.rs_b);
}
