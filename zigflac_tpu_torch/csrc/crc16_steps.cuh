// CRC-16/UMTS arithmetic of the frame CRC kernel (crc16.cu), shared with a
// host build that the CPU tests compile with g++.
//
// Poly 0x18005 (x^16 + x^15 + x^2 + 1), init 0, not reflected, no final
// xor (crc.py:21,56). A frame row holds the frame's bytes MSB-first in u32
// words: byte n is bits 31-8(n%4) .. 24-8(n%4) of word n/4, so bit s of
// word j has degree 8L - 1 - (32j + 31 - s) in the frame's polynomial M(x)
// of L bytes, and crc(M) = M(x) x^16 mod G.
//
// The CRC is GF(2)-linear, the algebra of crc.py (xpow_mod, crc16_combine)
// and ops/crc16.py. The kernel's form:
//
// * The frame is cut into nq = ceil(L / 16) chunks of 16 bytes (one int4,
//   four words), the last one masked past L: that is the frame followed by
//   p = 16 nq - L zero bytes, whose CRC is crc(M) x^(8p). So
//     crc(M) = x^(-8p) * XOR_q crc(chunk q) x^(128 (nq - 1 - q)).
// * crc(chunk) is a table sum: each word splits into six fields (five of 6
//   bits, one of 2) and each field indexes a 64-entry table of its value
//   times its position's power of x (ZfCrcTables::chunk). 64 entries of 16
//   bits are 32 words of shared memory, one a bank, so a warp's lookups
//   never conflict (an 8-bit table's 128 words would, three to four ways).
// * Lane l of a frame's kZfCrcLanes takes chunks l, l + G, l + 2G, ... (G =
//   kZfCrcLanes), reading consecutive int4s with its neighbours, and folds
//   them in Horner form, acc = acc x^(128 G) + crc(chunk): the product by
//   that constant is three lookups (ZfCrcTables::horner).
// * Lane l's last chunk lies s = (nq - 1 - l) mod G chunks before the end,
//   so its term is acc x^(128 s - 8p): one GF(2) product by one entry of a
//   16 G-entry table (ZfCrcShifts), the pad's x^(-8p) folded in. The lanes'
//   terms XOR to the CRC.
//
// Every table is made by constexpr functions from x^e mod G, at compile
// time: no thread builds one.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif

constexpr uint32_t kZfCrc16Poly = 0x18005;
constexpr int kZfCrcLanes = 64;  // lanes a frame
constexpr int kZfCrcBatch = 4;   // chunks a lane loads before it folds them
constexpr int kZfCrcWordFields = 6;
constexpr int kZfCrcAccFields = 3;

// The fields of a word (shifts 26, 20, 14, 8, 2, 0; widths 6, 6, 6, 6, 6,
// 2 bits) and of the 16-bit accumulator (shifts 10, 4, 0; widths 6, 6, 4).
// Each indexes a 64-entry table.
ZF_HD constexpr int zf_crc16_word_shift(int f) { return f == 5 ? 0 : 26 - 6 * f; }
ZF_HD constexpr int zf_crc16_acc_shift(int f) { return f == 2 ? 0 : 10 - 6 * f; }

struct alignas(16) ZfCrcTables {
  // chunk[m][f][v]: v x^(32 (3 - m) + shift_f + 16) mod G, word m of a
  // chunk, field f
  uint16_t chunk[4][kZfCrcWordFields][64];
  // horner[f][v]: v x^(shift_f + 128 G) mod G
  uint16_t horner[kZfCrcAccFields][64];
};
static_assert(sizeof(ZfCrcTables) % 16 == 0, "copied as int4s");

// e[k] = x^(8 (k - 15)) mod G, k in [0, 16 G): a lane's shift 128 s - 8p
// (s in [0, G), p in [0, 16)) is e[16 s - p + 15].
struct ZfCrcShifts {
  uint16_t e[16 * kZfCrcLanes];
};

// a x mod G, for a < 2^16.
ZF_HD constexpr uint32_t zf_crc16_mulx(uint32_t a) {
  a <<= 1;
  return a & 0x10000u ? a ^ kZfCrc16Poly : a;
}

// a x^(-1) mod G, for a < 2^16: G has a constant term, so a + G is a
// multiple of x where a is odd.
ZF_HD constexpr uint32_t zf_crc16_divx(uint32_t a) { return (a & 1u ? a ^ kZfCrc16Poly : a) >> 1; }

ZF_HD constexpr ZfCrcTables zf_crc16_make_tables() {
  ZfCrcTables t{};
  uint32_t pw[160] = {};  // x^e mod G
  pw[0] = 1;
  for (int e = 1; e < 160; ++e) pw[e] = zf_crc16_mulx(pw[e - 1]);
  for (int m = 0; m < 4; ++m)
    for (int f = 0; f < kZfCrcWordFields; ++f)
      for (uint32_t v = 0; v < 64; ++v) {
        uint32_t s = 0;
        for (int b = 0; b < 6; ++b)
          if ((v >> b) & 1u) s ^= pw[32 * (3 - m) + zf_crc16_word_shift(f) + b + 16];
        t.chunk[m][f][v] = (uint16_t)s;
      }
  uint32_t k = 1;  // x^(128 G) mod G, then times x^d
  for (int e = 0; e < 128 * kZfCrcLanes; ++e) k = zf_crc16_mulx(k);
  uint32_t kx[16] = {};
  for (int d = 0; d < 16; ++d) {
    kx[d] = k;
    k = zf_crc16_mulx(k);
  }
  for (int f = 0; f < kZfCrcAccFields; ++f)
    for (uint32_t v = 0; v < 64; ++v) {
      uint32_t s = 0;
      for (int b = 0; b < 6 && zf_crc16_acc_shift(f) + b < 16; ++b)
        if ((v >> b) & 1u) s ^= kx[zf_crc16_acc_shift(f) + b];
      t.horner[f][v] = (uint16_t)s;
    }
  return t;
}

ZF_HD constexpr ZfCrcShifts zf_crc16_make_shifts() {
  ZfCrcShifts t{};
  uint32_t up = 1, down = 1;
  for (int k = 15; k < 16 * kZfCrcLanes; ++k) {
    t.e[k] = (uint16_t)up;
    for (int i = 0; i < 8; ++i) up = zf_crc16_mulx(up);
  }
  for (int k = 15; k >= 0; --k) {
    t.e[k] = (uint16_t)down;
    for (int i = 0; i < 8; ++i) down = zf_crc16_divx(down);
  }
  return t;
}

// a(x) * b(x) mod G for a, b < 2^16.
ZF_HD uint32_t zf_gf2_mulmod(uint32_t a, uint32_t b) {
  uint32_t acc = 0;
  for (int i = 0; i < 16; ++i)
    if ((b >> i) & 1u) acc ^= a << i;
  for (int i = 30; i >= 16; --i)
    if ((acc >> i) & 1u) acc ^= kZfCrc16Poly << (i - 16);
  return acc;
}

// x^(8e) mod G by square and multiply (the tests' reference for the tables).
ZF_HD uint32_t zf_xpow8(uint64_t e) {
  uint32_t result = 1, base = 0x100;  // x^8
  for (; e; e >>= 1) {
    if (e & 1) result = zf_gf2_mulmod(result, base);
    base = zf_gf2_mulmod(base, base);
  }
  return result;
}

// The CRC (init 0) of a 16-byte chunk, words w[0..3].
ZF_HD uint32_t zf_crc16_chunk(const uint32_t (&w)[4], const ZfCrcTables& t) {
  uint32_t s = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int f = 0; f < kZfCrcWordFields; ++f)
      s ^= t.chunk[m][f][(w[m] >> zf_crc16_word_shift(f)) & (f == 5 ? 3u : 63u)];
  return s;
}

// acc x^(128 G) mod G.
ZF_HD uint32_t zf_crc16_fold(uint32_t acc, const ZfCrcTables& t) {
  return t.horner[0][acc >> 10] ^ t.horner[1][(acc >> 4) & 63u] ^ t.horner[2][acc & 15u];
}

// Loads chunk q of a row (words 4q..4q+3), words past the row (w words)
// as 0. vec: the row starts on 16 bytes and w % 4 == 0, so one int4 load.
ZF_HD void zf_crc16_load(const uint32_t* row, int64_t w, bool vec, int q, uint32_t (&c)[4]) {
  if (vec) {
#ifdef __CUDACC__
    const uint4 v = reinterpret_cast<const uint4*>(row)[q];
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
#else
    for (int m = 0; m < 4; ++m) c[m] = row[4 * (int64_t)q + m];
#endif
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int64_t j = 4 * (int64_t)q + m;
      c[m] = j < w ? row[j] : 0u;
    }
  }
}

// Zeroes the bytes of the frame's last chunk at and past its length: rem =
// len - 16 q, 1..15 bytes kept.
ZF_HD void zf_crc16_mask(int rem, uint32_t (&c)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int valid = rem - 4 * m;
    c[m] = valid >= 4 ? c[m] : valid <= 0 ? 0u : c[m] & (0xFFFFFFFFu << (8 * (4 - valid)));
  }
}

// Loads the lane's kZfCrcBatch chunks from q0 on (q0, q0 + G, ...), those
// below nq.
ZF_HD void zf_crc16_load_batch(const uint32_t* row, int64_t w, bool vec, int q0, int nq,
                               uint32_t (&c)[kZfCrcBatch][4]) {
#pragma unroll
  for (int i = 0; i < kZfCrcBatch; ++i)
    if (q0 + i * kZfCrcLanes < nq) zf_crc16_load(row, w, vec, q0 + i * kZfCrcLanes, c[i]);
}

// Lane `lane`'s term of the CRC of the first `nb` bytes of a row of w words
// (nb clamped to [0, 4w]): its chunks folded, times x^(128 s - 8p); 0 for a
// lane past the last chunk. The lane's first batch of chunks is loaded up to
// the row's end before the length is read (the kernel has its load in
// flight), then masked. Every lane calls ready() once, before any lookup:
// the kernel copies the tables into shared memory there.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <typename Ready>
ZF_HD uint32_t zf_crc16_lane(const uint32_t* row, int64_t w, bool vec, int64_t nb, int lane,
                             const ZfCrcTables& t, const uint16_t* shifts, Ready ready) {
  uint32_t c[kZfCrcBatch][4] = {};
  // chunks in the row: w < 2^33 words, so they and nq fit an int
  zf_crc16_load_batch(row, w, vec, lane, (int)((w + 3) / 4), c);
  const int64_t len = nb < 0 ? 0 : nb < 4 * w ? nb : 4 * w;
  const int nq = (int)((len + 15) / 16), rem = (int)(len % 16);
  const int s = lane < nq ? (nq - 1 - lane) % kZfCrcLanes : 0;
  const uint32_t shift = lane < nq ? shifts[16 * s + rem + (rem ? -1 : 15)] : 0;
  ready();
  if (lane >= nq) return 0;
  uint32_t acc = 0;
  for (int q0 = lane;;) {
#pragma unroll
    for (int i = 0; i < kZfCrcBatch; ++i) {
      const int q = q0 + i * kZfCrcLanes;
      if (q < nq) {
        if (rem && q == nq - 1) zf_crc16_mask(rem, c[i]);
        acc = zf_crc16_fold(acc, t) ^ zf_crc16_chunk(c[i], t);
      }
    }
    q0 += kZfCrcBatch * kZfCrcLanes;
    if (q0 >= nq) break;
    zf_crc16_load_batch(row, w, vec, q0, nq, c);
  }
  return zf_gf2_mulmod(acc, shift);
}

// The CRC's two bytes go big-endian into the row at byte_len and byte_len +
// 1, ORed into the words there; a position past the row (w words) is
// dropped. deposit_read reads those words (0 past the row) before the CRC is
// known, deposit_write stores them with the bytes ORed in.
ZF_HD bool zf_crc16_in_row(int64_t pos, int64_t w) { return pos >= 0 && pos < 4 * w; }

ZF_HD void zf_crc16_deposit_read(const uint32_t* row, int64_t w, int64_t byte_len,
                                 uint32_t (&old)[2]) {
  for (int k = 0; k < 2; ++k)
    old[k] = zf_crc16_in_row(byte_len + k, w) ? row[(byte_len + k) >> 2] : 0u;
}

ZF_HD void zf_crc16_deposit_write(uint32_t* row, int64_t w, int64_t byte_len, uint32_t crc,
                                  const uint32_t (&old)[2]) {
  const int64_t p0 = byte_len, p1 = byte_len + 1;
  const uint32_t b0 = ((crc >> 8) & 0xFFu) << (8 * (3 - (p0 & 3)));
  const uint32_t b1 = (crc & 0xFFu) << (8 * (3 - (p1 & 3)));
  if (zf_crc16_in_row(p0, w) && (p0 >> 2) == (p1 >> 2)) {  // one word holds both
    row[p0 >> 2] = old[0] | b0 | b1;
    return;
  }
  if (zf_crc16_in_row(p0, w)) row[p0 >> 2] = old[0] | b0;
  if (zf_crc16_in_row(p1, w)) row[p1 >> 2] = old[1] | b1;
}
