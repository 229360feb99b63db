// CRC-16/UMTS arithmetic of the frame CRC kernel (crc16.cu), shared with a
// host build that the CPU tests compile with g++.
//
// Poly 0x18005 (x^16 + x^15 + x^2 + 1), init 0, not reflected, no final
// xor (crc.py:21,56). A frame row holds the frame's bytes MSB-first in u32
// words: byte n is bits 31-8(n%4) .. 24-8(n%4) of word n/4.
//
// The CRC is GF(2)-linear, the algebra of crc.py (xpow_mod, crc16_combine)
// and ops/crc16.py: with A and B two runs of bytes,
//   crc(A || B) = crc(A) * x^(8 |B|) mod G  xor  crc(B),
// so each thread takes the CRC of its own contiguous run with a 256-entry
// table, and the runs combine by one GF(2) product each with x^(8 * the
// bytes after the run), computed by square and multiply.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif

constexpr uint32_t kZfCrc16Poly = 0x18005;

// Table entry b: the CRC register after shifting byte b through it.
ZF_HD uint32_t zf_crc16_table_entry(uint32_t b) {
  uint32_t crc = b << 8;
  for (int i = 0; i < 8; ++i)
    crc = (crc & 0x8000u) ? ((crc << 1) ^ kZfCrc16Poly) & 0xFFFFu : (crc << 1) & 0xFFFFu;
  return crc;
}

ZF_HD uint32_t zf_crc16_step(uint32_t crc, uint32_t byte, const uint16_t* table) {
  return table[((crc >> 8) ^ byte) & 0xFFu] ^ ((crc << 8) & 0xFFFFu);
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

// x^(8e) mod G.
ZF_HD uint32_t zf_xpow8(uint64_t e) {
  uint32_t result = 1, base = 0x100;  // x^8
  for (; e; e >>= 1) {
    if (e & 1) result = zf_gf2_mulmod(result, base);
    base = zf_gf2_mulmod(base, base);
  }
  return result;
}

// The bytes a thread takes: runs of `run` bytes, a multiple of 4, so every
// run starts on a word; the last one ends at the frame's length.
ZF_HD int64_t zf_crc16_run_bytes(int64_t len, int threads) {
  const int64_t per = (len + threads - 1) / threads;
  return (per + 3) / 4 * 4;
}

// The CRC (init 0) of bytes [b0, b1) of a row, b0 a multiple of 4.
ZF_HD uint32_t zf_crc16_run(const uint32_t* row, int64_t b0, int64_t b1, const uint16_t* table) {
  uint32_t crc = 0;
  for (int64_t w = b0 / 4; 4 * w < b1; ++w) {
    const uint32_t word = row[w];
    const int n = b1 - 4 * w < 4 ? (int)(b1 - 4 * w) : 4;
    for (int k = 0; k < n; ++k) crc = zf_crc16_step(crc, (word >> (24 - 8 * k)) & 0xFFu, table);
  }
  return crc;
}

// One thread's term of the frame CRC: its run's CRC times x^(8 * the bytes
// after it). 0 for a run past the frame's end.
ZF_HD uint32_t zf_crc16_term(const uint32_t* row, int64_t len, int64_t run, int t,
                             const uint16_t* table) {
  const int64_t b0 = t * run;
  if (b0 >= len) return 0;
  const int64_t b1 = b0 + run < len ? b0 + run : len;
  return zf_gf2_mulmod(zf_crc16_run(row, b0, b1, table), zf_xpow8((uint64_t)(len - b1)));
}

// ORs the CRC's two bytes, big-endian, into the row at byte_len and
// byte_len + 1; a position past the row (w words) is dropped.
ZF_HD void zf_crc16_deposit(uint32_t* row, int64_t w, int64_t byte_len, uint32_t crc) {
  for (int k = 0; k < 2; ++k) {
    const int64_t pos = byte_len + k;
    const uint32_t byte = k ? crc & 0xFFu : (crc >> 8) & 0xFFu;
    if (pos >= 0 && pos < 4 * w) row[pos >> 2] |= byte << (8 * (3 - (pos & 3)));
  }
}
