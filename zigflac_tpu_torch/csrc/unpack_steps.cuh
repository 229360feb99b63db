// The WAV sample arithmetic of the PCM unpack kernel (unpack.cu), shared
// with a host build that the CPU tests compile with g++.
//
// A WAV's data chunk is interleaved little-endian PCM: sample frame i of C
// channels is C samples of nb container bytes each (1-4), at byte
// (i C + ch) nb. One sample is read exactly as native/zf_native.cpp's
// deinterleave reads it (src/WavReader.zig:44-93): its nb bytes placed in
// the top of a u32, byte b at bits 8 (4 - nb + b) .. +7; for nb == 1,
// 128 >> (8 - depth) subtracted in u32, so the 0x80 byte wraps to INT32_MIN
// as the reference's does; then an arithmetic shift by 32 - depth unless
// depth == 32. Depths that fill their container partly (12 bits in 2
// bytes, 20 in 3) are left-justified there, so the shift drops the pad bits.
//
// The frames come out as int32 [n, C, block]: row r, channel ch, column
// col. Rows at and past nreal repeat row nreal - 1, the bucket padding the
// pipeline's batches take.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_UNPACK_HD __host__ __device__ __forceinline__
#else
#define ZF_UNPACK_HD inline
#endif

// One sample from its NB container bytes at p.
template <int NB>
ZF_UNPACK_HD int32_t zf_unpack_sample(const uint8_t* p, int depth) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < NB; ++b) v |= (uint32_t)p[b] << (8 * (4 - NB + b));
  if (NB == 1) v -= 128u >> (8 - depth);
  const int32_t x = (int32_t)v;
  return depth == 32 ? x : x >> (32 - depth);
}

// Sample frame `col` of row `row`: its C samples, from consecutive bytes,
// into column `col` of each channel's row of dst.
template <int NB>
ZF_UNPACK_HD void zf_unpack_frame(const uint8_t* src, int32_t* dst, int channels, int depth,
                                  int64_t block, int64_t nreal, int64_t row, int64_t col) {
  const int64_t from = row < nreal ? row : nreal - 1;
  const uint8_t* p = src + (from * block + col) * channels * NB;
  int32_t* d = dst + row * channels * block + col;
  for (int ch = 0; ch < channels; ++ch) d[ch * block] = zf_unpack_sample<NB>(p + ch * NB, depth);
}
