// Step arithmetic of the decoder synthesis, shared by the CUDA kernel
// (synth.cu) and a host build that the CPU tests compile with g++.
//
// One subframe's recurrence over a tile of kZfTile positions:
//
//   s[t] = v[t]                                        for t < warm
//   s[t] = v[t] + ((sum_j q[j] * s[t-1-j]) >> shift)   otherwise
//
// in wrapping 64-bit arithmetic: products, sums and the add of the value run
// in uint64_t and only the arithmetic right shift sees an int64_t, so nothing
// here is undefined for any input. The history h is a ring of the last
// kZfTile samples whose slot is the position modulo kZfTile; a tile's steps
// are unrolled, so every ring index is a compile-time constant. The tile
// functions read the tile's values from `in` and write its samples, not yet
// shifted left by the wasted bits, to `out`, which must not overlap: a step's
// load of its value then need not wait for the last step's store.
//
// Two forms of the same arithmetic:
//
//   wide    coefficients and history in 64 bits: each tap a full
//           64 x 64 -> 64 multiply-add (three 32-bit multiply instructions).
//   narrow  coefficients and history in int32: each tap one
//           32 x 32 + 64 -> 64 multiply-add (a single IMAD.WIDE). The sum,
//           the shift and the add are the wide form's, so the sample comes
//           out in 64 bits. With a shift of 0 the sample's low word is also
//           computed alone, in 32 bits, and that is what the history keeps:
//           it is the same word, one instruction after the last sample.
//
// Narrow is exact while it applies: if every coefficient and every sample
// in the history equals its own sign-extended low word, the int32 product
// is the 64-bit product (it cannot even wrap), so the wide and the narrow
// step give the same s. The narrow tile returns a flag that is non-zero as
// soon as one of its samples does not fit int32. Up to and including that
// sample the tile was exact; after it the truncated history may have been
// used, so the caller discards the tile, restores the history it saved
// with zf_save (all of which fitted int32, so zf_widen's sign extension
// gives back the exact 64-bit history) and runs the tile again wide.
//
// T is the number of taps summed, FULL = false the general tile: fewer
// than kZfTile positions (width) or warmup samples (warm).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif

constexpr int kZfTile = 32;  // history depth, and positions per tile
// A tile's values are loaded this many steps before the step that adds them
// (a tile that is not full loads a few positions past its width, inside its
// row of kZfTile, and never uses them): a load from shared memory takes
// longer than a step, and must not wait in line behind the last step's store.
constexpr int kZfAhead = 8;

// Runs the statement(s) with the constant T set to `taps`, one of the tap
// counts that zf_round_taps gives.
#define ZF_WITH_TAPS(taps, T, ...)                           \
  switch (taps) {                                            \
    case 0: { constexpr int T = 0; __VA_ARGS__; } break;     \
    case 1: { constexpr int T = 1; __VA_ARGS__; } break;     \
    case 2: { constexpr int T = 2; __VA_ARGS__; } break;     \
    case 3: { constexpr int T = 3; __VA_ARGS__; } break;     \
    case 4: { constexpr int T = 4; __VA_ARGS__; } break;     \
    case 8: { constexpr int T = 8; __VA_ARGS__; } break;     \
    case 16: { constexpr int T = 16; __VA_ARGS__; } break;   \
    case 24: { constexpr int T = 24; __VA_ARGS__; } break;   \
    default: { constexpr int T = 32; __VA_ARGS__; } break;   \
  }

// The smallest compiled tap count that covers n taps.
ZF_HD int zf_round_taps(int n) {
  return n <= 4 ? n : n <= 8 ? 8 : n <= 16 ? 16 : n <= 24 ? 24 : 32;
}

// One more than the index of the last non-zero coefficient: the taps that
// a subframe needs, whatever its declared order.
ZF_HD int zf_taps_needed(const uint64_t (&q)[kZfTile]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kZfTile; ++j)
    if (q[j] != 0) n = j + 1;
  return n;
}

ZF_HD bool zf_fits_i32(uint64_t x) { return x == (uint64_t)(int64_t)(int32_t)(uint32_t)x; }

ZF_HD bool zf_all_fit_i32(const uint64_t (&q)[kZfTile]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kZfTile; ++j) ok = ok && zf_fits_i32(q[j]);
  return ok;
}

// a * b + c with the int32 product taken in 64 bits: one IMAD.WIDE on the
// card. Written as the carry pair of the low and the high word, which ptxas
// folds into the one instruction with its 64-bit addend; given mad.wide, or
// the C expression, it multiplies alone and sums products in trees of adds:
// about one more instruction a tap, and two more between one sample and the
// next.
ZF_HD uint64_t zf_mad_i32(int32_t a, int32_t b, uint64_t c) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  asm("{\n\t"
      ".reg .b32 lo, hi;\n\t"
      "mov.b64 {lo, hi}, %3;\n\t"
      "mad.lo.cc.s32 lo, %1, %2, lo;\n\t"
      "madc.hi.s32 hi, %1, %2, hi;\n\t"
      "mov.b64 %0, {lo, hi};\n\t"
      "}"
      : "=l"(d)
      : "r"(a), "r"(b), "l"(c));
  return d;
#else
  return c + (uint64_t)((int64_t)a * (int64_t)b);
#endif
}

// The low 64 bits of a * b + c for the wide form, in the same manner: one
// IMAD.WIDE.U32 with its addend for the low words' product, and one IMAD
// into the high word for each of the two cross products.
ZF_HD uint64_t zf_mad_u64(uint64_t a, uint64_t b, uint64_t c) {
#ifdef __CUDA_ARCH__
  uint64_t d;
  asm("{\n\t"
      ".reg .b32 alo, ahi, blo, bhi, lo, hi;\n\t"
      "mov.b64 {alo, ahi}, %1;\n\t"
      "mov.b64 {blo, bhi}, %2;\n\t"
      "mov.b64 {lo, hi}, %3;\n\t"
      "mad.lo.cc.u32 lo, alo, blo, lo;\n\t"
      "madc.hi.u32 hi, alo, blo, hi;\n\t"
      "mad.lo.u32 hi, alo, bhi, hi;\n\t"
      "mad.lo.u32 hi, ahi, blo, hi;\n\t"
      "mov.b64 %0, {lo, hi};\n\t"
      "}"
      : "=l"(d)
      : "l"(a), "l"(b), "l"(c));
  return d;
#else
  return c + a * b;
#endif
}

// The low word of a * b + c: one 32-bit IMAD. Kept apart from zf_mad_i32 so
// that the compiler does not take it from the wide product's low half.
ZF_HD int32_t zf_mad_lo(int32_t a, int32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  int32_t d;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"((int32_t)c));
  return d;
#else
  return (int32_t)((uint32_t)a * (uint32_t)b + c);
#endif
}

template <int T, bool FULL>
ZF_HD void zf_tile_wide(const uint64_t (&q)[kZfTile], uint64_t (&h)[kZfTile],
                        const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                        int width, int warm, int sh) {
  uint64_t ahead[kZfTile];
#pragma unroll
  for (int t = 0; t < kZfAhead; ++t) ahead[t] = in[t];
#pragma unroll
  for (int t = 0; t < kZfTile; ++t) {
    if (!FULL && t >= width) break;
    if (t + kZfAhead < kZfTile) ahead[t + kZfAhead] = in[t + kZfAhead];
    // oldest tap first, the newest sample's product last: only that
    // product, the shift and the add wait for the last sample
    constexpr int kSums = T >= 8 ? 2 : 1;
    uint64_t sums[kSums] = {0};
#pragma unroll
    for (int j = T - 1; j >= 1; --j)
      sums[j % kSums] = zf_mad_u64(q[j], h[(t - 1 - j) & (kZfTile - 1)], sums[j % kSums]);
    uint64_t acc = sums[0];
#pragma unroll
    for (int i = 1; i < kSums; ++i) acc += sums[i];
    if (T > 0) acc = zf_mad_u64(q[0], h[(t - 1) & (kZfTile - 1)], acc);
    const uint64_t v = ahead[t];
    uint64_t s = v + (uint64_t)((int64_t)acc >> sh);
    if (!FULL && t < warm) s = v;
    h[t] = s;
    out[t] = s;
  }
}

// Returns non-zero if a sample of the tile did not fit int32. SH0 says that
// the shift is 0, as for every fixed predictor: the low word of a sample,
// which is all that the next step's products read, is then the low word of
// the sum, one 32-bit multiply-add after the last sample, and the 64-bit
// sample (for the output and the flag) is computed beside it, off the chain.
template <int T, bool FULL, bool SH0 = false>
ZF_HD uint32_t zf_tile_narrow(const int32_t (&q)[kZfTile], int32_t (&h)[kZfTile],
                              const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                              int width, int warm, int sh) {
  uint32_t bad = 0;
  uint64_t ahead[kZfTile];
#pragma unroll
  for (int t = 0; t < kZfAhead; ++t) ahead[t] = in[t];
#pragma unroll
  for (int t = 0; t < kZfTile; ++t) {
    if (!FULL && t >= width) break;
    if (t + kZfAhead < kZfTile) ahead[t + kZfAhead] = in[t + kZfAhead];
    // few taps: one chain of multiply-adds; many: two, half as deep (more
    // chains are no faster: the multiply-adds' issue sets the pace)
    constexpr int kSums = T >= 8 ? 2 : 1;
    uint64_t sums[kSums] = {0};
#pragma unroll
    for (int j = T - 1; j >= 1; --j)
      sums[j % kSums] = zf_mad_i32(q[j], h[(t - 1 - j) & (kZfTile - 1)], sums[j % kSums]);
    uint64_t acc = sums[0];
#pragma unroll
    for (int i = 1; i < kSums; ++i) acc += sums[i];
    const uint64_t v = ahead[t];
    const uint32_t base = (uint32_t)v + (uint32_t)acc;
    if (T > 0) acc = zf_mad_i32(q[0], h[(t - 1) & (kZfTile - 1)], acc);
    uint64_t s = v + (SH0 ? acc : (uint64_t)((int64_t)acc >> sh));
    if (!FULL && t < warm) s = v;
    const int32_t lo = SH0 && T > 0 ? zf_mad_lo(q[0], h[(t - 1) & (kZfTile - 1)], base)
                                    : (int32_t)(uint32_t)s;
    h[t] = lo;
    bad |= (uint32_t)(s >> 32) ^ (uint32_t)(lo >> 31);  // high word != sign of the low
    out[t] = s;
  }
  return bad;
}

// The history slots that a tile of T taps reads before it has written
// them: the last T of the ring. zf_save keeps them, zf_restore puts them
// back after a narrow tile that has to be run again.
template <int T>
ZF_HD void zf_save(const int32_t (&h)[kZfTile], int32_t (&saved)[kZfTile]) {
#pragma unroll
  for (int j = kZfTile - T; j < kZfTile; ++j) saved[j] = h[j];
}

template <int T>
ZF_HD void zf_restore(int32_t (&h)[kZfTile], const int32_t (&saved)[kZfTile]) {
#pragma unroll
  for (int j = 0; j < kZfTile; ++j) h[j] = j >= kZfTile - T ? saved[j] : 0;
}

ZF_HD void zf_widen(const int32_t (&h)[kZfTile], uint64_t (&wide)[kZfTile]) {
#pragma unroll
  for (int j = 0; j < kZfTile; ++j) wide[j] = (uint64_t)(int64_t)h[j];
}

// One tile of one subframe with the tap count chosen at run time (`taps`
// from zf_round_taps). A tile that is not full runs 4, 8 or all kZfTile
// taps: the coefficients beyond a subframe's taps are zero.
ZF_HD void zf_run_wide(int taps, bool full, const uint64_t (&q)[kZfTile],
                       uint64_t (&h)[kZfTile], const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out, int width, int warm, int sh) {
  if (full) {
    ZF_WITH_TAPS(taps, T, zf_tile_wide<T, true>(q, h, in, out, width, warm, sh))
  } else if (taps <= 4) {
    zf_tile_wide<4, false>(q, h, in, out, width, warm, sh);
  } else if (taps <= 8) {
    zf_tile_wide<8, false>(q, h, in, out, width, warm, sh);
  } else {
    zf_tile_wide<kZfTile, false>(q, h, in, out, width, warm, sh);
  }
}

// The same for the narrow form, keeping in `saved` what zf_undo_narrow
// needs to put the history back. sh0 may be set if sh is 0 (the caller sets
// it where that holds for its whole warp). Returns zf_tile_narrow's flag.
ZF_HD uint32_t zf_run_narrow(int taps, bool full, bool sh0, const int32_t (&q)[kZfTile],
                             int32_t (&h)[kZfTile], int32_t (&saved)[kZfTile],
                             const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                             int width, int warm, int sh) {
  uint32_t bad = 0;
  if (full && sh0 && taps >= 1 && taps <= 4) {  // the fixed predictors
#define ZF_SH0(T)        \
  zf_save<T>(h, saved); \
  bad = zf_tile_narrow<T, true, true>(q, h, in, out, width, warm, 0)
    switch (taps) {
      case 1: ZF_SH0(1); break;
      case 2: ZF_SH0(2); break;
      case 3: ZF_SH0(3); break;
      default: ZF_SH0(4); break;
    }
#undef ZF_SH0
  } else if (full) {
    ZF_WITH_TAPS(taps, T, zf_save<T>(h, saved);
                 bad = zf_tile_narrow<T, true>(q, h, in, out, width, warm, sh))
  } else if (taps <= 4) {
    zf_save<4>(h, saved);
    bad = zf_tile_narrow<4, false>(q, h, in, out, width, warm, sh);
  } else if (taps <= 8) {
    zf_save<8>(h, saved);
    bad = zf_tile_narrow<8, false>(q, h, in, out, width, warm, sh);
  } else {
    zf_save<kZfTile>(h, saved);
    bad = zf_tile_narrow<kZfTile, false>(q, h, in, out, width, warm, sh);
  }
  return bad;
}

ZF_HD void zf_undo_narrow(int taps, bool full, int32_t (&h)[kZfTile],
                          const int32_t (&saved)[kZfTile]) {
  if (full) {
    ZF_WITH_TAPS(taps, T, zf_restore<T>(h, saved))
  } else if (taps <= 4) {
    zf_restore<4>(h, saved);
  } else if (taps <= 8) {
    zf_restore<8>(h, saved);
  } else {
    zf_restore<kZfTile>(h, saved);
  }
}
