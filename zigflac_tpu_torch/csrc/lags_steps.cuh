// The arithmetic of the LPC stage's windowed lag sums (lags.cu), shared with
// a host build that the CPU tests compile with g++.
//
// What a plane of B samples s needs under one Q8 window w (values 0..256),
// as ops/lpc.py's plain lag_sums computes it: for each lag k = 0..order the
// exact sum V_k = sum_i x_i x_{i+k} with x_i = s_i w_i, carried as the int64
// triple (l0, l1, l2), V_k = l0 2^48 + l1 2^24 + l2 with l1, l2 in
// [0, 2^24). An integer has one such triple, so any exact method gives the
// plain version's values bit for bit.
//
// A thread of the kernel owns a run of kZfLagRun consecutive samples of a
// tile and G consecutive lags k0 .. k0 + G - 1: it forms the windowed
// samples of its run and of the run's G - 1 + k0 successors in registers
// and adds its run's G products sums into G partials. Samples past the
// plane are 0, so their products vanish and no sum needs a mask.
//
// Two tiers of arithmetic, which give the same triples:
//
// * narrow, for int32 planes whose samples lie within +-2^16 (kZfLagNarrowBits
//   bits: the 17-bit side plane of 16-bit audio): |x| <= 2^24, a product is
//   one 32 x 32 -> 64-bit multiply-add of magnitude <= 2^48, and a run's
//   partial (32 products) stays within 2^53.
// * wide, for every other plane: the 24-bit limbs of the plain version,
//   hi = (x + 2^23) >> 24 in [-2^22, 2^22], lo = x - hi 2^24 in [-2^23, 2^23)
//   (|x| <= 2^46: the 33-bit side plane times 256 is below 2^41), and the
//   sums hh = sum hi hi', hl = sum hi lo' + lo hi', ll = sum lo lo', four
//   32 x 32 -> 64-bit products a pair. Over B < 2^16 samples |hh| < 2^60,
//   |hl| < 2^62 and |ll| < 2^62, so the plain version's sums, in any order,
//   stay in int64; a run's partials stay within 2^51.
//
// The partials of a warp add through 21-bit limbs (zf_lag_limbs21), whose
// 32-lane sums stay in 32 bits, so that 32-bit warp reductions add them
// exactly. A narrow lag's total over a whole plane can pass 2^63 (B 2^48),
// so its tile sums are kept as (sum >> 24, sum & (2^24 - 1)) pairs.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_LAG_HD __host__ __device__ __forceinline__
#else
#define ZF_LAG_HD inline
#endif

constexpr int kZfLagThreads = 128;  // threads of a CTA: one plane, one lag group
constexpr int kZfLagRun = 32;       // consecutive samples a thread owns
constexpr int kZfLagTile = kZfLagThreads * kZfLagRun;  // samples a tile
constexpr int kZfLagMaxOrder = 32;
constexpr int kZfLagMaxWindows = 32;
constexpr int kZfLagNarrowBits = 17;  // the narrow tier's widest sample
// lags a thread holds: G = 9 for orders up to 8 (one group holds every
// lag), else 13 (orders above 12 take two or three groups, the last
// starting at most at lag 26)
constexpr int kZfLagSmallGroup = 9;
constexpr int kZfLagGroup = 13;
constexpr int kZfLagMaxHalo = 2 * kZfLagGroup + kZfLagGroup - 1;
// staged samples of a tile (its runs and the last run's successors)
constexpr int kZfLagStage = kZfLagTile + kZfLagMaxHalo;
constexpr int64_t kZfLagM24 = (1 << 24) - 1;

// The staged index of local sample i: one pad slot after every 32, so that
// the lanes of a warp, whose runs start 32 samples apart, read 32 distinct
// banks (int32; 2-way for int64, whose loads take two phases anyway).
ZF_LAG_HD int zf_lag_pad(int i) { return i + (i >> 5); }
// The same for the int16 window: two pad slots (one bank) after every 32.
ZF_LAG_HD int zf_lag_pad16(int i) { return i + 2 * (i >> 5); }

constexpr int kZfLagStageSlots = kZfLagStage + (kZfLagStage >> 5) + 1;
constexpr int kZfLagStageSlots16 = kZfLagStage + 2 * (kZfLagStage >> 5) + 2;

// The plain version's limbs of a windowed sample.
ZF_LAG_HD void zf_lag_limbs(int64_t x, int32_t* hi, int32_t* lo) {
  const int64_t h = (x + (1 << 23)) >> 24;
  *hi = (int32_t)h;
  *lo = (int32_t)(x - h * (1 << 24));
}

// A run's narrow products: acc[g] += sum_i x(start + i) x(start + off + i + g)
// for i < kZfLagRun; kSame when off == 0 (the run's own samples lead the
// successors). x(i) is the windowed sample at local index i, as int32.
template <int G, bool kSame, typename X>
ZF_LAG_HD void zf_lag_run_narrow(const X& x, int start, int off, int64_t (&acc)[G]) {
  int32_t b[kZfLagRun + G - 1];
#pragma unroll
  for (int j = 0; j < kZfLagRun + G - 1; ++j) b[j] = x(start + off + j);
#pragma unroll
  for (int i = 0; i < kZfLagRun; ++i) {
    const int64_t a = kSame ? b[i] : x(start + i);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] += a * b[i + g];
  }
}

// A run's wide products through the limbs, x(i) as int64: four products a
// pair, so the run goes in pieces of kZfLagWideStep samples, one after the
// other (each piece's code as long as a narrow run's, half the limbs held).
constexpr int kZfLagWideStep = kZfLagRun / 2;

template <int G, bool kSame, typename X>
ZF_LAG_HD void zf_lag_piece_wide(const X& x, int start, int off, int64_t (&hh)[G],
                                 int64_t (&hl)[G], int64_t (&ll)[G]) {
  int32_t bh[kZfLagWideStep + G - 1], bl[kZfLagWideStep + G - 1];
#pragma unroll
  for (int j = 0; j < kZfLagWideStep + G - 1; ++j)
    zf_lag_limbs(x(start + off + j), &bh[j], &bl[j]);
#pragma unroll
  for (int i = 0; i < kZfLagWideStep; ++i) {
    int32_t ah32, al32;
    if (kSame) {
      ah32 = bh[i];
      al32 = bl[i];
    } else {
      zf_lag_limbs(x(start + i), &ah32, &al32);
    }
    const int64_t ah = ah32, al = al32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      hh[g] += ah * bh[i + g];
      hl[g] += ah * bl[i + g] + al * bh[i + g];
      ll[g] += al * bl[i + g];
    }
  }
}

template <int G, bool kSame, typename X>
ZF_LAG_HD void zf_lag_run_wide(const X& x, int start, int off, int64_t (&hh)[G],
                               int64_t (&hl)[G], int64_t (&ll)[G]) {
#pragma unroll 1
  for (int piece = start; piece < start + kZfLagRun; piece += kZfLagWideStep)
    zf_lag_piece_wide<G, kSame>(x, piece, off, hh, hl, ll);
}

// v = a + b 2^21 + c 2^42 with a, b in [0, 2^21) and c = v >> 42: for
// |v| < 2^57 the 32-lane sums of a and b stay below 2^26 and that of c
// within 2^20, so 32-bit sums add them exactly.
ZF_LAG_HD void zf_lag_limbs21(int64_t v, uint32_t* a, uint32_t* b, int32_t* c) {
  *a = (uint32_t)(v & 0x1FFFFF);
  *b = (uint32_t)((v >> 21) & 0x1FFFFF);
  *c = (int32_t)(v >> 42);
}

ZF_LAG_HD int64_t zf_lag_join21(uint32_t sa, uint32_t sb, int32_t sc) {
  return (int64_t)sa + (int64_t)sb * (1LL << 21) + (int64_t)sc * (1LL << 42);
}

// A narrow lag's running total as (hi, lo), value hi 2^24 + lo: add a tile's
// sum s (|s| < 2^61).
ZF_LAG_HD void zf_lag_narrow_add(int64_t s, int64_t* hi, int64_t* lo) {
  *hi += s >> 24;
  *lo += s & kZfLagM24;
}

// The normalized triple of a narrow total.
ZF_LAG_HD void zf_lag_narrow_triple(int64_t hi, int64_t lo, int64_t* out) {
  const int64_t h = hi + (lo >> 24);
  out[0] = h >> 24;
  out[1] = h & kZfLagM24;
  out[2] = lo & kZfLagM24;
}

// The normalized triple of the wide sums, as the plain version forms it.
ZF_LAG_HD void zf_lag_wide_triple(int64_t hh, int64_t hl, int64_t ll, int64_t* out) {
  const int64_t hl2 = hl + (ll >> 24);
  out[0] = hh + (hl2 >> 24);
  out[1] = hl2 & kZfLagM24;
  out[2] = ll & kZfLagM24;
}

// The lags a thread holds for an LPC order, and the lag groups (CTAs a
// plane) that cover lags 0..order.
ZF_LAG_HD int zf_lag_group(int order) {
  return order < kZfLagSmallGroup ? kZfLagSmallGroup : kZfLagGroup;
}
ZF_LAG_HD int zf_lag_groups(int order) {
  const int g = zf_lag_group(order);
  return (order + g) / g;
}
