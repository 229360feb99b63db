// Per-plane arithmetic of the encoder's analysis, shared by the CUDA kernels
// (analyze.cu) and a host build that the CPU tests compile with g++.
//
// What a plane of B samples needs, as ops/analyze.py's plain versions compute
// it (best_fixed_order, residuals_for_order, rice_estimate):
//
// * the five fixed-order differences d_k[i] = sum_m BINOM[k][m] x[i-m] for
//   i >= k, their abs-sums and, in wide mode, whether some |d_k| exceeds
//   2^31 - 1: such an order is disqualified (total I64_MAX), and the first
//   minimum (strict <) is the order;
// * that order's residual in wrapping 64-bit arithmetic, cut to int32, the
//   first `order` slots zero;
// * the u32 zigzag of each residual, summed per partition at the top
//   partition order po_top = min(max_rice_order, ctz(B)) <= 8, and the
//   pyramid of coarser sums;
// * per partition (node) the cost of Rice param k, psz*(k+1) + ((s - psz/2)
//   >> k), for k = 0..max_param+1, with the plain version's three fixes, and
//   per partition order the level total, the last minimum (<=) winning.
//
// A thread of the kernel owns a run of kZfRun consecutive samples. The
// differences are taken one from the next (d_k[i] = d_{k-1}[i] -
// d_{k-1}[i-1]), which in wrapping arithmetic equals the tap form above, so
// a run needs only its four predecessors.
//
// Integer policy: the plain version computes in int64 with torch's wrapping
// arithmetic. The wide forms here run every sum and product that could pass
// 2^63 in uint64_t and read it back as int64_t, so the results are torch's
// bit for bit on any input and nothing is undefined. The narrow forms run in
// 32 bits only where zf_narrow_ok proves that nothing leaves 32 bits, and
// then give the same numbers. Shifts stay below the width.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif

constexpr int64_t kZfI64Max = INT64_MAX;  // a disqualified candidate's cost
constexpr int kZfParamCols = 256;         // params columns a plane
constexpr int kZfMaxPartOrder = 8;        // the partition orders the params hold
constexpr int kZfMaxNodes = (2 << kZfMaxPartOrder) - 1;
constexpr int kZfMaxParam4Bit = 14;       // above it a level takes method 1
constexpr int64_t kZfI32Max = 2147483647;
constexpr int kZfRun = 16;                // consecutive samples a thread owns
// The narrow arithmetic's limit of |x|. With every sample of a run and its
// predecessors within +-(2^23 - 1): |d_k| <= 2^k |x| < 2^27, so no order
// leaves int32 (no wide disqualification); a run's abs-sum of d_4 is below
// 16 * 2^27 = 2^31; a residual's zigzag is below 2^28, and a run's zigzag
// sum below 2^32.
constexpr uint32_t kZfNarrowMaxAbs = (1u << 23) - 1;

ZF_HD int zf_ilog2(int64_t v) {  // v >= 1
#ifdef __CUDA_ARCH__
  return 63 - __clzll(v);
#else
  return 63 - __builtin_clzll((uint64_t)v);
#endif
}

ZF_HD int zf_ctz(int64_t v) {  // v >= 1
#ifdef __CUDA_ARCH__
  return __ffsll(v) - 1;
#else
  return __builtin_ctzll((uint64_t)v);
#endif
}

// The top partition order of a block: min(max_rice_order, ctz(B)). The
// callers refuse a block whose po_top exceeds kZfMaxPartOrder.
ZF_HD int zf_po_top(int64_t b, int max_rice_order) {
  const int c = zf_ctz(b);
  return max_rice_order < c ? max_rice_order : c;
}

// Nodes of the partition-sum pyramid: level po holds 2^po nodes from
// offset 2^po - 1, level 0 first.
ZF_HD int zf_nodes(int po_top) { return (2 << po_top) - 1; }
ZF_HD int zf_level_offset(int po) { return (1 << po) - 1; }

// The partition-order limit of a predictor order (rice.zig:76-80): 15 for
// order 0, else log2(B) - log2(order), at most po_top. The plain version
// reads it from a table of orders 0..32.
ZF_HD int zf_dyn_max_po(int64_t order, int64_t b, int po_top) {
  const int lim = order <= 0 ? 15 : zf_ilog2(b) - zf_ilog2(order);
  return lim < po_top ? lim : po_top;
}

ZF_HD int64_t zf_abs(int64_t v) {  // torch's abs: INT64_MIN stays itself
  return (int64_t)(v < 0 ? uint64_t(0) - (uint64_t)v : (uint64_t)v);
}

ZF_HD uint32_t zf_abs_u32(int32_t v) { return v < 0 ? 0u - (uint32_t)v : (uint32_t)v; }

// Whether a warp whose samples (runs and predecessors) reach at most
// max_abs = max |x| may take the narrow arithmetic.
ZF_HD bool zf_narrow_ok(uint32_t max_abs) { return max_abs <= kZfNarrowMaxAbs; }

// One thread's share of pass 1: abs-sums per order, a bit per order whose
// |d| left int32 (torch's abs: INT64_MIN does not count), and whether every
// sample equals the plane's first.
struct ZfFixedAcc {
  uint64_t sum[5];
  unsigned over;
  bool all_eq;
};

ZF_HD void zf_fixed_acc_init(ZfFixedAcc& a) {
  for (int k = 0; k < 5; ++k) a.sum[k] = 0;
  a.over = 0;
  a.all_eq = true;
}

ZF_HD void zf_fixed_acc_merge(ZfFixedAcc& a, const ZfFixedAcc& b) {
  for (int k = 0; k < 5; ++k) a.sum[k] += b.sum[k];
  a.over |= b.over;
  a.all_eq = a.all_eq && b.all_eq;
}

// The differences at the sample before a run, e[k] = d_k[start - 1], from
// its predecessors p[m] = x[start - 1 - m] (0 before the plane).
template <typename A>
ZF_HD void zf_run_prev_diffs(const A (&p)[4], A (&e)[4]) {
  const A d1a = p[0] - p[1], d1b = p[1] - p[2], d1c = p[2] - p[3];
  const A d2a = d1a - d1b, d2b = d1b - d1c;
  e[0] = p[0];
  e[1] = d1a;
  e[2] = d2a;
  e[3] = d2a - d2b;
}

// Pass 1 over a run of R samples from `start` (x[r] = x[start + r], 0 past
// the plane; p its predecessors). kMasked: the run holds a sample before 4
// or past b; else every d_k counts. Narrow form: the warp passed
// zf_narrow_ok, so every difference and a run's sums fit 32 bits.
template <int R, bool kMasked>
ZF_HD void zf_run_fixed_narrow(const int32_t (&x)[R], const int32_t (&p)[4], int start,
                               int b, int32_t first, ZfFixedAcc& a) {
  int32_t e[4];
  zf_run_prev_diffs(p, e);
  uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0, s4 = 0;
  bool eq = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t d0 = x[r], d1 = d0 - e[0], d2 = d1 - e[1], d3 = d2 - e[2], d4 = d3 - e[3];
    e[0] = d0;
    e[1] = d1;
    e[2] = d2;
    e[3] = d3;
    const int i = start + r;
    if (!kMasked || i < b) {
      s0 += zf_abs_u32(d0);
      if (!kMasked || i >= 1) s1 += zf_abs_u32(d1);
      if (!kMasked || i >= 2) s2 += zf_abs_u32(d2);
      if (!kMasked || i >= 3) s3 += zf_abs_u32(d3);
      if (!kMasked || i >= 4) s4 += zf_abs_u32(d4);
      eq = eq && d0 == first;
    }
  }
  a.sum[0] += s0;
  a.sum[1] += s1;
  a.sum[2] += s2;
  a.sum[3] += s3;
  a.sum[4] += s4;
  a.all_eq = a.all_eq && eq;
}

// Pass 1, wide form: 64-bit wrapping arithmetic on any int32 or int64 plane.
template <int R, bool kMasked, typename T>
ZF_HD void zf_run_fixed_wide(const T (&x)[R], const T (&p)[4], int start, int b, int64_t first,
                             ZfFixedAcc& a) {
  uint64_t e[4], q[4];
  for (int m = 0; m < 4; ++m) q[m] = (uint64_t)(int64_t)p[m];
  zf_run_prev_diffs(q, e);
  bool eq = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint64_t d[5];
    d[0] = (uint64_t)(int64_t)x[r];
    d[1] = d[0] - e[0];
    d[2] = d[1] - e[1];
    d[3] = d[2] - e[2];
    d[4] = d[3] - e[3];
    for (int k = 0; k < 4; ++k) e[k] = d[k];
    const int i = start + r;
    if (!kMasked || i < b) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (!kMasked || i >= k) {
          const int64_t v = zf_abs((int64_t)d[k]);
          a.sum[k] += (uint64_t)v;
          if (v > kZfI32Max) a.over |= 1u << k;
        }
      }
      eq = eq && (int64_t)d[0] == first;
    }
  }
  a.all_eq = a.all_eq && eq;
}

// The order (first minimum of the totals) and whether it is usable: in wide
// mode an order whose |d| left int32 costs I64_MAX, and a winner at I64_MAX
// is not usable.
ZF_HD void zf_choose_fixed_order(const ZfFixedAcc& a, bool wide, int* order, bool* ok) {
  int64_t best = 0;
  int idx = 0;
  for (int k = 0; k < 5; ++k) {
    int64_t t = (int64_t)a.sum[k];
    if (wide && ((a.over >> k) & 1)) t = kZfI64Max;
    if (k == 0 || t < best) {
      best = t;
      idx = k;
    }
  }
  *order = idx;
  *ok = !wide || best != kZfI64Max;
}

// The residuals of fixed order kOrder over a run, cut to int32; 0 in the
// warmup (i < order) and past the plane. A is int32_t (narrow: exact) or
// uint64_t (wide: wrapping, then cut). Only the kOrder differences it needs
// are taken.
template <typename A, int kOrder, int R, bool kMasked, typename T>
ZF_HD void zf_run_residual_k(const T (&x)[R], const T (&p)[4], int start, int b,
                             int32_t (&res)[R]) {
  A e[4], q[4];
  for (int m = 0; m < 4; ++m) q[m] = (A)p[m];
  zf_run_prev_diffs(q, e);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    A d[kOrder + 1];
    d[0] = (A)x[r];
#pragma unroll
    for (int k = 1; k <= kOrder; ++k) d[k] = d[k - 1] - e[k - 1];
#pragma unroll
    for (int k = 0; k < kOrder; ++k) e[k] = d[k];
    const int i = start + r;
    res[r] = (kMasked && (i < kOrder || i >= b)) ? 0 : (int32_t)(uint32_t)d[kOrder];
  }
}

// The chosen order's residuals of a run (the order is the same for the
// whole plane, so the branch is too).
template <typename A, int R, bool kMasked, typename T>
ZF_HD void zf_run_residual(const T (&x)[R], const T (&p)[4], int start, int b, int order,
                           int32_t (&res)[R]) {
  switch (order) {
    case 0: zf_run_residual_k<A, 0, R, kMasked>(x, p, start, b, res); break;
    case 1: zf_run_residual_k<A, 1, R, kMasked>(x, p, start, b, res); break;
    case 2: zf_run_residual_k<A, 2, R, kMasked>(x, p, start, b, res); break;
    case 3: zf_run_residual_k<A, 3, R, kMasked>(x, p, start, b, res); break;
    default: zf_run_residual_k<A, 4, R, kMasked>(x, p, start, b, res); break;
  }
}

// u32 zigzag with the i32 wrapping shift (rice.zig:268-271).
ZF_HD uint32_t zf_zigzag(int32_t r) {
  const uint32_t u = (uint32_t)r;
  return (u << 1) ^ (0u - (u >> 31));
}

// A run's zigzag sums on either side of `split` (the run's first sample of
// its next partition, R if none): for partitions of at least R samples, a
// run meets at most two. S is uint32_t for a narrow warp (the sum stays
// below 2^32), else uint64_t.
template <typename S, int R>
ZF_HD void zf_run_split_sums(const int32_t (&res)[R], int split, S* before, S* after) {
  S a = 0, c = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const S z = zf_zigzag(res[r]);
    if (r < split) a += z;
    else c += z;
  }
  *before = a;
  *after = c;
}

// Partitions shorter than a run: emit(partition, zigzag sum) for each
// partition the run meets, in order (sums of samples past the plane are 0).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int R, typename Emit>
ZF_HD void zf_run_pieces(const int32_t (&res)[R], int start, int psz, Emit emit) {
  int key = start / psz, next = (key + 1) * psz;
  uint64_t acc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (start + r == next) {
      emit(key, acc);
      ++key;
      next += psz;
      acc = 0;
    }
    acc += zf_zigzag(res[r]);
  }
  emit(key, acc);
}

// The size of node j of level po; the first node of a level loses the
// warmup (it may be 0 or negative: then every one of its samples is warmup).
ZF_HD int64_t zf_node_psz(int64_t b, int po, int64_t j, int64_t order) {
  const int64_t psz = b >> po;
  return j == 0 ? psz - order : psz;
}

ZF_HD int64_t zf_floor_half(int64_t a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

ZF_HD int zf_bit_length(uint64_t v) {
#ifdef __CUDA_ARCH__
  return 64 - __clzll((long long)v);
#else
  return v ? 64 - __builtin_clzll(v) : 0;
#endif
}

// The best param k and its cost bc of one partition: zigzag sum s >= 0, size
// psz. The plain version's sweep with its three fixes, in its int64 terms:
//   lhs = max(s - floor(psz/2), 0); the k-sweep over 0..max_param+1 keeps
//   the first minimum of f(k) = psz*(k + 1) + (lhs >> k);
//   the escape param (max_param + 1) costs psz*(max_param + 1);
//   0 < s < psz/2: the reference's u64 subtraction wraps, every k >= 1 costs
//   at least 2^33, so k = 0 wins at psz - psz/2 + s;
//   s == 0 (every all-warmup partition among them): the escape param at 5.
// No sweep runs: with q_k = lhs >> k, f(k + 1) - f(k) = psz - ceil(q_k / 2)
// never falls as k rises, so f falls strictly until the first k with q_k <=
// 2*psz and never after: that k (capped at max_param + 1) is the sweep's
// first minimum. For psz >= 0 it is L - a or L - a + 1 (at least 0), L and a
// the bit lengths of lhs and 2*psz + 1; for psz < 0 no k qualifies.
// s stays below 2^48 (B < 2^16 zigzags below 2^32), so nothing here wraps.
// The cost is below 2^22 in magnitude: at most psz*(k + 1) + 2*psz <= 34*psz
// at the first minimum, psz*(max_param + 1) at the cap, 5 for an empty
// partition, and -31 * 31 where the first partition's size is negative
// (B >> po >= 1, order <= 32). A level's total stays below 2^22 too (its
// sizes add up to at most B): the kernel sums levels in 32 bits.
ZF_HD void zf_rice_node(int64_t s, int64_t psz, int max_param, int* k_out, int64_t* bc_out) {
  // selects, not early returns: two nodes of a thread run side by side
  const int64_t half = zf_floor_half(psz);
  const uint64_t lhs = s > half ? (uint64_t)(s - half) : 0;
  const int cap = max_param + 1;
  int k0 = zf_bit_length(lhs) - zf_bit_length(2 * (uint64_t)psz + 1);
  k0 = k0 < 0 ? 0 : k0;
  k0 += (lhs >> k0) >= 2 * (uint64_t)psz + 1;
  int k = psz >= 0 && k0 < cap ? k0 : cap;
  int64_t bc = k == cap ? psz * cap : psz * (k + 1) + (int64_t)(lhs >> k);
  if (s < half) {
    k = 0;
    bc = psz - half + s;
  }
  if (s == 0) {
    k = cap;
    bc = 5;
  }
  *k_out = k;
  *bc_out = bc;
}

// One level's sum of its nodes' costs (wrapping, as torch's int64 sum) and
// whether any took a param above 14.
struct ZfLevelAcc {
  uint64_t bc;
  bool wide_param;
};

ZF_HD void zf_level_acc_add(ZfLevelAcc& a, int k, int64_t bc) {
  a.bc += (uint64_t)bc;
  a.wide_param = a.wide_param || k > kZfMaxParam4Bit;
}

// The level's method (1: 5-bit params, only where max_param > 14) and its
// total, I64_MAX above the order's partition-order limit.
ZF_HD void zf_level_total(const ZfLevelAcc& a, int po, int dyn_max_po, int max_param,
                          int* method, int64_t* total) {
  *method = max_param > kZfMaxParam4Bit && a.wide_param ? 1 : 0;
  const uint64_t nparts = uint64_t(1) << po;
  const int64_t t = (int64_t)(a.bc + (uint64_t)(*method + 4) * nparts);
  *total = dyn_max_po >= po ? t : kZfI64Max;
}

// The partition order is the last minimum of the level totals (ties keep the
// larger order, rice.zig:258): the level of the least key. A total lies in
// [-961 + 4, 2^22): a level's nodes cost at most 34 * B + 5 * 256 together
// (zf_rice_node) plus 5 * 256 for the params, and a first node of negative
// size at least -31 * 31; or it is I64_MAX above the order's limit, which
// keys after every other total.
ZF_HD uint32_t zf_part_order_key(int64_t total, int po) {
  const uint32_t t = total == kZfI64Max ? 0x0FFFFFFFu : (uint32_t)(total + 1024);
  return (t << 4) | (uint32_t)(15 - po);
}

ZF_HD int zf_part_order_of_key(uint32_t key) { return 15 - (int)(key & 15); }
