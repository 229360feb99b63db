// Per-plane arithmetic of the encoder's analysis, shared by the CUDA kernel
// (analyze.cu) and a host build that the CPU tests compile with g++.
//
// What a plane of B samples needs, as ops/analyze.py's plain versions compute
// it (best_fixed_order, residuals_for_order, rice_estimate):
//
// * the five fixed-order differences d_k[i] = sum_m BINOM[k][m] x[i-m] for
//   i >= k, their abs-sums and, in wide mode, their largest |d_k|: an order
//   whose |d| exceeds 2^31 - 1 is disqualified (total I64_MAX), and the
//   first minimum (strict <) is the order;
// * that order's residual in wrapping 64-bit arithmetic, cut to int32, the
//   first `order` slots zero;
// * the u32 zigzag of each residual, summed per partition at the top
//   partition order po_top = min(max_rice_order, ctz(B)), and the pyramid of
//   coarser sums;
// * per partition (node) the cost of Rice param k, psz*(k+1) + ((s - psz/2)
//   >> k), for k = 0..max_param+1, with the plain version's three fixes, and
//   per partition order the level total, the last minimum (<=) winning.
//
// Integer policy: the plain version computes in int64 with torch's wrapping
// arithmetic. Here every sum and product that could pass 2^63 runs in
// uint64_t and is read back as int64_t, so the results are torch's bit for
// bit on any input and nothing is undefined. Shifts stay below the width.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define ZF_HD __host__ __device__ __forceinline__
#else
#define ZF_HD inline
#endif

constexpr int64_t kZfI64Max = INT64_MAX;  // a disqualified candidate's cost
constexpr int kZfParamCols = 256;         // params columns a plane
constexpr int kZfMaxParam4Bit = 14;       // above it a level takes method 1
constexpr int64_t kZfI32Max = 2147483647;

ZF_HD int zf_ilog2(int64_t v) {  // v >= 1
  int n = -1;
  for (uint64_t u = (uint64_t)v; u; u >>= 1) ++n;
  return n;
}

ZF_HD int zf_ctz(int64_t v) {  // v >= 1
  int n = 0;
  for (uint64_t u = (uint64_t)v; u && !(u & 1); u >>= 1) ++n;
  return n;
}

// The top partition order of a block: min(max_rice_order, ctz(B)).
ZF_HD int zf_po_top(int64_t b, int max_rice_order) {
  const int c = zf_ctz(b);
  return max_rice_order < c ? max_rice_order : c;
}

// Nodes of the partition-sum pyramid: level po holds 2^po nodes from
// offset 2^po - 1, level 0 first.
ZF_HD int64_t zf_nodes(int po_top) { return (int64_t(2) << po_top) - 1; }
ZF_HD int64_t zf_level_offset(int po) { return (int64_t(1) << po) - 1; }

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

// h[m] = x[i - m] (0 before the plane). d[k] = the k-th difference at i in
// BINOM's tap form, (1), (1, -1), (1, -2, 1), (1, -3, 3, -1), (1, -4, 6, -4, 1).
ZF_HD void zf_fixed_diffs(const int64_t (&h)[5], int64_t (&d)[5]) {
  const uint64_t a = (uint64_t)h[0], b = (uint64_t)h[1], c = (uint64_t)h[2],
                 e = (uint64_t)h[3], f = (uint64_t)h[4];
  d[0] = (int64_t)a;
  d[1] = (int64_t)(a - b);
  d[2] = (int64_t)(a - 2 * b + c);
  d[3] = (int64_t)(a - 3 * b + 3 * c - e);
  d[4] = (int64_t)(a - 4 * b + 6 * c - 4 * e + f);
}

// One thread's share of pass 1: abs-sums and largest |d| per order, and
// whether every sample equals the plane's first.
struct ZfFixedAcc {
  uint64_t sum[5];
  int64_t max[5];
  bool all_eq;
};

ZF_HD void zf_fixed_acc_init(ZfFixedAcc& a) {
  for (int k = 0; k < 5; ++k) {
    a.sum[k] = 0;
    a.max[k] = 0;
  }
  a.all_eq = true;
}

// Sample i (h as for zf_fixed_diffs); `first` is the plane's sample 0.
ZF_HD void zf_fixed_acc_add(ZfFixedAcc& a, const int64_t (&h)[5], int64_t i, int64_t first) {
  int64_t d[5];
  zf_fixed_diffs(h, d);
  for (int k = 0; k < 5; ++k) {
    if (i >= k) {
      const int64_t v = zf_abs(d[k]);
      a.sum[k] += (uint64_t)v;
      a.max[k] = v > a.max[k] ? v : a.max[k];
    }
  }
  a.all_eq = a.all_eq && h[0] == first;
}

ZF_HD void zf_fixed_acc_merge(ZfFixedAcc& a, const ZfFixedAcc& b) {
  for (int k = 0; k < 5; ++k) {
    a.sum[k] += b.sum[k];
    a.max[k] = b.max[k] > a.max[k] ? b.max[k] : a.max[k];
  }
  a.all_eq = a.all_eq && b.all_eq;
}

// The order (first minimum of the totals) and whether it is usable: in wide
// mode an order whose |d| left int32 costs I64_MAX, and a winner at I64_MAX
// is not usable.
ZF_HD void zf_choose_fixed_order(const ZfFixedAcc& a, bool wide, int* order, bool* ok) {
  int64_t best = 0;
  int idx = 0;
  for (int k = 0; k < 5; ++k) {
    int64_t t = (int64_t)a.sum[k];
    if (wide && a.max[k] > kZfI32Max) t = kZfI64Max;
    if (k == 0 || t < best) {
      best = t;
      idx = k;
    }
  }
  *order = idx;
  *ok = !wide || best != kZfI64Max;
}

// The residual at i of a fixed order, wrapping, cut to int32; 0 in the
// warmup (i < order).
ZF_HD int32_t zf_fixed_residual(int order, const int64_t (&h)[5], int64_t i) {
  if (i < order) return 0;
  int64_t d[5];
  zf_fixed_diffs(h, d);
  int64_t v = d[0];
  for (int k = 1; k < 5; ++k)  // selects, not an index: d stays in registers
    if (order == k) v = d[k];
  return (int32_t)(uint32_t)(uint64_t)v;
}

// u32 zigzag with the i32 wrapping shift (rice.zig:268-271).
ZF_HD uint32_t zf_zigzag(int32_t r) {
  const uint32_t u = (uint32_t)r;
  return (u << 1) ^ (0u - (u >> 31));
}

// The size of node j of level po; the first node of a level loses the
// warmup (it may be 0 or negative: then every one of its samples is warmup).
ZF_HD int64_t zf_node_psz(int64_t b, int po, int64_t j, int64_t order) {
  const int64_t psz = b >> po;
  return j == 0 ? psz - order : psz;
}

ZF_HD int64_t zf_floor_half(int64_t a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

// The best param k and its cost bc of one partition: zigzag sum s >= 0, size
// psz. The plain version's sweep with its three fixes, in its int64 terms:
//   lhs = max(s - floor(psz/2), 0); the k-sweep keeps the first minimum;
//   the escape param (max_param + 1) costs psz*(max_param + 1);
//   0 < s < psz/2: the reference's u64 subtraction wraps, every k >= 1 costs
//   at least 2^33, so k = 0 wins at psz - psz/2 + s;
//   s == 0 (every all-warmup partition among them): the escape param at 5.
// s stays below 2^48 (B < 2^16 zigzags below 2^32), so nothing here wraps.
ZF_HD void zf_rice_node(int64_t s, int64_t psz, int max_param, int* k_out, int64_t* bc_out) {
  const int64_t half = zf_floor_half(psz);
  const int64_t lhs = s - half > 0 ? s - half : 0;
  int64_t best_bc = psz + lhs;
  int best_k = 0;
  for (int k = 1; k <= max_param + 1; ++k) {
    const int64_t bc = psz * (k + 1) + (lhs >> k);
    if (bc < best_bc) {
      best_k = k;
      best_bc = bc;
    }
  }
  if (best_k == max_param + 1) best_bc = psz * (max_param + 1);
  if (s < half && s != 0) {
    best_k = 0;
    best_bc = psz - half + s;
  }
  if (s == 0) {
    best_k = max_param + 1;
    best_bc = 5;
  }
  *k_out = best_k;
  *bc_out = best_bc;
}

// One thread's share of a level: the sum of its nodes' costs (wrapping, as
// torch's int64 sum) and whether any took a param above 14.
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

// The partition order: the last minimum of the level totals (ties keep the
// larger order, rice.zig:258).
ZF_HD int zf_choose_part_order(const int64_t* totals, int po_top) {
  int best = 0;
  for (int po = 1; po <= po_top; ++po)
    if (totals[po] <= totals[best]) best = po;
  return best;
}
