// The encoder's per-plane analysis for Hopper (sm_90a): the fixed-order
// search, the chosen order's residual and the Rice partition sweep of every
// plane of a batch, one CTA per plane.
//
// Replaces what the JAX package leaves to XLA fusions inside its one jitted
// batch program (zigflac_tpu/ops/analyze.py: best_fixed_order :118,
// residuals_for_order :163, rice_sums_pyramid :181, rice_estimate :197,
// driven by analyze_planes :432). The TPU forms (the u32 sweep speculation
// and its sweep_unsafe flag, where-chains in place of gathers, a batch-minor
// layout for XLA's layout assignment) are not carried over.
//
// zf_analyze_fixed, per plane of B samples (int32, or int64 for the 33-bit
// side plane), 256 threads, tiles of 256 x kZfRun = 4096 samples. On the
// H100 what holds it back is latency, not bytes: each CTA's chain of loads,
// warp sums, barriers and the sweep, which four CTAs an SM (64 registers)
// overlap only partly (tools/torch_analyze_phases.py times the chain's
// phases). The design cuts the chain and the instructions on it:
//
// * Each thread owns a run of kZfRun (16) consecutive samples of a tile,
//   loaded once with 16-byte loads where the plane allows it. The four
//   samples before a run come from the lane below by __shfl_up_sync (lane 0
//   reads them from memory). Where the plane is one tile (B <= 4096, config
//   1's 4096 among them), the run stays in registers from the order search
//   to the residual store: pass 2 loads nothing. Larger planes load each
//   tile again in pass 2 (from L2).
// * Narrow arithmetic, chosen per warp: an int32 plane's warp whose samples
//   all lie within +-(2^23 - 1) (one __reduce_max_sync; zf_narrow_ok in
//   analyze_steps.cuh) takes differences, abs-sums and zigzag sums in 32
//   bits, which cannot leave them there; every other warp, and every int64
//   plane, runs the 64-bit wrapping form. The differences are taken one
//   from the next, four subtractions a sample; the residual takes only the
//   chosen order's.
// * Pass 1's block reduction: each warp sums its lanes' totals with one
//   __reduce_add_sync where every value is below 2^26 (else four 16-bit
//   limbs), one barrier, then every thread merges the eight warps' partials
//   itself and picks the order: no serial merge by one thread.
// * Pass 2 writes the residuals (16-byte stores where B % 4 == 0) and adds
//   each run's zigzag sum to its partition at the top order po_top with no
//   per-sample division: where partitions hold at least a run (config 1: 16
//   samples, one run), a run meets at most two partitions; lanes of one
//   partition sum by a segmented shuffle scan (skipped when no two lanes
//   share one), and the last adds it into shared memory, by a plain store
//   where no other warp shares the partition (a 64-bit shared atomicAdd is
//   a compare-and-swap loop on sm_90). Shorter partitions (B = 1152 at
//   order 7: 9 samples) are added piece by piece.
// * The Rice sweep (rice_sweep): po_top <= 8 (the wrappers refuse more), so
//   the top sums are at most 256, in static shared memory. Every node of
//   every level goes at once, two slots a thread, with no pyramid built: a
//   node of levels 5-8 sums at most eight top sums, the levels below share
//   one warp that scans them. A node's param comes in closed form
//   (zf_rice_node), not from a sweep over k. A level's costs add in 32 bits
//   (one __reduce_add_sync a warp and level); after one barrier warp 0
//   totals the levels, takes the last minimum as the least of packed keys
//   (one __reduce_min_sync) and writes the params from the kept best
//   params. Three barriers a plane in all.
//
// zf_rice_estimate takes the same sweep over residuals and orders the
// caller gives (the LPC candidate, orders 1-32). Its input pass is pass 2's
// input half: runs of kZfRun residuals loaded with 16-byte loads, zigzagged
// in registers, summed split at the partition boundary and added as pass 2
// adds them. Its bound is bytes too: config 3's LPC residuals (4 x 1024
// planes of 4096) are 67 MB read, ~0.023 ms.
//
// Its bound on the H100 is bytes: a config-1 batch (4 x 1024 planes of 4096
// int32 samples) reads 67 MB of planes and writes 67 MB of residuals and
// 8.4 MB of params, ~0.043 ms at 3.35 TB/s.
//
// The C entry points are bound with ctypes (ops/_build.py, ops/analyze.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "analyze_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kZfRun;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kZfParamCols, "one params column a thread");
static_assert(2 * kThreads >= kZfMaxNodes, "two pyramid nodes a thread");

struct Sweep {
  uint64_t top[kZfParamCols];  // the zigzag sums at the top partition order
  int level_bc[kZfMaxPartOrder + 1][kWarps];  // each warp's share of a level
  unsigned level_wide[kZfMaxPartOrder + 1][kWarps];
  uint8_t kbest[kZfMaxNodes];  // each node's best param, level 0 first
};

// A 64-bit warp sum: one 32-bit sum where every lane's value is below 2^26,
// else four 16-bit limbs (each limb's sum stays below 2^21); exact modulo
// 2^64.
__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  if (!__any_sync(kFull, v >> 26)) return __reduce_add_sync(kFull, (unsigned)v);
  const unsigned l0 = __reduce_add_sync(kFull, (unsigned)(v & 0xFFFFu));
  const unsigned l1 = __reduce_add_sync(kFull, (unsigned)(v >> 16) & 0xFFFFu);
  const unsigned l2 = __reduce_add_sync(kFull, (unsigned)(v >> 32) & 0xFFFFu);
  const unsigned l3 = __reduce_add_sync(kFull, (unsigned)(v >> 48));
  return (uint64_t)l0 + ((uint64_t)l1 << 16) + ((uint64_t)l2 << 32) + ((uint64_t)l3 << 48);
}

// Zero the top level; the caller's next barrier orders it before the adds
// that fill it.
__device__ __forceinline__ void sweep_zero(Sweep& sh, int po_top) {
  for (int j = threadIdx.x; j < (1 << po_top); j += kThreads) sh.top[j] = 0;
}

__device__ __forceinline__ void rice_finish(Sweep& sh, int b, int po_top, int64_t order,
                                            int max_param, int64_t* bits, int64_t* method,
                                            int64_t* part_order, int64_t* params);

// The sum of w <= 8 top-level sums from top[first].
__device__ __forceinline__ uint64_t top_sum(const Sweep& sh, int first, int w) {
  uint64_t s = 0;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    if (m < w) s += sh.top[first + m];
  return s;
}

// The Rice estimate from the top-level sums (every thread, after a barrier
// that follows their last add). Writes bits, method, part_order and the
// params row.
//
// The nodes of every level go at once, two slots a thread, the levels laid
// out from the top down (slot 0 is the top level's node 0), so that a warp's
// 32 slots hold one level of at least 32 nodes (levels 5-8, a node's sum
// read as at most 8 top sums) and one level's costs add in one warp sum.
// The levels below 5 (at most 31 nodes) share one warp's slots: its lane l
// holds the sum of node l of level H = min(po_top, 5), an inclusive scan
// over the lanes gives every smaller node's sum as a difference of two
// prefixes, and their costs add per level the same way.
__device__ __forceinline__ void rice_sweep(Sweep& sh, int b, int po_top, int64_t order,
                                           int max_param, int64_t* bits, int64_t* method,
                                           int64_t* part_order, int64_t* params) {
  const int t = threadIdx.x, lane = t & 31, warp = t / 32;
  const int nodes = zf_nodes(po_top), all = 2 << po_top;  // all - slot: slots left
  const int small_chunk = po_top >= 5 ? (1 << (po_top - 4)) - 1 : 0;
  int mine = 0;  // lane po: this warp's share of level po
  unsigned mine_wide = 0;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int slot = t + it * kThreads, chunk = slot / 32;  // the same for the warp
    if (chunk < small_chunk) {  // a level of at least 32 nodes
      const int level = 31 - __clz(all - slot - 1);
      const int j = slot - (all - (2 << level)), w = 1 << (po_top - level);
      int k;
      int64_t bc;
      zf_rice_node((int64_t)top_sum(sh, j * w, w), zf_node_psz(b, level, j, order), max_param,
                   &k, &bc);
      sh.kbest[zf_level_offset(level) + j] = (uint8_t)k;
      // (a node's cost is below 2^22 in magnitude, a level's total too:
      // 32-bit sums, zf_rice_node)
      const int sum = __reduce_add_sync(kFull, (int)bc);
      const unsigned wide = __any_sync(kFull, k > kZfMaxParam4Bit);
      if (lane == level) {
        mine += sum;
        mine_wide |= wide;
      }
    } else if (chunk == small_chunk) {  // the levels below 5
      const int held = po_top < 5 ? po_top : 5, w = 1 << (po_top - held);
      uint64_t prefix = lane < (1 << held) ? top_sum(sh, lane * w, w) : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint64_t o = __shfl_up_sync(kFull, (unsigned long long)prefix, off);
        if (lane >= off) prefix += o;
      }
      const int n = lane, level = 31 - __clz(n + 1), j = n + 1 - (1 << level);
      const int span = level <= held ? 1 << (held - level) : 0, first = j * span;
      const uint64_t hi = __shfl_sync(kFull, (unsigned long long)prefix, (first + span - 1) & 31);
      const uint64_t lo = __shfl_sync(kFull, (unsigned long long)prefix, (first + 31) & 31);
      int k = 0;
      int64_t bc = 0;
      if (level < 5 && level <= po_top) {  // n < 2^(min(po_top, 4) + 1) - 1
        zf_rice_node((int64_t)(hi - (first ? lo : 0)), zf_node_psz(b, level, j, order),
                     max_param, &k, &bc);
        sh.kbest[n] = (uint8_t)k;
      }
      // level po's nodes are lanes 2^po - 1 .. 2^(po+1) - 2: its sum is a
      // difference of two prefixes of an inclusive scan of the costs
      int cost = (int)bc;
      unsigned wide = k > kZfMaxParam4Bit ? 1u << level : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, cost, off);
        if (lane >= off) cost += o;
      }
      wide = __reduce_or_sync(kFull, wide);
      const int l = lane < 5 ? lane : 0;
      const int end = __shfl_sync(kFull, cost, (2 << l) - 2);
      const int before = __shfl_sync(kFull, cost, ((1 << l) + 30) & 31);
      if (lane < 5 && lane <= po_top) {
        mine += end - (lane ? before : 0);
        mine_wide |= (wide >> lane) & 1;
      }
    }
  }
  if (lane <= kZfMaxPartOrder) {
    sh.level_bc[lane][warp] = mine;
    sh.level_wide[lane][warp] = mine_wide;
  }
  __syncthreads();
  if (warp == 0) rice_finish(sh, b, po_top, order, max_param, bits, method, part_order, params);
}

// Warp 0, after the barrier that follows every warp's level shares: lane po
// totals level po, then every lane takes the last minimum, and the warp
// writes bits, method, part_order and the params row from the kept best
// params.
__device__ __forceinline__ void rice_finish(Sweep& sh, int b, int po_top, int64_t order,
                                            int max_param, int64_t* bits, int64_t* method,
                                            int64_t* part_order, int64_t* params) {
  const int lane = threadIdx.x & 31;
  const int dyn = zf_dyn_max_po(order, b, po_top);
  int64_t total = 0;
  int m = 0;
  if (lane <= po_top) {
    ZfLevelAcc a = {0, false};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a.bc += (uint64_t)(int64_t)sh.level_bc[lane][w];
      a.wide_param = a.wide_param || sh.level_wide[lane][w] != 0;
    }
    zf_level_total(a, lane, dyn, max_param, &m, &total);
  }
  const int best = zf_part_order_of_key(
      __reduce_min_sync(kFull, lane <= po_top ? zf_part_order_key(total, lane) : ~0u));
  const int64_t best_total = (int64_t)__shfl_sync(kFull, (long long)total, best);
  const int best_method = __shfl_sync(kFull, m, best);
  const uint8_t* kb = sh.kbest + zf_level_offset(best);
#pragma unroll
  for (int j = lane; j < kZfParamCols; j += 32) params[j] = j < (1 << best) ? (int64_t)kb[j] : 0;
  if (lane == 0) {
    *bits = best_total;
    *method = best_method;
    *part_order = best;
  }
}

// Adds a run's sum v to top[key], the keys rising with the lane: lanes of one
// key sum by a segmented shuffle scan (when any two neighbours share a key),
// then the segment's last lane adds it; with `own` (no other warp or tile
// adds to this warp's partitions) it stores it. Every lane of the warp calls
// it.
__device__ __forceinline__ void add_runs(uint64_t* top, int key, uint64_t v, bool own) {
  const int lane = threadIdx.x & 31;
  const int below = __shfl_up_sync(kFull, key, 1);
  if (__any_sync(kFull, lane > 0 && below == key)) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t o = __shfl_up_sync(kFull, (unsigned long long)v, off);
      const int ok = __shfl_up_sync(kFull, key, off);
      if (lane >= off && ok == key) v += o;
    }
    const int above = __shfl_down_sync(kFull, key, 1);
    if (lane != 31 && above == key) return;
  }
  if (v == 0) return;
  if (own) top[key] = v;
  else atomicAdd((unsigned long long*)&top[key], (unsigned long long)v);
}

// A thread's run of one tile: v[r] = x[start + r], 0 past b; one 16-byte
// load for each 16 bytes where the plane allows it (vec) and the run is
// whole.
template <typename T>
__device__ __forceinline__ void load_values(const T* __restrict__ x, int b, int start, bool vec,
                                            T (&v)[kZfRun]) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec && start + kZfRun <= b) {
    using V = typename std::conditional<sizeof(T) == 4, int4, longlong2>::type;
    const V* src = reinterpret_cast<const V*>(x + start);
#pragma unroll
    for (int q = 0; q < kZfRun / kVec; ++q) {
      const V w = src[q];
      if constexpr (sizeof(T) == 4) {
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
      } else {
        v[2 * q] = w.x;
        v[2 * q + 1] = w.y;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kZfRun; ++r) v[r] = start + r < b ? x[start + r] : T(0);
  }
}

// One tile's run of a thread: x[r] = plane[start + r] (0 past b), its four
// predecessors p (0 before and past the plane), and whether its warp may
// take the narrow arithmetic (never for int64 planes).
template <typename T>
__device__ __forceinline__ bool load_run(const T* __restrict__ x, int b, int start, bool vec,
                                         T (&v)[kZfRun], T (&p)[4]) {
  load_values(x, b, start, vec, v);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 4; ++m) {  // from the lane below; lane 0 reads its own
    T up;
    if constexpr (sizeof(T) == 4)
      up = __shfl_up_sync(kFull, v[kZfRun - 1 - m], 1);
    else
      up = (T)__shfl_up_sync(kFull, (long long)v[kZfRun - 1 - m], 1);
    const int i = start - 1 - m;
    p[m] = lane ? up : (i >= 0 && i < b ? x[i] : T(0));
  }
  if constexpr (sizeof(T) == 4) {
    uint32_t m = 0;
#pragma unroll
    for (int r = 0; r < kZfRun; ++r) m = max(m, zf_abs_u32(v[r]));
#pragma unroll
    for (int q = 0; q < 4; ++q) m = max(m, zf_abs_u32(p[q]));
    return zf_narrow_ok(__reduce_max_sync(kFull, m));
  } else {
    return false;
  }
}

// Adds a run's zigzag sums to the top-level partitions of psz samples
// (every lane of the warp calls it; r is 0 past the plane). Where partitions
// hold at least a run (the same branch for the whole block), a run meets at
// most two: its sums on either side of the boundary go through add_runs,
// 32-bit where the warp is narrow; shorter partitions are added piece by
// piece.
__device__ __forceinline__ void add_run_sums(const int32_t (&r)[kZfRun], int start, int b,
                                             bool narrow, uint64_t* top, int psz, bool own) {
  if (psz >= kZfRun) {
    const int key = start / psz;
    const int split = min((key + 1) * psz - start, kZfRun);
    uint64_t a, c;
    if (narrow) {
      uint32_t a32, c32;
      zf_run_split_sums<uint32_t>(r, split, &a32, &c32);
      a = a32;
      c = c32;
    } else {
      zf_run_split_sums<uint64_t>(r, split, &a, &c);
    }
    add_runs(top, key, a, own);
    if (__any_sync(kFull, c != 0)) add_runs(top, key + 1, c, false);
  } else if (start < b) {
    zf_run_pieces(r, start, psz, [&](int key, uint64_t s) {
      if (s) atomicAdd((unsigned long long*)&top[key], (unsigned long long)s);
    });
  }
}

template <typename T>
__device__ __forceinline__ void pass1_run(const T (&v)[kZfRun], const T (&p)[4], int start, int b,
                                          bool narrow, T first, ZfFixedAcc& acc) {
  if (start >= b) return;
  const bool masked = start < 4 || start + kZfRun > b;
  if constexpr (sizeof(T) == 4) {
    if (narrow) {
      if (masked) zf_run_fixed_narrow<kZfRun, true>(v, p, start, b, first, acc);
      else zf_run_fixed_narrow<kZfRun, false>(v, p, start, b, first, acc);
      return;
    }
  }
  if (masked) zf_run_fixed_wide<kZfRun, true>(v, p, start, b, (int64_t)first, acc);
  else zf_run_fixed_wide<kZfRun, false>(v, p, start, b, (int64_t)first, acc);
}

template <typename T>
__device__ __forceinline__ void pass2_run(const T (&v)[kZfRun], const T (&p)[4], int start, int b,
                                          bool narrow, int order, bool vec,
                                          int32_t* __restrict__ res, uint64_t* top, int psz,
                                          bool own) {
  int32_t r[kZfRun];
  const bool masked = start < 4 || start + kZfRun > b;
  if (sizeof(T) == 4 && narrow) {
    if (masked) zf_run_residual<int32_t, kZfRun, true>(v, p, start, b, order, r);
    else zf_run_residual<int32_t, kZfRun, false>(v, p, start, b, order, r);
  } else {
    if (masked) zf_run_residual<uint64_t, kZfRun, true>(v, p, start, b, order, r);
    else zf_run_residual<uint64_t, kZfRun, false>(v, p, start, b, order, r);
  }
  if (start < b) {
    if (vec && start + kZfRun <= b) {
      int4* dst = reinterpret_cast<int4*>(res + start);
#pragma unroll
      for (int q = 0; q < kZfRun / 4; ++q)
        dst[q] = make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    } else {
#pragma unroll
      for (int q = 0; q < kZfRun; ++q)
        if (start + q < b) res[start + q] = r[q];
    }
  }
  add_run_sums(r, start, b, sizeof(T) == 4 && narrow, top, psz, own);
}

// The order from each thread's pass-1 share: warp sums, one barrier, then
// every thread merges the warps' partials and picks the same order.
__device__ __forceinline__ void block_order(ZfFixedAcc acc, ZfFixedAcc* part, bool wide,
                                            int* order, bool* ok, bool* all_eq) {
#pragma unroll
  for (int k = 0; k < 5; ++k) acc.sum[k] = warp_sum(acc.sum[k]);
  acc.over = __reduce_or_sync(kFull, acc.over);
  acc.all_eq = __all_sync(kFull, acc.all_eq);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  ZfFixedAcc all = part[0];
#pragma unroll 2  // fully unrolled, the eight partials' loads spill the run
  for (int w = 1; w < kWarps; ++w) zf_fixed_acc_merge(all, part[w]);
  zf_choose_fixed_order(all, wide, order, ok);
  *all_eq = all.all_eq;
}

// zf_analyze_fixed for any plane: int64, B above one tile (each tile loaded
// again in pass 2), or unaligned; one CTA a plane.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
analyze_fixed_kernel(const T* __restrict__ planes, int b, bool wide, bool vec_in, bool vec_out,
                     int po_top, int max_param, int64_t* __restrict__ order_out,
                     bool* __restrict__ ok_out, int32_t* __restrict__ residuals,
                     int64_t* __restrict__ bits, int64_t* __restrict__ method,
                     int64_t* __restrict__ part_order, int64_t* __restrict__ params,
                     bool* __restrict__ all_eq) {
  __shared__ Sweep sh;
  __shared__ ZfFixedAcc part[kWarps];
  const int64_t pl = blockIdx.x;
  const T* x = planes + pl * b;
  int32_t* res = residuals + pl * b;
  const int t = threadIdx.x, ntiles = (b + kTile - 1) / kTile;
  sweep_zero(sh, po_top);

  // pass 1: the order
  const T first = x[0];
  T v[kZfRun], p[4];
  bool narrow = false;
  ZfFixedAcc acc;
  zf_fixed_acc_init(acc);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int start = tile * kTile + t * kZfRun;
    narrow = load_run(x, b, start, vec_in, v, p);
    pass1_run(v, p, start, b, narrow, first, acc);
  }
  int order;
  bool ok, eq;
  block_order(acc, part, wide, &order, &ok, &eq);
  if (t == 0) {
    order_out[pl] = order;
    ok_out[pl] = ok;
    all_eq[pl] = eq;
  }

  // pass 2: the residuals and the top level's partition sums
  uint64_t* top = sh.top;
  const int psz = b >> po_top;
  // a warp's partitions are its own: one tile, whole runs, none across warps
  const bool own = ntiles == 1 && psz % kZfRun == 0 && (32 * kZfRun) % psz == 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int start = tile * kTile + t * kZfRun;
    if (ntiles > 1) narrow = load_run(x, b, start, vec_in, v, p);
    pass2_run(v, p, start, b, narrow, order, vec_out, res, top, psz, own);
  }
  __syncthreads();
  rice_sweep(sh, b, po_top, order, max_param, bits + pl, method + pl, part_order + pl,
             params + pl * kZfParamCols);
}

// zf_rice_estimate's plane: the input half of analyze_fixed_kernel's pass
// 2. Each thread loads runs of kZfRun residuals (16-byte loads where vec),
// and add_run_sums adds their zigzag sums to the top-level partitions, by a
// plain store where the warp owns its partitions; then the sweep.
__global__ void __launch_bounds__(kThreads)
rice_estimate_kernel(const int32_t* __restrict__ residuals, const int64_t* __restrict__ order,
                     int b, bool vec, int po_top, int max_param, int64_t* __restrict__ bits,
                     int64_t* __restrict__ method, int64_t* __restrict__ part_order,
                     int64_t* __restrict__ params) {
  __shared__ Sweep sh;
  const int64_t pl = blockIdx.x;
  const int32_t* res = residuals + pl * b;
  const int ntiles = (b + kTile - 1) / kTile, psz = b >> po_top;
  const bool own = ntiles == 1 && psz % kZfRun == 0 && (32 * kZfRun) % psz == 0;
  sweep_zero(sh, po_top);
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int start = tile * kTile + threadIdx.x * kZfRun;
    int32_t r[kZfRun];
    load_values(res, b, start, vec, r);
    add_run_sums(r, start, b, false, sh.top, psz, own);
  }
  __syncthreads();
  rice_sweep(sh, b, po_top, order[pl], max_param, bits + pl, method + pl, part_order + pl,
             params + pl * kZfParamCols);
}

}  // namespace

extern "C" {

// Analyzes p planes of b samples (planes_i64: int64, else int32) on the
// given stream. Outputs: order, bits, method, part_order int64 [p]; ok,
// all_eq bool [p]; residuals int32 [p, b]; params int64 [p, 256]. The
// caller has checked 1 <= b <= 65535 and min(max_rice_order, ctz(b)) <= 8.
// Returns the launch's cudaError_t.
int zf_analyze_fixed(const void* planes, int planes_i64, int64_t p, int64_t b, int wide,
                     int64_t max_rice_order, int64_t max_param, void* order, void* ok,
                     void* residuals, void* bits, void* method, void* part_order, void* params,
                     void* all_eq, void* stream) {
  if (p == 0) return 0;
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const int po_top = zf_po_top(b, (int)max_rice_order);
  if (po_top > kZfMaxPartOrder) return (int)cudaErrorInvalidValue;
  const size_t elem = planes_i64 ? 8 : 4;
  const bool vec_in = (uintptr_t)planes % 16 == 0 && b % (16 / elem) == 0;
  const bool vec_out = (uintptr_t)residuals % 16 == 0 && b % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (planes_i64)
    analyze_fixed_kernel<int64_t><<<(unsigned)p, kThreads, 0, s>>>(
        (const int64_t*)planes, (int)b, wide != 0, vec_in, vec_out, po_top, (int)max_param,
        (int64_t*)order, (bool*)ok, (int32_t*)residuals, (int64_t*)bits, (int64_t*)method,
        (int64_t*)part_order, (int64_t*)params, (bool*)all_eq);
  else
    analyze_fixed_kernel<int32_t><<<(unsigned)p, kThreads, 0, s>>>(
        (const int32_t*)planes, (int)b, wide != 0, vec_in, vec_out, po_top, (int)max_param,
        (int64_t*)order, (bool*)ok, (int32_t*)residuals, (int64_t*)bits, (int64_t*)method,
        (int64_t*)part_order, (int64_t*)params, (bool*)all_eq);
  return (int)cudaGetLastError();
}

// The Rice estimate of p planes of b int32 residuals with their orders
// (int64 [p], 0..32). Outputs and checks as zf_analyze_fixed's.
int zf_rice_estimate(const void* residuals, const void* order, int64_t p, int64_t b,
                     int64_t max_rice_order, int64_t max_param, void* bits, void* method,
                     void* part_order, void* params, void* stream) {
  if (p == 0) return 0;
  if (b < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const int po_top = zf_po_top(b, (int)max_rice_order);
  if (po_top > kZfMaxPartOrder) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)residuals % 16 == 0 && b % 4 == 0;
  rice_estimate_kernel<<<(unsigned)p, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)residuals, (const int64_t*)order, (int)b, vec, po_top, (int)max_param,
      (int64_t*)bits, (int64_t*)method, (int64_t*)part_order, (int64_t*)params);
  return (int)cudaGetLastError();
}

}  // extern "C"
