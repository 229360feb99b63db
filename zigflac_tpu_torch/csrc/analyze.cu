// The encoder's per-plane analysis for Hopper (sm_90a): the fixed-order
// search, the chosen order's residual and the Rice partition sweep of every
// plane of a batch, one CTA per plane.
//
// Replaces what the JAX package leaves to XLA fusions inside its one jitted
// batch program (zigflac_tpu/ops/analyze.py: best_fixed_order :118,
// residuals_for_order :163, rice_sums_pyramid :181, rice_estimate :197,
// driven by analyze_planes :432). The port ran the same arithmetic as some
// hundreds of eager torch launches a batch over [4, 1024, 4096] int64
// temporaries. The TPU forms (the u32 sweep speculation and its
// sweep_unsafe flag, where-chains in place of gathers, a batch-minor layout
// for XLA's layout assignment) are not carried over.
//
// zf_analyze_fixed, per plane of B samples (int32, or int64 for the 33-bit
// side plane), 256 threads:
//
// * pass 1: every thread strides over the plane and sums |d_k| for the five
//   fixed orders (analyze_steps.cuh), keeps the largest |d_k| and whether all
//   samples are equal; a warp-shuffle and shared-memory reduction gives the
//   order. The four predecessors of a sample come from global memory next to
//   it: neighbouring threads read neighbouring addresses, and the plane (16
//   KB at B = 4096, int32) stays in L1/L2 between its five reads and pass 2.
//   B is any FLAC block size, 1 to 65535: nothing assumes the plane fits in
//   shared memory.
// * pass 2: the chosen order's residual is written once as int32, and its
//   zigzag is added to its partition's sum at the top partition order: the
//   lanes of a warp that share a partition sum first (__match_any_sync,
//   __reduce_add_sync), then one 64-bit atomicAdd into shared memory.
// * the pyramid of coarser sums, level by level; then per level every node's
//   best Rice param and cost, one thread a node, and the level's total by a
//   block reduction; the last minimum is the partition order, and the chosen
//   level's params (the first 256 nodes, as the plain version crops them) are
//   computed once more and written.
//
// zf_rice_estimate is the same device code from pass 2 on, over residuals
// and orders the caller gives (the LPC candidate, orders 1-32).
//
// Pyramids of po_top <= kSharedMaxPo (4095 nodes, 32 KB) live in shared
// memory; larger ones (max_rice_order above 11 with B a multiple of 4096)
// in a scratch row of global memory the wrapper allocates, the same code
// through a generic pointer.
//
// What bounds it on the H100 is bytes: a config-1 batch (4 x 1024 planes of
// 4096 int32 samples) reads 67 MB of planes and writes 67 MB of residuals
// and 8.4 MB of params, ~0.043 ms at 3.35 TB/s; its ~40 integer operations
// a sample take about as long at the INT32 rate. The design reads each
// sample from device memory once (its other reads hit the caches) and writes
// each output once.
//
// The C entry points are bound with ctypes (ops/_build.py, ops/analyze.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "analyze_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedMaxPo = 11;
constexpr int kMaxPo = 15;

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int o = 16; o; o >>= 1)
    v += (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)v, o);
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o; o >>= 1) {
    const int64_t w = (int64_t)__shfl_xor_sync(0xffffffffu, (long long)v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Adds each lane's zigzag z into top[key] with one atomic for each key the
// warp holds (a partition of 16 samples takes 2 atomics a warp, not 32).
// The two 16-bit halves are summed apart so the 32-bit sums cannot wrap.
// Every lane of the warp calls it.
__device__ __forceinline__ void add_by_partition(uint64_t* top, uint32_t key, uint32_t z) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned lo = __reduce_add_sync(peers, z & 0xFFFFu);
  const unsigned hi = __reduce_add_sync(peers, z >> 16);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    const uint64_t sum = ((uint64_t)hi << 16) + lo;
    if (sum) atomicAdd((unsigned long long*)&top[key], (unsigned long long)sum);
  }
}

template <typename T>
__device__ __forceinline__ void history(const T* __restrict__ x, int64_t i, int64_t (&h)[5]) {
#pragma unroll
  for (int m = 0; m < 5; ++m) h[m] = i >= m ? (int64_t)x[i - m] : 0;
}

// Pass 1 over one plane: the order, whether it is usable, and all-equal.
template <typename T>
__device__ void choose_order(const T* __restrict__ x, int64_t b, bool wide, int* order,
                             bool* ok, bool* all_eq) {
  __shared__ ZfFixedAcc part[kWarps];
  __shared__ int s_order;
  __shared__ bool s_ok, s_eq;
  ZfFixedAcc acc;
  zf_fixed_acc_init(acc);
  const int64_t first = (int64_t)x[0];
  for (int64_t i = threadIdx.x; i < b; i += kThreads) {
    int64_t h[5];
    history(x, i, h);
    zf_fixed_acc_add(acc, h, i, first);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    acc.sum[k] = warp_sum(acc.sum[k]);
    acc.max[k] = warp_max(acc.max[k]);
  }
  acc.all_eq = __all_sync(0xffffffffu, acc.all_eq);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    ZfFixedAcc all = part[0];
    for (int w = 1; w < kWarps; ++w) zf_fixed_acc_merge(all, part[w]);
    int o;
    bool usable;
    zf_choose_fixed_order(all, wide, &o, &usable);
    s_order = o;
    s_ok = usable;
    s_eq = all.all_eq;
  }
  __syncthreads();
  *order = s_order;
  *ok = s_ok;
  *all_eq = s_eq;
}

// The Rice estimate of one plane from its top-level partition sums, which
// the caller has added into sums[offset(po_top) ..]; builds the pyramid in
// place. Writes bits, method, part_order and the params row.
__device__ void rice_sweep(uint64_t* sums, int64_t b, int po_top, int64_t order,
                           int max_param, int64_t* bits, int64_t* method, int64_t* part_order,
                           int64_t* params) {
  __shared__ ZfLevelAcc part[2][kWarps];
  __shared__ int64_t totals[kMaxPo + 1];
  __shared__ int methods[kMaxPo + 1];
  __shared__ int s_best;
  for (int po = po_top - 1; po >= 0; --po) {
    uint64_t* lvl = sums + zf_level_offset(po);
    const uint64_t* up = sums + zf_level_offset(po + 1);
    for (int64_t j = threadIdx.x; j < (int64_t(1) << po); j += kThreads)
      lvl[j] = up[2 * j] + up[2 * j + 1];
    __syncthreads();
  }
  const int dyn = zf_dyn_max_po(order, b, po_top);
  const int warp = threadIdx.x / 32;
  for (int po = 0; po <= po_top; ++po) {
    const uint64_t* lvl = sums + zf_level_offset(po);
    ZfLevelAcc acc = {0, false};
    for (int64_t j = threadIdx.x; j < (int64_t(1) << po); j += kThreads) {
      int k;
      int64_t bc;
      zf_rice_node((int64_t)lvl[j], zf_node_psz(b, po, j, order), max_param, &k, &bc);
      zf_level_acc_add(acc, k, bc);
    }
    acc.bc = warp_sum(acc.bc);
    acc.wide_param = __any_sync(0xffffffffu, acc.wide_param);
    // two buffers: thread 0 reads level po's while the others fill po + 1's
    if (threadIdx.x % 32 == 0) part[po & 1][warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      ZfLevelAcc all = {0, false};
      for (int w = 0; w < kWarps; ++w) {
        all.bc += part[po & 1][w].bc;
        all.wide_param = all.wide_param || part[po & 1][w].wide_param;
      }
      zf_level_total(all, po, dyn, max_param, &methods[po], &totals[po]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int best = zf_choose_part_order(totals, po_top);
    s_best = best;
    *bits = totals[best];
    *method = methods[best];
    *part_order = best;
  }
  __syncthreads();
  const int best = s_best;
  const uint64_t* lvl = sums + zf_level_offset(best);
  const int64_t nparts = int64_t(1) << best;
  for (int j = threadIdx.x; j < kZfParamCols; j += kThreads) {
    int k = 0;
    if (j < nparts) {
      int64_t bc;
      zf_rice_node((int64_t)lvl[j], zf_node_psz(b, best, j, order), max_param, &k, &bc);
    }
    params[j] = k;
  }
}

__device__ uint64_t* plane_sums(uint64_t* scratch, int po_top) {
  extern __shared__ uint64_t sums_smem[];
  return scratch ? scratch + (int64_t)blockIdx.x * zf_nodes(po_top) : sums_smem;
}

__device__ void zero_top(uint64_t* sums, int po_top) {
  uint64_t* top = sums + zf_level_offset(po_top);
  for (int64_t j = threadIdx.x; j < (int64_t(1) << po_top); j += kThreads) top[j] = 0;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
analyze_fixed_kernel(const T* __restrict__ planes, int64_t b, bool wide, int po_top,
                     int max_param, int64_t* __restrict__ order_out, bool* __restrict__ ok_out,
                     int32_t* __restrict__ residuals, int64_t* __restrict__ bits,
                     int64_t* __restrict__ method, int64_t* __restrict__ part_order,
                     int64_t* __restrict__ params, bool* __restrict__ all_eq,
                     uint64_t* scratch) {
  const int64_t p = blockIdx.x;
  const T* x = planes + p * b;
  int32_t* res = residuals + p * b;
  int order;
  bool ok, eq;
  choose_order(x, b, wide, &order, &ok, &eq);
  uint64_t* sums = plane_sums(scratch, po_top);
  zero_top(sums, po_top);
  uint64_t* top = sums + zf_level_offset(po_top);
  const uint32_t psz_top = (uint32_t)(b >> po_top);
  for (int64_t base = 0; base < b; base += kThreads) {  // the same trips for every lane
    const int64_t i = base + threadIdx.x;
    int32_t r = 0;
    if (i < b) {
      int64_t h[5];
      history(x, i, h);
      r = zf_fixed_residual(order, h, i);
      res[i] = r;
    }
    add_by_partition(top, (uint32_t)(i < b ? i : b - 1) / psz_top, zf_zigzag(r));
  }
  __syncthreads();
  rice_sweep(sums, b, po_top, order, max_param, bits + p, method + p, part_order + p,
             params + p * kZfParamCols);
  if (threadIdx.x == 0) {
    order_out[p] = order;
    ok_out[p] = ok;
    all_eq[p] = eq;
  }
}

__global__ void __launch_bounds__(kThreads)
rice_estimate_kernel(const int32_t* __restrict__ residuals, const int64_t* __restrict__ order,
                     int64_t b, int po_top, int max_param, int64_t* __restrict__ bits,
                     int64_t* __restrict__ method, int64_t* __restrict__ part_order,
                     int64_t* __restrict__ params, uint64_t* scratch) {
  const int64_t p = blockIdx.x;
  const int32_t* res = residuals + p * b;
  uint64_t* sums = plane_sums(scratch, po_top);
  zero_top(sums, po_top);
  uint64_t* top = sums + zf_level_offset(po_top);
  const uint32_t psz_top = (uint32_t)(b >> po_top);
  for (int64_t base = 0; base < b; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    add_by_partition(top, (uint32_t)(i < b ? i : b - 1) / psz_top,
                     i < b ? zf_zigzag(res[i]) : 0u);
  }
  __syncthreads();
  rice_sweep(sums, b, po_top, order[p], max_param, bits + p, method + p, part_order + p,
             params + p * kZfParamCols);
}

size_t sums_smem_bytes(int po_top, const void* scratch) {
  return scratch ? 0 : (size_t)zf_nodes(po_top) * sizeof(uint64_t);
}

}  // namespace

extern "C" {

// Analyzes p planes of b samples (planes_i64: int64, else int32) on the
// given stream. Outputs: order, bits, method, part_order int64 [p]; ok,
// all_eq bool [p]; residuals int32 [p, b]; params int64 [p, 256]. scratch
// is null when po_top <= zf_shared_max_po(), else int64 [p, 2^(po_top+1) - 1].
// Returns the launch's cudaError_t.
int zf_analyze_fixed(const void* planes, int planes_i64, int64_t p, int64_t b, int wide,
                     int64_t max_rice_order, int64_t max_param, void* order, void* ok,
                     void* residuals, void* bits, void* method, void* part_order, void* params,
                     void* all_eq, void* scratch, void* stream) {
  if (p == 0) return 0;
  const int po_top = zf_po_top(b, (int)max_rice_order);
  const size_t smem = sums_smem_bytes(po_top, scratch);
  cudaStream_t s = (cudaStream_t)stream;
  if (planes_i64)
    analyze_fixed_kernel<int64_t><<<(unsigned)p, kThreads, smem, s>>>(
        (const int64_t*)planes, b, wide != 0, po_top, (int)max_param, (int64_t*)order,
        (bool*)ok, (int32_t*)residuals, (int64_t*)bits, (int64_t*)method,
        (int64_t*)part_order, (int64_t*)params, (bool*)all_eq, (uint64_t*)scratch);
  else
    analyze_fixed_kernel<int32_t><<<(unsigned)p, kThreads, smem, s>>>(
        (const int32_t*)planes, b, wide != 0, po_top, (int)max_param, (int64_t*)order,
        (bool*)ok, (int32_t*)residuals, (int64_t*)bits, (int64_t*)method,
        (int64_t*)part_order, (int64_t*)params, (bool*)all_eq, (uint64_t*)scratch);
  return (int)cudaGetLastError();
}

// The Rice estimate of p planes of b int32 residuals with their orders
// (int64 [p], 0..32). Outputs and scratch as zf_analyze_fixed's.
int zf_rice_estimate(const void* residuals, const void* order, int64_t p, int64_t b,
                     int64_t max_rice_order, int64_t max_param, void* bits, void* method,
                     void* part_order, void* params, void* scratch, void* stream) {
  if (p == 0) return 0;
  const int po_top = zf_po_top(b, (int)max_rice_order);
  rice_estimate_kernel<<<(unsigned)p, kThreads, sums_smem_bytes(po_top, scratch),
                         (cudaStream_t)stream>>>(
      (const int32_t*)residuals, (const int64_t*)order, b, po_top, (int)max_param,
      (int64_t*)bits, (int64_t*)method, (int64_t*)part_order, (int64_t*)params,
      (uint64_t*)scratch);
  return (int)cudaGetLastError();
}

// The largest top partition order whose pyramid the kernels keep in shared
// memory; above it the caller passes a scratch row a plane.
int64_t zf_shared_max_po() { return kSharedMaxPo; }

}  // extern "C"
