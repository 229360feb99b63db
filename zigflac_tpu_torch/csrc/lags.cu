// The LPC stage's windowed autocorrelation for Hopper (sm_90a): the exact
// lag sums of every plane of a batch under every window, one CTA per plane
// and lag group.
//
// Replaces the lag sums the JAX package leaves to XLA fusions inside its
// jitted batch program (zigflac_tpu/ops/lpc.py:195 lag_sums, driven by
// analyze_planes), which the port ran as plain torch ops (ops/lpc.py
// lag_sums, still the plain version): the windowed plane and its limbs
// materialized in int64, then four strided limb products per lag, each
// written out and summed, about (order + 1) x 16 passes over [W, planes, B]
// int64 tensors. The JAX package's product tiers and narrow storage, made
// for the TPU's emulated int64, are not carried over; the two tiers below
// give the same triples (lags_steps.cuh).
//
// zf_lag_sums, per plane of B samples (int32, or int64 for the 33-bit side
// plane) and per group of G lags (9 up to order 8, else 13: one group up to
// order 12, two or three above), 128 threads, tiles of 128 x 32 = 4096
// samples. What bounds it on the H100 is operations: (order + 1) exact
// multiply-adds a sample and window, about 1.3 G at flac -8's batch (4 x
// 1024 planes of 4096, six windows, order 12), against 67 MB of planes read
// once. The design:
//
// * The plane's tile (and its last run's successors, zero past the plane)
//   is staged in shared memory once and serves every window; a plane of one
//   tile (B <= 4096) is read from device memory once for all its windows.
//   Each window's Q8 values (int16) are staged beside it, window by window.
//   Both stagings pad one bank after every 32 samples, so that the lanes of
//   a warp, whose runs start 32 samples apart, read distinct banks.
// * The windowed sample x = s w is formed in registers where a thread reads
//   its run and the run's successors; x is never written anywhere.
// * Windows run outside the lags: a thread holds G partials (3 G wide), one
//   run of 32 samples a tile, fully unrolled (wide: two pieces of 16 in
//   turn): G multiply-adds per sample loaded narrow, 4 G wide.
// * The tier is the caller's, from the plane's type and the bound it gives on
//   |s|: narrow 32 x 32 -> 64-bit products where |s| <= 2^16 (16-bit audio
//   and its side plane), 24-bit limbs otherwise.
// * A tile's partials add in each warp by three 32-bit warp reductions a
//   value (21-bit limbs), then the four warps' sums in shared memory, by the
//   threads that own the lags; two barriers a window and tile.
//
// The C entry point is bound with ctypes (ops/_build.py, ops/lpc.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lags_steps.cuh"

namespace {

constexpr int kWarps = kZfLagThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The sum of v over the warp, for |v| < 2^57, in every lane.
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  uint32_t a, b;
  int32_t c;
  zf_lag_limbs21(v, &a, &b, &c);
  return zf_lag_join21(__reduce_add_sync(kFull, a), __reduce_add_sync(kFull, b),
                       __reduce_add_sync(kFull, c));
}

// kParts partials a lag: 1 narrow (the product sums), 3 wide (hh, hl, ll).
template <typename T, bool kNarrow, int G>
__global__ void __launch_bounds__(kZfLagThreads)
lag_sums_kernel(const T* __restrict__ planes, const int16_t* __restrict__ windows, int nwin,
                int b, int order, int64_t nplanes, int64_t* __restrict__ out) {
  constexpr int kParts = kNarrow ? 1 : 3;
  __shared__ T s_sm[kZfLagStageSlots];
  __shared__ int16_t w_sm[kZfLagStageSlots16];
  __shared__ int64_t wsum[kWarps][kParts * G];
  const int64_t pl = blockIdx.x;
  const int k0 = blockIdx.y * G;
  const T* __restrict__ x = planes + pl * b;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ntiles = (b + kZfLagTile - 1) / kZfLagTile;
  const int start = t * kZfLagRun;
  const auto xs = [&](int i) {
    if constexpr (kNarrow) return (int32_t)s_sm[zf_lag_pad(i)] * (int32_t)w_sm[zf_lag_pad16(i)];
    else return (int64_t)s_sm[zf_lag_pad(i)] * (int64_t)w_sm[zf_lag_pad16(i)];
  };

  for (int w = 0; w < nwin; ++w) {
    // this thread's lag's totals (threads t < G): narrow (hi, lo), wide
    // (hh, hl, ll)
    int64_t tot[3] = {0, 0, 0};
    const int16_t* __restrict__ wv = windows + (int64_t)w * b;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int base = tile * kZfLagTile;
      const int len = min(kZfLagTile, b - base);
      const int span = (len + kZfLagRun - 1) / kZfLagRun * kZfLagRun + k0 + G - 1;
      if (ntiles > 1 || w == 0)
        for (int i = t; i < span; i += kZfLagThreads)
          s_sm[zf_lag_pad(i)] = base + i < b ? x[base + i] : T(0);
      for (int i = t; i < span; i += kZfLagThreads)
        w_sm[zf_lag_pad16(i)] = base + i < b ? wv[base + i] : int16_t(0);
      __syncthreads();

      int64_t acc[kParts][G];
#pragma unroll
      for (int c = 0; c < kParts; ++c)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[c][g] = 0;
      // a small group is a plane's only one: k0 == 0, and the run's own
      // samples lead its successors
      const bool same = G == kZfLagSmallGroup || k0 == 0;
      if (start < len) {
        if constexpr (kNarrow) {
          if (same) zf_lag_run_narrow<G, true>(xs, start, 0, acc[0]);
          else zf_lag_run_narrow<G, false>(xs, start, k0, acc[0]);
        } else {
          if (same) zf_lag_run_wide<G, true>(xs, start, 0, acc[0], acc[1], acc[2]);
          else zf_lag_run_wide<G, false>(xs, start, k0, acc[0], acc[1], acc[2]);
        }
      }
#pragma unroll
      for (int c = 0; c < kParts; ++c)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int64_t s = warp_sum(acc[c][g]);
          if (lane == 0) wsum[warp][c * G + g] = s;
        }
      __syncthreads();
      if (t < G) {
#pragma unroll
        for (int c = 0; c < kParts; ++c) {
          int64_t s = 0;
#pragma unroll
          for (int q = 0; q < kWarps; ++q) s += wsum[q][c * G + t];
          if constexpr (kNarrow) zf_lag_narrow_add(s, &tot[0], &tot[1]);
          else tot[c] += s;
        }
      }
    }
    const int k = k0 + t;
    if (t < G && k <= order) {
      int64_t* o = out + (((int64_t)w * nplanes + pl) * (order + 1) + k) * 3;
      if constexpr (kNarrow) zf_lag_narrow_triple(tot[0], tot[1], o);
      else zf_lag_wide_triple(tot[0], tot[1], tot[2], o);
    }
  }
}

template <typename T, bool kNarrow>
void launch(const void* planes, const void* windows, int nwin, int64_t p, int b, int order,
            void* out, cudaStream_t s) {
  const dim3 grid((unsigned)p, (unsigned)zf_lag_groups(order));
  if (zf_lag_group(order) == kZfLagSmallGroup)
    lag_sums_kernel<T, kNarrow, kZfLagSmallGroup><<<grid, kZfLagThreads, 0, s>>>(
        (const T*)planes, (const int16_t*)windows, nwin, b, order, p, (int64_t*)out);
  else
    lag_sums_kernel<T, kNarrow, kZfLagGroup><<<grid, kZfLagThreads, 0, s>>>(
        (const T*)planes, (const int16_t*)windows, nwin, b, order, p, (int64_t*)out);
}

}  // namespace

extern "C" {

// The lag sums of p planes of b samples (planes_i64: int64, else int32)
// under nwin Q8 windows (int16 [nwin, b], values 0..256) for lags 0..order:
// out int64 [nwin, p, order + 1, 3], the normalized limb triples. narrow
// (int32 planes only) promises |sample| <= 2^16. Returns the launch's
// cudaError_t.
int zf_lag_sums(const void* planes, int planes_i64, int narrow, const void* windows,
                int64_t nwin, int64_t p, int64_t b, int64_t order, void* out, void* stream) {
  if (b < 1 || b > 65535 || order < 1 || order > kZfLagMaxOrder || nwin < 1 ||
      nwin > kZfLagMaxWindows || p < 0 || p > 0x7fffffff || (narrow && planes_i64))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (planes_i64)
    launch<int64_t, false>(planes, windows, (int)nwin, p, (int)b, (int)order, out, s);
  else if (narrow)
    launch<int32_t, true>(planes, windows, (int)nwin, p, (int)b, (int)order, out, s);
  else
    launch<int32_t, false>(planes, windows, (int)nwin, p, (int)b, (int)order, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
