// The frame symbols stage for Hopper (sm_90a): every frame's header (with its
// CRC-8), every wire channel's subframe fields and codes, and the inclusive
// prefix sum of their widths, written as the deposit kernel's inputs.
//
// Replaces the JAX package's XLA stage zigflac_tpu/ops/bitpack.py:472
// frame_symbol_stream (:91 channel_symbols, :418 header_symbols, :430
// _cumsum_bits_exact) and zigflac_tpu/ops/header.py:119 build_headers (:94
// utf8_frame_number_bytes). On the TPU they were fused into the jitted batch
// program; in the port they were ~900 eager launches a batch (the plain
// version, bitpack.frame_symbol_stream), and a pageable copy of the CRC-8
// table inside the dispatch.
//
// What bounds it is bytes: 16 B written a column (int32 end bit, int64
// value, int32 width), 1024 x 8,734 columns for a config-1 batch (143 MB),
// the planes and residuals read (67 MB) and the params (4 MB): ~0.064 ms at
// 3.35 TB/s. This first kernel is simple and exact:
//
// * One CTA of kThreads a frame. Thread 0 builds the header (the CRC-8 from
//   a table made at compile time) into shared memory.
// * The channels in turn. For a predicted subframe the CTA first takes
//   each partition's largest residual key (symbols_steps.cuh) at the chosen
//   partition order: a warp's lanes of one partition reduce with
//   __reduce_max_sync, then one shared atomicMax.
// * The columns in tiles of kThreads x kCols: a thread computes kCols
//   neighbouring columns (zf_sym_column), stores val and nbv, and sums its
//   widths; a warp scan and one barrier a tile (the warp totals double
//   buffered) give each its offset, with the total carried from tile to
//   tile in 64 bits. S reaches ~526k columns at 8 channels of 65,535
//   samples, so no frame's stream sits in shared memory whole.
//
// Nothing is read past the plan's arrays: plane and residual rows are read
// through their strides, so a view (independent channels' planes) needs no
// copy. Later work: coalesced stores through shared memory, the deposit fused
// behind the scan, TMA for the rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "symbols_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // neighbouring columns a thread a tile
constexpr int64_t kTile = (int64_t)kThreads * kCols;

__device__ const ZfCrc8Table kCrc8 = zf_crc8_make_table();

template <typename T>
struct SymArgs {
  const int64_t *frame_numbers, *channels_code;            // [N]
  const int64_t *kind, *order, *method, *part_order, *ss;  // [W, N]
  const int64_t *qshift, *wasted;                          // [W, N]
  const int64_t *params, *qcoeffs;                         // [W, N, 256], [W, N, 32]
  const T* planes;
  int64_t pl_w, pl_n, pl_b;  // element strides of planes [W, N, B]
  const int32_t* res;
  int64_t rs_w, rs_n, rs_b;  // element strides of residuals [W, N, B]
  int64_t n;
  ZfSymLayout lay;
  ZfSymHeaderStatic hs;
  int32_t* dep_cum;
  int64_t* val;
  int32_t* nbv;
  int64_t* total_bits;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) symbols_kernel(const SymArgs<T> a) {
  __shared__ ZfSymHeader hdr;
  __shared__ ZfSymChannel ch;
  __shared__ uint32_t keys[kZfSymParamCols];
  __shared__ int64_t warp_sum[2][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t f = blockIdx.x;
  const ZfSymLayout& L = a.lay;
  int32_t* dc = a.dep_cum + f * L.s;
  int64_t* vv = a.val + f * L.s;
  int32_t* nn = a.nbv + f * L.s;
  if (t == 0) hdr = zf_sym_header(a.frame_numbers[f], a.channels_code[f], a.hs, kCrc8);
  int64_t carry = 0;
  int buf = 0;
  for (int64_t c = -1; c < L.w; ++c) {
    const int64_t cc = c < 0 ? 0 : c;
    const int64_t wn = cc * a.n + f;  // this channel's row of the [W, N] fields
    const T* plane = a.planes + cc * a.pl_w + f * a.pl_n;
    const int32_t* res = a.res + cc * a.rs_w + f * a.rs_n;
    if (c >= 0) {
      __syncthreads();  // the last channel's columns are done with ch and keys
      if (t == 0) {
        ch.kind = a.kind[wn];
        ch.order = a.order[wn];
        ch.method = a.method[wn];
        ch.part_order = a.part_order[wn];
        ch.ss = a.ss[wn];
        ch.qshift = a.qshift[wn];
        ch.wasted = a.wasted[wn];
      }
      for (int i = t; i < kZfSymParamCols; i += kThreads) keys[i] = 0u;
      __syncthreads();
      // partition p at the chosen order covers samples [p psize, (p+1) psize)
      const uint32_t psize = (uint32_t)(L.b >> ch.part_order);  // b < 2^16
      if (zf_sym_pred(ch) && psize > 0) {
        for (int64_t i0 = (int64_t)warp * 32; i0 < L.b; i0 += kThreads) {
          const int64_t i = i0 + lane;
          const bool in = i < L.b;
          const unsigned act = __ballot_sync(0xffffffffu, in);
          if (in) {
            const int p = (int)((uint32_t)i / psize);
            const unsigned peers = __match_any_sync(act, p);
            const unsigned m = __reduce_max_sync(peers, zf_sym_key(res[i * a.rs_b]));
            if (m && lane == __ffs(peers) - 1) atomicMax(&keys[p], m);
          }
        }
      }
    }
    __syncthreads();  // the header (c < 0) or the keys are in place
    const int64_t cols = c < 0 ? kZfSymHeaderCols : L.chan_cols;
    const int64_t base = c < 0 ? 0 : kZfSymHeaderCols + c * L.chan_cols;
    const int64_t* params = a.params + wn * kZfSymParamCols;
    const int64_t* qcoeffs = a.qcoeffs + wn * kZfSymCoeffCols;
    for (int64_t tile = 0; tile < cols; tile += kTile) {
      const int64_t first = tile + (int64_t)t * kCols;
      int64_t incl[kCols];
      int64_t run = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t col = first + j;
        if (col < cols) {
          const ZfSym s = c < 0 ? zf_sym_header_column(hdr, col)
                                : zf_sym_column(L, ch, col, plane, a.pl_b, res, a.rs_b, params,
                                                qcoeffs, keys);
          vv[base + col] = s.val;
          nn[base + col] = s.nbv;
          run += s.nb;
        }
        incl[j] = run;
      }
      int64_t x = run;  // the warp's inclusive scan of the threads' sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) warp_sum[buf][warp] = x;
      __syncthreads();
      int64_t before = carry + x - run, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int64_t s = warp_sum[buf][w];
        before += w < warp ? s : 0;
        total += s;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (first + j < cols) dc[base + first + j] = (int32_t)(uint32_t)(uint64_t)(before + incl[j]);
      carry += total;
      buf ^= 1;
    }
  }
  if (t == 0) a.total_bits[f] = carry;
}

template <typename T>
int launch(const SymArgs<T>& a, cudaStream_t stream) {
  symbols_kernel<T><<<(unsigned)a.n, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The symbol streams of n frames of w wire channels of b samples: the plan's
// fields (int64 [w, n] each, params int64 [w, n, 256], qcoeffs int64 [w, n,
// 32], contiguous), its planes (int32, or int64 where planes_wide) and
// residuals (int32) through their element strides, the frame numbers and
// channel codes (int64 [n]) and the static header pieces; out: dep_cum int32
// [n, s], val int64 [n, s], nbv int32 [n, s], total_bits int64 [n], s =
// ZfSymLayout::s (ops/symbols.symbol_columns). Returns the launch's cudaError_t.
int zf_frame_symbols(const void* frame_numbers, const void* channels_code, const void* kind,
                     const void* order, const void* method, const void* part_order,
                     const void* sample_size, const void* qshift, const void* wasted,
                     const void* params, const void* qcoeffs, const void* planes, int planes_wide,
                     int64_t pl_w, int64_t pl_n, int64_t pl_b, const void* residuals,
                     int64_t rs_w, int64_t rs_n, int64_t rs_b, int64_t n, int64_t w, int64_t b,
                     int64_t max_rice_order, int64_t lpc_order, int64_t lpc_precision,
                     int64_t byte2, int64_t depth_code, int64_t tail, int64_t ntail,
                     void* dep_cum, void* val, void* nbv, void* total_bits, void* stream) {
  if (n == 0) return 0;
  const ZfSymLayout lay = zf_sym_layout(w, b, max_rice_order, lpc_order, lpc_precision);
  const ZfSymHeaderStatic hs = {byte2, depth_code, tail, ntail};
#define ZF_SYM_ARGS(T)                                                                      \
  SymArgs<T> {                                                                              \
    (const int64_t*)frame_numbers, (const int64_t*)channels_code, (const int64_t*)kind,     \
        (const int64_t*)order, (const int64_t*)method, (const int64_t*)part_order,          \
        (const int64_t*)sample_size, (const int64_t*)qshift, (const int64_t*)wasted,        \
        (const int64_t*)params, (const int64_t*)qcoeffs, (const T*)planes, pl_w, pl_n,      \
        pl_b, (const int32_t*)residuals, rs_w, rs_n, rs_b, n, lay, hs, (int32_t*)dep_cum,   \
        (int64_t*)val, (int32_t*)nbv, (int64_t*)total_bits                                  \
  }
  if (planes_wide) return launch(ZF_SYM_ARGS(int64_t), (cudaStream_t)stream);
  return launch(ZF_SYM_ARGS(int32_t), (cudaStream_t)stream);
#undef ZF_SYM_ARGS
}

}  // extern "C"
