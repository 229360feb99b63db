// The frame symbols stage for Hopper (sm_90a): every frame's header (with its
// CRC-8), every wire channel's subframe fields and codes, and the inclusive
// prefix sum of their widths, written as the deposit kernel's inputs.
//
// Replaces the JAX package's XLA stage zigflac_tpu/ops/bitpack.py:472
// frame_symbol_stream (:91 channel_symbols, :418 header_symbols, :430
// _cumsum_bits_exact) and zigflac_tpu/ops/header.py:119 build_headers (:94
// utf8_frame_number_bytes). On the TPU they were fused into the jitted batch
// program; in the port they were ~900 eager launches a batch (the plain
// version, bitpack.frame_symbol_stream).
//
// What bounds it is bytes: 16 B written a column (int32 end bit, int64
// value, int32 width), 1024 x 8,734 columns for a config-1 batch (143 MB),
// and what the columns read: ~0.053 ms at 3.35 TB/s. Its instructions come
// next (~0.038 ms at 60 INT32 operations a column), so the design keeps a
// column's work short and every store a warp's 32 neighbouring columns:
//
// * One CTA of kThreads a frame, kMinBlocks CTAs an SM (32 registers), so a
//   1024-frame batch runs in one wave on 132 SMs.
// * Phase one, one barrier: warp 0 writes the header, a byte a lane, and
//   lane 0 its CRC-8 (the table in constant memory); the first threads
//   write the channels' fields and row pointers; every thread packs the
//   fields of its grid groups (zf_sym_group: the Rice param, the value's
//   mask and width, the param column if the group starts a partition) into
//   shared memory from the params, while warp 0's header is built.
// * Only where a partition's param is the escape code does it need its
//   widest residual: then, and only for those partitions, the residuals are
//   read for their keys (__match_any_sync + __reduce_max_sync, one shared
//   atomicMax), and the escapes' groups are finished; two barriers. A frame
//   without escapes reads each residual once.
// * The columns in tiles of kThreads x kRounds: a warp takes kRounds rounds
//   of 32 neighbouring columns, each starting on a 128-byte line of the
//   outputs (a frame's row starts anywhere, so its first round is partial),
//   a column a lane (zf_sym_frame_column: the channel and the residual group
//   by a multiply-high, no division; a code selected, not branched, from
//   its group's 8 bytes), stores val and nbv coalesced, scans the widths'
//   low 32 bits with shuffles (one SHFL and one predicated add a step) and
//   keeps its inclusive sums in registers; one barrier a tile gives each
//   warp the warps before it and the tiles before (the carry, in shared
//   memory), and dep_cum is stored coalesced. The frame's 64-bit total is
//   each lane's own sum, reduced at the end.
//
// Nothing is read past the plan's arrays: plane and residual rows are read
// through their strides, so a view (independent channels' planes) needs no
// copy. At most 8 wire channels and 256 grid groups (po_top <= 8, as the
// analysis refuses more).

#include <cuda_runtime.h>
#include <stdint.h>

#include "symbols_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;     // rounds of 32 columns a warp a tile
constexpr int kMinBlocks = 8;  // CTAs an SM: 1024 frames in one wave
constexpr int32_t kTile = kThreads * kRounds;

__constant__ ZfCrc8Table kCrc8 = zf_crc8_make_table();

// x + the inclusive scan of x over the lanes below, by shuffles: each step
// adds the shuffled value where the source lane exists (one SHFL and one
// predicated add).
__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    asm("{\n\t.reg .u32 y;\n\t.reg .pred p;\n\t"
        "shfl.sync.up.b32 y|p, %0, %1, 0, 0xffffffff;\n\t"
        "@p add.u32 %0, %0, y;\n\t}"
        : "+r"(x)
        : "r"(o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    symbols_kernel(const __grid_constant__ ZfSymArgs<T> a) {
  __shared__ ZfSymHeader hdr;
  __shared__ ZfSymChannel<T> chan[kZfSymMaxChannels];
  __shared__ ZfSymGroup groups[kZfSymMaxChannels * kZfSymParamCols];
  __shared__ uint32_t keys[kZfSymMaxChannels * kZfSymParamCols];
  __shared__ uint32_t warp_sum[2][kWarps], carry[2];  // double-buffered by tile
  __shared__ uint64_t warp_bits[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t f = blockIdx.x;
  const ZfSymLayout& L = a.lay;

  if (warp == 0) {
    const int64_t fn = a.frame_numbers[f];
    if (lane < kZfSymHeaderCols)
      hdr.bytes[lane] = zf_sym_header_byte(lane, fn, a.channels_code[f], a.hs);
    __syncwarp();
    if (lane == 0) zf_sym_header_crc(hdr, zf_sym_header_crc_pos(fn, a.hs), kCrc8);
  }
  if (t < L.w) chan[t] = zf_sym_channel(a, t, f);
  const bool esc = zf_sym_group_fields(a, f, chan, groups, keys, false, t, kThreads);
  const bool any_esc = __syncthreads_or(esc);
  if (any_esc) {
    // the escape partitions' largest keys, then their groups' fields: a
    // round of 32 samples inside one partition (partitions of a multiple of
    // 32 samples) reduces over the warp, else over each partition's lanes
    for (int c = 0; c < L.w; ++c) {
      const ZfSymChannel<T>& ch = chan[c];
      if (!zf_sym_pred(ch.kind)) continue;
      const bool whole = ((L.g << ch.ds) & 31) == 0;
      for (uint32_t i0 = warp * 32; i0 < (uint32_t)L.b; i0 += kThreads) {
        const uint32_t i = i0 + lane, p = (L.g == 1 ? i : zf_sym_div(i, L.d_g)) >> ch.ds;
        const bool in = i < (uint32_t)L.b &&
                        groups[c * kZfSymParamCols + (p << ch.ds)].y == kZfSymPending;
        if (!__any_sync(0xffffffffu, in)) continue;
        const uint32_t key = in ? zf_sym_key(zf_sym_ld(ch.res + (int64_t)i * a.rs_b)) : 0u;
        uint32_t* at = &keys[c * kZfSymParamCols + p];
        if (whole) {
          const unsigned m = __reduce_max_sync(0xffffffffu, key);
          if (m && lane == 0) atomicMax(at, m);
          continue;
        }
        const unsigned act = __ballot_sync(0xffffffffu, in);
        if (in) {
          const unsigned peers = __match_any_sync(act, p);
          const unsigned m = __reduce_max_sync(peers, key);
          if (m && lane == __ffs(peers) - 1) atomicMax(at, m);
        }
      }
    }
    __syncthreads();
    zf_sym_group_fields(a, f, chan, groups, keys, true, t, kThreads);
    __syncthreads();
  }

  // rounds start where the outputs' element index is a multiple of 32, so
  // a warp's stores fill whole 128-byte lines (256 bytes of val): the first
  // round takes the frame's first columns up to such a line, the columns
  // before the frame wrap past s and are skipped
  const int64_t row = f * L.s;
  const uint32_t s = (uint32_t)L.s;
  uint64_t bits = 0;  // this lane's widths, in 64 bits
  if (t == 0) carry[0] = 0;  // the frame's sum before the tile, mod 2^32
  for (int32_t tile = -(int32_t)(row & 31); tile < (int32_t)s; tile += kTile) {
    const int buf = ((tile + 31) / kTile) & 1;  // the tile's parity
    const uint32_t first = (uint32_t)tile + warp * (32 * kRounds) + lane;
    uint32_t incl[kRounds], run = 0;
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const uint32_t col = first + 32 * j;
      ZfSym sym = zf_sym_make(0, 0, 0);
      if (col < s) {
        sym = zf_sym_frame_column(a, f, col, hdr, chan, groups);
        a.val[row + col] = (int64_t)sym.val;
        a.nbv[row + col] = (int32_t)sym.nbv;
      }
      bits += sym.nb;
      const uint32_t x = warp_inclusive_sum((uint32_t)sym.nb);
      incl[j] = run + x;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) warp_sum[buf][warp] = run;
    __syncthreads();
    uint32_t before = carry[buf], total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t ws = warp_sum[buf][w];
      before += w < warp ? ws : 0u;
      total += ws;
    }
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const uint32_t col = first + 32 * j;
      if (col < s) a.dep_cum[row + col] = (int32_t)(before + incl[j]);
    }
    if (t == 0) carry[buf ^ 1] = carry[buf] + total;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_down_sync(0xffffffffu, bits, o);
  if (lane == 0) warp_bits[warp] = bits;
  __syncthreads();
  if (t == 0) {
    uint64_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_bits[w];
    a.total_bits[f] = (int64_t)total;
  }
}

template <typename T>
int launch(const ZfSymArgs<T>& a, cudaStream_t stream) {
  symbols_kernel<T><<<(unsigned)a.n, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The symbol streams of n frames of w wire channels (at most 8) of b
// samples, at most 256 grid groups a channel: the plan's fields (int64
// [w, n] each, params int64 [w, n, 256], qcoeffs int64 [w, n, 32],
// contiguous), its planes (int32, or int64 where planes_wide) and residuals
// (int32) through their element strides, the frame numbers and channel codes
// (int64 [n]) and the static header pieces; out: dep_cum int32 [n, s], val
// int64 [n, s], nbv int32 [n, s], total_bits int64 [n], s = ZfSymLayout::s
// (ops/symbols.symbol_columns). Returns the launch's cudaError_t.
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
  if (w > kZfSymMaxChannels || ((int64_t)1 << lay.po_top) > kZfSymParamCols)
    return (int)cudaErrorInvalidValue;
  const ZfSymHeaderStatic hs = {byte2, depth_code, tail, ntail};
#define ZF_SYM_ARGS(T)                                                                      \
  ZfSymArgs<T> {                                                                            \
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
