// Decoder synthesis for Hopper (sm_90a): rebuilds the wire samples of a
// batch of subframes from their normalized predictor form.
//
// Replaces the decode scan of the JAX package, zigflac_tpu/ops/synth.py:29
// (_compiled_synth): not a Pallas kernel but a lax.scan over the block's
// sample positions that XLA compiles into one program. Eager PyTorch has no
// such program: the same loop is several launches per sample position. For
// each of M subframes independently, over B positions,
//
//   s[i] = v[i]                                        for i < order
//   s[i] = v[i] + ((sum_j q[j] * s[i-1-j]) >> shift)   otherwise
//
// over 32 taps (zeros beyond the order), and the output is s[i] << wasted.
// All of it wraps in 64 bits as XLA's int64 does: products, sums and the
// left shift run in uint64_t, and only the arithmetic right shift sees an
// int64_t, so a corrupt stream that overflows gives the scan's values and
// nothing is undefined. The wrapper keeps shift and wasted below 64.
//
// Design: one thread per subframe, one warp (32 subframes) per block, so
// that M = 1024 subframes spread over 32 SMs. A thread keeps its 32
// coefficients and its 32-sample history in registers. The history is a
// ring whose slot is the position modulo 32, and positions are walked in
// tiles of 32 with the tile's steps unrolled, so every ring index is a
// compile-time constant and no sample is ever moved. Coefficients come in
// four groups of 8, and a warp runs only as many groups as its subframes
// have non-zero coefficients in (a template parameter, so a full tile's 32
// steps are one branch-free block that the compiler schedules across
// steps): exact for any input, and one group for fixed predictors
// (order <= 4) and LPC of order <= 8. With one warp on an SM nothing but
// the code's own order hides latency, so a step sums its products oldest
// tap first into two partial sums and adds the newest sample's product
// last: only that product, the shift and two adds lie between one sample
// and the next.
//
// A thread walking its own row would read addresses 8 * B bytes apart from
// its neighbours', so each [32 subframes, 32 positions] tile is staged
// through shared memory instead of transposing in the wrapper: the warp
// copies row after row with 32 consecutive int64 (256 bytes, coalesced),
// each thread then reads and overwrites its own row (rows padded to 33
// words of 8 bytes, so the 32 threads fall on different banks), and the
// warp stores the tile back row after row. Each input is read once and
// each output written once. The copies in are asynchronous (cp.async
// straight into shared memory) and double-buffered: the next tile is on
// its way while this one is computed, since the lone warp has nothing
// else to cover a load's latency with.
//
// What bounds it on the H100 is none of the usual two. Bytes: 16 * M * B
// (67 MB at M = 1024, B = 4096) take 0.02 ms at 3.35 TB/s. Operations: a
// 64-bit multiply-add is about 4 INT32 operations, small against the
// card's INT32 rate. The floor is the dependent chain: B steps, each
// waiting on the last sample through one multiply, add, shift and add
// (about 24 cycles), and with 32 warps on 132 SMs nothing else hides it.
//
// The C entry point is bound with ctypes (ops/_build.py, ops/synth.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 32;        // history depth, and positions per tile
constexpr int kRows = 32;        // subframes per block: one warp
constexpr int kPad = kTaps + 1;  // row stride in shared memory, in samples

// The steps of one tile for one subframe: row holds the tile's values and
// receives its samples. NG is the number of coefficient groups summed; FULL
// says the tile has all kTaps positions. warm is how many of the tile's
// first positions are warmup samples (below the subframe's order).
template <int NG, bool FULL>
__device__ __forceinline__ void tile_steps(const uint64_t (&q)[kTaps], uint64_t (&h)[kTaps],
                                           uint64_t* row, int width, int warm, int sh,
                                           int ws) {
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    if (!FULL && t >= width) break;
    uint64_t acc0 = 0, acc1 = 0;
#pragma unroll
    for (int j = 8 * NG - 1; j >= 1; j -= 2) {
      acc1 += q[j] * h[(t - 1 - j) & (kTaps - 1)];
      if (j > 1) acc0 += q[j - 1] * h[(t - j) & (kTaps - 1)];
    }
    uint64_t acc = acc0 + acc1;
    if (NG > 0) acc += q[0] * h[(t - 1) & (kTaps - 1)];
    const uint64_t v = row[t];
    const uint64_t pred = (uint64_t)((int64_t)acc >> sh);
    const uint64_t s = t < warm ? v : v + pred;
    h[t] = s;
    row[t] = s << ws;
  }
}

// Starts the copy of the tile at positions [i0, i0 + kTaps) of the block's
// rows into shared memory and closes the copy group (an empty one past the
// last tile, so the caller's wait always counts the same groups).
__device__ __forceinline__ void fetch_tile(uint64_t (*tile)[kPad], const int64_t* values,
                                           int64_t row0, int rows, int64_t b, int64_t i0,
                                           int lane) {
  if (i0 < b && i0 + lane < b) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows)
        __pipeline_memcpy_async(&tile[r][lane], values + (row0 + r) * b + i0 + lane, 8);
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kRows)
synth_kernel(const int64_t* __restrict__ values, const int64_t* __restrict__ qcoeffs,
             const int64_t* __restrict__ shift, const int64_t* __restrict__ order,
             const int64_t* __restrict__ wasted, int64_t m_total, int64_t b,
             int64_t* __restrict__ out) {
  __shared__ uint64_t tiles[2][kRows][kPad];
  const int lane = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t m = row0 + lane;
  const bool live = m < m_total;
  const int rows = (int)(m_total - row0 < kRows ? m_total - row0 : kRows);

  uint64_t q[kTaps], h[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    q[j] = live ? (uint64_t)qcoeffs[m * kTaps + j] : 0;
    h[j] = 0;
  }
  // groups of 8 coefficients up to this subframe's last non-zero one, and
  // the most that any subframe of the warp needs
  unsigned mine = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint64_t any = 0;
#pragma unroll
    for (int j = 8 * g; j < 8 * g + 8; ++j) any |= q[j];
    if (any) mine = g + 1;
  }
  const unsigned groups = __reduce_max_sync(0xffffffffu, mine);
  const int sh = live ? (int)shift[m] : 0;
  const int ws = live ? (int)wasted[m] : 0;
  const int64_t ord = live ? order[m] : 0;

  fetch_tile(tiles[0], values, row0, rows, b, 0, lane);
  int buf = 0;
  for (int64_t i0 = 0; i0 < b; i0 += kTaps, buf ^= 1) {
    uint64_t (*tile)[kPad] = tiles[buf];
    const int width = (int)(b - i0 < kTaps ? b - i0 : kTaps);
    // the other buffer's samples were stored before the last __syncwarp
    fetch_tile(tiles[buf ^ 1], values, row0, rows, b, i0 + kTaps, lane);
    __pipeline_wait_prior(1);  // all but the group just closed: this tile is in
    __syncwarp();
    const int64_t left = ord - i0;
    const int warm = left < 0 ? 0 : left > kTaps ? kTaps : (int)left;
    uint64_t* row = tile[lane];
    if (width < kTaps) {
      tile_steps<4, false>(q, h, row, width, warm, sh, ws);
    } else {
      switch (groups) {
        case 0: tile_steps<0, true>(q, h, row, width, warm, sh, ws); break;
        case 1: tile_steps<1, true>(q, h, row, width, warm, sh, ws); break;
        case 2: tile_steps<2, true>(q, h, row, width, warm, sh, ws); break;
        case 3: tile_steps<3, true>(q, h, row, width, warm, sh, ws); break;
        default: tile_steps<4, true>(q, h, row, width, warm, sh, ws); break;
      }
    }
    __syncwarp();
    if (lane < width) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r)
        out[(row0 + r) * b + i0 + lane] = (int64_t)tile[r][lane];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Synthesizes m subframes of b positions: values and out int64 [m, b],
// qcoeffs int64 [m, 32], shift, order and wasted int64 [m], on the given
// stream. Returns the launch's cudaError_t.
int zf_synthesize(const void* values, const void* qcoeffs, const void* shift,
                  const void* order, const void* wasted, int64_t m, int64_t b, void* out,
                  void* stream) {
  if (m == 0 || b == 0) return 0;
  const unsigned blocks = (unsigned)((m + kRows - 1) / kRows);
  synth_kernel<<<blocks, kRows, 0, (cudaStream_t)stream>>>(
      (const int64_t*)values, (const int64_t*)qcoeffs, (const int64_t*)shift,
      (const int64_t*)order, (const int64_t*)wasted, m, b, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
