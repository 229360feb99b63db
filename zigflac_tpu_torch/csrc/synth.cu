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
// All of it wraps in 64 bits as XLA's int64 does, so a corrupt stream that
// overflows gives the scan's values and nothing is undefined. The wrapper
// keeps shift and wasted below 64.
//
// What bounds it on the H100 is none of the usual two. Bytes: 16 * M * B
// (67 MB at M = 1024, B = 4096) take 0.02 ms at 3.35 TB/s. Operations: a
// few integer multiply-adds per sample, small against the card's INT32
// rate. The floor is the dependent chain: B steps, each waiting on the last
// sample through a multiply-add, a shift and an add, and a decoder's batch
// of M = 1024 subframes is 32 warps on a card with 528 warp schedulers, so
// no other warp hides it. A lone warp issues about one integer instruction
// in three cycles here (measured: PERF.md sec. 6), so after the chain it is
// the step's instruction count that sets the pace. The design therefore
// spends everything on the one warp's step: the fewest instructions between
// two samples, and as few other instructions in the step as the arithmetic
// allows.
//
// One thread per subframe, 32 subframes per block. A thread keeps its
// coefficients and its 32-sample history in registers, the history as a
// ring indexed by compile-time constants (synth_steps.cuh), and walks the
// positions in tiles of 32 with the steps unrolled.
//
// - Narrow multiplies, chosen per warp, exact. Every coefficient a FLAC
//   stream can carry fits 16 bits and every sample of a valid stream of up
//   to 32 bits per sample fits int32 (but for the 33-bit side channel at 32
//   bits), while the function is defined on any int64. A warp whose 32
//   subframes have coefficients that all fit int32 starts narrow: int32
//   coefficients and history, each tap ONE instruction (IMAD.WIDE, 32 x 32
//   + 64), against three for a 64 x 64 product. The sample still comes out
//   in 64 bits; each step ORs "does not fit int32" into a flag, and the warp
//   votes after each tile. If any lane's flag is set the tile is run again
//   wide from the saved history (which fitted, so sign extension restores
//   it exactly) and from the tile's inputs, which are never overwritten;
//   the warp stays wide for the rest of the block. Nothing is guessed from
//   the bit depth: a 33-bit side subframe, a corrupt frame or a 62-bit
//   coefficient goes wide by itself, in the tile where it first matters.
// - Exact tap counts. The taps summed are a warp-uniform template parameter
//   from the largest index of a non-zero coefficient in the warp: 0 (a
//   copy), 1, 2, 3, 4, 8, 16, 24 or 32. A batch of fixed predictors runs 1
//   to 4 products a step.
// - The shortest chain. The older taps are summed first and the newest
//   sample's product last; in the narrow form only the low word of a sample
//   feeds the next step. Where every shift of the warp is 0 (all fixed
//   predictors) that low word is the low word of the sum, so one 32-bit
//   multiply-add (IMAD) lies between one sample and the next, and the 64-bit
//   sample for the output and the flag is computed beside it. With a shift
//   the chain is IMAD.WIDE with the older taps' sum as its addend (written
//   as a carry pair in PTX: given mad.wide, ptxas multiplies alone and adds
//   in trees), the funnel shift's low word and one 32-bit add. The warmup
//   select exists only in the general tile (a block's first, and a ragged
//   last one), which runs 4, 8 or all 32 taps (coefficients beyond the
//   order are zero). A step's value is loaded from shared memory eight
//   steps ahead, from a tile that the stores never touch, so no load waits
//   behind a store.
// - No copies in the computing warp. A thread walking its own row would
//   read addresses 8 * B bytes apart from its neighbours', so each [32
//   subframes, 32 positions] tile is staged through shared memory (rows
//   padded to 33 words of 8 bytes, so the 32 threads fall on different
//   banks) and moved with coalesced 256-byte rows. Two more warps do that,
//   each on a scheduler of its own: one keeps cp.async copies of the tiles
//   two ahead in flight into a ring of three input tiles, one stores the
//   last tile's samples, shifted left by the wasted bits, from one of two
//   output tiles. The three meet at one named barrier a tile. The computing
//   warp runs loads from shared memory, the steps and stores to shared
//   memory, nothing else. Each input is read once, each output written once.
//
// The C entry point is bound with ctypes (ops/_build.py, ops/synth.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "synth_steps.cuh"

namespace {

constexpr int kTaps = kZfTile;   // history depth, and positions per tile
constexpr int kRows = 32;        // subframes per block: one to a lane of a warp
constexpr int kPad = kTaps + 1;  // row stride in shared memory, in samples
constexpr int kInTiles = 3;      // input ring: this tile and two on their way
constexpr int kThreads = 96;     // warp 0 computes, warp 1 loads, warp 2 stores
constexpr unsigned kFull = 0xffffffffu;

typedef uint64_t Tile[kRows][kPad];

// The block's three warps meet here once a tile.
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

struct Block {
  const int64_t* values;
  int64_t* out;
  int64_t row0;  // the block's first subframe
  int rows;      // its subframes
  int64_t b;     // positions per subframe
  int64_t tiles;
};

// Warp 1. Starts the copy of tile k of the block's rows into shared memory
// and closes the copy group (an empty one past the last tile, so that the
// waits always count the same groups).
__device__ __forceinline__ void fetch_tile(Tile& tile, const Block& blk, int64_t k, int lane) {
  const int64_t i = k * kTaps + lane;
  if (i < blk.b) {
    const int64_t* src = blk.values + blk.row0 * blk.b + i;
#pragma unroll 8
    for (int r = 0; r < blk.rows; ++r, src += blk.b)
      __pipeline_memcpy_async(&tile[r][lane], src, 8);
  }
  __pipeline_commit();
}

__device__ void load_tiles(Tile* in, const Block& blk, int lane) {
  for (int k = 0; k < kInTiles - 1; ++k) fetch_tile(in[k], blk, k, lane);
  __pipeline_wait_prior(kInTiles - 2);  // all but the newest groups: tile 0 is in
  tile_barrier();
  int slot = kInTiles - 1;
  for (int64_t k = 0; k < blk.tiles; ++k) {
    // the slot of tile k - 1, which the computing warp left at the last barrier
    fetch_tile(in[slot], blk, k + kInTiles - 1, lane);
    slot = slot == kInTiles - 1 ? 0 : slot + 1;
    __pipeline_wait_prior(kInTiles - 2);  // tile k + 1 is in
    tile_barrier();
  }
}

// Warp 2. Stores tile k's samples, shifted left by each row's wasted bits
// (my_ws is that of row `lane`).
__device__ __forceinline__ void store_tile(const Tile& tile, const Block& blk, int64_t k,
                                           int lane, int my_ws, bool any_ws) {
  const int64_t i = k * kTaps + lane;
  const bool mine = i < blk.b;
  int64_t* dst = blk.out + blk.row0 * blk.b + i;
  if (any_ws) {
#pragma unroll 8
    for (int r = 0; r < blk.rows; ++r, dst += blk.b) {
      const int ws = __shfl_sync(kFull, my_ws, r);
      if (mine) *dst = (int64_t)(tile[r][lane] << ws);
    }
  } else if (mine) {
#pragma unroll 8
    for (int r = 0; r < blk.rows; ++r, dst += blk.b) *dst = (int64_t)tile[r][lane];
  }
}

__device__ void store_tiles(const Tile* out, const Block& blk, int lane,
                            const int64_t* __restrict__ wasted) {
  const int my_ws = lane < blk.rows ? (int)wasted[blk.row0 + lane] : 0;
  const bool any_ws = __any_sync(kFull, my_ws != 0);
  tile_barrier();
  for (int64_t k = 0; k < blk.tiles; ++k) {
    if (k > 0) store_tile(out[(k - 1) & 1], blk, k - 1, lane, my_ws, any_ws);
    __syncwarp();
    tile_barrier();
  }
  store_tile(out[(blk.tiles - 1) & 1], blk, blk.tiles - 1, lane, my_ws, any_ws);
}

// Tile k as one lane sees it: its positions, how many of its first ones are
// the lane's warmup samples, and whether it is full: all kTaps positions and
// no warmup sample in any lane (warm_end is where the warp's last one ends).
struct TileShape {
  int width, warm;
  bool full;
};

__device__ __forceinline__ TileShape tile_shape(const Block& blk, int64_t k, int64_t ord,
                                                int64_t warm_end) {
  const int64_t left = blk.b - k * kTaps, warm = ord - k * kTaps;
  TileShape t;
  t.width = left < kTaps ? (int)left : kTaps;
  t.warm = warm < 0 ? 0 : warm > kTaps ? kTaps : (int)warm;
  t.full = t.width == kTaps && k * kTaps >= warm_end;
  return t;
}

// Warp 0, one subframe a lane: tile k from in[k % 3] into out[k % 2].
// report, if given, receives the block's tap count, whether it ended wide,
// and the tile at which it went wide (-1: never).
__device__ void compute_tiles(const Tile* in, Tile* out, const Block& blk, int lane,
                              const int64_t* __restrict__ qcoeffs,
                              const int64_t* __restrict__ shift,
                              const int64_t* __restrict__ order, int32_t* report) {
  const bool live = lane < blk.rows;
  const int64_t m = blk.row0 + lane;
  const int sh = live ? (int)shift[m] : 0;
  const int64_t ord = live ? order[m] : 0;

  int need = 0;
  bool fits = true;
  {
    uint64_t q[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) q[j] = live ? (uint64_t)qcoeffs[m * kTaps + j] : 0;
    need = zf_taps_needed(q);
    fits = zf_all_fit_i32(q);
  }
  const int taps = zf_round_taps((int)__reduce_max_sync(kFull, (unsigned)need));
  const bool narrow = __all_sync(kFull, fits);
  const bool sh0 = __all_sync(kFull, sh == 0);

  const int64_t warm_end = (int64_t)__reduce_max_sync(
      kFull, (unsigned)(ord < 0 ? 0 : ord > blk.b ? blk.b : ord));
  int64_t k = 0;
  int slot = 0;
  int32_t saved[kTaps];
  int32_t hn[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) hn[j] = 0;

  tile_barrier();  // tile 0 is in
  if (narrow) {
    int32_t qn[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) qn[j] = live ? (int32_t)qcoeffs[m * kTaps + j] : 0;
    for (; k < blk.tiles; ++k) {
      const TileShape t = tile_shape(blk, k, ord, warm_end);
      uint32_t bad = 0;
      if (live)
        bad = zf_run_narrow(taps, t.full, sh0, qn, hn, saved, in[slot][lane],
                            out[k & 1][lane], t.width, t.warm, sh);
      __syncwarp();
      if (__any_sync(kFull, bad != 0)) {
        zf_undo_narrow(taps, t.full, hn, saved);
        break;  // this tile again, wide
      }
      slot = slot == kInTiles - 1 ? 0 : slot + 1;
      tile_barrier();
    }
  }
  const int64_t wide_at = k < blk.tiles ? k : -1;
  if (k < blk.tiles) {
    uint64_t q[kTaps], h[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) q[j] = live ? (uint64_t)qcoeffs[m * kTaps + j] : 0;
    zf_widen(hn, h);
    for (; k < blk.tiles; ++k) {
      const TileShape t = tile_shape(blk, k, ord, warm_end);
      if (live)
        zf_run_wide(taps, t.full, q, h, in[slot][lane], out[k & 1][lane], t.width, t.warm,
                    sh);
      __syncwarp();
      slot = slot == kInTiles - 1 ? 0 : slot + 1;
      tile_barrier();
    }
  }
  if (report != nullptr && lane == 0) {
    report[0] = taps;
    report[1] = wide_at >= 0;
    report[2] = (int32_t)wide_at;
  }
}

__global__ void __launch_bounds__(kThreads)
synth_kernel(const int64_t* __restrict__ values, const int64_t* __restrict__ qcoeffs,
             const int64_t* __restrict__ shift, const int64_t* __restrict__ order,
             const int64_t* __restrict__ wasted, int64_t m_total, int64_t b,
             int64_t* __restrict__ out, int32_t* __restrict__ report) {
  __shared__ uint64_t in_tiles[kInTiles][kRows][kPad];
  __shared__ uint64_t out_tiles[2][kRows][kPad];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Block blk;
  blk.values = values;
  blk.out = out;
  blk.row0 = (int64_t)blockIdx.x * kRows;
  blk.rows = (int)(m_total - blk.row0 < kRows ? m_total - blk.row0 : kRows);
  blk.b = b;
  blk.tiles = (b + kTaps - 1) / kTaps;
  if (warp == 0)
    compute_tiles(in_tiles, out_tiles, blk, lane, qcoeffs, shift, order,
                  report == nullptr ? nullptr : report + 3 * (int64_t)blockIdx.x);
  else if (warp == 1)
    load_tiles(in_tiles, blk, lane);
  else
    store_tiles(out_tiles, blk, lane, wasted);
}

}  // namespace

extern "C" {

// Synthesizes m subframes of b positions: values and out int64 [m, b],
// qcoeffs int64 [m, 32], shift, order and wasted int64 [m], on the given
// stream, 32 subframes to a block. report is null or int32 [blocks, 3] for
// blocks = ceil(m / 32): each block's tap count, 1 if it ended wide, and the
// tile at which it went wide or -1.
// Returns the launch's cudaError_t.
int zf_synthesize(const void* values, const void* qcoeffs, const void* shift,
                  const void* order, const void* wasted, int64_t m, int64_t b, void* out,
                  void* report, void* stream) {
  if (m == 0 || b == 0) return 0;
  const unsigned blocks = (unsigned)((m + kRows - 1) / kRows);
  synth_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)values, (const int64_t*)qcoeffs, (const int64_t*)shift,
      (const int64_t*)order, (const int64_t*)wasted, m, b, (int64_t*)out, (int32_t*)report);
  return (int)cudaGetLastError();
}

}  // extern "C"
