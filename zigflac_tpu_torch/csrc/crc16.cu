// The frame CRC-16 for Hopper (sm_90a): each frame's CRC-16/UMTS over its
// first byte_len bytes, and in the compact path the two CRC bytes ORed into
// the row after them.
//
// Replaces the JAX package's XLA fusions zigflac_tpu/ops/crc16.py:54
// crc16_words (a carry-less product of every word with a per-column
// constant, an XOR tree, then x^(-8 pad) to cancel the zero padding) and
// zigflac_tpu/ops/bitpack.py:355 deposit_crc16. In the port these were
// about a hundred eager launches over [1024, 5504] int64 temporaries.
//
// What bounds it is bytes: a config-1 batch's 1024 frames of ~10 KB inside
// rows of 22 KB, 10.5 MB read, ~0.0031 ms at 3.35 TB/s. The design
// (crc16_steps.cuh) keeps the instructions a byte few and off any chain:
//
// * kZfCrcLanes (64) lanes a frame, four frames a CTA of 256 threads: a
//   config-1 batch is 256 CTAs, about two an SM (at most 64 registers), one
//   wave. Neighbouring lanes read neighbouring 16-byte chunks (int4 loads
//   where the rows start on 16 bytes, else the same lanes read words), in
//   batches of kZfCrcBatch chunks a lane (ten chunks, three batches, for a
//   config-1 frame). The first batch is read up to the row's end while
//   byte_len is still in flight, and masked once it arrives; the CRC
//   bytes' two words are read before the CRC is known.
// * A chunk's CRC is 24 lookups in 64-entry tables of 16 bits, which a
//   warp reads without bank conflicts; the Horner fold by x^(128 * 64) is
//   3 more. A lane's shift to the frame's end, the zero pad's x^(-8p)
//   folded in, is one entry of a table of constants and one GF(2) product:
//   no square and multiply. Chunk indices are 32-bit.
// * Lanes and batches were chosen on the H100 among 32-256 lanes and 2-12
//   chunks: more lanes a frame spend more on the epilogue and the tables'
//   copies, larger batches more registers. What remains is the lookups'
//   shared-memory pipe, the issue of ~100 instructions a chunk, and a
//   fixed part: launch, table copy and epilogue (PERF.md, sec. 6).
// * The tables (3,456 B) are made at compile time into device memory; each
//   CTA copies them into shared memory once, one int4 a thread loaded
//   first thing, for its four frames.
// * A frame's two warps XOR their lanes' terms by shuffles, then through
//   shared memory after the CTA's second barrier.
//
// No byte at or past L = min(byte_len, 4W) enters the CRC (the last chunk
// is masked) and nothing past the row is read or written: a frame over its
// word budget (byte_len > 4W) gets the CRC of its whole row, which its
// caller does not read, as the plain version's.
//
// With `write`, the frame's first lane ORs the CRC's two bytes big-endian
// into the row at byte_len and byte_len + 1, dropping a position past the
// row: the kernel UPDATES THE WORDS IN PLACE, where the plain version
// (deposit_crc16) returns a copy.
//
// A kernel of its own, not an epilogue of deposit.cu: the deposit kernel
// stands above half its bound and is left as it is, and the rows are read
// here straight after the deposit wrote them, from the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc16_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = kThreads / kZfCrcLanes;  // frames a CTA
constexpr int kWarpsPerFrame = kZfCrcLanes / 32;
constexpr int kTableInt4 = sizeof(ZfCrcTables) / 16;
static_assert(kZfCrcLanes % 32 == 0 && kThreads % kZfCrcLanes == 0, "whole warps a frame");
static_assert(kTableInt4 <= kThreads, "one int4 of the tables a thread");

__device__ const ZfCrcTables kTables = zf_crc16_make_tables();
__device__ const ZfCrcShifts kShifts = zf_crc16_make_shifts();

__global__ void __launch_bounds__(kThreads, 4)
crc16_kernel(uint32_t* __restrict__ words, const int64_t* __restrict__ byte_len, int64_t n,
             int64_t w, bool vec, bool write, int64_t* __restrict__ crcs) {
  __shared__ ZfCrcTables tab;
  __shared__ uint32_t part[kThreads / 32];
  // this thread's int4 of the tables, loaded before anything waits
  uint4 tv = make_uint4(0, 0, 0, 0);
  if (threadIdx.x < kTableInt4) tv = reinterpret_cast<const uint4*>(&kTables)[threadIdx.x];
  const int64_t f = (int64_t)blockIdx.x * kFrames + threadIdx.x / kZfCrcLanes;
  const int lane = threadIdx.x % kZfCrcLanes;
  const bool here = f < n;
  uint32_t* row = words + (here ? f : 0) * w;
  const int64_t nb = here ? byte_len[f] : 0;
  uint32_t old[2] = {0, 0};
  uint32_t term = zf_crc16_lane(row, here ? w : 0, vec, nb, lane, tab, kShifts.e, [&] {
    if (threadIdx.x < kTableInt4) reinterpret_cast<uint4*>(&tab)[threadIdx.x] = tv;
    if (write && here && lane == 0) zf_crc16_deposit_read(row, w, nb, old);
    __syncthreads();
  });
#pragma unroll
  for (int o = 16; o; o >>= 1) term ^= __shfl_xor_sync(0xffffffffu, term, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = term;
  __syncthreads();
  if (lane == 0 && here) {
    uint32_t crc = 0;
#pragma unroll
    for (int i = 0; i < kWarpsPerFrame; ++i) crc ^= part[threadIdx.x / 32 + i];
    crcs[f] = crc;
    if (write) zf_crc16_deposit_write(row, w, nb, crc, old);
  }
}

}  // namespace

extern "C" {

// CRC-16 of n frames, rows of w words (int32 [n, w], MSB-first), the first
// byte_len[f] bytes each (int64 [n]), into crcs (int64 [n]); with `write`
// the CRC bytes are ORed into the rows in place. Returns the launch's
// cudaError_t.
int zf_crc16_frames(void* words, const void* byte_len, int64_t n, int64_t w, int write,
                    void* crcs, void* stream) {
  if (n == 0) return 0;
  const bool vec = (uintptr_t)words % 16 == 0 && w % 4 == 0;
  crc16_kernel<<<(unsigned)((n + kFrames - 1) / kFrames), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)words, (const int64_t*)byte_len, n, w, vec, write != 0, (int64_t*)crcs);
  return (int)cudaGetLastError();
}

}  // extern "C"
