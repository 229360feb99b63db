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
// One CTA per frame, 256 threads. The frame's L = min(byte_len, 4W) bytes
// are cut into 256 contiguous runs (a multiple of 4 bytes each); a thread
// takes the CRC of its run byte by byte from a 256-entry table in shared
// memory, multiplies it by x^(8 * the bytes after the run) mod G
// (crc16_steps.cuh), and the block XORs the terms. No byte at or past L is
// read, and nothing past the row is read or written: a frame over its word
// budget (byte_len > 4W) gets the CRC of its whole row, which its caller
// does not read, as the plain version's.
//
// With `write`, thread 0 ORs the CRC's two bytes big-endian into the row at
// byte_len and byte_len + 1, dropping a position past the row: the kernel
// UPDATES THE WORDS IN PLACE, where the plain version (deposit_crc16)
// returns a copy.
//
// A kernel of its own, not an epilogue of deposit.cu: the deposit kernel
// stands above half its bound and is left as it is, and the 22.5 MB of a
// config-1 batch's rows are read here straight after the deposit wrote them,
// from the 50 MB L2, so fusing would save at most the ~0.007 ms of reading
// them from device memory.
//
// What bounds it is bytes: a config-1 batch's 1024 frames of ~22 KB, ~0.0067
// ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc16_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
crc16_kernel(uint32_t* __restrict__ words, const int64_t* __restrict__ byte_len, int64_t w,
             bool write, int64_t* __restrict__ crcs) {
  __shared__ uint16_t table[256];
  __shared__ uint32_t part[kWarps];
  const int64_t f = blockIdx.x;
  uint32_t* row = words + f * w;
  table[threadIdx.x] = (uint16_t)zf_crc16_table_entry(threadIdx.x);
  const int64_t n = byte_len[f];
  const int64_t len = n < 0 ? 0 : n < 4 * w ? n : 4 * w;
  const int64_t run = zf_crc16_run_bytes(len, kThreads);
  __syncthreads();
  uint32_t term = zf_crc16_term(row, len, run, threadIdx.x, table);
  for (int o = 16; o; o >>= 1) term ^= __shfl_xor_sync(0xffffffffu, term, o);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t crc = 0;
    for (int i = 0; i < kWarps; ++i) crc ^= part[i];
    crcs[f] = crc;
    if (write) zf_crc16_deposit(row, w, n, crc);
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
  crc16_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)words, (const int64_t*)byte_len, w, write != 0, (int64_t*)crcs);
  return (int)cudaGetLastError();
}

}  // extern "C"
