// Frame bit deposit for Hopper (sm_90a): packs each frame's symbol stream
// into its MSB-first u32 words.
//
// Replaces the TPU kernel zigflac_tpu/ops/pallas_deposit.py (_deposit_kernel,
// launched by _call_group). That kernel's shape came from the TPU: it bins
// 128-deposit chunks against an iota window with a read-modify-write of a
// VMEM row, pair-merges symbols first to halve its VMEM transactions, and
// does every wide shift in u32 limbs because the TPU has no 64-bit shifts.
// None of that carries over. Here:
//
// * one CTA per frame, its threads striding over the frame's symbols, so
//   reads of d_cum / val / nbv are coalesced;
// * each symbol splits into at most three word contributions with native
//   64-bit shifts (deposit_bits.cuh), and each is atomicOr'ed into the
//   frame's row in shared memory (fields are disjoint, so or is exact);
// * __syncthreads, then one coalesced store of the whole row, zeros
//   included. A row over the shared-memory budget is or'ed straight into
//   the output row, which the wrapper has zeroed: the same kernel, exact.
//
// What bounds it on the H100 is bytes: 16 bytes read per symbol (i32 end
// bit, i64 value, i32 width), about 9M symbols per 1024-frame stereo batch
// at block 4096, so about 150 MB in and 22 MB out per batch. The design
// reads each symbol once and writes each word once; the atomics stay in
// shared memory, where neighbouring symbols of one word meet.
//
// The C entry point is bound with ctypes (ops/_build.py, ops/deposit.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deposit_bits.cuh"

namespace {

constexpr int kThreads = 256;
// Rows up to this size are built in shared memory: 48 KiB is what a block
// may take without opting in, and holds the exact-capacity row of a
// 4096-sample stereo frame (10,112 words).
constexpr int64_t kSharedRowBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
deposit_kernel(const int32_t* __restrict__ d_cum, const int64_t* __restrict__ val,
               const int32_t* __restrict__ nbv, int64_t s, int64_t max_words,
               bool shared_row, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t row_smem[];
  const int64_t f = blockIdx.x;
  const int32_t* dc = d_cum + f * s;
  const int64_t* vv = val + f * s;
  const int32_t* nn = nbv + f * s;
  uint32_t* orow = out + f * max_words;
  uint32_t* row = shared_row ? row_smem : orow;

  if (shared_row) {
    for (int64_t i = threadIdx.x; i < max_words; i += blockDim.x) row[i] = 0u;
    __syncthreads();
  }
  for (int64_t i = threadIdx.x; i < s; i += blockDim.x) {
    zf_deposit_symbol(dc[i], (uint64_t)vv[i], nn[i], max_words,
                      [row](int64_t w, uint32_t bits) { atomicOr(&row[w], bits); });
  }
  if (shared_row) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < max_words; i += blockDim.x) orow[i] = row[i];
  }
}

}  // namespace

extern "C" {

// Deposits n frames of s symbols into out [n, max_words] (zeroed by the
// caller) on the given stream. Returns the launch's cudaError_t.
int zf_deposit_words(const void* d_cum, const void* val, const void* nbv, int64_t n,
                     int64_t s, int64_t max_words, void* out, void* stream) {
  if (n == 0) return 0;
  const bool shared_row = max_words * 4 <= kSharedRowBytes;
  const size_t smem = shared_row ? (size_t)max_words * 4 : 0;
  deposit_kernel<<<(unsigned)n, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)d_cum, (const int64_t*)val, (const int32_t*)nbv, s, max_words,
      shared_row, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The largest row, in bytes, that the kernel builds in shared memory;
// larger rows take the global-memory branch.
int64_t zf_shared_row_bytes() { return kSharedRowBytes; }

const char* zf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
