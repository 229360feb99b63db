// The PCM unpack for Hopper (sm_90a): a batch of a WAV's interleaved
// little-endian sample bytes, copied to the card as they are, into the
// int32 [n, C, block] frames the encode's batch program takes.
//
// Replaces no kernel of the JAX package: there the host de-interleaves
// (wav.planar_samples -> native.deinterleave, a per-channel byte loop) and
// the planes cross to the device as int32 or narrowed to int16. Here the
// packed bytes cross once, 2 or 3 B a sample in place of 4, and the
// de-interleave, the sign extension and the bucket padding happen on the
// card, in one pass, while the host goes on.
//
// What bounds it is bytes: each output sample is written once (4 B) and its
// nb container bytes are read once, n C block (nb + 4) B at 3.35 TB/s:
// 0.0150 ms for a 1024-frame CD batch (2 x 4096 samples, nb 2), 0.0175 ms
// for a 24-bit one (nb 3). Operations are a few a byte. The design keeps
// both sides of the copy coalesced:
//
// * One thread a sample frame (its C samples), 256 threads a CTA along one
//   row's columns, one row a grid row (the grid strides over rows past
//   65,535). Consecutive lanes write consecutive samples of each channel's
//   row: every store of a warp is 128 contiguous bytes.
// * Each lane reads its frame's C nb bytes with byte loads. A warp's loads
//   of one byte position lie within 32 C nb contiguous bytes (128 for CD,
//   192 at 24 bits), so the first brings the lines into L1 and the others
//   hit there: the bytes come from device memory once.
// * The container width nb is a template parameter, so a sample's bytes
//   are an unrolled sequence of loads, shifts and ORs; channels and depth
//   are arguments.
// * Rows past nreal read row nreal - 1 again (from L2), in place of the
//   host's concatenation of repeated frames.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unpack_steps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridRows = 65535;

template <int NB>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ src, int32_t* __restrict__ dst, int channels,
              int depth, int64_t block, int64_t nreal, int64_t n) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= block) return;
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y)
    zf_unpack_frame<NB>(src, dst, channels, depth, block, nreal, row, col);
}

template <int NB>
void launch(dim3 grid, cudaStream_t stream, const uint8_t* src, int32_t* dst, int channels,
            int depth, int64_t block, int64_t nreal, int64_t n) {
  unpack_kernel<NB><<<grid, kThreads, 0, stream>>>(src, dst, channels, depth, block, nreal, n);
}

}  // namespace

extern "C" {

// The frames int32 [n, channels, block] (dst) of the first nreal * block
// sample frames of src (uint8, interleaved little-endian, nb bytes a
// sample, 1 <= nb <= 4), rows nreal..n-1 repeating row nreal - 1. Returns
// the launch's cudaError_t (cudaErrorInvalidValue for an nb out of range).
int zf_unpack_pcm(const void* src, void* dst, int channels, int nb, int depth, int64_t block,
                  int64_t nreal, int64_t n, void* stream) {
  if (n == 0 || block == 0) return 0;
  const dim3 grid((unsigned)((block + kThreads - 1) / kThreads),
                  (unsigned)(n < kMaxGridRows ? n : kMaxGridRows));
  const auto s = (cudaStream_t)stream;
  const auto in = (const uint8_t*)src;
  const auto out = (int32_t*)dst;
  switch (nb) {
    case 1: launch<1>(grid, s, in, out, channels, depth, block, nreal, n); break;
    case 2: launch<2>(grid, s, in, out, channels, depth, block, nreal, n); break;
    case 3: launch<3>(grid, s, in, out, channels, depth, block, nreal, n); break;
    case 4: launch<4>(grid, s, in, out, channels, depth, block, nreal, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
