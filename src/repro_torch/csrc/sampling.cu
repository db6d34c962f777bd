// K9, candidate_keys_i32 — the per-candidate sort keys of device fanout
// sampling, over the CSC candidate window [rows, width] of one hop:
//     out[i, c] = enc(mix32(uint32(starts[i] + c) ^ base))   for c < cnts[i]
//     out[i, c] = INT32_MAX                                  otherwise
//   Replaces repro/kernels/sampling_ops.py::_candidate_keys_pallas
//   (_keys_kernel).
//
// Encoding: enc(k) = (int32)(k ^ 0x80000000). It maps the unsigned order of
// the uint32 keys onto the signed order of int32, so torch.topk / torch.sort
// over the window rank the keys as the reference ranks its uint32 keys, in
// half the memory of int64 (torch has no uint32 sort). The reference's
// invalid key 0xFFFFFFFF becomes INT32_MAX; decoding is enc ^ 0x80000000
// read as uint32, or enc + 2^31 in int64.
//
// Bound on the H100: the bytes of the window. Each candidate is written once
// (4 bytes) after about ten integer operations, and each row reads two ints
// for width candidates; at bgs's width of 222 the writes are all of it.
//
// Design: the TPU kernel cuts the window into (8, width) row blocks, with
// starts and counts in VMEM and the base key by scalar prefetch. Here the
// window is one flat range of rows * width int32 values: each thread
// computes four consecutive values and writes them with one 16-byte store
// (the output comes from torch's allocator, 256-byte aligned, so every group
// of four is aligned; the ragged tail is stored one by one). A thread finds
// its first value's row with one 64-bit division and steps the column for
// the other three; the rows' starts and counts are read by each thread
// itself through the read-only cache (the width values of a row share them);
// the base key is a kernel argument. A grid-stride loop with 64-bit
// indices over a grid of a few blocks per SM covers windows of billions of
// candidates. mix32 uses native uint32 multiplies.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlocksPerSm = 16;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int key_of(const int* __restrict__ starts,
                                      const int* __restrict__ cnts,
                                      uint32_t base, long long row,
                                      int col) {
  if (col >= __ldg(cnts + row)) return INT_MAX;
  const uint32_t pos =
      static_cast<uint32_t>(__ldg(starts + row)) + static_cast<uint32_t>(col);
  return static_cast<int>(mix32(pos ^ base) ^ 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
candidate_keys_kernel(const int* __restrict__ starts,
                      const int* __restrict__ cnts, uint32_t base,
                      int* __restrict__ out, long long total, int width) {
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * kPerThread;
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * kPerThread;
       i < total; i += stride) {
    long long row = i / width;
    int col = static_cast<int>(i - row * width);
    int v[kPerThread];
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      v[p] = (i + p < total) ? key_of(starts, cnts, base, row, col) : 0;
      if (++col == width) {
        col = 0;
        ++row;
      }
    }
    if (i + kPerThread <= total) {
      *reinterpret_cast<int4*>(out + i) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int p = 0; i + p < total; ++p) out[i + p] = v[p];
    }
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K9. starts, cnts [rows] int32, out [rows, width] int32 (the encoded keys);
// rows * width > 0. Launches on `stream`.
extern "C" int candidate_keys_i32(const int* starts, const int* cnts,
                                  unsigned int base, int* out,
                                  long long rows, int width, void* stream) {
  if (rows <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = rows * width;
  const long long per_block = static_cast<long long>(kThreads) * kPerThread;
  long long blocks = (total + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  candidate_keys_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      starts, cnts, static_cast<uint32_t>(base), out, total, width);
  return static_cast<int>(cudaGetLastError());
}
