// K1: gather-fused segment GEMM of the GEMM template (Hector Algorithm 1),
//     Y[slot] = X[gidx[slot]] @ W[t2g[tile]]   (x row_scale[slot] if given).
//
// Replaces: repro/kernels/segment_mm.py::segment_mm_gather_padded (the
// Pallas kernel with bodies _mm_gather_kernel / _mm_gather_scale_kernel).
//
// Bound on the H100: bytes. Per row tile it reads `tile` gathered rows of
// X (k floats each), one k x n slice of W and writes tile x n outputs, at
// 2*k FLOPs per output: 128 FLOPs per 256-byte row at k = 64, far below
// the card's ~20 FLOP/byte fp32 ridge.
//
// Design: one thread block per (row tile, 64-column slice of n). The
// block loads its own slice of the padded gather map and pulls its rows of
// X straight from global memory by index, 16 bytes per thread where k is a
// multiple of 4, into shared memory (row stride k + 1, so threads reading
// one column of many rows hit distinct banks). Nothing is kept resident
// across blocks: the TPU kernel's whole-source VMEM block and scalar
// prefetch have no counterpart. W[t2g[tile]]'s column slice goes to shared
// memory beside it, and each thread forms whole dot products over k with
// fp32 FMAs (no TF32). Slots whose gather index is -1 (tile padding) are
// written as exact zeros; the optional per-row scale is the epilogue.
// Pad tiles that bucketing appends extend the last group and only multiply
// zero rows.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColTile = 64;

__global__ void __launch_bounds__(kThreads)
segment_mm_gather_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const int* __restrict__ gidx,
                         const int* __restrict__ t2g,
                         const float* __restrict__ scale,
                         float* __restrict__ y,
                         int k, int n, int tile, int vec4) {
  extern __shared__ float smem[];
  const int ldx = k + 1;
  const int col0 = blockIdx.y * kColTile;
  const int cols = min(kColTile, n - col0);
  float* xs = smem;              // [tile][k + 1]
  float* ws = smem + tile * ldx; // [k][cols]
  const int row0 = blockIdx.x * tile;
  const int group = t2g[blockIdx.x];

  if (vec4) {
    const int kq = k >> 2;
    for (int i = threadIdx.x; i < tile * kq; i += blockDim.x) {
      const int r = i / kq;
      const int q = i - r * kq;
      const int src = gidx[row0 + r];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0) {
        v = reinterpret_cast<const float4*>(x + (size_t)src * k)[q];
      }
      float* dst = xs + r * ldx + 4 * q;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < tile * k; i += blockDim.x) {
      const int r = i / k;
      const int c = i - r * k;
      const int src = gidx[row0 + r];
      xs[r * ldx + c] = src >= 0 ? x[(size_t)src * k + c] : 0.f;
    }
  }
  const float* wg = w + (size_t)group * k * n + col0;
  for (int i = threadIdx.x; i < k * cols; i += blockDim.x) {
    const int kk = i / cols;
    const int c = i - kk * cols;
    ws[i] = wg[(size_t)kk * n + c];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < tile * cols; o += blockDim.x) {
    const int r = o / cols;
    const int c = o - r * cols;
    const float* xr = xs + r * ldx;
    float acc = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      acc = fmaf(xr[kk], ws[kk * cols + c], acc);
    }
    const int row = row0 + r;
    if (gidx[row] < 0) {
      acc = 0.f;
    } else if (scale != nullptr) {
      acc *= scale[row];
    }
    y[(size_t)row * n + col0 + c] = acc;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of segment_mm_gather_f32 asks for, in bytes.
extern "C" long long segment_mm_gather_smem_bytes(int k, int n, int tile) {
  const int cols = n < kColTile ? n : kColTile;
  return ((long long)tile * (k + 1) + (long long)k * cols) * sizeof(float);
}

// x [nx, k], w [R, k, n], gidx [num_tiles * tile], t2g [>= num_tiles],
// scale [num_tiles * tile] or null, y [num_tiles * tile, n]; all contiguous
// on one device. Launches on `stream`; returns cudaGetLastError().
extern "C" int segment_mm_gather_f32(const float* x, const float* w,
                                     const int* gidx, const int* t2g,
                                     const float* scale, float* y, int k,
                                     int n, int num_tiles, int tile, int vec4,
                                     void* stream) {
  if (num_tiles <= 0 || n <= 0 || k <= 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = segment_mm_gather_smem_bytes(k, n, tile);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_mm_gather_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(num_tiles, (n + kColTile - 1) / kColTile);
  segment_mm_gather_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, gidx, t2g, scale, y, k, n, tile, vec4);
  return static_cast<int>(cudaGetLastError());
}
