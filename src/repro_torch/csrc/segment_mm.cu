// The GEMM template of Hector (Algorithm 1) and its backward:
//
// K1, segment_mm_gather_f32 — gather-fused segment GEMM,
//     Y[slot] = X[gidx[slot]] @ W[t2g[tile]]   (x row_scale[slot] if given).
//   Replaces repro/kernels/segment_mm.py::segment_mm_gather_padded
//   (_mm_gather_kernel / _mm_gather_scale_kernel).
// K4, segment_mm_padded_f32 — segment GEMM over pre-padded rows,
//     Y[row] = X[row] @ W[t2g[tile]]   (x row_scale[row] if given),
//   with W read either as stored ([R, k, n]) or transposed by stride (the
//   dX = dY @ W^T of every GEMM's backward, no [R, n, k] copy).
//   Replaces segment_mm.py::segment_mm_padded (_mm_kernel / _mm_scale_kernel).
// K5, segment_outer_f32 — the dW of every GEMM,
//     dW[g] = sum over the tiles t of group g of X_t^T @ dY_t   -> [R, k, n].
//   Replaces segment_mm.py::segment_outer_padded (_outer_kernel).
//
// Bound on the H100: bytes. K1/K4 do 2*k FLOPs per output and read a row of
// k floats per n outputs (128 FLOPs per 256-byte row at k = n = 64), K5
// 2*k*n FLOPs per row of (k + n) floats read (16 FLOPs per byte at 64 x 64):
// all at or below the card's ~20 FLOP/byte fp32 ridge.
//
// K1/K4 design: one thread block per (row tile, col_tile-column slice of n;
// 64 by default, the tuner's tile_n otherwise; the row tile is the layout's
// tile or, as the tuner's tile_rows, a divisor of it over a sub-tiled
// tile -> group map, which the caller passes as `tile`). The
// block stages its tile's rows in shared memory (row stride kd + 1, so
// threads reading one column of many rows hit distinct banks): K1 pulls them
// from global memory by gather index, K4 reads them contiguously; 16 bytes
// per thread where the row width is a multiple of 4. The slice of
// W[t2g[tile]] goes beside them (row stride cols + 1); a transposed W is read
// with the reduction index fastest, so the global reads stay coalesced and
// the shared-memory stores conflict-free. Each thread forms whole dot
// products with fp32 FMAs (no TF32). K1 writes slots whose gather index is
// -1 as exact zeros; the optional per-row scale is the epilogue. Pad tiles
// that bucketing appends multiply zero rows. Nothing is kept resident across
// blocks: the TPU kernel's whole-source VMEM block and scalar prefetch have
// no counterpart.
//
// K5 design: the TPU kernel walks all tiles on one sequential grid and
// accumulates each group's run into one VMEM block (is_first flags). Here
// each group's run of REAL tiles [group_tile_ptr[g], group_tile_ptr[g+1])
// (bucketing's pure-pad tiles, which only ever hold zero rows, are left
// out) is cut into chunks of at most chunk_tiles tiles
// ([group_chunk_ptr[g], group_chunk_ptr[g+1]) are g's chunks). One thread
// block per (chunk, 64 x 64 slice of dW) sums its rows' outer products into
// an fp64 partial; a second kernel adds each group's partials in chunk
// order. No atomics: the result is deterministic, and a group of 10^5 rows
// is spread over many blocks instead of serializing on one. Accumulation is
// fp64 throughout (inputs and dW fp32), so sums of any length stay within
// the final fp32 rounding. Groups that own no real tile are written as
// zeros (the TPU kernel never visits them; its caller masks them).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColTile = 64;   // the default column slice of K1 / K4
constexpr int kOuterSlice = 64;
constexpr int kOuterPerThread = kOuterSlice * kOuterSlice / kThreads;

// One (row tile, column slice) of Y = X_rows @ W[group], W element
// (red, col) at w[group * kd * n + red * w_sr + col * w_sc].
template <bool kGather>
__device__ __forceinline__ void tile_gemm(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ gidx, const int* __restrict__ t2g,
    const float* __restrict__ scale, float* __restrict__ y, int kd, int n,
    int tile, int col_tile, int vec4, int w_sr, int w_sc) {
  extern __shared__ float smem[];
  const int ldx = kd + 1;
  const int col0 = blockIdx.y * col_tile;
  const int cols = min(col_tile, n - col0);
  const int ldw = cols + 1;
  float* xs = smem;              // [tile][kd + 1]
  float* ws = smem + tile * ldx; // [kd][cols + 1]
  const int row0 = blockIdx.x * tile;
  const int group = t2g[blockIdx.x];

  if (vec4) {
    const int kq = kd >> 2;
    for (int i = threadIdx.x; i < tile * kq; i += blockDim.x) {
      const int r = i / kq;
      const int q = i - r * kq;
      const int src = kGather ? gidx[row0 + r] : row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0) {
        v = reinterpret_cast<const float4*>(x + (size_t)src * kd)[q];
      }
      float* dst = xs + r * ldx + 4 * q;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < tile * kd; i += blockDim.x) {
      const int r = i / kd;
      const int c = i - r * kd;
      const int src = kGather ? gidx[row0 + r] : row0 + r;
      xs[r * ldx + c] = src >= 0 ? x[(size_t)src * kd + c] : 0.f;
    }
  }
  const float* wg = w + (size_t)group * kd * n + (size_t)col0 * w_sc;
  if (w_sc == 1) {               // W as stored: columns are contiguous
    for (int i = threadIdx.x; i < kd * cols; i += blockDim.x) {
      const int kk = i / cols;
      const int c = i - kk * cols;
      ws[kk * ldw + c] = wg[(size_t)kk * w_sr + c];
    }
  } else {                       // W transposed: the reduction index is
    for (int i = threadIdx.x; i < kd * cols; i += blockDim.x) {
      const int c = i / kd;      // contiguous, read it fastest
      const int kk = i - c * kd;
      ws[kk * ldw + c] = wg[(size_t)c * w_sc + (size_t)kk * w_sr];
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < tile * cols; o += blockDim.x) {
    const int r = o / cols;
    const int c = o - r * cols;
    const float* xr = xs + r * ldx;
    float acc = 0.f;
    for (int kk = 0; kk < kd; ++kk) {
      acc = fmaf(xr[kk], ws[kk * ldw + c], acc);
    }
    const int row = row0 + r;
    if (kGather && gidx[row] < 0) {
      acc = 0.f;
    } else if (scale != nullptr) {
      acc *= scale[row];
    }
    y[(size_t)row * n + col0 + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_mm_gather_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const int* __restrict__ gidx,
                         const int* __restrict__ t2g,
                         const float* __restrict__ scale,
                         float* __restrict__ y, int k, int n, int tile,
                         int col_tile, int vec4) {
  tile_gemm<true>(x, w, gidx, t2g, scale, y, k, n, tile, col_tile, vec4, n,
                  1);
}

__global__ void __launch_bounds__(kThreads)
segment_mm_padded_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const int* __restrict__ t2g,
                         const float* __restrict__ scale,
                         float* __restrict__ y, int kd, int n, int tile,
                         int col_tile, int vec4, int w_sr, int w_sc) {
  tile_gemm<false>(x, w, nullptr, t2g, scale, y, kd, n, tile, col_tile, vec4,
                   w_sr, w_sc);
}

// fp64 partial of one chunk of one group's real tiles, for one
// (64-row slice of k) x (64-column slice of n) block of dW.
__global__ void __launch_bounds__(kThreads)
segment_outer_partial_kernel(const float* __restrict__ x,
                             const float* __restrict__ dy,
                             const int* __restrict__ group_tile_ptr,
                             const int* __restrict__ group_chunk_ptr,
                             double* __restrict__ partial, int k, int n,
                             int tile, int num_groups, int chunk_tiles) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x;
  // the chunk's group: the last g with group_chunk_ptr[g] <= chunk (groups
  // without chunks share their successor's offset and are skipped)
  int lo = 0, hi = num_groups;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (group_chunk_ptr[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int g = lo;
  const int t_begin =
      group_tile_ptr[g] + (chunk - group_chunk_ptr[g]) * chunk_tiles;
  const int t_end = min(t_begin + chunk_tiles, group_tile_ptr[g + 1]);
  const int k0 = blockIdx.y * kOuterSlice;
  const int n0 = blockIdx.z * kOuterSlice;
  const int kc = min(kOuterSlice, k - k0);
  const int nc = min(kOuterSlice, n - n0);
  float* xs = smem;              // [tile][kc]
  float* ds = smem + tile * kc;  // [tile][nc]

  double acc[kOuterPerThread];
#pragma unroll
  for (int p = 0; p < kOuterPerThread; ++p) acc[p] = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    const size_t row0 = (size_t)t * tile;
    __syncthreads();
    for (int i = threadIdx.x; i < tile * kc; i += blockDim.x) {
      const int r = i / kc;
      xs[i] = x[(row0 + r) * k + k0 + (i - r * kc)];
    }
    for (int i = threadIdx.x; i < tile * nc; i += blockDim.x) {
      const int r = i / nc;
      ds[i] = dy[(row0 + r) * n + n0 + (i - r * nc)];
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kOuterPerThread; ++p) {
      const int o = threadIdx.x + p * kThreads;
      if (o < kc * nc) {
        const int i = o / nc;
        const int j = o - i * nc;
        double a = acc[p];
        for (int r = 0; r < tile; ++r) {
          a = fma(static_cast<double>(xs[r * kc + i]),
                  static_cast<double>(ds[r * nc + j]), a);
        }
        acc[p] = a;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kOuterPerThread; ++p) {
    const int o = threadIdx.x + p * kThreads;
    if (o < kc * nc) {
      const int i = o / nc;
      const int j = o - i * nc;
      partial[((size_t)chunk * k + k0 + i) * n + n0 + j] = acc[p];
    }
  }
}

// dW[g] = sum of g's chunk partials in chunk order; zero for a group
// without chunks.
__global__ void __launch_bounds__(kThreads)
segment_outer_combine_kernel(const double* __restrict__ partial,
                             const int* __restrict__ group_chunk_ptr,
                             float* __restrict__ dw, int kn) {
  const int g = blockIdx.x;
  const int c0 = group_chunk_ptr[g];
  const int c1 = group_chunk_ptr[g + 1];
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < kn;
       e += gridDim.y * blockDim.x) {
    double s = 0.0;
    for (int c = c0; c < c1; ++c) s += partial[(size_t)c * kn + e];
    dw[(size_t)g * kn + e] = static_cast<float>(s);
  }
}

cudaError_t allow_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block of segment_mm_gather_f32 / segment_mm_padded_f32
// asks for, in bytes (kd: the reduction width; col_tile <= 0: the default).
extern "C" long long segment_mm_smem_bytes(int kd, int n, int tile,
                                           int col_tile) {
  if (col_tile <= 0) col_tile = kColTile;
  const int cols = n < col_tile ? n : col_tile;
  return ((long long)tile * (kd + 1) + (long long)kd * (cols + 1)) *
         sizeof(float);
}

// Shared memory one block of segment_outer_f32's partial kernel asks for.
extern "C" long long segment_outer_smem_bytes(int k, int n, int tile) {
  const int kc = k < kOuterSlice ? k : kOuterSlice;
  const int nc = n < kOuterSlice ? n : kOuterSlice;
  return (long long)tile * (kc + nc) * sizeof(float);
}

// K1. x [nx, k], w [R, k, n], gidx [num_tiles * tile], t2g [>= num_tiles],
// scale [num_tiles * tile] or null, y [num_tiles * tile, n]; all contiguous
// on one device; col_tile <= 0: the default slice. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int segment_mm_gather_f32(const float* x, const float* w,
                                     const int* gidx, const int* t2g,
                                     const float* scale, float* y, int k,
                                     int n, int num_tiles, int tile,
                                     int col_tile, int vec4, void* stream) {
  if (num_tiles <= 0 || n <= 0 || k <= 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (col_tile <= 0) col_tile = kColTile;
  const long long smem = segment_mm_smem_bytes(k, n, tile, col_tile);
  cudaError_t e = allow_smem((const void*)segment_mm_gather_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(num_tiles, (n + col_tile - 1) / col_tile);
  segment_mm_gather_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, gidx, t2g, scale, y, k, n, tile, col_tile, vec4);
  return static_cast<int>(cudaGetLastError());
}

// K4. x [num_tiles * tile, kd], w with group stride kd * n and element
// strides (w_sr, w_sc) for (reduction, column): (n, 1) for W [R, kd, n] as
// stored, (1, kd) for the transpose of a W [R, n, kd]; t2g [>= num_tiles],
// scale [num_tiles * tile] or null, y [num_tiles * tile, n].
extern "C" int segment_mm_padded_f32(const float* x, const float* w,
                                     const int* t2g, const float* scale,
                                     float* y, int kd, int n, int num_tiles,
                                     int tile, int col_tile, int vec4,
                                     int w_sr, int w_sc, void* stream) {
  if (num_tiles <= 0 || n <= 0 || kd <= 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (col_tile <= 0) col_tile = kColTile;
  const long long smem = segment_mm_smem_bytes(kd, n, tile, col_tile);
  cudaError_t e = allow_smem((const void*)segment_mm_padded_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(num_tiles, (n + col_tile - 1) / col_tile);
  segment_mm_padded_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, t2g, scale, y, kd, n, tile, col_tile, vec4, w_sr, w_sc);
  return static_cast<int>(cudaGetLastError());
}

// K5. x [T * tile, k], dy [T * tile, n], group_tile_ptr and group_chunk_ptr
// [num_groups + 1], partial [num_chunks, k, n] fp64 scratch, dw
// [num_groups, k, n]. Launches the partial kernel (when num_chunks > 0)
// and the combine kernel on `stream`.
extern "C" int segment_outer_f32(const float* x, const float* dy,
                                 const int* group_tile_ptr,
                                 const int* group_chunk_ptr, double* partial,
                                 float* dw, int k, int n, int tile,
                                 int num_groups, int num_chunks,
                                 int chunk_tiles, void* stream) {
  if (num_groups <= 0 || k <= 0 || n <= 0 || tile <= 0 || num_chunks < 0 ||
      chunk_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_chunks > 0) {
    const long long smem = segment_outer_smem_bytes(k, n, tile);
    cudaError_t e =
        allow_smem((const void*)segment_outer_partial_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(num_chunks, (k + kOuterSlice - 1) / kOuterSlice,
              (n + kOuterSlice - 1) / kOuterSlice);
    segment_outer_partial_kernel<<<grid, kThreads, smem, s>>>(
        x, dy, group_tile_ptr, group_chunk_ptr, partial, k, n, tile,
        num_groups, chunk_tiles);
    cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  const int kn = k * n;
  int ysplit = (kn + kThreads - 1) / kThreads;
  if (ysplit > 65535) ysplit = 65535;
  dim3 grid(num_groups, ysplit);
  segment_outer_combine_kernel<<<grid, kThreads, 0, s>>>(
      partial, group_chunk_ptr, dw, kn);
  return static_cast<int>(cudaGetLastError());
}
