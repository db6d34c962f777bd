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
// all at or below the card's ~20 FLOP/byte fp32 ridge (and K5's below the
// fp64 tensor cores' 67 TFLOP/s ridge, 20 FLOP/byte).
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
// ([group_chunk_ptr[g], group_chunk_ptr[g+1]) are g's chunks), where
// chunk_tiles is fitted to the layout's padded tile count by the caller
// (segment_mm.py::outer_chunk_tiles) so that a call has about a wave of
// blocks. One thread block per (chunk, 64 x 64 slice of dW) streams its
// rows through shared memory with cp.async and sums X_t^T dY_t on the
// fp64 tensor cores (mma.sync m16n8k4 .f64, DMMA): an fp32 x fp32 product
// is exact in fp64 (24 + 24 significant bits <= 53), so the products are
// exactly those of an fp64 FMA and only the fp64 summation order differs
// from the plain version (no TF32, no bf16 split). A group with one chunk
// is written by its block; a longer group's blocks write fp64 partials and
// the last to arrive (an integer counter per group and slice; no float
// atomics) adds them in chunk order: one launch a call, bitwise repeatable.
// Groups that own no real tile are written as zeros (the TPU kernel never
// visits them; its caller masks them).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColTile = 64;   // the default column slice of K1 / K4

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

// ---------------------------------------------------------------------------
// K5: dW on fp64 tensor cores
// ---------------------------------------------------------------------------
constexpr int kOuterSlice = 64;          // rows and columns of a dW slice
constexpr int kOuterRows = 32;           // rows of X and dY a stage holds
constexpr int kOuterLd = kOuterSlice + 8;  // 72: conflict-free fragments
constexpr int kOuterTile = kOuterRows * kOuterLd;   // floats of one operand
constexpr int kOuterStages = 2;          // stages in the cp.async ring
constexpr int kOuterPtrCap = 1024;       // groups whose offsets a block stages
constexpr int kOuterWarps = kThreads / 32;
// dynamic shared memory of a K5 block: the ring (36,864 bytes; four
// stages measured no faster than two on the H100), which the row groups'
// fp64 sums reuse at the end (at most 28,672 bytes)
constexpr int kOuterSmem = kOuterStages * 2 * kOuterTile * sizeof(float);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, 16 or 4 bytes; zero-filled where !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// c[16x8] += a[16x4] @ b[4x8] in fp64 (DMMA; sm_90's m16n8k4 shape, which
// measured no slower than two sm_80 m8n8k4 on the H100). Fragments:
// a0 = A[g][t], a1 = A[g + 8][t], b0 = B[t][g]; c0, c1 = C[g][2t, 2t + 1],
// c2, c3 = C[g + 8][2t, 2t + 1] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void dmma_16x8x4(double (&c)[4], double a0,
                                            double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// Stage rows row0 .. row0 + valid - 1 (at most kOuterRows) of the `cols`
// columns at c0 of a row-major [*, ld] matrix into dst[kOuterRows][kOuterLd];
// rows past `valid` are zero-filled.
__device__ __forceinline__ void outer_stage(float* dst,
                                            const float* __restrict__ src,
                                            int ld, int c0, int cols,
                                            size_t row0, int valid,
                                            bool vec4) {
  if (vec4) {
    const int q = cols >> 2;
    for (int i = threadIdx.x; i < kOuterRows * q; i += blockDim.x) {
      const int r = i / q;
      const int c = (i - r * q) * 4;
      const bool in = r < valid;
      cp_async16(dst + r * kOuterLd + c,
                 in ? src + (row0 + r) * ld + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kOuterRows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      const bool in = r < valid;
      cp_async4(dst + r * kOuterLd + c,
                in ? src + (row0 + r) * ld + c0 + c : src, in);
    }
  }
}

// Zero the (kc x nc at k0, n0) slice of dW[g] for every group g in
// [g0, g1): groups that own no real tile.
__device__ __forceinline__ void outer_zero_groups(float* __restrict__ dw,
                                                  int g0, int g1, int k,
                                                  int n, int k0, int n0,
                                                  int kc, int nc) {
  for (int g = g0; g < g1; ++g) {
    for (int e = threadIdx.x; e < kc * nc; e += blockDim.x) {
      const int i = e / nc;
      dw[((size_t)g * k + k0 + i) * n + n0 + e - i * nc] = 0.f;
    }
  }
}

// One thread block per (chunk, 64-row slice of k, 64-column slice of n).
// A chunk is at most chunk_tiles consecutive real tiles of one group g:
// its rows are contiguous, so the block streams them through a ring of
// 32-row stages in shared memory (cp.async, the next stage in flight
// while one is multiplied). The group offsets come in first, staged in
// shared memory in one round trip. The block's eight warps cover the
// kc x nc slice in warp tiles of 16 x 32 (wm x wn of them) and, where
// the slice needs fewer than eight, split the stage's 4-row steps over
// wr = 8 / (wm * wn) row groups, added in row-group order at the end.
// Every step is one fp64 m16n8k4 MMA per 8 columns: A = X^T (16 of dW's
// rows by 4 of X's rows), B = dY (4 rows by 8 columns), both converted
// from fp32 exactly. A group with one chunk is written to dW directly;
// otherwise each chunk writes its fp64 partial, and the last of the
// group's blocks to arrive (an integer counter a group and slice; no
// float atomics) adds the partials in chunk order (a small slice's idle
// threads in lanes of chunk runs, added in lane order), writes dW and
// resets the counter to 0. The first chunk of a group also zeroes the
// groups without chunks just before it, the last chunk all those after it.
// Chunks past group_chunk_ptr[G] (the static bound of device-built
// layouts) return at once.
__global__ void __launch_bounds__(kThreads)
segment_outer_kernel(const float* __restrict__ x,
                     const float* __restrict__ dy,
                     const int* __restrict__ group_tile_ptr,
                     const int* __restrict__ group_chunk_ptr,
                     double* __restrict__ partial, float* __restrict__ dw,
                     int* __restrict__ counters, int k, int n, int tile,
                     int num_groups, int chunk_tiles) {
  extern __shared__ __align__(16) float stage[];  // [stages][x, dy][tile]
  __shared__ int s_ptr[2][kOuterPtrCap];  // group_chunk_ptr, group_tile_ptr
  __shared__ int s_last;
  const int chunk = blockIdx.x;
  // both offset arrays in one round trip to global memory, where they fit
  const bool staged = num_groups < kOuterPtrCap;
  if (staged) {
    for (int i = threadIdx.x; i <= num_groups; i += blockDim.x) {
      s_ptr[0][i] = group_chunk_ptr[i];
      s_ptr[1][i] = group_tile_ptr[i];
    }
    __syncthreads();
  }
  const int* gcp = staged ? s_ptr[0] : group_chunk_ptr;
  const int* gtp = staged ? s_ptr[1] : group_tile_ptr;
  const int total_chunks = gcp[num_groups];
  if (chunk >= total_chunks) {
    if (total_chunks == 0 && chunk == 0) {    // no group owns a real tile
      outer_zero_groups(dw, 0, num_groups, k, n, blockIdx.y * kOuterSlice,
                        blockIdx.z * kOuterSlice,
                        min(kOuterSlice, k - (int)blockIdx.y * kOuterSlice),
                        min(kOuterSlice, n - (int)blockIdx.z * kOuterSlice));
    }
    return;
  }
  // the chunk's group: the last g with group_chunk_ptr[g] <= chunk
  int lo = 0, hi = num_groups;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (gcp[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int g = lo;
  const int c_begin = gcp[g];
  const int c_end = gcp[g + 1];
  const int k0 = blockIdx.y * kOuterSlice;
  const int n0 = blockIdx.z * kOuterSlice;
  const int kc = min(kOuterSlice, k - k0);
  const int nc = min(kOuterSlice, n - n0);
  if (chunk == c_begin) {
    int g0 = g;
    while (g0 > 0 && gcp[g0 - 1] == c_begin) --g0;
    outer_zero_groups(dw, g0, g, k, n, k0, n0, kc, nc);
  }
  if (chunk == total_chunks - 1) {
    outer_zero_groups(dw, g + 1, num_groups, k, n, k0, n0, kc, nc);
  }

  const int t_begin = gtp[g] + (chunk - c_begin) * chunk_tiles;
  const int t_end = min(t_begin + chunk_tiles, gtp[g + 1]);
  const size_t row_begin = (size_t)t_begin * tile;
  const int rows = (t_end - t_begin) * tile;
  const int stages = (rows + kOuterRows - 1) / kOuterRows;
  const bool x4 = (k & 3) == 0 &&
                  (reinterpret_cast<size_t>(x) & 15) == 0;
  const bool d4 = (n & 3) == 0 &&
                  (reinterpret_cast<size_t>(dy) & 15) == 0;

  // the columns past kc / nc that the fragments read (up to the next 16
  // of X's, 8 of dY's): zero, once
  const int xz = (kc + 15) / 16 * 16 - kc;
  const int dz = (nc + 7) / 8 * 8 - nc;
  for (int i = threadIdx.x; i < kOuterStages * kOuterRows * (xz + dz);
       i += blockDim.x) {
    const int row = i / (xz + dz);        // buffer * kOuterRows + row
    const int c = i - row * (xz + dz);
    float* buf = stage + (row / kOuterRows) * 2 * kOuterTile +
                 (row % kOuterRows) * kOuterLd;
    if (c < xz) {
      buf[kc + c] = 0.f;
    } else {
      buf[kOuterTile + nc + c - xz] = 0.f;
    }
  }

  const int wm = (kc + 15) / 16;
  const int wn = (nc + 31) / 32;
  const int wr = kOuterWarps / (wm * wn);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp / (wm * wn);            // row group
  const int wt = warp - rg * (wm * wn);       // warp tile
  const int mb = (wt / wn) * 16;
  const int nb = (wt % wn) * 32;
  const int jn = min(4, (nc - nb + 7) / 8);   // 8-column tiles in range
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool active = rg < wr;

  double acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0;
  }

  // a ring of kOuterStages stages: stage s lives in buffer s % kOuterStages
  // and is in flight kOuterStages - 1 stages ahead of its use
  auto issue = [&](int s) {
    if (s < stages) {
      float* buf = stage + (s % kOuterStages) * 2 * kOuterTile;
      const int r0 = s * kOuterRows;
      const int valid = min(rows - r0, kOuterRows);
      outer_stage(buf, x, k, k0, kc, row_begin + r0, valid, x4);
      outer_stage(buf + kOuterTile, dy, n, n0, nc, row_begin + r0, valid,
                  d4);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kOuterStages - 1; ++s) issue(s);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kOuterStages - 2>();      // stage s has landed
    __syncthreads();                        // and stage s - 1 is consumed
    issue(s + kOuterStages - 1);            // into stage s - 1's buffer
    const float* xs = stage + (s % kOuterStages) * 2 * kOuterTile;
    const float* ds = xs + kOuterTile;
    const int steps = (min(rows - s * kOuterRows, kOuterRows) + 3) >> 2;
    if (active) {
      for (int st = rg; st < steps; st += wr) {
        const int r = st * 4 + tq;
        const double a0 = xs[r * kOuterLd + mb + gq];
        const double a1 = xs[r * kOuterLd + mb + gq + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < jn) {
            dmma_16x8x4(acc[j], a0, a1,
                        ds[r * kOuterLd + nb + j * 8 + gq]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the stages are free for the sums

  // the row groups' sums, added in row-group order
  if (wr > 1) {
    double* red = reinterpret_cast<double*>(stage);
    if (active && rg > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          red[(((rg - 1) * (wm * wn) + wt) * 16 + j * 4 + q) * 32 + lane] =
              acc[j][q];
        }
      }
    }
    __syncthreads();
    if (active && rg == 0) {
      for (int o = 1; o < wr; ++o) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[j][q] += red[(((o - 1) * (wm * wn) + wt) * 16 + j * 4 + q) *
                                 32 + lane];
          }
        }
      }
    }
  }

  const bool single = c_end - c_begin == 1;
  if (active && rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = mb + gq + (q >> 1) * 8;
        const int c = nb + j * 8 + 2 * tq + (q & 1);
        if (i < kc && c < nc) {
          const size_t e = ((size_t)(single ? g : chunk) * k + k0 + i) * n +
                           n0 + c;
          if (single) {
            dw[e] = static_cast<float>(acc[j][q]);
          } else {
            partial[e] = acc[j][q];
          }
        }
      }
    }
  }
  if (single) return;
  __threadfence();
  __syncthreads();
  int* counter =
      counters + ((size_t)g * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1) == c_end - c_begin - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block of the group: its partials in chunk order
  const int ne = kc * nc;
  const size_t kn = (size_t)k * n;
  if (ne <= kThreads) {
    // one element a thread, and the block's kThreads / ne lanes of
    // threads each sum a contiguous run of the chunks (8 loads in flight),
    // the lanes then added in lane order
    const int lanes = kThreads / ne;
    const int lane_c = threadIdx.x / ne;
    const int e = threadIdx.x - lane_c * ne;
    const int i = e / nc;
    const int off = (k0 + i) * n + n0 + e - i * nc;
    double sum = 0.0;
    if (lane_c < lanes) {
      const int m = c_end - c_begin;
      const int per = (m + lanes - 1) / lanes;
      const int ca = c_begin + min(lane_c * per, m);
      const int cb = c_begin + min((lane_c + 1) * per, m);
      int c = ca;
      for (; c + 8 <= cb; c += 8) {
        double v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(partial + (c + u) * kn + off);
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += v[u];
      }
      for (; c < cb; ++c) sum += __ldcg(partial + c * kn + off);
    }
    double* lane_sums = reinterpret_cast<double*>(stage);
    lane_sums[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x < ne) {
      for (int l = 1; l < lanes; ++l) sum += lane_sums[l * ne + threadIdx.x];
      dw[g * kn + off] = static_cast<float>(sum);
    }
  } else {
    // each thread's kPer elements loaded together (one latency a chunk)
    constexpr int kPer = kOuterSlice * kOuterSlice / kThreads;
    const int cnt = (ne - threadIdx.x + kThreads - 1) / kThreads;
    int off[kPer];
    double sum[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int e = threadIdx.x + p * kThreads;
      const int i = e / nc;
      off[p] = (k0 + i) * n + n0 + e - i * nc;
      sum[p] = 0.0;
    }
    for (int c = c_begin; c < c_end; ++c) {
      const double* pc = partial + c * kn;
      double v[kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        v[p] = p < cnt ? __ldcg(pc + off[p]) : 0.0;
      }
#pragma unroll
      for (int p = 0; p < kPer; ++p) sum[p] += v[p];
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (p < cnt) dw[g * kn + off[p]] = static_cast<float>(sum[p]);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
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
// [num_groups + 1] (chunks of at most chunk_tiles real tiles), partial
// [num_chunks, k, n] fp64 scratch (rows of multi-chunk groups only),
// counters [num_groups * ceil(k / 64) * ceil(n / 64)] int32, zero before
// the launch and zero again after it, dw [num_groups, k, n]. One launch on
// `stream`, num_chunks blocks along x (chunks past group_chunk_ptr[G]
// return at once).
extern "C" int segment_outer_f32(const float* x, const float* dy,
                                 const int* group_tile_ptr,
                                 const int* group_chunk_ptr, double* partial,
                                 float* dw, int* counters, int k, int n,
                                 int tile, int num_groups, int num_chunks,
                                 int chunk_tiles, void* stream) {
  if (num_groups <= 0 || k <= 0 || n <= 0 || tile <= 0 || num_chunks <= 0 ||
      chunk_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e =
      allow_smem((const void*)segment_outer_kernel, kOuterSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(num_chunks, (k + kOuterSlice - 1) / kOuterSlice,
            (n + kOuterSlice - 1) / kOuterSlice);
  segment_outer_kernel<<<grid, kThreads, kOuterSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, dy, group_tile_ptr, group_chunk_ptr, partial, dw, counters, k, n,
      tile, num_groups, chunk_tiles);
  return static_cast<int>(cudaGetLastError());
}
