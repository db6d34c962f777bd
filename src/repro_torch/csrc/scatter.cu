// K11, seg_sum_sorted_f32 — the backward's scatter-add as a sum over the
// entries of a stable sort of its target index:
//     out[r] = sum_{j = ptr[r]}^{ptr[r+1]-1} values[perm[j]]
// in increasing j. perm is a stable sort of the target of every value row,
// ptr the first sorted position of each row (searchsorted of the sorted
// targets); rows with target -1 sort first and lie before ptr[0], so they
// add nothing.
//   Replaces no TPU kernel. The reference leaves these sums to XLA's
//   scatter-add (jnp `.at[].add` and `jax.ops.segment_sum` in the custom
//   VJPs of repro/kernels/ops.py); the port's `index_add_` used float
//   atomics on the card, whose order changes from run to run, so training
//   was not bitwise repeatable. This kernel takes their place in the dX of
//   a gathered GEMM (K1's backward) and in the compact message gradients
//   of the two traversal ops.
//
// Bound on the H100: bytes. Each sorted entry reads its perm index and one
// value row of d floats, each row writes d floats; one fp64 add a column
// an entry.
//
// One thread block a row would run in a fixed order too, but it
// serializes on hubs (a high-out-degree source, a popular (src, etype)
// row), as the traversal kernels' node-block walk did before they split by
// slots. So the sorted entries are cut into units of kUnitEntries
// consecutive entries, from the shapes alone, as csrc/traversal.cu cuts its
// slots, one thread block a unit. Each of its kWarps warps walks 32
// consecutive entries in order, lanes spread over the columns (kCols a
// lane, so a warp covers 64 columns a pass), summing each row's run in
// fp64: a row whose entries all lie in the warp's 32 is written at once; a
// row cut by the warp's edges leaves a partial in shared memory, and the
// block's first warp adds those in warp order. A row whose entries all lie
// in the unit is written there; a row that crosses a unit edge leaves one
// fp64 partial in each unit it touches: its first unit's tail, every later
// unit's head (a workspace of 2 * units rows). The combine kernel,
// launched after it on the same stream, adds them in unit order and writes
// the row. No float atomics: the result is bit for bit the same from
// launch to launch, whatever the order the blocks run in.
//
// Rows without entries are not written: the wrapper zeroes the output.
// Inputs and outputs are fp32, sums fp64, as in the traversal kernels: a
// hub's long sum stays within the final fp32 rounding of the exact one.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kUnitEntries = 256;   // sorted entries of one unit
constexpr int kWarps = 8;           // warps of a unit block
constexpr int kWarpEntries = kUnitEntries / kWarps;   // 32 a warp
constexpr int kCols = 2;            // columns a lane sums in one pass
constexpr int kPassCols = 32 * kCols;
constexpr int kLoadAhead = 8;       // entries a lane keeps in flight
constexpr int kCombineThreads = 256;

// The row whose run holds sorted entry j, for ptr[0] <= j < ptr[num_rows]:
// the last r with ptr[r] <= j (rows without entries share their ptr with
// the next row and are passed over).
__device__ __forceinline__ int row_of(const int* __restrict__ ptr,
                                      int num_rows, int j) {
  int lo = 0, hi = num_rows;        // ptr[lo] <= j < ptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ptr + mid) <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Where a sum of row `row` over [s, e) goes: the output if the row's run
// lies inside, else the partial of the run cut by s (`head`) or by e
// (`tail`). Returns 0 / 1 / 2.
__device__ __forceinline__ int cut(const int* __restrict__ ptr, int row,
                                   int s, int e) {
  if (__ldg(ptr + row) < s) return 1;
  return __ldg(ptr + row + 1) > e ? 2 : 0;
}

// One unit: entries [u * kUnitEntries, (u + 1) * kUnitEntries) within
// [ptr[0], ptr[num_rows]), in passes of kPassCols columns. Warp w sums
// rows over its 32 entries; the rows its edges cut go to shared memory
// (slot 0: the run cut by its start, slot 1: the run cut by its end), and
// warp 0 adds them in warp order. A row cut by the unit's start leaves its
// unit sum in the unit's head, a row cut by its end in the tail.
__global__ void __launch_bounds__(kWarps * 32)
seg_sum_sorted_unit_kernel(const float* __restrict__ values,
                           const int* __restrict__ perm,
                           const int* __restrict__ ptr,
                           float* __restrict__ out, double* __restrict__ ws,
                           int d, int num_rows) {
  __shared__ double s_part[kWarps][2][kPassCols];
  __shared__ int s_row[kWarps][2];
  const int u = blockIdx.x;
  const int lo = __ldg(ptr), hi = __ldg(ptr + num_rows);
  const int us = max(u * kUnitEntries, lo);
  const int ue = min(u * kUnitEntries + kUnitEntries, hi);
  if (us >= ue) return;             // no entry of a row: nothing to sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = max(u * kUnitEntries + warp * kWarpEntries, us);
  const int e = min(u * kUnitEntries + (warp + 1) * kWarpEntries, ue);
  const int first = s < e ? row_of(ptr, num_rows, s) : 0;
  double* head = ws + 2LL * u * d;
  double* tail = head + d;
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    int cut_row[2] = {-1, -1};
    int row = first;
    for (int j = s; j < e; ++row) {
      const int stop = min(__ldg(ptr + row + 1), e);
      double acc[kCols] = {};
      for (; j < stop; j += kLoadAhead) {
        float v[kLoadAhead][kCols];
#pragma unroll
        for (int q = 0; q < kLoadAhead; ++q) {
          const long long base =
              j + q < stop
                  ? static_cast<long long>(__ldg(perm + j + q)) * d
                  : -1;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = c0 + lane + 32 * k;
            v[q][k] = base >= 0 && c < d ? __ldg(values + base + c) : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kLoadAhead; ++q) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (j + q < stop) acc[k] += static_cast<double>(v[q][k]);
          }
        }
      }
      j = stop;
      const int where = cut(ptr, row, s, e);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (where == 0) {
          if (c < d) out[static_cast<long long>(row) * d + c] =
              static_cast<float>(acc[k]);
        } else {
          s_part[warp][where - 1][lane + 32 * k] = acc[k];
        }
      }
      if (where) cut_row[where - 1] = row;
    }
    if (lane == 0) {
      s_row[warp][0] = cut_row[0];
      s_row[warp][1] = cut_row[1];
    }
    __syncthreads();
    if (warp == 0) {
      // the cut runs in warp order (each warp's slot 0 before its slot 1)
      // are in row order: sum each row's run of partials, then place it
      int cur = -1;
      double acc[kCols] = {};
      for (int w = 0; w <= kWarps; ++w) {
        for (int k2 = 0; k2 < 2; ++k2) {
          const int r = w < kWarps ? s_row[w][k2] : -2;
          if (r == -1) continue;
          if (r != cur && cur >= 0) {
            const int where = cut(ptr, cur, us, ue);
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int c = c0 + lane + 32 * k;
              if (c >= d) continue;
              if (where == 0) {
                out[static_cast<long long>(cur) * d + c] =
                    static_cast<float>(acc[k]);
              } else {
                (where == 1 ? head : tail)[c] = acc[k];
              }
            }
          }
          if (r == -2) break;
          if (r != cur) {
            cur = r;
#pragma unroll
            for (int k = 0; k < kCols; ++k) acc[k] = 0.0;
          }
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            acc[k] += s_part[w][k2][lane + 32 * k];
          }
        }
      }
    }
    __syncthreads();
  }
}

// One block a unit edge u * kUnitEntries (u >= 1): the row that crosses
// it, if this is the first edge the row crosses, is the sum of its first
// unit's tail and the heads of every later unit it reaches, in unit order.
__global__ void __launch_bounds__(kCombineThreads)
seg_sum_sorted_combine_kernel(const int* __restrict__ ptr,
                              const double* __restrict__ ws,
                              float* __restrict__ out, int d, int num_rows,
                              int num_units) {
  const int u = blockIdx.x + 1;
  if (u >= num_units) return;
  const int edge = u * kUnitEntries;
  const int lo = __ldg(ptr), hi = __ldg(ptr + num_rows);
  if (edge <= lo || edge >= hi) return;
  const int row = row_of(ptr, num_rows, edge);
  const int rs = __ldg(ptr + row), re = __ldg(ptr + row + 1);
  // crosses no edge here (begins at it), or crossed an earlier one
  if (rs >= edge || rs < edge - kUnitEntries) return;
  const int last = (re - 1) / kUnitEntries;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    double acc = ws[(2LL * (u - 1) + 1) * d + c];
#pragma unroll 8
    for (int w = u; w <= last; ++w) acc += ws[2LL * w * d + c];
    out[static_cast<long long>(row) * d + c] = static_cast<float>(acc);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K11. values [n_values, d]; perm [n_entries] (indices into values, a
// stable sort of their targets); ptr [num_rows + 1]; out [num_rows, d],
// zeroed by the caller; ws 2 * ceil(n_entries / 256) * d doubles (a head
// and a tail partial row a unit; the combine reads only what the units
// wrote, so it is not cleared). Two launches on `stream`: the units, then
// the combine.
extern "C" int seg_sum_sorted_f32(const float* values, const int* perm,
                                  const int* ptr, float* out, double* ws,
                                  int d, int n_entries, int num_rows,
                                  void* stream) {
  if (d <= 0 || n_entries <= 0 || num_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int units = (n_entries + kUnitEntries - 1) / kUnitEntries;
  const int threads = std::min(kCombineThreads, (d + 31) / 32 * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seg_sum_sorted_unit_kernel<<<units, kWarps * 32, 0, s>>>(
      values, perm, ptr, out, ws, d, num_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // launched even for one unit (it then returns at once): a call is
  // always two kernels
  seg_sum_sorted_combine_kernel<<<std::max(1, units - 1), threads, 0, s>>>(
      ptr, ws, out, d, num_rows, units);
  return static_cast<int>(cudaGetLastError());
}

// The unit size the wrapper sizes the workspace with.
extern "C" long long seg_sum_sorted_unit_entries() { return kUnitEntries; }
