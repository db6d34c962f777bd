// K11, seg_sum_sorted_f32 — the backward's scatter-add as a sum over the
// entries of a stable sort of its target index:
//     out[r] = sum over j with key[j] == r of values[perm[j]]
// in increasing j. perm is a stable sort of the target of every value row,
// key the sorted targets themselves; entries with target -1 sort first and
// add nothing. Rows without entries are zero.
//   Replaces no TPU kernel. The reference leaves these sums to XLA's
//   scatter-add (jnp `.at[].add` and `jax.ops.segment_sum` in the custom
//   VJPs of repro/kernels/ops.py); the port's `index_add_` used float
//   atomics on the card, whose order changes from run to run, so training
//   was not bitwise repeatable. This kernel takes their place in the dX of
//   a gathered GEMM (K1's backward) and in the compact message gradients
//   of the two traversal ops.
//
// Bound on the H100: bytes. Each sorted entry reads its key, its perm index
// and one value row of d floats, each row writes d floats; one fp64 add a
// column an entry. The value rows are gathered by index, a few hundred
// bytes each, so the kernel lives on how many of them it keeps in flight.
//
// The design, from the host's `traversal.scatter_plan` (shapes only):
// * One warp a unit of `unit` consecutive sorted entries (a block is one
//   warp). It stages the unit's keys and perm indices into shared memory
//   with coalesced loads; an entry's row is its key, a run's edges are
//   where neighbouring keys differ: nothing searches an offset array.
// * Value rows are gathered into a two-stage shared-memory ring with
//   `cp.async` (16-byte `cp.async.cg` at vec = 4, i.e. d % 4 == 0; 4-byte
//   copies otherwise), a stage being `chunk` entries x one column pass of
//   lanes x vec columns; the next stage is in flight while one is summed,
//   so a row boundary never drains the loads.
// * Lanes split into 32 / lanes groups of `lanes` lanes, each lane vec
//   columns: each group walks its own span of a stage's entries in order,
//   writing the runs that end inside it; the groups' first and last runs
//   are then joined by a segmented scan across the groups (shuffles, a
//   fixed tree order), and a run that goes on past the stage is carried
//   in registers. Sums are fp64.
// * A row that crosses a unit edge leaves fp64 partials in each unit it
//   touches (its first unit's tail, every later unit's head). Each unit
//   writes its partials, fences, and adds a term to the integer ticket of
//   the row's last unit b: -(a + 1) from the first unit a, -1 from each
//   unit between, b + 2 from b, so the ticket reaches 2 exactly when the
//   last of them arrives (no earlier subset sums to 2). That unit adds the
//   partials in unit order, writes the row and resets the ticket. The
//   integer atomics pick who combines, never the order of the float sums:
//   the result is bit for bit the same from launch to launch, whatever the
//   order the blocks run in. One launch a call.
// * Rows without entries are zeroed here: the warp that holds the entry
//   where the key steps from p to k > p + 1 writes zeros over rows
//   p + 1 .. k - 1 (the last unit also over the rows after the last key).
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 2;          // the ring of value-row stages
constexpr int kMaxSmemBytes = 48 * 1024;
constexpr int kUnroll = 16;         // partials in flight in the combine

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The last unit of the run of `row` that goes on past unit u: the units
// after u start with `row` up to it. One strided load a lane, 32 units a
// round.
__device__ __forceinline__ int run_end_unit(const int* __restrict__ key,
                                            int row, int u, int unit,
                                            int units, int lane) {
  for (int v0 = u + 1;; v0 += 32) {
    const int v = v0 + lane;
    const bool stop =
        v >= units || __ldg(key + static_cast<long long>(v) * unit) != row;
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) return v0 + __ffs(m) - 2;
  }
}

// Row `row` of a run over units a .. b: unit a's tail partial plus the head
// partials of units a + 1 .. b, W doubles a load (2 where d is even). Lanes
// over the row's W-column vectors and, where a row has fewer than 32 of
// them, over slices of the units (each strided, in unit order); kUnroll
// loads a lane in flight; the slices meet in a fixed tree.
template <int W>
__device__ __forceinline__ void combine_row(const double* __restrict__ ws,
                                            float* __restrict__ out, int d,
                                            int row, int a, int b, int lane) {
  using Vec = typename std::conditional<W == 2, double2, double>::type;
  const int cols = d / W;
  const int cw = cols >= 32 ? 32 : 1 << (32 - __clz(cols - 1));
  const int gs = 32 / cw, slice = lane / cw;
  for (int c0 = 0; c0 < cols; c0 += cw) {
    const int c = c0 + lane % cw;
    double acc[W] = {};
    if (c < cols) {
      for (int w = a + 1 + slice; w <= b; w += kUnroll * gs) {
        Vec t[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int wi = w + i * gs;
          t[i] = wi <= b ? __ldcg(reinterpret_cast<const Vec*>(
                               ws + 2LL * wi * d) + c)
                         : Vec{};
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const double* x = reinterpret_cast<const double*>(t + i);
#pragma unroll
          for (int q = 0; q < W; ++q) acc[q] += x[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      for (int o = gs / 2; o >= 1; o >>= 1) {
        acc[q] += __shfl_down_sync(kFull, acc[q], o * cw);
      }
    }
    if (slice == 0 && c < cols) {
      const double* first = ws + (2LL * a + 1) * d + c * W;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        out[static_cast<long long>(row) * d + c * W + q] =
            static_cast<float>(__ldcg(first + q) + acc[q]);
      }
    }
  }
}

template <int V, int L>
__global__ void __launch_bounds__(32)
seg_sum_sorted_kernel(const float* __restrict__ values,
                      const int* __restrict__ perm,
                      const int* __restrict__ key, float* __restrict__ out,
                      double* __restrict__ ws, int* __restrict__ tickets,
                      int d, int n, int num_rows, int unit, int chunk) {
  constexpr int G = 32 / L;         // lane groups, each walking entries
  constexpr int P = L * V;          // columns a column pass
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [kStages][chunk][P]
  int* key_s = reinterpret_cast<int*>(smem + kStages * chunk * P);
  int* perm_s = key_s + unit;
  const int lane = threadIdx.x;
  const int u = blockIdx.x;
  const int units = gridDim.x;
  const long long us = static_cast<long long>(u) * unit;
  const int cnt = static_cast<int>(min(static_cast<long long>(unit), n - us));

  for (int t = lane; t < cnt; t += 32) {
    key_s[t] = __ldg(key + us + t);
    perm_s[t] = __ldg(perm + us + t);
  }
  const int before = us > 0 ? __ldg(key + us - 1) : -1;
  const bool last_unit = us + cnt == n;
  const int after = last_unit ? INT_MIN : __ldg(key + us + cnt);
  __syncwarp();
  const int first_row = key_s[0], last_row = key_s[cnt - 1];

  // zeros over the rows without entries whose gap begins in this unit
  for (int t0 = 0; t0 <= cnt; t0 += 32) {
    const int t = t0 + lane;
    long long lo = 0, hi = 0;
    if (t < cnt) {
      const int prev = t ? key_s[t - 1] : before, cur = key_s[t];
      lo = static_cast<long long>(prev + 1) * d;
      hi = static_cast<long long>(cur) * d;
    } else if (t == cnt && last_unit) {
      lo = static_cast<long long>(last_row + 1) * d;
      hi = static_cast<long long>(num_rows) * d;
    }
    unsigned m = __ballot_sync(kFull, hi > lo);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const long long a = __shfl_sync(kFull, lo, src);
      const long long b = __shfl_sync(kFull, hi, src);
      for (long long i = a + lane; i < b; i += 32) out[i] = 0.0f;
    }
  }
  if (last_row < 0) return;         // every entry's target is -1

  // the run of the unit's first row began in an earlier unit (head), the
  // run of its last row goes on into a later one (tail); a unit inside
  // one run is both and keeps its partial as the head
  const bool head_open = first_row >= 0 && before == first_row;
  const bool tail_open = after == last_row;
  double* head = ws + 2LL * u * d;
  double* tail = head + d;
  const int g = lane / L, cl = lane % L;

  // a run's sum over this unit, at columns c .. c + V - 1 of lane cl
  auto put = [&](int row, const double* v, int c) {
    if (row < 0 || c >= d) return;
    if (row == first_row && head_open) {
#pragma unroll
      for (int q = 0; q < V; ++q) head[c + q] = v[q];
    } else if (row == last_row && tail_open) {
#pragma unroll
      for (int q = 0; q < V; ++q) tail[c + q] = v[q];
    } else if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + static_cast<long long>(row) * d + c) =
          make_float4(static_cast<float>(v[0]), static_cast<float>(v[1]),
                      static_cast<float>(v[2]), static_cast<float>(v[3]));
    } else {
      out[static_cast<long long>(row) * d + c] = static_cast<float>(v[0]);
    }
  };

  const int nch = (cnt + chunk - 1) / chunk;
  const int stages = nch * ((d + P - 1) / P);
  // stage s: column pass s / nch, entries of chunk s % nch
  auto issue = [&](int s) {
    if (s < stages) {
      float* dst = ring + (s % kStages) * chunk * P;
      const int c0 = (s / nch) * P, t0 = (s % nch) * chunk;
      const int rows = min(chunk, cnt - t0);
      for (int i = lane; i < rows * L; i += 32) {
        const int e = i / L, c = c0 + (i % L) * V;
        if (key_s[t0 + e] >= 0 && c < d) {
          copy_async<V>(dst + e * P + (i % L) * V,
                        values + static_cast<long long>(perm_s[t0 + e]) * d +
                            c);
        }
      }
    }
    commit_async();
  };

  double carry[V];
  int carry_row = INT_MIN;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  // the last unit of a run that goes on past this one, while the first
  // stages load
  const int b_tail = tail_open ? run_end_unit(key, last_row, u, unit, units,
                                              lane) : -1;
  for (int s = 0; s < stages; ++s) {
    issue(s + kStages - 1);
    wait_async<kStages - 1>();
    __syncwarp();
    const int ch = s % nch, t0 = ch * chunk;
    const int rows = min(chunk, cnt - t0);
    const int c = (s / nch) * P + cl * V;
    const float* src = ring + (s % kStages) * chunk * P;
    if (ch == 0) carry_row = INT_MIN;
    // the key of the chunk's entry e; past the unit's last entry, its last
    // row (whose value is zero)
    auto key_at = [&](int e) { return e < rows ? key_s[t0 + e] : last_row; };
    // each group walks its span of the chunk in order: a run that ends
    // inside the span is written at once, its first run (head) and last
    // run (tail) are kept; a span of one run passes it on
    int hk = INT_MIN, tk = INT_MIN;
    double hv[V], acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) hv[q] = acc[q] = 0.0;
    const int span = chunk / G;
    for (int i = 0; i < span; ++i) {
      const int e = g * span + i;
      const int k = key_at(e);
      if (k != tk) {
        if (tk != INT_MIN) {
          if (hk == INT_MIN) {
            hk = tk;
#pragma unroll
            for (int q = 0; q < V; ++q) hv[q] = acc[q];
          } else {
            put(tk, acc, c);
          }
        }
        tk = k;
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = 0.0;
      }
      if (e < rows && k >= 0 && c < d) {
        if constexpr (V == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + e * P +
                                                            cl * V);
          acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
        } else {
          acc[0] += src[e * P + cl];
        }
      }
    }
    // join the groups in order: what group g passes right (o, for key tk)
    // is its tail, plus what came from the left where its span is one run
    // of the same key: a segmented scan in a fixed tree order
    const bool multi = hk != INT_MIN;
    const int in_key = multi ? hk : tk;
    if (carry_row != INT_MIN &&
        carry_row != __shfl_sync(kFull, in_key, 0)) {
      if (g == 0) put(carry_row, carry, c);   // its run ended before
      carry_row = INT_MIN;
    }
    double o[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      o[q] = g == 0 && !multi && carry_row == tk ? carry[q] + acc[q]
                                                : acc[q];
    }
    const int tk_left = __shfl_up_sync(kFull, tk, L);
    bool head = g == 0 || multi || tk_left != tk;
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const bool head_up = __shfl_up_sync(kFull, head, off * L);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const double up = __shfl_up_sync(kFull, o[q], off * L);
        if (g >= off && !head) o[q] = up + o[q];
      }
      if (g >= off && !head) head = head_up;
    }
    // a tail run that the next group does not go on with ends here
    const int in_right = __shfl_down_sync(kFull, in_key, L);
    if (g < G - 1 && in_right != tk) put(tk, o, c);
    // a group's head run ends in it: what came from the left, plus hv
    if (G > 1 || multi) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const double up = __shfl_up_sync(kFull, o[q], L);
        if (multi && g > 0 && tk_left == hk) {
          hv[q] = up + hv[q];
        } else if (multi && g == 0 && carry_row == hk) {
          hv[q] = carry[q] + hv[q];
        }
      }
      if (multi) put(hk, hv, c);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      carry[q] = __shfl_sync(kFull, o[q], (G - 1) * L + cl);
    }
    carry_row = __shfl_sync(kFull, tk, (G - 1) * L);
    if (ch == nch - 1 && g == 0) put(carry_row, carry, c);
    __syncwarp();
  }
  wait_async<0>();
  if (!head_open && !tail_open) return;

  // the rows that cross a unit edge: tickets at their last unit
  const bool inside = head_open && tail_open && first_row == last_row;
  int* count = tickets;             // [units], zero before the launch
  int* first = tickets + units;     // [units]: the first unit of the run
  if (lane == 0 && tail_open && !inside) first[b_tail] = u;
  __threadfence();
  __syncwarp();
  int done = 0;                     // bit 0: first_row, bit 1: last_row
  if (lane == 0) {
    if (inside) {
      done = atomicAdd(count + b_tail, -1) - 1 == 2;
    } else {
      if (head_open && atomicAdd(count + u, u + 2) + u + 2 == 2) done = 1;
      if (tail_open && atomicAdd(count + b_tail, -(u + 1)) - (u + 1) == 2) {
        done |= 2;
      }
    }
  }
  done = __shfl_sync(kFull, done, 0);
  if (!done) return;
  __threadfence();
  for (int bit = 0; bit < 2; ++bit) {
    if (!(done >> bit & 1)) continue;
    const int row = bit ? last_row : first_row;
    const int b = bit || inside ? b_tail : u;
    const int a = __ldcg(first + b);
    if (d % 2 == 0) {
      combine_row<2>(ws, out, d, row, a, b, lane);
    } else {
      combine_row<1>(ws, out, d, row, a, b, lane);
    }
    if (lane == 0) count[b] = 0;    // a graph replay finds it zero
  }
}

template <int V, int L>
int launch(const float* values, const int* perm, const int* key, float* out,
           double* ws, int* tickets, int d, int n, int num_rows, int unit,
           int chunk, int units, cudaStream_t s) {
  const int smem = (kStages * chunk * L * V + 2 * unit) * 4;
  seg_sum_sorted_kernel<V, L><<<units, 32, smem, s>>>(
      values, perm, key, out, ws, tickets, d, n, num_rows, unit, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_lanes(int lanes, const float* values, const int* perm,
                 const int* key, float* out, double* ws, int* tickets, int d,
                 int n, int num_rows, int unit, int chunk, int units,
                 cudaStream_t s) {
#define K11_LANES(L)                                                      \
  case L:                                                                 \
    return launch<V, L>(values, perm, key, out, ws, tickets, d, n,        \
                        num_rows, unit, chunk, units, s);
  switch (lanes) {
    K11_LANES(1)
    K11_LANES(2)
    K11_LANES(4)
    K11_LANES(8)
    K11_LANES(16)
    K11_LANES(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K11_LANES
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K11. values [*, d] fp32 (16-byte aligned at vec = 4); perm and key [n]
// int32 (a stable sort of the targets and the sorted targets, -1 first,
// every key below num_rows); out [num_rows, d], every row written here;
// ws 2 * units * d doubles (a head and a tail partial a unit, not
// cleared); tickets 2 * units ints, zero (the counts are left zero).
// `lanes`, `vec`, `chunk` and `unit` come from traversal.scatter_plan;
// units = ceil(n / unit). One launch on `stream`.
extern "C" int seg_sum_sorted_f32(const float* values, const int* perm,
                                  const int* key, float* out, double* ws,
                                  int* tickets, int d, int n, int num_rows,
                                  int unit, int chunk, int lanes, int vec,
                                  void* stream) {
  if (d <= 0 || n <= 0 || num_rows <= 0 || chunk <= 0 || unit <= 0 ||
      unit % chunk != 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && d % 4 != 0) || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || chunk % (32 / lanes) != 0 ||
      (kStages * chunk * lanes * vec + 2 * unit) * 4 > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = (static_cast<long long>(n) + unit - 1) / unit;
  if (units >= INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int u = static_cast<int>(units);
  return vec == 4 ? launch_lanes<4>(lanes, values, perm, key, out, ws,
                                    tickets, d, n, num_rows, unit, chunk, u, s)
                  : launch_lanes<1>(lanes, values, perm, key, out, ws,
                                    tickets, d, n, num_rows, unit, chunk, u,
                                    s);
}
