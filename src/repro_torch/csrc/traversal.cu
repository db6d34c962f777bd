// K2, K3, K6, K7 and K8: the aggregations of the traversal template
// (Hector Algorithm 2) over the blocked destination CSR.
//
// K2, seg_stats_f32 — per-destination softmax statistics:
//     mx[v]  = max(-1e30, max_{e->v} s_e),  den[v] = sum_{e->v} exp(s_e - mx[v])
//   Replaces repro/kernels/traversal.py::seg_stats_padded (_stats_kernel).
// K3, seg_softmax_agg_gather_f32 — gather-fused softmax aggregation:
//     out[v] = sum_{e->v} exp(s_e - mx[v]) / max(den[v], 1e-38) * msg[mmap[e]]
//   Replaces traversal.py::seg_softmax_agg_gather_padded
//   (_softmax_agg_gather_kernel, _gather_msg_tile).
// K7, seg_weighted_agg_gather_f32 — gather-fused weighted aggregation (the
// numerator of RGCN's mean; the division by the in-degree stays outside):
//     out[v] = sum_{e->v} scale_e * msg[mmap[e]]
//   Replaces traversal.py::seg_weighted_agg_gather_padded
//   (_weighted_agg_gather_kernel).
// K6, seg_softmax_agg_padded_f32, and K8, seg_weighted_agg_padded_f32 — K3
// and K7 over messages already padded into the dst-sorted slots
// (msg_p [T * tile, d], the materialized-gather variant the tuner picks
// with fuse_gather = false): the message row of a slot is the slot itself.
//   Replace traversal.py::seg_softmax_agg_padded (_softmax_agg_kernel) and
//   ::seg_weighted_agg_padded (_weighted_agg_kernel).
//
// Bound on the H100: bytes (a few FLOPs per byte). K2 reads each slot's
// score and local destination once and writes two floats per node; K3
// reads each slot's score, destination and message index, one message row
// of d floats per real slot, the node stats, and writes d floats per node;
// K7 reads the same without the stats, a scale in place of the score. K6
// and K8 read no message index; each real slot reads its own message row
// (pad slots' rows are never read).
//
// The TPU kernels run their grid in order and accumulate a node block's
// consecutive edge tiles into one VMEM output block, scattering with a
// one-hot [node_block x tile] matmul. Here blocks run in parallel, in no
// order, and nothing carries over between them. A walk of one thread block
// per node block would take as long as the largest node block's tile
// range, and those are skewed: a hub (bgs: in-degree 22,949), bucketing's
// pad node (about 97K slots at 1024 seeds on bgs), and the pure-pad tiles
// bucketing appends to the last node block. So all five split by slots.
//
// The grid is ceil(T / chunk_tiles) units of chunk_tiles consecutive tiles,
// from the shapes alone. The layouts keep every slot's sort key (slot_key)
// non-decreasing, so a node's real slots form one run and a unit finds its
// nodes from its own slots and the two slots at its edges. A node whose
// slots all lie in one unit is written by that unit; a node that crosses a
// unit edge leaves one partial in each unit it touches (a unit's head and
// tail, in a workspace of 2 * units rows of fp64), and a combine kernel,
// launched after it on the same stream, reduces them in unit order and
// writes the node. No float atomics: every kernel here is deterministic, bit
// for bit from launch to launch.
//
// K3, K6, K7 and K8 (weighted_unit_body, then weighted_combine_body): each
// slot's weight is staged with it: K7's and K8's scale, or K3's and K6's
// attention exp(s - mx[v]) / max(den[v], 1e-38) from K2's statistics of the
// slot's node. Inside a unit, agents of 8-32 threads take contiguous
// sub-runs of slots, lanes spread over a row's columns in vector loads,
// several rows in flight, fp64 sums in registers; the agents' boundary
// nodes are added in agent order in shared memory. Shared memory grows with
// chunk_tiles * tile, never with node_block.
//
// K2 (stats_unit_body, twice, each pass with its combine): the max must be
// known before a slot's term exp(s - mx[v]) is, so K2 makes two exact
// passes over the same units. The max pass takes each node's max of its
// scores, the sum pass the fp64 sum of its fp32 terms exp(s - mx[v]), each
// term the plain version's expression. A warp is an agent over whole
// 32-slot rounds: a segmented scan over the key runs by warp shuffles (the
// run open at a round's end carried into the next), then the agents' first
// and last nodes in agent order. The max is exact and independent of
// order; the sum differs from the plain version only in its fp64 order, so
// den agrees to the final fp32 rounding. An online max would instead
// rescale every crossing node's partial sums by exp(m_unit - m) and round
// its terms differently. Shared memory is a few words a warp, whatever
// chunk_tiles and node_block.
//
// Every node without a slot is written too (mx = -1e30, den = 0, out = 0):
// the unit that holds the first slot after it writes it, and the combine
// writes the node blocks that own no tile, which the TPU kernels never
// visit. Pad slots (local_dst == node_block) add nothing, as the TPU
// kernels' zero scale for them does.
//
// Inputs and outputs are fp32; den and out accumulate in fp64. Bucketing
// routes every pad edge to one pad node, which then sums tens of thousands
// of slots: a sequential fp32 sum of that length drifts by about 1e-5 of
// its value, an fp64 one stays within the final fp32 rounding. FP64 adds
// cost nothing here beside the slot walk.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// the slot split: units of consecutive slots and a fixed-order combine
// ---------------------------------------------------------------------------
constexpr int kUnitThreads = 256;
constexpr int kRowBytes = 64;       // bytes of messages a lane loads ahead
constexpr int kCombineWarps = 8;    // warps (and units) of a combine block
constexpr int kCombineCols = 2;     // columns a combine lane sums at once
constexpr int kChainLoads = 8;      // partials a combine lane loads ahead

// The sort key of slot i: 2 * its global destination for a real slot
// (local_dst < node_block), 2 * (the last node of its block) + 1 for a pad
// slot. Every layout builder places a node block's pad slots after that
// block's real slots (block_csr and device_block_csr pad each block's run
// to whole tiles; pad_blocked_csr appends pure-pad tiles to the last
// block), so the key never decreases along the slot array: a node's real
// slots form one run, and a pad sorts after the last node of its block.
__device__ __forceinline__ int slot_key(const int* __restrict__ local_dst,
                                        const int* __restrict__ t2b, int i,
                                        int tile, int node_block) {
  const int b = t2b[i / tile];
  const int ld = local_dst[i];
  return ld < node_block ? 2 * (b * node_block + ld)
                         : 2 * (b + 1) * node_block - 1;
}

// The node whose run of real slots crosses the boundary before slot s, or
// -1 (no run crosses it, or s is 0 or n_slots).
__device__ __forceinline__ int crossing_node(const int* __restrict__ local_dst,
                                             const int* __restrict__ t2b,
                                             int s, int n_slots, int tile,
                                             int node_block) {
  if (s <= 0 || s >= n_slots) return -1;
  const int a = slot_key(local_dst, t2b, s - 1, tile, node_block);
  const int b = slot_key(local_dst, t2b, s, tile, node_block);
  return (a == b && !(a & 1)) ? a >> 1 : -1;
}

template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const double (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(static_cast<float>(a[0]), static_cast<float>(a[1]),
                    static_cast<float>(a[2]), static_cast<float>(a[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) =
        make_float2(static_cast<float>(a[0]), static_cast<float>(a[1]));
  } else {
    p[0] = static_cast<float>(a[0]);
  }
}

// Write `fill` to rows lo..hi (inclusive) in the V columns at col.
template <int V>
__device__ __forceinline__ void fill_rows(float* __restrict__ out, int lo,
                                          int hi, int d, int col, bool on,
                                          float fill = 0.f) {
  if (!on) return;
  for (int n = lo; n <= hi; ++n) {
    float* p = out + (size_t)n * d + col;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(fill, fill, fill, fill);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(fill, fill);
    } else {
      p[0] = fill;
    }
  }
}

// Fill the slot-less nodes prev+1 .. hi before a slot of node block bs
// (prev: the node of the slot before it, -1 before the first slot) that
// lie in prev's block or in bs. The node blocks strictly between own no
// tile: the combine kernel fills those, so a long run of them costs no
// agent a serial loop.
template <int V>
__device__ __forceinline__ void fill_gap(float* __restrict__ out, int prev,
                                         int hi, int bs, int node_block,
                                         int d, int col, bool on,
                                         float fill = 0.f) {
  if (hi <= prev) return;
  const int bp = prev >= 0 ? prev / node_block : -1;
  if (bp == bs) {
    fill_rows<V>(out, prev + 1, hi, d, col, on, fill);
    return;
  }
  if (bp >= 0) fill_rows<V>(out, prev + 1, (bp + 1) * node_block - 1, d, col,
                            on, fill);
  fill_rows<V>(out, bs * node_block, hi, d, col, on, fill);
}

// The lanes an agent spreads a row's columns over, V columns a lane: the
// power of two that covers the row, at least 8 (so that a unit has at most
// 32 agents to add up in order) and at most a warp. d = 64 in float4s is
// 16 lanes, two agents a warp.
__host__ __device__ inline int weighted_lanes(int d, int vec) {
  const int need = (d + vec - 1) / vec;
  int lanes = 8;
  while (lanes < need && lanes < 32) lanes *= 2;
  return lanes;
}

// One thread block per unit of unit_slots consecutive slots. The unit's
// slots (key, message row, scale) are staged in shared memory; each agent
// (`lanes` consecutive threads) sums a contiguous sub-run of them with
// kRowBytes / (4 V) message rows loaded ahead, fp64 sums in registers
// flushed at each change of destination: a node that lies wholly inside
// the agent is written to out, the agent's first and last node go to
// shared memory.
// Then one thread a column walks the agents in order and adds up the nodes
// that cross agents; the node that crosses the unit's first boundary
// (head) and the one that crosses its last boundary (tail) go to the
// workspace, ws[2u] and ws[2u + 1], for the combine kernel. Every
// slot-less node is written as a zero row by the agent that holds the
// first slot after it (the agent with the array's last slot takes the
// nodes after it). Columns past one agent's width (lanes * V) run as
// further chunks over the same staged slots. (The rows of node blocks that
// own no tile are the combine kernel's.) kGather: the message row is
// mmap[slot] (K3, K7), else the slot itself (K6, K8). kSoftmax (K3, K6):
// `weight` holds the slots' scores, and a real slot's weight is its
// attention exp(score - mx[n]) / max(den[n], 1e-38) with n its global
// node, the plain version's fp32 expression, computed once as the slot is
// staged; else (K7, K8) `weight` is the slot's scale and mx, den are not
// read.
template <bool kGather, int V, bool kSoftmax = false>
__device__ __forceinline__ void weighted_unit_body(
    const float* __restrict__ weight, const float* __restrict__ msg,
    const int* __restrict__ mmap, const int* __restrict__ local_dst,
    const int* __restrict__ t2b, const float* __restrict__ mx,
    const float* __restrict__ den, float* __restrict__ out,
    double* __restrict__ ws, int d, int n_slots, int num_nodes,
    int node_block, int tile, int unit_slots, int lanes) {
  extern __shared__ double smem_unit[];
  const int agents = kUnitThreads / lanes;
  const int cw = lanes * V;                                 // chunk columns
  double* s_head = smem_unit;                               // [agents][cw]
  double* s_tail = s_head + (size_t)agents * cw;            // [agents][cw]
  int* s_key = reinterpret_cast<int*>(s_tail + (size_t)agents * cw);
  int* s_row = s_key + unit_slots;                          // [unit_slots]
  float* s_w = reinterpret_cast<float*>(s_row + unit_slots);
  int* s_hnode = reinterpret_cast<int*>(s_w + unit_slots);  // [agents]
  int* s_tnode = s_hnode + agents;                          // [agents]

  const int u = blockIdx.x;
  const int u0 = u * unit_slots;
  const int len = min(unit_slots, n_slots - u0);
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    const int i = u0 + j;
    const int k = slot_key(local_dst, t2b, i, tile, node_block);
    const int row = kGather ? mmap[i] : i;
    const bool real = !(k & 1);
    float w = 0.f;
    if (real) {
      w = weight[i];
      if (kSoftmax) {
        const int n = k >> 1;
        w = expf(w - mx[n]) / fmaxf(den[n], 1e-38f);
      }
    }
    s_key[j] = k;
    s_row[j] = real ? row : -1;
    s_w[j] = w;
  }
  const int head = crossing_node(local_dst, t2b, u0, n_slots, tile,
                                 node_block);
  const int tail = crossing_node(local_dst, t2b, u0 + len, n_slots, tile,
                                 node_block);
  const int before =
      u0 > 0 ? slot_key(local_dst, t2b, u0 - 1, tile, node_block) >> 1 : -1;
  __syncthreads();

  const int a = threadIdx.x / lanes;
  const int lane = threadIdx.x - a * lanes;
  const int per = (len + agents - 1) / agents;
  const int a0 = min(a * per, len);
  const int a1 = min(a0 + per, len);
  const bool last = a0 < a1 && a1 == len && u0 + len == n_slots;

  for (int c0 = 0; c0 < d; c0 += cw) {
    const int col = c0 + lane * V;
    const bool on = col < d;
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
    int cur = -1, first = -1;
    int prev = a0 > 0 ? s_key[a0 - 1] >> 1 : before;
    constexpr int kRows = kRowBytes / (4 * V);   // rows loaded ahead
    for (int j0 = a0; j0 < a1; j0 += kRows) {
      float m[kRows][V];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = j0 + r;
        const int row = j < a1 ? s_row[j] : -1;
        if (row >= 0 && on) {
          load_row<V>(msg + (size_t)row * d + col, m[r]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) m[r][v] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = j0 + r;
        if (j >= a1) break;
        const int k = s_key[j];
        const int n = k >> 1;
        if (k & 1) {           // a pad: the nodes after prev up to the last
          fill_gap<V>(out, prev, n, n / node_block, node_block, d, col,
                      on);                   // of its block have no slot
          prev = n;
          continue;
        }
        if (n != cur) {
          if (cur >= 0) {
            if (first < 0) {
              first = cur;
#pragma unroll
              for (int v = 0; v < V; ++v)
                s_head[a * cw + lane * V + v] = acc[v];
            } else if (on) {
              store_row<V>(out + (size_t)cur * d + col, acc);
            }
          }
          fill_gap<V>(out, prev, n - 1, n / node_block, node_block, d, col,
                      on);
          cur = n;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.0;
        }
        prev = n;
        if (s_row[j] >= 0) {
          const double w = s_w[j];
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = fma(w, static_cast<double>(m[r][v]), acc[v]);
        }
      }
    }
    int tnode = -1;
    if (cur >= 0) {
      double* dst = s_head;
      if (first < 0) {
        first = cur;
      } else {
        tnode = cur;
        dst = s_tail;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) dst[a * cw + lane * V + v] = acc[v];
    }
    if (last) {                  // the rest of the last slot's block
      fill_rows<V>(out, prev + 1, (prev / node_block + 1) * node_block - 1,
                   d, col, on);
    }
    if (lane == 0) {
      s_hnode[a] = first;
      s_tnode[a] = tnode;
    }
    __syncthreads();

    // the nodes that cross agents, added in agent order
    const int c = c0 + threadIdx.x;
    if (threadIdx.x < cw && c < d) {
      double sum = 0.0;
      int node = -1;
      auto flush = [&]() {
        if (node == head) {
          ws[(size_t)(2 * u) * d + c] = sum;
        } else if (node == tail) {
          ws[(size_t)(2 * u + 1) * d + c] = sum;
        } else {
          out[(size_t)node * d + c] = static_cast<float>(sum);
        }
      };
      for (int b = 0; b < agents; ++b) {
        const int h = s_hnode[b];
        if (h < 0) continue;
        const double hv = s_head[b * cw + threadIdx.x];
        if (h == node) {
          sum += hv;
        } else {
          if (node >= 0) flush();
          node = h;
          sum = hv;
        }
        const int t = s_tnode[b];
        if (t >= 0) {
          flush();
          node = t;
          sum = s_tail[b * cw + threadIdx.x];
        }
      }
      if (node >= 0) flush();
    }
    __syncthreads();                 // the next chunk reuses shared memory
  }
}

// One block for kCombineWarps units. Each block first fills the node
// blocks that own no tile (zero rows; -1e30 for K2's max): block k takes
// node blocks k, k + gridDim.x, ..., a thread tests one of them, and the
// block fills the rows of those its threads found (node blocks without a
// tile often lie together, so the round robin spreads their rows).
// Then each warp tests one unit (three lanes each load one boundary): does
// a node whose first slot lies in the unit run across its tail boundary?
// Its row is the sum (kMax:
// the max) of its partials in unit order: the unit's tail, then the head of
// every later unit the node reaches. A node that ends in the next unit
// (most of them) is reduced by the warp; for a longer run the whole block
// takes the node after the others: its threads look for the end of the run
// 256 units at a time, the heads are cut into one contiguous run a warp,
// each reduced in order, and the warps' results are added in warp order.
template <bool kMax = false>
__device__ __forceinline__ void weighted_combine_body(
    const int* __restrict__ local_dst, const int* __restrict__ t2b,
    const int* __restrict__ block_tile_ptr, const double* __restrict__ ws,
    float* __restrict__ out, int d, int n_slots, int num_units,
    int num_node_blocks, int node_block, int tile, int unit_slots) {
  __shared__ int s_node[kCombineWarps];
  __shared__ int s_first[kCombineWarps];
  __shared__ double s_sum[kCombineWarps][32 * kCombineCols];
  __shared__ int s_empty[kCombineWarps * 32];
  __shared__ int s_count;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const double ident = kMax ? static_cast<double>(kNegInf) : 0.0;
  auto op = [](double a, double b) { return kMax ? fmax(a, b) : a + b; };
  const int rows = node_block * d;
  for (long long k0 = 0; blockIdx.x + k0 * gridDim.x < num_node_blocks;
       k0 += blockDim.x) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const long long b = blockIdx.x + (k0 + threadIdx.x) * gridDim.x;
    if (b < num_node_blocks && block_tile_ptr[b] == block_tile_ptr[b + 1]) {
      s_empty[atomicAdd(&s_count, 1)] = static_cast<int>(b);  // owns no tile
    }
    __syncthreads();
    for (int e = 0; e < s_count; ++e) {
      float* ob = out + (size_t)s_empty[e] * rows;
      for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        ob[i] = static_cast<float>(ident);
      }
    }
    __syncthreads();
  }
  {
    const int u = blockIdx.x * kCombineWarps + warp;
    // lanes 0, 1, 2: the nodes crossing the unit's tail boundary, its head
    // boundary and the next unit's tail boundary
    int c = -1;
    if (lane < 3 && u < num_units) {
      const int u0 = u * unit_slots;
      c = crossing_node(local_dst, t2b,
                        u0 + (lane == 1 ? 0 : lane == 0 ? 1 : 2) * unit_slots,
                        n_slots, tile, node_block);
    }
    int v = __shfl_sync(0xffffffffu, c, 0);
    const int at_head = __shfl_sync(0xffffffffu, c, 1);
    const int at_next = __shfl_sync(0xffffffffu, c, 2);
    if (v >= 0 && at_head == v) v = -1;  // the node started in an earlier unit
    const bool longer = v >= 0 && at_next == v;
    if (v >= 0 && !longer) {           // the common case: two units
      for (int c = lane; c < d; c += 32) {
        out[(size_t)v * d + c] = static_cast<float>(op(
            ws[(size_t)(2 * u + 1) * d + c], ws[(size_t)(2 * u + 2) * d + c]));
      }
    }
    if (lane == 0) s_node[warp] = longer ? v : -1;
  }
  __syncthreads();
  for (int uw = 0; uw < kCombineWarps; ++uw) {
    const int v = s_node[uw];
    if (v < 0) continue;
    const int u = blockIdx.x * kCombineWarps + uw;
    // the last unit the node reaches: the first one it does not run past
    int end = u + 1;
    for (;;) {
      const int k = end + threadIdx.x;
      const bool runs = k < num_units &&
                        crossing_node(local_dst, t2b, (k + 1) * unit_slots,
                                      n_slots, tile, node_block) == v;
      const unsigned mask = __ballot_sync(0xffffffffu, runs);
      if (lane == 0) {
        s_first[warp] = mask == 0xffffffffu ? 32 : __ffs(~mask) - 1;
      }
      __syncthreads();
      int first = kCombineWarps * 32;
      for (int w = kCombineWarps - 1; w >= 0; --w) {
        if (s_first[w] < 32) first = w * 32 + s_first[w];
      }
      __syncthreads();
      end += first;
      if (first < kCombineWarps * 32) break;
    }
    const int heads = end - u;                  // units u + 1 .. end
    const int per = (heads + kCombineWarps - 1) / kCombineWarps;
    const int k0 = u + 1 + min(warp * per, heads);
    const int k1 = u + 1 + min((warp + 1) * per, heads);
    for (int c0 = 0; c0 < d; c0 += 32 * kCombineCols) {
      double sum[kCombineCols];
#pragma unroll
      for (int j = 0; j < kCombineCols; ++j) sum[j] = ident;
      int k = k0;
      for (; k + kChainLoads <= k1; k += kChainLoads) {
        double p[kChainLoads][kCombineCols];
#pragma unroll
        for (int i = 0; i < kChainLoads; ++i) {
#pragma unroll
          for (int j = 0; j < kCombineCols; ++j) {
            const int c = c0 + lane + 32 * j;
            p[i][j] = c < d ? ws[(size_t)(2 * (k + i)) * d + c] : ident;
          }
        }
#pragma unroll
        for (int i = 0; i < kChainLoads; ++i) {
#pragma unroll
          for (int j = 0; j < kCombineCols; ++j) sum[j] = op(sum[j], p[i][j]);
        }
      }
      for (; k < k1; ++k) {
#pragma unroll
        for (int j = 0; j < kCombineCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < d) sum[j] = op(sum[j], ws[(size_t)(2 * k) * d + c]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCombineCols; ++j) {
        s_sum[warp][lane + 32 * j] = sum[j];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < kCombineCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c >= d) continue;
          double total = ws[(size_t)(2 * u + 1) * d + c];
          for (int w = 0; w < kCombineWarps && w * per < heads; ++w) {
            total = op(total, s_sum[w][lane + 32 * j]);
          }
          out[(size_t)v * d + c] = static_cast<float>(total);
        }
      }
      __syncthreads();
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kUnitThreads)
weighted_agg_gather_unit_kernel(const float* __restrict__ scale,
                                const float* __restrict__ msg,
                                const int* __restrict__ mmap,
                                const int* __restrict__ local_dst,
                                const int* __restrict__ t2b,
                                float* __restrict__ out,
                                double* __restrict__ ws, int d, int n_slots,
                                int num_nodes, int node_block, int tile,
                                int unit_slots, int lanes) {
  weighted_unit_body<true, V>(scale, msg, mmap, local_dst, t2b, nullptr,
                              nullptr, out, ws, d, n_slots, num_nodes,
                              node_block, tile, unit_slots, lanes);
}

template <int V>
__global__ void __launch_bounds__(kUnitThreads)
weighted_agg_padded_unit_kernel(const float* __restrict__ scale,
                                const float* __restrict__ msg_p,
                                const int* __restrict__ local_dst,
                                const int* __restrict__ t2b,
                                float* __restrict__ out,
                                double* __restrict__ ws, int d, int n_slots,
                                int num_nodes, int node_block, int tile,
                                int unit_slots, int lanes) {
  weighted_unit_body<false, V>(scale, msg_p, nullptr, local_dst, t2b,
                               nullptr, nullptr, out, ws, d, n_slots,
                               num_nodes, node_block, tile, unit_slots,
                               lanes);
}

// K3: K7's unit with the softmax weight
template <int V>
__global__ void __launch_bounds__(kUnitThreads)
softmax_agg_gather_unit_kernel(const float* __restrict__ scores,
                               const float* __restrict__ msg,
                               const int* __restrict__ mmap,
                               const int* __restrict__ local_dst,
                               const int* __restrict__ t2b,
                               const float* __restrict__ mx,
                               const float* __restrict__ den,
                               float* __restrict__ out,
                               double* __restrict__ ws, int d, int n_slots,
                               int num_nodes, int node_block, int tile,
                               int unit_slots, int lanes) {
  weighted_unit_body<true, V, true>(scores, msg, mmap, local_dst, t2b, mx,
                                    den, out, ws, d, n_slots, num_nodes,
                                    node_block, tile, unit_slots, lanes);
}

// K6: K3's unit over messages padded into the slots
template <int V>
__global__ void __launch_bounds__(kUnitThreads)
softmax_agg_padded_unit_kernel(const float* __restrict__ scores,
                               const float* __restrict__ msg_p,
                               const int* __restrict__ local_dst,
                               const int* __restrict__ t2b,
                               const float* __restrict__ mx,
                               const float* __restrict__ den,
                               float* __restrict__ out,
                               double* __restrict__ ws, int d, int n_slots,
                               int num_nodes, int node_block, int tile,
                               int unit_slots, int lanes) {
  weighted_unit_body<false, V, true>(scores, msg_p, nullptr, local_dst, t2b,
                                     mx, den, out, ws, d, n_slots, num_nodes,
                                     node_block, tile, unit_slots, lanes);
}

// ---------------------------------------------------------------------------
// K2: the softmax statistics in two passes over the slot split
// ---------------------------------------------------------------------------
constexpr int kStatsWarps = kUnitThreads / 32;   // agents of a K2 unit
constexpr int kNoKey = 0x7fffffff;               // past every slot key

// One pass of K2 over the unit of unit_slots consecutive slots at blockIdx.
// kSum = false, the max pass: a real slot's value is max(score, -1e30) and
// out is mx. kSum = true, the sum pass: a real slot's value is its term
// expf(score - mx[n]) (n its global node, mx from the max pass), widened
// to fp64, and out is den. A pad's value adds nothing.
// Each warp is an agent over a contiguous run of whole 32-slot rounds. In a
// round a lane loads one slot; the warp takes a segmented inclusive scan
// over the key runs by shuffles (the keys never decrease, so a lane
// reduces with the lane `off` below it when their keys are equal), the run
// left open at the round's end carried into the next round's first lane.
// A run that ends inside the agent and is not the agent's first node is
// the node's whole reduction and is written to out (a carried run when the
// next round's first slot starts another); the agent's first and last
// nodes go to shared memory, and one thread then walks the agents in
// order, as weighted_unit_body does: the unit's head and tail nodes to the
// workspace (ws[2u], ws[2u + 1]), the others to out. The lane of a slot
// that starts a key run writes `fill` (-1e30 for mx, 0 for den) to the
// slot-less nodes since the previous slot's node, and the array's last
// slot fills the rest of its block.
template <bool kSum>
__device__ __forceinline__ void stats_unit_body(
    const float* __restrict__ scores, const int* __restrict__ local_dst,
    const int* __restrict__ t2b, const float* __restrict__ mx,
    float* __restrict__ out, double* __restrict__ ws, int n_slots,
    int node_block, int tile, int unit_slots) {
  __shared__ double s_head[kStatsWarps], s_tail[kStatsWarps];
  __shared__ int s_hnode[kStatsWarps], s_tnode[kStatsWarps];
  constexpr unsigned kAll = 0xffffffffu;
  const double ident = kSum ? 0.0 : static_cast<double>(kNegInf);
  const float fill = kSum ? 0.f : kNegInf;
  auto op = [](double a, double b) { return kSum ? a + b : fmax(a, b); };

  const int u = blockIdx.x;
  const int u0 = u * unit_slots;
  const int len = min(unit_slots, n_slots - u0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = ((len + kStatsWarps - 1) / kStatsWarps + 31) & ~31;
  const int a0 = min(warp * per, len);
  const int a1 = min(a0 + per, len);

  // loaded here, used after the rounds: the unit's head and tail nodes
  int head = -1, tail = -1;
  if (threadIdx.x == 0) {
    head = crossing_node(local_dst, t2b, u0, n_slots, tile, node_block);
    tail = crossing_node(local_dst, t2b, u0 + len, n_slots, tile,
                         node_block);
  }
  // the key of the slot before the round's first, and the reduction of
  // its run so far in this agent
  int carry_key = u0 + a0 > 0
      ? slot_key(local_dst, t2b, u0 + a0 - 1, tile, node_block) : -1;
  double carry = ident;
  int first = -1;                        // the agent's first real node
  for (int j0 = a0; j0 < a1; j0 += 32) {
    const int i = u0 + j0 + lane;
    const bool valid = j0 + lane < a1;
    int k = kNoKey;
    double v = ident;
    if (valid) {
      const float s = scores[i];         // loaded beside the key
      k = slot_key(local_dst, t2b, i, tile, node_block);
      if (!(k & 1)) {
        v = kSum ? static_cast<double>(expf(s - mx[k >> 1]))
                 : static_cast<double>(fmaxf(s, kNegInf));
      }
    }
    if (lane == 0 && j0 > a0 && k != carry_key && !(carry_key & 1)) {
      const int n = carry_key >> 1;          // the carried run ended
      if (n == first) {
        s_head[warp] = carry;
      } else {
        out[n] = static_cast<float>(carry);
      }
    }
    const int up = __shfl_up_sync(kAll, k, 1);
    const int prev_key = lane == 0 ? carry_key : up;
    if (valid && k != prev_key) {        // the first slot of its key run
      const int n = k >> 1;
      fill_gap<1>(out, prev_key >> 1, (k & 1) ? n : n - 1, n / node_block,
                  node_block, 1, 0, true, fill);
    }
    if (valid && i == n_slots - 1) {     // the rest of the last slot's block
      const int n = k >> 1;
      fill_rows<1>(out, n + 1, (n / node_block + 1) * node_block - 1, 1, 0,
                   true, fill);
    }
    if (lane == 0 && k == carry_key) v = op(carry, v);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(kAll, v, off);
      const int ok = __shfl_up_sync(kAll, k, off);
      if (lane >= off && ok == k) v = op(o, v);
    }
    const unsigned real = __ballot_sync(kAll, valid && !(k & 1));
    if (first < 0 && real) {
      first = __shfl_sync(kAll, k, __ffs(real) - 1) >> 1;
    }
    const int last = min(31, a1 - 1 - j0);   // the round's last slot
    const int down = __shfl_down_sync(kAll, k, 1);
    if (valid && lane < last && down != k && !(k & 1)) {
      const int n = k >> 1;                  // a run that ends here
      if (n == first) {
        s_head[warp] = v;
      } else {
        out[n] = static_cast<float>(v);
      }
    }
    carry_key = __shfl_sync(kAll, k, last);
    carry = __shfl_sync(kAll, v, last);
  }
  if (lane == 0) {
    int tnode = -1;
    if (a0 < a1 && !(carry_key & 1)) {       // the run open at the end
      if ((carry_key >> 1) == first) {
        s_head[warp] = carry;
      } else {
        tnode = carry_key >> 1;
        s_tail[warp] = carry;
      }
    }
    s_hnode[warp] = first;
    s_tnode[warp] = tnode;
  }
  __syncthreads();

  if (threadIdx.x == 0) {                  // the agents' nodes, in order
    double acc = ident;
    int node = -1;
    auto flush = [&]() {
      if (node == head) {
        ws[2 * u] = acc;
      } else if (node == tail) {
        ws[2 * u + 1] = acc;
      } else {
        out[node] = static_cast<float>(acc);
      }
    };
    for (int b = 0; b < kStatsWarps; ++b) {
      const int h = s_hnode[b];
      if (h < 0) continue;
      if (h == node) {
        acc = op(acc, s_head[b]);
      } else {
        if (node >= 0) flush();
        node = h;
        acc = s_head[b];
      }
      const int t = s_tnode[b];
      if (t >= 0) {
        flush();
        node = t;
        acc = s_tail[b];
      }
    }
    if (node >= 0) flush();
  }
}

__global__ void __launch_bounds__(kUnitThreads)
stats_max_unit_kernel(const float* __restrict__ scores,
                      const int* __restrict__ local_dst,
                      const int* __restrict__ t2b, float* __restrict__ mx,
                      double* __restrict__ ws, int n_slots, int node_block,
                      int tile, int unit_slots) {
  stats_unit_body<false>(scores, local_dst, t2b, nullptr, mx, ws, n_slots,
                         node_block, tile, unit_slots);
}

__global__ void __launch_bounds__(kUnitThreads)
stats_sum_unit_kernel(const float* __restrict__ scores,
                      const int* __restrict__ local_dst,
                      const int* __restrict__ t2b,
                      const float* __restrict__ mx, float* __restrict__ den,
                      double* __restrict__ ws, int n_slots, int node_block,
                      int tile, int unit_slots) {
  stats_unit_body<true>(scores, local_dst, t2b, mx, den, ws, n_slots,
                        node_block, tile, unit_slots);
}

// The combine launches: one body, instantiated once per kernel so that a
// profile names each kernel's combine after it (the tag's name shows in
// the kernel's name); K2's max pass takes the max of the partials.
struct softmax_agg_gather_combine {};
struct softmax_agg_padded_combine {};
struct weighted_agg_gather_combine {};
struct weighted_agg_padded_combine {};
struct stats_max_combine {};
struct stats_sum_combine {};

template <typename Name, bool kMax = false>
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_kernel(const int* __restrict__ local_dst, const int* __restrict__ t2b,
               const int* __restrict__ block_tile_ptr,
               const double* __restrict__ ws, float* __restrict__ out, int d,
               int n_slots, int num_units, int num_node_blocks,
               int node_block, int tile, int unit_slots) {
  weighted_combine_body<kMax>(local_dst, t2b, block_tile_ptr, ws, out, d,
                              n_slots, num_units, num_node_blocks,
                              node_block, tile, unit_slots);
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2. scores, local_dst [T * tile]; t2b [>= T]; block_tile_ptr
// [num_node_blocks + 1]; mx, den [num_node_blocks * node_block]; ws
// 2 * ceil(T / chunk_tiles) doubles, which both passes use in turn. Four
// launches on one stream: the max pass's units and combine, then the sum
// pass's.
extern "C" int seg_stats_f32(const float* scores, const int* local_dst,
                             const int* t2b, const int* block_tile_ptr,
                             float* mx, float* den, double* ws,
                             int num_tiles, int num_node_blocks,
                             int node_block, int tile, int chunk_tiles,
                             void* stream) {
  if (num_tiles <= 0 || num_node_blocks <= 0 || node_block <= 0 ||
      tile <= 0 || chunk_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slots = num_tiles * tile;
  const int unit_slots = chunk_tiles * tile;
  const int units = (num_tiles + chunk_tiles - 1) / chunk_tiles;
  const int combine_blocks = (units + kCombineWarps - 1) / kCombineWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_max_unit_kernel<<<units, kUnitThreads, 0, s>>>(
      scores, local_dst, t2b, mx, ws, n_slots, node_block, tile, unit_slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<stats_max_combine, true>
      <<<combine_blocks, kCombineWarps * 32, 0, s>>>(
          local_dst, t2b, block_tile_ptr, ws, mx, 1, n_slots, units,
          num_node_blocks, node_block, tile, unit_slots);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_sum_unit_kernel<<<units, kUnitThreads, 0, s>>>(
      scores, local_dst, t2b, mx, den, ws, n_slots, node_block, tile,
      unit_slots);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<stats_sum_combine>
      <<<combine_blocks, kCombineWarps * 32, 0, s>>>(
          local_dst, t2b, block_tile_ptr, ws, den, 1, n_slots, units,
          num_node_blocks, node_block, tile, unit_slots);
  return static_cast<int>(cudaGetLastError());
}

// K3's, K6's, K7's and K8's dynamic shared memory, whatever node_block: the
// agents' first- and last-node partials (two fp64 rows of lanes * vec
// columns an agent), the unit's staged slots (key, row, weight) and the
// agents' two node ids.
extern "C" long long seg_weighted_agg_smem_bytes(int d, int tile,
                                                 int chunk_tiles, int vec) {
  const int lanes = weighted_lanes(d, vec);
  const int agents = kUnitThreads / lanes;
  return 2LL * agents * lanes * vec * (long long)sizeof(double) +
         (long long)chunk_tiles * tile * (2 * sizeof(int) + sizeof(float)) +
         2LL * agents * (long long)sizeof(int);
}

template <typename Kernel, typename... Args>
cudaError_t launch_unit(Kernel* kernel, int units, long long smem,
                        cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<units, kUnitThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// Launch K3 (kGather, kSoftmax), K6 (kSoftmax), K7 (kGather) or K8: the
// unit kernel over ceil(num_tiles / chunk_tiles) units, then the combine
// kernel, one block for kCombineWarps units, on the same stream. ws holds
// 2 * units * d doubles: a head and a tail partial row a unit. vec (1, 2
// or 4) divides d, and msg is aligned to vec floats. mx, den: K3's and
// K6's node statistics.
template <bool kGather, bool kSoftmax>
int launch_weighted(const float* weight, const float* msg, const int* mmap,
                    const int* local_dst, const int* t2b,
                    const int* block_tile_ptr, const float* mx,
                    const float* den, float* out, double* ws, int d,
                    int num_tiles, int num_node_blocks, int node_block,
                    int tile, int chunk_tiles, int vec, void* stream) {
  if (num_tiles <= 0 || num_node_blocks <= 0 || node_block <= 0 || d <= 0 ||
      tile <= 0 || chunk_tiles <= 0 || d % vec != 0 ||
      (vec != 1 && vec != 2 && vec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slots = num_tiles * tile;
  const int unit_slots = chunk_tiles * tile;
  const int units = (num_tiles + chunk_tiles - 1) / chunk_tiles;
  const int num_nodes = num_node_blocks * node_block;
  const int lanes = weighted_lanes(d, vec);
  const long long smem = seg_weighted_agg_smem_bytes(d, tile, chunk_tiles,
                                                     vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (kSoftmax && kGather) {
    auto* kernel = vec == 4   ? softmax_agg_gather_unit_kernel<4>
                   : vec == 2 ? softmax_agg_gather_unit_kernel<2>
                              : softmax_agg_gather_unit_kernel<1>;
    e = launch_unit(kernel, units, smem, s, weight, msg, mmap, local_dst,
                    t2b, mx, den, out, ws, d, n_slots, num_nodes, node_block,
                    tile, unit_slots, lanes);
  } else if constexpr (kSoftmax) {
    auto* kernel = vec == 4   ? softmax_agg_padded_unit_kernel<4>
                   : vec == 2 ? softmax_agg_padded_unit_kernel<2>
                              : softmax_agg_padded_unit_kernel<1>;
    e = launch_unit(kernel, units, smem, s, weight, msg, local_dst, t2b, mx,
                    den, out, ws, d, n_slots, num_nodes, node_block, tile,
                    unit_slots, lanes);
  } else if constexpr (kGather) {
    auto* kernel = vec == 4   ? weighted_agg_gather_unit_kernel<4>
                   : vec == 2 ? weighted_agg_gather_unit_kernel<2>
                              : weighted_agg_gather_unit_kernel<1>;
    e = launch_unit(kernel, units, smem, s, weight, msg, mmap, local_dst,
                    t2b, out, ws, d, n_slots, num_nodes, node_block, tile,
                    unit_slots, lanes);
  } else {
    auto* kernel = vec == 4   ? weighted_agg_padded_unit_kernel<4>
                   : vec == 2 ? weighted_agg_padded_unit_kernel<2>
                              : weighted_agg_padded_unit_kernel<1>;
    e = launch_unit(kernel, units, smem, s, weight, msg, local_dst, t2b, out,
                    ws, d, n_slots, num_nodes, node_block, tile, unit_slots,
                    lanes);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int combine_blocks = (units + kCombineWarps - 1) / kCombineWarps;
  auto* combine =
      kSoftmax ? (kGather ? combine_kernel<softmax_agg_gather_combine>
                          : combine_kernel<softmax_agg_padded_combine>)
               : (kGather ? combine_kernel<weighted_agg_gather_combine>
                          : combine_kernel<weighted_agg_padded_combine>);
  combine<<<combine_blocks, kCombineWarps * 32, 0, s>>>(
      local_dst, t2b, block_tile_ptr, ws, out, d, n_slots, units,
      num_node_blocks, node_block, tile, unit_slots);
  return static_cast<int>(cudaGetLastError());
}

// K3. scores (pad slots -1e30), mmap, local_dst [T * tile]; t2b [>= T];
// block_tile_ptr [num_node_blocks + 1]; mx, den
// [num_node_blocks * node_block] from seg_stats_f32; msg [em, d];
// out [num_node_blocks * node_block, d]; ws as above.
extern "C" int seg_softmax_agg_gather_f32(
    const float* scores, const float* msg, const int* mmap,
    const int* local_dst, const int* t2b, const int* block_tile_ptr,
    const float* mx, const float* den, float* out, double* ws, int d,
    int num_tiles, int num_node_blocks, int node_block, int tile,
    int chunk_tiles, int vec, void* stream) {
  return launch_weighted<true, true>(scores, msg, mmap, local_dst, t2b,
                                     block_tile_ptr, mx, den, out, ws, d,
                                     num_tiles, num_node_blocks, node_block,
                                     tile, chunk_tiles, vec, stream);
}

// K6. scores (pad slots -1e30), local_dst [T * tile]; t2b [>= T];
// block_tile_ptr [num_node_blocks + 1]; msg_p [T * tile, d] (the messages
// padded into the slots); mx, den from seg_stats_f32;
// out [num_node_blocks * node_block, d]; ws as above.
extern "C" int seg_softmax_agg_padded_f32(
    const float* scores, const float* msg_p, const int* local_dst,
    const int* t2b, const int* block_tile_ptr, const float* mx,
    const float* den, float* out, double* ws, int d, int num_tiles,
    int num_node_blocks, int node_block, int tile, int chunk_tiles, int vec,
    void* stream) {
  return launch_weighted<false, true>(scores, msg_p, nullptr, local_dst, t2b,
                                      block_tile_ptr, mx, den, out, ws, d,
                                      num_tiles, num_node_blocks, node_block,
                                      tile, chunk_tiles, vec, stream);
}

// K7. scale_p (pad slots 0), mmap, local_dst [T * tile]; t2b [>= T];
// block_tile_ptr [num_node_blocks + 1]; msg [em, d];
// out [num_node_blocks * node_block, d]; ws as above.
extern "C" int seg_weighted_agg_gather_f32(
    const float* scale, const float* msg, const int* mmap,
    const int* local_dst, const int* t2b, const int* block_tile_ptr,
    float* out, double* ws, int d, int num_tiles, int num_node_blocks,
    int node_block, int tile, int chunk_tiles, int vec, void* stream) {
  return launch_weighted<true, false>(scale, msg, mmap, local_dst, t2b,
                                      block_tile_ptr, nullptr, nullptr, out,
                                      ws, d, num_tiles, num_node_blocks,
                                      node_block, tile, chunk_tiles, vec,
                                      stream);
}

// K8. scale_p (pad slots 0), local_dst [T * tile]; t2b [>= T];
// block_tile_ptr [num_node_blocks + 1]; msg_p [T * tile, d];
// out [num_node_blocks * node_block, d]; ws as above.
extern "C" int seg_weighted_agg_padded_f32(
    const float* scale, const float* msg_p, const int* local_dst,
    const int* t2b, const int* block_tile_ptr, float* out, double* ws, int d,
    int num_tiles, int num_node_blocks, int node_block, int tile,
    int chunk_tiles, int vec, void* stream) {
  return launch_weighted<false, false>(scale, msg_p, nullptr, local_dst, t2b,
                                       block_tile_ptr, nullptr, nullptr, out,
                                       ws, d, num_tiles, num_node_blocks,
                                       node_block, tile, chunk_tiles, vec,
                                       stream);
}
