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
// order, and nothing carries over between them.
//
// K2 and K6: one thread block owns one node block and walks that block's
// contiguous tile range [block_tile_ptr[b], block_tile_ptr[b+1]) (derived
// from the non-decreasing tile -> block map when the layout is built) with
// a loop in place of the sequential grid. Each tile's slots are staged in
// shared memory. K2 gives every destination node of the block to one
// thread, which takes the exact max in a first pass over the slots and the
// sum of exponentials in a second. K6 (agg_body; the message of slot i at
// row i): each staged slot gets its attention from the score and K2's
// stats, then every (node, column) accumulator in shared memory is owned
// by exactly one thread, which adds the slots of its node in slot order.
// Such a walk takes as long as the largest node block's tile range, and
// those are skewed: a hub (bgs: in-degree 22,949), bucketing's pad node,
// and the pure-pad tiles bucketing appends to the last node block.
//
// K3, K7 and K8 split by slots instead (weighted_unit_body, then
// weighted_combine_body). The grid is ceil(T / chunk_tiles) units of
// chunk_tiles consecutive tiles, from the shapes alone. The layouts keep
// every slot's sort key (slot_key) non-decreasing, so a node's real slots
// form one run and a unit finds its nodes from its own slots and the two
// slots at its edges. Each slot's weight is staged with it: K7's and K8's
// scale, or K3's attention exp(s - mx[v]) / max(den[v], 1e-38) from K2's
// statistics of the slot's node. Inside a unit, agents of 8-32 threads take
// contiguous sub-runs of slots, lanes spread over a row's columns in
// vector loads, several rows in flight, fp64 sums in registers; the
// agents' boundary nodes are added in agent order in shared memory. A
// node whose slots all lie in one unit is written by that unit; a node
// that crosses a unit edge leaves one fp64 partial in each unit it
// touches (a unit's head and tail, in a workspace of 2 * units * d
// doubles), and the combine kernel, launched after it on the same stream,
// adds them in unit order and writes the row. Shared memory grows with
// chunk_tiles * tile, never with node_block. No float atomics: all three
// are deterministic, bit for bit from launch to launch.
//
// Node blocks that own no tile are written too (mx = -1e30, den = 0,
// out = 0), which the TPU kernels never visit; so is every slot-less node.
// Pad slots (local_dst == node_block) add nothing, as the TPU kernels'
// zero scale for them does.
//
// Inputs and outputs are fp32; den and out accumulate in fp64. Bucketing
// routes every pad edge to one pad node, which then sums tens of thousands
// of slots (about 97K at 1024 seeds on bgs): a sequential fp32 sum of that
// length drifts by about 1e-5 of its value, an fp64 one stays within the
// final fp32 rounding. FP64 adds cost nothing here beside the slot walk.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kAggThreads = 256;

__global__ void seg_stats_kernel(const float* __restrict__ scores,
                                 const int* __restrict__ local_dst,
                                 const int* __restrict__ block_tile_ptr,
                                 float* __restrict__ mx,
                                 float* __restrict__ den, int node_block,
                                 int tile) {
  extern __shared__ float smem[];
  float* s_score = smem;                                  // [tile]
  int* s_dst = reinterpret_cast<int*>(smem + tile);       // [tile]
  const int b = blockIdx.x;
  const int t0 = block_tile_ptr[b];
  const int t1 = block_tile_ptr[b + 1];
  const int j = threadIdx.x;

  float m = kNegInf;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      s_score[i] = scores[(size_t)t * tile + i];
      s_dst[i] = local_dst[(size_t)t * tile + i];
    }
    __syncthreads();
    if (j < node_block) {
      for (int i = 0; i < tile; ++i) {
        if (s_dst[i] == j) m = fmaxf(m, s_score[i]);
      }
    }
  }
  double d = 0.0;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      s_score[i] = scores[(size_t)t * tile + i];
      s_dst[i] = local_dst[(size_t)t * tile + i];
    }
    __syncthreads();
    if (j < node_block) {
      for (int i = 0; i < tile; ++i) {
        if (s_dst[i] == j) d += static_cast<double>(expf(s_score[i] - m));
      }
    }
  }
  if (j < node_block) {
    mx[(size_t)b * node_block + j] = m;
    den[(size_t)b * node_block + j] = static_cast<float>(d);
  }
}

// One thread block per node block: stage each tile's (weight, message row,
// destination), then every (node, column) accumulator has one owning
// thread that adds in slot order. kSoftmax: the weight is the attention
// exp(score - mx[v]) / max(den[v], 1e-38) (K6); else the slot's scale
// (which no kernel takes now: K7 and K8 run weighted_unit_body). kGather:
// the message row is mmap[slot] (no kernel now: K3 runs
// weighted_unit_body); else the slot (K6, whose messages are padded into
// the slots).
template <bool kSoftmax, bool kGather>
__device__ __forceinline__ void agg_body(
    const float* __restrict__ weight, const float* __restrict__ msg,
    const int* __restrict__ mmap, const int* __restrict__ local_dst,
    const int* __restrict__ block_tile_ptr, const float* __restrict__ mx,
    const float* __restrict__ den, float* __restrict__ out, int d,
    int node_block, int tile, int groups, int colw) {
  extern __shared__ double smem_acc[];
  double* acc = smem_acc;                                     // [NB][d]
  float* s_att =
      reinterpret_cast<float*>(acc + (size_t)node_block * d); // [tile]
  int* s_row = reinterpret_cast<int*>(s_att + tile);          // [tile]
  int* s_dst = s_row + tile;                                  // [tile]
  const int b = blockIdx.x;
  const int t0 = block_tile_ptr[b];
  const int t1 = block_tile_ptr[b + 1];
  const int g = threadIdx.x / colw;
  const int cx = threadIdx.x - g * colw;

  for (int i = threadIdx.x; i < node_block * d; i += blockDim.x) acc[i] = 0.0;
  for (int t = t0; t < t1; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const size_t slot = (size_t)t * tile + i;
      const int v = local_dst[slot];
      float a = 0.f;
      int row = -1;
      if (v < node_block) {
        if (kSoftmax) {
          const size_t nv = (size_t)b * node_block + v;
          a = expf(weight[slot] - mx[nv]) / fmaxf(den[nv], 1e-38f);
        } else {
          a = weight[slot];
        }
        row = kGather ? mmap[slot] : static_cast<int>(slot);
      }
      s_att[i] = a;
      s_row[i] = row;
      s_dst[i] = v;
    }
    __syncthreads();
    if (g < groups) {
      for (int i = 0; i < tile; ++i) {
        const int row = s_row[i];
        const int v = s_dst[i];
        if (row < 0 || v % groups != g) continue;
        const double a = s_att[i];
        const float* mr = msg + (size_t)row * d;
        double* av = acc + (size_t)v * d;
        for (int c = cx; c < d; c += colw) av[c] = fma(a, (double)mr[c], av[c]);
      }
    }
  }
  __syncthreads();
  float* ob = out + (size_t)b * node_block * d;
  for (int i = threadIdx.x; i < node_block * d; i += blockDim.x) {
    ob[i] = static_cast<float>(acc[i]);
  }
}

__global__ void __launch_bounds__(kAggThreads)
seg_softmax_agg_padded_kernel(const float* __restrict__ scores,
                              const float* __restrict__ msg_p,
                              const int* __restrict__ local_dst,
                              const int* __restrict__ block_tile_ptr,
                              const float* __restrict__ mx,
                              const float* __restrict__ den,
                              float* __restrict__ out, int d, int node_block,
                              int tile, int groups, int colw) {
  agg_body<true, false>(scores, msg_p, nullptr, local_dst, block_tile_ptr, mx,
                        den, out, d, node_block, tile, groups, colw);
}

// ---------------------------------------------------------------------------
// K7 and K8: slot-split weighted aggregation with a fixed-order combine
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

// Zero rows lo..hi (inclusive) in the V columns at col.
template <int V>
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int lo,
                                          int hi, int d, int col, bool on) {
  if (!on) return;
  for (int n = lo; n <= hi; ++n) {
    float* p = out + (size_t)n * d + col;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(0.f, 0.f);
    } else {
      p[0] = 0.f;
    }
  }
}

// Zero the slot-less nodes prev+1 .. hi before a slot of node block bs
// (prev: the node of the slot before it, -1 before the first slot) that
// lie in prev's block or in bs. The node blocks strictly between own no
// tile: the combine kernel zeroes those, so a long run of them costs no
// agent a serial loop.
template <int V>
__device__ __forceinline__ void zero_gap(float* __restrict__ out, int prev,
                                         int hi, int bs, int node_block,
                                         int d, int col, bool on) {
  if (hi <= prev) return;
  const int bp = prev >= 0 ? prev / node_block : -1;
  if (bp == bs) {
    zero_rows<V>(out, prev + 1, hi, d, col, on);
    return;
  }
  if (bp >= 0) zero_rows<V>(out, prev + 1, (bp + 1) * node_block - 1, d, col,
                            on);
  zero_rows<V>(out, bs * node_block, hi, d, col, on);
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
// mmap[slot] (K3, K7), else the slot itself (K8). kSoftmax (K3): `weight`
// holds the slots' scores, and a real slot's weight is its attention
// exp(score - mx[n]) / max(den[n], 1e-38) with n its global node, the
// fp32 expression of agg_body, computed once as the slot is staged; else
// (K7, K8) `weight` is the slot's scale and mx, den are not read.
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
          zero_gap<V>(out, prev, n, n / node_block, node_block, d, col,
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
          zero_gap<V>(out, prev, n - 1, n / node_block, node_block, d, col,
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
      zero_rows<V>(out, prev + 1, (prev / node_block + 1) * node_block - 1,
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

// One block for kCombineWarps units. Each block first zeroes the node
// blocks that own no tile, a share of them in turn. Then each warp tests
// one unit: does a node whose first slot lies in the unit run across its
// tail boundary? Its row is the sum of its partials in unit order: the
// unit's tail, then the head of every later unit the node reaches. A node
// that ends in the next unit (most of them) is summed by the warp; for a
// longer run the whole block takes the node after the others: its threads
// look for the end of the run 256 units at a time, the heads are cut into
// one contiguous run a warp, each summed in order, and the warps' sums are
// added in warp order.
__device__ __forceinline__ void weighted_combine_body(
    const int* __restrict__ local_dst, const int* __restrict__ t2b,
    const int* __restrict__ block_tile_ptr, const double* __restrict__ ws,
    float* __restrict__ out, int d, int n_slots, int num_units,
    int num_node_blocks, int node_block, int tile, int unit_slots) {
  __shared__ int s_node[kCombineWarps];
  __shared__ int s_first[kCombineWarps];
  __shared__ double s_sum[kCombineWarps][32 * kCombineCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.x; b < num_node_blocks; b += gridDim.x) {
    if (block_tile_ptr[b] == block_tile_ptr[b + 1]) {    // owns no tile
      float* ob = out + (size_t)b * node_block * d;
      for (int i = threadIdx.x; i < node_block * d; i += blockDim.x) {
        ob[i] = 0.f;
      }
    }
  }
  {
    const int u = blockIdx.x * kCombineWarps + warp;
    int v = -1;
    bool longer = false;
    if (lane == 0 && u < num_units) {
      const int u0 = u * unit_slots;
      v = crossing_node(local_dst, t2b, u0 + unit_slots, n_slots, tile,
                        node_block);
      if (v >= 0 &&
          crossing_node(local_dst, t2b, u0, n_slots, tile, node_block) == v) {
        v = -1;                        // the node started in an earlier unit
      }
      longer = v >= 0 && crossing_node(local_dst, t2b, u0 + 2 * unit_slots,
                                       n_slots, tile, node_block) == v;
    }
    v = __shfl_sync(0xffffffffu, v, 0);
    longer = __shfl_sync(0xffffffffu, longer, 0);
    if (v >= 0 && !longer) {           // the common case: two units
      for (int c = lane; c < d; c += 32) {
        out[(size_t)v * d + c] = static_cast<float>(
            ws[(size_t)(2 * u + 1) * d + c] + ws[(size_t)(2 * u + 2) * d + c]);
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
      for (int j = 0; j < kCombineCols; ++j) sum[j] = 0.0;
      int k = k0;
      for (; k + kChainLoads <= k1; k += kChainLoads) {
        double p[kChainLoads][kCombineCols];
#pragma unroll
        for (int i = 0; i < kChainLoads; ++i) {
#pragma unroll
          for (int j = 0; j < kCombineCols; ++j) {
            const int c = c0 + lane + 32 * j;
            p[i][j] = c < d ? ws[(size_t)(2 * (k + i)) * d + c] : 0.0;
          }
        }
#pragma unroll
        for (int i = 0; i < kChainLoads; ++i) {
#pragma unroll
          for (int j = 0; j < kCombineCols; ++j) sum[j] += p[i][j];
        }
      }
      for (; k < k1; ++k) {
#pragma unroll
        for (int j = 0; j < kCombineCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < d) sum[j] += ws[(size_t)(2 * k) * d + c];
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
            total += s_sum[w][lane + 32 * j];
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

// The combine launch of K3, K7 and K8: one body, instantiated once per
// kernel so that a profile names each kernel's combine after it (the tag's
// name shows in the kernel's name).
struct softmax_agg_gather_combine {};
struct weighted_agg_gather_combine {};
struct weighted_agg_padded_combine {};

template <typename Name>
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_kernel(const int* __restrict__ local_dst, const int* __restrict__ t2b,
               const int* __restrict__ block_tile_ptr,
               const double* __restrict__ ws, float* __restrict__ out, int d,
               int n_slots, int num_units, int num_node_blocks,
               int node_block, int tile, int unit_slots) {
  weighted_combine_body(local_dst, t2b, block_tile_ptr, ws, out, d, n_slots,
                        num_units, num_node_blocks, node_block, tile,
                        unit_slots);
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

extern "C" long long seg_stats_smem_bytes(int tile) {
  return (long long)tile * (sizeof(float) + sizeof(int));
}

// K6's dynamic shared memory: the fp64 accumulators and one tile's staged
// slots.
extern "C" long long seg_agg_smem_bytes(int d, int node_block, int tile) {
  return (long long)node_block * d * sizeof(double) +
         (long long)tile * (sizeof(float) + 2 * sizeof(int));
}

// scores, local_dst [T * tile]; block_tile_ptr [num_node_blocks + 1];
// mx, den [num_node_blocks * node_block]. node_block <= 1024.
extern "C" int seg_stats_f32(const float* scores, const int* local_dst,
                             const int* block_tile_ptr, float* mx, float* den,
                             int num_node_blocks, int node_block, int tile,
                             void* stream) {
  if (num_node_blocks <= 0 || node_block <= 0 || node_block > 1024 ||
      tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = seg_stats_smem_bytes(tile);
  cudaError_t e = allow_smem(seg_stats_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = (node_block + 31) / 32 * 32;
  seg_stats_kernel<<<num_node_blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      scores, local_dst, block_tile_ptr, mx, den, node_block, tile);
  return static_cast<int>(cudaGetLastError());
}

// Launch K6 with one thread block per node block: colw
// consecutive threads cover a row's columns, `groups` such groups take the
// block's nodes in turn. `args` are the kernel's pointer arguments.
template <typename Kernel, typename... Args>
int launch_agg(Kernel* kernel, int d, int num_node_blocks, int node_block,
               int tile, void* stream, Args... args) {
  if (num_node_blocks <= 0 || node_block <= 0 || d <= 0 || tile <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int colw = d < kAggThreads ? d : kAggThreads;
  int groups = kAggThreads / colw;
  if (groups > node_block) groups = node_block;
  const long long smem = seg_agg_smem_bytes(d, node_block, tile);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<num_node_blocks, colw * groups, smem,
           static_cast<cudaStream_t>(stream)>>>(args..., d, node_block, tile,
                                                groups, colw);
  return static_cast<int>(cudaGetLastError());
}

// K6. scores, local_dst [T * tile]; msg_p [T * tile, d] (the messages
// padded into the slots); mx, den from seg_stats_f32;
// out [num_node_blocks * node_block, d].
extern "C" int seg_softmax_agg_padded_f32(
    const float* scores, const float* msg_p, const int* local_dst,
    const int* block_tile_ptr, const float* mx, const float* den, float* out,
    int d, int num_node_blocks, int node_block, int tile, void* stream) {
  return launch_agg(seg_softmax_agg_padded_kernel, d, num_node_blocks,
                    node_block, tile, stream, scores, msg_p, local_dst,
                    block_tile_ptr, mx, den, out);
}

// K3's, K7's and K8's dynamic shared memory, whatever node_block: the
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

// Launch K3 (kSoftmax), K7 (kGather) or K8: the unit kernel over
// ceil(num_tiles / chunk_tiles) units, then the combine kernel, one block
// for kCombineWarps units, on the same stream. ws holds 2 * units * d
// doubles: a head and a tail partial row a unit. vec (1, 2 or 4) divides
// d, and msg is aligned to vec floats. mx, den: K3's node statistics.
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
  if constexpr (kSoftmax) {
    auto* kernel = vec == 4   ? softmax_agg_gather_unit_kernel<4>
                   : vec == 2 ? softmax_agg_gather_unit_kernel<2>
                              : softmax_agg_gather_unit_kernel<1>;
    e = launch_unit(kernel, units, smem, s, weight, msg, mmap, local_dst,
                    t2b, mx, den, out, ws, d, n_slots, num_nodes, node_block,
                    tile, unit_slots, lanes);
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
  auto* combine = kSoftmax  ? combine_kernel<softmax_agg_gather_combine>
                  : kGather ? combine_kernel<weighted_agg_gather_combine>
                            : combine_kernel<weighted_agg_padded_combine>;
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
