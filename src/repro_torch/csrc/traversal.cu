// K2, K3 and K7: the aggregations of the traversal template (Hector
// Algorithm 2) over the blocked destination CSR.
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
// Design: the TPU kernels run their grid in order and accumulate a node
// block's consecutive edge tiles into one VMEM output block, scattering with
// a one-hot [node_block x tile] matmul. Here blocks run in parallel, so one
// thread block owns one node block and walks that block's contiguous tile
// range [block_tile_ptr[b], block_tile_ptr[b+1]) (derived from the
// non-decreasing tile -> block map when the layout is built) with a loop
// in place of the sequential grid. Each tile's slots are staged in shared
// memory. K2 gives every destination node of the block to one thread,
// which takes the exact max in a first pass over the slots and the sum of
// exponentials in a second. K3, K6, K7 and K8 share one body (agg_body;
// K6 and K8 read the message of slot i at row i instead of mmap[i]):
// each staged slot gets its weight (K3: the attention from the score and
// K2's stats; K7: the slot's scale), then every (node, column)
// accumulator in shared memory is owned by exactly one thread, which adds
// the slots of its node in slot order; the message rows are gathered from
// global memory by index (-1 contributes nothing), coalesced along the
// columns. No float atomics: the results are deterministic. Node blocks
// that own no tile are written too (mx = -1e30, den = 0, out = 0), which
// the TPU kernels never visit. Pad slots (local_dst == node_block) add
// nothing, as the TPU kernels' zero scale for them does.
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
// exp(score - mx[v]) / max(den[v], 1e-38) (K3, K6); else the slot's scale
// (K7, K8). kGather: the message row is mmap[slot] (K3, K7); else the slot
// (K6, K8, whose messages are padded into the slots).
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
seg_softmax_agg_gather_kernel(const float* __restrict__ scores,
                              const float* __restrict__ msg,
                              const int* __restrict__ mmap,
                              const int* __restrict__ local_dst,
                              const int* __restrict__ block_tile_ptr,
                              const float* __restrict__ mx,
                              const float* __restrict__ den,
                              float* __restrict__ out, int d, int node_block,
                              int tile, int groups, int colw) {
  agg_body<true, true>(scores, msg, mmap, local_dst, block_tile_ptr, mx, den,
                       out, d, node_block, tile, groups, colw);
}

__global__ void __launch_bounds__(kAggThreads)
seg_weighted_agg_gather_kernel(const float* __restrict__ scale,
                               const float* __restrict__ msg,
                               const int* __restrict__ mmap,
                               const int* __restrict__ local_dst,
                               const int* __restrict__ block_tile_ptr,
                               float* __restrict__ out, int d, int node_block,
                               int tile, int groups, int colw) {
  agg_body<false, true>(scale, msg, mmap, local_dst, block_tile_ptr, nullptr,
                        nullptr, out, d, node_block, tile, groups, colw);
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

__global__ void __launch_bounds__(kAggThreads)
seg_weighted_agg_padded_kernel(const float* __restrict__ scale,
                               const float* __restrict__ msg_p,
                               const int* __restrict__ local_dst,
                               const int* __restrict__ block_tile_ptr,
                               float* __restrict__ out, int d, int node_block,
                               int tile, int groups, int colw) {
  agg_body<false, false>(scale, msg_p, nullptr, local_dst, block_tile_ptr,
                         nullptr, nullptr, out, d, node_block, tile, groups,
                         colw);
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

// K3's, K6's, K7's and K8's dynamic shared memory: the fp64 accumulators
// and one tile's staged slots.
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

// Launch K3, K6, K7 or K8 with one thread block per node block: colw
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

// msg [em, d]; mmap, scores, local_dst [T * tile]; mx, den from
// seg_stats_f32; out [num_node_blocks * node_block, d].
extern "C" int seg_softmax_agg_gather_f32(
    const float* scores, const float* msg, const int* mmap,
    const int* local_dst, const int* block_tile_ptr, const float* mx,
    const float* den, float* out, int d, int num_node_blocks, int node_block,
    int tile, void* stream) {
  return launch_agg(seg_softmax_agg_gather_kernel, d, num_node_blocks,
                    node_block, tile, stream, scores, msg, mmap, local_dst,
                    block_tile_ptr, mx, den, out);
}

// scale_p (pad slots 0), mmap, local_dst [T * tile]; msg [em, d];
// out [num_node_blocks * node_block, d].
extern "C" int seg_weighted_agg_gather_f32(
    const float* scale, const float* msg, const int* mmap,
    const int* local_dst, const int* block_tile_ptr, float* out, int d,
    int num_node_blocks, int node_block, int tile, void* stream) {
  return launch_agg(seg_weighted_agg_gather_kernel, d, num_node_blocks,
                    node_block, tile, stream, scale, msg, mmap, local_dst,
                    block_tile_ptr, out);
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

// K8. scale_p (pad slots 0), local_dst [T * tile]; msg_p [T * tile, d];
// out [num_node_blocks * node_block, d].
extern "C" int seg_weighted_agg_padded_f32(
    const float* scale, const float* msg_p, const int* local_dst,
    const int* block_tile_ptr, float* out, int d, int num_node_blocks,
    int node_block, int tile, void* stream) {
  return launch_agg(seg_weighted_agg_padded_kernel, d, num_node_blocks,
                    node_block, tile, stream, scale, msg_p, local_dst,
                    block_tile_ptr, out);
}
