// K10, flash_attention_fwd — grouped-query attention for the LM's prefill
// and decode:
//     out[b, i, h] = softmax_j(mask(cap(q[b, i, h] . k[b, j, h/g] / sqrt(hd))))
//                    @ v[b, :, h/g]
//   with q [B, Sq, H, hd], k and v [B, Sk, KV, hd] (g = H / KV), query i at
//   position q_offset + i, key j at position j; mask: j <= q_pos (causal),
//   j > q_pos - window (window > 0); cap(s) = softcap * tanh(s / softcap)
//   (softcap > 0). fp32 or bf16 in (all three alike), fp32 arithmetic
//   throughout (IEEE FMAs, no TF32 or tensor cores), out in the input type.
//   Replaces repro/kernels/flash_attention.py::flash_attention (_kernel).
//
// Bound on the H100: operations at prefill (4 * hd FLOPs per unmasked
// (query, key) pair against (Sq + 2 Sk) * hd inputs: gemma2-2b's 4096-token
// prefill does about 2,000 FLOPs per byte), bytes at decode (each key of
// the cache read once for the g query heads of its KV head).
//
// Design. The TPU kernel keeps a whole head's K/V resident in VMEM and runs
// one grid step per (batch, head, q tile). Here:
// * One thread block serves one (batch, KV head) and 64 consecutive rows of
//   the flattened (query, head-in-group) index, so every K/V tile it loads
//   is read once for all g query heads of that KV head (GQA without
//   replicating K/V, and any g, 5 included).
// * K/V stream through shared memory, 32 keys a tile (fp32 in shared memory
//   whatever the input type); the 64 query rows stay there as well. Each of
//   the 8 warps owns 8 rows; lane j scores key j of the tile against them
//   (one 16-byte shared load of K feeds 32 FMAs), keeps the online softmax
//   (m, den, acc) in registers, and P @ V takes each p from its lane by a
//   shuffle while every lane owns hd / 32 output columns.
// * Masked scores get -1e30 and p = exp(s - m) as in the reference: while
//   a row's running max is still -1e30 its masked keys weigh 1, and its
//   first visible key rescales them to 0. A block walks only the tiles its
//   rows can see (from the window's lower bound of its first row to the
//   causal bound of its last), which changes no row that sees a key. A row
//   that sees none (its window starts past the last key) averages every
//   value, as the reference's does, so a block whose last row is such a
//   row walks every key. Keys past Sk weigh 0.
// * Decode (Sq = 1) gives only B * KV blocks. The key range is then split
//   over thread blocks (flash-decoding): each writes its partial
//   (m, den, acc) rows to a workspace and a second kernel combines the
//   splits in split order, so the result does not depend on scheduling.
// * q_offset, window and softcap are run-time arguments: one build serves
//   every decode position. Any Sq and Sk: rows and keys past the end are
//   masked, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // (query, head) rows a block
constexpr int kKeys = 32;                      // keys a tile: one per lane
constexpr float kNeg = -1e30f;                 // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws;          // [splits, B * KV, Sq * g, hd + 2] when splits > 1
  int b, sq, sk, h, kv, hd, g;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;   // batch and sequence strides
  int causal, window, q_offset;
  float softcap, sqrt_hd;
  int splits, chunk;  // key splits and the keys of each (a multiple of 32)
};

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

// four bf16 (8 bytes): the element at the lower address is the low half
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(t.x << 16);
  o[1] = __uint_as_float(t.x & 0xffff0000u);
  o[2] = __uint_as_float(t.y << 16);
  o[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// NC = output columns per lane (hd <= 32 * NC)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int hd = p.hd, g = p.g, hq = hd >> 2;
  const int ldq = hd + 4;  // row strides: 16-byte reads by 8 lanes of
  const int ldk = hd + 4;  // different rows fall on distinct banks
  float* qs = smem;                      // [kRows][ldq]
  float* ks = qs + kRows * ldq;          // [kKeys][ldk]
  float* vs = ks + kKeys * ldk;          // [kKeys][hd]

  const int rows_total = p.sq * g;
  const int row0 = blockIdx.x * kRows;
  const int bk = blockIdx.y;             // batch * KV + KV head
  const int bi = bk / p.kv, kvh = bk % p.kv;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + kvh * g * hd;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * hd;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * hd;

  // the keys this block's rows can see, within its split
  const int last_row = min(row0 + kRows, rows_total) - 1;
  const int qpos_lo = p.q_offset + row0 / g;
  const int qpos_hi = p.q_offset + last_row / g;
  int k_lo = split * p.chunk;
  int k_hi = min(p.sk, k_lo + p.chunk);
  // rows are in position order: if any row sees no key, the last does
  const bool blind_row = p.window > 0 && qpos_hi - p.window + 1 >= p.sk;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  if (p.window > 0 && !blind_row) k_lo = max(k_lo, qpos_lo - p.window + 1);

  for (int i = threadIdx.x; i < kRows * hq; i += kThreads) {
    const int r = i / hq, d = (i - r * hq) * 4;
    const int row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows_total) {
      const int qi = row / g, hh = row - qi * g;
      load4(q + qi * p.q_ss + hh * hd + d, x);
    }
    *reinterpret_cast<float4*>(qs + r * ldq + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }

  const int wrow0 = row0 + warp * kRowsPerWarp;
  const bool live = wrow0 < rows_total;   // warp-uniform
  const float* qw = qs + warp * kRowsPerWarp * ldq;
  float m[kRowsPerWarp], den[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    den[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int key0 = k_lo; key0 < k_hi; key0 += kKeys) {
    const int nk = min(kKeys, k_hi - key0);
    __syncthreads();   // the previous tile is consumed (and Q is stored)
    for (int i = threadIdx.x; i < kKeys * hq; i += kThreads) {
      const int j = i / hq, d = (i - j * hq) * 4;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nk) {
        load4(k + (key0 + j) * p.k_ss + d, kx);
        load4(v + (key0 + j) * p.v_ss + d, vx);
      }
      *reinterpret_cast<float4*>(ks + j * ldk + d) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(vs + j * hd + d) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();
    if (!live) continue;

    // scores: lane = key
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = ks + lane * ldk;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * ldq + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // online softmax; s[r] becomes p
    const int key = key0 + lane;
    const bool exists = lane < nk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = wrow0 + r;
      const int qpos = p.q_offset + row / g;
      bool ok = exists;
      if (p.causal) ok = ok && key <= qpos;
      if (p.window > 0) ok = ok && key > qpos - p.window;
      float x = s[r] / p.sqrt_hd;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = ok ? x : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - m_new);
      const float pr = exists ? expf(x - m_new) : 0.f;
      den[r] = den[r] * corr + pr;   // this lane's share; summed at the end
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      s[r] = pr;
    }

    // acc += P @ V: lane owns columns lane + 32 c
    for (int j = 0; j < nk; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < hd ? vs[j * hd + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float dsum = warp_sum(den[r]);
    const int row = wrow0 + r;
    if (row >= rows_total) continue;
    if (p.splits == 1) {
      const int qi = row / g, hh = row - qi * g;
      T* o = static_cast<T*>(p.out) +
             ((static_cast<long long>(bi) * p.sq + qi) * p.h + kvh * g + hh) *
                 hd;
      const float dn = fmaxf(dsum, 1e-38f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < hd) store(o + col, acc[r][c] / dn);
      }
    } else {
      float* w = p.ws + ((static_cast<long long>(split) * p.b * p.kv + bk) *
                             rows_total + row) * (hd + 2);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < hd) w[col] = acc[r][c];
      }
      if (lane == 0) {
        w[hd] = m[r];
        w[hd + 1] = dsum;
      }
    }
  }
}

// the splits' partial rows combined in split order: one thread an output
template <typename T>
__global__ void flash_combine_kernel(const Params p) {
  const int hd = p.hd, g = p.g;
  const long long rows_total = static_cast<long long>(p.sq) * g;
  const long long total = static_cast<long long>(p.b) * p.kv * rows_total * hd;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int col = static_cast<int>(idx % hd);
  const long long t = idx / hd;
  const long long row = t % rows_total;
  const long long bk = t / rows_total;
  const long long step = static_cast<long long>(p.b) * p.kv * rows_total *
                         (hd + 2);
  const float* w = p.ws + (bk * rows_total + row) * (hd + 2);
  float m = kNeg;
  for (int s = 0; s < p.splits; ++s) m = fmaxf(m, w[s * step + hd]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float c = expf(w[s * step + hd] - m);
    num += w[s * step + col] * c;
    den += w[s * step + hd + 1] * c;
  }
  const long long bi = bk / p.kv, kvh = bk % p.kv;
  const long long qi = row / g, hh = row % g;
  T* o = static_cast<T*>(p.out) + ((bi * p.sq + qi) * p.h + kvh * g + hh) * hd;
  store(o + col, num / fmaxf(den, 1e-38f));
}

long long smem_bytes(int hd) {
  return static_cast<long long>(sizeof(float)) *
         (kRows * (hd + 4) + kKeys * (hd + 4) + kKeys * hd);
}

template <typename T, int NC>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(p.hd));
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows_total = static_cast<long long>(p.sq) * p.g;
  dim3 grid(static_cast<unsigned>((rows_total + kRows - 1) / kRows),
            p.b * p.kv, p.splits);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const long long total = static_cast<long long>(p.b) * p.kv * rows_total *
                          p.hd;
  flash_combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 1>(p, stream);
  if (p.hd <= 64) return launch<T, 2>(p, stream);
  if (p.hd <= 128) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one thread block at head dim hd.
extern "C" long long flash_attention_smem_bytes(int hd) {
  return smem_bytes(hd);
}

// K10. q [B, Sq, H, hd], k and v [B, Sk, KV, hd], each with unit element
// stride, heads hd apart and the given batch and sequence strides (in
// elements, multiples of 4, base 16-byte aligned); out [B, Sq, H, hd]
// contiguous; dtype 0 = fp32, 1 = bf16; hd a multiple of 4, at most 256;
// window <= 0 and softcap <= 0 switch those off; ws holds
// splits * B * KV * Sq * (H / KV) * (hd + 2) floats when splits > 1.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* ws,
    int dtype, int b, int sq, int sk, int h, int kv, int hd, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int causal, int window, float softcap, int q_offset,
    int splits, int chunk, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0 || hd <= 0 ||
      hd > 256 || hd % 4 != 0 || splits <= 0 || chunk <= 0 ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.ws = ws;
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.kv = kv;
  p.hd = hd;
  p.g = h / kv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  p.sqrt_hd = sqrtf(static_cast<float>(hd));
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, st);
  return dispatch<__nv_bfloat16>(p, st);
}
