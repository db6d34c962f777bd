// K10, flash_attention_fwd — grouped-query attention for the LM's prefill
// and decode:
//     out[b, i, h] = softmax_j(mask(cap(q[b, i, h] . k[b, j, h/g] / sqrt(hd))))
//                    @ v[b, :, h/g]
//   with q [B, Sq, H, hd], k and v [B, Sk, KV, hd] (g = H / KV), query i at
//   position q_offset + i, key j at position j; mask: j <= q_pos (causal),
//   j > q_pos - window (window > 0); cap(s) = softcap * tanh(s / softcap)
//   (softcap > 0). fp32 or bf16 in (all three alike), fp32 softmax and
//   sums, out in the input type.
//   Replaces repro/kernels/flash_attention.py::flash_attention (_kernel).
//
// Bound on the H100: operations at prefill (4 * hd FLOPs per unmasked
// (query, key) pair against (Sq + 2 Sk) * hd inputs: gemma2-2b's 4096-token
// prefill does about 2,000 FLOPs per byte, far above the card's ~295 for
// bf16), bytes at decode (each key of the cache read once for the g query
// heads of its KV head).
//
// Three kernels, one function. The wrapper (kernels/flash_attention.py,
// ``plan``) picks one by dtype, head dim and the Sq * g flattened rows:
//
// * flash_attention_mma_kernel — bf16, hd a multiple of 16, Sq * g >= 64
//   (every prefill). Tensor cores: mma.sync.m16n8k16 bf16 with fp32
//   accumulation. A block of 4 warps owns 64 consecutive rows of the
//   flattened (query, head-in-group) index of one (batch, KV head), 128 at
//   hd 128 (two m16 tiles a warp, so each K and V fragment feeds both), so
//   each K/V tile is read once for all g query heads (GQA without
//   replicating K/V, any g). Q, K and V sit in shared memory as bf16 (64
//   keys a tile, rows padded by 16 bytes so ldmatrix's eight rows fall on
//   distinct banks); cp.async fills them. K and V each have one buffer and
//   the load of one overlaps the product with the other: V(t) lands during
//   Q K(t)^T and the softmax, K(t+1) during P @ V(t). Two barriers a tile.
//   S = Q K^T: bf16 x bf16 products are exact in fp32 and summed in fp32.
//   P @ V: P rounded to bf16 would move each weight by up to 2^-8, more
//   than atol 2e-5 where an output is near zero; so it is computed as
//   P_hi @ V + P_lo @ V with P_hi = bf16(p), P_lo = bf16(p - P_hi), about
//   16 bits of each weight, for 1.5x the tensor FLOPs. The softmax runs in
//   base 2: on a tile with neither mask nor cap a score costs one FFMA and
//   one MUFU.EX2 (the max is taken over the raw scores and scaled once).
//   Tiles outside the block's visible range are skipped and only the tiles
//   that cross the diagonal, the window edge or the last key are masked;
//   with causal masking the latest (heaviest) row blocks launch first.
// * flash_decode_kernel — bf16, hd a multiple of 16, Sq * g < 64 (decode).
//   A block of 8 warps serves one (batch, KV head, key split) and only the
//   live rows. Every warp reads a disjoint key sub-range of the split,
//   whole key rows at a time in coalesced 16-byte loads (hd / 8 lanes a
//   key, 256 / hd keys an instruction), K/V kept bf16 in registers; rows
//   go 4 at a time. The warps' (m, den, acc) are combined through shared
//   memory in warp order.
// * flash_attention_kernel — everything else: fp32 inputs (IEEE FMAs, no
//   TF32 or tensor cores) and bf16 with hd not a multiple of 16. One block
//   of 8 warps serves 64 rows; K/V stream through fp32 shared memory 32
//   keys a tile; lane j scores key j, P @ V takes each p by a shuffle.
//
// Common to all three:
// * Masked scores get -1e30 and p = exp(s - m) as in the reference: while
//   a row's running max is still -1e30 its masked keys weigh 1, and its
//   first visible key rescales them to 0. A block walks only the keys its
//   rows can see (from the window's lower bound of its first row to the
//   causal bound of its last), which changes no row that sees a key. A row
//   that sees none (its window starts past the last key) averages every
//   value, as the reference's does, so a block whose last row is such a
//   row walks every key. Keys past Sk or past the walked range weigh 0.
// * When the grid would leave SMs idle (decode) the key range is split
//   over thread blocks (flash-decoding): each writes its partial
//   (m, den, acc) rows to a workspace and flash_combine_kernel combines the
//   splits in split order, so the result does not depend on scheduling.
//   No float atomics anywhere.
// * q_offset, window and softcap are run-time arguments: one build serves
//   every decode position. Any Sq and Sk: rows and keys past the end are
//   masked, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;                 // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

// -inf: the score of a key that does not exist (past Sk or the walked range)
__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

enum Route { kRouteFma = 0, kRouteMma = 1, kRouteDecode = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws;          // [splits, B * KV, Sq * g, hd + 2] when splits > 1
  int b, sq, sk, h, kv, hd, g;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;   // batch and sequence strides
  int causal, window, q_offset;
  float softcap, sqrt_hd, scale;                  // scale = 1 / sqrt(hd)
  int splits, chunk;  // key splits and the keys of each
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

// eight bf16 (one 16-byte word) as floats
__device__ __forceinline__ void unpack8(const uint4& t, float* o) {
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

// The keys [k_lo, k_hi) that rows [row0, last_row] of one (batch, KV head)
// can see within key split `split` (see the file comment).
__device__ __forceinline__ void visible_keys(const Params& p, int row0,
                                             int last_row, int split,
                                             int* k_lo, int* k_hi) {
  const int qpos_lo = p.q_offset + row0 / p.g;
  const int qpos_hi = p.q_offset + last_row / p.g;
  int lo = split * p.chunk;
  int hi = min(p.sk, lo + p.chunk);
  // rows are in position order: if any row sees no key, the last does
  const bool blind_row = p.window > 0 && qpos_hi - p.window + 1 >= p.sk;
  if (p.causal) hi = min(hi, qpos_hi + 1);
  if (p.window > 0 && !blind_row) lo = max(lo, qpos_lo - p.window + 1);
  *k_lo = lo;
  *k_hi = hi;
}

// the score of one (row, key) pair before masking: s / sqrt(hd), capped
__device__ __forceinline__ float scaled(const Params& p, float s) {
  const float x = s * p.scale;
  return p.softcap > 0.f ? p.softcap * tanhf(x / p.softcap) : x;
}

__device__ __forceinline__ bool sees(const Params& p, int key, int qpos) {
  bool ok = true;
  if (p.causal) ok = key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// flash_attention_kernel: the CUDA-core route (fp32; bf16 at other hd)
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // (query, head) rows a block
constexpr int kKeys = 32;                      // keys a tile: one per lane

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

  int k_lo, k_hi;
  visible_keys(p, row0, min(row0 + kRows, rows_total) - 1, split, &k_lo,
               &k_hi);

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
      float x = s[r] / p.sqrt_hd;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      x = exists && sees(p, key, qpos) ? x : kNeg;
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

// ---------------------------------------------------------------------------
// flash_attention_mma_kernel: bf16 prefill on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = kMmaWarps * 16;   // rows a block per m16 tile a warp
constexpr int kMmaKeys = 64;               // keys a tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] @ b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned* hi,
                                           unsigned* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *hi = bf16x2_bits(h);
  *lo = bf16x2_bits(__floats2bfloat162_rn(x0 - __low2float(h),
                                          x1 - __high2float(h)));
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (MUFU.EX2; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// m16 row tiles a warp owns at head dim HD: two at 128, so each K and V
// fragment feeds both (at 256 the output alone takes 128 registers)
__host__ __device__ constexpr int mma_tiles(int hd) {
  return hd == 128 ? 2 : 1;
}

// HD: head dim rounded up to 64, 128 or 256 (columns past hd are zeros);
// each warp owns MT m16 row tiles, the block 64 * MT rows
template <int HD, int MT>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const Params p) {
  constexpr int LD = HD + 8;      // bf16 a shared row: +16 bytes, so the 8
  constexpr int CH = HD / 8;      // rows of an ldmatrix hit distinct banks
  constexpr int NT = HD / 8;      // n8 tiles of the output
  constexpr int ROWS = kMmaRows * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + ROWS * LD;
  __nv_bfloat16* sv = sk + kMmaKeys * LD;

  const int hd = p.hd, g = p.g;
  const int rows_total = p.sq * g;
  // with causal masking the latest rows see the most keys: launch them first
  const int rb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int row0 = rb * ROWS;
  const int bk = blockIdx.x;             // batch * KV + KV head
  const int bi = bk / p.kv, kvh = bk % p.kv;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb + kvh * g * hd;
  const bf16* k = static_cast<const bf16*>(p.k) + bi * p.k_sb + kvh * hd;
  const bf16* v = static_cast<const bf16*>(p.v) + bi * p.v_sb + kvh * hd;

  const int last_row = min(row0 + ROWS, rows_total) - 1;
  int k_lo, k_hi;
  visible_keys(p, row0, last_row, split, &k_lo, &k_hi);
  const int qpos_first = p.q_offset + row0 / g;
  const int qpos_last = p.q_offset + last_row / g;

  for (int i = tid; i < ROWS * CH; i += kMmaThreads) {
    const int r = i / CH, c = i - r * CH;
    const int row = row0 + r;
    const bool ok = row < rows_total && c * 8 < hd;
    const bf16* src = q;
    if (ok) {
      const int qi = row / g, hh = row - qi * g;
      src = q + qi * p.q_ss + hh * hd + c * 8;
    }
    cp_async16(sq + r * LD + c * 8, src, ok);
  }
  auto load_tile = [&](bf16* dst, const bf16* src, long long ss, int key0) {
    for (int i = tid; i < kMmaKeys * CH; i += kMmaThreads) {
      const int j = i / CH, c = i - j * CH;
      const int key = key0 + j;
      const bool ok = key < k_hi && c * 8 < hd;
      cp_async16(dst + j * LD + c * 8, ok ? src + key * ss + c * 8 : src, ok);
    }
  };

  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kMmaKeys - 1) / kMmaKeys
                                  : 0;
  if (n_tiles > 0) load_tile(sk, k, p.k_ss, k_lo);
  cp_async_commit();                     // Q and K(0)

  // the softmax runs in base 2: x2 = x * log2(e), p = 2^(x2 - m2). The mask
  // value stays -1e30, so a masked key still weighs 1 while a row's max is
  // -1e30 and 0 after, as in the reference.
  const float c2 = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap2 = p.softcap * kLog2e;
  // this lane's rows: m-tile i's wr + 16 i and wr + 16 i + 8 (mma C layout)
  const int wr = warp * 16 * MT + (lane >> 2);
  int qpos[MT][2];
  float o[MT][NT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      qpos[i][h2] = p.q_offset + (row0 + wr + 16 * i + 8 * h2) / g;
      m[i][h2] = kNeg;
      l[i][h2] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = k_lo + t * kMmaKeys;
    cp_async_wait<0>();
    __syncthreads();                     // K(t) landed; V(t-1) consumed
    load_tile(sv, v, p.v_ss, key0);
    cp_async_commit();

    // S[16 MT x 64] = Q K^T for this warp's rows
    float s[MT][8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(a[i], sq + (warp * 16 * MT + i * 16 + (lane & 15)) * LD +
                          kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned b[4];
        ldsm_x4(b, sk + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(s[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(s[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }

    // online softmax over the tile; s becomes p. Only a tile that crosses
    // the diagonal, the window edge or the last key is masked.
    const bool edge = key0 + kMmaKeys > k_hi ||
                      (p.causal && key0 + kMmaKeys - 1 > qpos_first) ||
                      (p.window > 0 && key0 <= qpos_last - p.window);
    // a tile with neither mask nor cap keeps its raw scores: the max is
    // taken over them and scaled once, and p = 2^(s c2 - m2) is one FFMA
    // and one MUFU.EX2 a score
    const bool raw = !edge && !(p.softcap > 0.f);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (p.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[i][j][e] = cap2 * tanhf(s[i][j][e] * c2);
          }
        }
      } else if (!raw) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j][e] *= c2;
        }
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + j * 8 + (lane & 3) * 2 + (e & 1);
            s[i][j][e] = key >= k_hi ? neg_inf()
                         : sees(p, key, qpos[i][e >> 1]) ? s[i][j][e] : kNeg;
          }
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = s[i][0][2 * h2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx = fmaxf(mx, fmaxf(s[i][j][2 * h2], s[i][j][2 * h2 + 1]));
        }
        mx = fmaxf(m[i][h2], raw ? mx * c2 : mx);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float corr = ex2(m[i][h2] - mx);
        m[i][h2] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = s[i][j][2 * h2 + e];
            const float pe = ex2(raw ? fmaf(x, c2, -mx) : x - mx);
            s[i][j][2 * h2 + e] = pe;
            sum += pe;
          }
        }
        l[i][h2] = l[i][h2] * corr + sum;  // this lane's share
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[i][n][2 * h2] *= corr;
          o[i][n][2 * h2 + 1] *= corr;
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();                     // V(t) landed; K(t) consumed
    if (t + 1 < n_tiles) load_tile(sk, k, p.k_ss, key0 + kMmaKeys);
    cp_async_commit();
    // O += P_hi V + P_lo V, 16 keys at a time
#pragma unroll
    for (int ks = 0; ks < kMmaKeys / 16; ++ks) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        split_bf16(s[i][2 * ks][0], s[i][2 * ks][1], &ah[i][0], &al[i][0]);
        split_bf16(s[i][2 * ks][2], s[i][2 * ks][3], &ah[i][1], &al[i][1]);
        split_bf16(s[i][2 * ks + 1][0], s[i][2 * ks + 1][1], &ah[i][2],
                   &al[i][2]);
        split_bf16(s[i][2 * ks + 1][2], s[i][2 * ks + 1][3], &ah[i][3],
                   &al[i][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        unsigned b[4];
        ldsm_x4_t(b, sv + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(o[i][2 * n2], ah[i], b[0], b[1]);
          mma_bf16(o[i][2 * n2], al[i], b[0], b[1]);
          mma_bf16(o[i][2 * n2 + 1], ah[i], b[2], b[3]);
          mma_bf16(o[i][2 * n2 + 1], al[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                    // nothing in flight at exit

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float den = l[i][h2];
      den += __shfl_xor_sync(kFull, den, 1);
      den += __shfl_xor_sync(kFull, den, 2);
      const int row = row0 + wr + 16 * i + 8 * h2;
      if (row >= rows_total) continue;
      if (p.splits == 1) {
        const int qi = row / g, hh = row - qi * g;
        bf16* out = static_cast<bf16*>(p.out) +
                    ((static_cast<long long>(bi) * p.sq + qi) * p.h +
                     kvh * g + hh) * hd;
        const float dn = fmaxf(den, 1e-38f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + (lane & 3) * 2;
          if (col < hd) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(o[i][n][2 * h2] / dn,
                                      o[i][n][2 * h2 + 1] / dn);
          }
        }
      } else {
        // the split combine works in base e: m back from base 2 (every
        // split of a call scales alike, so -1e30 rows still weigh alike)
        float* w = p.ws + ((static_cast<long long>(split) * p.b * p.kv +
                            bk) * rows_total + row) * (hd + 2);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + (lane & 3) * 2;
          if (col < hd) {
            w[col] = o[i][n][2 * h2];
            w[col + 1] = o[i][n][2 * h2 + 1];
          }
        }
        if ((lane & 3) == 0) {
          w[hd] = m[i][h2] * kLn2;
          w[hd + 1] = den;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_decode_kernel: bf16 decode, every warp reading the cache
// ---------------------------------------------------------------------------
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecRows = 4;       // rows a pass (registers: q and acc)
constexpr int kDecBatch = 2;      // key groups a lane has in flight

__global__ void __launch_bounds__(kDecThreads, 2)
flash_decode_kernel(const Params p) {
  extern __shared__ float dsm[];          // [kDecWarps][kDecRows][hd]
  __shared__ float s_m[kDecWarps][kDecRows], s_l[kDecWarps][kDecRows];
  using bf16 = __nv_bfloat16;
  const int hd = p.hd, g = p.g;
  const int rows_total = p.sq * g;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int bi = bk / p.kv, kvh = bk % p.kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb + kvh * g * hd;
  const bf16* k = static_cast<const bf16*>(p.k) + bi * p.k_sb + kvh * hd;
  const bf16* v = static_cast<const bf16*>(p.v) + bi * p.v_sb + kvh * hd;

  // lanes a key: hd / 8 rounded up to a power of two; keys an instruction
  int lpk = 2;
  while (lpk * 8 < hd) lpk <<= 1;
  const int kpl = 32 / lpk;
  const int slot = lane / lpk, col0 = (lane % lpk) * 8;
  const bool col_ok = col0 < hd;

  int k_lo, k_hi;
  visible_keys(p, 0, rows_total - 1, split, &k_lo, &k_hi);
  // this warp's keys: a contiguous share, a multiple of kpl keys
  const int n = max(0, k_hi - k_lo);
  const int per = ((n + kDecWarps - 1) / kDecWarps + kpl - 1) / kpl * kpl;
  const int w_lo = k_lo + warp * per;
  const int w_hi = min(k_hi, w_lo + per);

  for (int rc0 = 0; rc0 < rows_total; rc0 += kDecRows) {
    float qf[kDecRows][8], acc[kDecRows][8], m[kDecRows], l[kDecRows];
    int qpos[kDecRows];
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      const int row = rc0 + r;
      const int qi = min(row, rows_total - 1) / g;
      qpos[r] = p.q_offset + qi;
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows_total && col_ok) {
        t = __ldg(reinterpret_cast<const uint4*>(
            q + qi * p.q_ss + (row - qi * g) * hd + col0));
      }
      unpack8(t, qf[r]);
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    }

    for (int key0 = w_lo; key0 < w_hi; key0 += kpl * kDecBatch) {
      uint4 kr[kDecBatch], vr[kDecBatch];
      bool ex[kDecBatch];
#pragma unroll
      for (int i = 0; i < kDecBatch; ++i) {
        const int key = key0 + i * kpl + slot;
        ex[i] = key < w_hi;
        kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
        if (ex[i] && col_ok) {
          kr[i] = __ldg(reinterpret_cast<const uint4*>(k + key * p.k_ss +
                                                       col0));
          vr[i] = __ldg(reinterpret_cast<const uint4*>(v + key * p.v_ss +
                                                       col0));
        }
      }
      float x[kDecRows][kDecBatch];
#pragma unroll
      for (int i = 0; i < kDecBatch; ++i) {
        float kf[8];
        unpack8(kr[i], kf);
        const int key = key0 + i * kpl + slot;
#pragma unroll
        for (int r = 0; r < kDecRows; ++r) {
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) d = fmaf(qf[r][c], kf[c], d);
          for (int o = lpk >> 1; o > 0; o >>= 1)
            d += __shfl_xor_sync(kFull, d, o);
          const float s = scaled(p, d);
          x[r][i] = !ex[i] ? neg_inf() : sees(p, key, qpos[r]) ? s : kNeg;
        }
      }
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < kDecBatch; ++i) mx = fmaxf(mx, x[r][i]);
        const float corr = __expf(m[r] - mx);
        m[r] = mx;
        l[r] *= corr;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] *= corr;
#pragma unroll
        for (int i = 0; i < kDecBatch; ++i) {
          const float pe = __expf(x[r][i] - mx);
          l[r] += pe;
          float vf[8];
          unpack8(vr[i], vf);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(pe, vf[c], acc[r][c]);
        }
      }
    }

    // the warp's key slots combined (lanes lpk apart hold the same columns)
#pragma unroll
    for (int r = 0; r < kDecRows; ++r) {
      for (int o = lpk; o < 32; o <<= 1) {
        const float m2 = __shfl_xor_sync(kFull, m[r], o);
        const float l2 = __shfl_xor_sync(kFull, l[r], o);
        const float mx = fmaxf(m[r], m2);
        const float c1 = __expf(m[r] - mx), c2 = __expf(m2 - mx);
        l[r] = l[r] * c1 + l2 * c2;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float a2 = __shfl_xor_sync(kFull, acc[r][c], o);
          acc[r][c] = acc[r][c] * c1 + a2 * c2;
        }
        m[r] = mx;
      }
      if (slot == 0 && col_ok) {
        float* d = dsm + (warp * kDecRows + r) * hd + col0;
#pragma unroll
        for (int c = 0; c < 8; ++c) d[c] = acc[r][c];
      }
      if (lane == 0) {
        s_m[warp][r] = m[r];
        s_l[warp][r] = l[r];
      }
    }
    __syncthreads();
    // the warps combined in warp order: one thread a (row, column)
    for (int idx = threadIdx.x; idx < kDecRows * hd; idx += kDecThreads) {
      const int r = idx / hd, col = idx - r * hd;
      const int row = rc0 + r;
      if (row >= rows_total) continue;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float c = __expf(s_m[w][r] - mx);
        num += dsm[(w * kDecRows + r) * hd + col] * c;
        den += s_l[w][r] * c;
      }
      if (p.splits == 1) {
        const int qi = row / g, hh = row - qi * g;
        bf16* out = static_cast<bf16*>(p.out) +
                    ((static_cast<long long>(bi) * p.sq + qi) * p.h +
                     kvh * g + hh) * hd;
        out[col] = __float2bfloat16_rn(num / fmaxf(den, 1e-38f));
      } else {
        float* w = p.ws + ((static_cast<long long>(split) * p.b * p.kv + bk) *
                               rows_total + row) * (hd + 2);
        w[col] = num;
        if (col == 0) {
          w[hd] = mx;
          w[hd + 1] = den;
        }
      }
    }
    __syncthreads();                      // shared memory is reused
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

int mma_dim(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

int mma_rows(int hd) { return kMmaRows * mma_tiles(mma_dim(hd)); }

long long smem_bytes(int route, int hd) {
  if (route == kRouteMma) {   // Q, K and V tiles in bf16
    return 2LL * (mma_dim(hd) + 8) * (mma_rows(hd) + 2 * kMmaKeys);
  }
  if (route == kRouteDecode) {  // the warps' partial acc rows
    return static_cast<long long>(sizeof(float)) * kDecWarps * kDecRows * hd;
  }
  return static_cast<long long>(sizeof(float)) *
         (kRows * (hd + 4) + kKeys * (hd + 4) + kKeys * hd);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, int smem,
                  const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine(const Params& p, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.b) * p.kv * p.sq * p.g *
                          p.hd;
  flash_combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256,
                            0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(kRouteFma, p.hd));
  const long long rows_total = static_cast<long long>(p.sq) * p.g;
  const dim3 grid(static_cast<unsigned>((rows_total + kRows - 1) / kRows),
                  p.b * p.kv, p.splits);
  if (p.hd <= 32) {
    return launch_kernel(flash_attention_kernel<T, 1>, grid, kThreads, smem,
                         p, stream);
  }
  if (p.hd <= 64) {
    return launch_kernel(flash_attention_kernel<T, 2>, grid, kThreads, smem,
                         p, stream);
  }
  if (p.hd <= 128) {
    return launch_kernel(flash_attention_kernel<T, 4>, grid, kThreads, smem,
                         p, stream);
  }
  return launch_kernel(flash_attention_kernel<T, 8>, grid, kThreads, smem, p,
                       stream);
}

int launch_mma(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(kRouteMma, p.hd));
  const long long rows_total = static_cast<long long>(p.sq) * p.g;
  const dim3 grid(p.b * p.kv,
                  static_cast<unsigned>((rows_total + mma_rows(p.hd) - 1) /
                                        mma_rows(p.hd)),
                  p.splits);
  switch (mma_dim(p.hd)) {
    case 64:
      return launch_kernel(flash_attention_mma_kernel<64, mma_tiles(64)>,
                           grid, kMmaThreads, smem, p, stream);
    case 128:
      return launch_kernel(flash_attention_mma_kernel<128, mma_tiles(128)>,
                           grid, kMmaThreads, smem, p, stream);
    default:
      return launch_kernel(flash_attention_mma_kernel<256, mma_tiles(256)>,
                           grid, kMmaThreads, smem, p, stream);
  }
}

int launch_decode(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(kRouteDecode, p.hd));
  return launch_kernel(flash_decode_kernel, dim3(p.b * p.kv, p.splits),
                       kDecThreads, smem, p, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one thread block of `route` at head dim hd.
extern "C" long long flash_attention_smem_bytes(int route, int hd) {
  return smem_bytes(route, hd);
}

// K10. q [B, Sq, H, hd], k and v [B, Sk, KV, hd], each with unit element
// stride, heads hd apart and the given batch and sequence strides (in
// elements); out [B, Sq, H, hd] contiguous; dtype 0 = fp32, 1 = bf16; hd at
// most 256; window <= 0 and softcap <= 0 switch those off; ws holds
// splits * B * KV * Sq * (H / KV) * (hd + 2) floats when splits > 1.
// route 0 (CUDA cores): hd a multiple of 4, strides multiples of 4, bases
// 16-byte aligned (fp32) or 8-byte (bf16). Routes 1 (tensor cores) and 2
// (decode): bf16, hd a multiple of 16, strides multiples of 8 (16 bytes),
// bases 16-byte aligned.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* ws,
    int dtype, int route, int b, int sq, int sk, int h, int kv, int hd,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, int causal, int window, float softcap,
    int q_offset, int splits, int chunk, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0 || hd <= 0 ||
      hd > 256 || hd % 4 != 0 || splits <= 0 || chunk <= 0 ||
      (splits > 1 && ws == nullptr) || route < 0 || route > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteFma &&
      (dtype != 1 || hd % 16 != 0 || !aligned16(q) || !aligned16(k) ||
       !aligned16(v) || q_sb % 8 || q_ss % 8 || k_sb % 8 || k_ss % 8 ||
       v_sb % 8 || v_ss % 8)) {
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
  p.scale = 1.f / p.sqrt_hd;
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (route == kRouteMma) {
    rc = launch_mma(p, st);
  } else if (route == kRouteDecode) {
    rc = launch_decode(p, st);
  } else if (dtype == 0) {
    rc = launch_fma<float>(p, st);
  } else {
    rc = launch_fma<__nv_bfloat16>(p, st);
  }
  if (rc != 0 || splits == 1) return rc;
  if (dtype == 0) return launch_combine<float>(p, st);
  return launch_combine<__nv_bfloat16>(p, st);
}
