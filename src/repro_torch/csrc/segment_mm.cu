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
// fp64 tensor cores' 67 TFLOP/s ridge, 20 FLOP/byte). At k = n = 64 the
// bytes and the FMAs are close (0.075 against 0.060 ms for 500 K rows), so
// K1/K4 must run their FMAs near the fp32 peak to stay on the byte bound.
//
// K1/K4 design. Every output is one fp32 FMA chain over kk = 0 .. k-1 in
// order, started at +0, with the scale as its epilogue (no TF32, no split,
// no tensor cores): the results are bit for bit those of a thread forming
// one output at a time; a slot gathering -1 is an exact zero. The wrapper
// picks the route and the work split from the shapes alone
// (segment_mm.py::gemm_plan):
//
// * wide (n > 16): 128 threads cover pieces of 128 rows by 64 columns, each
//   thread an 8 x 8 register tile (two groups of 4 columns, 32 apart; a
//   warp is 4 x 8 threads) that reads 16 words of 16 bytes from shared
//   memory a 256 FMAs (a thread forming one output at a time read two
//   words a FMA, which held the FMAs near 1/8 of their peak). A call too
//   small to fill the card takes 256 threads of 2 x 4 tiles, 32-row pieces.
// * narrow (n <= 16: the n = 1 attention products, the n = 8 / 16 output
//   layers): a row a thread with all its columns, so no thread idles. At
//   n = 1 each warp stages its 32 rows itself, with no block-wide barrier,
//   and holds W's column in registers (column_body); at n = 2 .. 16 the
//   128-row pieces take the shared-memory pipeline, a piece holding up to
//   kNarrowRuns groups (a W slot each), so the short groups of a served
//   batch do not wait for one another.
//
// The shared-memory pipeline (gemm_body): persistent blocks, in whole waves,
// each walk a span of at most kSpanMax rows. A span's tile -> group entries
// make runs of consecutive tiles of one group, cut into pieces; a piece's
// rows and its groups' W slices stream through a two-stage cp.async ring in
// chunks of 32 reduction columns, across pieces (the next chunk in flight
// while one is multiplied), so W is staged once a piece rather than once a
// tile and shared memory does not grow with k (48 KB at the 8 x 8 tile). X
// rows sit row-major, their 16-byte quads swizzled so that the rows one
// instruction reads lie in other banks; W as stored sits [kk][cols]; a
// transposed W keeps the reduction index fastest (coalesced reads) as
// [col][kk], quads swizzled by col / 4.
//
// K1 reads its gather indices first: a tile whose indices are all -1 (the
// pure-pad tiles bucketing appends, the padding of tiny groups) is written
// as zeros without staging or multiplying anything, and a -1 row of a real
// tile is never staged. K4 multiplies every row: its pad rows are zero only
// by its callers' contract. Nothing uses atomics; each launch runs on the
// caller's stream and repeats bit for bit. The tuner's tile_rows only
// refines the tile -> group map (sub-tiles share their tile's group, so the
// runs are the same); its tile_n no longer cuts the blocks (the register
// tile fixes the columns of a block); neither changes a result.
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

constexpr int kThreads = 256;       // threads of a K5 block

// ---------------------------------------------------------------------------
// cp.async from global to shared memory (K1, K4, K5)
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// K1 / K4: register-tiled fp32 segment GEMM
// ---------------------------------------------------------------------------
constexpr int kKChunk = 32;          // reduction columns a ring stage holds
constexpr int kGemmStages = 2;       // stages in the cp.async ring
constexpr int kSpanMax = 1024;       // rows a persistent block walks, at most
constexpr int kWideCols = 64;        // columns of a wide block
constexpr int kNarrowThreads = 128;  // narrow: one row a thread
constexpr int kNarrowRuns = 4;       // narrow: groups a piece may hold
// n = 1: each warp's own ring of [32 rows][kKChunk] stages
constexpr int kColumnSmem = kNarrowThreads / 32 * kGemmStages * 32 * kKChunk *
                            static_cast<int>(sizeof(float));
// the routes, as segment_mm.py::gemm_plan names them
constexpr int kRouteWide = 0;
constexpr int kRouteNarrow = 1;
// bits of a launch's `vec`: 16-byte X rows (cp.async of 16 bytes), 16-byte
// W words along a row of W (or, wide, of W^T), float4 stores of Y, and the
// narrow route's single W column contiguous along the reduction
constexpr int kVecX = 1;
constexpr int kVecW = 2;
constexpr int kVecY = 4;
constexpr int kVecWCol = 8;

// A thread holds TR rows by TC columns of a piece of RT * TR rows; the
// block's RT * CT threads cover CT * TC columns, a thread's columns in
// groups of 4 that lie 4 CT apart (col). Wide: TR = TM and, at TM = 8,
// TC = 8 (two groups), RT = 16, CT = 8 (a warp is 4 x 8 threads, 32 rows by
// 64 columns: 16 loads of 16 bytes a 256 FMAs), at TM = 2, TC = 4 and
// RT = CT = 16. Narrow: TR = 1, TC = NC (4, 8 or 16, >= n), RT = 128,
// CT = 1 (n = 1 takes column_body).
template <int TR_, int TC_, int RT_, int CT_>
struct Tiling {
  static constexpr int TR = TR_;
  static constexpr int TC = TC_;
  static constexpr int RT = RT_;
  static constexpr int CT = CT_;
  static constexpr int kRows = RT * TR;           // rows of a piece
  static constexpr int kCols = CT * TC;           // columns of a block
  static constexpr int kThreads = RT * CT;
  // groups a piece may hold: one (wide; a run longer than a piece is cut)
  // or up to kNarrowRuns (narrow: the W chunk of a group is small, so a
  // piece stages one a group and its rows need not wait for one another)
  static constexpr int kRuns = CT == 1 ? kNarrowRuns : 1;
  // X stage [kRows][kKChunk]; W stage: kRuns slots of [kKChunk][kCols]
  // (or, W^T, [kCols][kKChunk])
  static constexpr int kXStage = kRows * kKChunk;
  static constexpr int kWSlot = kKChunk * kCols;
  static constexpr int kWStage = kRuns * kWSlot;
  static constexpr int kSmem =
      kGemmStages * (kXStage + kWStage) * static_cast<int>(sizeof(float));
  // the quad swizzle of a staged X row: by register tile, so that the
  // rows one instruction reads (two or four tiles' at once in a wide warp,
  // one per thread in a narrow one) lie in other banks
  static __device__ __forceinline__ int x_key(int rr) {
    return (rr / TR) & (CT == 1 ? 7 : 3);
  }
  // column (in the block) of column j of thread column tx
  static __device__ __forceinline__ int col(int tx, int j) {
    return 4 * CT * (j >> 2) + 4 * tx + (j & 3);
  }
};

// Offset of reduction column kk in a staged row of kKChunk floats whose
// 16-byte quads are swizzled by `key` (< 8: kKChunk holds 8 quads).
__device__ __forceinline__ int quad_pos(int kk, int key) {
  return 4 * ((kk >> 2) ^ key) + (kk & 3);
}

// Is any bit of [lo, hi) set in the bit mask m (lo < hi)?
__device__ __forceinline__ bool any_bits(const unsigned* m, int lo, int hi) {
  for (int i = lo >> 5; i <= (hi - 1) >> 5; ++i) {
    const int a = max(lo - 32 * i, 0);
    const int b = min(hi - 32 * i, 32);
    const unsigned sel = (b == 32 ? ~0u : (1u << b) - 1u) & ~((1u << a) - 1u);
    if (m[i] & sel) return true;
  }
  return false;
}

// One persistent block: rows [row0, row0 + span) of the padded layout by
// columns [col0, col0 + kCols) of Y. W element (red, col) of group g is at
// w[g * k * n + red * w_sr + col * w_sc]. The span holds tile portions (the
// parts of layout tiles in it); K1 first marks the portions holding a row
// whose gather index is >= 0 ("live"): the others are written as zeros and
// never staged. The live rows are cut into pieces of at most kRows
// consecutive rows and kRuns groups, and a piece into steps of kKChunk
// reduction columns; a step stages the piece's rows and its groups' W
// chunks. Steps flow through a ring of kGemmStages stages across pieces
// (the next in flight while one is multiplied), and a piece's last step
// writes its rows. Every output is one fmaf chain over kk in order.
template <bool kGather, bool kTransW, typename T>
__device__ __forceinline__ void gemm_body(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ gidx, const int* __restrict__ t2g,
    const float* __restrict__ scale, float* __restrict__ y, int k, int n,
    int rp, int tile, int span, int w_sr, int w_sc, int vec) {
  constexpr int TR = T::TR;
  constexpr int TC = T::TC;
  constexpr int RT = T::RT;
  constexpr int CT = T::CT;
  constexpr int BM = T::kRows;
  constexpr int BN = T::kCols;
  constexpr bool kNarrow = CT == 1;
  extern __shared__ __align__(16) float gemm_smem[];
  __shared__ int s_src[kSpanMax];            // row -> source row, or -1
  __shared__ int s_grp[kSpanMax];            // tile portion -> group
  __shared__ unsigned s_real[kSpanMax / 32]; // rows whose source is >= 0
  __shared__ unsigned s_live[kSpanMax / 32]; // rows of live tile portions
  float* xs = gemm_smem;                                 // [stages][X]
  float* ws = gemm_smem + kGemmStages * T::kXStage;      // [stages][W]

  const int tid = threadIdx.x;
  const int tx = tid % CT;
  const int ty = tid / CT;
  const int row0 = blockIdx.x * span;
  const int rows = min(span, rp - row0);
  const int col0 = blockIdx.y * BN;
  const int cols = min(BN, n - col0);
  const int t0 = row0 / tile;
  const int ntl = (row0 + rows - 1) / tile - t0 + 1;   // tile portions
  const bool x4 = vec & kVecX;
  const bool w4 = vec & kVecW;
  const bool y4 = vec & kVecY;
  auto p_lo = [&](int p) { return max(row0, (t0 + p) * tile) - row0; };
  auto p_hi = [&](int p) {
    return min(row0 + rows, (t0 + p + 1) * tile) - row0;
  };

  for (int r = tid; r < rows; r += T::kThreads) {
    s_src[r] = kGather ? gidx[row0 + r] : row0 + r;
    if (r < ntl) s_grp[r] = t2g[t0 + r];
  }
  if (kGather) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int words = (rows + 31) >> 5;
    __syncthreads();
    for (int i = warp; i < words; i += T::kThreads / 32) {
      const int r = 32 * i + lane;
      const unsigned b = __ballot_sync(~0u, r < rows && s_src[r] >= 0);
      if (lane == 0) s_real[i] = b;
    }
    __syncthreads();
    for (int i = warp; i < words; i += T::kThreads / 32) {
      const int r = 32 * i + lane;
      bool live = false;
      if (r < rows) {
        const int p = (row0 + r) / tile - t0;
        live = any_bits(s_real, p_lo(p), p_hi(p));
      }
      const unsigned b = __ballot_sync(~0u, live);
      if (lane == 0) s_live[i] = b;
    }
  }
  __syncthreads();

  auto live = [&](int r) {
    return !kGather || ((s_live[r >> 5] >> (r & 31)) & 1u);
  };
  // rows of portions that gather only -1: zeros, never staged
  if (kGather) {
    for (int r = ty; r < rows; r += RT) {
      if (live(r)) continue;
      float* yr = y + ((size_t)row0 + r) * n + col0;
#pragma unroll
      for (int j = 0; j < TC; j += 4) {
        const int c = T::col(tx, j);
        if (y4 && c + 3 < cols) {
          *reinterpret_cast<float4*>(yr + c) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int u = 0; u < 4 && j + u < TC; ++u) {
            if (c + u < cols) yr[c + u] = 0.f;
          }
        }
      }
    }
  }

  // A step: chunk `chunk` of the piece [lo, hi): up to BM consecutive
  // live rows from `pos` on, of at most T::kRuns groups (a piece ends at a
  // pad portion, after BM rows, or before a (kRuns + 1)-th group; groups
  // change only between a wide piece's pieces, so a thread's TR rows
  // always share one).
  struct Step {
    int pos, lo, hi, chunk;
    bool valid;
  };
  const int nch = (k + kKChunk - 1) / kKChunk;
  auto portion = [&](int r) { return (row0 + r) / tile - t0; };
  auto next_piece = [&](Step& s) {
    s.valid = false;
    if (s.pos >= rows) return;
    int pp = portion(s.pos);
    while (pp < ntl && !live(p_lo(pp))) ++pp;
    if (pp >= ntl) return;
    const int lo = max(s.pos, p_lo(pp));
    int g = s_grp[pp];
    int runs = 1;
    int hi = min(p_hi(pp), lo + BM);
    while (hi < lo + BM && ++pp < ntl && live(p_lo(pp))) {
      const int g2 = s_grp[pp];
      if (g2 != g) {
        if (runs == T::kRuns) break;
        ++runs;
        g = g2;
      }
      hi = min(p_hi(pp), lo + BM);
    }
    s.lo = lo;
    s.hi = hi;
    s.pos = hi;
    s.valid = true;
  };
  auto advance = [&](Step& s) {
    if (++s.chunk < nch) return;
    s.chunk = 0;
    next_piece(s);
  };
  // the W slot of a piece's row r: the groups that start after row lo
  auto slot_of = [&](int lo, int r) {
    int slot = 0;
    int g = s_grp[portion(lo)];
    for (int pp = portion(lo) + 1; pp <= portion(r); ++pp) {
      const int g2 = s_grp[pp];
      slot += g2 != g;
      g = g2;
    }
    return slot;
  };

  // W chunk (kc reduction rows) of one group, from wg, into a slot at wb
  auto stage_w = [&](const float* wg, float* wb, int kc) {
    if (kTransW) {                 // wide, W^T: [col][kk], quads by col / 4
      if (w4) {
        const int nq = kc >> 2;
        for (int i = tid; i < cols * nq; i += T::kThreads) {
          const int c = i / nq;
          const int q = i - c * nq;
          cp_async16(wb + c * kKChunk + 4 * (q ^ ((c >> 2) & 7)),
                     wg + (size_t)c * w_sc + 4 * q, true);
        }
      } else {
        for (int i = tid; i < cols * kc; i += T::kThreads) {
          const int c = i / kc;
          const int kk = i - c * kc;
          cp_async4(wb + c * kKChunk + quad_pos(kk, (c >> 2) & 7),
                    wg + (size_t)c * w_sc + kk, true);
        }
      }
    } else if (w4) {               // [kk][BN], rows of W 16 bytes at a time
      const int cq = cols >> 2;
      for (int i = tid; i < kc * cq; i += T::kThreads) {
        const int kk = i / cq;
        const int c = 4 * (i - kk * cq);
        cp_async16(wb + kk * BN + c, wg + (size_t)kk * w_sr + c, true);
      }
    } else {                       // [kk][BN], a float at a time, in
      for (int i = tid; i < kc * cols; i += T::kThreads) {   // W's order
        int kk, c;
        if (w_sc == 1) {
          kk = i / cols;
          c = i - kk * cols;
        } else {
          c = i / kc;
          kk = i - c * kc;
        }
        cp_async4(wb + kk * BN + c, wg + (size_t)kk * w_sr + (size_t)c * w_sc,
                  true);
      }
    }
  };

  // stage step s (its piece's rows, its groups' W chunks) into buffer buf
  auto issue = [&](const Step& s, int buf) {
    const int k0 = s.chunk * kKChunk;
    const int kc = min(kKChunk, k - k0);
    float* xb = xs + buf * T::kXStage;
    float* wb = ws + buf * T::kWStage;
    const int nr = s.hi - s.lo;
    if (x4) {
      const int nq = kc >> 2;
      for (int i = tid; i < nr * nq; i += T::kThreads) {
        const int rr = i / nq;
        const int q = i - rr * nq;
        const int src = s_src[s.lo + rr];
        if (src >= 0) {
          cp_async16(xb + rr * kKChunk + 4 * (q ^ T::x_key(rr)),
                     x + (size_t)src * k + k0 + 4 * q, true);
        }
      }
    } else {
      for (int i = tid; i < nr * kc; i += T::kThreads) {
        const int rr = i / kc;
        const int kk = i - rr * kc;
        const int src = s_src[s.lo + rr];
        if (src >= 0) {
          cp_async4(xb + rr * kKChunk + quad_pos(kk, T::x_key(rr)),
                    x + (size_t)src * k + k0 + kk, true);
        }
      }
    }
    int gprev = -1;
    for (int pp = portion(s.lo), slot = -1; pp <= portion(s.hi - 1); ++pp) {
      const int g = s_grp[pp];
      if (g == gprev) continue;
      gprev = g;
      ++slot;
      stage_w(w + (size_t)g * k * n + (size_t)k0 * w_sr + (size_t)col0 * w_sc,
              wb + slot * T::kWSlot, kc);
    }
  };

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  }
  const bool my_cols = 4 * tx < cols;
  Step in;                           // the next step to stage
  in.pos = 0;
  in.chunk = 0;
  next_piece(in);
  Step out = in;                     // the next step to multiply
  int n_in = 0;
  for (int s = 0; s < kGemmStages; ++s, ++n_in) {   // every stage in flight
    if (in.valid) {
      issue(in, n_in % kGemmStages);
      advance(in);
    }
    cp_async_commit();
  }
  int my_slot = 0;                   // narrow: the W slot of my row's group
  for (int n_out = 0; out.valid; ++n_out) {
    if (n_out == 0) {
      cp_async_wait<kGemmStages - 1>();   // step 0 has landed
      __syncthreads();
    } else {
      cp_async_wait<kGemmStages - 2>();   // step n_out has landed
      __syncthreads();                    // and step n_out - 1 is consumed:
      if (in.valid) {                     // its buffer takes the next step
        issue(in, n_in % kGemmStages);
        advance(in);
      }
      cp_async_commit();
      ++n_in;
    }
    if (T::kRuns > 1 && out.chunk == 0) {
      my_slot = slot_of(out.lo, min(out.lo + TR * ty, out.hi - 1));
    }
    if (my_cols && TR * ty < out.hi - out.lo) {
      const int buf = n_out % kGemmStages;
      const float* xb = xs + buf * T::kXStage + TR * ty * kKChunk;
      const float* wb = ws + buf * T::kWStage + my_slot * T::kWSlot;
      const int key = T::x_key(TR * ty);
      const int kc = min(kKChunk, k - out.chunk * kKChunk);
      const int kc4 = kc & ~3;
      for (int q = 0; q < (kc4 >> 2); ++q) {
        if (!kNarrow) {
          float wf[4][TC];           // W[4 q + u][col(tx, j)]
          if (kTransW) {
#pragma unroll
            for (int j = 0; j < TC; ++j) {
              const int c = T::col(tx, j);   // kk 4 q .. 4 q + 3 of c
              const float4 v = *reinterpret_cast<const float4*>(
                  wb + c * kKChunk + 4 * (q ^ ((c >> 2) & 7)));
              wf[0][j] = v.x;
              wf[1][j] = v.y;
              wf[2][j] = v.z;
              wf[3][j] = v.w;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int j = 0; j < TC; j += 4) {
                const float4 v = *reinterpret_cast<const float4*>(
                    wb + (4 * q + u) * BN + T::col(tx, j));
                wf[u][j] = v.x;
                wf[u][j + 1] = v.y;
                wf[u][j + 2] = v.z;
                wf[u][j + 3] = v.w;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                xb + i * kKChunk + 4 * (q ^ key));
#pragma unroll
            for (int j = 0; j < TC; ++j) {
              acc[i][j] = fmaf(v.x, wf[0][j], acc[i][j]);
              acc[i][j] = fmaf(v.y, wf[1][j], acc[i][j]);
              acc[i][j] = fmaf(v.z, wf[2][j], acc[i][j]);
              acc[i][j] = fmaf(v.w, wf[3][j], acc[i][j]);
            }
          }
        } else {
          const float4 v =
              *reinterpret_cast<const float4*>(xb + 4 * (q ^ key));
          const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int j = 0; j < TC; j += 4) {
              const float4 u4 = *reinterpret_cast<const float4*>(
                  wb + (4 * q + u) * BN + j);
              acc[0][j] = fmaf(xv[u], u4.x, acc[0][j]);
              acc[0][j + 1] = fmaf(xv[u], u4.y, acc[0][j + 1]);
              acc[0][j + 2] = fmaf(xv[u], u4.z, acc[0][j + 2]);
              acc[0][j + 3] = fmaf(xv[u], u4.w, acc[0][j + 3]);
            }
          }
        }
      }
      for (int kk = kc4; kk < kc; ++kk) {
        float wr[TC];
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int c = T::col(tx, j);
          wr[j] = kTransW ? wb[c * kKChunk + quad_pos(kk, (c >> 2) & 7)]
                          : wb[kk * BN + c];
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float v = xb[i * kKChunk + quad_pos(kk, key)];
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(v, wr[j], acc[i][j]);
        }
      }
    }
    if (out.chunk == nch - 1) {        // the piece's rows are done
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = out.lo + TR * ty + i;
        if (my_cols && r < out.hi) {
          const size_t row = (size_t)row0 + r;
          const bool zero = kGather && s_src[r] < 0;
          const float f = (scale != nullptr && !zero) ? scale[row] : 1.f;
          float v[TC];
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            v[j] = zero ? 0.f : (scale != nullptr ? acc[i][j] * f
                                                  : acc[i][j]);
          }
          float* yr = y + row * n + col0;
#pragma unroll
          for (int j = 0; j < TC; j += 4) {
            const int c = T::col(tx, j);
            if (y4 && c + 3 < cols) {
              *reinterpret_cast<float4*>(yr + c) =
                  make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
            } else {
#pragma unroll
              for (int u = 0; u < 4 && j + u < TC; ++u) {
                if (c + u < cols) yr[c + u] = v[j + u];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
      }
    }
    advance(out);
  }
}

// Narrow route at n = 1 (the attention products): a thread a row, and each
// warp on its own. A warp's 32 rows come in through its own two-stage
// cp.async ring in chunks of kKChunk reduction columns, 8 lanes a row (4
// rows an instruction, whole 128-byte lines), with no block-wide barrier;
// each lane then reads its row back (quads swizzled by row % 8, so the 8
// lanes of a phase hit 8 banks). W[t2g[row / tile]] is then one column of
// k floats, contiguous along the reduction (w_sr = 1 whether or not W is
// transposed), read 4 kk a word through the read-only cache (where a
// tile's rows share it) into registers as the chunk's rows are staged. A
// K1 row that gathers -1 is neither staged nor multiplied.
template <bool kGather>
__device__ __forceinline__ void column_body(
    const float* __restrict__ x, const float* __restrict__ w,
    const int* __restrict__ gidx, const int* __restrict__ t2g,
    const float* __restrict__ scale, float* __restrict__ y, int k, int n,
    int rp, int tile, int span, int w_sr, int w_sc, int vec) {
  extern __shared__ __align__(16) float gemm_smem[];  // [warp][stage][32][32]
  static_assert(kGemmStages == 2, "column_body turns two stages by hand");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kNarrowThreads + threadIdx.x;
  const int src = row < rp ? (kGather ? gidx[row] : row) : -1;
  float* ring = gemm_smem + warp * kGemmStages * 32 * kKChunk;
  const bool x4 = vec & kVecX;
  const bool w4 = vec & kVecWCol;
  const int nch = (k + kKChunk - 1) / kKChunk;
  // stage chunk c of the warp's rows: lane l copies quad l % 8 of rows
  // l / 8 + 4 i, i < 8 (16-byte copies), or, where k % 4 != 0, float l of
  // every row
  auto issue = [&](int c) {
    float* buf = ring + (c % kGemmStages) * 32 * kKChunk;
    const int k0 = c * kKChunk;
    const int kc = min(kKChunk, k - k0);
    if (x4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = lane / 8 + 4 * i;
        const int q = lane & 7;
        const int s = __shfl_sync(~0u, src, r);
        if (s >= 0 && 4 * q < kc) {
          cp_async16(buf + r * kKChunk + 4 * (q ^ (r & 7)),
                     x + (size_t)s * k + k0 + 4 * q, true);
        }
      }
    } else {
      for (int r = 0; r < 32; ++r) {
        const int s = __shfl_sync(~0u, src, r);
        if (s >= 0 && lane < kc) {
          cp_async4(buf + r * kKChunk + quad_pos(lane, r & 7),
                    x + (size_t)s * k + k0 + lane, true);
        }
      }
    }
  };
  if (__all_sync(~0u, src < 0)) {     // a warp of rows that gather -1
    if (row < rp) y[row] = 0.f;
    return;
  }
  const float* wc = w + (size_t)(src >= 0 ? t2g[row / tile] : 0) * k;
  // W's column for chunk c into registers, issued with the chunk's rows
  auto load_w = [&](float (&wr)[kKChunk], int c) {
    if (src < 0) return;
    const int k0 = c * kKChunk;
    const int kc = min(kKChunk, k - k0);
#pragma unroll
    for (int j = 0; j < kKChunk; j += 4) {
      if (j >= kc) break;
      if (w4) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(wc + k0 + j));
        wr[j] = u.x;
        wr[j + 1] = u.y;
        wr[j + 2] = u.z;
        wr[j + 3] = u.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u < kc) wr[j + u] = __ldg(wc + k0 + j + u);
        }
      }
    }
  };
  float acc = 0.f;
  // acc += chunk c of my row (staged by the warp) times W's column, in order
  auto mul = [&](const float (&wr)[kKChunk], int c) {
    const float* xr =
        ring + (c % kGemmStages) * 32 * kKChunk + lane * kKChunk;
    const int kc = min(kKChunk, k - c * kKChunk);
#pragma unroll
    for (int j = 0; j < kKChunk; j += 4) {
      if (j >= kc) break;
      if (j + 4 <= kc) {
        const float4 v = *reinterpret_cast<const float4*>(
            xr + 4 * ((j >> 2) ^ (lane & 7)));
        acc = fmaf(v.x, wr[j], acc);
        acc = fmaf(v.y, wr[j + 1], acc);
        acc = fmaf(v.z, wr[j + 2], acc);
        acc = fmaf(v.w, wr[j + 3], acc);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u < kc) acc = fmaf(xr[quad_pos(j + u, lane & 7)], wr[j + u],
                                     acc);
        }
      }
    }
  };
  // two stages in turn (chunk c in ring buffer c % 2, W in wa / wb); each
  // step commits one group after its multiply, so one group stays pending
  float wa[kKChunk], wb[kKChunk];
  issue(0);
  load_w(wa, 0);
  cp_async_commit();
  if (nch > 1) {
    issue(1);
    load_w(wb, 1);
  }
  cp_async_commit();
  for (int c = 0; c < nch; c += 2) {
    cp_async_wait<kGemmStages - 1>();
    __syncwarp();                     // the warp's copies of chunk c landed
    if (src >= 0) mul(wa, c);
    __syncwarp();                     // chunk c is read: its buffer is free
    if (c + 2 < nch) {
      issue(c + 2);
      load_w(wa, c + 2);
    }
    cp_async_commit();
    if (c + 1 == nch) break;
    cp_async_wait<kGemmStages - 1>();
    __syncwarp();
    if (src >= 0) mul(wb, c + 1);
    __syncwarp();
    if (c + 3 < nch) {
      issue(c + 3);
      load_w(wb, c + 3);
    }
    cp_async_commit();
  }
  if (row < rp) {
    y[row] = src < 0 ? 0.f : (scale != nullptr ? acc * scale[row] : acc);
  }
}

#define GEMM_PARAMS                                                       \
  const float* __restrict__ x, const float* __restrict__ w,               \
      const int* __restrict__ gidx, const int* __restrict__ t2g,          \
      const float* __restrict__ scale, float* __restrict__ y, int k,      \
      int n, int rp, int tile, int span, int w_sr, int w_sc, int vec
#define GEMM_ARGS x, w, gidx, t2g, scale, y, k, n, rp, tile, span, w_sr, \
                  w_sc, vec

// the wide route's tiling at TM rows a thread
template <int TM>
using WideTiling = Tiling<TM, TM == 8 ? 8 : 4, 16, TM == 8 ? 8 : 16>;

template <int TM>
__global__ void __launch_bounds__(WideTiling<TM>::kThreads,
                                  TM == 8 ? 3 : 2)
segment_mm_gather_wide(GEMM_PARAMS) {
  gemm_body<true, false, WideTiling<TM>>(GEMM_ARGS);
}

template <bool kTransW, int TM>
__global__ void __launch_bounds__(WideTiling<TM>::kThreads,
                                  TM == 8 ? 3 : 2)
segment_mm_padded_wide(GEMM_PARAMS) {
  gemm_body<false, kTransW, WideTiling<TM>>(GEMM_ARGS);
}

// the narrow route's tiling at NC columns a thread
template <int NC>
using NarrowTiling = Tiling<1, NC, kNarrowThreads, 1>;

template <int NC>
__global__ void __launch_bounds__(kNarrowThreads)
segment_mm_gather_narrow(GEMM_PARAMS) {
  if constexpr (NC == 1) {
    column_body<true>(GEMM_ARGS);
  } else {
    gemm_body<true, false, NarrowTiling<NC>>(GEMM_ARGS);
  }
}

template <int NC>
__global__ void __launch_bounds__(kNarrowThreads)
segment_mm_padded_narrow(GEMM_PARAMS) {
  if constexpr (NC == 1) {
    column_body<false>(GEMM_ARGS);
  } else {
    gemm_body<false, false, NarrowTiling<NC>>(GEMM_ARGS);
  }
}

#undef GEMM_PARAMS
#undef GEMM_ARGS

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising its
// limit first on each device it has not yet run on (`ready`: a bit a
// device, one word a kernel).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, unsigned long long& ready, dim3 grid,
                   int threads, int smem, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready & bit)) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The `ready` word of one kernel instantiation.
template <bool kGather, bool kTransW, int kRoute, int kPer>
unsigned long long& ready_bits() {
  static unsigned long long bits = 0;
  return bits;
}

// K1 (gather) or K4 as the wrapper planned it: `route` wide (TM =
// per_thread rows of 4 columns a thread) or narrow (NC = per_thread >= n
// columns of one row a thread), `span` rows a block. `aligned`: bit 0, x is
// 16-byte aligned; bit 1, w is.
template <bool kGather>
cudaError_t launch_gemm(const float* x, const float* w, const int* gidx,
                        const int* t2g, const float* scale, float* y, int k,
                        int n, int rp, int tile, int route, int per_thread,
                        int span, int aligned, bool transpose,
                        cudaStream_t stream) {
  if (rp <= 0 || n <= 0 || k <= 0 || tile <= 0 || span <= 0 ||
      span > kSpanMax || (kGather && transpose)) {
    return cudaErrorInvalidValue;
  }
  const int w_sr = transpose ? 1 : n;
  const int w_sc = transpose ? k : 1;
  const bool wa = aligned & 2;
  int vec = ((aligned & 1) && k % 4 == 0) ? kVecX : 0;
  if (n % 4 == 0) vec |= kVecY;
  if (wa && (transpose ? k % 4 == 0 : n % 4 == 0)) vec |= kVecW;
#define GEMM_ARGS x, w, gidx, t2g, scale, y, k, n, rp, tile, span, w_sr, \
                  w_sc, vec
  if (route == kRouteWide) {
    if (span % (16 * per_thread)) return cudaErrorInvalidValue;
    const dim3 grid((rp + span - 1) / span, (n + kWideCols - 1) / kWideCols);
    static_assert(WideTiling<2>::kCols == kWideCols &&
                      WideTiling<8>::kCols == kWideCols,
                  "a wide block covers kWideCols columns");
    if (per_thread == 2) {
      constexpr int smem = WideTiling<2>::kSmem;
      constexpr int threads = WideTiling<2>::kThreads;
      return kGather
                 ? launch(segment_mm_gather_wide<2>,
                          ready_bits<true, false, kRouteWide, 2>(), grid,
                          threads, smem, stream, GEMM_ARGS)
             : transpose
                 ? launch(segment_mm_padded_wide<true, 2>,
                          ready_bits<false, true, kRouteWide, 2>(), grid,
                          threads, smem, stream, GEMM_ARGS)
                 : launch(segment_mm_padded_wide<false, 2>,
                          ready_bits<false, false, kRouteWide, 2>(), grid,
                          threads, smem, stream, GEMM_ARGS);
    }
    if (per_thread == 8) {
      constexpr int smem = WideTiling<8>::kSmem;
      constexpr int threads = WideTiling<8>::kThreads;
      return kGather
                 ? launch(segment_mm_gather_wide<8>,
                          ready_bits<true, false, kRouteWide, 8>(), grid,
                          threads, smem, stream, GEMM_ARGS)
             : transpose
                 ? launch(segment_mm_padded_wide<true, 8>,
                          ready_bits<false, true, kRouteWide, 8>(), grid,
                          threads, smem, stream, GEMM_ARGS)
                 : launch(segment_mm_padded_wide<false, 8>,
                          ready_bits<false, false, kRouteWide, 8>(), grid,
                          threads, smem, stream, GEMM_ARGS);
    }
    return cudaErrorInvalidValue;
  }
  if (route != kRouteNarrow || n > per_thread) return cudaErrorInvalidValue;
  if (transpose) vec &= ~kVecW;           // a W^T row is not contiguous
  if (wa && per_thread == 1 && w_sr == 1 && k % 4 == 0) vec |= kVecWCol;
  if (per_thread == 1) {
    const dim3 grid((rp + kNarrowThreads - 1) / kNarrowThreads);
    return kGather ? launch(segment_mm_gather_narrow<1>,
                            ready_bits<true, false, kRouteNarrow, 1>(), grid,
                            kNarrowThreads, kColumnSmem, stream, GEMM_ARGS)
                   : launch(segment_mm_padded_narrow<1>,
                            ready_bits<false, false, kRouteNarrow, 1>(), grid,
                            kNarrowThreads, kColumnSmem, stream, GEMM_ARGS);
  }
  if (span % kNarrowThreads) return cudaErrorInvalidValue;
  const dim3 grid((rp + span - 1) / span);
#define NARROW(NC)                                                          \
  (kGather ? launch(segment_mm_gather_narrow<NC>,                           \
                    ready_bits<true, false, kRouteNarrow, NC>(), grid,      \
                    kNarrowThreads, NarrowTiling<NC>::kSmem, stream,        \
                    GEMM_ARGS)                                              \
           : launch(segment_mm_padded_narrow<NC>,                           \
                    ready_bits<false, false, kRouteNarrow, NC>(), grid,     \
                    kNarrowThreads, NarrowTiling<NC>::kSmem, stream,        \
                    GEMM_ARGS))
  switch (per_thread) {
    case 4: return NARROW(4);
    case 8: return NARROW(8);
    case 16: return NARROW(16);
    default: return cudaErrorInvalidValue;
  }
#undef NARROW
#undef GEMM_ARGS
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

// K1. x [nx, k], w [R, k, n], gidx [rp], t2g [>= rp / tile], scale [rp] or
// null, y [rp, n]; all contiguous on one device. `route`, `per_thread` and
// `span` as segment_mm.py::gemm_plan gives them (route 0: wide, TM =
// per_thread rows a thread; 1: narrow, NC = per_thread columns a thread;
// span rows a block); `aligned` bit 0: x is 16-byte aligned, bit 1: w is.
// Launches on `stream`; returns the launch's error.
extern "C" int segment_mm_gather_f32(const float* x, const float* w,
                                     const int* gidx, const int* t2g,
                                     const float* scale, float* y, int k,
                                     int n, int rp, int tile, int route,
                                     int per_thread, int span, int aligned,
                                     void* stream) {
  return static_cast<int>(launch_gemm<true>(
      x, w, gidx, t2g, scale, y, k, n, rp, tile, route, per_thread, span,
      aligned, false, static_cast<cudaStream_t>(stream)));
}

// K4. x [rp, kd], w [R, kd, n] or, with `transpose`, [R, n, kd] read as
// its transpose (the dX of a GEMM); t2g [>= rp / tile], scale [rp] or
// null, y [rp, n]; the rest as K1's.
extern "C" int segment_mm_padded_f32(const float* x, const float* w,
                                     const int* t2g, const float* scale,
                                     float* y, int kd, int n, int rp,
                                     int tile, int route, int per_thread,
                                     int span, int aligned, int transpose,
                                     void* stream) {
  return static_cast<int>(launch_gemm<false>(
      x, w, nullptr, t2g, scale, y, kd, n, rp, tile, route, per_thread, span,
      aligned, transpose != 0, static_cast<cudaStream_t>(stream)));
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
