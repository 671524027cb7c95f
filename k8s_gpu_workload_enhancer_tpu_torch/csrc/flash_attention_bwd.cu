// Causal flash-attention backward for Hopper: three kernels.
//
// Replaces, in k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py (driven
// from _flash_backward_flat):
//   - _flash_bwd_dq_kernel: dQ = sum_k dS K with dS = P * (dO V^T - delta)
//     * scale, P = exp(S - lse) recomputed from the forward's LSE, and the
//     optional p/ds stash (B*H, Sq, Sk) for the dK/dV pass, the tiles past
//     the causal range written as zeros;
//   - _flash_bwd_dkv_from_stash_kernel: dV = P^T dO, dK = dS^T Q read from
//     that stash;
//   - _flash_bwd_dkv_kernel: dK/dV with S, P and dP recomputed.
// Every body repeats the TPU kernels' rounding points: f32 scores times
// scale, NEG_INF = -1e30 past the diagonal (global positions q_offset + i
// >= kv_offset + j), P = exp(S - lse) (a fully masked row has lse =
// LSE_MASKED, so its P is exactly 0), dS = (P * (dP - delta)) * scale
// rounded to q's dtype before the dQ and dK products, P rounded to dO's
// dtype before the dV product, f32 accumulation. The tensors keep the
// model's (B, S, H, D) layout; lse and delta are (B, H, Sq) f32. Heads are
// MHA: the caller expands GQA first, as the TPU kernels require.
//
// Bound: operations. dQ is three products (S, dP, dS K) and the recompute
// dK/dV four (S, dP, P^T dO, dS^T Q), each 2 D flops a visible (query, key)
// pair: at the trainer's shape (B 8, S 2048, 16 heads of 128, causal) 206
// and 275 GFLOP against ~0.3 GB, 0.209 and 0.278 ms at the bf16
// tensor-core rate. The bodies are chosen explicitly in launch<W>, by
// dtype and head_dim (wgmma_body, exported as ktwe_flash_bwd_wgmma for
// the wrappers' counts); none is a fallback for another.
//
// bf16 dQ and recompute dK/dV at head_dim <= 128 (tc::): tensor cores
// (wgmma) on tiles that TMA loads under mbarriers (csrc/sm90.cuh). A block
// owns 128 rows of one (batch, head) -- query rows for dQ, key rows for
// dK/dV -- as two consumer warpgroups of 64 rows, and a producer warpgroup
// whose one thread streams the other side's 64-row tiles through a
// two-stage ring (setmaxnreg: producer 24 registers, consumers 240). Tiles
// are two TMA boxes of 64 head-dim columns (128-byte swizzle) on 4-D maps
// over (B, S, H, D); TMA's zero fill gives the rows past Sq/Sk and the
// columns past D (the whole second box at D <= 64). The loop over the
// streamed tiles is the TPU grid's sequential axis: the sums stay in
// registers, no atomics, so both outputs are the same run to run. dQ:
// S = Q K^T and dP = dO V^T (K-major), then dQ += dS K with dS as bf16
// register fragments and K's tile read MN-major through a second
// descriptor. dK/dV: the products are transposed so that keys are wgmma's
// M (S^T = K Q^T, dP^T = V dO^T), then dV += P^T dO and dK += dS^T Q with
// dO and Q MN-major. Each query tile's lse and delta (rows past Sq as
// LSE_MASKED and 0: never what lies past the arrays) reach the dK/dV
// consumers through shared memory, fetched a tile ahead. Tiles wholly past
// the diagonal are skipped, the edge tiles masked with 32-bit column
// limits; the heaviest causal tiles launch first (dQ: the last query
// tiles, dK/dV: the first key tiles). Shared memory: 2 x 32 KB resident +
// 2 stages x 2 x 16 KB = 129 KB dynamic, plus 5.1 KB (dQ) and 8.1 KB
// (dK/dV) static. `-Xptxas -v` (CUDA 12.8): 168 registers at launch, up to
// R237 in the consumers; dQ spills nothing, dK/dV (dK, dV, S^T and dP^T
// are 192 registers a thread) 132-152 bytes, on the recheck path.
//
// The in-order recheck. P and dS are rounded to bf16 before the products,
// so a sum S or dP that differs in its last bits from the plain version's
// can flip their roundings: measured on the card, hundreds of output
// entries at the trainer's shape then leave the backward limits (one
// rounding of the output). The plain version's f32 products (cuBLAS)
// sum in head-dim order as one FMA chain, as the f32-pipe bodies do, and
// the tensor cores sum in another order. So the elementwise pass computes
// p (ex2.approx on log2(e)-scaled arguments: it flushes p below 2^-126 to
// 0, where the plain version's p is a subnormal) and ds from the
// tensor-core sums and flags each element whose f32 value lies within a
// margin of a bf16 rounding boundary (`probs`): the sums differ by at most
// kChainErr |q| |k| (4 f32 roundings of the product of the rows' norms,
// which bounds the sum of the terms' magnitudes), plus the argument's and
// the exponentials' roundings, plus for ds that of dP over |dP - delta|.
// A warp's flagged elements (1.6 % at the trainer's shape) are rechecked
// 32 at a time, one a lane (`recheck`): S and dP as FMA chains in
// head-dim order from the tiles in shared memory, p with expf and ds with
// the plain version's steps. P and dS then round as the plain version's
// do: at the card's shapes the p/ds stash equals it bit for bit, and dQ,
// dK, dV differ from it only by the order of their final f32 sums.
//
// f32, and bf16 above head_dim 128: the f32 pipes (the f32 training gates
// need true f32 products, which TF32 wgmma would not give). One block of
// 256 threads owns a tile of rows and walks the other side's tiles inside
// the block, keeping its output accumulators in registers. Every product
// is a register-tiled outer product out of shared memory: both operands
// are stored k-major in f32 (the tile loads transpose and convert once),
// so each step of the contraction loads a few float2/float4 words and
// issues 8-32 FMAs per thread; the D-wide accumulators' columns are spread
// so that those words never share a bank (`acc_col`). A thread owns the
// same rows in the score tile and in its accumulator tile, so its rows'
// lse and delta stay in registers. Head dims up to 64, 128, 256 and 512
// are four instantiations (bf16 only 256 and 512 for dQ and dK/dV; the
// stash dK/dV all four) with tiles sized so the shared memory fits one
// block: 223 KB at 256 with 32-row tiles; at 512 (the flagship's 4 heads
// of 512) 16-row tiles on both sides, each thread owning one score, taken
// as a dot product of two row-major rows 16 bytes at a time (no k-major
// copies of q, k, v or dO: 130 KB for dQ, 131 KB for dK/dV), and 32
// columns of its accumulator rows.
//
// Not done yet: tensor-core bodies for dQ at head_dim 512 and for the stash
// dK/dV kernel (both head-dim instances), which need their own tiles (64 x
// 512 bf16 tiles of Q, dO, K and V do not fit in 227 KB together); the
// recompute dK/dV at 512 (off the main path); overlapping one tile's
// elementwise pass and recheck with the next tile's products inside a
// warpgroup. Times beside the bound and SDPA: PERF.md, section 6, rows 7-9.
#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

using namespace ktwe;

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads over each output tile
constexpr float kNegInf = -1e30f;
constexpr float kLseMasked = 1e30f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  void* p_stash;   // (B*H, Sq, Sk) in dO's dtype, or null
  void* ds_stash;  // (B*H, Sq, Sk) in q's dtype, or null
  int sq, sk, h, d;
  int causal;
  long long q_offset, kv_offset;
  float scale;
};

// Tile sizes by the head-dim bound DMAX: BR rows owned by the block, BC
// rows of the other side per step of its loop, and the padding P of the
// k-major (transposed) tiles' rows. ROWDOT: each thread owns one score of
// the 16 x 16 tiles, taken as a dot product of two row-major rows 16 bytes
// at a time (`row_dot`), so the score products read no k-major copies.
template <int DMAX> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int BR = 64, BC = 32, P = 4;
  static constexpr bool ROWDOT = false;
};
template <> struct Tiles<128> {
  static constexpr int BR = 64, BC = 32, P = 4;
  static constexpr bool ROWDOT = false;
};
template <> struct Tiles<256> {
  static constexpr int BR = 32, BC = 32, P = 4;
  static constexpr bool ROWDOT = false;
};
template <> struct Tiles<512> {
  static constexpr int BR = 16, BC = 16, P = 1;
  static constexpr bool ROWDOT = true;
};

// sum_{k < K} a[k] * b[k] in k order with FMAs (the order of `outer_mma`),
// both rows in shared memory, 16-byte aligned, K a multiple of 4.
__device__ __forceinline__ float row_dot(const float* __restrict__ a, const float* __restrict__ b,
                                         int K) {
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
    const float4 y = *reinterpret_cast<const float4*>(b + k);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// The D-wide accumulator products give thread tx of the 16 across a tile
// the columns tx * 4 + kSpread * g + e (g < TD / 4, e < 4): each step of a
// contraction then reads 16-byte words that neighbouring threads take from
// neighbouring addresses, free of shared-memory bank conflicts at any D.
constexpr int kSpread = 16 * 4;

__device__ __forceinline__ int acc_col(int tx, int j) {
  return tx * 4 + (j / 4) * kSpread + j % 4;
}

// acc[i][j] += sum_{k < K} A[k * lda + m0 + i] * B[k * ldb + col(j)]: a
// register-tiled outer product over operands stored k-major in shared memory,
// col(j) = n0 + j, or with kSpreadCols the spread columns n0 + kSpread * (j /
// 4) + j % 4 of `acc_col` (n0 = tx * 4). Every sum runs in k order.
template <int TM, int TN, bool kSpreadCols = false>
__device__ __forceinline__ void outer_mma(const float* __restrict__ A, int lda, int m0,
                                          const float* __restrict__ B, int ldb, int n0, int K,
                                          float (&acc)[TM][TN]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
    load_row<TM>(A + k * lda + m0, a);
    if constexpr (kSpreadCols) {
      static_assert(TN % 4 == 0, "spread columns come in groups of 4");
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(B + k * ldb + n0 + g * kSpread);
        b[4 * g] = t.x;
        b[4 * g + 1] = t.y;
        b[4 * g + 2] = t.z;
        b[4 * g + 3] = t.w;
      }
    } else {
      load_row<TN>(B + k * ldb + n0, b);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Load rows [row0, row0 + ROWS) of a (S, H, D) tensor's head slice `base`
// (rows >= n_valid and columns >= d read as 0) into shared f32: `tr`
// transposed ([DMAX][ltr], column-major over rows) and/or `rm` row-major
// ([ROWS][lrm]). Consecutive threads take consecutive rows, so the
// transposed stores fall in consecutive banks.
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, long long row_stride,
                                          int row0, int n_valid, int d, float* tr, int ltr,
                                          float* rm, int lrm) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = DMAX / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += kThreads) {
    const int r = idx % ROWS;
    const int c = (idx / ROWS) * kVec;
    float f[kVec];
    if (row0 + r < n_valid && c < d) {
      const Vec<T, kVec> v = load_vec<T, kVec>(base + (row0 + r) * row_stride + c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = to_f(v.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    if (tr != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tr[(c + e) * ltr + r] = f[e];
    }
    if (rm != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(rm + r * lrm + c + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int r, int c) {
  return c < a.sk && (!a.causal || a.q_offset + r >= a.kv_offset + c);
}

// ---------------------------------------------------------------------------
// dQ (and the optional p/ds stash): query tile resident, key tiles stream.
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t dq_smem_floats() {
  constexpr int BQ = Tiles<DMAX>::BR, BK = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  if constexpr (Tiles<DMAX>::ROWDOT) {
    return 2 * BQ * (DMAX + 4) + 2 * BK * (DMAX + 4) + BK * (BQ + P);
  }
  return 2 * DMAX * (BQ + P) + 2 * DMAX * (BK + P) + BK * (DMAX + 4) + BK * (BQ + P);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BQ = Tiles<DMAX>::BR, BK = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  constexpr int LQ = BQ + P, LK = BK + P, LD = DMAX + 4;
  constexpr int TM = BQ / 16, TN = BK / 16, TD = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  constexpr bool RD = Tiles<DMAX>::ROWDOT;
  // k-major tiles [DMAX][LQ or LK], or with ROWDOT row-major ones [rows][LD].
  float *qT = nullptr, *doT = nullptr, *kT = nullptr, *vT = nullptr;
  float *qR = nullptr, *doR = nullptr, *vR = nullptr, *kR, *dsT;
  if constexpr (RD) {
    qR = smem;
    doR = qR + BQ * LD;
    kR = doR + BQ * LD;
    vR = kR + BK * LD;
    dsT = vR + BK * LD;            // [BK][LQ]
  } else {
    qT = smem;
    doT = qT + DMAX * LQ;
    kT = doT + DMAX * LQ;
    vT = kT + DMAX * LK;
    kR = vT + DMAX * LK;           // [BK][LD]
    dsT = kR + BK * LD;            // [BK][LQ]
  }

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = a.d;
  const long long rs = static_cast<long long>(a.h) * d;  // between sequence rows
  const long long bh = static_cast<long long>(batch) * a.h + head;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* gb = static_cast<const T*>(a.dout) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(batch) * a.sk * rs + head * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(batch) * a.sk * rs + head * d;

  load_tile<T, BQ, DMAX>(qb, rs, q0, a.sq, d, qT, LQ, qR, LD);
  load_tile<T, BQ, DMAX>(gb, rs, q0, a.sq, d, doT, LQ, doR, LD);
  float lse_r[TM], delta_r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    lse_r[i] = r < a.sq ? a.lse[bh * a.sq + r] : kLseMasked;
    delta_r[i] = r < a.sq ? a.delta[bh * a.sq + r] : 0.f;
  }
  float acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  // Key tiles this query tile needs: causal stops at the tile holding the
  // largest key position its last row may see.
  const int total_tiles = (a.sk + BK - 1) / BK;
  int n_tiles = total_tiles;
  if (a.causal) {
    const int q_last = min(q0 + BQ, a.sq) - 1;
    const long long last_key = a.q_offset + q_last - a.kv_offset;
    const long long need = last_key / BK + 1;
    n_tiles = last_key < 0 ? 0 : (need < total_tiles ? static_cast<int>(need) : total_tiles);
  }
  T* p_st = static_cast<T*>(a.p_stash);
  T* ds_st = static_cast<T*>(a.ds_stash);
  const long long st_base = bh * a.sq * static_cast<long long>(a.sk);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done with kT/vT/kR/dsT
    load_tile<T, BK, DMAX>(kb, rs, k0, a.sk, d, kT, LK, kR, LD);
    load_tile<T, BK, DMAX>(vb, rs, k0, a.sk, d, vT, LK, vR, LD);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    if constexpr (RD) {
      s[0][0] = row_dot(qR + ty * LD, kR + tx * LD, d);
      dp[0][0] = row_dot(doR + ty * LD, vR + tx * LD, d);
    } else {
      outer_mma<TM, TN>(qT, LQ, ty * TM, kT, LK, tx * TN, d, s);
      outer_mma<TM, TN>(doT, LQ, ty * TM, vT, LK, tx * TN, d, dp);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = q0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx * TN + j;
        const float sv = visible(a, r, c) ? __fmul_rn(s[i][j], a.scale) : kNegInf;
        const float p = expf(sv - lse_r[i]);
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], delta_r[i])), a.scale);
        const T ds_t = from_f<T>(ds);
        dsT[(tx * TN + j) * LQ + ty * TM + i] = to_f(ds_t);
        if (p_st != nullptr && r < a.sq && c < a.sk) {
          const long long at = st_base + static_cast<long long>(r) * a.sk + c;
          p_st[at] = from_f<T>(p);
          ds_st[at] = ds_t;
        }
      }
    }
    __syncthreads();
    outer_mma<TM, TD, true>(dsT, LQ, ty * TM, kR, LD, tx * 4, BK, acc);
  }

  // Stash tiles past the causal range hold zeros, as the TPU kernel leaves
  // them, so a reader of wider tiles finds no garbage.
  if (p_st != nullptr && n_tiles < total_tiles) {
    const int c_start = n_tiles * BK;
    const int width = a.sk - c_start;
    const int q_rows = min(BQ, a.sq - q0);
    const T zero = from_f<T>(0.f);
    for (long long idx = threadIdx.x; idx < static_cast<long long>(q_rows) * width;
         idx += kThreads) {
      const int r = static_cast<int>(idx / width);
      const int c = c_start + static_cast<int>(idx - static_cast<long long>(r) * width);
      const long long at = st_base + static_cast<long long>(q0 + r) * a.sk + c;
      p_st[at] = zero;
      ds_st[at] = zero;
    }
  }

  T* dqb = static_cast<T*>(a.dq) + static_cast<long long>(batch) * a.sq * rs + head * d;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r < a.sq) {
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int c = acc_col(tx, j);
        if (c < d) dqb[r * rs + c] = from_f<T>(acc[i][j]);
      }
    }
  }
}

// First query tile (of height BQ) that can see key row k0 under the causal
// mask; the number of query tiles when none can.
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0, int BQ) {
  if (!a.causal) return 0;
  const long long first_row = a.kv_offset + k0 - a.q_offset;
  if (first_row <= 0) return 0;
  if (first_row >= a.sq) return (a.sq + BQ - 1) / BQ;
  return static_cast<int>(first_row / BQ);
}

template <typename T, int TM, int TD>
__device__ __forceinline__ void store_kv(const BwdArgs& a, int k0, int ty, int tx,
                                         const float (&acc_k)[TM][TD],
                                         const float (&acc_v)[TM][TD]) {
  const int d = a.d;
  const long long rs = static_cast<long long>(a.h) * d;
  const long long off = static_cast<long long>(blockIdx.z) * a.sk * rs + blockIdx.y * d;
  T* dkb = static_cast<T*>(a.dk) + off;
  T* dvb = static_cast<T*>(a.dv) + off;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = k0 + ty * TM + i;
    if (c < a.sk) {
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int col = acc_col(tx, j);
        if (col < d) {
          dkb[c * rs + col] = from_f<T>(acc_k[i][j]);
          dvb[c * rs + col] = from_f<T>(acc_v[i][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV with S, P and dP recomputed: key tile resident, query tiles stream.
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t dkv_smem_floats() {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  if constexpr (Tiles<DMAX>::ROWDOT) {
    return 2 * BKV * (DMAX + 4) + 2 * BQ * (DMAX + 4) + 2 * BQ * (BKV + P);
  }
  return 2 * DMAX * (BKV + P) + 2 * DMAX * (BQ + P) + 2 * BQ * (DMAX + 4) + 2 * BQ * (BKV + P);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  constexpr int LC = BKV + P, LR = BQ + P, LD = DMAX + 4;
  constexpr int TM = BKV / 16, TN = BQ / 16, TD = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  constexpr bool RD = Tiles<DMAX>::ROWDOT;
  // k-major key and query tiles [DMAX][LC or LR], or with ROWDOT row-major
  // key tiles [BKV][LD]; row-major query tiles [BQ][LD] either way.
  float *kT = nullptr, *vT = nullptr, *qT = nullptr, *doT = nullptr;
  float *kR = nullptr, *vR = nullptr, *qR;
  if constexpr (RD) {
    kR = smem;
    vR = kR + BKV * LD;
    qR = vR + BKV * LD;
  } else {
    kT = smem;
    vT = kT + DMAX * LC;
    qT = vT + DMAX * LC;
    doT = qT + DMAX * LR;
    qR = doT + DMAX * LR;
  }
  float* doR = qR + BQ * LD;    // [BQ][LD]
  float* pR = doR + BQ * LD;    // [BQ][LC]
  float* dsR = pR + BQ * LC;    // [BQ][LC]
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int k0 = blockIdx.x * BKV;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = a.d;
  const long long rs = static_cast<long long>(a.h) * d;
  const long long bh = static_cast<long long>(batch) * a.h + head;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* gb = static_cast<const T*>(a.dout) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(batch) * a.sk * rs + head * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(batch) * a.sk * rs + head * d;

  load_tile<T, BKV, DMAX>(kb, rs, k0, a.sk, d, kT, LC, kR, LD);
  load_tile<T, BKV, DMAX>(vb, rs, k0, a.sk, d, vT, LC, vR, LD);
  float acc_k[TM][TD], acc_v[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  const int n_q_tiles = (a.sq + BQ - 1) / BQ;
  for (int t = first_q_tile(a, k0, BQ); t < n_q_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_tile<T, BQ, DMAX>(qb, rs, q0, a.sq, d, qT, LR, qR, LD);
    load_tile<T, BQ, DMAX>(gb, rs, q0, a.sq, d, doT, LR, doR, LD);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < a.sq ? a.lse[bh * a.sq + r] : kLseMasked;
      delta_s[threadIdx.x] = r < a.sq ? a.delta[bh * a.sq + r] : 0.f;
    }
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    if constexpr (RD) {
      s[0][0] = row_dot(kR + ty * LD, qR + tx * LD, d);    // S^T[c][r]
      dp[0][0] = row_dot(vR + ty * LD, doR + tx * LD, d);  // dP^T[c][r]
    } else {
      outer_mma<TM, TN>(kT, LC, ty * TM, qT, LR, tx * TN, d, s);   // S^T[c][r]
      outer_mma<TM, TN>(vT, LC, ty * TM, doT, LR, tx * TN, d, dp);  // dP^T[c][r]
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int c = k0 + ty * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int lr = tx * TN + j;
        const float sv = visible(a, q0 + lr, c) ? __fmul_rn(s[i][j], a.scale) : kNegInf;
        const float p = expf(sv - lse_s[lr]);
        const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], delta_s[lr])), a.scale);
        pR[lr * LC + ty * TM + i] = to_f(from_f<T>(p));
        dsR[lr * LC + ty * TM + i] = to_f(from_f<T>(ds));
      }
    }
    __syncthreads();
    outer_mma<TM, TD, true>(pR, LC, ty * TM, doR, LD, tx * 4, BQ, acc_v);   // dV += P^T dO
    outer_mma<TM, TD, true>(dsR, LC, ty * TM, qR, LD, tx * 4, BQ, acc_k);   // dK += dS^T Q
  }
  store_kv<T, TM, TD>(a, k0, ty, tx, acc_k, acc_v);
}

// ---------------------------------------------------------------------------
// dK/dV from the p/ds stash: two products per query tile, nothing recomputed.
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t dkv_stash_smem_floats() {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  return 2 * BQ * (DMAX + 4) + 2 * BQ * (BKV + P);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_stash_kernel(BwdArgs a) {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC, P = Tiles<DMAX>::P;
  constexpr int LC = BKV + P, LD = DMAX + 4;
  constexpr int TM = BKV / 16, TD = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* qR = smem;            // [BQ][LD]
  float* doR = qR + BQ * LD;   // [BQ][LD]
  float* pR = doR + BQ * LD;   // [BQ][LC]
  float* dsR = pR + BQ * LC;   // [BQ][LC]

  const int k0 = blockIdx.x * BKV;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int d = a.d;
  const long long rs = static_cast<long long>(a.h) * d;
  const long long bh = static_cast<long long>(batch) * a.h + head;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* gb = static_cast<const T*>(a.dout) + static_cast<long long>(batch) * a.sq * rs + head * d;
  const T* p_st = static_cast<const T*>(a.p_stash) + bh * a.sq * static_cast<long long>(a.sk);
  const T* ds_st = static_cast<const T*>(a.ds_stash) + bh * a.sq * static_cast<long long>(a.sk);

  float acc_k[TM][TD], acc_v[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }
  const int n_q_tiles = (a.sq + BQ - 1) / BQ;
  for (int t = first_q_tile(a, k0, BQ); t < n_q_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_tile<T, BQ, DMAX>(qb, rs, q0, a.sq, d, nullptr, 0, qR, LD);
    load_tile<T, BQ, DMAX>(gb, rs, q0, a.sq, d, nullptr, 0, doR, LD);
    for (int idx = threadIdx.x; idx < BQ * BKV; idx += kThreads) {
      const int r = idx / BKV, c = idx % BKV;
      const bool in = q0 + r < a.sq && k0 + c < a.sk;
      const long long at = static_cast<long long>(q0 + r) * a.sk + k0 + c;
      pR[r * LC + c] = in ? to_f(p_st[at]) : 0.f;
      dsR[r * LC + c] = in ? to_f(ds_st[at]) : 0.f;
    }
    __syncthreads();
    outer_mma<TM, TD, true>(pR, LC, ty * TM, doR, LD, tx * 4, BQ, acc_v);
    outer_mma<TM, TD, true>(dsR, LC, ty * TM, qR, LD, tx * 4, BQ, acc_k);
  }
  store_kv<T, TM, TD>(a, k0, ty, tx, acc_k, acc_v);
}

enum Which { kDq = 0, kDkv = 1, kDkvStash = 2 };

// ---------------------------------------------------------------------------
// bf16 bodies at head_dim <= 128: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace ktwe::sm90;

constexpr int kConsumers = 2;                   // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kDPad = 128;                      // widest head_dim taken
constexpr int kBoxes = kDPad / kSwizzleCols;    // 64-column boxes a tile row
constexpr int kRows = 64 * kConsumers;          // rows a block owns
constexpr int kStream = 64;                     // rows of the other side a tile
constexpr int kStages = 2;                      // ring depth of the streamed tiles
constexpr int kOwnBytes = kRows * kDPad * 2;    // one resident tile (Q, dO or K, V)
constexpr int kTileBytes = kStream * kDPad * 2; // one streamed tile
constexpr int kSmem = 2 * kOwnBytes + 2 * kStages * kTileBytes + kAtomBytes;  // + alignment
// Allowance for |tensor-core sum - in-order FMA chain| of a D-term dot
// product, per unit of the product of the two rows' norms (which bounds the
// sum of the terms' magnitudes): 4 f32 roundings' worth.
constexpr float kChainErr = 4.f / 16777216.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kTwo24 = 16777216.f;            // f32 ulps per unit of relative error, at most
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* out0;          // dQ, or dK
  void* out1;          // dV (dK/dV only)
  void* p_stash;       // (B*H, Sq, Sk) or null (dQ only)
  void* ds_stash;
  int sq, sk, h, d;
  int causal;
  long long q_offset, kv_offset;
  float scale;
  int n_tiles;         // row tiles of the grid
};

__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return p + ((kAtomBytes - (smem_u32(p) & (kAtomBytes - 1))) & (kAtomBytes - 1));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Key tiles of kStream keys that query rows up to `last_row` need.
__device__ __forceinline__ int key_tiles(const Args& a, int last_row) {
  int n = (a.sk + kStream - 1) / kStream;
  if (a.causal) {
    const long long last_key = a.q_offset + last_row - a.kv_offset;
    if (last_key < 0) return 0;
    if (last_key / kStream + 1 < n) n = static_cast<int>(last_key / kStream + 1);
  }
  return n;
}

// First query tile of kStream rows that can see key row `key`; the number
// of query tiles when none can.
__device__ __forceinline__ int first_query_tile(const Args& a, int key) {
  const int n = (a.sq + kStream - 1) / kStream;
  if (key >= a.sk) return n;
  if (!a.causal) return 0;
  const long long first_row = a.kv_offset + key - a.q_offset;
  if (first_row <= 0) return 0;
  if (first_row >= a.sq) return n;
  return static_cast<int>(first_row / kStream);
}

// Loads the kBoxes 64-column boxes of `rows` rows at sequence row `row`;
// columns past D (a whole box at D <= 64) read as zeros.
__device__ __forceinline__ void load_boxes(unsigned char* dst, const CUtensorMap* map,
                                           uint64_t* bar, int rows, int head, int row,
                                           int batch) {
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    tma_load_4d(dst + c * rows * kBoxRowBytes, map, bar, c * kSwizzleCols, head, row, batch);
  }
}

// acc (64 x 64) = A (64 x D) B (64 x D)^T, both K-major tiles in shared
// memory: A's rows start at a_addr in boxes a_rows rows tall, B's likewise.
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a_addr, int a_rows,
                                        uint32_t b_addr, int b_rows) {
#pragma unroll
  for (int ks = 0; ks < kDPad / 16; ++ks) {
    const uint32_t col_bytes = (ks & 3) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a_addr + (ks >> 2) * a_rows * kBoxRowBytes + col_bytes,
                                       16, kAtomBytes),
                       desc_sw128(b_addr + (ks >> 2) * b_rows * kBoxRowBytes + col_bytes, 16,
                                  kAtomBytes),
                       ks > 0);
  }
}

// The accumulator fragment of a 64 x 64 product as four k16 A fragments
// in bf16 (round to nearest even): the next product's A from registers.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// acc (64 x 128) += A (64 x 64, registers) B (64 x 128), B's 64 rows run
// along the reduction (MN-major): two 64-column boxes kStream rows tall.
__device__ __forceinline__ void mma_ab_rs(float (&acc)[64], const uint32_t (&a)[4][4],
                                          uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128k16_rs_tb(acc, a[kk],
                           desc_sw128(b_addr + kk * 16 * kBoxRowBytes, kStream * kBoxRowBytes,
                                      kAtomBytes),
                           1);
  }
}

// 16-byte chunk `chunk` (8 columns) of row r of a tile `rows` rows tall,
// stored as 128-byte-swizzled 64-column boxes (chunk c of a box row r sits
// at c ^ (r % 8)).
__device__ __forceinline__ uint4 tile_chunk(const unsigned char* tile, int rows, int r,
                                            int chunk) {
  return *reinterpret_cast<const uint4*>(tile + (chunk >> 3) * rows * kBoxRowBytes +
                                         r * kBoxRowBytes + (((chunk & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// Euclidean norm of row r of a tile (columns past D are zeros), in eight
// independent partial sums: a margin needs no particular order.
__device__ __forceinline__ float row_norm(const unsigned char* tile, int rows, int r) {
  float acc[8] = {};
#pragma unroll
  for (int ch = 0; ch < kDPad / 8; ++ch) {
    const uint4 v = tile_chunk(tile, rows, r, ch);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf16x2_to_f2(w[i]);
      acc[2 * i] = fmaf(f.x, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(f.y, f.y, acc[2 * i + 1]);
    }
  }
  return sqrtf(((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7])));
}

// One row of a tile: its base, height and row index.
struct TileRow {
  const unsigned char* tile;
  int rows, r;
};

// x = sum_i a_i b_i and y = sum_i c_i e_i, each an FMA chain in i order
// from 0: the order of the plain version's f32 products (and of the f32-pipe
// bodies), so x and y are theirs bit for bit. The columns past D are zeros,
// and an FMA of two zeros leaves a chain from +0 as it was.
__device__ __forceinline__ void chain_dots(TileRow a, TileRow b, TileRow c, TileRow e,
                                           float& x, float& y) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int ch = 0; ch < kDPad / 8; ++ch) {
    const uint4 va = tile_chunk(a.tile, a.rows, a.r, ch);
    const uint4 vb = tile_chunk(b.tile, b.rows, b.r, ch);
    const uint4 vc = tile_chunk(c.tile, c.rows, c.r, ch);
    const uint4 ve = tile_chunk(e.tile, e.rows, e.r, ch);
    const uint32_t wa[4] = {va.x, va.y, va.z, va.w}, wb[4] = {vb.x, vb.y, vb.z, vb.w};
    const uint32_t wc[4] = {vc.x, vc.y, vc.z, vc.w}, we[4] = {ve.x, ve.y, ve.z, ve.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = bf16x2_to_f2(wa[i]), fb = bf16x2_to_f2(wb[i]);
      const float2 fc = bf16x2_to_f2(wc[i]), fe = bf16x2_to_f2(we[i]);
      sx = fmaf(fa.x, fb.x, sx);
      sy = fmaf(fc.x, fe.x, sy);
      sx = fmaf(fa.y, fb.y, sx);
      sy = fmaf(fc.y, fe.y, sy);
    }
  }
  x = sx;
  y = sy;
}

// p = exp(S scale - lse) and ds = (p (dP - delta)) scale from S and dP
// with the plain version's rounding steps (and its expf).
__device__ __forceinline__ void probs_exact(float s, float dp, float lse, float delta,
                                            float scale, float& p, float& ds) {
  p = expf(__fmul_rn(s, scale) - lse);
  ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// How many f32 ulps x lies from the boundary at which its bf16 rounding
// changes (the midpoint of the two bf16 values around x), signed: its low 16
// bits less 0x8000, as a float (2^23 + low, less 2^23 + 2^15).
__device__ __forceinline__ float boundary_offset(float x) {
  return __uint_as_float((__float_as_uint(x) & 0xFFFFu) | 0x4B000000u) - 8421376.f;
}

// p = exp(S scale - lse) and ds = (p (dP - delta)) scale from the
// tensor-core S and dP (ex2.approx on log2(e)-scaled arguments, nl = -lse
// log2(e); it flushes p below 2^-126 to 0, where the plain version's p is a
// subnormal that differs from 0 by less than that); returns whether their
// bf16 roundings could differ from those of
// probs_exact on the in-order sums. The margins, in f32 ulps, bound the
// relative differences times 2^24: mp for p (the sums' difference, the
// arguments' roundings and the two exponentials'), and mp plus t / |dP -
// delta| plus ds's own roundings for ds (t: dP's allowance times 2^24).
// Masked elements (vis false) are exactly 0 either way.
__device__ __forceinline__ bool probs(float s, float dp, float nl, float delta, float sl2e,
                                      float scale, bool vis, float mp, float t, float& p,
                                      float& ds) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fmaf(s, sl2e, nl)));
  p = vis ? e : 0.f;
  const float dpd = dp - delta;
  ds = p * dpd * scale;
  // Bitwise, not short-circuit: one straight-line sequence for every element.
  return vis & ((fabsf(boundary_offset(p)) <= mp) |
                ((fabsf(boundary_offset(ds)) - (mp + 8.f)) * fabsf(dpd) <= t));
}

// The margin terms of a row or column: with r = the row's norm, |S scale| <=
// scale |q| |k| (Cauchy-Schwarz), and the sums differ by at most kChainErr
// |q| |k| (S) and kChainErr |dO| |V| (dP). mp = a |k| + b (a from q's norm,
// b from lse), t = c |V| (c from dO's norm). A row with lse = LSE_MASKED has
// p = 0 and needs no lse term.
__device__ __forceinline__ float margin_a(float scale, float q_norm) {
  return scale * q_norm * (kChainErr * kTwo24 + 4.f);
}
__device__ __forceinline__ float margin_b(float lse) {
  return lse < 1e29f ? fmaf(4.f, fabsf(lse), 8.f) : 8.f;
}
__device__ __forceinline__ float margin_c(float do_norm) {
  return kChainErr * kTwo24 * do_norm;
}

// Writes element i of the two fragments; a switch on the runtime i keeps
// the fragments in registers.
__device__ __forceinline__ void set_element(float (&x)[32], float (&y)[32], int i, float xv,
                                            float yv) {
  switch (i) {
#define KTWE_SET(k) \
  case k:           \
    x[k] = xv;      \
    y[k] = yv;      \
    break;
    KTWE_SET(0) KTWE_SET(1) KTWE_SET(2) KTWE_SET(3) KTWE_SET(4) KTWE_SET(5) KTWE_SET(6)
    KTWE_SET(7) KTWE_SET(8) KTWE_SET(9) KTWE_SET(10) KTWE_SET(11) KTWE_SET(12) KTWE_SET(13)
    KTWE_SET(14) KTWE_SET(15) KTWE_SET(16) KTWE_SET(17) KTWE_SET(18) KTWE_SET(19)
    KTWE_SET(20) KTWE_SET(21) KTWE_SET(22) KTWE_SET(23) KTWE_SET(24) KTWE_SET(25)
    KTWE_SET(26) KTWE_SET(27) KTWE_SET(28) KTWE_SET(29) KTWE_SET(30) KTWE_SET(31)
#undef KTWE_SET
    default: break;
  }
}

// A warp's queue for the recheck: the flagged elements (owner lane << 5 |
// fragment index), their recomputed (p, ds), and how many are flagged.
struct RecheckQueue {
  int desc[32];
  float2 res[32];
  int count;
};

// Rechecks this warp's flagged elements (bit i of `flags`: element i of this
// lane's fragments), 32 at a time, one a lane: exact(owner, i, p, ds)
// recomputes element i of lane `owner`'s fragments, and the owner takes the
// result into s and dp. q.count is 0 on entry and on return.
template <class Exact>
__device__ __forceinline__ void recheck(RecheckQueue& q, uint32_t flags, int lane,
                                        float (&s)[32], float (&dp)[32], Exact exact) {
  if (!__any_sync(kAll, flags != 0)) return;
  const int cnt = __popc(flags);
  const int first = cnt ? atomicAdd(&q.count, cnt) : 0;
  __syncwarp();
  const int total = q.count;
  for (int base = 0; base < total; base += 32) {
    int slot = first;
    for (uint32_t m = flags; m != 0; m &= m - 1, ++slot) {
      if (slot >= base && slot < base + 32) q.desc[slot - base] = (lane << 5) | (__ffs(m) - 1);
    }
    __syncwarp();
    if (base + lane < total) {
      const int d = q.desc[lane];
      float p, ds;
      exact(d >> 5, d & 31, p, ds);
      q.res[lane] = make_float2(p, ds);
    }
    __syncwarp();
    slot = first;
    for (uint32_t m = flags; m != 0; m &= m - 1, ++slot) {
      if (slot >= base && slot < base + 32) {
        const float2 r = q.res[slot - base];
        set_element(s, dp, __ffs(m) - 1, r.x, r.y);
      }
    }
    __syncwarp();
  }
  if (lane == 0) q.count = 0;
  __syncwarp();
}

// Visible columns of a tile row as 32-bit limits: column c (0..63) of the
// tile is visible when c < cols and c <= last (causal).
__device__ __forceinline__ int clamp_col(long long x) {
  return static_cast<int>(x < -1 ? -1 : (x > kStream ? kStream : x));
}

// (B, S, H, D) bf16 rows of a 64 x 128 f32 accumulator fragment: rows
// row0 and row0 + 8 of this thread, columns 8 j + 2 quad (+1) below d.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, int n_rows,
                                           int d, int row0, int quad, const float (&acc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col < d) {   // d is a multiple of 8, so col + 1 < d too
      if (row0 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(base + row0 * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      }
      if (row0 + 8 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(base + (row0 + 8) * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// Two neighbouring stash entries (row, col) and (row, col + 1) in bf16.
__device__ __forceinline__ void stash_pair(__nv_bfloat16* row_base, int col, int sk, float x0,
                                           float x1) {
  if ((sk & 1) == 0 && col + 1 < sk) {
    *reinterpret_cast<__nv_bfloat162*>(row_base + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < sk) row_base[col] = __float2bfloat16_rn(x0);
    if (col + 1 < sk) row_base[col + 1] = __float2bfloat16_rn(x1);
  }
}

// ---------------------------------------------------------------------------
// dQ (and the optional p/ds stash): 128 query rows resident, key tiles stream.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t own_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // Per consumer, two buffers of one key tile's K and V row norms.
  __shared__ __align__(16) float norm_s[kConsumers][2][2][kStream];
  __shared__ RecheckQueue queue_s[kConsumers * 4];
  unsigned char* q_s = align_atom(smem_raw);
  unsigned char* do_s = q_s + kOwnBytes;
  unsigned char* k_s = do_s + kOwnBytes;                // kStages x kTileBytes
  unsigned char* v_s = k_s + kStages * kTileBytes;      // kStages x kTileBytes

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (a.n_tiles - 1 - static_cast<int>(blockIdx.z)) * kRows;  // heavy tiles first
  const int n_tiles = key_tiles(a, min(q0 + kRows, a.sq) - 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&own_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&own_full, 2 * kBoxes * kRows * kBoxRowBytes);
      load_boxes(q_s, &q_map, &own_full, kRows, head, q0, batch);
      load_boxes(do_s, &do_map, &own_full, kRows, head, q0, batch);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[st], 2 * kBoxes * kStream * kBoxRowBytes);
        load_boxes(k_s + st * kTileBytes, &k_map, &full[st], kStream, head,
                   t * kStream, batch);
        load_boxes(v_s + st * kTileBytes, &v_map, &full[st], kStream, head,
                   t * kStream, batch);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows first_row .. first_row + 63.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int quad = lane & 3;
  const int first_row = q0 + cw * 64;
  const int lrow0 = cw * 64 + warp * 16 + (lane >> 2);   // this thread's rows in the tile:
  const int row0 = q0 + lrow0;                            // row0 and row0 + 8
  const int row1 = row0 + 8;
  // Key tiles this warpgroup computes; past them every one of its rows
  // masks the whole tile, so it only hands them back.
  const int my_tiles = first_row >= a.sq ? 0 : key_tiles(a, min(first_row + 64, a.sq) - 1);
  const long long bh = static_cast<long long>(batch) * a.h + head;
  // Rows past Sq read as fully masked (P = 0) with delta 0, never as
  // whatever lies past the end of lse and delta.
  const float lse0 = row0 < a.sq ? a.lse[bh * a.sq + row0] : kLseMasked;
  const float lse1 = row1 < a.sq ? a.lse[bh * a.sq + row1] : kLseMasked;
  const float dl0 = row0 < a.sq ? a.delta[bh * a.sq + row0] : 0.f;
  const float dl1 = row1 < a.sq ? a.delta[bh * a.sq + row1] : 0.f;
  __nv_bfloat16* p_st = static_cast<__nv_bfloat16*>(a.p_stash);
  __nv_bfloat16* ds_st = static_cast<__nv_bfloat16*>(a.ds_stash);
  const long long st_base = bh * a.sq * static_cast<long long>(a.sk);

  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t dsa[4][4];

  mbar_wait(&own_full, 0);
  const uint32_t q_addr = smem_u32(q_s) + cw * 64 * kBoxRowBytes;
  const uint32_t do_addr = smem_u32(do_s) + cw * 64 * kBoxRowBytes;
  RecheckQueue& queue = queue_s[cw * 4 + warp];
  if (lane == 0) queue.count = 0;
  __syncwarp();
  // This thread's rows' terms of the rounding margins (`probs`).
  const float sl2e = a.scale * kLog2e;
  const float nl0 = -lse0 * kLog2e, nl1 = -lse1 * kLog2e;
  const float ma0 = margin_a(a.scale, row_norm(q_s, kRows, lrow0));
  const float ma1 = margin_a(a.scale, row_norm(q_s, kRows, lrow0 + 8));
  const float mb0 = margin_b(lse0), mb1 = margin_b(lse1);
  const float mc0 = margin_c(row_norm(do_s, kRows, lrow0));
  const float mc1 = margin_c(row_norm(do_s, kRows, lrow0 + 8));
  int done = 0;   // tiles this warpgroup computed (the norm buffer's parity)

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kStream;
    mbar_wait(&full[st], (t / kStages) & 1);
    if (t >= my_tiles) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const unsigned char* kt = k_s + st * kTileBytes;
    const unsigned char* vt = v_s + st * kTileBytes;

    // S = Q K^T and dP = dO V^T, both operands K-major; the key tile's row
    // norms meanwhile (thread t128: K row t128, or V row t128 - 64).
    wgmma_fence();
    mma_abt(s, q_addr, kRows, smem_u32(kt), kStream);
    mma_abt(dp, do_addr, kRows, smem_u32(vt), kStream);
    wgmma_commit();
    float* norms = &norm_s[cw][done & 1][0][0];
    norms[t128] = row_norm(t128 < 64 ? kt : vt, kStream, t128 & 63);
    named_sync(1 + cw);
    ++done;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse) and dS = (P (dP - delta)) scale, in place.
    // Visible: tile column c < cols, and c <= last0 (last1) for row0 (row1);
    // no column of a row past Sq.
    const int cols = clamp_col(static_cast<long long>(a.sk) - k0) - 2 * quad;
    const int last0 = (row0 >= a.sq ? -1
                       : a.causal ? clamp_col(a.q_offset + row0 - a.kv_offset - k0) : kStream) -
                      2 * quad;
    const int last1 = (row1 >= a.sq ? -1
                       : a.causal ? clamp_col(a.q_offset + row1 - a.kv_offset - k0) : kStream) -
                      2 * quad;
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 nk = *reinterpret_cast<const float2*>(norms + 8 * j + 2 * quad);
      const float2 nv = *reinterpret_cast<const float2*>(norms + kStream + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + e;   // the tile column, less 2 quad
        const float nkv = e ? nk.y : nk.x, nvv = e ? nv.y : nv.x;
        float p, ds;
        if (probs(s[4 * j + e], dp[4 * j + e], nl0, dl0, sl2e, a.scale, c < cols && c <= last0,
                  fmaf(ma0, nkv, mb0), mc0 * nvv, p, ds)) {
          flags |= 1u << (4 * j + e);
        }
        s[4 * j + e] = p;
        dp[4 * j + e] = ds;
        if (probs(s[4 * j + 2 + e], dp[4 * j + 2 + e], nl1, dl1, sl2e, a.scale,
                  c < cols && c <= last1, fmaf(ma1, nkv, mb1), mc1 * nvv, p, ds)) {
          flags |= 1u << (4 * j + 2 + e);
        }
        s[4 * j + 2 + e] = p;
        dp[4 * j + 2 + e] = ds;
      }
    }
    // Elements near a bf16 rounding boundary take S and dP as in-order
    // chains, so they round as the plain version rounds them.
    recheck(queue, flags, lane, s, dp, [&](int owner, int i, float& p, float& ds) {
      const int lr = cw * 64 + warp * 16 + (owner >> 2) + ((i >> 1) & 1) * 8;
      const int lk = 8 * (i >> 2) + 2 * (owner & 3) + (i & 1);
      const int row = q0 + lr;   // flagged rows are below Sq
      float sx, dpx;
      chain_dots(TileRow{q_s, kRows, lr}, TileRow{kt, kStream, lk}, TileRow{do_s, kRows, lr},
                 TileRow{vt, kStream, lk}, sx, dpx);
      probs_exact(sx, dpx, a.lse[bh * a.sq + row], a.delta[bh * a.sq + row], a.scale, p, ds);
    });
    pack_a(dp, dsa);   // dS in q's dtype for the product
    if (p_st != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 8 * j + 2 * quad;
        if (row0 < a.sq) {
          const long long at = st_base + static_cast<long long>(row0) * a.sk;
          stash_pair(p_st + at, col, a.sk, s[4 * j], s[4 * j + 1]);
          stash_pair(ds_st + at, col, a.sk, dp[4 * j], dp[4 * j + 1]);
        }
        if (row1 < a.sq) {
          const long long at = st_base + static_cast<long long>(row1) * a.sk;
          stash_pair(p_st + at, col, a.sk, s[4 * j + 2], s[4 * j + 3]);
          stash_pair(ds_st + at, col, a.sk, dp[4 * j + 2], dp[4 * j + 3]);
        }
      }
    }

    // dQ += dS K: K's tile read MN-major (the same smem as S's K-major B).
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(dsa[kk]);
    wgmma_fence();
    mma_ab_rs(dq, dsa, smem_u32(kt));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // Stash tiles past this warpgroup's causal range hold zeros up to Sk.
  if (p_st != nullptr) {
    const int c_start = my_tiles * kStream;
    const int rows = max(0, min(64, a.sq - first_row));
    const int width = a.sk - c_start;
    if (width > 0 && rows > 0) {
      const long long at0 = st_base + static_cast<long long>(first_row) * a.sk + c_start;
      if ((a.sk & 7) == 0) {   // 16-byte stores: c_start is a multiple of 64
        const int vecs = width / 8;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int idx = t128; idx < rows * vecs; idx += 128) {
          const int r = idx / vecs;
          const long long at = at0 + static_cast<long long>(r) * a.sk + (idx - r * vecs) * 8;
          *reinterpret_cast<uint4*>(p_st + at) = zero;
          *reinterpret_cast<uint4*>(ds_st + at) = zero;
        }
      } else {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        for (int idx = t128; idx < rows * width; idx += 128) {
          const int r = idx / width;
          const long long at = at0 + static_cast<long long>(r) * a.sk + (idx - r * width);
          p_st[at] = zero;
          ds_st[at] = zero;
        }
      }
    }
  }

  const long long rs = static_cast<long long>(a.h) * a.d;
  store_rows(static_cast<__nv_bfloat16*>(a.out0) + static_cast<long long>(batch) * a.sq * rs +
                 static_cast<long long>(head) * a.d,
             rs, a.sq, a.d, row0, quad, dq);
}

// ---------------------------------------------------------------------------
// dK/dV with S, P and dP recomputed: 128 key rows resident, query tiles stream.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t own_full;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // Per consumer, two buffers of one query tile's lse, delta, Q and dO row
  // norms, and lse's margin term.
  __shared__ __align__(16) float stat_s[kConsumers][2][5][kStream];
  __shared__ RecheckQueue queue_s[kConsumers * 4];
  unsigned char* k_s = align_atom(smem_raw);
  unsigned char* v_s = k_s + kOwnBytes;
  unsigned char* q_s = v_s + kOwnBytes;                 // kStages x kTileBytes
  unsigned char* do_s = q_s + kStages * kTileBytes;     // kStages x kTileBytes

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.z) * kRows;  // causal: the first key tiles are heaviest
  const int n_qtiles = (a.sq + kStream - 1) / kStream;
  const int t_first = first_query_tile(a, k0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&own_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&own_full, 2 * kBoxes * kRows * kBoxRowBytes);
      load_boxes(k_s, &k_map, &own_full, kRows, head, k0, batch);
      load_boxes(v_s, &v_map, &own_full, kRows, head, k0, batch);
      for (int t = t_first; t < n_qtiles; ++t) {
        const int i = t - t_first;
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * kBoxes * kStream * kBoxRowBytes);
        load_boxes(q_s + st * kTileBytes, &q_map, &full[st], kStream, head,
                   t * kStream, batch);
        load_boxes(do_s + st * kTileBytes, &do_map, &full[st], kStream, head,
                   t * kStream, batch);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns key rows kc0 .. kc0 + 63. The products
  // are transposed (keys are wgmma's M): S^T = K Q^T, dP^T = V dO^T.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int quad = lane & 3;
  const int kc0 = k0 + cw * 64;
  const int lkey0 = cw * 64 + warp * 16 + (lane >> 2);   // this thread's keys in the tile:
  const int key0 = k0 + lkey0;                            // key0 and key0 + 8
  const int key1 = key0 + 8;
  const int my_first = first_query_tile(a, kc0);
  const long long bh = static_cast<long long>(batch) * a.h + head;

  // Thread t128 fetches entry t128 % 64 of the tile's lse (t128 < 64) or
  // delta, one tile ahead; query rows past Sq read as fully masked.
  const int stat_idx = t128 & 63;
  const int stat_kind = t128 >> 6;
  auto fetch_stat = [&](int t) {
    const int r = t * kStream + stat_idx;
    if (stat_kind == 0) return r < a.sq ? a.lse[bh * a.sq + r] : kLseMasked;
    return r < a.sq ? a.delta[bh * a.sq + r] : 0.f;
  };
  float stat_next = my_first < n_qtiles ? fetch_stat(my_first) : 0.f;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], dsa[4][4];

  mbar_wait(&own_full, 0);
  const uint32_t k_addr = smem_u32(k_s) + cw * 64 * kBoxRowBytes;
  const uint32_t v_addr = smem_u32(v_s) + cw * 64 * kBoxRowBytes;
  RecheckQueue& queue = queue_s[cw * 4 + warp];
  if (lane == 0) queue.count = 0;
  __syncwarp();
  // This thread's keys' terms of the rounding margins (`probs`).
  const float sl2e = a.scale * kLog2e;
  const float ma0 = margin_a(a.scale, row_norm(k_s, kRows, lkey0));
  const float ma1 = margin_a(a.scale, row_norm(k_s, kRows, lkey0 + 8));
  const float mc0 = margin_c(row_norm(v_s, kRows, lkey0));
  const float mc1 = margin_c(row_norm(v_s, kRows, lkey0 + 8));
  int done = 0;   // tiles this warpgroup computed (the stat buffer's parity)

  for (int t = t_first; t < n_qtiles; ++t) {
    const int i = t - t_first;
    const int st = i % kStages;
    const int q0 = t * kStream;
    mbar_wait(&full[st], (i / kStages) & 1);
    if (t < my_first) {   // wholly past the diagonal for this warpgroup's keys
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      continue;
    }
    const unsigned char* qt = q_s + st * kTileBytes;
    const unsigned char* gt = do_s + st * kTileBytes;

    wgmma_fence();
    mma_abt(s, k_addr, kRows, smem_u32(qt), kStream);
    mma_abt(dp, v_addr, kRows, smem_u32(gt), kStream);
    wgmma_commit();
    // The query tile's lse, delta and row norms meanwhile.
    float* stat = &stat_s[cw][done & 1][0][0];
    stat[stat_kind * kStream + stat_idx] = stat_next;
    stat[(2 + stat_kind) * kStream + stat_idx] = row_norm(stat_kind ? gt : qt, kStream, stat_idx);
    if (stat_kind == 0) stat[4 * kStream + stat_idx] = margin_b(stat_next);
    if (t + 1 < n_qtiles) stat_next = fetch_stat(t + 1);
    named_sync(1 + cw);
    ++done;
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Visible: key below Sk, tile column c < rows (query rows below Sq), and
    // c >= first0 (first1) for key0 (key1) under the causal mask.
    const int rows = clamp_col(static_cast<long long>(a.sq) - q0) - 2 * quad;
    const int first0 = (key0 >= a.sk ? kStream + 1
                        : a.causal ? clamp_col(a.kv_offset + key0 - a.q_offset - q0) : 0) -
                       2 * quad;
    const int first1 = (key1 >= a.sk ? kStream + 1
                        : a.causal ? clamp_col(a.kv_offset + key1 - a.q_offset - q0) : 0) -
                       2 * quad;
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 lse = *reinterpret_cast<const float2*>(stat + c);
      const float2 dl = *reinterpret_cast<const float2*>(stat + kStream + c);
      const float2 nq = *reinterpret_cast<const float2*>(stat + 2 * kStream + c);
      const float2 ng = *reinterpret_cast<const float2*>(stat + 3 * kStream + c);
      const float2 mb = *reinterpret_cast<const float2*>(stat + 4 * kStream + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * j + e;   // the tile column, less 2 quad
        const float nl = -(e ? lse.y : lse.x) * kLog2e, dlt = e ? dl.y : dl.x;
        const float nqe = e ? nq.y : nq.x, nge = e ? ng.y : ng.x, mbe = e ? mb.y : mb.x;
        float p, ds;
        if (probs(s[4 * j + e], dp[4 * j + e], nl, dlt, sl2e, a.scale,
                  cc >= first0 && cc < rows, fmaf(ma0, nqe, mbe), mc0 * nge, p, ds)) {
          flags |= 1u << (4 * j + e);
        }
        s[4 * j + e] = p;
        dp[4 * j + e] = ds;
        if (probs(s[4 * j + 2 + e], dp[4 * j + 2 + e], nl, dlt, sl2e, a.scale,
                  cc >= first1 && cc < rows, fmaf(ma1, nqe, mbe), mc1 * nge, p, ds)) {
          flags |= 1u << (4 * j + 2 + e);
        }
        s[4 * j + 2 + e] = p;
        dp[4 * j + 2 + e] = ds;
      }
    }
    // Elements near a bf16 rounding boundary take S and dP as in-order
    // chains, so they round as the plain version rounds them.
    recheck(queue, flags, lane, s, dp, [&](int owner, int i, float& p, float& ds) {
      const int lk = cw * 64 + warp * 16 + (owner >> 2) + ((i >> 1) & 1) * 8;
      const int lq = 8 * (i >> 2) + 2 * (owner & 3) + (i & 1);
      float sx, dpx;
      chain_dots(TileRow{qt, kStream, lq}, TileRow{k_s, kRows, lk}, TileRow{gt, kStream, lq},
                 TileRow{v_s, kRows, lk}, sx, dpx);
      probs_exact(sx, dpx, stat[lq], stat[kStream + lq], a.scale, p, ds);
    });
    pack_a(s, pa);    // P^T in dO's dtype for the dV product
    pack_a(dp, dsa);  // dS^T in q's dtype for the dK product

    // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major.
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(dsa[kk]);
    }
    wgmma_fence();
    mma_ab_rs(dv, pa, smem_u32(gt));
    mma_ab_rs(dk, dsa, smem_u32(qt));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const long long rs = static_cast<long long>(a.h) * a.d;
  const long long off =
      static_cast<long long>(batch) * a.sk * rs + static_cast<long long>(head) * a.d;
  store_rows(static_cast<__nv_bfloat16*>(a.out0) + off, rs, a.sk, a.d, key0, quad, dk);
  store_rows(static_cast<__nv_bfloat16*>(a.out1) + off, rs, a.sk, a.d, key0, quad, dv);
}

template <int W>
cudaError_t launch(const BwdArgs& ba, int batch, int device, cudaStream_t stream) {
  static_assert(W == kDq || W == kDkv, "the stash dK/dV kernel has no tensor-core body");
  auto kernel = W == kDq ? flash_bwd_dq_wgmma_kernel : flash_bwd_dkv_wgmma_kernel;
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const int n_tiles = ((W == kDq ? ba.sq : ba.sk) + kRows - 1) / kRows;
  if (n_tiles > 65535) return static_cast<cudaError_t>(kBadArgument);
  // Resident tiles are kRows tall, streamed ones kStream.
  const int q_rows = W == kDq ? kRows : kStream;
  const int k_rows = W == kDq ? kStream : kRows;
  CUtensorMap q_map, do_map, k_map, v_map;
  cudaError_t err = make_bshd_map(&q_map, ba.q, batch, ba.sq, ba.h, ba.d, q_rows);
  if (err == cudaSuccess) err = make_bshd_map(&do_map, ba.dout, batch, ba.sq, ba.h, ba.d, q_rows);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, ba.k, batch, ba.sk, ba.h, ba.d, k_rows);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, ba.v, batch, ba.sk, ba.h, ba.d, k_rows);
  if (err != cudaSuccess) return err;
  const Args a{ba.lse, ba.delta, W == kDq ? ba.dq : ba.dk, ba.dv, ba.p_stash, ba.ds_stash,
               ba.sq, ba.sk, ba.h, ba.d, ba.causal ? 1 : 0, ba.q_offset, ba.kv_offset,
               ba.scale, n_tiles};
  kernel<<<dim3(ba.h, batch, n_tiles), kThreads, kSmem, stream>>>(q_map, do_map, k_map, v_map,
                                                                 a);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Dynamic shared memory of the f32-pipe body W at head-dim bound DMAX.
template <int DMAX, int W>
constexpr size_t smem_floats() {
  if constexpr (W == kDq) return dq_smem_floats<DMAX>();
  if constexpr (W == kDkv) return dkv_smem_floats<DMAX>();
  return dkv_stash_smem_floats<DMAX>();
}

template <typename T, int DMAX, int W>
cudaError_t launch_one(const BwdArgs& a, int batch, int device, cudaStream_t stream) {
  void (*kernel)(BwdArgs);
  if constexpr (W == kDq) {
    kernel = flash_bwd_dq_kernel<T, DMAX>;
  } else if constexpr (W == kDkv) {
    kernel = flash_bwd_dkv_kernel<T, DMAX>;
  } else {
    kernel = flash_bwd_dkv_stash_kernel<T, DMAX>;
  }
  const size_t bytes = smem_floats<DMAX, W>() * sizeof(float);
  // The shared-memory opt-in belongs to the kernel on a device: once each.
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const int rows = W == kDq ? a.sq : a.sk;
  const dim3 grid((rows + Tiles<DMAX>::BR - 1) / Tiles<DMAX>::BR, a.h, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Whether a call runs a tensor-core body: bf16 at head_dim <= 128, dQ and
// the recompute dK/dV. The launcher's rule, exported for the wrappers'
// counts (ktwe_flash_bwd_wgmma).
bool wgmma_body(int which, int d, int dtype) {
  return (which == kDq || which == kDkv) && dtype == kBF16 && d <= tc::kDPad;
}

template <int W>
cudaError_t launch(const BwdArgs& a, int batch, int dtype, int device, cudaStream_t s) {
  const int dmax = a.d <= 64 ? 64 : (a.d <= 128 ? 128 : (a.d <= 256 ? 256 : 512));
  if (dtype == kF32) {
    if (dmax == 64) return launch_one<float, 64, W>(a, batch, device, s);
    if (dmax == 128) return launch_one<float, 128, W>(a, batch, device, s);
    if (dmax == 256) return launch_one<float, 256, W>(a, batch, device, s);
    return launch_one<float, 512, W>(a, batch, device, s);
  }
  if constexpr (W == kDkvStash) {
    if (dmax == 64) return launch_one<__nv_bfloat16, 64, W>(a, batch, device, s);
    if (dmax == 128) return launch_one<__nv_bfloat16, 128, W>(a, batch, device, s);
  } else {
    if (wgmma_body(W, a.d, dtype)) return tc::launch<W>(a, batch, device, s);
  }
  if (dmax == 256) return launch_one<__nv_bfloat16, 256, W>(a, batch, device, s);
  return launch_one<__nv_bfloat16, 512, W>(a, batch, device, s);
}

int validate(int batch, int sq, int sk, int h, int d, int dtype, int device) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || d <= 0 ||
      d > 512 || d % 8 != 0 || device < 0 || device >= kMaxDevices ||
      (dtype != kF32 && dtype != kBF16)) {
    return kBadArgument;
  }
  return 0;
}

template <int W>
int run(const BwdArgs& a, int batch, int dtype, int device, void* stream) {
  const int bad = validate(batch, a.sq, a.sk, a.h, a.d, dtype, device);
  if (bad) return bad;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  return static_cast<int>(launch<W>(a, batch, dtype, device, static_cast<cudaStream_t>(stream)));
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// q, dout, dq: (batch, sq, h, d); k, v: (batch, sk, h, d); one dtype, all
// contiguous and 16-byte aligned. lse, delta: (batch, h, sq) f32. p_stash and
// ds_stash: (batch * h, sq, sk) in the same dtype, both or neither.
KTWE_EXPORT int ktwe_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* p_stash,
                                  void* ds_stash, int batch, int sq, int sk, int h, int d,
                                  int causal, long long q_offset, long long kv_offset, float scale,
                                  int dtype, int device, void* stream) {
  if ((p_stash == nullptr) != (ds_stash == nullptr)) return kBadArgument;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr, p_stash, ds_stash,
                  sq, sk, h, d, causal != 0, q_offset, kv_offset, scale};
  return run<kDq>(a, batch, dtype, device, stream);
}

// dk, dv: (batch, sk, h, d). The rest as for ktwe_flash_bwd_dq.
KTWE_EXPORT int ktwe_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int batch, int sq, int sk, int h, int d, int causal,
                                   long long q_offset, long long kv_offset, float scale,
                                   int dtype, int device, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), nullptr, dk, dv, nullptr, nullptr,
                  sq, sk, h, d, causal != 0, q_offset, kv_offset, scale};
  return run<kDkv>(a, batch, dtype, device, stream);
}

// dK/dV from the stash ktwe_flash_bwd_dq wrote for the same arguments.
KTWE_EXPORT int ktwe_flash_bwd_dkv_stash(const void* q, const void* dout, const void* p_stash,
                                         const void* ds_stash, void* dk, void* dv, int batch,
                                         int sq, int sk, int h, int d, int causal,
                                         long long q_offset, long long kv_offset, int dtype,
                                         int device, void* stream) {
  if (p_stash == nullptr || ds_stash == nullptr) return kBadArgument;
  const BwdArgs a{q, nullptr, nullptr, dout, nullptr, nullptr, nullptr, dk, dv,
                  const_cast<void*>(p_stash), const_cast<void*>(ds_stash),
                  sq, sk, h, d, causal != 0, q_offset, kv_offset, 1.f};
  return run<kDkvStash>(a, batch, dtype, device, stream);
}

// 1 when a call of kernel `which` (0 dQ, 1 recompute dK/dV, 2 dK/dV from
// the stash) at head_dim d and `dtype` runs a tensor-core (wgmma) body,
// else 0: the rule the launchers above apply.
KTWE_EXPORT int ktwe_flash_bwd_wgmma(int which, int d, int dtype) {
  return wgmma_body(which, d, dtype) ? 1 : 0;
}

// Dynamic shared memory a block of the body that (which, d, dtype)
// selects asks for (bytes), for reports; 0 for arguments the launchers
// refuse.
KTWE_EXPORT int ktwe_flash_bwd_smem(int which, int d, int dtype) {
  if (d <= 0 || d > 512 || d % 8 != 0 || which < kDq || which > kDkvStash ||
      (dtype != kF32 && dtype != kBF16)) {
    return 0;
  }
  if (wgmma_body(which, d, dtype)) return tc::kSmem;
  constexpr int kDmax[4] = {64, 128, 256, 512};
  size_t floats[3][4] = {{smem_floats<64, kDq>(), smem_floats<128, kDq>(),
                          smem_floats<256, kDq>(), smem_floats<512, kDq>()},
                         {smem_floats<64, kDkv>(), smem_floats<128, kDkv>(),
                          smem_floats<256, kDkv>(), smem_floats<512, kDkv>()},
                         {smem_floats<64, kDkvStash>(), smem_floats<128, kDkvStash>(),
                          smem_floats<256, kDkvStash>(), smem_floats<512, kDkvStash>()}};
  int i = 0;
  while (d > kDmax[i]) ++i;
  return static_cast<int>(floats[which][i] * sizeof(float));
}
