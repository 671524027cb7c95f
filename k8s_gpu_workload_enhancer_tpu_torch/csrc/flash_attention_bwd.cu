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
// Every kernel repeats the TPU kernels' rounding points: f32 scores times
// scale, NEG_INF = -1e30 past the diagonal (global positions q_offset + i
// >= kv_offset + j), P = exp(S - lse) (a fully masked row has lse =
// LSE_MASKED, so its P is exactly 0), dS = (P * (dP - delta)) * scale
// rounded to q's dtype before the dQ and dK products, P rounded to dO's
// dtype before the dV product, f32 accumulation. The tensors keep the
// model's (B, S, H, D) layout; lse and delta are (B, H, Sq) f32. Heads are
// MHA: the caller expands GQA first, as the TPU kernels require.
//
// Bound: operations. At the training shape (B 8, S 2048, 16 heads of 128,
// causal) the five products of the backward come to ~344 GFLOP per call
// against ~0.3 GB of traffic, ~0.35 ms at the bf16 tensor-core rate. These
// first kernels run the products on the f32 pipes instead, so they sit far
// above that bound; tensor cores (wgmma), TMA and a deeper pipeline are
// later work. Design, per kernel: one block of 256 threads owns a tile of
// rows (query rows for dQ, key rows for dK/dV) and walks the other side's
// tiles inside the block (the TPU's sequential grid axis), keeping its
// output accumulators in registers. Every product is a register-tiled
// outer product out of shared memory: both operands are stored k-major in
// f32 (the tile loads transpose and convert once), so each step of the
// contraction loads a few float2/float4 words and issues 8-32 FMAs per
// thread. A thread owns the same rows in the score tile and in its
// accumulator tile, so its rows' lse and delta stay in registers. Head
// dims up to 64, 128 and 256 are three instantiations with tiles sized so
// the shared memory fits one block (at most 223 KB at 256).
#include <atomic>

#include "common.cuh"

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
// rows of the other side per step of its loop.
template <int DMAX> struct Tiles;
template <> struct Tiles<64> { static constexpr int BR = 64, BC = 32; };
template <> struct Tiles<128> { static constexpr int BR = 64, BC = 32; };
template <> struct Tiles<256> { static constexpr int BR = 32, BC = 32; };

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

// acc[i][j] += sum_{k < K} A[k * lda + m0 + i] * B[k * ldb + n0 + j]: a
// register-tiled outer product over operands stored k-major in shared memory.
template <int TM, int TN>
__device__ __forceinline__ void outer_mma(const float* __restrict__ A, int lda, int m0,
                                          const float* __restrict__ B, int ldb, int n0, int K,
                                          float (&acc)[TM][TN]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
    load_row<TM>(A + k * lda + m0, a);
    load_row<TN>(B + k * ldb + n0, b);
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
  constexpr int BQ = Tiles<DMAX>::BR, BK = Tiles<DMAX>::BC;
  return 2 * DMAX * (BQ + 4) + 2 * DMAX * (BK + 4) + BK * (DMAX + 4) + BK * (BQ + 4);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BQ = Tiles<DMAX>::BR, BK = Tiles<DMAX>::BC;
  constexpr int LQ = BQ + 4, LK = BK + 4, LD = DMAX + 4;
  constexpr int TM = BQ / 16, TN = BK / 16, TD = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;               // [DMAX][LQ]
  float* doT = qT + DMAX * LQ;    // [DMAX][LQ]
  float* kT = doT + DMAX * LQ;    // [DMAX][LK]
  float* vT = kT + DMAX * LK;     // [DMAX][LK]
  float* kR = vT + DMAX * LK;     // [BK][LD]
  float* dsT = kR + BK * LD;      // [BK][LQ]

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

  load_tile<T, BQ, DMAX>(qb, rs, q0, a.sq, d, qT, LQ, nullptr, 0);
  load_tile<T, BQ, DMAX>(gb, rs, q0, a.sq, d, doT, LQ, nullptr, 0);
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
    load_tile<T, BK, DMAX>(vb, rs, k0, a.sk, d, vT, LK, nullptr, 0);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    outer_mma<TM, TN>(qT, LQ, ty * TM, kT, LK, tx * TN, d, s);
    outer_mma<TM, TN>(doT, LQ, ty * TM, vT, LK, tx * TN, d, dp);
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
    outer_mma<TM, TD>(dsT, LQ, ty * TM, kR, LD, tx * TD, BK, acc);
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
        const int c = tx * TD + j;
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
        const int col = tx * TD + j;
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
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC;
  return 2 * DMAX * (BKV + 4) + 2 * DMAX * (BQ + 4) + 2 * BQ * (DMAX + 4) + 2 * BQ * (BKV + 4);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC;
  constexpr int LC = BKV + 4, LR = BQ + 4, LD = DMAX + 4;
  constexpr int TM = BKV / 16, TN = BQ / 16, TD = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;             // [DMAX][LC]
  float* vT = kT + DMAX * LC;   // [DMAX][LC]
  float* qT = vT + DMAX * LC;   // [DMAX][LR]
  float* doT = qT + DMAX * LR;  // [DMAX][LR]
  float* qR = doT + DMAX * LR;  // [BQ][LD]
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

  load_tile<T, BKV, DMAX>(kb, rs, k0, a.sk, d, kT, LC, nullptr, 0);
  load_tile<T, BKV, DMAX>(vb, rs, k0, a.sk, d, vT, LC, nullptr, 0);
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
    outer_mma<TM, TN>(kT, LC, ty * TM, qT, LR, tx * TN, d, s);   // S^T[c][r]
    outer_mma<TM, TN>(vT, LC, ty * TM, doT, LR, tx * TN, d, dp);  // dP^T[c][r]
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
    outer_mma<TM, TD>(pR, LC, ty * TM, doR, LD, tx * TD, BQ, acc_v);   // dV += P^T dO
    outer_mma<TM, TD>(dsR, LC, ty * TM, qR, LD, tx * TD, BQ, acc_k);   // dK += dS^T Q
  }
  store_kv<T, TM, TD>(a, k0, ty, tx, acc_k, acc_v);
}

// ---------------------------------------------------------------------------
// dK/dV from the p/ds stash: two products per query tile, nothing recomputed.
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t dkv_stash_smem_floats() {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC;
  return 2 * BQ * (DMAX + 4) + 2 * BQ * (BKV + 4);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_stash_kernel(BwdArgs a) {
  constexpr int BKV = Tiles<DMAX>::BR, BQ = Tiles<DMAX>::BC;
  constexpr int LC = BKV + 4, LD = DMAX + 4;
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
    outer_mma<TM, TD>(pR, LC, ty * TM, doR, LD, tx * TD, BQ, acc_v);
    outer_mma<TM, TD>(dsR, LC, ty * TM, qR, LD, tx * TD, BQ, acc_k);
  }
  store_kv<T, TM, TD>(a, k0, ty, tx, acc_k, acc_v);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

enum Which { kDq = 0, kDkv = 1, kDkvStash = 2 };

template <typename T, int DMAX, int W>
cudaError_t launch_one(const BwdArgs& a, int batch, int device, cudaStream_t stream) {
  size_t floats;
  void (*kernel)(BwdArgs);
  int rows_per_block;
  if constexpr (W == kDq) {
    floats = dq_smem_floats<DMAX>();
    kernel = flash_bwd_dq_kernel<T, DMAX>;
    rows_per_block = Tiles<DMAX>::BR;
  } else if constexpr (W == kDkv) {
    floats = dkv_smem_floats<DMAX>();
    kernel = flash_bwd_dkv_kernel<T, DMAX>;
    rows_per_block = Tiles<DMAX>::BR;
  } else {
    floats = dkv_stash_smem_floats<DMAX>();
    kernel = flash_bwd_dkv_stash_kernel<T, DMAX>;
    rows_per_block = Tiles<DMAX>::BR;
  }
  const size_t bytes = floats * sizeof(float);
  // The shared-memory opt-in belongs to the kernel on a device: once each.
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const int rows = W == kDq ? a.sq : a.sk;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, a.h, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(const BwdArgs& a, int batch, int dtype, int device, cudaStream_t s) {
  const int dmax = a.d <= 64 ? 64 : (a.d <= 128 ? 128 : 256);
  if (dtype == kF32) {
    if (dmax == 64) return launch_one<float, 64, W>(a, batch, device, s);
    if (dmax == 128) return launch_one<float, 128, W>(a, batch, device, s);
    return launch_one<float, 256, W>(a, batch, device, s);
  }
  if (dmax == 64) return launch_one<__nv_bfloat16, 64, W>(a, batch, device, s);
  if (dmax == 128) return launch_one<__nv_bfloat16, 128, W>(a, batch, device, s);
  return launch_one<__nv_bfloat16, 256, W>(a, batch, device, s);
}

int validate(int batch, int sq, int sk, int h, int d, int dtype, int device) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || d <= 0 ||
      d > 256 || d % 8 != 0 || device < 0 || device >= kMaxDevices ||
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
