// Fused LM-head + softmax cross-entropy for Hopper: forward and backward.
//
// Replaces, in k8s_gpu_workload_enhancer_tpu/ops/fused_ce.py:
//   - _ce_fwd_kernel (called from _fused_forward): logits tiles h2 @ W on
//     the tensor cores, folded into a running (m, l) logsumexp per row, the
//     gold logit picked from the f32 tile, and only the bf16 logits stash
//     written; the f32 logits never reach device memory;
//   - _ce_bwd_kernel (_fused_backward): dlg = ((exp(stash - lse) - onehot)
//     * g / N) rounded to bf16 per tile, written out for the dHead product
//     (plain torch, as in the reference), and contracted at once with the
//     head tile into an f32 dH accumulator, stored as bf16.
// h2 (N, D) and W (D, V) share one dtype: bf16 (the model's) or f32 (the
// f32 parity gate). The stash, dlg and dH are bf16 in both, as the
// reference writes them.
//
// Bound: operations. At the flagship microbatch (N 16384, D 2048, V 32768)
// each kernel's product is 2.2 TFLOP, ~2.2 ms at the bf16 tensor-core rate,
// against ~1.2 GB of stash and dlg traffic (~0.36 ms). Design: 128 x 128
// output tiles, 8 warps of 64 x 32, each product a chain of 16 x 16 x 16
// bf16 `wmma` (mma.sync) steps with f32 accumulation, the operand tiles (32
// deep) staged in shared memory and the next tile's global loads started
// into registers before the current tile's products (one stage of
// prefetch); registers are capped so that two blocks share an SM, one's
// loads and epilogue overlapping the other's products. The f32 inputs take the same tiles on the f32 pipes (an 8 x 8
// register tile per thread, FMAs in contraction order): no TF32 rounding,
// so the f32 gate's limits (loss 1e-5, gradients 1e-3) hold. wgmma and TMA
// are later work.
//   - Forward: the TPU's sequential vocab axis becomes a loop inside the
//     block over its share of the vocab tiles; the vocab is cut into
//     `splits` shares so the grid fills the card, each share writes its
//     rows' (m, l, gold) partials, and a second small kernel combines them
//     (one share gives exactly the reference's online result). After each
//     tile's products the f32 tile goes to shared memory; a warp owns 16
//     rows there, reduces each row with shuffles and writes its stash row
//     with 8-byte stores.
//   - Backward: blocks own a 128-row x 128-column tile of dH and walk the
//     whole vocab 32 columns at a time; the dlg tile is made from the stash
//     while it is staged (each of the D / 128 column blocks of a row tile
//     recomputes it; the first one writes it out).
#include <mma.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

using namespace ktwe;
using namespace nvcuda;

namespace {

constexpr int kBM = 128;       // rows of h2 / dH per block
constexpr int kBN = 128;       // vocab columns (forward) or D columns (backward) per block
constexpr int kBK = 32;        // contraction depth per staged tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdc = kBN + 4;  // f32 output tile row stride (floats)
constexpr float kNegInf = -1e30f;

// Shared-memory row strides of the operand tiles: bf16 rows padded by 8
// elements (wmma wants a multiple of 8, and 16-byte stores stay aligned),
// f32 rows by 4.
template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };
template <typename T> constexpr int kLdA = kBK + Pad<T>::v;        // A: [kBM][kLdA]
template <typename T> constexpr int kLdBRow = kBN + Pad<T>::v;     // B row-major: [kBK][.]
template <typename T> constexpr int kLdBCol = kBK + Pad<T>::v;     // B col-major: [kBN][.]

template <typename T> constexpr int kVec = 16 / sizeof(T);
using Raw = uint4;  // 16 bytes of elements

// ---------------------------------------------------------------------------
// The product of one staged tile pair, per dtype.
// ---------------------------------------------------------------------------

// bf16: warp (wm, wn) of a 2 x 4 grid owns rows wm*64.. and columns wn*32..
// as 4 x 2 fragments of 16 x 16.
struct TensorCoreAcc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
    }
  }

  // A [kBM][lda] row-major; B element (k, n) at B[k * ldb + n] (row-major)
  // or B[n * ldb + k] (col-major).
  template <bool kBColMajor>
  __device__ void mma(const __nv_bfloat16* A, const __nv_bfloat16* B) {
    constexpr int lda = kLdA<__nv_bfloat16>;
    constexpr int ldb = kBColMajor ? kLdBCol<__nv_bfloat16> : kLdBRow<__nv_bfloat16>;
    using BLayout = typename std::conditional<kBColMajor, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], A + (wm * 64 + i * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(b[j], kBColMajor ? B + n * ldb + kk : B + kk * ldb + n, ldb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
      }
    }
  }

  __device__ void store(float* C) const {
    const int warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(C + (wm * 64 + i * 16) * kLdc + wn * 32 + j * 16, c[i][j], kLdc,
                                wmma::mem_row_major);
      }
    }
  }
};

// f32: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j, i, j < 8, summed in contraction order with FMAs.
struct SimtAcc {
  float c[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
    }
  }

  template <bool kBColMajor>
  __device__ void mma(const float* A, const float* B) {
    constexpr int lda = kLdA<float>;
    constexpr int ldb = kBColMajor ? kLdBCol<float> : kLdBRow<float>;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = kBColMajor ? B[n * ldb + k] : B[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
      }
    }
  }

  __device__ void store(float* C) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) C[(ty + 16 * i) * kLdc + tx + 16 * j] = c[i][j];
    }
  }
};

// Blocks resident per SM: two for bf16 (registers capped at 128 a thread;
// 68 KB of shared memory each), one for the f32 pipes' 8 x 8 tiles.
template <typename T> constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = TensorCoreAcc; };
template <> struct AccOf<float> { using type = SimtAcc; };

// Shared memory of a block: the operand tiles, overlaid after the products
// by the f32 output tile.
template <typename T, bool kBColMajor>
constexpr size_t smem_bytes() {
  const size_t a = sizeof(T) * kBM * kLdA<T>;
  const size_t b = sizeof(T) * (kBColMajor ? kBN * kLdBCol<T> : kBK * kLdBRow<T>);
  const size_t c = sizeof(float) * kBM * kLdc;
  return a + b > c ? a + b : c;
}

// A tile of ROWS rows x kBK columns of a row-major matrix (rows >= n_rows
// and columns >= n_cols read as 0), as raw 16-byte vectors in registers:
// vector `it` of this thread is row idx / vpr, column (idx % vpr) * kVec.
template <typename T, int ROWS>
struct RowTile {
  static constexpr int vpr = kBK / kVec<T>;
  static constexpr int iters = ROWS * vpr / kThreads;
  Raw v[iters];

  __device__ static int row(int it) { return (threadIdx.x + it * kThreads) / vpr; }
  __device__ static int col(int it) { return (threadIdx.x + it * kThreads) % vpr * kVec<T>; }

  __device__ void load(const T* src, long long ld, int r0, int n_rows, int c0, int n_cols) {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      const int r = r0 + row(it), c = c0 + col(it);
      v[it] = (r < n_rows && c < n_cols)
                  ? *reinterpret_cast<const Raw*>(src + static_cast<long long>(r) * ld + c)
                  : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(T* dst, int ld) const {
#pragma unroll
    for (int it = 0; it < iters; ++it) *reinterpret_cast<Raw*>(dst + row(it) * ld + col(it)) = v[it];
  }
};

// A tile of kBK rows x kBN columns of a row-major matrix (columns >= n_cols
// read as 0): the forward's head tile.
template <typename T>
struct HeadTile {
  static constexpr int vpr = kBN / kVec<T>;
  static constexpr int iters = kBK * vpr / kThreads;
  Raw v[iters];

  __device__ static int row(int it) { return (threadIdx.x + it * kThreads) / vpr; }
  __device__ static int col(int it) { return (threadIdx.x + it * kThreads) % vpr * kVec<T>; }

  __device__ void load(const T* src, long long ld, int r0, int c0, int n_cols) {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      const int c = c0 + col(it);
      v[it] = c < n_cols ? *reinterpret_cast<const Raw*>(src + static_cast<long long>(r0 + row(it)) * ld + c)
                         : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(T* dst) const {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      *reinterpret_cast<Raw*>(dst + row(it) * kLdBRow<T> + col(it)) = v[it];
    }
  }
};

struct FwdArgs {
  const void* h;        // (N, D)
  const void* w;        // (D, V)
  const int* targets;   // (N,)
  __nv_bfloat16* stash; // (N, V)
  float* part;          // (3, splits, N): m, l, gold per vocab share
  float* lse;           // (N,)
  float* gold;          // (N,)
  int n, d, v, splits;
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) ce_fwd_kernel(FwdArgs a) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kBM * kLdA<T>;
  float* Cs = reinterpret_cast<float*>(smem_raw);

  const int m0 = blockIdx.x * kBM;
  const int v_tiles = (a.v + kBN - 1) / kBN;
  const int per = (v_tiles + a.splits - 1) / a.splits;
  const int t_begin = blockIdx.y * per;
  const int t_end = min(v_tiles, t_begin + per);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = a.d / kBK;

  // Row state (running max, sum, gold; target), one entry per row: the
  // warp that owns a row in the epilogue is the only one to touch it.
  __shared__ float m_s[kBM], l_s[kBM], g_s[kBM];
  __shared__ int t_s[kBM];
  if (threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
    g_s[threadIdx.x] = 0.f;
    t_s[threadIdx.x] = r < a.n ? a.targets[r] : -1;
  }

  Acc acc;
  RowTile<T, kBM> ta;
  HeadTile<T> tb;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    acc.zero();
    ta.load(h, a.d, m0, a.n, 0, a.d);
    tb.load(w, a.v, 0, n0, a.v);
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();  // the previous products (or epilogue) are done with shared memory
      ta.store(As, kLdA<T>);
      tb.store(Bs);
      __syncthreads();
      if (kc + 1 < nk) {  // the next tile's loads fly during these products
        ta.load(h, a.d, m0, a.n, (kc + 1) * kBK, a.d);
        tb.load(w, a.v, (kc + 1) * kBK, n0, a.v);
      }
      acc.template mma<false>(As, Bs);
    }
    __syncthreads();
    acc.store(Cs);
    __syncthreads();
    // Epilogue: warp `warp` owns rows warp*16 .. +15; lane owns columns
    // lane*4 .. +3 of the tile.
    const int c = n0 + lane * 4;
    const bool col_ok = c < a.v;  // V % 4 == 0: a group of 4 is in or out
    for (int i = 0; i < 16; ++i) {
      const int lr = warp * 16 + i;
      const int r = m0 + lr;
      if (r >= a.n) continue;  // warp-uniform
      // Every lane reads the row state before the shuffles below, which no
      // lane passes until all have arrived; lane 0 writes it back after.
      const float m_old = m_s[lr], l_old = l_s[lr];
      const float4 x = *reinterpret_cast<const float4*>(Cs + lr * kLdc + lane * 4);
      float mx = col_ok ? fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)) : kNegInf;
      mx = warp_max(mx);
      const float m_new = fmaxf(m_old, mx);
      float s = col_ok ? (expf(x.x - m_new) + expf(x.y - m_new)) + (expf(x.z - m_new) + expf(x.w - m_new))
                       : 0.f;
      s = warp_sum(s);
      if (lane == 0) {
        l_s[lr] = l_old * expf(m_old - m_new) + s;
        m_s[lr] = m_new;
        const int t = t_s[lr];
        if (t >= n0 && t < n0 + kBN && t < a.v) g_s[lr] = Cs[lr * kLdc + (t - n0)];
      }
      if (col_ok) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned*>(&lo);
        packed.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(a.stash + static_cast<long long>(r) * a.v + c) = packed;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < a.n) {
    const int r = m0 + threadIdx.x;
    const long long at = static_cast<long long>(blockIdx.y) * a.n + r;
    const long long plane = static_cast<long long>(a.splits) * a.n;
    a.part[at] = m_s[threadIdx.x];
    a.part[plane + at] = l_s[threadIdx.x];
    a.part[2 * plane + at] = g_s[threadIdx.x];
  }
}

// lse = M + log(max(sum_i l_i exp(m_i - M), 1e-30)), gold = sum_i gold_i.
__global__ void ce_combine_kernel(FwdArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const long long plane = static_cast<long long>(a.splits) * a.n;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part[static_cast<long long>(s) * a.n + r]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long at = static_cast<long long>(s) * a.n + r;
    l += a.part[plane + at] * expf(a.part[at] - mx);
    g += a.part[2 * plane + at];
  }
  a.lse[r] = mx + logf(fmaxf(l, 1e-30f));
  a.gold[r] = g;
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const __nv_bfloat16* stash;  // (N, V)
  const void* w;               // (D, V)
  const float* lse;            // (N,)
  const int* targets;          // (N,)
  const float* scale;          // () g / N
  __nv_bfloat16* dlg;          // (N, V)
  __nv_bfloat16* dh;           // (N, D)
  int n, d, v;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>) ce_bwd_kernel(BwdArgs a) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + kBM * kLdA<T>;
  float* Cs = reinterpret_cast<float*>(smem_raw);
  __shared__ float lse_s[kBM];
  __shared__ int t_s[kBM];

  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBN;
  const bool write_dlg = blockIdx.y == 0;
  const T* w = static_cast<const T*>(a.w);
  if (threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    lse_s[threadIdx.x] = r < a.n ? a.lse[r] : 0.f;
    t_s[threadIdx.x] = r < a.n ? a.targets[r] : -1;
  }
  const float scale = *a.scale;

  Acc acc;
  acc.zero();
  RowTile<__nv_bfloat16, kBM> ts;  // stash
  RowTile<T, kBN> tw;              // W rows d0.., i.e. head^T as a col-major operand
  const int nk = (a.v + kBK - 1) / kBK;
  ts.load(a.stash, a.v, m0, a.n, 0, a.v);
  tw.load(w + static_cast<long long>(d0) * a.v, a.v, 0, kBN, 0, a.v);
  for (int kc = 0; kc < nk; ++kc) {
    const int v0 = kc * kBK;
    __syncthreads();  // lse_s/t_s are written; the previous products are done
    // dlg from the staged stash vectors, into A and (once) out to memory.
#pragma unroll
    for (int it = 0; it < RowTile<__nv_bfloat16, kBM>::iters; ++it) {
      const int lr = RowTile<__nv_bfloat16, kBM>::row(it);
      const int lc = RowTile<__nv_bfloat16, kBM>::col(it);
      const int r = m0 + lr, c = v0 + lc;
      const bool ok = r < a.n && c < a.v;  // V % 8 == 0: a vector is in or out
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(&ts.v[it]);
      alignas(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float g = 0.f;
        if (ok) {
          const float p = expf(__fsub_rn(__bfloat162float(st[e]), lse_s[lr]));
          const float onehot = c + e == t_s[lr] ? 1.f : 0.f;
          g = __fmul_rn(__fsub_rn(p, onehot), scale);
        }
        out[e] = __float2bfloat16_rn(g);
      }
      if (ok && write_dlg) {
        *reinterpret_cast<Raw*>(a.dlg + static_cast<long long>(r) * a.v + c) =
            *reinterpret_cast<const Raw*>(out);
      }
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<Raw*>(As + lr * kLdA<T> + lc) = *reinterpret_cast<const Raw*>(out);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) As[lr * kLdA<T> + lc + e] = __bfloat162float(out[e]);
      }
    }
    tw.store(Bs, kLdBCol<T>);
    __syncthreads();
    if (kc + 1 < nk) {
      ts.load(a.stash, a.v, m0, a.n, v0 + kBK, a.v);
      tw.load(w + static_cast<long long>(d0) * a.v, a.v, 0, kBN, v0 + kBK, a.v);
    }
    acc.template mma<true>(As, Bs);  // dH += dlg @ head_tile^T
  }
  __syncthreads();
  acc.store(Cs);
  __syncthreads();
  // dH tile out as bf16, 8 columns (16 bytes) per store.
  for (int idx = threadIdx.x; idx < kBM * kBN / 8; idx += kThreads) {
    const int lr = idx / (kBN / 8), lc = idx % (kBN / 8) * 8;
    const int r = m0 + lr;
    if (r >= a.n) continue;
    alignas(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(Cs[lr * kLdc + lc + e]);
    *reinterpret_cast<Raw*>(a.dh + static_cast<long long>(r) * a.d + d0 + lc) =
        *reinterpret_cast<const Raw*>(out);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, int device, std::atomic<bool>* done) {
  // The shared-memory opt-in belongs to the kernel on a device: once each.
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch_fwd(const FwdArgs& a, int device, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  constexpr size_t bytes = smem_bytes<T, false>();
  cudaError_t err = opt_in(ce_fwd_kernel<T>, bytes, device, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBM - 1) / kBM, a.splits);
  ce_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.n + 255) / 256, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int device, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  constexpr size_t bytes = smem_bytes<T, true>();
  const cudaError_t err = opt_in(ce_bwd_kernel<T>, bytes, device, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBM - 1) / kBM, a.d / kBN);
  ce_bwd_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

int validate(int n, int d, int v, int dtype, int device) {
  if (n <= 0 || d <= 0 || d % kBN != 0 || v <= 0 || v % 8 != 0 || device < 0 ||
      device >= kMaxDevices || (dtype != kF32 && dtype != kBF16)) {
    return kBadArgument;
  }
  return 0;
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// h: (n, d), w: (d, v) in one dtype; targets (n,) int32; stash (n, v) bf16;
// part (3, splits, n), lse (n,), gold (n,) f32. All contiguous and 16-byte
// aligned; d % 128 == 0, v % 8 == 0, 1 <= splits <= ceil(v / 128).
KTWE_EXPORT int ktwe_fused_ce_fwd(const void* h, const void* w, const void* targets, void* stash,
                                  void* part, void* lse, void* gold, int n, int d, int v,
                                  int splits, int dtype, int device, void* stream) {
  if (validate(n, d, v, dtype, device) || splits < 1 || splits > (v + kBN - 1) / kBN ||
      splits > 65535) {
    return kBadArgument;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const FwdArgs a{h, w, static_cast<const int*>(targets), static_cast<__nv_bfloat16*>(stash),
                  static_cast<float*>(part), static_cast<float*>(lse), static_cast<float*>(gold),
                  n, d, v, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == kF32 ? launch_fwd<float>(a, device, st) : launch_fwd<__nv_bfloat16>(a, device, st);
  return static_cast<int>(err);
}

// stash (n, v) bf16; w (d, v) in `dtype`; lse (n,) f32; targets (n,) int32;
// scale () f32 on the device; dlg (n, v) and dh (n, d) bf16. Layout rules
// as for ktwe_fused_ce_fwd.
KTWE_EXPORT int ktwe_fused_ce_bwd(const void* stash, const void* w, const void* lse,
                                  const void* targets, const void* scale, void* dlg, void* dh,
                                  int n, int d, int v, int dtype, int device, void* stream) {
  if (validate(n, d, v, dtype, device)) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const BwdArgs a{static_cast<const __nv_bfloat16*>(stash), w, static_cast<const float*>(lse),
                  static_cast<const int*>(targets), static_cast<const float*>(scale),
                  static_cast<__nv_bfloat16*>(dlg), static_cast<__nv_bfloat16*>(dh), n, d, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == kF32 ? launch_bwd<float>(a, device, st) : launch_bwd<__nv_bfloat16>(a, device, st);
  return static_cast<int>(err);
}
