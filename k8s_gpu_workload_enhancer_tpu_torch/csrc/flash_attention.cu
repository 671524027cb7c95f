// Causal flash-attention forward for Hopper.
//
// Replaces k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py:_flash_kernel
// (called from _flash_forward_lse_flat). It computes what that kernel
// computes, on the model's (B, S, H, D) layout directly:
//   - scores q.k accumulated in f32 from the inputs, multiplied by
//     D^-0.5 after the product, masked on GLOBAL positions
//     q_offset + i >= kv_offset + j with NEG_INF = -1e30 (not -inf);
//   - an online softmax whose running max is clamped at NEG_INF / 2, so a
//     fully masked row ends with l == 0 and output 0, never NaN;
//   - l summed from the f32 p; P rounded to V's dtype before the PV
//     product; the output divided by max(l, 1e-30); optional LSE
//     (B, H, Sq) f32 in natural log, LSE_MASKED for fully masked rows;
//   - KV tiles wholly past the tile's last query row are never loaded.
// GQA is taken natively: query head h reads KV head h / (H / KH).
//
// Two bodies, chosen by dtype in ktwe_flash_attention_fwd (not a fallback:
// a bf16 call never reaches the f32 body).
//
// bf16: tensor cores (wgmma) on tiles that TMA loads under mbarriers
// (csrc/sm90.cuh). Bound: causal attention is 4 B Sq Sk H D / 2 flops
// against 2 (Sq H + 2 Sk KH) D bytes, so at every main-path shape it is
// operations that bound it (989 TFLOP/s bf16: 0.139 ms at the trainer's
// (8, 2048, 16, 128) and at the flagship's flat (32, 2048, 1, 512)); the
// serving prefill (Sq 128 against 256 keys) is 8 blocks and bound by
// latency. One block is one query tile of one (batch, head): warpgroup 0
// is the producer (one thread issues every TMA load, the warpgroup gives
// its registers away with setmaxnreg), warpgroups 1 and 2 consume. Tiles
// are TMA boxes of 64 head-dim columns (the 128-byte swizzle's width),
// loaded on a 4-D map over (B, S, H, D) with the real strides, so nothing
// is relayouted and TMA's zero fill supplies the Sq and Sk tails and the
// columns past a D that is not a multiple of 64. S = Q K^T is wgmma with
// both operands in shared memory (K-major), P V takes P from registers
// (the S accumulator converted to bf16 fragments in place: the reference's
// p.astype(v.dtype)) and V from shared memory MN-major (the descriptor's
// transpose bit). Softmax uses exp2f on log2(e)-scaled differences.
// Heavy causal query tiles launch first (reverse tile order on the
// slowest grid axis), so the tail of the grid is short.
//   - head_dim <= 128 (the trainer's 128; 64, 72 and smaller zero-filled):
//     128 query rows a block, one consumer warpgroup per 64 rows, K and V
//     tiles of 128 keys in a two-stage ring. Shared memory: Q 32 KB +
//     2 x (K + V) 128 KB = 160 KB. Registers: O 64 x 128 and S 64 x 128
//     f32 are 64 + 64 a consumer thread.
//   - head_dim <= 512 (serving and the flagship at 512; 256 too): a
//     64 x 512 f32 output tile is 256 registers a thread in one
//     warpgroup, more than a thread has. So the two consumer warpgroups
//     split O's columns (64 x 256 each, 128 registers) and each computes
//     the whole S = Q K^T itself: the same wgmma sequence on the same
//     tiles gives both the same S bit for bit, so m, l and the rescale
//     agree without an exchange (the price is the S product twice: 1.5x
//     the tensor work of the ideal). 64 query rows and K and V tiles of 64
//     keys in one stage with separate K and V barriers, so the next K
//     tile loads during softmax and P V and the next V tile during Q K^T.
//     Shared memory: Q 64 KB + K 64 KB + V 64 KB = 192 KB.
//   Registers: `-Xptxas -v` (CUDA 12.8) reports 168 a thread at launch for
//   both instances (384 threads, one block an SM) with no spill and no
//   stack; setmaxnreg then gives the consumers 240 and the producer 24.
//   Static shared memory is the mbarriers (80 and 48 bytes). P's bf16
//   fragments are all written before wgmma.fence: written between the
//   fence and the product, ptxas fences each product itself and
//   serialises them (its warning C7520).
//   Not yet done: overlapping one tile's softmax with the next tile's
//   Q K^T inside a warpgroup, and a deeper ring at head_dim 512. Times
//   beside the bound and SDPA: PERF.md, section 6, row 6.
//
// Head dims above 512 (either dtype, off every main path) take a
// column-sliced variant of the f32-pipe body (flash_fwd_sliced_kernel); a
// head_dim that is not a multiple of 8 is zero-padded by the wrapper.
//
// f32: the f32 pipes (the f32 training gates need true f32 products, which
// TF32 wgmma would not give). 16 query rows per block, 256 threads each
// owning D / 256 output columns for all 16 rows; K and V stream through
// shared memory in 32-row tiles (opted in above 48 KB once per device).
// Scores are warp-cooperative dot products (lanes over D, then a shuffle
// reduction), one softmax row per warp with lanes over the 32 keys.
#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

using namespace ktwe;

namespace {

constexpr int kBQ = 16;        // query rows per block
constexpr int kBK = 32;        // keys per tile (one per lane in the softmax)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 512;
constexpr int kCols = kMaxD / kThreads;  // output columns per thread
constexpr float kNegInf = -1e30f;
constexpr float kLseMasked = 1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int sq, sk, h, kh, d;
  int causal;
  long long q_offset, kv_offset;
  float scale;
};

template <typename T>
size_t smem_bytes(int d) {
  return sizeof(float) * kBQ * d + 2 * sizeof(T) * kBK * d + sizeof(float) * kBQ * kBK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kBQ];
  __shared__ float l_s[kBQ];
  __shared__ float c_s[kBQ];

  const int d = a.d;
  float* qs = reinterpret_cast<float*>(smem);       // (kBQ, d) f32
  T* ks = reinterpret_cast<T*>(qs + kBQ * d);       // (kBK, d)
  T* vs = ks + kBK * d;                             // (kBK, d)
  float* ps = reinterpret_cast<float*>(vs + kBK * d);  // (kBQ, kBK)

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (a.h / a.kh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long q_stride = static_cast<long long>(a.h) * d;    // between sequence rows
  const long long kv_stride = static_cast<long long>(a.kh) * d;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(batch) * a.sq * q_stride +
                static_cast<long long>(head) * d;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(batch) * a.sk * kv_stride +
                static_cast<long long>(kv_head) * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(batch) * a.sk * kv_stride +
                static_cast<long long>(kv_head) * d;

  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = d / kVec;

  // Q tile -> shared f32; rows past Sq are zero and never stored.
  for (int idx = tid; idx < kBQ * vecs_per_row; idx += kThreads) {
    const int r = idx / vecs_per_row;
    const int c = (idx - r * vecs_per_row) * kVec;
    float* dst = qs + r * d + c;
    if (q0 + r < a.sq) {
      const Vec<T, kVec> v = load_vec<T, kVec>(qb + (q0 + r) * q_stride + c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = to_f(v.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    }
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kBQ][kCols];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  }

  // KV tiles this query tile needs: causal stops at the tile holding the
  // largest key position the last query row may see.
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int n_tiles = (a.sk + kBK - 1) / kBK;
  if (a.causal) {
    const long long last_key = a.q_offset + q_last - a.kv_offset;
    if (last_key < 0) {
      n_tiles = 0;
    } else if (last_key / kBK + 1 < n_tiles) {
      n_tiles = static_cast<int>(last_key / kBK + 1);
    }
  }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    for (int idx = tid; idx < kBK * vecs_per_row; idx += kThreads) {
      const int r = idx / vecs_per_row;
      const int c = (idx - r * vecs_per_row) * kVec;
      Vec<T, kVec> kv, vv;
      if (k0 + r < a.sk) {
        kv = load_vec<T, kVec>(kb + (k0 + r) * kv_stride + c);
        vv = load_vec<T, kVec>(vb + (k0 + r) * kv_stride + c);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          kv.v[e] = from_f<T>(0.f);
          vv.v[e] = from_f<T>(0.f);
        }
      }
      store_vec<T, kVec>(ks + r * d + c, kv);
      store_vec<T, kVec>(vs + r * d + c, vv);
    }
    __syncthreads();

    // Scores: each warp takes (row, key) pairs; lanes split D.
    for (int p = warp; p < kBQ * kBK; p += kWarps) {
      const int r = p / kBK;
      const int j = p - r * kBK;
      const float* qr = qs + r * d;
      const T* kr = ks + j * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qr[c], to_f(kr[c]), s);
      s = warp_sum(s);
      if (lane == 0) {
        const bool visible =
            k0 + j < a.sk &&
            (!a.causal || a.q_offset + q0 + r >= a.kv_offset + k0 + j);
        ps[r * kBK + j] = visible ? __fmul_rn(s, a.scale) : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one row per warp, one key per lane.
    for (int r = warp; r < kBQ; r += kWarps) {
      const float s = ps[r * kBK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, warp_max(s)), kNegInf * 0.5f);
      const float p = expf(s - m_new);
      const float corr = expf(m_prev - m_new);
      const float p_sum = warp_sum(p);
      ps[r * kBK + lane] = to_f(from_f<T>(p));  // P in V's dtype for the PV product
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + p_sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this tile, for this thread's columns.
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = tid + u * kThreads;
      if (c < d) {
#pragma unroll
        for (int r = 0; r < kBQ; ++r) acc[r][u] *= c_s[r];
        for (int j = 0; j < kBK; ++j) {
          const float vv = to_f(vs[j * d + c]);
#pragma unroll
          for (int r = 0; r < kBQ; ++r) acc[r][u] = fmaf(ps[r * kBK + j], vv, acc[r][u]);
        }
      }
    }
    __syncthreads();
  }

  T* ob = static_cast<T*>(a.o) + static_cast<long long>(batch) * a.sq * q_stride +
          static_cast<long long>(head) * d;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = tid + u * kThreads;
    if (c < d) {
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        if (q0 + r < a.sq) {
          ob[(q0 + r) * q_stride + c] = from_f<T>(acc[r][u] / fmaxf(l_s[r], 1e-30f));
        }
      }
    }
  }
  if (a.lse != nullptr && tid < kBQ && q0 + tid < a.sq) {
    const float l = l_s[tid];
    a.lse[(static_cast<long long>(batch) * a.h + head) * a.sq + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-30f)) : kLseMasked;
  }
}

template <typename T>
cudaError_t launch(const FlashArgs& a, int batch, int device, cudaStream_t stream) {
  // The shared-memory opt-in belongs to the kernel on a device: set it once
  // per device, for the largest head_dim, not on every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T>(kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, batch);
  flash_fwd_kernel<T><<<grid, kThreads, smem_bytes<T>(a.d), stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims above 512 (f32 and bf16; off every main path): the f32-pipe body
// with a grid axis over 512-column slices of O. A block computes its query
// tile's scores over the whole D, 512 columns of Q and K at a time through
// the same shared-memory tiles, and writes only its slice of O (and, in
// slice 0, the LSE); every slice computes the same scores bit for bit, so
// their softmax statistics agree without an exchange.
// ---------------------------------------------------------------------------

constexpr int kSlice = 512;

template <typename T>
size_t sliced_smem_bytes() {
  return sizeof(float) * kBQ * kSlice + 2 * sizeof(T) * kBK * kSlice +
         sizeof(float) * kBQ * kBK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_sliced_kernel(FlashArgs a, int slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kBQ];
  __shared__ float l_s[kBQ];
  __shared__ float c_s[kBQ];

  const int d = a.d;
  float* qs = reinterpret_cast<float*>(smem);          // (kBQ, kSlice) f32: a chunk of Q
  T* ks = reinterpret_cast<T*>(qs + kBQ * kSlice);     // (kBK, kSlice): a chunk of K
  T* vs = ks + kBK * kSlice;                           // (kBK, kSlice): the slice of V
  float* ps = reinterpret_cast<float*>(vs + kBK * kSlice);  // (kBQ, kBK)

  const int slice = blockIdx.x % slices;
  const int q0 = blockIdx.x / slices * kBQ;
  const int col0 = slice * kSlice;
  const int wv = min(kSlice, d - col0);
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (a.h / a.kh);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long q_stride = static_cast<long long>(a.h) * d;
  const long long kv_stride = static_cast<long long>(a.kh) * d;
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(batch) * a.sq * q_stride +
                static_cast<long long>(head) * d;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(batch) * a.sk * kv_stride +
                static_cast<long long>(kv_head) * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(batch) * a.sk * kv_stride +
                static_cast<long long>(kv_head) * d;
  constexpr int kVec = 16 / sizeof(T);

  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kBQ][kCols];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  }
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  int n_tiles = (a.sk + kBK - 1) / kBK;
  if (a.causal) {
    const long long last_key = a.q_offset + q_last - a.kv_offset;
    if (last_key < 0) {
      n_tiles = 0;
    } else if (last_key / kBK + 1 < n_tiles) {
      n_tiles = static_cast<int>(last_key / kBK + 1);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    for (int i = tid; i < kBQ * kBK; i += kThreads) ps[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kSlice) {
      const int vpr = min(kSlice, d - c0) / kVec;
      __syncthreads();  // the last chunk's (or tile's) readers are done
      for (int idx = tid; idx < kBQ * vpr; idx += kThreads) {
        const int r = idx / vpr;
        const int c = (idx - r * vpr) * kVec;
        float* dst = qs + r * kSlice + c;
        if (q0 + r < a.sq) {
          const Vec<T, kVec> v = load_vec<T, kVec>(qb + (q0 + r) * q_stride + c0 + c);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dst[e] = to_f(v.v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
        }
      }
      for (int idx = tid; idx < kBK * vpr; idx += kThreads) {
        const int r = idx / vpr;
        const int c = (idx - r * vpr) * kVec;
        Vec<T, kVec> kv;
        if (k0 + r < a.sk) {
          kv = load_vec<T, kVec>(kb + (k0 + r) * kv_stride + c0 + c);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kv.v[e] = from_f<T>(0.f);
        }
        store_vec<T, kVec>(ks + r * kSlice + c, kv);
      }
      __syncthreads();
      const int w = vpr * kVec;
      for (int p = warp; p < kBQ * kBK; p += kWarps) {
        const float* qr = qs + (p / kBK) * kSlice;
        const T* kr = ks + (p % kBK) * kSlice;
        float s = 0.f;
        for (int c = lane; c < w; c += 32) s = fmaf(qr[c], to_f(kr[c]), s);
        s = warp_sum(s);
        if (lane == 0) ps[p] += s;
      }
    }
    // This slice of V; rows past Sk are zero.
    const int vpr = wv / kVec;
    for (int idx = tid; idx < kBK * vpr; idx += kThreads) {
      const int r = idx / vpr;
      const int c = (idx - r * vpr) * kVec;
      Vec<T, kVec> vv;
      if (k0 + r < a.sk) {
        vv = load_vec<T, kVec>(vb + (k0 + r) * kv_stride + col0 + c);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) vv.v[e] = from_f<T>(0.f);
      }
      store_vec<T, kVec>(vs + r * kSlice + c, vv);
    }
    __syncthreads();

    // Online softmax: one row per warp, one key per lane.
    for (int r = warp; r < kBQ; r += kWarps) {
      const bool visible = k0 + lane < a.sk &&
                           (!a.causal || a.q_offset + q0 + r >= a.kv_offset + k0 + lane);
      const float s = visible ? __fmul_rn(ps[r * kBK + lane], a.scale) : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, warp_max(s)), kNegInf * 0.5f);
      const float p = expf(s - m_new);
      const float corr = expf(m_prev - m_new);
      const float p_sum = warp_sum(p);
      ps[r * kBK + lane] = to_f(from_f<T>(p));
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + p_sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = tid + u * kThreads;
      if (c < wv) {
#pragma unroll
        for (int r = 0; r < kBQ; ++r) acc[r][u] *= c_s[r];
        for (int j = 0; j < kBK; ++j) {
          const float vv = to_f(vs[j * kSlice + c]);
#pragma unroll
          for (int r = 0; r < kBQ; ++r) acc[r][u] = fmaf(ps[r * kBK + j], vv, acc[r][u]);
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();

  T* ob = static_cast<T*>(a.o) + static_cast<long long>(batch) * a.sq * q_stride +
          static_cast<long long>(head) * d + col0;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = tid + u * kThreads;
    if (c < wv) {
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        if (q0 + r < a.sq) {
          ob[(q0 + r) * q_stride + c] = from_f<T>(acc[r][u] / fmaxf(l_s[r], 1e-30f));
        }
      }
    }
  }
  if (slice == 0 && a.lse != nullptr && tid < kBQ && q0 + tid < a.sq) {
    const float l = l_s[tid];
    a.lse[(static_cast<long long>(batch) * a.h + head) * a.sq + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-30f)) : kLseMasked;
  }
}

template <typename T>
cudaError_t launch_sliced(const FlashArgs& a, int batch, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sliced_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sliced_smem_bytes<T>()));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const int slices = (a.d + kSlice - 1) / kSlice;
  const long long blocks_x = static_cast<long long>((a.sq + kBQ - 1) / kBQ) * slices;
  if (blocks_x > 0x7fffffffLL) return static_cast<cudaError_t>(kBadArgument);
  const dim3 grid(static_cast<unsigned>(blocks_x), a.h, batch);
  flash_fwd_sliced_kernel<T><<<grid, kThreads, sliced_smem_bytes<T>(), stream>>>(a, slices);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

using namespace ktwe::sm90;

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int DPAD_, int BQ_, int BK_, int STAGES_>
struct Shape {
  static constexpr int DPAD = DPAD_;                 // widest head_dim taken
  static constexpr int BQ = BQ_;                     // query rows a block
  static constexpr int BK = BK_;                     // keys a tile
  static constexpr int STAGES = STAGES_;             // K and V ring depth
  static constexpr int ROW_WGS = BQ / 64;            // consumers over rows
  static constexpr int NO = DPAD * ROW_WGS / kConsumers;  // O columns a consumer
  static constexpr int Q_BYTES = BQ * DPAD * 2;
  static constexpr int KV_BYTES = BK * DPAD * 2;     // one K or V stage
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + kAtomBytes;  // + alignment
  static_assert(ROW_WGS * (DPAD / NO) == kConsumers, "consumers cover the tile once");
};
using Small = Shape<128, 128, 128, 2>;
using Large = Shape<512, 64, 64, 1>;

struct Args {
  void* o;
  float* lse;
  int sq, sk, h, kh, d;
  int causal;
  long long q_offset, kv_offset;
  float scale;
  int n_qtiles;
};

// KV tiles of `bk` keys that query rows up to `last_row` need.
__device__ __forceinline__ int tiles_for(const Args& a, int last_row, int bk) {
  int n = (a.sk + bk - 1) / bk;
  if (a.causal) {
    const long long last_key = a.q_offset + last_row - a.kv_offset;
    if (last_key < 0) return 0;
    if (last_key / bk + 1 < n) n = static_cast<int>(last_key / bk + 1);
  }
  return n;
}

template <int BK>
__device__ __forceinline__ void mma_qk(float (&s)[BK / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BK == 128) {
    wgmma_m64n128k16_ss(s, da, db, acc);
  } else {
    static_assert(BK == 64, "S tile of 64 or 128 keys");
    wgmma_m64n64k16_ss(s, da, db, acc);
  }
}

template <int NO>
__device__ __forceinline__ void mma_pv(float (&o)[NO / 2], const uint32_t (&p)[4],
                                       uint64_t db) {
  if constexpr (NO == 128) {
    wgmma_m64n128k16_rs_tb(o, p, db, 1);
  } else {
    static_assert(NO == 256, "O tile of 128 or 256 columns");
    wgmma_m64n256k16_rs_tb(o, p, db, 1);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <class S>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[S::STAGES], k_empty[S::STAGES];
  __shared__ __align__(8) uint64_t v_full[S::STAGES], v_empty[S::STAGES];

  // Swizzle atoms need 1024-byte alignment.
  unsigned char* q_s = smem_raw + ((kAtomBytes - (smem_u32(smem_raw) & (kAtomBytes - 1))) &
                                   (kAtomBytes - 1));
  unsigned char* k_s = q_s + S::Q_BYTES;                 // STAGES x KV_BYTES
  unsigned char* v_s = k_s + S::STAGES * S::KV_BYTES;    // STAGES x KV_BYTES

  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (a.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * S::BQ;  // heavy tiles first
  const int kv_head = head / (a.h / a.kh);
  const int d_chunks = (a.d + kSwizzleCols - 1) / kSwizzleCols;
  const int n_tiles = tiles_for(a, min(q0 + S::BQ, a.sq) - 1, S::BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int st = 0; st < S::STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kConsumers * 4);   // lane 0 of every consumer warp
      mbar_init(&v_empty[st], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&q_full, d_chunks * S::BQ * kBoxRowBytes);
      for (int c = 0; c < d_chunks; ++c) {
        tma_load_4d(q_s + c * S::BQ * kBoxRowBytes, &q_map, &q_full, c * kSwizzleCols, head,
                    q0, batch);
      }
      const uint32_t tile_bytes = d_chunks * S::BK * kBoxRowBytes;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S::STAGES;
        const uint32_t free_parity = ((t / S::STAGES) & 1) ^ 1;  // first round passes
        const int k0 = t * S::BK;
        unsigned char* kt = k_s + st * S::KV_BYTES;
        unsigned char* vt = v_s + st * S::KV_BYTES;
        mbar_wait(&k_empty[st], free_parity);
        mbar_arrive_expect_tx(&k_full[st], tile_bytes);
        for (int c = 0; c < d_chunks; ++c) {
          tma_load_4d(kt + c * S::BK * kBoxRowBytes, &k_map, &k_full[st], c * kSwizzleCols,
                      kv_head, k0, batch);
        }
        mbar_wait(&v_empty[st], free_parity);
        mbar_arrive_expect_tx(&v_full[st], tile_bytes);
        for (int c = 0; c < d_chunks; ++c) {
          tma_load_4d(vt + c * S::BK * kBoxRowBytes, &v_map, &v_full[st], c * kSwizzleCols,
                      kv_head, k0, batch);
        }
      }
    }
    return;
  }

  // Consumers.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int row_wg = S::ROW_WGS == 2 ? cw : 0;
  const int col_wg = S::ROW_WGS == 2 ? 0 : cw;
  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int quad = lane & 3;
  const int first_row = q0 + row_wg * 64;                 // this warpgroup's rows
  const int row0 = first_row + warp * 16 + (lane >> 2);   // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  // Tiles this warpgroup computes; past them every one of its rows masks
  // the whole tile, which adds exactly nothing, so it only hands them back.
  const int my_tiles = (first_row >= a.sq || col_wg * S::NO >= a.d)
                           ? 0
                           : tiles_for(a, min(first_row + 64, a.sq) - 1, S::BK);

  float o[S::NO / 2];
#pragma unroll
  for (int i = 0; i < S::NO / 2; ++i) o[i] = 0.f;
  float sc[S::BK / 2];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(&q_full, 0);
  const uint32_t q_addr = smem_u32(q_s) + row_wg * 64 * kBoxRowBytes;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S::STAGES;
    const uint32_t parity = (t / S::STAGES) & 1;
    const int k0 = t * S::BK;
    mbar_wait(&k_full[st], parity);
    if (t >= my_tiles) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[st]);
      mbar_wait(&v_full[st], parity);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[st]);
      continue;
    }

    // S = Q K^T over the head_dim, 16 columns a step.
    const uint32_t k_addr = smem_u32(k_s + st * S::KV_BYTES);
    wgmma_fence();
    for (int ks = 0; ks < d_chunks * 4; ++ks) {
      const uint32_t col_bytes = (ks & 3) * 32;
      mma_qk<S::BK>(sc,
                    desc_sw128(q_addr + (ks >> 2) * S::BQ * kBoxRowBytes + col_bytes, 16,
                               kAtomBytes),
                    desc_sw128(k_addr + (ks >> 2) * S::BK * kBoxRowBytes + col_bytes, 16,
                               kAtomBytes),
                    ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[st]);

    // Scale after the product, mask, online softmax; p overwrites sc.
    const bool edge = k0 + S::BK > a.sk ||
                      (a.causal && a.kv_offset + k0 + S::BK - 1 > a.q_offset + first_row);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < S::BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = __fmul_rn(sc[4 * j + e], a.scale);
        float x1 = __fmul_rn(sc[4 * j + 2 + e], a.scale);
        if (edge) {
          const int key = k0 + 8 * j + 2 * quad + e;
          const long long kpos = a.kv_offset + key;
          if (key >= a.sk || (a.causal && a.q_offset + row0 < kpos)) x0 = kNegInf;
          if (key >= a.sk || (a.causal && a.q_offset + row1 < kpos)) x1 = kNegInf;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(fmaxf(m0, quad_max(mx0)), kNegInf * 0.5f);
    const float mn1 = fmaxf(fmaxf(m1, quad_max(mx1)), kNegInf * 0.5f);
    const float corr0 = exp2f((m0 - mn0) * kLog2e);
    const float corr1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < S::BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f((sc[4 * j + e] - mn0) * kLog2e);
        const float p1 = exp2f((sc[4 * j + 2 + e] - mn1) * kLog2e);
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        ps0 += p0;
        ps1 += p1;
      }
    }
    l0 = l0 * corr0 + ps0;   // this thread's share of the row; summed at the end
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int j = 0; j < S::NO / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // O += P V: P from registers in bf16, V MN-major, 16 keys a step. The
    // A fragments are all written before the fence, so the compiler need
    // not fence (and serialise) each product itself.
    uint32_t pa[S::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
    mbar_wait(&v_full[st], parity);
    const uint32_t v_addr =
        smem_u32(v_s + st * S::KV_BYTES) + col_wg * (S::NO / kSwizzleCols) * S::BK * kBoxRowBytes;
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
      mma_pv<S::NO>(o, pa[kk],
                    desc_sw128(v_addr + kk * 16 * kBoxRowBytes, S::BK * kBoxRowBytes,
                               kAtomBytes));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[st]);
  }

  // Epilogue: O / max(l, 1e-30) in bf16 at the (B, S, H, D) strides.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o);
  const long long q_stride = static_cast<long long>(a.h) * a.d;
  const long long base = (static_cast<long long>(batch) * a.sq) * q_stride +
                         static_cast<long long>(head) * a.d;
#pragma unroll
  for (int j = 0; j < S::NO / 8; ++j) {
    const int col = col_wg * S::NO + 8 * j + 2 * quad;
    if (col < a.d) {   // d is a multiple of 8, so col + 1 < d too
      if (row0 < a.sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + base + row0 * q_stride + col) =
            __floats2bfloat162_rn(o[4 * j] / den0, o[4 * j + 1] / den0);
      }
      if (row1 < a.sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + base + row1 * q_stride + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
      }
    }
  }
  if (a.lse != nullptr && col_wg == 0 && quad == 0) {
    float* lse = a.lse + (static_cast<long long>(batch) * a.h + head) * a.sq;
    if (row0 < a.sq) lse[row0] = l0 > 0.f ? m0 + logf(den0) : kLseMasked;
    if (row1 < a.sq) lse[row1] = l1 > 0.f ? m1 + logf(den1) : kLseMasked;
  }
}

template <class S>
cudaError_t launch(const FlashArgs& fa, int batch, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const int n_qtiles = (fa.sq + S::BQ - 1) / S::BQ;
  if (n_qtiles > 65535) return static_cast<cudaError_t>(kBadArgument);
  // Maps are built per call on the host and passed by value: nothing is
  // allocated, and a captured CUDA graph keeps its own copy.
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_bshd_map(&q_map, fa.q, batch, fa.sq, fa.h, fa.d, S::BQ);
  if (err == cudaSuccess) err = make_bshd_map(&k_map, fa.k, batch, fa.sk, fa.kh, fa.d, S::BK);
  if (err == cudaSuccess) err = make_bshd_map(&v_map, fa.v, batch, fa.sk, fa.kh, fa.d, S::BK);
  if (err != cudaSuccess) return err;
  const Args a{fa.o, fa.lse, fa.sq, fa.sk, fa.h, fa.kh, fa.d, fa.causal ? 1 : 0,
               fa.q_offset, fa.kv_offset, fa.scale, n_qtiles};
  const dim3 grid(fa.h, batch, n_qtiles);
  flash_fwd_wgmma_kernel<S><<<grid, kThreads, S::SMEM, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

KTWE_DEFINE_ERROR_STRING

// q, o: (batch, sq, h, d); k, v: (batch, sk, kh, d); all contiguous, one
// dtype, 16-byte aligned; d a multiple of 8 (the wrapper pads other head
// dims with zero columns). lse: (batch, h, sq) f32 or null. d above 512
// runs the column-sliced f32-pipe body in either dtype.
KTWE_EXPORT int ktwe_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int batch, int sq, int sk, int h, int kh,
                                         int d, int causal, long long q_offset,
                                         long long kv_offset, float scale, int dtype, int device,
                                         void* stream) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || sk <= 0 || h <= 0 || h > 65535 || kh <= 0 ||
      h % kh != 0 || d <= 0 || d % 8 != 0 || device < 0 || device >= kMaxDevices) {
    return kBadArgument;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  FlashArgs a{q, k, v, o, static_cast<float*>(lse), sq, sk, h, kh, d, causal != 0,
              q_offset, kv_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kMaxD) {
    switch (dtype) {
      case kF32: err = launch_sliced<float>(a, batch, device, s); break;
      case kBF16: err = launch_sliced<__nv_bfloat16>(a, batch, device, s); break;
      default: return kBadArgument;
    }
    return static_cast<int>(err);
  }
  switch (dtype) {
    case kF32: err = launch<float>(a, batch, device, s); break;
    case kBF16:
      err = d <= tc::Small::DPAD ? tc::launch<tc::Small>(a, batch, device, s)
                                 : tc::launch<tc::Large>(a, batch, device, s);
      break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the body that `dtype` and `d` select
// asks for (bytes), for reports; 0 for arguments the launcher refuses.
KTWE_EXPORT int ktwe_flash_attention_smem(int d, int dtype) {
  if (d <= 0 || d % 8 != 0) return 0;
  if (d > kMaxD) {
    switch (dtype) {
      case kF32: return static_cast<int>(sliced_smem_bytes<float>());
      case kBF16: return static_cast<int>(sliced_smem_bytes<__nv_bfloat16>());
      default: return 0;
    }
  }
  switch (dtype) {
    case kF32: return static_cast<int>(smem_bytes<float>(d));
    case kBF16: return d <= tc::Small::DPAD ? tc::Small::SMEM : tc::Large::SMEM;
    default: return 0;
  }
}
