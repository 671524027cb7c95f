// Paged decode attention for Hopper: one new token per slot, attending the
// slot's KV through its block table.
//
// Replaces k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py:
// _paged_decode_kernel (launched by paged_decode_attention). It computes what
// that kernel computes, not its schedule:
//   - q (B, H, D) with query heads kv-head-major, so query head h reads KV
//     head h / G (G = H / KH);
//   - K/V pages (NB, BL, KH, D); logical position j of slot b lives in row
//     j % BL of page table[b, j / BL];
//   - scores q.k in f32 times scale, positions j > pos[b] masked to
//     NEG_INF = -1e30 (not -inf);
//   - an online softmax whose running max is clamped at NEG_INF / 2;
//   - p rounded to V's dtype before the PV product, statistics in f32;
//   - the output divided by max(l, 1e-30), stored in q's dtype.
// The TPU kernel walks the pages as a sequential grid axis and carries
// m / l / acc in VMEM from one grid step to the next. Blocks on the card run
// in no order, so here one block owns one (slot, kv-head) pair and loops
// over the slot's positions itself: it reads pos[b] and its table row, and
// walks tiles of 32 logical positions while the tile starts at or before
// pos[b]; each row of a tile finds its own page in the table, so any BL >= 1
// works and a tile may span pages. Positions past pos[b] are never loaded.
//
// The table ids come from the host and are trusted (< NB); the engine keeps
// them so. A parked slot's row is all trash (page 0) at pos max_seq - 1: the
// block walks the trash page and writes output nobody reads.
//
// Bound: bytes. Each block reads its slot's K and V rows for one kv head
// once, (pos + 1) * D * 2 elements, against 4 * G * D flops per position,
// so the card's memory rate bounds it: at the serving shape (8 slots, 4 kv
// heads, D 512, pos ~130-210, bf16) about 11 MB, 3.4 microseconds at
// 3.35 TB/s. What limits this kernel is latency, not bandwidth: it launches
// only B * KH blocks (32 at the serving shape, on 132 SMs), one per SM with
// 4 warps, so nothing hides a load's trip to memory but the block's own
// pipeline. Design: 128 threads; the G query rows sit in shared memory as
// f32; each tile's K and V rows go to shared memory with 16-byte cp.async
// copies whose page rows were looked up once per tile (rows past pos[b] are
// zero-filled, never read), and the copies of tile t + 1 are in flight while
// tile t computes: K(t + 1) lands during tile t's softmax and PV product,
// V(t + 1) during tile t + 1's scores (64 KB per buffer at bf16 and
// D = 512, above the 48 KB default, so the kernel opts in once per device).
// Scores are warp-cooperative dot products (lanes over D, a shuffle
// reduction), one softmax row per warp with one position per lane; each
// thread keeps a (G, D / 128) f32 accumulator in registers, owning columns
// tid + 128 k, with G a compile-time bound (1, 2, 4, 8 or 16) so the PV loop
// is no longer than the group. A split-KV (flash-decoding) schedule that
// fills the card is later work.
#include <cuda_pipeline.h>

#include <atomic>

#include "common.cuh"

using namespace ktwe;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // logical positions per tile (one per lane in the softmax)
constexpr int kMaxD = 512;
constexpr int kMaxG = 16;      // query heads per kv head
constexpr int kCols = kMaxD / kThreads;  // output columns per thread
constexpr float kNegInf = -1e30f;

struct PagedArgs {
  const void* q;      // (B, H, D)
  const void* k;      // (NB, BL, KH, D)
  const void* v;      // (NB, BL, KH, D)
  const int* table;   // (B, MB)
  const int* pos;     // (B,)
  void* o;            // (B, H, D)
  int h, kh, d, bl, mb;
  float scale;
};

template <typename T>
size_t smem_bytes(int g, int d) {
  return sizeof(float) * g * d + 2 * sizeof(T) * kTile * d + sizeof(float) * g * kTile;
}

// kG: a compile-time bound on G = H / KH (the accumulator's rows).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[kG];
  __shared__ float l_s[kG];
  __shared__ float c_s[kG];
  // Page row of each tile row (-1 past pos), for the two tiles in flight.
  __shared__ long long row_s[2][kTile];

  const int d = a.d;
  const int g = a.h / a.kh;
  float* qs = reinterpret_cast<float*>(smem);          // (g, d) f32
  T* ks = reinterpret_cast<T*>(qs + g * d);            // (kTile, d)
  T* vs = ks + kTile * d;                              // (kTile, d)
  float* ps = reinterpret_cast<float*>(vs + kTile * d);  // (g, kTile)

  const int kv_head = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = d / kVec;

  // The G query rows of this kv head are contiguous in (B, H, D).
  const long long q_off = (static_cast<long long>(slot) * a.h + static_cast<long long>(kv_head) * g) * d;
  const T* qb = static_cast<const T*>(a.q) + q_off;
  for (int idx = tid; idx < g * vecs_per_row; idx += kThreads) {
    const Vec<T, kVec> v = load_vec<T, kVec>(qb + idx * kVec);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[idx * kVec + e] = to_f(v.v[e]);
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kG][kCols];
#pragma unroll
  for (int r = 0; r < kG; ++r) {
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  }

  // Positions this slot attends: [0, last]; a table covers mb * bl of them.
  const int* trow = a.table + static_cast<long long>(slot) * a.mb;
  const long long span = static_cast<long long>(a.mb) * a.bl;
  const int last = static_cast<int>(min(static_cast<long long>(a.pos[slot]), span - 1));
  const int n_tiles = last < 0 ? 0 : last / kTile + 1;
  const long long row_stride = static_cast<long long>(a.kh) * d;  // between page rows
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(kv_head) * d;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(kv_head) * d;

  // Look up tile t's page rows (threads 0..31); read after a barrier.
  auto find_rows = [&](int t) {
    if (tid < kTile) {
      const int j = t * kTile + tid;
      row_s[t & 1][tid] = j <= last ? static_cast<long long>(trow[j / a.bl]) * a.bl + j % a.bl : -1;
    }
  };
  // Start the async copy of tile t's rows of `pages` into `dst`, as one
  // commit group; rows past pos are zero-filled.
  auto start_copy = [&](T* dst, const T* pages, int t) {
    const long long* rows = row_s[t & 1];
    for (int idx = tid; idx < kTile * vecs_per_row; idx += kThreads) {
      const int r = idx / vecs_per_row;
      const int c = (idx - r * vecs_per_row) * kVec;
      const long long row = rows[r];
      __pipeline_memcpy_async(dst + r * d + c, row >= 0 ? pages + row * row_stride + c : pages,
                              16, row >= 0 ? 0 : 16);
    }
    __pipeline_commit();
  };

  if (n_tiles > 0) find_rows(0);
  __syncthreads();
  if (n_tiles > 0) {
    start_copy(ks, kb, 0);
    start_copy(vs, vb, 0);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const bool more = t + 1 < n_tiles;
    __pipeline_wait_prior(1);  // this thread's K(t) copies landed
    __syncthreads();

    // Scores: each warp takes (query row, position) pairs; lanes split D.
    for (int p = warp; p < g * kTile; p += kWarps) {
      const int r = p / kTile;
      const int j = p - r * kTile;
      const float* qr = qs + r * d;
      const T* kr = ks + j * d;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qr[c], to_f(kr[c]), s);
      s = warp_sum(s);
      if (lane == 0) ps[r * kTile + j] = j0 + j <= last ? __fmul_rn(s, a.scale) : kNegInf;
    }
    if (more) find_rows(t + 1);
    __syncthreads();  // K(t) consumed; tile t + 1's rows visible
    if (more) {
      start_copy(ks, kb, t + 1);
    } else {
      __pipeline_commit();  // an empty group keeps the wait counts aligned
    }

    // Online softmax: one query row per warp, one position per lane.
    for (int r = warp; r < g; r += kWarps) {
      const float s = ps[r * kTile + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, warp_max(s)), kNegInf * 0.5f);
      const float p = expf(s - m_new);
      const float corr = expf(m_prev - m_new);
      const float p_sum = warp_sum(p);
      ps[r * kTile + lane] = to_f(from_f<T>(p));  // p in V's dtype for the PV product
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + p_sum;
        c_s[r] = corr;
      }
    }
    __pipeline_wait_prior(1);  // this thread's V(t) copies landed
    __syncthreads();

    // acc = acc * corr + p V over this tile, for this thread's columns.
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = tid + u * kThreads;
      if (c < d) {
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          if (r < g) acc[r][u] *= c_s[r];
        }
        for (int j = 0; j < kTile; ++j) {
          const float vv = to_f(vs[j * d + c]);
#pragma unroll
          for (int r = 0; r < kG; ++r) {
            if (r < g) acc[r][u] = fmaf(ps[r * kTile + j], vv, acc[r][u]);
          }
        }
      }
    }
    __syncthreads();  // V(t) consumed
    if (more) {
      start_copy(vs, vb, t + 1);
    } else {
      __pipeline_commit();
    }
  }

  T* ob = static_cast<T*>(a.o) + q_off;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int c = tid + u * kThreads;
    if (c < d) {
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (r < g) ob[r * d + c] = from_f<T>(acc[r][u] / fmaxf(l_s[r], 1e-30f));
      }
    }
  }
}

template <typename T, int kG>
cudaError_t launch(const PagedArgs& a, int batch, int device, cudaStream_t stream) {
  // The shared-memory opt-in belongs to the kernel on a device: set it once
  // per device, for the largest head_dim, not on every launch.
  static std::atomic<bool> opted_in[kMaxDevices];
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, kG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T>(kG, kMaxD)));
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid(a.kh, batch);
  paged_decode_kernel<T, kG><<<grid, kThreads, smem_bytes<T>(a.h / a.kh, a.d), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_group(const PagedArgs& a, int batch, int device, cudaStream_t stream) {
  const int g = a.h / a.kh;
  if (g <= 1) return launch<T, 1>(a, batch, device, stream);
  if (g <= 2) return launch<T, 2>(a, batch, device, stream);
  if (g <= 4) return launch<T, 4>(a, batch, device, stream);
  if (g <= 8) return launch<T, 8>(a, batch, device, stream);
  return launch<T, kMaxG>(a, batch, device, stream);
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// q, o: (batch, h, d); k, v: (nb, bl, kh, d), one dtype; table: (batch, mb)
// int32 page ids < nb; pos: (batch,) int32. All contiguous, 16-byte aligned.
KTWE_EXPORT int ktwe_paged_decode_fwd(const void* q, const void* k, const void* v,
                                      const void* table, const void* pos, void* o, int batch,
                                      int h, int kh, int d, int nb, int bl, int mb, float scale,
                                      int dtype, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || kh <= 0 || h % kh != 0 || h / kh > kMaxG ||
      d <= 0 || d > kMaxD || d % 8 != 0 || nb <= 0 || bl <= 0 || mb <= 0 || device < 0 ||
      device >= kMaxDevices) {
    return kBadArgument;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  PagedArgs a{q, k, v, static_cast<const int*>(table), static_cast<const int*>(pos), o,
              h, kh, d, bl, mb, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: err = launch_group<float>(a, batch, device, s); break;
    case kBF16: err = launch_group<__nv_bfloat16>(a, batch, device, s); break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}
