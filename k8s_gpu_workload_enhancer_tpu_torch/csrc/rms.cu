// RMSNorm forward and backward for Hopper: register-lean row pipelines.
//
// Forward: replaces k8s_gpu_workload_enhancer_tpu/ops/rms_pallas.py:
// _rms_fwd_kernel (called from _rms_fwd_call). Per row of x (N, D): an f32
// mean of squares, then x * rsqrt(var + eps) * w in f32, rounded once to x's
// dtype. The products are explicitly rounded multiplies, so the result
// follows the plain version's (x * r) * w order.
//
// Backward: replaces rms_pallas.py:_rms_bwd_kernel (called from
// _rms_bwd_call). With r = rsqrt(mean(x^2) + eps) recomputed from x and
// x_hat = x * r: dx = r * (dy*w - x_hat * mean(dy*w*x_hat)) in f32, rounded
// to x's dtype; dw = sum over all rows of dy * x_hat in f32, returned in
// w's dtype. mean(dy*w*x_hat) is formed as r * mean(dy*w*x), one rounding
// away from the plain version's order.
//
// Bound: bytes, both. A few operations per byte: the forward reads each row
// once and writes it once (2 * N * D * sizeof(T) plus the weight), the
// backward reads x and dy and writes dx (3 * N * D * sizeof(T)); at the
// training shape (16384 rows of 2048, bf16) that is 134 MB and 201 MB.
//
// What bounded the first bodies. The forward ran one short block per row:
// two barriers for its sum, a second global load of the row for the scaled
// write and the weight as eight scalar loads a thread, for every row. The
// backward gave every thread four 16-byte slots of x, dy, w and dw whatever
// the width (about 170 registers), so one 256-thread block fitted an SM
// and each row's loads waited through two barriers with nothing else in
// flight.
//
// The rows now. A row is served by a group of G warps; thread t of the
// group owns the row's 16-byte vectors t, t + 32G, ..., V of them, V a
// template parameter (1, 2, 4, 8), so a thread carries only the registers
// its width needs. A thread's columns are the same in every row, so its
// weights are loaded once, in 16-byte vectors, and serve every row the
// group takes: held in registers where they are at most kWeightRegs floats,
// else staged once a block in shared memory as f32 (bank-spread planes).
// The row stays in registers between its sum and its scaled write (no
// second pass), and the group's next row is loaded before the current one
// is reduced (kAhead), so loads stay in flight through each reduction and
// store. A warp's sum is shuffles only; G > 1 warps add one barrier a row
// over a two-slot exchange in shared memory (a named barrier of its own
// where a block holds several groups).
//
// Forward: G the fewest warps (up to 8) that hold a row at kFwdVecs
// vectors a thread, doubled while there are too few rows for kSpreadWarps
// warps (a decode step's 8 rows, a prefill chunk's 128 take 8 warps of one
// vector: a short chain a thread, one load round trip); V up to 8, so rows
// up to 2048 vectors (16384 bf16 or 8192 f32 columns; 2048 columns on the
// one-element instances, taken where 16 bytes do not divide the width or
// the weight is not 16-byte aligned). A block is one row group; a
// persistent grid of the SMs times the blocks one SM holds (the occupancy
// query), each block walking rows with a stride of the grid. At the
// training width (2048, bf16) that is G 4, V 2: the weights in registers,
// 59 registers, eight 128-thread blocks an SM. Four warps a row measured
// faster than one warp of eight vectors (weights staged, 126 registers)
// and than two of four; one warp holding its eight vectors' f32 weights
// in registers took 204 registers.
//
// Backward: 256-thread blocks; G = 8 warps a row where the row has 256
// vectors or more (V 1 for bf16 up to 2048 columns, 2 up to 4096, 4 up to
// 8192; f32 half those), narrower rows fewer warps and several groups a
// block. Each thread accumulates its columns' dw in registers across its
// group's rows; a block's groups add theirs in shared memory once at the
// end, in group order, and the block writes one f32 row of partial sums.
// The grid is fixed: BWD_PARTS (ops/rms.py) = 528 blocks, block p taking
// rows [p * rows / parts, (p + 1) * rows / parts), and
// rms_dw_finalize_kernel adds the partial rows in a fixed order (64 strided
// runs, then a fixed tree), so dw is bitwise the same from run to run and
// never depends on the card's SM count. 528 = 132 SMs x 4 blocks: the V = 1
// body is held to 64 registers (__launch_bounds__(256, 4)), so four blocks
// fill an H100 SM and the grid is one full wave (512 would leave 16 block
// slots idle). Measured against it: two rows ahead (spills at 64
// registers), three blocks an SM with two or three rows ahead (396 parts),
// five with the weights staged or no row ahead (660 parts): all slower.
// The TPU kernel carries its dw sum across its sequential grid; blocks
// here run in no order, hence the second pass.
//
// Registers, spills and shared memory of every instance (CUDA 12.8,
// `-Xptxas -v`, sm_90a) are printed by chip_smoke.py's `rms_build` line;
// PERF.md §6 keeps those of the main path's instances.
#include <cstdint>

#include "common.cuh"

using namespace ktwe;

namespace {

constexpr int kMaxGroupWarps = 8;    // warps that serve one row, at most
constexpr int kAhead = 1;            // rows a group loads ahead of the one it reduces
constexpr int kWeightRegs = 16;      // weights a thread holds in registers, at most
constexpr int kMaxVecs = 8;          // forward: vectors a thread owns in a row, at most
constexpr int kFwdVecs = 2;          // forward: vectors a thread owns where G allows
constexpr int kSpreadWarps = 1024;   // forward: warps a grid of few rows spreads over
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxVecs = 4;       // backward: vectors a thread owns in a row, at most

// Wait for the `threads` threads of row group g (of `groups` in the
// block): the block barrier for one group, else named barrier 1 + g. The
// ids are literals, so a kernel reserves only the barriers it names.
__device__ __forceinline__ void group_sync(int g, int groups, int threads) {
  if (groups == 1) {
    __syncthreads();
    return;
  }
  switch (g) {
    case 0: asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory"); break;
    case 1: asm volatile("bar.sync 2, %0;" ::"r"(threads) : "memory"); break;
    case 2: asm volatile("bar.sync 3, %0;" ::"r"(threads) : "memory"); break;
    default: asm volatile("bar.sync 4, %0;" ::"r"(threads) : "memory"); break;
  }
}

// N weights from p into f32, 16 bytes a load (the launchers take the
// vector instances only for a 16-byte aligned w, so every vector's weights
// are aligned; N == 1 loads one element).
template <typename W, int N>
__device__ __forceinline__ void load_weights(const W* p, float (&o)[N]) {
  constexpr int kPer = 16 / sizeof(W) < N ? 16 / sizeof(W) : N;
#pragma unroll
  for (int c = 0; c < N; c += kPer) {
    const Vec<W, kPer> v = load_vec<W, kPer>(p + c);
#pragma unroll
    for (int k = 0; k < kPer; ++k) o[c + k] = to_f(v.v[k]);
  }
}

// The block's copy of the weight in f32 shared memory (d floats), laid out
// so a warp reading its vectors' weights touches each bank once: for N % 4
// == 0, N / 4 planes of float4 (plane p holds elements 4p..4p+3 of every
// vector), else one float a column. Loaded once a block, 16 bytes a load.
template <typename W, int N>
__device__ __forceinline__ void stage_weights(const W* __restrict__ w, int n_vec, float* sw) {
  for (int vi = threadIdx.x; vi < n_vec; vi += blockDim.x) {
    float f[N];
    load_weights<W, N>(w + static_cast<long long>(vi) * N, f);
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int p = 0; p < N / 4; ++p) {
        reinterpret_cast<float4*>(sw)[p * n_vec + vi] =
            make_float4(f[4 * p], f[4 * p + 1], f[4 * p + 2], f[4 * p + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) sw[vi * N + j] = f[j];
    }
  }
}

// Vector vi's weights from the staged copy; zeros past the row's end.
template <int N>
__device__ __forceinline__ void read_weights(const float* sw, int n_vec, int vi, float (&f)[N]) {
  if (vi >= n_vec) {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = 0.f;
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int p = 0; p < N / 4; ++p) {
      const float4 v = reinterpret_cast<const float4*>(sw)[p * n_vec + vi];
      f[4 * p] = v.x;
      f[4 * p + 1] = v.y;
      f[4 * p + 2] = v.z;
      f[4 * p + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = sw[vi * N + j];
  }
}

// A thread's weights: its V vectors' N values in registers where they are
// few (V * N <= 16 floats), else the block's copy staged in shared memory
// (d floats) and read a vector at a time, so the registers stay what the
// row needs.
template <typename W, int N, int V>
struct RowWeights {
  static constexpr bool kInRegs = V * N <= kWeightRegs;
  float r[kInRegs ? V : 1][N];

  // Every thread of the block calls this; a barrier must follow before
  // `get` where the weights are staged.
  __device__ __forceinline__ void load(const W* __restrict__ w, float* sw, int t, int gthreads,
                                       int n_vec) {
    if constexpr (kInRegs) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int vi = t + k * gthreads;
        if (vi < n_vec) {
          load_weights<W, N>(w + static_cast<long long>(vi) * N, r[k]);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) r[k][j] = 0.f;
        }
      }
    } else {
      stage_weights<W, N>(w, n_vec, sw);
    }
  }

  __device__ __forceinline__ void get(const float* sw, int k, int vi, int n_vec,
                                      float (&f)[N]) const {
    if constexpr (kInRegs) {
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = r[k][j];
    } else {
      read_weights<N>(sw, n_vec, vi, f);
    }
  }

  static size_t smem_bytes(int d) { return kInRegs ? 0 : static_cast<size_t>(d) * sizeof(float); }
};

// The V vectors thread t of a group of `gthreads` owns in one row; vectors
// past the row's end read as zeros.
template <typename T, int N, int V>
__device__ __forceinline__ void load_row(const T* row, int t, int gthreads, int n_vec,
                                         Vec<T, N> (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = t + k * gthreads;
    if (vi < n_vec) {
      v[k] = load_vec<T, N>(row + static_cast<long long>(vi) * N);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[k].v[j] = from_f<T>(0.f);
    }
  }
}

// Rotate a ring of row buffers held in registers: buffer i takes i + 1's.
template <typename T, int N, int V, int D>
__device__ __forceinline__ void shift_rows(Vec<T, N> (&b)[D][V]) {
#pragma unroll
  for (int i = 0; i + 1 < D; ++i) {
#pragma unroll
    for (int k = 0; k < V; ++k) b[i][k] = b[i + 1][k];
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Block: the G warps of one row group (blockDim.x = 32 G); block b takes
// rows b, b + gridDim.x, ... Dynamic shared memory: the staged weight
// where it is not held in registers (RowWeights).
template <typename T, typename W, int N, int V>
__global__ void __launch_bounds__(kMaxGroupWarps * 32)
    rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                        long long rows, int d, float eps) {
  extern __shared__ __align__(16) float sw[];
  __shared__ float red[2][kMaxGroupWarps];
  const int group_warps = blockDim.x >> 5;
  const int t = threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_vec = d / N;

  const float inv_d = 1.f / static_cast<float>(d);
  const long long stride = gridDim.x;
  long long row = blockIdx.x;
  Vec<T, N> buf[kAhead + 1][V];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const long long r = row + i * stride;
    if (r < rows) load_row<T, N, V>(x + r * d, t, blockDim.x, n_vec, buf[i]);
  }
  RowWeights<W, N, V> wts;
  wts.load(w, sw, t, blockDim.x, n_vec);
  if constexpr (!RowWeights<W, N, V>::kInRegs) __syncthreads();

  int slot = 0;
  for (; row < rows; row += stride) {
    const long long ahead = row + kAhead * stride;
    if (ahead < rows) load_row<T, N, V>(x + ahead * d, t, blockDim.x, n_vec, buf[kAhead]);

    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f(buf[0][k].v[j]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    if (group_warps > 1) {
      if (lane == 0) red[slot][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxGroupWarps; ++i) {
        if (i < group_warps) ss += red[slot][i];
      }
      slot ^= 1;
    }
    const float r = rsqrtf(ss * inv_d + eps);

    T* orow = out + row * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int vi = t + k * blockDim.x;
      if (vi < n_vec) {
        float wk[N];
        wts.get(sw, k, vi, n_vec, wk);
        Vec<T, N> o;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          o.v[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(buf[0][k].v[j]), r), wk[j]));
        }
        store_vec<T, N>(orow + static_cast<long long>(vi) * N, o);
      }
    }
    shift_rows<T, N, V, kAhead + 1>(buf);
  }
}

// The forward's grid cap: SMs times the blocks of 32 << gshift threads
// (with their shared memory for width d) one SM holds, for this instance
// on this device; asked when the width changes and kept, (d, blocks)
// packed in one word.
template <typename T, typename W, int N, int V>
cudaError_t fwd_resident_blocks(int device, int gshift, int d, int* blocks) {
  static unsigned long long cache[kMaxDevices][4];  // by gshift
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  unsigned long long& entry = cache[device][gshift];
  const unsigned long long seen = entry;
  if (static_cast<int>(seen >> 32) == d) {
    *blocks = static_cast<int>(seen & 0xffffffffu);
    return cudaSuccess;
  }
  const size_t smem = RowWeights<W, N, V>::smem_bytes(d);
  auto kernel = rms_norm_fwd_kernel<T, W, N, V>;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 << gshift, smem);
  }
  if (err != cudaSuccess) return err;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  entry = (static_cast<unsigned long long>(d) << 32) | static_cast<unsigned>(n);
  *blocks = n;
  return cudaSuccess;
}

template <typename T, typename W, int N, int V>
cudaError_t launch_fwd_v(const T* x, const W* w, T* out, long long rows, int d, int gshift,
                         float eps, int device, cudaStream_t stream) {
  int resident = 0;
  const cudaError_t err = fwd_resident_blocks<T, W, N, V>(device, gshift, d, &resident);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(rows < resident ? rows : resident);
  const size_t smem = RowWeights<W, N, V>::smem_bytes(d);
  rms_norm_fwd_kernel<T, W, N, V><<<grid, 32 << gshift, smem, stream>>>(x, w, out, rows, d, eps);
  return cudaGetLastError();
}

// The forward's layout for rows of n_vec vectors: 2^gshift warps a row
// (the fewest, up to kMaxGroupWarps, that hold a row at kFwdVecs vectors
// a thread, doubled while the rows are too few to give the grid
// kSpreadWarps warps) and V vectors a thread (a power of two, at most
// kMaxVecs). False past that.
inline bool fwd_layout(int n_vec, long long rows, int* gshift, int* v) {
  if (n_vec > 32 * kMaxGroupWarps * kMaxVecs) return false;
  int s = 0;
  while ((1 << s) < kMaxGroupWarps && (32 << s) * kFwdVecs < n_vec) ++s;
  while ((1 << s) < kMaxGroupWarps && (32 << s) < n_vec && rows * (1 << s) < kSpreadWarps) ++s;
  int k = 1;
  while (k * (32 << s) < n_vec) k *= 2;
  *gshift = s;
  *v = k;
  return true;
}

template <typename T, typename W, int N>
cudaError_t launch_fwd_n(const void* x, const void* w, void* out, long long rows, int d,
                         float eps, int device, cudaStream_t stream) {
  int gshift = 0, v = 0;
  if (!fwd_layout(d / N, rows, &gshift, &v)) return static_cast<cudaError_t>(kBadArgument);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  switch (v) {
    case 1: return launch_fwd_v<T, W, N, 1>(xp, wp, op, rows, d, gshift, eps, device, stream);
    case 2: return launch_fwd_v<T, W, N, 2>(xp, wp, op, rows, d, gshift, eps, device, stream);
    case 4: return launch_fwd_v<T, W, N, 4>(xp, wp, op, rows, d, gshift, eps, device, stream);
    case 8: return launch_fwd_v<T, W, N, 8>(xp, wp, op, rows, d, gshift, eps, device, stream);
    default: return static_cast<cudaError_t>(kBadArgument);
  }
}

// Vectors of 16 bytes where they divide the width and w is 16-byte aligned
// (x is), else one element a vector.
template <typename T>
bool vector_path(int d, const void* w) {
  return d % (16 / sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   int device, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector_path<T>(d, w)) {
    return launch_fwd_n<T, W, kVec>(x, w, out, rows, d, eps, device, stream);
  }
  return launch_fwd_n<T, W, 1>(x, w, out, rows, d, eps, device, stream);
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w, void* out, long long rows, int d, float eps,
                     int w_dtype, int device, cudaStream_t stream) {
  switch (w_dtype) {
    case kF32: return launch<T, float>(x, w, out, rows, d, eps, device, stream);
    case kBF16: return launch<T, __nv_bfloat16>(x, w, out, rows, d, eps, device, stream);
    default: return static_cast<cudaError_t>(kBadArgument);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Grid: `parts` blocks (BWD_PARTS, fewer when rows are fewer), block p taking rows
// [p * rows / parts, (p + 1) * rows / parts); its groups of group_warps
// warps take rows lo + g, lo + g + groups, ... dw_partial: (gridDim.x, d)
// f32. Dynamic shared memory: the staged weight where it is not held in
// registers (RowWeights).
template <typename T, typename W, int N, int V>
__global__ void __launch_bounds__(kBwdThreads, 4 / V)
    rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw_partial, long long rows, int d, int gshift,
                        float eps) {
  extern __shared__ __align__(16) float sw[];
  __shared__ float2 red[2][kBwdThreads / 32];
  const int group_warps = 1 << gshift;
  const int gthreads = 32 << gshift;
  const int g = threadIdx.x >> (5 + gshift);
  const int t = threadIdx.x & (gthreads - 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_vec = d / N;
  const int groups = kBwdThreads >> (5 + gshift);

  const long long lo = rows * blockIdx.x / gridDim.x;
  const long long hi = rows * (blockIdx.x + 1) / gridDim.x;
  long long row = lo + g;
  Vec<T, N> xb[kAhead + 1][V], gb[kAhead + 1][V];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const long long r = row + i * groups;
    if (r < hi) {
      load_row<T, N, V>(x + r * d, t, gthreads, n_vec, xb[i]);
      load_row<T, N, V>(dy + r * d, t, gthreads, n_vec, gb[i]);
    }
  }
  RowWeights<W, N, V> wts;
  wts.load(w, sw, t, gthreads, n_vec);
  float acc[V][N];
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[k][j] = 0.f;
  }
  if constexpr (!RowWeights<W, N, V>::kInRegs) __syncthreads();

  const float inv_d = 1.f / static_cast<float>(d);
  int slot = 0;
  for (; row < hi; row += groups) {
    const long long ahead = row + kAhead * groups;
    if (ahead < hi) {
      load_row<T, N, V>(x + ahead * d, t, gthreads, n_vec, xb[kAhead]);
      load_row<T, N, V>(dy + ahead * d, t, gthreads, n_vec, gb[kAhead]);
    }

    float wk[V][N];
    float2 sums = make_float2(0.f, 0.f);  // (sum x^2, sum dy*w*x)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      wts.get(sw, k, t + k * gthreads, n_vec, wk[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xf = to_f(xb[0][k].v[j]);
        sums.x = fmaf(xf, xf, sums.x);
        sums.y = fmaf(__fmul_rn(to_f(gb[0][k].v[j]), wk[k][j]), xf, sums.y);
      }
    }
    sums.x = warp_sum(sums.x);
    sums.y = warp_sum(sums.y);
    if (group_warps > 1) {
      if (lane == 0) red[slot][warp] = sums;
      group_sync(g, groups, gthreads);
      sums = make_float2(0.f, 0.f);
      for (int i = 0; i < group_warps; ++i) {
        const float2 p = red[slot][g * group_warps + i];
        sums.x += p.x;
        sums.y += p.y;
      }
      slot ^= 1;
    }
    const float r = rsqrtf(sums.x * inv_d + eps);
    const float proj = __fmul_rn(r, sums.y * inv_d);  // mean(dy*w*x_hat)

    T* drow = dx + row * d;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int vi = t + k * gthreads;
      if (vi < n_vec) {
        Vec<T, N> o;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xf = to_f(xb[0][k].v[j]);
          const float gf = to_f(gb[0][k].v[j]);
          const float xhat = __fmul_rn(xf, r);
          const float dyw = __fmul_rn(gf, wk[k][j]);
          o.v[j] = from_f<T>(__fmul_rn(r, __fsub_rn(dyw, __fmul_rn(xhat, proj))));
          acc[k][j] = fmaf(gf, xhat, acc[k][j]);
        }
        store_vec<T, N>(drow + static_cast<long long>(vi) * N, o);
      }
    }
    shift_rows<T, N, V, kAhead + 1>(xb);
    shift_rows<T, N, V, kAhead + 1>(gb);
  }

  // Several groups a block only where a row needs fewer than 8 warps, and
  // then V == 1: groups 1.. hand their sums to group 0, added in order.
  if constexpr (V == 1) {
    if (groups > 1) {
      __shared__ float comb[kBwdThreads][N];
#pragma unroll
      for (int j = 0; j < N; ++j) comb[threadIdx.x][j] = acc[0][j];
      __syncthreads();
      if (g == 0) {
        for (int h = 1; h < groups; ++h) {
#pragma unroll
          for (int j = 0; j < N; ++j) acc[0][j] += comb[t + h * gthreads][j];
        }
      }
    }
  }
  if (g != 0) return;
  float* prow = dw_partial + blockIdx.x * static_cast<long long>(d);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = t + k * gthreads;
    if (vi < n_vec) {
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          Vec<float, 4> s;
#pragma unroll
          for (int i = 0; i < 4; ++i) s.v[i] = acc[k][j + i];
          store_vec<float, 4>(prow + vi * N + j, s);
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) prow[vi * N + j] = acc[k][j];
      }
    }
  }
}

constexpr int kFinLanes = 64;  // partial rows summed side by side per column

// dw[c] = sum_p partial[p][c], in a fixed order: lane y of a column adds
// parts y, y + 64, ... in turn, then the 64 lane sums meet in a fixed tree.
// A block of 256 threads covers 4 * C columns (C a thread, as one load).
template <typename W, int C>
__global__ void __launch_bounds__(256)
    rms_dw_finalize_kernel(const float* __restrict__ partial, int parts, int d,
                           W* __restrict__ dw) {
  __shared__ Vec<float, C> s[kFinLanes][4];
  const int cx = threadIdx.x & 3;
  const int y = threadIdx.x >> 2;
  const int c = (blockIdx.x * 4 + cx) * C;
  Vec<float, C> v;
#pragma unroll
  for (int i = 0; i < C; ++i) v.v[i] = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int p = y; p < parts; p += kFinLanes) {
      const Vec<float, C> a = load_vec<float, C>(partial + static_cast<long long>(p) * d + c);
#pragma unroll
      for (int i = 0; i < C; ++i) v.v[i] += a.v[i];
    }
  }
  s[y][cx] = v;
  __syncthreads();
#pragma unroll
  for (int h = kFinLanes / 2; h > 0; h >>= 1) {
    if (y < h) {
#pragma unroll
      for (int i = 0; i < C; ++i) s[y][cx].v[i] += s[y + h][cx].v[i];
    }
    __syncthreads();
  }
  if (y == 0 && c < d) {
#pragma unroll
    for (int i = 0; i < C; ++i) dw[c + i] = from_f<W>(s[0][cx].v[i]);
  }
}

// The backward's layout: G warps a row (a power of two, at most 8) and V
// vectors a thread (1, 2 or 4). False past 8 warps of 4 vectors.
inline bool bwd_layout(int n_vec, int* gshift, int* v) {
  int s = 0;
  while ((1 << s) < kMaxGroupWarps && (32 << s) < n_vec) ++s;
  int k = 1;
  while (k * (32 << s) < n_vec) k *= 2;
  if (k > kBwdMaxVecs) return false;
  *gshift = s;
  *v = k;
  return true;
}

template <typename T, typename W, int N>
cudaError_t launch_bwd_n(const void* x, const void* w, const void* dy, void* dx, float* partial,
                         void* dw, long long rows, int d, float eps, int parts,
                         cudaStream_t stream) {
  int gshift = 0, v = 0;
  if (!bwd_layout(d / N, &gshift, &v)) return static_cast<cudaError_t>(kBadArgument);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  switch (v) {
    case 1:
      rms_norm_bwd_kernel<T, W, N, 1><<<parts, kBwdThreads, RowWeights<W, N, 1>::smem_bytes(d),
                                        stream>>>(xp, wp, gp, op, partial, rows, d, gshift, eps);
      break;
    case 2:
      rms_norm_bwd_kernel<T, W, N, 2><<<parts, kBwdThreads, RowWeights<W, N, 2>::smem_bytes(d),
                                        stream>>>(xp, wp, gp, op, partial, rows, d, gshift, eps);
      break;
    case 4:
      rms_norm_bwd_kernel<T, W, N, 4><<<parts, kBwdThreads, RowWeights<W, N, 4>::smem_bytes(d),
                                        stream>>>(xp, wp, gp, op, partial, rows, d, gshift, eps);
      break;
    default: return static_cast<cudaError_t>(kBadArgument);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  W* dwp = static_cast<W*>(dw);
  if (d % 4 == 0) {
    rms_dw_finalize_kernel<W, 4><<<(d + 15) / 16, 256, 0, stream>>>(partial, parts, d, dwp);
  } else {
    rms_dw_finalize_kernel<W, 1><<<(d + 3) / 4, 256, 0, stream>>>(partial, parts, d, dwp);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, float* partial,
                       void* dw, long long rows, int d, float eps, int parts,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector_path<T>(d, w)) {
    return launch_bwd_n<T, W, kVec>(x, w, dy, dx, partial, dw, rows, d, eps, parts, stream);
  }
  return launch_bwd_n<T, W, 1>(x, w, dy, dx, partial, dw, rows, d, eps, parts, stream);
}

template <typename T>
cudaError_t launch_bwd_w(const void* x, const void* w, const void* dy, void* dx, float* partial,
                         void* dw, long long rows, int d, float eps, int parts, int w_dtype,
                         cudaStream_t stream) {
  switch (w_dtype) {
    case kF32:
      return launch_bwd<T, float>(x, w, dy, dx, partial, dw, rows, d, eps, parts, stream);
    case kBF16:
      return launch_bwd<T, __nv_bfloat16>(x, w, dy, dx, partial, dw, rows, d, eps, parts, stream);
    default: return static_cast<cudaError_t>(kBadArgument);
  }
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// x, out: (rows, d) contiguous, 16-byte aligned; w: (d,) contiguous. Rows
// of at most 2048 vectors of 16 bytes (2048 columns where 16 bytes do not
// divide d or w is not 16-byte aligned).
KTWE_EXPORT int ktwe_rms_norm_fwd(const void* x, const void* w, void* out, long long rows, int d,
                                  float eps, int x_dtype, int w_dtype, int device, void* stream) {
  if (rows <= 0 || d <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: err = launch_w<float>(x, w, out, rows, d, eps, w_dtype, device, s); break;
    case kBF16: err = launch_w<__nv_bfloat16>(x, w, out, rows, d, eps, w_dtype, device, s); break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}

// x, dy, dx: (rows, d) contiguous, 16-byte aligned, x's dtype; w, dw: (d,)
// in w's dtype; dw_partial: (parts, d) f32 scratch, 16-byte aligned, parts
// <= rows. Rows of at most 1024 vectors of 16 bytes (1024 columns where 16
// bytes do not divide d or w is not 16-byte aligned).
KTWE_EXPORT int ktwe_rms_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                  void* dw_partial, void* dw, long long rows, int d, float eps,
                                  int parts, int x_dtype, int w_dtype, int device, void* stream) {
  if (rows <= 0 || d <= 0 || parts <= 0 || parts > rows || parts > 65535) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(dw_partial);
  switch (x_dtype) {
    case kF32:
      err = launch_bwd_w<float>(x, w, dy, dx, partial, dw, rows, d, eps, parts, w_dtype, s);
      break;
    case kBF16:
      err = launch_bwd_w<__nv_bfloat16>(x, w, dy, dx, partial, dw, rows, d, eps, parts, w_dtype,
                                        s);
      break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}
