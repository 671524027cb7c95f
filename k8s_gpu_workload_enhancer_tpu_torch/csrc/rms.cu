// RMSNorm forward and backward for Hopper.
//
// Forward: replaces k8s_gpu_workload_enhancer_tpu/ops/rms_pallas.py:
// _rms_fwd_kernel (called from _rms_fwd_call). Per row of x (N, D): an f32
// mean of squares, then x * rsqrt(var + eps) * w in f32, rounded once to x's
// dtype.
//
// Bound: bytes. It reads each row once and writes it once (2 * N * D *
// sizeof(T) plus the weight); the arithmetic is a few operations per byte.
// At the serving decode shape (8 rows of 2048) it moves 64 KB, so it is
// bound by launch latency before bandwidth. Design: one block per row, each
// thread moving 16 bytes per load; the row is summed with warp shuffles and
// one shared-memory pass across warps, then re-read from L1/L2 for the
// scaled write (the row is at most a few KB). The products are written with
// explicitly rounded multiplies so the result matches the plain version's
// (x * r) * w order.
//
// Backward: replaces rms_pallas.py:_rms_bwd_kernel (called from
// _rms_bwd_call). With r = rsqrt(mean(x^2) + eps) recomputed from x and
// x_hat = x * r: dx = r * (dy*w - x_hat * mean(dy*w*x_hat)) in f32, rounded
// to x's dtype; dw = sum over all rows of dy * x_hat in f32, returned in
// w's dtype.
//
// Bound: bytes. It reads x and dy and writes dx (3 * N * D * sizeof(T)), a
// few operations per byte; at the training shape (16384 rows of 2048, bf16)
// that is ~201 MB. Design: a fixed grid of kBwdParts blocks, each walking a
// contiguous run of rows. A thread owns the same columns (16-byte vectors)
// in every row, so its share of dw accumulates in registers across the run
// with no atomics; both row sums (x^2 and dy*w*x) go through one block
// reduction per row. Each block then writes one f32 row of partial dw sums,
// and a second small kernel adds the kBwdParts partials in a fixed order
// (eight strided runs, then the eight run totals), so dw is bitwise
// deterministic from run to run. The TPU kernel carries its dw sum across
// its sequential grid; blocks here run in no order, hence the second pass.
// mean(dy*w*x_hat) is formed as r * mean(dy*w*x), one rounding away from
// the plain version's order.
#include <climits>

#include "common.cuh"

using namespace ktwe;

namespace {

__device__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

template <typename T, typename W, int N>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                                    T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int step = blockDim.x * N;

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += step) {
    const Vec<T, N> v = load_vec<T, N>(xr + i);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f(v.v[k]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = threadIdx.x * N; i < d; i += step) {
    const Vec<T, N> v = load_vec<T, N>(xr + i);
    Vec<T, N> o;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      o.v[k] = from_f<T>(__fmul_rn(__fmul_rn(to_f(v.v[k]), r), to_f(w[i + k])));
    }
    store_vec<T, N>(orow + i, o);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0;
  const int n = vec ? kVec : 1;
  int threads = ((d / n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const dim3 grid(static_cast<unsigned>(rows));
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    rms_norm_fwd_kernel<T, W, kVec><<<grid, threads, 0, stream>>>(xp, wp, op, d, eps);
  } else {
    rms_norm_fwd_kernel<T, W, 1><<<grid, threads, 0, stream>>>(xp, wp, op, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w, void* out, long long rows, int d, float eps,
                     int w_dtype, cudaStream_t stream) {
  switch (w_dtype) {
    case kF32: return launch<T, float>(x, w, out, rows, d, eps, stream);
    case kBF16: return launch<T, __nv_bfloat16>(x, w, out, rows, d, eps, stream);
    default: return static_cast<cudaError_t>(kBadArgument);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdMaxIter = 4;  // 16-byte vectors a thread owns in a row

__device__ float2 block_sum2(float2 v) {
  __shared__ float2 partial[32];
  __shared__ float2 total;
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? partial[lane] : make_float2(0.f, 0.f);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// Grid: one block per part; block p takes rows [p * rpb, (p + 1) * rpb).
// Thread t owns vectors t, t + blockDim.x, ... (at most kBwdMaxIter) of a
// row. dw_partial: (gridDim.x, d) f32.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kBwdThreads)
    rms_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw_partial, long long rows, int d, float eps) {
  const int n_vec = d / N;
  float wv[kBwdMaxIter][N], acc[kBwdMaxIter][N];
#pragma unroll
  for (int it = 0; it < kBwdMaxIter; ++it) {
    const int c = (threadIdx.x + it * blockDim.x) * N;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      wv[it][k] = c < d ? to_f(w[c + k]) : 0.f;
      acc[it][k] = 0.f;
    }
  }
  const long long rpb = (rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = blockIdx.x * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0; row < r1; ++row) {
    float xv[kBwdMaxIter][N], gv[kBwdMaxIter][N];
    float2 sums = make_float2(0.f, 0.f);  // (sum x^2, sum dy*w*x)
#pragma unroll
    for (int it = 0; it < kBwdMaxIter; ++it) {
      const int vi = threadIdx.x + it * blockDim.x;
      if (vi < n_vec) {
        const Vec<T, N> a = load_vec<T, N>(x + row * d + vi * N);
        const Vec<T, N> b = load_vec<T, N>(dy + row * d + vi * N);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          xv[it][k] = to_f(a.v[k]);
          gv[it][k] = to_f(b.v[k]);
          sums.x = fmaf(xv[it][k], xv[it][k], sums.x);
          sums.y = fmaf(__fmul_rn(gv[it][k], wv[it][k]), xv[it][k], sums.y);
        }
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) xv[it][k] = gv[it][k] = 0.f;
      }
    }
    sums = block_sum2(sums);
    const float r = rsqrtf(sums.x * inv_d + eps);
    const float proj = __fmul_rn(r, sums.y * inv_d);  // mean(dy*w*x_hat)
#pragma unroll
    for (int it = 0; it < kBwdMaxIter; ++it) {
      const int vi = threadIdx.x + it * blockDim.x;
      if (vi < n_vec) {
        Vec<T, N> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xhat = __fmul_rn(xv[it][k], r);
          const float dyw = __fmul_rn(gv[it][k], wv[it][k]);
          o.v[k] = from_f<T>(__fmul_rn(r, __fsub_rn(dyw, __fmul_rn(xhat, proj))));
          acc[it][k] = fmaf(gv[it][k], xhat, acc[it][k]);
        }
        store_vec<T, N>(dx + row * d + vi * N, o);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kBwdMaxIter; ++it) {
    const int vi = threadIdx.x + it * blockDim.x;
    if (vi < n_vec) {
#pragma unroll
      for (int k = 0; k < N; ++k) dw_partial[blockIdx.x * static_cast<long long>(d) + vi * N + k] = acc[it][k];
    }
  }
}

// dw[c] = sum_p partial[p][c], in a fixed order: thread (x, y) of a 32 x 8
// block sums parts y, y + 8, ... of column c, then row y == 0 adds the eight.
template <typename W>
__global__ void rms_dw_finalize_kernel(const float* __restrict__ partial, int parts, int d,
                                       W* __restrict__ dw) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < d) {
    for (int p = threadIdx.y; p < parts; p += 8) v += partial[static_cast<long long>(p) * d + c];
  }
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += s[y][threadIdx.x];
    dw[c] = from_f<W>(t);
  }
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, float* partial,
                       void* dw, long long rows, int d, float eps, int parts,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0;
  const int n = vec ? kVec : 1;
  const int n_vec = d / n;
  int threads = ((n_vec + 31) / 32) * 32;
  threads = threads > kBwdThreads ? kBwdThreads : threads;
  if (n_vec > threads * kBwdMaxIter) return static_cast<cudaError_t>(kBadArgument);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  if (vec) {
    rms_norm_bwd_kernel<T, W, kVec><<<parts, threads, 0, stream>>>(xp, wp, gp, op, partial, rows,
                                                                    d, eps);
  } else {
    rms_norm_bwd_kernel<T, W, 1><<<parts, threads, 0, stream>>>(xp, wp, gp, op, partial, rows, d,
                                                                 eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_finalize_kernel<W><<<(d + 31) / 32, dim3(32, 8), 0, stream>>>(partial, parts, d,
                                                                        static_cast<W*>(dw));
  return cudaGetLastError();
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

// x, out: (rows, d) contiguous, 16-byte aligned; w: (d,) contiguous.
KTWE_EXPORT int ktwe_rms_norm_fwd(const void* x, const void* w, void* out, long long rows, int d,
                                  float eps, int x_dtype, int w_dtype, int device, void* stream) {
  if (rows <= 0 || rows > INT_MAX || d <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: err = launch_w<float>(x, w, out, rows, d, eps, w_dtype, s); break;
    case kBF16: err = launch_w<__nv_bfloat16>(x, w, out, rows, d, eps, w_dtype, s); break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}

// x, dy, dx: (rows, d) contiguous, 16-byte aligned, x's dtype; w, dw: (d,)
// in w's dtype; dw_partial: (parts, d) f32 scratch, parts <= rows.
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
