// Rotate-half RoPE for Hopper: three kernels.
//
// Replace, in k8s_gpu_workload_enhancer_tpu/ops/rope_pallas.py:
//   - _rope_kernel (called from _rope_call): x (B, S, H, D) -> (B, S, H, D);
//   - _rope_t_kernel (_rope_t_call): x (B, S, H, D) -> (B*H, S, D), the
//     flash kernels' flat layout, rotated and relaid out in one pass;
//   - _rope_t_inv_kernel (_rope_t_inv_call): a cotangent (B*H, S, D) ->
//     (B, S, H, D), rotated with -sin (the inverse rotation, RoPE's VJP).
// Pairs (i, i + D/2) are rotated by f32 cos/sin rows (S, D/2) that the
// caller has already sliced at the position offset: [x1*c - x2*s,
// x2*c + x1*s] in f32, rounded once to x's dtype.
//
// Bound: bytes. Each element is read once and written once, with four
// multiplies and two adds per pair. Design: one thread per group of pairs
// that fills a 16-byte load of each half, neighbouring threads on
// neighbouring columns, a grid-stride loop over all rows. The cos/sin rows
// are small and stay in L2. Multiplies and adds are explicitly rounded (no
// fused multiply-add) so the result is bit-identical to the plain version.
// The layout-changing pair walks the rows of its input in order and writes
// each rotated row to its place in the other layout: a row is D contiguous
// elements (1 KB at bf16 and D 512), so both the reads and the scattered
// row writes stay whole 16-byte accesses, neighbouring threads on
// neighbouring columns.
#include "common.cuh"

using namespace ktwe;

namespace {

template <typename T, int N>
__global__ void rope_fwd_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t, T* __restrict__ out,
                                long long rows, int seq, int heads, int half) {
  const long long groups_per_row = half / N;
  const long long total = rows * groups_per_row;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / groups_per_row;
    const int i = static_cast<int>(g - row * groups_per_row) * N;
    const int pos = static_cast<int>((row / heads) % seq);
    const T* xr = x + row * 2 * half;
    T* orow = out + row * 2 * half;
    const Vec<T, N> a = load_vec<T, N>(xr + i);
    const Vec<T, N> b = load_vec<T, N>(xr + half + i);
    const float* c = cos_t + static_cast<long long>(pos) * half + i;
    const float* s = sin_t + static_cast<long long>(pos) * half + i;
    Vec<T, N> o1, o2;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x1 = to_f(a.v[k]);
      const float x2 = to_f(b.v[k]);
      o1.v[k] = from_f<T>(__fsub_rn(__fmul_rn(x1, c[k]), __fmul_rn(x2, s[k])));
      o2.v[k] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[k]), __fmul_rn(x1, s[k])));
    }
    store_vec<T, N>(orow + i, o1);
    store_vec<T, N>(orow + half + i, o2);
  }
}

// kToFlat: input (B, S, H, D) rows, output (B*H, S, D) rows; otherwise the
// reverse. kNegSin rotates by -sin (the inverse rotation).
template <typename T, int N, bool kToFlat, bool kNegSin>
__global__ void rope_t_kernel(const T* __restrict__ x, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, T* __restrict__ out,
                              long long rows, int seq, int heads, int half) {
  const long long groups_per_row = half / N;
  const long long total = rows * groups_per_row;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < total;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / groups_per_row;
    const int i = static_cast<int>(g - row * groups_per_row) * N;
    int pos;
    long long orow_idx;
    if constexpr (kToFlat) {  // row = (b * S + s) * H + h
      const long long bs = row / heads;
      const int h = static_cast<int>(row - bs * heads);
      const long long b = bs / seq;
      pos = static_cast<int>(bs - b * seq);
      orow_idx = (b * heads + h) * seq + pos;
    } else {                  // row = (b * H + h) * S + s
      const long long bh = row / seq;
      pos = static_cast<int>(row - bh * seq);
      const long long b = bh / heads;
      const int h = static_cast<int>(bh - b * heads);
      orow_idx = (b * seq + pos) * heads + h;
    }
    const T* xr = x + row * 2 * half;
    T* orow = out + orow_idx * 2 * half;
    const Vec<T, N> a = load_vec<T, N>(xr + i);
    const Vec<T, N> b = load_vec<T, N>(xr + half + i);
    const float* c = cos_t + static_cast<long long>(pos) * half + i;
    const float* s = sin_t + static_cast<long long>(pos) * half + i;
    Vec<T, N> o1, o2;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float x1 = to_f(a.v[k]);
      const float x2 = to_f(b.v[k]);
      const float sk = kNegSin ? -s[k] : s[k];
      o1.v[k] = from_f<T>(__fsub_rn(__fmul_rn(x1, c[k]), __fmul_rn(x2, sk)));
      o2.v[k] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[k]), __fmul_rn(x1, sk)));
    }
    store_vec<T, N>(orow + i, o1);
    store_vec<T, N>(orow + half + i, o2);
  }
}

long long grid_for(long long groups, int threads) {
  const long long blocks = (groups + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;
}

template <typename T, bool kToFlat>
cudaError_t launch_t(const void* x, const float* cos_t, const float* sin_t, void* out,
                     long long rows, int seq, int heads, int half, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = half % kVec == 0;
  const long long blocks = grid_for(rows * (vec ? half / kVec : half), kThreads);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  // The flat-to-model direction is the VJP: the inverse rotation.
  if (vec) {
    rope_t_kernel<T, kVec, kToFlat, !kToFlat><<<static_cast<unsigned>(blocks), kThreads, 0,
                                                  stream>>>(xp, cos_t, sin_t, op, rows, seq,
                                                            heads, half);
  } else {
    rope_t_kernel<T, 1, kToFlat, !kToFlat><<<static_cast<unsigned>(blocks), kThreads, 0,
                                              stream>>>(xp, cos_t, sin_t, op, rows, seq, heads,
                                                        half);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* cos_t, const float* sin_t, void* out,
                   long long rows, int seq, int heads, int half, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = half % kVec == 0;
  const long long groups = rows * (vec ? half / kVec : half);
  constexpr int kThreads = 256;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec) {
    rope_fwd_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, cos_t, sin_t, op, rows, seq, heads, half);
  } else {
    rope_fwd_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, cos_t, sin_t, op, rows, seq, heads, half);
  }
  return cudaGetLastError();
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// x, out: (batch, seq, heads, 2 * half) contiguous, 16-byte aligned;
// cos_t, sin_t: (seq, half) f32 contiguous.
KTWE_EXPORT int ktwe_rope_fwd(const void* x, const void* cos_t, const void* sin_t, void* out,
                              long long batch, int seq, int heads, int half, int dtype,
                              int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || half <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const long long rows = batch * seq * heads;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: err = launch<float>(x, c, s, out, rows, seq, heads, half, st); break;
    case kBF16: err = launch<__nv_bfloat16>(x, c, s, out, rows, seq, heads, half, st); break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}

// x: (batch, seq, heads, 2 * half); out: (batch * heads, seq, 2 * half); both
// contiguous and 16-byte aligned. cos_t, sin_t: (seq, half) f32 contiguous.
// to_flat 1 rotates x into the flat layout (_rope_t_kernel); to_flat 0 reads
// x as (batch * heads, seq, 2 * half), rotates it by -sin and writes out as
// (batch, seq, heads, 2 * half) (_rope_t_inv_kernel).
KTWE_EXPORT int ktwe_rope_t(const void* x, const void* cos_t, const void* sin_t, void* out,
                            long long batch, int seq, int heads, int half, int to_flat,
                            int dtype, int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || half <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const long long rows = batch * seq * heads;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = to_flat ? launch_t<float, true>(x, c, s, out, rows, seq, heads, half, st)
                  : launch_t<float, false>(x, c, s, out, rows, seq, heads, half, st);
  } else if (dtype == kBF16) {
    err = to_flat ? launch_t<__nv_bfloat16, true>(x, c, s, out, rows, seq, heads, half, st)
                  : launch_t<__nv_bfloat16, false>(x, c, s, out, rows, seq, heads, half, st);
  } else {
    return kBadArgument;
  }
  return static_cast<int>(err);
}
