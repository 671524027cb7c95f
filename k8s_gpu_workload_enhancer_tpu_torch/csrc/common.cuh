// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built by `nvcc -shared` into its own .so with a
// plain C interface (ops/kernels.py loads it with ctypes). Each exported
// launcher returns 0 on success, a cudaError_t code when the launch was
// refused, or kBadArgument when the arguments describe a shape the kernel
// does not take (the Python wrappers check first, so that code means a
// wrapper bug).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define KTWE_EXPORT extern "C" __attribute__((visibility("default")))

namespace ktwe {

// Element type codes shared with ops/kernels.py (DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kBadArgument = 1000;
constexpr int kMaxDevices = 64;

// Make `device` current for the calling thread; no call into the runtime's
// device switch when it already is (the common case on the hot path).
inline cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round-to-nearest-even, the rounding torch's `.to(dtype)` uses.
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements moved as one aligned load/store (16 bytes when N*sizeof(T) == 16).
template <typename T, int N> struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& v) {
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// Cache hints for data a kernel touches once, for 16-byte vectors (other
// sizes take the plain access). load_once: read-only, not kept in L1, and
// L2 asked to fetch the 256-byte block around the address. store_once:
// evict-first in L2 (st.global.cs), for output nothing reads back before
// the next kernel.
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_once(const T* p) {
  if constexpr (sizeof(Vec<T, N>) == 16) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return *reinterpret_cast<const Vec<T, N>*>(&r);
  } else {
    return load_vec<T, N>(p);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_once(T* p, const Vec<T, N>& v) {
  if constexpr (sizeof(Vec<T, N>) == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
  } else {
    store_vec<T, N>(p, v);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ktwe

// Human-readable text for a launcher's return code.
#define KTWE_DEFINE_ERROR_STRING                                             \
  KTWE_EXPORT const char* ktwe_error_string(int code) {                      \
    if (code == ktwe::kBadArgument) return "argument not taken by kernel"; \
    return cudaGetErrorString(static_cast<cudaError_t>(code));              \
  }
