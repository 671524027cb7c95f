// (B, S, H, D) <-> (B*H, S, D) relayout for Hopper: two kernels.
//
// Replace, in k8s_gpu_workload_enhancer_tpu/ops/relayout.py:
//   - _to_t_kernel (called from _to_t_call): x (B, S, H, D) -> (B*H, S, D),
//     the flash kernels' flat layout;
//   - _from_t_kernel (_from_t_call): x (B*H, S, D) -> (B, S, H, D).
// Each is the other's VJP. Both copy bits: any 2- or 4-byte element type.
//
// Bound: bytes. Each element is read once and written once. The TPU kernels
// moved (bs, h, d) blocks through VMEM and restacked the head axis. Here
// each (b, s, h) row of D elements is contiguous in both layouts (1 KB at
// bf16 and D 512), so no shared-memory transpose is needed: one warp per
// row walks its input row 16 bytes a lane, neighbouring lanes on
// neighbouring columns, and writes it whole to its row in the other
// layout. Rows are visited in input order by a grid-stride loop; the index
// remap is computed once a row, in 64-bit offsets.
#include "common.cuh"

using namespace ktwe;

namespace {

// kToFlat: input rows (b, s, h) of (B, S, H, D), output rows (b, h, s) of
// (B*H, S, D); otherwise the reverse. T is an unsigned integer type of the
// element's width; N elements a lane moves at a time.
template <typename T, int N, bool kToFlat>
__global__ void relayout_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows,
                                long long seq, long long heads, int width) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int groups = width / N;
  for (long long row = warp; row < rows; row += warps) {
    long long orow;
    if constexpr (kToFlat) {  // row = (b * S + s) * H + h
      const long long bs = row / heads;
      const long long h = row - bs * heads;
      const long long b = bs / seq;
      orow = (b * heads + h) * seq + (bs - b * seq);
    } else {                  // row = (b * H + h) * S + s
      const long long bh = row / seq;
      const long long s = row - bh * seq;
      const long long b = bh / heads;
      orow = (b * seq + s) * heads + (bh - b * heads);
    }
    const T* src = x + row * width;
    T* dst = out + orow * width;
#pragma unroll 4
    for (int g = lane; g < groups; g += 32) {
      store_vec<T, N>(dst + g * N, load_vec<T, N>(src + g * N));
    }
  }
}

constexpr int kThreads = 256;  // 8 warps, 8 rows a block at a time

template <typename T, bool kToFlat>
cudaError_t launch(const void* x, void* out, long long rows, long long seq, long long heads,
                   int width, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (width % kVec == 0) {
    relayout_kernel<T, kVec, kToFlat><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, op, rows, seq, heads, width);
  } else {
    relayout_kernel<T, 1, kToFlat><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, op, rows, seq, heads, width);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dir(int to_flat, const void* x, void* out, long long rows, long long seq,
                       long long heads, int width, cudaStream_t stream) {
  return to_flat ? launch<T, true>(x, out, rows, seq, heads, width, stream)
                 : launch<T, false>(x, out, rows, seq, heads, width, stream);
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// to_flat 1: x (batch, seq, heads, width) -> out (batch * heads, seq, width)
// (_to_t_kernel); to_flat 0: x (batch * heads, seq, width) -> out (batch,
// seq, heads, width) (_from_t_kernel). Both contiguous and 16-byte aligned;
// elem_bytes is the element's width (2 or 4), the bits are copied as they
// are.
KTWE_EXPORT int ktwe_relayout(const void* x, void* out, long long batch, long long seq,
                              long long heads, int width, int elem_bytes, int to_flat, int device,
                              void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || width <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const long long rows = batch * seq * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: err = launch_dir<unsigned short>(to_flat, x, out, rows, seq, heads, width, st); break;
    case 4: err = launch_dir<unsigned int>(to_flat, x, out, rows, seq, heads, width, st); break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}
