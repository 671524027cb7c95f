// Embedding gather for Hopper: one kernel.
//
// Replaces k8s_gpu_workload_enhancer_tpu/ops/embed_pallas.py:_gather_kernel
// (called from _gather_call): out[n] = cast_out(f32(table[row(ids[n])]) *
// scale), for a (V, D) table of f32 or bf16 and an output of either type.
// row() is the JAX model's gather clamp: a negative id wraps once by V,
// then the id is clamped into [0, V - 1]. With round_rows set, each row is
// first rounded to the output type (the model's `table.astype(dt)[ids]`
// before its scale), so an f32 master table gives the model's bf16
// embedding without a cast of the whole table.
//
// Bound: bytes. Each gathered row is read once and each output row written
// once, one multiply an element. The TPU kernel viewed the table as
// (V, 8, D/8) so a row was a tiling-aligned tile, and kept G = 8 row DMAs
// in flight a grid step. Here a row is D contiguous elements on both sides
// (4 KB at bf16 and D 2048), so the design is one warp per output row: the
// warp's lanes read the row 16 bytes each, neighbouring lanes on
// neighbouring columns, a grid-stride loop over rows. One lane's id load
// per row is broadcast through L1 to the other lanes. Ids are read through
// their two strides, so a sliced token batch (`tokens[:, :-1]`) needs no
// copy, and int32 or int64 ids need no cast. The multiply is rounded
// explicitly (no fused multiply-add), bit for bit with the plain version.
#include "common.cuh"

using namespace ktwe;

namespace {

// N elements a lane moves at a time: 16 bytes of the wider of the two
// types (a 16-byte load and an 8-byte store when the types differ), or 1
// when N does not divide the row.
template <typename Tin, typename Tout, typename Tid, int N, bool kRoundRows>
__global__ void embed_gather_kernel(const Tin* __restrict__ table, const Tid* __restrict__ ids,
                                    Tout* __restrict__ out, long long rows, long long cols,
                                    long long id_stride0, long long id_stride1, long long vocab,
                                    int width, float scale) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int groups = width / N;
  for (long long n = warp; n < rows; n += warps) {
    const long long b = n / cols;
    const long long s = n - b * cols;
    long long id = static_cast<long long>(ids[b * id_stride0 + s * id_stride1]);
    if (id < 0) id += vocab;
    id = id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
    const Tin* src = table + id * width;
    Tout* dst = out + n * width;
#pragma unroll 4
    for (int g = lane; g < groups; g += 32) {
      const Vec<Tin, N> v = load_vec<Tin, N>(src + g * N);
      Vec<Tout, N> o;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float f = to_f(v.v[k]);
        if constexpr (kRoundRows) f = to_f(from_f<Tout>(f));
        o.v[k] = from_f<Tout>(__fmul_rn(f, scale));
      }
      store_vec<Tout, N>(dst + g * N, o);
    }
  }
}

constexpr int kThreads = 256;  // 8 warps, 8 rows a block at a time

template <typename Tin, typename Tout, typename Tid, bool kRoundRows>
cudaError_t launch(const void* table, const void* ids, void* out, long long rows, long long cols,
                   long long s0, long long s1, long long vocab, int width, float scale,
                   cudaStream_t stream) {
  constexpr int kWide = sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout);
  constexpr int kVec = 16 / kWide;
  long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 132 * 16) blocks = 132 * 16;
  const Tin* t = static_cast<const Tin*>(table);
  const Tid* i = static_cast<const Tid*>(ids);
  Tout* o = static_cast<Tout*>(out);
  if (width % kVec == 0) {
    embed_gather_kernel<Tin, Tout, Tid, kVec, kRoundRows>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(t, i, o, rows, cols, s0, s1,
                                                                 vocab, width, scale);
  } else {
    embed_gather_kernel<Tin, Tout, Tid, 1, kRoundRows>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(t, i, o, rows, cols, s0, s1,
                                                                 vocab, width, scale);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout, typename Tid>
cudaError_t dispatch_round(int round_rows, const void* table, const void* ids, void* out,
                           long long rows, long long cols, long long s0, long long s1,
                           long long vocab, int width, float scale, cudaStream_t stream) {
  return round_rows
             ? launch<Tin, Tout, Tid, true>(table, ids, out, rows, cols, s0, s1, vocab, width,
                                            scale, stream)
             : launch<Tin, Tout, Tid, false>(table, ids, out, rows, cols, s0, s1, vocab, width,
                                             scale, stream);
}

template <typename Tin, typename Tout>
cudaError_t dispatch_ids(int id_bytes, int round_rows, const void* table, const void* ids,
                         void* out, long long rows, long long cols, long long s0, long long s1,
                         long long vocab, int width, float scale, cudaStream_t stream) {
  if (id_bytes == 4) {
    return dispatch_round<Tin, Tout, int>(round_rows, table, ids, out, rows, cols, s0, s1, vocab,
                                          width, scale, stream);
  }
  return dispatch_round<Tin, Tout, long long>(round_rows, table, ids, out, rows, cols, s0, s1,
                                              vocab, width, scale, stream);
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// table: (vocab, width) contiguous, 16-byte aligned, dtype table_dtype;
// ids: int32 (id_bytes 4) or int64 (id_bytes 8), element (b, s) at
// b * id_stride0 + s * id_stride1 for b < rows / cols, s < cols (strides in
// elements); out: (rows, width) contiguous, 16-byte aligned, dtype
// out_dtype. round_rows 1 rounds each row to out_dtype before the scale.
KTWE_EXPORT int ktwe_embed_gather(const void* table, const void* ids, void* out, long long rows,
                                  long long cols, long long id_stride0, long long id_stride1,
                                  long long vocab, int width, float scale, int id_bytes,
                                  int round_rows, int table_dtype, int out_dtype, int device,
                                  void* stream) {
  if (rows <= 0 || cols <= 0 || rows % cols || vocab <= 0 || width <= 0) return kBadArgument;
  if (id_bytes != 4 && id_bytes != 8) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long s0 = id_stride0, s1 = id_stride1;
  if (table_dtype == kF32 && out_dtype == kF32) {
    err = dispatch_ids<float, float>(id_bytes, round_rows, table, ids, out, rows, cols, s0, s1,
                                     vocab, width, scale, st);
  } else if (table_dtype == kF32 && out_dtype == kBF16) {
    err = dispatch_ids<float, __nv_bfloat16>(id_bytes, round_rows, table, ids, out, rows, cols,
                                             s0, s1, vocab, width, scale, st);
  } else if (table_dtype == kBF16 && out_dtype == kF32) {
    err = dispatch_ids<__nv_bfloat16, float>(id_bytes, round_rows, table, ids, out, rows, cols,
                                             s0, s1, vocab, width, scale, st);
  } else if (table_dtype == kBF16 && out_dtype == kBF16) {
    err = dispatch_ids<__nv_bfloat16, __nv_bfloat16>(id_bytes, round_rows, table, ids, out, rows,
                                                     cols, s0, s1, vocab, width, scale, st);
  } else {
    return kBadArgument;
  }
  return static_cast<int>(err);
}
