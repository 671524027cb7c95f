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
// (4 KB at bf16 and D 2048), and what sets the time differs with the id
// count: at a decode step (8 ids) or a prefill chunk (128) the card is
// latency-bound, so the work must spread over many SMs and each thread
// must wait on as few dependent steps as it can; at a training microbatch
// (16384 ids) it is bytes-bound, so enough 16-byte loads must be in flight.
// The first port (one warp a row, 8 rows a block) ran a decode step on one
// SM and a prefill chunk on 16, each lane two to four dependent round trips
// after a 64-bit division and the id's load.
//
// The design: a block covers R rows x a column slice of T threads x V
// vectors of 16 bytes (of the wider of the two types), neighbouring
// threads on neighbouring vectors. Each thread reads its row's id itself
// (the threads of a warp share the address, so the warp makes one request;
// this measured faster than one read a row broadcast through shared
// memory, whose barrier sits on the critical path), through the ids' two
// strides, so a sliced token batch such as `tokens[:, :-1]` needs no copy
// and int32 or int64 ids no cast: ids of one run need no division, the
// strided view a 32-bit one. Then it issues its V loads before any of its
// stores: one round trip after the id's. The launcher picks V = 1 in
// 128-thread blocks while one wave of the card holds every vector (8 ids:
// 16 blocks; 128 ids: 256 blocks), else V = 2 in 256-thread blocks; the
// output is written evict-first (st.global.cs), as nothing reads it back
// before the next kernel, worth 1.5 % at the training microbatch. A row
// width that is not a multiple of the vector takes one-element vectors.
// The multiply is rounded explicitly (no fused multiply-add), bit for bit
// with the plain version; rounding a row to the output type is skipped
// where the table has that type already (it is the identity there).
#include <type_traits>

#include "common.cuh"

using namespace ktwe;

namespace {

constexpr int kMaxThreads = 256;
// Vectors a thread moves where one wave of resident threads cannot hold
// them all; below that, one.
constexpr int kLargeV = 2;
// Threads a block while every vector fits one wave (spreads a decode
// step's and a prefill chunk's rows over more SMs; 32, 64 and 256 measured
// slower).
constexpr int kSmallThreads = 128;
// Resident threads on the card at once: 132 SMs x 2048.
constexpr long long kOneWave = 132LL * 2048;

// N elements a vector; V vectors a thread; a block of blockDim.x threads
// is R = blockDim.x >> tx_log2 rows x (1 << tx_log2) threads along a row,
// and blockIdx.y picks the column slice of (1 << tx_log2) * V vectors.
template <typename Tin, typename Tout, typename Tid, int N, int V, bool kRoundRows>
__global__ void __launch_bounds__(kMaxThreads)
    embed_gather_kernel(const Tin* __restrict__ table, const Tid* __restrict__ ids,
                        Tout* __restrict__ out, long long rows, long long cols,
                        long long id_stride0, long long id_stride1, long long vocab, int width,
                        int tx_log2, float scale) {
  const long long n = static_cast<long long>(blockIdx.x) * (blockDim.x >> tx_log2) +
                      (threadIdx.x >> tx_log2);
  if (n >= rows) return;
  // The row's id: ids of one row of the batch (n < cols) need no division;
  // rows < 2^31 (the launcher's check), so a 32-bit one does the rest.
  long long at = n * id_stride1;
  if (n >= cols) {
    const long long b = static_cast<unsigned>(n) / static_cast<unsigned>(cols);
    at = b * id_stride0 + (n - b * cols) * id_stride1;
  }
  long long id = static_cast<long long>(ids[at]);
  if (id < 0) id += vocab;
  id = id < 0 ? 0 : (id >= vocab ? vocab - 1 : id);
  const int t_count = 1 << tx_log2;
  const int groups = width / N;
  const int g0 = static_cast<int>(blockIdx.y) * t_count * V + (threadIdx.x & (t_count - 1));
  const Tin* src = table + id * width;
  Tout* dst = out + n * width;
  Vec<Tin, N> v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = g0 + k * t_count;
    if (g < groups) v[k] = load_vec<Tin, N>(src + g * N);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int g = g0 + k * t_count;
    if (g >= groups) continue;
    Vec<Tout, N> o;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float f = to_f(v[k].v[e]);
      if constexpr (kRoundRows && !std::is_same_v<Tin, Tout>) f = to_f(from_f<Tout>(f));
      o.v[e] = from_f<Tout>(__fmul_rn(f, scale));
    }
    store_once<Tout, N>(dst + g * N, o);
  }
}

template <typename Tin, typename Tout, typename Tid, int N, bool kRoundRows>
cudaError_t launch_n(const void* table, const void* ids, void* out, long long rows,
                     long long cols, long long s0, long long s1, long long vocab, int width,
                     float scale, cudaStream_t stream) {
  const long long groups = width / N;
  const bool one_wave = rows * groups <= kOneWave;
  const int v = one_wave ? 1 : kLargeV;
  const int threads = one_wave ? kSmallThreads : kMaxThreads;
  int tx_log2 = 0;  // threads along a row: the least power of two covering it, at most a block
  while ((1LL << tx_log2) * v < groups && (1 << tx_log2) < threads) ++tx_log2;
  const long long r_count = threads >> tx_log2;
  const long long slices = (groups + (1LL << tx_log2) * v - 1) / ((1LL << tx_log2) * v);
  const long long blocks = (rows + r_count - 1) / r_count;
  if (slices > 65535 || rows > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (rows == cols || s0 == cols * s1) {  // one run of ids: index n * s1
    cols = rows;
    s0 = 0;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(slices));
  const Tin* t = static_cast<const Tin*>(table);
  const Tid* i = static_cast<const Tid*>(ids);
  Tout* o = static_cast<Tout*>(out);
  if (v == 1) {
    embed_gather_kernel<Tin, Tout, Tid, N, 1, kRoundRows>
        <<<grid, threads, 0, stream>>>(t, i, o, rows, cols, s0, s1, vocab, width, tx_log2, scale);
  } else {
    embed_gather_kernel<Tin, Tout, Tid, N, kLargeV, kRoundRows>
        <<<grid, threads, 0, stream>>>(t, i, o, rows, cols, s0, s1, vocab, width, tx_log2, scale);
  }
  return cudaGetLastError();
}

template <typename Tin, typename Tout, typename Tid, bool kRoundRows>
cudaError_t launch(const void* table, const void* ids, void* out, long long rows, long long cols,
                   long long s0, long long s1, long long vocab, int width, float scale,
                   cudaStream_t stream) {
  constexpr int kWide = sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout);
  constexpr int kVec = 16 / kWide;
  if (width % kVec == 0) {
    return launch_n<Tin, Tout, Tid, kVec, kRoundRows>(table, ids, out, rows, cols, s0, s1, vocab,
                                                      width, scale, stream);
  }
  return launch_n<Tin, Tout, Tid, 1, kRoundRows>(table, ids, out, rows, cols, s0, s1, vocab,
                                                 width, scale, stream);
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
