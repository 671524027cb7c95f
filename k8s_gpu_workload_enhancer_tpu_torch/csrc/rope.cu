// Rotate-half RoPE for Hopper: three kernels.
//
// Replace, in k8s_gpu_workload_enhancer_tpu/ops/rope_pallas.py:
//   - _rope_kernel (called from _rope_call): x (B, S, H, D) -> (B, S, H, D),
//     rotated by sin or, for its VJP, by -sin;
//   - _rope_t_kernel (_rope_t_call): x (B, S, H, D) -> (B*H, S, D), the
//     flash kernels' flat layout, rotated and relaid out in one pass;
//   - _rope_t_inv_kernel (_rope_t_inv_call): a cotangent (B*H, S, D) ->
//     (B, S, H, D), rotated with -sin (the inverse rotation, RoPE's VJP).
// Pairs (i, i + D/2) are rotated by f32 cos/sin rows (S, D/2) that the
// caller has already sliced at the position offset: [x1*c - x2*s,
// x2*c + x1*s] in f32, rounded once to x's dtype.
//
// The tables are read where they lie, through their strides: the model's
// rope_frequencies table is (max_seq, D/2, 2), so the cos and sin rows at
// an offset are views with an element stride of 2, sin one float past cos.
// Read in place, one 16-byte load brings {cos, sin} of two pairs, and the
// caller launches nothing to copy them out. Tables of other strides
// (contiguous (S, D/2) ones, which no main path passes) take one 4-byte
// load an element.
//
// Bound: bytes. Each element is read once and written once, with four
// multiplies and two adds per pair. Multiplies and adds are explicitly
// rounded (no fused multiply-add), and -sin is a negation (exact), so every
// kernel is bit-identical to its plain version.
//
// The (B, S, H, D) kernel, redesigned for this card. What held the first
// port back: at a serving chunk its 64 blocks left half the SMs idle; each
// thread divided in 64 bits to find its row and position; its tables were
// 16 scalar loads, and copies the caller launched. Now a block is (pair
// groups of a row) x (heads) x (positions): the position comes from the
// block's coordinates (one 32-bit remainder a thread, no division an
// element group), and a thread rotates one group of pairs (16 bytes of
// each half) in one head. The launcher gives each position its own block
// while one wave of the card holds all the work (a serving chunk, 128
// positions x 4 heads of 512: 128 blocks of 128 threads, one an SM), else
// 256-thread blocks of several positions (the training VJP, 16 heads of
// 128: two positions a block). x is read once and the output written once,
// so their 16-byte accesses carry cache hints: loads skip L1 and ask L2
// for the 256 bytes around them (x1 and x2 of a 128-wide bf16 head), stores
// are evict-first. Measured on the card (scripts/rope_embed_probe.py): the
// hints are worth 1.5 % at the training shape; more heads a thread (118
// registers at four) or a persistent grid were slower, and so was a
// warp-contiguous mapping that swaps the halves by shuffle.
//
// The layout-changing pair (schedule as first ported): one thread per
// group of pairs, neighbouring threads on neighbouring columns, a
// grid-stride loop over all rows; it walks the rows of its input in order
// and writes each rotated row to its place in the other layout: a row is D
// contiguous elements (1 KB at bf16 and D 512), so both the reads and the
// scattered row writes stay whole 16-byte accesses.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace ktwe;

namespace {

// Where a kernel finds cos[pos][i] and sin[pos][i].
enum TableLayout : int {
  kAny = 0,    // any strides: one 4-byte load an element
  kPairs = 1,  // sin at cos + 1, element stride 2: 16-byte loads of 2 {cos, sin}
};

struct Tables {
  const float* cos;
  const float* sin;
  long long cos_row, cos_elem, sin_row, sin_elem;  // strides in floats
};

// cos/sin of pairs i .. i + N - 1 at position pos.
template <int kTable, int N>
__device__ __forceinline__ void load_table(const Tables& t, int pos, int i, float (&c)[N],
                                           float (&s)[N]) {
  const float* cr = t.cos + pos * t.cos_row;
  if constexpr (kTable == kPairs) {
    static_assert(N % 2 == 0, "pairs come two to a 16-byte load");
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float4 v = *reinterpret_cast<const float4*>(cr + 2 * (i + k));
      c[k] = v.x;
      s[k] = v.y;
      c[k + 1] = v.z;
      s[k + 1] = v.w;
    }
  } else {
    const float* sr = t.sin + pos * t.sin_row;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      c[k] = cr[(i + k) * t.cos_elem];
      s[k] = sr[(i + k) * t.sin_elem];
    }
  }
}

template <typename T, int N, bool kNegSin>
__device__ __forceinline__ void rotate(const Vec<T, N>& a, const Vec<T, N>& b, const float (&c)[N],
                                       const float (&s)[N], Vec<T, N>& o1, Vec<T, N>& o2) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x1 = to_f(a.v[k]);
    const float x2 = to_f(b.v[k]);
    const float sk = kNegSin ? -s[k] : s[k];
    o1.v[k] = from_f<T>(__fsub_rn(__fmul_rn(x1, c[k]), __fmul_rn(x2, sk)));
    o2.v[k] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[k]), __fmul_rn(x1, sk)));
  }
}

// positions = B * S; block (x: pair groups, y: heads, z: positions).
template <typename T, int N, int kTable, bool kNegSin>
__global__ void rope_fwd_kernel(const T* __restrict__ x, Tables t, T* __restrict__ out,
                                int positions, int seq, int heads, int half) {
  const int bs = static_cast<int>(blockIdx.x * blockDim.z + threadIdx.z);
  if (bs >= positions) return;
  const int pos = bs % seq;
  const long long row0 = static_cast<long long>(bs) * heads;
  const int groups = half / N;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int i = g * N;
    float c[N], s[N];
    load_table<kTable, N>(t, pos, i, c, s);
    for (int h = threadIdx.y; h < heads; h += blockDim.y) {
      const T* xr = x + (row0 + h) * 2 * half;
      const Vec<T, N> a = load_once<T, N>(xr + i);
      const Vec<T, N> b = load_once<T, N>(xr + half + i);
      Vec<T, N> o1, o2;
      rotate<T, N, kNegSin>(a, b, c, s, o1, o2);
      T* orow = out + (row0 + h) * 2 * half;
      store_once<T, N>(orow + i, o1);
      store_once<T, N>(orow + half + i, o2);
    }
  }
}

// kToFlat: input (B, S, H, D) rows, output (B*H, S, D) rows; otherwise the
// reverse. kNegSin rotates by -sin (the inverse rotation).
template <typename T, int N, int kTable, bool kToFlat, bool kNegSin>
__global__ void rope_t_kernel(const T* __restrict__ x, Tables t, T* __restrict__ out,
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
    float c[N], s[N];
    load_table<kTable, N>(t, pos, i, c, s);
    Vec<T, N> o1, o2;
    rotate<T, N, kNegSin>(a, b, c, s, o1, o2);
    store_vec<T, N>(orow + i, o1);
    store_vec<T, N>(orow + half + i, o2);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// kPairs where the strides and addresses allow it for N pairs a thread (N
// a power of two), else kAny.
int table_layout(const Tables& t, int n) {
  return n % 2 == 0 && t.sin == t.cos + 1 && t.cos_elem == 2 && t.sin_elem == 2 &&
                 t.cos_row == t.sin_row && t.cos_row % 4 == 0 && aligned16(t.cos)
             ? kPairs
             : kAny;
}

// Calls f(std::integral_constant<int, layout>) for the run-time layout,
// instantiating kPairs only where N pairs a thread can take it.
template <int N, typename F>
cudaError_t with_layout(int layout, F&& f) {
  if constexpr (N % 2 == 0) {
    if (layout == kPairs) return f(std::integral_constant<int, kPairs>{});
  }
  return f(std::integral_constant<int, kAny>{});
}

// Work a wave of the card holds: 132 SMs x 2048 resident threads.
constexpr long long kOneWave = 132LL * 2048;
constexpr int kMaxThreads = 256;

template <typename T, int N, bool kNegSin>
cudaError_t launch_fwd(const void* x, const Tables& t, void* out, int positions, int seq,
                       int heads, int half, cudaStream_t stream) {
  const int groups = half / N;
  const bool one_wave = static_cast<long long>(positions) * heads * groups <= kOneWave;
  const int bx = groups < kMaxThreads ? groups : kMaxThreads;
  const int by = heads < kMaxThreads / bx ? heads : kMaxThreads / bx;
  int bz = one_wave ? 1 : kMaxThreads / (bx * by);
  bz = bz < 1 ? 1 : (bz > 64 ? 64 : bz);  // blockDim.z is at most 64
  const dim3 block(bx, by, bz);
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(positions) + bz - 1) / bz);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  return with_layout<N>(table_layout(t, N), [&](auto layout) {
    constexpr int kTable = decltype(layout)::value;
    rope_fwd_kernel<T, N, kTable, kNegSin>
        <<<grid, block, 0, stream>>>(xp, t, op, positions, seq, heads, half);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch(const void* x, const Tables& t, void* out, int positions, int seq, int heads,
                   int half, bool neg_sin, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (half % kVec == 0) {
    return neg_sin ? launch_fwd<T, kVec, true>(x, t, out, positions, seq, heads, half, stream)
                   : launch_fwd<T, kVec, false>(x, t, out, positions, seq, heads, half, stream);
  }
  return neg_sin ? launch_fwd<T, 1, true>(x, t, out, positions, seq, heads, half, stream)
                 : launch_fwd<T, 1, false>(x, t, out, positions, seq, heads, half, stream);
}

long long grid_for(long long groups, int threads) {
  const long long blocks = (groups + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;
}

template <typename T, int N, bool kToFlat>
cudaError_t launch_t_n(const void* x, const Tables& t, void* out, long long rows, int seq,
                       int heads, int half, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>(grid_for(rows * (half / N), kThreads));
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  // The flat-to-model direction is the VJP: the inverse rotation.
  return with_layout<N>(table_layout(t, N), [&](auto layout) {
    constexpr int kTable = decltype(layout)::value;
    rope_t_kernel<T, N, kTable, kToFlat, !kToFlat>
        <<<blocks, kThreads, 0, stream>>>(xp, t, op, rows, seq, heads, half);
    return cudaGetLastError();
  });
}

template <typename T, bool kToFlat>
cudaError_t launch_t(const void* x, const Tables& t, void* out, long long rows, int seq,
                     int heads, int half, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (half % kVec == 0) {
    return launch_t_n<T, kVec, kToFlat>(x, t, out, rows, seq, heads, half, stream);
  }
  return launch_t_n<T, 1, kToFlat>(x, t, out, rows, seq, heads, half, stream);
}

Tables tables(const void* cos_t, const void* sin_t, long long cos_row, long long cos_elem,
              long long sin_row, long long sin_elem) {
  return Tables{static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), cos_row,
                cos_elem, sin_row, sin_elem};
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// x, out: (batch, seq, heads, 2 * half) contiguous, 16-byte aligned;
// cos_t, sin_t: f32 (seq, half) tables, element (p, i) at p * row + i * elem
// floats from each pointer (the strides of a view of the model's
// (max_seq, half, 2) table, or of contiguous tables). neg_sin 1 rotates by
// -sin (the VJP). batch * seq must fit an int.
KTWE_EXPORT int ktwe_rope_fwd(const void* x, const void* cos_t, const void* sin_t, void* out,
                              long long batch, int seq, int heads, int half, long long cos_row,
                              long long cos_elem, long long sin_row, long long sin_elem,
                              int neg_sin, int dtype, int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || half <= 0) return kBadArgument;
  if (batch * seq > 0x7fffffffLL) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const Tables t = tables(cos_t, sin_t, cos_row, cos_elem, sin_row, sin_elem);
  const int positions = static_cast<int>(batch * seq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      err = launch<float>(x, t, out, positions, seq, heads, half, neg_sin != 0, st);
      break;
    case kBF16:
      err = launch<__nv_bfloat16>(x, t, out, positions, seq, heads, half, neg_sin != 0, st);
      break;
    default: return kBadArgument;
  }
  return static_cast<int>(err);
}

// x: (batch, seq, heads, 2 * half); out: (batch * heads, seq, 2 * half); both
// contiguous and 16-byte aligned. cos_t, sin_t: f32 (seq, half) tables with
// the strides of ktwe_rope_fwd. to_flat 1 rotates x into the flat layout
// (_rope_t_kernel); to_flat 0 reads x as (batch * heads, seq, 2 * half),
// rotates it by -sin and writes out as (batch, seq, heads, 2 * half)
// (_rope_t_inv_kernel).
KTWE_EXPORT int ktwe_rope_t(const void* x, const void* cos_t, const void* sin_t, void* out,
                            long long batch, int seq, int heads, int half, long long cos_row,
                            long long cos_elem, long long sin_row, long long sin_elem,
                            int to_flat, int dtype, int device, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || half <= 0) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const Tables t = tables(cos_t, sin_t, cos_row, cos_elem, sin_row, sin_elem);
  const long long rows = batch * seq * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    err = to_flat ? launch_t<float, true>(x, t, out, rows, seq, heads, half, st)
                  : launch_t<float, false>(x, t, out, rows, seq, heads, half, st);
  } else if (dtype == kBF16) {
    err = to_flat ? launch_t<__nv_bfloat16, true>(x, t, out, rows, seq, heads, half, st)
                  : launch_t<__nv_bfloat16, false>(x, t, out, rows, seq, heads, half, st);
  } else {
    return kBadArgument;
  }
  return static_cast<int>(err);
}
