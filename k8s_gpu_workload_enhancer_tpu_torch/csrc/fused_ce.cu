// Fused LM-head + softmax cross-entropy for Hopper: forward and backward.
//
// Replaces, in k8s_gpu_workload_enhancer_tpu/ops/fused_ce.py:
//   - _ce_fwd_kernel (fused_ce.py:87, called from _fused_forward): logits
//     tiles h2 @ W summed in f32, folded into a logsumexp per row, the gold
//     logit picked from the f32 tile, and only the bf16 logits stash
//     written; the f32 logits never reach device memory;
//   - _ce_bwd_kernel (fused_ce.py:175, _fused_backward): dlg = ((exp(stash
//     - lse) - onehot) * g / N) rounded to bf16, written out for the dHead
//     product (plain torch, as in the reference), and dH = dlg @ W^T summed
//     in f32, stored as bf16.
// h2 (N, D) and W (D, V) share one dtype: bf16 (the model's) or f32 (the
// f32 parity gate). The stash, dlg and dH are bf16 in both, as the
// reference writes them. Two bodies, chosen by dtype in the launchers (not
// a fallback: a bf16 call never reaches the f32 body); ktwe_fused_ce_wgmma
// reports the choice.
//
// bf16: tensor cores (wgmma) on tiles that TMA loads under mbarriers
// (csrc/sm90.cuh).
//   Bound. At the flagship microbatch (N 16384, D 2048, V 32768) each
//   product is 2 N D V = 2.2 TFLOP, 2.2 ms at 989 TFLOP/s, against 64 MB
//   of h2, 128 MB of W and 1.07 GB of stash (0.38 ms at 3.35 TB/s):
//   operations bound both products. The backward's dlg pass alone is
//   bytes: 1.07 GB of stash read and 1.07 GB of dlg written, 0.64 ms.
//   One GEMM body serves both products: a persistent block an SM (132 on
//   an H100), warpgroup 0 the producer (one thread issues every TMA load;
//   setmaxnreg gives its registers away), warpgroups 1 and 2 the consumers,
//   each owning 64 rows of a 128 x 256 f32 output tile (128 registers a
//   thread) and issuing m64n256k16 wgmma from shared memory. Stages are 64
//   deep: an A tile of 128 x 64 (one 128-byte-swizzled box, 16 KB) and a B
//   tile of 64 x 256 (32 KB), four stages in a ring (193 KB with the
//   alignment). A consumer keeps one stage's products in flight while it
//   issues the next (wgmma_wait<1>), and frees each stage as soon as its
//   products are done, so the producer runs up to four stages ahead, into
//   the next tile while the consumers run the epilogue.
//   - Forward: A = h2 K-major; B = W, whose rows run along the reduction
//     axis: four 64 x 64 boxes of W read MN-major (the transpose bit). The
//     tiles are walked in groups of 16 row tiles, vocab tile by vocab tile
//     (tile t of a group: row tile t % 16, vocab tile t / 16), so the 132
//     tiles in flight share about 16 h2 bands (8 MB) and 8 W tiles (8 MB),
//     which L2 holds: h2 is read from memory once a group and W once a
//     group (1.1 GB in all) instead of an h2 band a tile. The epilogue
//     works on the f32 accumulators: columns past V masked, each row's max
//     and sum of exp over the tile (quad shuffles of the accumulator
//     layout), the gold logit picked by its owner thread, the stash written
//     as bf16 pairs; each tile writes its rows' (m, l, gold) partials and a
//     second small kernel combines them: lse = M + log(max(sum l_i exp(m_i
//     - M), 1e-30)).
//   - Backward: (a) a bytes-bound pass writes dlg from the stash with the
//     reference's rounding (expf of the RN difference, RN subtraction of
//     the one-hot, RN product with the scale, RN to bf16), once; (b) dH =
//     dlg @ W^T on the GEMM body, both operands K-major (dlg (N, V) and W
//     (D, V) both run along V), accumulated over the whole V and stored RN
//     to bf16. Tiles run row band by row band, the D / 256 column tiles of
//     a band side by side, so the blocks in flight share their dlg slices
//     and the same W slice through L2 while they walk V together. No
//     tile is recomputed.
//   TMA's zero fill supplies ragged N, V and D: rows past N and columns
//   past V (forward) or D (backward) come in as zeros and are masked out of
//   the statistics and the stores.
//
// f32: the f32 pipes (the f32 training gates hold the loss to 1e-5 and
// every gradient to 1e-3 against true f32 products, which TF32 wgmma would
// not give). 128 x 128 output tiles, 256 threads each owning an 8 x 8
// register tile (FMAs in contraction order), operand tiles 32 deep staged
// in shared memory with one stage of register prefetch.
//   - Forward: the vocab is cut into shares so the grid fills the card;
//     each share folds its tiles into a running (m, l, gold) per row and
//     the combine kernel above merges the shares.
//   - Backward: blocks own a 128-row x 128-column tile of dH and walk the
//     whole vocab 32 columns at a time; the dlg tile is made from the stash
//     while it is staged (each of the D / 128 column blocks of a row tile
//     recomputes it; the first one writes it out).
#include <algorithm>
#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

using namespace ktwe;

namespace {

constexpr float kNegInf = -1e30f;

enum Kernel : int { kFwd = 0, kBwd = 1 };

struct FwdArgs {
  const void* h;        // (N, D)
  const void* w;        // (D, V)
  const int* targets;   // (N,)
  __nv_bfloat16* stash; // (N, V)
  float* part;          // (3, splits, N): m, l, gold per vocab share
  float* lse;           // (N,)
  float* gold;          // (N,)
  int n, d, v, splits;
};

struct BwdArgs {
  const __nv_bfloat16* stash;  // (N, V)
  const void* w;               // (D, V)
  const float* lse;            // (N,)
  const int* targets;          // (N,)
  const float* scale;          // () g / N
  __nv_bfloat16* dlg;          // (N, V)
  __nv_bfloat16* dh;           // (N, D)
  int n, d, v;
};

// lse = M + log(max(sum_i l_i exp(m_i - M), 1e-30)), gold = sum_i gold_i.
__global__ void ce_combine_kernel(FwdArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const long long plane = static_cast<long long>(a.splits) * a.n;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part[static_cast<long long>(s) * a.n + r]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const long long at = static_cast<long long>(s) * a.n + r;
    l += a.part[plane + at] * expf(a.part[at] - mx);
    g += a.part[2 * plane + at];
  }
  a.lse[r] = mx + logf(fmaxf(l, 1e-30f));
  a.gold[r] = g;
}

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, int device, std::atomic<bool>* done) {
  // The shared-memory opt-in belongs to the kernel on a device: once each.
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

// ===========================================================================
// bf16 bodies: wgmma + TMA
// ===========================================================================
namespace tc {

using namespace ktwe::sm90;

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBM = 128;                            // output rows a tile (64 a consumer)
constexpr int kBN = 256;                            // output columns a tile
constexpr int kBK = kSwizzleCols;                   // contraction depth a stage
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBoxRowBytes;         // 128 x 64 bf16: 16 KB
constexpr int kBBytes = kBN * kBoxRowBytes;         // 64 x 256 or 256 x 64 bf16: 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + kAtomBytes;  // + alignment
constexpr int kFwdGroupRows = 16;                   // forward: row tiles walked together
constexpr float kLog2e = 1.4426950408889634f;

struct GemmArgs {
  int n;                 // output rows (N)
  int cols;              // output columns: V (forward) or D (backward)
  int depth;             // contraction: D (forward) or V (backward)
  int group;             // row tiles walked together
  const int* targets;    // forward: (N,)
  __nv_bfloat16* out;    // forward: stash (N, V); backward: dH (N, D)
  float* part;           // forward: (3, column tiles, N) m, l, gold
};

// Tile `id` of the walk: groups of `group` row tiles, column tile by column
// tile inside a group (the last group may hold fewer rows).
__device__ __forceinline__ void tile_at(int id, int n_mt, int n_ct, int group, int& mt,
                                        int& ct) {
  const int g = id / (group * n_ct);
  const int within = id - g * group * n_ct;
  const int rows = min(group, n_mt - g * group);
  mt = g * group + within % rows;
  ct = within / rows;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The forward's epilogue for one row of this thread: its 64 columns of the
// tile (acc[4 j + e], e < 2, at column 8 j + 2 quad + e; the second row's
// at acc[4 j + 2 + e]), columns past V already at kNegInf. Writes the row's
// (m, l, gold) partials of column tile `ct` from the quad's first lane.
template <int kHalf>
__device__ __forceinline__ void fwd_row_stats(const float (&acc)[kBN / 2], const GemmArgs& g,
                                              int row, int c0, int ct, int quad) {
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(acc[4 * j + kHalf], acc[4 * j + kHalf + 1]));
  mx = quad_max(mx);
  const float mx2 = mx * kLog2e;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s += exp2f(fmaf(acc[4 * j + kHalf], kLog2e, -mx2)) +
         exp2f(fmaf(acc[4 * j + kHalf + 1], kLog2e, -mx2));
  }
  s = quad_sum(s);
  // The gold logit: the one thread whose columns hold the target picks it.
  float gold = 0.f;
  const int tr = row < g.n ? g.targets[row] - c0 - 2 * quad : -1;
  if (tr >= 0 && tr < kBN && (tr & 6) == 0) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (8 * j == (tr & ~1)) gold = (tr & 1) ? acc[4 * j + kHalf + 1] : acc[4 * j + kHalf];
    }
  }
  gold = quad_sum(gold);   // zeros and one value: exact
  if (quad == 0 && row < g.n) {
    const long long plane = static_cast<long long>((g.cols + kBN - 1) / kBN) * g.n;
    const long long at = static_cast<long long>(ct) * g.n + row;
    g.part[at] = mx;
    g.part[plane + at] = s;
    g.part[2 * plane + at] = gold;
  }
}

// This thread's rows (row0 and row0 + 8) of the tile at column c0, as bf16
// pairs: RN of the f32 accumulators; rows past n and columns past cols
// (a multiple of 8, so a pair is in or out) are not stored.
__device__ __forceinline__ void store_bf16(const float (&acc)[kBN / 2], __nv_bfloat16* out,
                                           int n, int cols, int row0, int c0, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n) continue;
    __nv_bfloat16* dst = out + static_cast<long long>(row) * cols;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = c0 + 8 * j + 2 * quad;
      if (col < cols) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// kFwdBody: the forward (A = h2, B = W MN-major, statistics and stash out);
// else the backward's dH (A = dlg, B = W K-major, dH out).
template <bool kFwdBody>
__global__ void __launch_bounds__(kThreads, 1)
    ce_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // Swizzle atoms need 1024-byte alignment.
  unsigned char* ring = smem_raw + ((kAtomBytes - (smem_u32(smem_raw) & (kAtomBytes - 1))) &
                                    (kAtomBytes - 1));

  const int n_mt = (g.n + kBM - 1) / kBM;
  const int n_ct = (g.cols + kBN - 1) / kBN;
  const int tiles = n_mt * n_ct;
  const int k_blocks = (g.depth + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full, across tiles.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, ct;
        tile_at(tile, n_mt, n_ct, g.group, mt, ct);
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int st = it % kStages;
          unsigned char* stage = ring + st * kStageBytes;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);   // the first round passes
          mbar_arrive_expect_tx(&full[st], kStageBytes);
          tma_load_2d(stage, &a_map, &full[st], kb * kBK, mt * kBM);
          if constexpr (kFwdBody) {
            // W rows kb*64.. (the reduction axis), 256 vocab columns as
            // four 64-column boxes.
#pragma unroll
            for (int c = 0; c < kBN / kSwizzleCols; ++c) {
              tma_load_2d(stage + kABytes + c * kBK * kBoxRowBytes, &b_map, &full[st],
                          ct * kBN + c * kSwizzleCols, kb * kBK);
            }
          } else {
            // W rows ct*256.. (dH's columns), vocab columns kb*64.. (the
            // reduction axis): one 256-row box.
            tma_load_2d(stage + kABytes, &b_map, &full[st], kb * kBK, ct * kBN);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows cw*64 .. +63 of every tile.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int quad = lane & 3;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, ct;
    tile_at(tile, n_mt, n_ct, g.group, mt, ct);
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const uint32_t a_addr = smem_u32(ring + st * kStageBytes) + cw * 64 * kBoxRowBytes;
      const uint32_t b_addr = smem_u32(ring + st * kStageBytes + kABytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = desc_sw128(a_addr + kk * 32, 16, kAtomBytes);
        // MN-major B: the leading offset is the distance between the
        // 64-column boxes, a step of 16 rows 16 box rows; K-major B: 32
        // bytes a step inside the 128-byte rows.
        const uint64_t db = kFwdBody
                                ? desc_sw128(b_addr + kk * 16 * kBoxRowBytes,
                                             kBK * kBoxRowBytes, kAtomBytes)
                                : desc_sw128(b_addr + kk * 32, 16, kAtomBytes);
        wgmma_m64n256k16_ss<kFwdBody ? 1 : 0>(acc, da, db, kb > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      fence_regs(acc);
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    const int row0 = mt * kBM + cw * 64 + warp * 16 + (lane >> 2);
    const int c0 = ct * kBN;
    if constexpr (kFwdBody) {
      if (c0 + kBN > g.cols) {   // the last vocab tile: columns past V out
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          if (c0 + 8 * j + 2 * quad >= g.cols) {
            acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = kNegInf;
          }
        }
      }
      fwd_row_stats<0>(acc, g, row0, c0, ct, quad);
      fwd_row_stats<2>(acc, g, row0 + 8, c0, ct, quad);
    }
    store_bf16(acc, g.out, g.n, g.cols, row0, c0, quad);
  }
}

// Blocks of the persistent grid: one an SM.
inline cudaError_t sm_count(int device, int* out) {
  static std::atomic<int> cached[kMaxDevices];
  int n = cached[device].load(std::memory_order_acquire);
  if (n == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached[device].store(n, std::memory_order_release);
  }
  *out = n;
  return cudaSuccess;
}

template <bool kFwdBody>
cudaError_t launch_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map, const GemmArgs& g,
                        int device, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  cudaError_t err = opt_in(ce_wgmma_kernel<kFwdBody>, kSmem, device, opted);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((g.n + kBM - 1) / kBM) * ((g.cols + kBN - 1) / kBN);
  if (tiles > (1ll << 30)) return static_cast<cudaError_t>(kBadArgument);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  ce_wgmma_kernel<kFwdBody><<<grid, kThreads, kSmem, stream>>>(a_map, b_map, g);
  return cudaGetLastError();
}

// Maps are built per call on the host and passed by value: nothing is
// allocated, and a captured CUDA graph keeps its own copy.
cudaError_t launch_fwd(const FwdArgs& a, int device, cudaStream_t stream) {
  CUtensorMap h_map, w_map;
  cudaError_t err = make_matrix_map(&h_map, a.h, a.n, a.d, kBM);
  if (err == cudaSuccess) err = make_matrix_map(&w_map, a.w, a.d, a.v, kBK);
  if (err != cudaSuccess) return err;
  const GemmArgs g{a.n, a.v, a.d, kFwdGroupRows, a.targets, a.stash, a.part};
  err = launch_gemm<true>(h_map, w_map, g, device, stream);
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.n + 255) / 256, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// dlg from the stash, 8 elements (16 bytes) a thread and step, a block a
// row: the reference's expression with its rounding at every step.
__global__ void __launch_bounds__(256) ce_dlg_kernel(BwdArgs a) {
  const float scale = *a.scale;
  for (int r = blockIdx.x; r < a.n; r += gridDim.x) {
    const float lse = a.lse[r];
    const int t = a.targets[r];
    const long long base = static_cast<long long>(r) * a.v;
    for (int c = threadIdx.x * 8; c < a.v; c += 256 * 8) {   // V % 8 == 0
      const uint4 raw = *reinterpret_cast<const uint4*>(a.stash + base + c);
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(&raw);
      alignas(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = expf(__fsub_rn(__bfloat162float(st[e]), lse));
        const float onehot = c + e == t ? 1.f : 0.f;
        out[e] = __float2bfloat16_rn(__fmul_rn(__fsub_rn(p, onehot), scale));
      }
      *reinterpret_cast<uint4*>(a.dlg + base + c) = *reinterpret_cast<const uint4*>(out);
    }
  }
}

cudaError_t launch_bwd(const BwdArgs& a, int device, cudaStream_t stream) {
  CUtensorMap dlg_map, w_map;
  cudaError_t err = make_matrix_map(&dlg_map, a.dlg, a.n, a.v, kBM);
  if (err == cudaSuccess) err = make_matrix_map(&w_map, a.w, a.d, a.v, kBN);
  if (err != cudaSuccess) return err;
  ce_dlg_kernel<<<a.n < (1 << 30) ? a.n : (1 << 30), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const GemmArgs g{a.n, a.d, a.v, 1, nullptr, a.dh, nullptr};
  return launch_gemm<false>(dlg_map, w_map, g, device, stream);
}

}  // namespace tc

// ===========================================================================
// f32 bodies: the f32 pipes
// ===========================================================================
namespace simt {

constexpr int kBM = 128;       // rows of h2 / dH per block
constexpr int kBN = 128;       // vocab columns (forward) or D columns (backward) per block
constexpr int kBK = 32;        // contraction depth per staged tile
constexpr int kThreads = 256;  // 16 x 16 threads, an 8 x 8 register tile each
constexpr int kLdc = kBN + 4;  // f32 output tile row stride (floats)
constexpr int kLdA = kBK + 4;  // operand tile row strides, padded by 4 floats
constexpr int kLdBRow = kBN + 4;
constexpr int kLdBCol = kBK + 4;
// The forward's vocab shares aim for this many blocks, so a few hundred
// rows still fill the card.
constexpr int kTargetFwdBlocks = 1024;

template <typename T> constexpr int kVec = 16 / sizeof(T);
using Raw = uint4;  // 16 bytes of elements

// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j, i, j < 8, summed in contraction order with FMAs.
struct Acc {
  float c[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
    }
  }

  // A [kBM][kLdA] row-major; B element (k, n) at B[k * kLdBRow + n]
  // (row-major) or B[n * kLdBCol + k] (col-major).
  template <bool kBColMajor>
  __device__ void mma(const float* A, const float* B) {
    constexpr int ldb = kBColMajor ? kLdBCol : kLdBRow;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty + 16 * i) * kLdA + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = kBColMajor ? B[n * ldb + k] : B[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
      }
    }
  }

  __device__ void store(float* C) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) C[(ty + 16 * i) * kLdc + tx + 16 * j] = c[i][j];
    }
  }
};

// Shared memory of a block: the operand tiles, overlaid after the products
// by the f32 output tile.
template <bool kBColMajor>
constexpr size_t smem_bytes() {
  const size_t a = sizeof(float) * kBM * kLdA;
  const size_t b = sizeof(float) * (kBColMajor ? kBN * kLdBCol : kBK * kLdBRow);
  const size_t c = sizeof(float) * kBM * kLdc;
  return a + b > c ? a + b : c;
}

// A tile of ROWS rows x kBK columns of a row-major matrix (rows >= n_rows
// and columns >= n_cols read as 0), as raw 16-byte vectors in registers:
// vector `it` of this thread is row idx / vpr, column (idx % vpr) * kVec.
template <typename T, int ROWS>
struct RowTile {
  static constexpr int vpr = kBK / kVec<T>;
  static constexpr int iters = ROWS * vpr / kThreads;
  Raw v[iters];

  __device__ static int row(int it) { return (threadIdx.x + it * kThreads) / vpr; }
  __device__ static int col(int it) { return (threadIdx.x + it * kThreads) % vpr * kVec<T>; }

  __device__ void load(const T* src, long long ld, int r0, int n_rows, int c0, int n_cols) {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      const int r = r0 + row(it), c = c0 + col(it);
      v[it] = (r < n_rows && c < n_cols)
                  ? *reinterpret_cast<const Raw*>(src + static_cast<long long>(r) * ld + c)
                  : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(T* dst, int ld) const {
#pragma unroll
    for (int it = 0; it < iters; ++it) *reinterpret_cast<Raw*>(dst + row(it) * ld + col(it)) = v[it];
  }
};

// A tile of kBK rows x kBN columns of the row-major head (columns >= n_cols
// read as 0): the forward's B tile.
struct HeadTile {
  static constexpr int vpr = kBN / kVec<float>;
  static constexpr int iters = kBK * vpr / kThreads;
  Raw v[iters];

  __device__ static int row(int it) { return (threadIdx.x + it * kThreads) / vpr; }
  __device__ static int col(int it) { return (threadIdx.x + it * kThreads) % vpr * kVec<float>; }

  __device__ void load(const float* src, long long ld, int r0, int c0, int n_cols) {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      const int c = c0 + col(it);
      v[it] = c < n_cols ? *reinterpret_cast<const Raw*>(src + static_cast<long long>(r0 + row(it)) * ld + c)
                         : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(float* dst) const {
#pragma unroll
    for (int it = 0; it < iters; ++it) {
      *reinterpret_cast<Raw*>(dst + row(it) * kLdBRow + col(it)) = v[it];
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1) ce_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem_raw);

  const int m0 = blockIdx.x * kBM;
  const int v_tiles = (a.v + kBN - 1) / kBN;
  const int per = (v_tiles + a.splits - 1) / a.splits;
  const int t_begin = blockIdx.y * per;
  const int t_end = min(v_tiles, t_begin + per);
  const float* h = static_cast<const float*>(a.h);
  const float* w = static_cast<const float*>(a.w);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = a.d / kBK;

  // Row state (running max, sum, gold; target), one entry per row: the
  // warp that owns a row in the epilogue is the only one to touch it.
  __shared__ float m_s[kBM], l_s[kBM], g_s[kBM];
  __shared__ int t_s[kBM];
  if (threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
    g_s[threadIdx.x] = 0.f;
    t_s[threadIdx.x] = r < a.n ? a.targets[r] : -1;
  }

  Acc acc;
  RowTile<float, kBM> ta;
  HeadTile tb;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    acc.zero();
    ta.load(h, a.d, m0, a.n, 0, a.d);
    tb.load(w, a.v, 0, n0, a.v);
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();  // the previous products (or epilogue) are done with shared memory
      ta.store(As, kLdA);
      tb.store(Bs);
      __syncthreads();
      if (kc + 1 < nk) {  // the next tile's loads fly during these products
        ta.load(h, a.d, m0, a.n, (kc + 1) * kBK, a.d);
        tb.load(w, a.v, (kc + 1) * kBK, n0, a.v);
      }
      acc.mma<false>(As, Bs);
    }
    __syncthreads();
    acc.store(Cs);
    __syncthreads();
    // Epilogue: warp `warp` owns rows warp*16 .. +15; lane owns columns
    // lane*4 .. +3 of the tile.
    const int c = n0 + lane * 4;
    const bool col_ok = c < a.v;  // V % 4 == 0: a group of 4 is in or out
    for (int i = 0; i < 16; ++i) {
      const int lr = warp * 16 + i;
      const int r = m0 + lr;
      if (r >= a.n) continue;  // warp-uniform
      // Every lane reads the row state before the shuffles below, which no
      // lane passes until all have arrived; lane 0 writes it back after.
      const float m_old = m_s[lr], l_old = l_s[lr];
      const float4 x = *reinterpret_cast<const float4*>(Cs + lr * kLdc + lane * 4);
      float mx = col_ok ? fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)) : kNegInf;
      mx = warp_max(mx);
      const float m_new = fmaxf(m_old, mx);
      float s = col_ok ? (expf(x.x - m_new) + expf(x.y - m_new)) + (expf(x.z - m_new) + expf(x.w - m_new))
                       : 0.f;
      s = warp_sum(s);
      if (lane == 0) {
        l_s[lr] = l_old * expf(m_old - m_new) + s;
        m_s[lr] = m_new;
        const int t = t_s[lr];
        if (t >= n0 && t < n0 + kBN && t < a.v) g_s[lr] = Cs[lr * kLdc + (t - n0)];
      }
      if (col_ok) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned*>(&lo);
        packed.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(a.stash + static_cast<long long>(r) * a.v + c) = packed;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < a.n) {
    const int r = m0 + threadIdx.x;
    const long long at = static_cast<long long>(blockIdx.y) * a.n + r;
    const long long plane = static_cast<long long>(a.splits) * a.n;
    a.part[at] = m_s[threadIdx.x];
    a.part[plane + at] = l_s[threadIdx.x];
    a.part[2 * plane + at] = g_s[threadIdx.x];
  }
}

__global__ void __launch_bounds__(kThreads, 1) ce_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem_raw);
  __shared__ float lse_s[kBM];
  __shared__ int t_s[kBM];

  const int m0 = blockIdx.x * kBM;
  const int d0 = blockIdx.y * kBN;
  const bool write_dlg = blockIdx.y == 0;
  const float* w = static_cast<const float*>(a.w);
  if (threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    lse_s[threadIdx.x] = r < a.n ? a.lse[r] : 0.f;
    t_s[threadIdx.x] = r < a.n ? a.targets[r] : -1;
  }
  const float scale = *a.scale;

  Acc acc;
  acc.zero();
  RowTile<__nv_bfloat16, kBM> ts;  // stash
  RowTile<float, kBN> tw;          // W rows d0.., i.e. head^T as a col-major operand
  const int nk = (a.v + kBK - 1) / kBK;
  ts.load(a.stash, a.v, m0, a.n, 0, a.v);
  tw.load(w + static_cast<long long>(d0) * a.v, a.v, 0, kBN, 0, a.v);
  for (int kc = 0; kc < nk; ++kc) {
    const int v0 = kc * kBK;
    __syncthreads();  // lse_s/t_s are written; the previous products are done
    // dlg from the staged stash vectors, into A and (once) out to memory.
#pragma unroll
    for (int it = 0; it < RowTile<__nv_bfloat16, kBM>::iters; ++it) {
      const int lr = RowTile<__nv_bfloat16, kBM>::row(it);
      const int lc = RowTile<__nv_bfloat16, kBM>::col(it);
      const int r = m0 + lr, c = v0 + lc;
      const bool ok = r < a.n && c < a.v;  // V % 8 == 0: a vector is in or out
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(&ts.v[it]);
      alignas(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float g = 0.f;
        if (ok) {
          const float p = expf(__fsub_rn(__bfloat162float(st[e]), lse_s[lr]));
          const float onehot = c + e == t_s[lr] ? 1.f : 0.f;
          g = __fmul_rn(__fsub_rn(p, onehot), scale);
        }
        out[e] = __float2bfloat16_rn(g);
      }
      if (ok && write_dlg) {
        *reinterpret_cast<Raw*>(a.dlg + static_cast<long long>(r) * a.v + c) =
            *reinterpret_cast<const Raw*>(out);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) As[lr * kLdA + lc + e] = __bfloat162float(out[e]);
    }
    tw.store(Bs, kLdBCol);
    __syncthreads();
    if (kc + 1 < nk) {
      ts.load(a.stash, a.v, m0, a.n, v0 + kBK, a.v);
      tw.load(w + static_cast<long long>(d0) * a.v, a.v, 0, kBN, v0 + kBK, a.v);
    }
    acc.mma<true>(As, Bs);  // dH += dlg @ head_tile^T
  }
  __syncthreads();
  acc.store(Cs);
  __syncthreads();
  // dH tile out as bf16, 8 columns (16 bytes) per store.
  for (int idx = threadIdx.x; idx < kBM * kBN / 8; idx += kThreads) {
    const int lr = idx / (kBN / 8), lc = idx % (kBN / 8) * 8;
    const int r = m0 + lr;
    if (r >= a.n) continue;
    alignas(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(Cs[lr * kLdc + lc + e]);
    *reinterpret_cast<Raw*>(a.dh + static_cast<long long>(r) * a.d + d0 + lc) =
        *reinterpret_cast<const Raw*>(out);
  }
}

// Vocab shares of the forward grid: enough blocks to fill the card, the
// vocab tiles spread evenly over the shares.
int splits(int n, int v) {
  const int n_tiles = (n + kBM - 1) / kBM, v_tiles = (v + kBN - 1) / kBN;
  const int want = std::min(v_tiles, std::max(1, (kTargetFwdBlocks + n_tiles - 1) / n_tiles));
  const int per = (v_tiles + want - 1) / want;
  return (v_tiles + per - 1) / per;
}

cudaError_t launch_fwd(const FwdArgs& a, int device, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  constexpr size_t bytes = smem_bytes<false>();
  cudaError_t err = opt_in(ce_fwd_kernel, bytes, device, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBM - 1) / kBM, a.splits);
  ce_fwd_kernel<<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.n + 255) / 256, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int device, cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  constexpr size_t bytes = smem_bytes<true>();
  const cudaError_t err = opt_in(ce_bwd_kernel, bytes, device, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBM - 1) / kBM, a.d / kBN);
  ce_bwd_kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt

bool shape_ok(int n, int d, int v, int dtype) {
  return n > 0 && d > 0 && d % 128 == 0 && v > 0 && v % 8 == 0 &&
         (dtype == kF32 || dtype == kBF16);
}

// The rule both launchers apply: bf16 runs the tensor-core bodies.
bool wgmma_body(int dtype) { return dtype == kBF16; }

// (m, l, gold) partials the forward writes per row: one per vocab tile
// (bf16) or per vocab share (f32).
int fwd_splits(int n, int v, int dtype) {
  return wgmma_body(dtype) ? (v + tc::kBN - 1) / tc::kBN : simt::splits(n, v);
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// h: (n, d), w: (d, v) in one dtype; targets (n,) int32; stash (n, v) bf16;
// part (3, splits, n), lse (n,), gold (n,) f32. All contiguous and 16-byte
// aligned; d % 128 == 0, v % 8 == 0, splits == ktwe_fused_ce_splits(n, v,
// dtype).
KTWE_EXPORT int ktwe_fused_ce_fwd(const void* h, const void* w, const void* targets, void* stash,
                                  void* part, void* lse, void* gold, int n, int d, int v,
                                  int splits, int dtype, int device, void* stream) {
  if (!shape_ok(n, d, v, dtype) || device < 0 || device >= kMaxDevices ||
      splits != fwd_splits(n, v, dtype) || (!wgmma_body(dtype) && splits > 65535)) {
    return kBadArgument;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const FwdArgs a{h, w, static_cast<const int*>(targets), static_cast<__nv_bfloat16*>(stash),
                  static_cast<float*>(part), static_cast<float*>(lse), static_cast<float*>(gold),
                  n, d, v, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = wgmma_body(dtype) ? tc::launch_fwd(a, device, st) : simt::launch_fwd(a, device, st);
  return static_cast<int>(err);
}

// stash (n, v) bf16; w (d, v) in `dtype`; lse (n,) f32; targets (n,) int32;
// scale () f32 on the device; dlg (n, v) and dh (n, d) bf16. Layout rules
// as for ktwe_fused_ce_fwd. bf16 runs two launches: the dlg pass, then the
// dH product.
KTWE_EXPORT int ktwe_fused_ce_bwd(const void* stash, const void* w, const void* lse,
                                  const void* targets, const void* scale, void* dlg, void* dh,
                                  int n, int d, int v, int dtype, int device, void* stream) {
  if (!shape_ok(n, d, v, dtype) || device < 0 || device >= kMaxDevices) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const BwdArgs a{static_cast<const __nv_bfloat16*>(stash), w, static_cast<const float*>(lse),
                  static_cast<const int*>(targets), static_cast<const float*>(scale),
                  static_cast<__nv_bfloat16*>(dlg), static_cast<__nv_bfloat16*>(dh), n, d, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = wgmma_body(dtype) ? tc::launch_bwd(a, device, st) : simt::launch_bwd(a, device, st);
  return static_cast<int>(err);
}

// The forward's partials per row for (n, v, dtype): the `splits` that
// ktwe_fused_ce_fwd takes; 0 for a shape it refuses.
KTWE_EXPORT int ktwe_fused_ce_splits(int n, int v, int dtype) {
  if (!shape_ok(n, 128, v, dtype)) return 0;
  return fwd_splits(n, v, dtype);
}

// 1 when both launchers run the tensor-core (wgmma) bodies for `dtype`,
// else 0 (the f32 pipes).
KTWE_EXPORT int ktwe_fused_ce_wgmma(int dtype) { return wgmma_body(dtype) ? 1 : 0; }

// The tile of kernel `which` (0 forward, 1 backward) for `dtype`, for
// reports: item 0 output rows, 1 output columns, 2 contraction depth a
// stage, 3 stages, 4 dynamic shared memory a block (bytes); 0 for
// arguments the launchers refuse.
KTWE_EXPORT int ktwe_fused_ce_tile(int which, int dtype, int item) {
  if ((which != kFwd && which != kBwd) || (dtype != kF32 && dtype != kBF16)) return 0;
  if (wgmma_body(dtype)) {
    const int items[5] = {tc::kBM, tc::kBN, tc::kBK, tc::kStages, tc::kSmem};
    return item >= 0 && item < 5 ? items[item] : 0;
  }
  const int smem = static_cast<int>(which == kFwd ? simt::smem_bytes<false>()
                                                  : simt::smem_bytes<true>());
  const int items[5] = {simt::kBM, simt::kBN, simt::kBK, 1, smem};
  return item >= 0 && item < 5 ? items[item] : 0;
}
