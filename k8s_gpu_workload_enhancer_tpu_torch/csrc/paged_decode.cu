// Paged decode attention for Hopper: one new token per slot, attending the
// slot's KV through its block table, as a split-KV (flash-decoding) schedule.
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
// m / l / acc in VMEM from one grid step to the next.
//
// Bound: bytes. Each (slot, kv head) reads its K and V rows once,
// (pos + 1) * D * 2 elements, against 4 * G * D flops a position: at the
// paged engine's shape (8 slots, 4 kv heads, D 512, G 1, positions 130-207,
// bf16) about 11 MB, 3.3 microseconds at 3.35 TB/s. The first version of this
// kernel launched one block per (slot, kv head), 32 blocks on 132 SMs, each
// walking its positions in series: latency, not bandwidth, bounded it.
//
// Schedule. The grid is (kv head x group tile x column slice, slot, split):
//   - a split is a fixed run of split_len logical positions. split_len comes
//     from the table's static width (MB * BL) and the grid's other axes
//     (ktwe_paged_decode_split_len: about kTargetBlocks blocks a call, in
//     whole tiles of kTile positions), never from pos, so a launch can be
//     captured in a CUDA graph. A block reads pos[b] itself; a split that
//     starts past it marks its partial empty and exits;
//   - a group tile is up to 16 query rows of one kv head (bf16) or up to 8
//     (f32): the group size has no ceiling, it only adds tiles;
//   - a column slice is 512 output columns (D above 512 takes several); the
//     scores always run over the whole D, so slices repeat them (off every
//     main path).
// Each split writes an f32 partial (m, l, acc) for its rows to a workspace
// (one scratch tensor from the caching allocator); paged_decode_combine_kernel
// merges the partials in split order, rescaling each by exp(m_s - m) in f32,
// and divides and casts once, so the output is the same bits from call to
// call. The main path launches both with one host call
// (ktwe_paged_decode_fwd); ktwe_paged_decode_split and
// ktwe_paged_decode_combine launch one each, for checking the combine
// alone. p is rounded relative to its split's running max (the TPU
// kernel's to its page-by-page running max, the plain version's to the
// global max): the bf16 output moves within the forward tolerance, f32
// only by summation order.
//
// Loads. A block copies units of kTile positions x up to 512 columns, the
// tile's K chunks then its V slice, through a ring of `stages` buffers in
// shared memory with cp.async: the units ahead are in flight while one is
// consumed. Four threads copy each row of a unit, so a thread looks its
// row's page up once a tile (the first tile's lookup goes out together
// with the read of pos[b]). The copy width comes from D x element size:
// 16 bytes where that divides, 8 or 4 where it does not; a bf16 head_dim
// that is odd is copied element by element. Rows past pos[b] or the
// split's end are zero-filled and masked.
// The stage count fits the ring in kRingBytes (at least two stages), and a
// block allocates no more stages than its split can use.
//
// Products.
//   - bf16 (paged_decode_mma_kernel): mma.sync m16n8k16 (bf16 in, f32 out)
//     on a 16-row group tile, padded with zero rows where G < 16 (G 1 is the
//     serve default: the tensor cores do 16 times the work and still wait on
//     memory). Each of the 4 warps takes 128 columns of a unit: for S it
//     contracts them against Q fragments held in registers (K fragments by
//     ldmatrix from the ring), and the warps' partial scores meet in shared
//     memory in a fixed order, so every warp holds the same S; each warp runs
//     the softmax on it in registers, turns P into A fragments in place, and
//     accumulates its 128 output columns of P V (V fragments by
//     ldmatrix.trans). Ring rows of an odd number of 16-byte words (1040
//     bytes at D 512) keep ldmatrix free of bank conflicts.
//   - f32 (paged_decode_simt_kernel): CUDA cores, since f32 needs true f32
//     products. Lane j of every warp owns position j of a tile; warp w sums
//     its 128 columns of each K chunk for the tile's rows (16-byte reads from
//     shared memory, q from L1), the four partials meet in shared memory, a
//     warp per row runs the softmax over the lanes, and thread t owns output
//     columns t + 128 u of the slice for every row of the tile.
//
// The table ids come from the host and are trusted (< NB); the engine keeps
// them so. A parked slot's row is all trash (page 0) at pos max_seq - 1: its
// blocks walk the trash page and write output nobody reads.
//
// Registers, spills and shared memory of every instance (`-Xptxas -v`) are
// printed by chip_smoke.py's `paged_decode_build` line; times beside the
// bound are in PERF.md, section 6, row 10.
#include <atomic>
#include <cstdint>

#include "common.cuh"

using namespace ktwe;

namespace {

constexpr int kThreads = 128;               // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                   // positions a tile
constexpr int kUnit = 512;                  // columns of a copied unit
constexpr int kWarpCols = kUnit / kWarps;   // 128: a warp's columns of a unit
constexpr int kMmaRows = 16;                // group tile of the bf16 body
constexpr int kSimtRows = 8;                // largest group tile of the f32 body
constexpr int kTargetBlocks = 528;          // 132 SMs x 4
constexpr int kMaxSplits = kTargetBlocks;
constexpr int kRingBytes = 100 * 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxDynamicSmem = 136 * 1024;  // two f32 stages
constexpr float kNegInf = -1e30f;

// A ring row in elements: the unit's columns (min(D, 512)) in whole 32-byte
// words plus 16 bytes, an odd number of 16-byte words, so that 8 consecutive
// rows fall in 8 distinct bank groups.
template <typename T>
int ring_row(int d) {
  const int bytes = (d < kUnit ? d : kUnit) * static_cast<int>(sizeof(T));
  return ((bytes + 31) / 32 * 32 + 16) / static_cast<int>(sizeof(T));
}

struct Args {
  const void* q;       // (B, H, D)
  const void* k;       // (NB, BL, KH, D)
  const void* v;       // (NB, BL, KH, D)
  const int* table;    // (B, MB)
  const int* pos;      // (B,)
  float* part_acc;     // (splits, B, H, D)
  float* part_ml;      // (splits, B, H, 2): running max, sum
  int batch, h, kh, d, bl, bl_shift, mb;
  int g;               // H / KH
  int rows;            // rows of a group tile
  int gtiles;          // group tiles a kv head
  int slices;          // 512-column slices of D (and K chunks)
  int split_len;       // positions a split, a multiple of kTile
  int stages;          // ring buffers
  int lds;             // elements a ring row (ring_row)
  float scale;
};

constexpr int kRowThreads = kThreads / kTile;  // threads that copy one row of a unit

// What one block owns.
struct Block {
  int kvh, slice, b, split;
  int h0;          // first query head of the group tile
  int n_rows;      // rows of the tile that exist
  int s0, j_end;   // positions [s0, j_end) this split attends
  int n_tiles;
  const int* trow;  // the slot's table row
  int row_tile;     // the tile of row_at
  long long row_at; // this thread's copy row in the pool (page * BL + row), -1 past the table
};

// The page row of the position this thread copies in tile t: thread t of
// the block copies row t / kRowThreads of every unit of a tile, so one
// table lookup serves the tile's K chunks and V slice.
__device__ __forceinline__ long long thread_row(const Args& a, const Block& k, int t) {
  const int j = k.s0 + t * kTile + static_cast<int>(threadIdx.x) / kRowThreads;
  if (j >= a.mb * a.bl) return -1;
  const int page = k.trow[a.bl_shift >= 0 ? j >> a.bl_shift : j / a.bl];
  const int in_page = a.bl_shift >= 0 ? (j & (a.bl - 1)) : j % a.bl;
  return static_cast<long long>(page) * a.bl + in_page;
}

// The block's coordinates; the first tile's table lookup goes out before
// pos[b] is read, so the two loads are in flight together.
__device__ __forceinline__ Block block_of(const Args& a) {
  Block k;
  int x = blockIdx.x;
  k.slice = x % a.slices;
  x /= a.slices;
  const int gt = x % a.gtiles;
  k.kvh = x / a.gtiles;
  k.b = blockIdx.y;
  k.split = blockIdx.z;
  k.h0 = k.kvh * a.g + gt * a.rows;
  k.n_rows = min(a.rows, a.g - gt * a.rows);
  k.s0 = k.split * a.split_len;
  k.trow = a.table + static_cast<long long>(k.b) * a.mb;
  k.row_tile = 0;
  k.row_at = thread_row(a, k, 0);
  const int span = a.mb * a.bl;
  const int last = static_cast<int>(min(static_cast<long long>(a.pos[k.b]),
                                        static_cast<long long>(span - 1)));
  k.j_end = min(k.s0 + a.split_len, last + 1);
  k.n_tiles = k.j_end > k.s0 ? (k.j_end - k.s0 + kTile - 1) / kTile : 0;
  return k;
}

// Index of query row r of the block's tile in (splits, B, H).
__device__ __forceinline__ long long part_row(const Args& a, const Block& k, int r) {
  return (static_cast<long long>(k.split) * a.batch + k.b) * a.h + k.h0 + r;
}

// A split with no position at or before pos[b]: m = NEG_INF, l = 0; the
// combine never reads its acc.
__device__ __forceinline__ void write_empty(const Args& a, const Block& k) {
  if (k.slice == 0 && static_cast<int>(threadIdx.x) < k.n_rows) {
    float* ml = a.part_ml + part_row(a, k, threadIdx.x) * 2;
    ml[0] = kNegInf;
    ml[1] = 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are pending.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// One CW-byte copy from device memory into shared memory; zeros where the row
// is not valid. CW 16 bypasses L1 (cp.async.cg); 8 and 4 go through it (the
// only sizes cp.async.ca takes); 2 (an odd bf16 head_dim) is a plain copy.
template <typename T, int CW>
__device__ __forceinline__ void copy_one(T* dst, const T* src, bool valid) {
  if constexpr (CW == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (CW >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(CW), "r"(valid ? CW : 0)
                 : "memory");
  } else {
    static_assert(sizeof(T) == 2, "element-wise copies are for bf16");
    *dst = valid ? *src : from_f<T>(0.f);
  }
}

// Copy one unit of tile t (its rows j0 .. j0 + kTile - 1), columns [col0,
// col0 + width) of kv head kvh, into a ring buffer (rows of a.lds): the
// kRowThreads threads of a row copy its 16-byte chunks side by side.
template <typename T, int CW>
__device__ __forceinline__ void copy_unit(T* dst, const T* pages, const Args& a, const Block& k,
                                          int t, int col0, int width) {
  constexpr int kPer = CW / static_cast<int>(sizeof(T)) > 0 ? CW / static_cast<int>(sizeof(T)) : 1;
  const int r = threadIdx.x / kRowThreads;
  const bool valid = k.s0 + t * kTile + r < k.j_end;
  const T* src = valid ? pages + (k.row_at * a.kh + k.kvh) * a.d + col0 : pages;
  T* row = dst + r * a.lds;
  for (int c = (threadIdx.x % kRowThreads) * kPer; c < width; c += kRowThreads * kPer) {
    copy_one<T, CW>(row + c, valid ? src + c : pages, valid);
  }
}

// The ring: units are (tile t, part c), c < slices the K chunk c, c == slices
// the V slice, consumed in order by every thread once the unit has landed;
// stages - 1 units are in flight ahead of the one consumed, and one barrier
// a unit frees the buffer the next copy overwrites. Unit u goes to buffer
// u % stages. issue_unit starts the copy of unit u (nothing past the last)
// as one commit group; units are issued in order, so k's row cache moves
// on a tile at a time.
template <typename T, int CW>
__device__ __forceinline__ void issue_unit(const Args& a, Block& k, T* ring, int u, int units) {
  if (u < units) {
    const int per_tile = a.slices + 1;
    const int t = u / per_tile;
    const int c = u - t * per_tile;
    const bool is_v = c == a.slices;
    const int col0 = (is_v ? k.slice : c) * kUnit;
    if (t != k.row_tile) {
      k.row_tile = t;
      k.row_at = thread_row(a, k, t);
    }
    copy_unit<T, CW>(ring + (u % a.stages) * kTile * a.lds,
                     static_cast<const T*>(is_v ? a.v : a.k), a, k, t, col0,
                     min(kUnit, a.d - col0));
  }
  cp_commit();
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q fragments of this warp's 128 columns of K chunk `chunk` (zeros past the
// tile's rows and past D). Fragment layout (lane = 4 g + t): an A fragment
// holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; a C
// fragment rows g and g + 8, columns 2t, 2t + 1 of an 8-column tile.
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* qb, int n_rows, int d,
                                             int col0, uint32_t (&qf)[kWarpCols / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c0 = col0 + 2 * (lane & 3);
  auto at = [&](int r, int c) {
    return r < n_rows && c < d ? to_f(qb[static_cast<long long>(r) * d + c]) : 0.f;
  };
#pragma unroll
  for (int ks = 0; ks < kWarpCols / 16; ++ks) {
    const int c = c0 + 16 * ks;
    qf[ks][0] = pack_bf16(at(g, c), at(g, c + 1));
    qf[ks][1] = pack_bf16(at(g + 8, c), at(g + 8, c + 1));
    qf[ks][2] = pack_bf16(at(g, c + 8), at(g, c + 9));
    qf[ks][3] = pack_bf16(at(g + 8, c + 8), at(g + 8, c + 9));
  }
}

template <int CW>
__global__ void __launch_bounds__(kThreads) paged_decode_mma_kernel(Args a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps * 16 * 32];  // each warp's partial scores
  T* ring = reinterpret_cast<T*>(smem);
  Block k = block_of(a);
  if (k.n_tiles == 0) {
    write_empty(a, k);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wcol = warp * kWarpCols;
  const int mat = lane >> 3;   // ldmatrix: the 8 x 8 matrix this lane addresses
  const int mrow = lane & 7;   // and its row
  const T* qb = static_cast<const T*>(a.q) + (static_cast<long long>(k.b) * a.h + k.h0) * a.d;
  const int per_tile = a.slices + 1;
  const int units = k.n_tiles * per_tile;

  // The last K chunk's columns up to the next multiple of 16 are read by its
  // last k-step: zero them once in every buffer the block uses (a buffer
  // holds real, finite data there otherwise).
  const int w_last = a.d - (a.slices - 1) * kUnit;
  if (w_last & 15) {
    const int pad = ((w_last + 15) & ~15) - w_last;
    const int bufs = min(a.stages, units);
    for (int idx = threadIdx.x; idx < bufs * kTile * pad; idx += kThreads) {
      ring[(idx / pad) * a.lds + w_last + idx % pad] = from_f<T>(0.f);
    }
  }

  uint32_t qf[kWarpCols / 16][4];
  float s[4][4];              // scores: 4 tiles of 8 positions
  float o[kWarpCols / 8][4];  // this warp's 128 output columns
#pragma unroll
  for (int n = 0; n < kWarpCols / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows gq, gq + 8
  const int wv = min(kUnit, a.d - k.slice * kUnit);      // V slice width

  // Q's fragments before the first copies: measured faster at the paged
  // engine's shape than after them (PERF.md, section 6, row 10).
  if (a.slices == 1) load_q_frags(qb, k.n_rows, a.d, wcol, qf);
  for (int u = 0; u + 1 < a.stages; ++u) issue_unit<T, CW>(a, k, ring, u, units);
  for (int u = 0; u < units; ++u) {
    cp_wait(a.stages - 2);
    __syncthreads();  // unit u visible to all; unit u - 1's buffer free
    issue_unit<T, CW>(a, k, ring, u + a.stages - 1, units);
    const int t = u / per_tile;
    const int c = u - t * per_tile;
    const uint32_t base = smem_addr(ring + (u % a.stages) * kTile * a.lds);
    if (c < a.slices) {  // K chunk c: this warp's share of S
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        }
      }
      if (a.slices > 1) load_q_frags(qb, k.n_rows, a.d, c * kUnit + wcol, qf);
      const int width = min(kUnit, a.d - c * kUnit);
#pragma unroll
      for (int ks = 0; ks < kWarpCols / 16; ++ks) {
        const int k0 = wcol + 16 * ks;
        if (k0 < width) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int row = 8 * (2 * np + (mat >> 1)) + mrow;
            const int col = k0 + 8 * (mat & 1);
            uint32_t b0, b1, b2, b3;
            ldsm_x4(base + (row * a.lds + col) * 2, b0, b1, b2, b3);
            mma_bf16(s[2 * np], qf[ks], b0, b1);
            mma_bf16(s[2 * np + 1], qf[ks], b2, b3);
          }
        }
      }
      continue;
    }

    // V slice: the warps' partial scores, summed in warp order, give every
    // warp the same S; then the softmax and P V in registers.
#pragma unroll
    for (int i = 0; i < 16; ++i) red[(warp * 16 + i) * 32 + lane] = s[i / 4][i % 4];
    __syncthreads();
    const int j0 = k.s0 + t * kTile + 2 * tq;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float sum = red[i * 32 + lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[(w * 16 + i) * 32 + lane];
      const int j = j0 + 8 * (i / 4) + (i & 1);
      const float sv = j < k.j_end ? __fmul_rn(sum, a.scale) : kNegInf;
      s[i / 4][i % 4] = sv;
      if ((i & 2) == 0) {
        mx0 = fmaxf(mx0, sv);
      } else {
        mx1 = fmaxf(mx1, sv);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(fmaxf(m0, mx0), kNegInf * 0.5f);
    const float mn1 = fmaxf(fmaxf(m1, mx1), kNegInf * 0.5f);
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[2][4];  // P as A fragments: positions 0-15, 16-31
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float p0 = expf(s[n][0] - mn0);
      const float p1 = expf(s[n][1] - mn0);
      const float p2 = expf(s[n][2] - mn1);
      const float p3 = expf(s[n][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[n >> 1][2 * (n & 1)] = pack_bf16(p0, p1);
      pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int np = 0; np < kWarpCols / 16; ++np) {
        const int n0 = wcol + 16 * np;
        if (n0 < wv) {
          const int row = 16 * ks + 8 * (mat & 1) + mrow;
          const int col = n0 + 8 * (mat >> 1);
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(base + (row * a.lds + col) * 2, b0, b1, b2, b3);
          mma_bf16(o[2 * np], pa[ks], b0, b1);
          mma_bf16(o[2 * np + 1], pa[ks], b2, b3);
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gq + 8 * half;
    if (r < k.n_rows) {
      float* acc = a.part_acc + part_row(a, k, r) * a.d + k.slice * kUnit;
#pragma unroll
      for (int n = 0; n < kWarpCols / 8; ++n) {
        const int c = wcol + 8 * n + 2 * tq;
        if (c < wv) acc[c] = o[n][2 * half];
        if (c + 1 < wv) acc[c + 1] = o[n][2 * half + 1];
      }
      if (k.slice == 0 && warp == 0 && tq == 0) {
        float* ml = a.part_ml + part_row(a, k, r) * 2;
        ml[0] = half ? m1 : m0;
        ml[1] = half ? l1 : l0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

// GR: rows of a group tile (1, 2, 4 or 8).
template <typename T, int GR, int CW>
__global__ void __launch_bounds__(kThreads) paged_decode_simt_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps][GR][32];
  __shared__ float ps[GR][kTile];
  __shared__ float m_s[GR];
  __shared__ float l_s[GR];
  __shared__ float c_s[GR];
  constexpr int kCols = kUnit / kThreads;  // output columns a thread
  T* ring = reinterpret_cast<T*>(smem);
  Block k = block_of(a);
  if (k.n_tiles == 0) {
    write_empty(a, k);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wcol = warp * kWarpCols;
  const T* qb = static_cast<const T*>(a.q) + (static_cast<long long>(k.b) * a.h + k.h0) * a.d;
  const int per_tile = a.slices + 1;
  const int units = k.n_tiles * per_tile;
  const int wv = min(kUnit, a.d - k.slice * kUnit);  // V slice width
  if (threadIdx.x < GR) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float sreg[GR];  // this warp's partial score of the lane's position
  float acc[GR][kCols];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    sreg[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  }

  for (int u = 0; u + 1 < a.stages; ++u) issue_unit<T, CW>(a, k, ring, u, units);
  for (int u = 0; u < units; ++u) {
    cp_wait(a.stages - 2);
    __syncthreads();  // unit u visible to all; unit u - 1's buffer free
    issue_unit<T, CW>(a, k, ring, u + a.stages - 1, units);
    const int t = u / per_tile;
    const int c = u - t * per_tile;
    const T* buf = ring + (u % a.stages) * kTile * a.lds;
    if (c < a.slices) {  // K chunk c: the lane's position, this warp's columns
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < GR; ++r) sreg[r] = 0.f;
      }
      const int hi = min(wcol + kWarpCols, min(kUnit, a.d - c * kUnit));
      const T* krow = buf + lane * a.lds;
      const T* qc = qb + c * kUnit;
      int cc = wcol;
      if constexpr (sizeof(T) == 4) {
        for (; cc + 4 <= hi; cc += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + cc);
#pragma unroll
          for (int r = 0; r < GR; ++r) {
            if (r < k.n_rows) {
              const T* qr = qc + static_cast<long long>(r) * a.d + cc;
              sreg[r] = fmaf(to_f(__ldg(qr)), kv.x, sreg[r]);
              sreg[r] = fmaf(to_f(__ldg(qr + 1)), kv.y, sreg[r]);
              sreg[r] = fmaf(to_f(__ldg(qr + 2)), kv.z, sreg[r]);
              sreg[r] = fmaf(to_f(__ldg(qr + 3)), kv.w, sreg[r]);
            }
          }
        }
      }
      for (; cc < hi; ++cc) {
        const float kv = to_f(krow[cc]);
#pragma unroll
        for (int r = 0; r < GR; ++r) {
          if (r < k.n_rows) {
            sreg[r] = fmaf(to_f(__ldg(qc + static_cast<long long>(r) * a.d + cc)), kv, sreg[r]);
          }
        }
      }
      continue;
    }

    // V slice: the tile's scores, its softmax, then P V.
#pragma unroll
    for (int r = 0; r < GR; ++r) red[warp][r][lane] = sreg[r];
    __syncthreads();
    const int j = k.s0 + t * kTile + lane;
    for (int r = warp; r < GR; r += kWarps) {
      float sum = red[0][r][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w][r][lane];
      const float sv = j < k.j_end ? __fmul_rn(sum, a.scale) : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(fmaxf(m_prev, warp_max(sv)), kNegInf * 0.5f);
      const float p = expf(sv - m_new);
      const float corr = expf(m_prev - m_new);
      const float p_sum = warp_sum(p);
      ps[r][lane] = to_f(from_f<T>(p));  // p in V's dtype for the PV product
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + p_sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u2 = 0; u2 < kCols; ++u2) {
      const int col = threadIdx.x + u2 * kThreads;
      if (col < wv) {
#pragma unroll
        for (int r = 0; r < GR; ++r) acc[r][u2] *= c_s[r];
        for (int jj = 0; jj < kTile; ++jj) {
          const float vv = to_f(buf[jj * a.lds + col]);
#pragma unroll
          for (int r = 0; r < GR; ++r) acc[r][u2] = fmaf(ps[r][jj], vv, acc[r][u2]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (r < k.n_rows) {
      float* out = a.part_acc + part_row(a, k, r) * a.d + k.slice * kUnit;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = threadIdx.x + u * kThreads;
        if (col < wv) out[col] = acc[r][u];
      }
    }
  }
  if (k.slice == 0 && static_cast<int>(threadIdx.x) < k.n_rows) {
    float* ml = a.part_ml + part_row(a, k, threadIdx.x) * 2;
    ml[0] = m_s[threadIdx.x];
    ml[1] = l_s[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// Combine: one block a (slot, query head) row
// ---------------------------------------------------------------------------

// The splits' statistics are loaded together (one split a thread); thread
// 0 then lists the live splits (sum > 0) in split order with their weights,
// and every thread sums its columns over them, the live splits' loads
// issued together (4 columns a thread where D % 4 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(const float* __restrict__ part_acc,
                                const float* __restrict__ part_ml, T* __restrict__ o, int rows,
                                int d, int splits) {
  __shared__ float2 ml_s[kMaxSplits];
  __shared__ float w_s[kMaxSplits];
  __shared__ int live_s[kMaxSplits];
  __shared__ int n_live;
  __shared__ float l_tot;
  const long long row = blockIdx.x;
  for (int s = threadIdx.x; s < splits; s += kThreads) {
    ml_s[s] = __ldg(reinterpret_cast<const float2*>(part_ml) + static_cast<long long>(s) * rows +
                    row);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = kNegInf * 0.5f;
    for (int s = 0; s < splits; ++s) {
      if (ml_s[s].y > 0.f) m = fmaxf(m, ml_s[s].x);
    }
    float l = 0.f;
    int n = 0;
    for (int s = 0; s < splits; ++s) {
      if (ml_s[s].y > 0.f) {
        const float w = expf(ml_s[s].x - m);
        w_s[n] = w;
        live_s[n++] = s;
        l = fmaf(w, ml_s[s].y, l);
      }
    }
    n_live = n;
    l_tot = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int n = n_live;
  const long long split_stride = static_cast<long long>(rows) * d;
  const float* base = part_acc + row * d;
  T* out = o + row * d;
  if (d % 4 == 0) {
    for (int c = threadIdx.x * 4; c < d; c += kThreads * 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(base + live_s[i] * split_stride + c));
        const float w = w_s[i];
        acc.x = fmaf(w, v.x, acc.x);
        acc.y = fmaf(w, v.y, acc.y);
        acc.z = fmaf(w, v.z, acc.z);
        acc.w = fmaf(w, v.w, acc.w);
      }
      out[c] = from_f<T>(acc.x / l_tot);
      out[c + 1] = from_f<T>(acc.y / l_tot);
      out[c + 2] = from_f<T>(acc.z / l_tot);
      out[c + 3] = from_f<T>(acc.w / l_tot);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        acc = fmaf(w_s[i], __ldg(base + live_s[i] * split_stride + c), acc);
      }
      out[c] = from_f<T>(acc / l_tot);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Rows of a group tile for (dtype, G).
int group_rows(int dtype, int g) {
  if (dtype == kBF16) return kMmaRows;
  int r = 1;
  while (r < g && r < kSimtRows) r *= 2;
  return r;
}

// Positions a split: about kTargetBlocks blocks a call, in whole tiles.
int split_len_for(int batch, int h, int kh, int d, long long span, int dtype) {
  const int g = h / kh;
  const int rows = group_rows(dtype, g);
  const long long pairs = static_cast<long long>(batch) * kh * ((g + rows - 1) / rows) *
                          ((d + kUnit - 1) / kUnit);
  const long long max_splits = (span + kTile - 1) / kTile;
  long long want = (kTargetBlocks + pairs - 1) / pairs;
  want = want < 1 ? 1 : (want > max_splits ? max_splits : want);
  const long long per = (span + want - 1) / want;
  return static_cast<int>((per + kTile - 1) / kTile * kTile);
}

template <typename T>
int copy_width(int d) {
  const int bytes = d * static_cast<int>(sizeof(T));
  return bytes % 16 == 0 ? 16 : (bytes % 8 == 0 ? 8 : (bytes % 4 == 0 ? 4 : 2));
}

template <class Kernel>
cudaError_t launch_split(Kernel kernel, const Args& a, int device, int splits, size_t smem,
                         cudaStream_t stream, std::atomic<bool>* opted_in) {
  if (!opted_in[device].load(std::memory_order_acquire)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    opted_in[device].store(true, std::memory_order_release);
  }
  const dim3 grid(a.kh * a.gtiles * a.slices, a.batch, splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The shared-memory opt-in belongs to the kernel on a device: once each.
#define KTWE_LAUNCH_SPLIT(...)                                            \
  do {                                                                    \
    static std::atomic<bool> opted_in[kMaxDevices];                       \
    return launch_split(__VA_ARGS__, a, device, splits, smem, s, opted_in); \
  } while (0)

cudaError_t launch_bf16(const Args& a, int device, int splits, size_t smem, cudaStream_t s) {
  switch (copy_width<__nv_bfloat16>(a.d)) {
    case 16: KTWE_LAUNCH_SPLIT(paged_decode_mma_kernel<16>);
    case 8: KTWE_LAUNCH_SPLIT(paged_decode_mma_kernel<8>);
    case 4: KTWE_LAUNCH_SPLIT(paged_decode_mma_kernel<4>);
    default: KTWE_LAUNCH_SPLIT(paged_decode_mma_kernel<2>);
  }
}

template <int GR>
cudaError_t launch_f32_rows(const Args& a, int device, int splits, size_t smem, cudaStream_t s) {
  switch (copy_width<float>(a.d)) {
    case 16: KTWE_LAUNCH_SPLIT(paged_decode_simt_kernel<float, GR, 16>);
    case 8: KTWE_LAUNCH_SPLIT(paged_decode_simt_kernel<float, GR, 8>);
    default: KTWE_LAUNCH_SPLIT(paged_decode_simt_kernel<float, GR, 4>);
  }
}

cudaError_t launch_f32(const Args& a, int device, int splits, size_t smem, cudaStream_t s) {
  switch (a.rows) {
    case 1: return launch_f32_rows<1>(a, device, splits, smem, s);
    case 2: return launch_f32_rows<2>(a, device, splits, smem, s);
    case 4: return launch_f32_rows<4>(a, device, splits, smem, s);
    default: return launch_f32_rows<8>(a, device, splits, smem, s);
  }
}

}  // namespace

KTWE_DEFINE_ERROR_STRING

// Positions a split for a call of these shapes (span = MB * BL): the
// wrapper sizes the workspace from it.
KTWE_EXPORT int ktwe_paged_decode_split_len(int batch, int h, int kh, int d, long long span,
                                            int dtype) {
  if (batch <= 0 || h <= 0 || kh <= 0 || h % kh != 0 || d <= 0 || span <= 0 ||
      (dtype != kF32 && dtype != kBF16)) {
    return 0;
  }
  return split_len_for(batch, h, kh, d, span, dtype);
}

// q: (batch, h, d); k, v: (nb, bl, kh, d), one dtype; table: (batch, mb)
// int32 page ids < nb; pos: (batch,) int32; part_acc: (splits, batch, h, d)
// f32 and part_ml: (splits, batch, h, 2) f32, with split_len from
// ktwe_paged_decode_split_len and splits = ceil(mb * bl / split_len). All
// contiguous, 16-byte aligned. Writes every split's partial.
KTWE_EXPORT int ktwe_paged_decode_split(const void* q, const void* k, const void* v,
                                        const void* table, const void* pos, void* part_acc,
                                        void* part_ml, int batch, int h, int kh, int d, int nb,
                                        int bl, int mb, int split_len, float scale, int dtype,
                                        int device, void* stream) {
  const long long span = static_cast<long long>(mb) * bl;
  if (batch <= 0 || batch > 65535 || h <= 0 || kh <= 0 || h % kh != 0 || d <= 0 || nb <= 0 ||
      bl <= 0 || mb <= 0 || span > (1LL << 30) || split_len <= 0 || split_len % kTile != 0 ||
      device < 0 || device >= kMaxDevices || (dtype != kF32 && dtype != kBF16)) {
    return kBadArgument;
  }
  const long long splits = (span + split_len - 1) / split_len;
  if (splits > kMaxSplits) return kBadArgument;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  Args a{q, k, v, static_cast<const int*>(table), static_cast<const int*>(pos),
         static_cast<float*>(part_acc), static_cast<float*>(part_ml),
         batch, h, kh, d, bl, -1, mb, h / kh, 0, 0, (d + kUnit - 1) / kUnit, split_len, 0, 0,
         scale};
  if ((bl & (bl - 1)) == 0) {
    a.bl_shift = 0;
    while ((1 << a.bl_shift) < bl) ++a.bl_shift;
  }
  a.rows = group_rows(dtype, a.g);
  a.gtiles = (a.g + a.rows - 1) / a.rows;
  if (static_cast<long long>(a.kh) * a.gtiles * a.slices > 0x7fffffffLL) return kBadArgument;
  a.lds = dtype == kBF16 ? ring_row<__nv_bfloat16>(d) : ring_row<float>(d);
  const int stage = kTile * a.lds * (dtype == kBF16 ? 2 : 4);
  int stages = kRingBytes / stage;
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  a.stages = stages;
  const int units = split_len / kTile * (a.slices + 1);
  const size_t smem = static_cast<size_t>(stages < units ? stages : units) * stage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == kBF16 ? launch_bf16(a, device, static_cast<int>(splits), smem, s)
                       : launch_f32(a, device, static_cast<int>(splits), smem, s);
  return static_cast<int>(err);
}

// o: (rows, d) in `dtype` from the partials (splits, rows, d) and (splits,
// rows, 2) that ktwe_paged_decode_split wrote (rows = batch * h).
KTWE_EXPORT int ktwe_paged_decode_combine(const void* part_acc, const void* part_ml, void* o,
                                          int rows, int d, int splits, int dtype, int device,
                                          void* stream) {
  if (rows <= 0 || d <= 0 || splits <= 0 || splits > kMaxSplits || device < 0 ||
      device >= kMaxDevices || (dtype != kF32 && dtype != kBF16)) {
    return kBadArgument;
  }
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* acc = static_cast<const float*>(part_acc);
  const float* ml = static_cast<const float*>(part_ml);
  if (dtype == kBF16) {
    paged_decode_combine_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        acc, ml, static_cast<__nv_bfloat16*>(o), rows, d, splits);
  } else {
    paged_decode_combine_kernel<float><<<rows, kThreads, 0, s>>>(acc, ml, static_cast<float*>(o),
                                                                rows, d, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The main path's call: ktwe_paged_decode_split, then ktwe_paged_decode_combine
// into o (batch, h, d) in q's dtype, one host call for both launches.
KTWE_EXPORT int ktwe_paged_decode_fwd(const void* q, const void* k, const void* v,
                                      const void* table, const void* pos, void* o,
                                      void* part_acc, void* part_ml, int batch, int h, int kh,
                                      int d, int nb, int bl, int mb, int split_len, float scale,
                                      int dtype, int device, void* stream) {
  const int err = ktwe_paged_decode_split(q, k, v, table, pos, part_acc, part_ml, batch, h, kh, d,
                                          nb, bl, mb, split_len, scale, dtype, device, stream);
  if (err != 0) return err;
  const long long splits = (static_cast<long long>(mb) * bl + split_len - 1) / split_len;
  return ktwe_paged_decode_combine(part_acc, part_ml, o, batch * h, d, static_cast<int>(splits),
                                   dtype, device, stream);
}
