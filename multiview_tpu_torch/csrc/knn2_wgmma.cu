// Fused squared-L2 distance + running top-2 for descriptor matching on the
// tensor cores of Hopper (sm_90a): split-TF32 wgmma, asynchronous slab loads,
// every descriptor width.
//
// Replaces the TPU kernel multiview_tpu/sfm/matching.py::matched_pairs_pallas
// (pl.pallas_call at matching.py:186) for every descriptor width. The first
// port of that kernel, csrc/knn2.cu (FP32 FMA on the CUDA cores), stays as the
// FP32 oracle on the card.
//
// What bounds it on the H100. A pair costs 2*N*M*D FLOP against
// (N + M)*D*4 + 12*N bytes: about 1000 FLOP per byte, so operations bound it,
// not memory.
//
//   shape (pairs x N x M x D)   FLOP     bytes    TF32 tensor cores   3xTF32 floor   memory
//                                                 (495 TFLOP/s)                      (3.35 TB/s)
//   8 x 4096 x 4096 x 128       34.4 G   33.9 MB  0.069 ms            0.208 ms       0.010 ms
//   1 x 10000 x 10000 x 128     25.6 G   10.4 MB  0.052 ms            0.155 ms       0.003 ms
//
// Each dot product is computed three times over on the tensor cores (3xTF32)
// to keep FP32 accuracy, so the kernel's own floor is three times the TF32
// column.
//
// Design.
// * Exactness: every input x is split once into hi = tf32(x) and
//   lo = tf32(x - hi) (cvt.rna.tf32.f32), and
//   q.t ~= q_lo.t_hi + q_hi.t_lo + q_hi.t_hi, accumulated in FP32 in that
//   order (small terms first). The dropped q_lo.t_lo term is below 2^-22 of
//   sum|q_i t_i|. The tensor cores truncate when they add into the FP32
//   accumulator, so a sum over all of D comes out low (measured on unit
//   128-wide descriptors: distances 9.7e-7 too large in the mean). The sum
//   is therefore cut into chains of 16 dimensions; each chain starts from
//   zero and the chains are added on the CUDA cores, rounding to nearest.
//   Row norms are exact FP32 sums of the unsplit rows (same summation order
//   as csrc/knn2.cu) and the distance stays max(|q|^2 + |t|^2 - 2 q.t, 0).
// * Shared-memory traffic. wgmma m64n64k8 with both operands in shared
//   memory reads 4 KB per 65,536 FLOP: at the tensor cores' TF32 rate (about
//   2048 FLOP a clock an SM) that is 128 B a clock, all the bandwidth an SM's
//   shared memory has. This kernel issues m64n96k8: 5 KB per 98,304 FLOP,
//   104 B a clock. (m64n128k8 would need 96 B, but two of its accumulators
//   and their running sum do not fit a thread's registers beside the rest.)
// * L2 traffic. A block owns 128 query rows (two consumer warpgroups of 64
//   rows each) and both read the same train slabs, so a train byte loaded
//   into shared memory feeds 128 query rows: 21 B a clock an SM at the
//   tensor cores' rate at D <= 128.
// * Slabs. The query set is cut into tiles of 128 rows, the train set into
//   tiles of 96, every tile into slabs of 32 dimensions (one 128-byte swizzle
//   row: hi then lo, each rows x 32 floats in the K-major, 128-byte-swizzled
//   order wgmma reads). A width that is not a multiple of 32 is zero-filled
//   by the loads, and only the chains that hold a dimension below D are
//   issued; zeros change no product and no norm. Rows past the end of a set
//   are zero with norm +inf, so their distance is +inf and they never win:
//   ragged edges need no pad rows in the data and no test in the inner loop.
// * Pre-pass (split_sets, one launch): one warp per row of either set writes
//   the row's slabs and its norm, and the first threads zero the ticket
//   counters of the call. Where D <= 128 the block's query tile (at most
//   128 KB split) is copied into shared memory once and stays for the whole
//   sweep; above 128 the query tile's slabs are streamed beside the train
//   tile's, so shared memory holds at any width.
// * Main kernel: three warpgroups. The first thread of warpgroup 0 keeps slabs
//   in flight with cp.async.bulk (one linear copy lands a slab in place;
//   completion on an mbarrier) into a ring of stages, refilling a stage once
//   both consumer warpgroups have released it; a tile's train norms arrive
//   with its last slab. setmaxnreg gives its registers to the consumers (232
//   a thread). Each consumer warpgroup keeps two chains in flight (a chain:
//   six m64n96k8, two k-steps of the three split products, into one of two
//   accumulators), adds a retired chain into its running dot products on the
//   CUDA cores while the next runs, releases a stage when the slab's chains
//   have retired, and at a tile's end folds the 64 x 96 fragment into a
//   running (best, index, second) per row in registers while the next
//   tile's first two chains run. Columns reach a thread in increasing index
//   and the comparisons are strict, so ties keep the lowest index and an
//   exact duplicate gives second == best. At the end the four threads of a
//   quad merge ordered by (distance, index).
// * What the compiler must see: no branch that parts a warpgroup and no
//   instruction that writes an accumulator while a chain runs (ptxas then
//   serializes the wgmma: measured 3 to 10 times slower). So every wait
//   loops inside its asm, the first product of a chain only writes its
//   accumulator, every step issues a chain (past the sweep's end the last
//   one again, its result unread), and the chain count is a template
//   parameter (an instance for each even count up to 16, D <= 256; one
//   reading it at run time for the rest), so a tile's chains unroll with
//   no index arithmetic.
// * Filling the card at one pair: the sweep is split over `splits` blocks per
//   query tile (chosen by the caller from the block count and the SM count).
//   Each block writes a partial top-2; the last block of a query tile to take
//   a ticket folds the partials in split order, so the result does not
//   depend on which block finished last. Two launches a call in all.
//
// Nothing here allocates or synchronises: the caller provides the scratch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kQueryRows = 128;                  // rows of a query tile: two warpgroups
constexpr int kTrainRows = 96;                   // rows of a train tile: the wgmma's N
constexpr int kWgRows = 64;                      // query rows of a warpgroup: the wgmma's M
constexpr int kFrag = kWgRows * kTrainRows / 128;  // accumulator floats a thread: 48
constexpr int kSlabDims = 32;                    // dimensions of a slab (a 128-byte row)
constexpr int kChainDims = 16;                   // dimensions the tensor cores sum in a chain
constexpr int kQHalfBytes = kQueryRows * kSlabDims * 4;  // hi (or lo) of a query slab: 16 KB
constexpr int kQSlabBytes = 2 * kQHalfBytes;     // hi + lo
constexpr int kTHalfBytes = kTrainRows * kSlabDims * 4;  // of a train slab: 12 KB
constexpr int kTSlabBytes = 2 * kTHalfBytes;
constexpr int kTNormBytes = kTrainRows * 4;      // a train tile's norms
constexpr int kResidentSlabs = 4;                // query tiles up to D = 128 stay in shared memory
constexpr int kMaxStages = 8;
constexpr int kConsumerThreads = 256;            // warpgroups 1 and 2
constexpr int kThreads = 128 + kConsumerThreads; // + warpgroup 0, the loader's
constexpr int kLoaderRegs = 40;                  // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;               // dynamic shared memory a block may have
constexpr int kSmemFixed = 2 * 8 * kMaxStages + 16;  // mbarriers and the ticket flag
constexpr int kParts = 8;                        // clock counters a warpgroup
constexpr long long kSpinLimit = 4000000000LL;   // clocks before a stuck wait traps

struct Geometry {
  int kbs;          // slabs a row
  int chains;       // chains of 16 dimensions that hold a dimension below D
  bool resident;    // the query tile stays in shared memory
  int stage_bytes;  // a stage: the train slab (and the query slab where streamed)
  int q_bytes;      // the resident query tile
  int stages;
  int smem_bytes;
};

Geometry geometry(int dim) {
  Geometry g;
  g.kbs = (dim + kSlabDims - 1) / kSlabDims;
  g.chains = (dim + kChainDims - 1) / kChainDims;
  g.resident = g.kbs <= kResidentSlabs;
  g.stage_bytes = g.resident ? kTSlabBytes : kTSlabBytes + kQSlabBytes;
  g.q_bytes = g.resident ? g.kbs * kQSlabBytes : 0;
  g.stages = (kSmemLimit - kSmemFixed - g.q_bytes) / (g.stage_bytes + kTNormBytes);
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.smem_bytes = g.q_bytes + g.stages * (g.stage_bytes + kTNormBytes) + kSmemFixed;
  return g;
}

// ------------------------------------------------------------ the splitting

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xffffe000u);
}

// where element (row r of a tile, dimension `lane` of a slab) lies in the
// 128-byte-swizzled slab half, in floats
__device__ __forceinline__ int swizzled(int r, int lane) {
  return r * kSlabDims + ((((lane >> 2) ^ (r & 7)) << 2) | (lane & 3));
}

// the norm a warp has summed lane-wise, in csrc/knn2.cu's order, on every lane
__device__ __forceinline__ float warp_norm(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return __shfl_sync(0xffffffffu, s, 0);
}

struct SetArgs {
  const float* x;           // [pairs, rows, dim]
  unsigned char* slabs;     // [pairs, tiles, kbs, {hi, lo}[tile_rows][32 swizzled]]
  float* norms;             // [pairs, tiles * tile_rows]
  int rows, tiles, tile_rows;
  long long padded_rows;    // pairs * tiles * tile_rows
};

// One warp per padded row of set a, then of set b; the first threads also
// zero the call's ticket counters.
__global__ void split_sets(SetArgs a, SetArgs b, int dim, int kbs, int* __restrict__ tickets,
                           int n_tickets) {
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = gid; i < n_tickets; i += (long long)gridDim.x * blockDim.x)
    tickets[i] = 0;
  long long prow = gid >> 5;
  const int lane = threadIdx.x & 31;
  const bool in_a = prow < a.padded_rows;
  if (!in_a) prow -= a.padded_rows;
  if (prow >= (in_a ? a.padded_rows : b.padded_rows)) return;  // uniform per warp
  const int rows = in_a ? a.rows : b.rows;
  const int tiles = in_a ? a.tiles : b.tiles;
  const int tile_rows = in_a ? a.tile_rows : b.tile_rows;
  const int half = tile_rows * kSlabDims;  // floats of a slab's hi (or lo)
  const long long tile = prow / tile_rows;  // over all pairs
  const int r = (int)(prow % tile_rows);
  const long long pair = tile / tiles;
  const int row = (int)(tile % tiles) * tile_rows + r;
  const bool live = row < rows;
  const float* src = (in_a ? a.x : b.x) + (pair * rows + (live ? row : 0)) * (long long)dim;
  float* slab = reinterpret_cast<float*>(in_a ? a.slabs : b.slabs) + tile * kbs * 2LL * half;
  const int o = swizzled(r, lane);
  float sum = 0.f;
  // four slabs' loads in flight at a time: a warp's one row is all it reads
  for (int kb0 = 0; kb0 < kbs; kb0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = (kb0 + u) * kSlabDims + lane;
      v[u] = live && kb0 + u < kbs && col < dim ? src[col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kb0 + u < kbs) {
        sum = fmaf(v[u], v[u], sum);
        const float h = tf32_round(v[u]);
        slab[(kb0 + u) * 2 * half + o] = h;
        slab[(kb0 + u) * 2 * half + half + o] = tf32_round(v[u] - h);
      }
    }
  }
  sum = warp_norm(sum);
  if (lane == 0) (in_a ? a.norms : b.norms)[tile * tile_rows + r] = live ? sum : CUDART_INF_F;
}

// ------------------------------------------------------- PTX building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. The loop lies inside
// the asm, so that the compiler sees no branch that could part a warpgroup
// while its wgmma chains run. A wait that does not end (a lost copy, a wrong
// byte count) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar), "r"(parity), "l"(kSpinLimit)
      : "memory");
}

// Linear global -> shared copy of `bytes` (a multiple of 16), reported to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows at a 128-byte pitch, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// acc (64x96 FP32 fragment) = A(64x8) . B(96x8)^T (+ acc unless First). The
// first product of a chain only writes the accumulator, so that no value
// flows into it from before the chain.
template <bool First>
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[kFrag], uint64_t desc_a,
                                                    uint64_t desc_b) {
  if constexpr (First) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
          "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(0));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending) : "memory");
}
// keeps the compiler from moving accumulator reads across the asynchronous chain
__device__ __forceinline__ void fence_fragment(float (&d)[kFrag]) {
#pragma unroll
  for (int i = 0; i < kFrag; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One chain: k-steps 2h and 2h + 1 (8 dimensions each) of a slab, the three
// split products small terms first, summed by the tensor cores into `acc`
// (overwritten) and committed as one group. A k-step is 32 bytes inside the
// slab's 128-byte rows.
__device__ __forceinline__ void issue_chain(float (&acc)[kFrag], uint64_t a_hi, uint64_t a_lo,
                                            uint64_t b_hi, uint64_t b_lo, int h) {
  wgmma_fence();
  const uint64_t off0 = (uint64_t)((2 * h * 32) >> 4), off1 = off0 + 2;
  wgmma_m64n96k8_tf32<true>(acc, a_lo + off0, b_hi + off0);
  wgmma_m64n96k8_tf32<false>(acc, a_lo + off1, b_hi + off1);
  wgmma_m64n96k8_tf32<false>(acc, a_hi + off0, b_lo + off0);
  wgmma_m64n96k8_tf32<false>(acc, a_hi + off1, b_lo + off1);
  wgmma_m64n96k8_tf32<false>(acc, a_hi + off0, b_hi + off0);
  wgmma_m64n96k8_tf32<false>(acc, a_hi + off1, b_hi + off1);
  wgmma_commit();
}

// ------------------------------------------------------------------ top-2

struct Top2 {
  float best;
  int idx;
  float second;
};

// Strict comparisons, written as selects: a data-dependent branch per
// candidate costs this fold many times the arithmetic (measured: 92 clocks a
// candidate with branches).
__device__ __forceinline__ void push_top2(float d, int j, Top2& t) {
  const bool wins = d < t.best;
  t.second = wins ? t.best : fminf(t.second, d);
  t.idx = wins ? j : t.idx;
  t.best = wins ? d : t.best;
}

// folds another partial top-2 into t, ordered by (distance, index)
__device__ __forceinline__ void merge_top2(Top2& t, float c1, int j1, float c2) {
  if (c1 < t.best || (c1 == t.best && j1 < t.idx)) {
    t.second = fminf(t.best, c2);
    t.best = c1;
    t.idx = j1;
  } else {
    t.second = fminf(t.second, c1);
  }
}

__device__ __forceinline__ void merge_quad(Top2& t) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float c1 = __shfl_xor_sync(0xffffffffu, t.best, off);
    const int j1 = __shfl_xor_sync(0xffffffffu, t.idx, off);
    const float c2 = __shfl_xor_sync(0xffffffffu, t.second, off);
    merge_top2(t, c1, j1, c2);
  }
}

// ------------------------------------------------------------- main kernel

struct Params {
  const unsigned char* q_slabs;      // split query tiles
  const float* q_norms;
  const unsigned char* t_slabs;      // split train tiles
  const float* t_norms;
  int n, dim, kbs, chains, q_tiles, t_tiles, stages, resident;
  float* part_best;                  // [pairs, q_tiles, splits, kQueryRows] (splits > 1)
  int* part_idx;
  float* part_second;
  int* tickets;                      // [pairs, q_tiles], zeroed by split_sets
  int* best_idx;                     // [pairs, n]
  float* best_dist;
  float* second_dist;
  long long* clocks;                 // null or [blocks, 2, kParts]
};

// The copies of a block's sweep, issued by its first thread: slab g (train
// tile g / kbs, slab g % kbs, and the query tile's slab where it is
// streamed) into stage g % stages, once both consumer warpgroups have
// released the slab that stage held. A tile's train norms come with its last
// slab.
struct Loader {
  int next;           // the next slab to load
  int tile, kb;       // its train tile (in the split) and slab
  int st;             // its stage
  uint32_t phase;     // the phase of that stage's round
  int slabs;          // slabs of the sweep

  // loads slab `next` into its stage once the stage is free
  __device__ __forceinline__ bool load(const Params& p, uint32_t stage_s, int stage_bytes,
                                       uint32_t norm_s, uint32_t bars, uint32_t empty0,
                                       int t0, int q_tile, int pair) {
    if (next >= slabs) return false;
    mbar_wait(empty0 + 8 * st, phase ^ 1u);  // the first round passes at once
    const bool last = kb == p.kbs - 1;
    const uint32_t full = bars + 8 * st;
    const uint32_t dst = stage_s + st * stage_bytes;
    mbar_expect_tx(full, stage_bytes + (last ? kTNormBytes : 0));
    const long long t_tile = (long long)pair * p.t_tiles + t0 + tile;
    bulk_load(dst, p.t_slabs + (t_tile * p.kbs + kb) * kTSlabBytes, kTSlabBytes, full);
    if (!p.resident)
      bulk_load(dst + kTSlabBytes,
                p.q_slabs + (((long long)pair * p.q_tiles + q_tile) * p.kbs + kb) * kQSlabBytes,
                kQSlabBytes, full);
    if (last)
      bulk_load(norm_s + st * kTNormBytes, p.t_norms + t_tile * kTrainRows, kTNormBytes, full);
    ++next;
    if (++kb == p.kbs) kb = 0, ++tile;
    if (++st == p.stages) st = 0, phase ^= 1u;
    return true;
  }
};

// Clock counters of a warpgroup (see knn2_wgmma); every thread reads the
// clock, so that no branch on the thread parts a warpgroup near a wgmma.
template <bool Timed>
struct Clocks {
  long long part[kParts - 1] = {0, 0, 0, 0, 0, 0, 0};
  __device__ __forceinline__ long long now() const { return clock64(); }
  __device__ __forceinline__ void add(int i, long long since) { part[i] += clock64() - since; }
};
template <>
struct Clocks<false> {
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ void add(int, long long) {}
};
enum { kWaiting, kChains, kSums, kFold, kStart, kIssue, kRelease };

// The warpgroups' walk over the chains of a sweep: chain c of train tile t,
// in slab c / 2. Two chains are in flight, in two accumulators by turns:
// chain k + 2 is issued as soon as chain k has been consumed. Chains are
// issued and consumed in order, each position kept as (tile, chain).
template <bool Timed>
struct Walk {
  const Params& p;
  uint32_t stage_s, q_s, a_rows, bars, empty0;
  int stage_bytes, steps;
  int st_wait;        // the stage of the next slab to wait for
  uint32_t ph_wait;   // and its phase
  int st_free;        // the stage of the oldest slab not yet released
  int it, ic;         // the next chain to issue: tile, chain
  Clocks<Timed>& clk;

  // issues chain c of tile `tile` into acc; the first chain of a slab waits
  // for the slab. Past the sweep's end it issues the last chain again, unwaited,
  // its result unread: every step issues a chain, so that no accumulator is
  // written on one path and kept on another.
  __device__ __forceinline__ void issue_at(float (&acc)[kFrag], int tile, int c) {
    const bool real = tile < steps;
    if (!real) c = p.chains - 1;
    if (real && (c & 1) == 0) {
      const long long waited = clk.now();
      mbar_wait(bars + 8 * st_wait, ph_wait);
      clk.add(kWaiting, waited);
      if (++st_wait == p.stages) st_wait = 0, ph_wait ^= 1u;
    }
    const int st = st_wait == 0 ? p.stages - 1 : st_wait - 1;  // the slab's stage
    const uint32_t b = stage_s + st * stage_bytes;
    const uint32_t a = (p.resident ? q_s + (c >> 1) * kQSlabBytes : b + kTSlabBytes) + a_rows;
    const long long mark = clk.now();
    issue_chain(acc, smem_desc(a), smem_desc(a + kQHalfBytes), smem_desc(b),
                smem_desc(b + kTHalfBytes), c & 1);
    clk.add(kIssue, mark);
  }

  // issues the next chain in order (the walk's own count)
  __device__ __forceinline__ void issue(float (&acc)[kFrag]) {
    issue_at(acc, it, ic);
    if (++ic == p.chains) ic = 0, ++it;
  }

  // releases the oldest slab held
  __device__ __forceinline__ void release() {
    const long long mark = clk.now();
    mbar_arrive(empty0 + 8 * st_free);
    if (++st_free == p.stages) st_free = 0;
    clk.add(kRelease, mark);
  }
};

// 64 x 96 fragment of the distances into the running top-2s of the thread's
// two rows
__device__ __forceinline__ void fold_tile(const float (&dot)[kFrag], const float* tn, int col0,
                                          float qn0, float qn1, Top2& top0, Top2& top1) {
  // fragment: dot[4j + {0,1}] = row r0, columns 8j + 2 quad + {0,1}; dot[4j + {2,3}] = row r0 + 8
#pragma unroll
  for (int j = 0; j < kTrainRows / 8; ++j) {
    const float2 tj = *reinterpret_cast<const float2*>(tn + 8 * j);
    const int c = col0 + 8 * j;
    push_top2(fmaxf(qn0 + tj.x - 2.f * dot[4 * j + 0], 0.f), c, top0);
    push_top2(fmaxf(qn0 + tj.y - 2.f * dot[4 * j + 1], 0.f), c + 1, top0);
    push_top2(fmaxf(qn1 + tj.x - 2.f * dot[4 * j + 2], 0.f), c, top1);
    push_top2(fmaxf(qn1 + tj.y - 2.f * dot[4 * j + 3], 0.f), c + 1, top1);
  }
}

// Consumes chain c of tile t, in acc (the next chain runs in the other
// accumulator): waits for it, adds it into the tile's dot products, issues
// the chain after the next into acc, releases a slab whose chains have all
// retired and at a tile's end folds the tile while the next two chains run.
// Past the sweep's end (t >= steps) only the wait and the issue. Every
// condition is the same across a warpgroup.
template <bool Timed>
__device__ __forceinline__ void consume(Walk<Timed>& w, int t, int c, float (&acc)[kFrag],
                                        float (&dot)[kFrag], Top2& top0, Top2& top1,
                                        const float* norm_smem, int col0, float qn0, float qn1) {
  long long mark = w.clk.now();
  wgmma_wait<1>();
  fence_fragment(acc);
  w.clk.add(kChains, mark);
  mark = w.clk.now();
  // a select, not a branch: dot is written on every path alike
  const bool first = c == 0;
#pragma unroll
  for (int e = 0; e < kFrag; ++e) dot[e] = (first ? 0.f : dot[e]) + acc[e];
  w.clk.add(kSums, mark);
  w.issue(acc);  // acc is free again
  if (t >= w.steps) return;
  if (c == w.p.chains - 1) {
    mark = w.clk.now();
    fold_tile(dot, norm_smem + w.st_free * kTrainRows, col0 + t * kTrainRows, qn0, qn1, top0,
              top1);
    w.clk.add(kFold, mark);
    w.release();  // the tile's last slab, with its norms
  } else if (c & 1) {
    w.release();  // both chains of the slab have retired
  }
}

// The same step for a chain count C known when compiling (C even): chain j
// of tile t, in acc0 for even j and acc1 for odd j, every position and
// condition fixed by j, the tile's chains unrolled.
template <int C, bool Timed>
__device__ __forceinline__ void step(Walk<Timed>& w, int t, int j, float (&acc)[kFrag],
                                     float (&dot)[kFrag], Top2& top0, Top2& top1,
                                     const float* norm_smem, int col0, float qn0, float qn1) {
  long long mark = w.clk.now();
  wgmma_wait<1>();
  fence_fragment(acc);
  w.clk.add(kChains, mark);
  mark = w.clk.now();
  if (j == 0) {
#pragma unroll
    for (int e = 0; e < kFrag; ++e) dot[e] = acc[e];
  } else {
#pragma unroll
    for (int e = 0; e < kFrag; ++e) dot[e] += acc[e];
  }
  w.clk.add(kSums, mark);
  w.issue_at(acc, t + (j + 2) / C, (j + 2) % C);  // acc is free again
  if (j == C - 1) {
    mark = w.clk.now();
    fold_tile(dot, norm_smem + w.st_free * kTrainRows, col0 + t * kTrainRows, qn0, qn1, top0,
              top1);
    w.clk.add(kFold, mark);
    w.release();  // the tile's last slab, with its norms
  } else if (j & 1) {
    w.release();  // both chains of the slab have retired
  }
}

// grid (splits, query tiles, pairs); block kThreads: warpgroup 0 loads,
// warpgroups 1 and 2 consume. Timed, the first thread of each consumer
// warpgroup writes its clock counts to `clocks` [block, warpgroup, {waiting
// for slabs (the query tile's too), waiting for chains, chain sums, top-2
// fold, start (to the first wait), issuing chains, releasing slabs, whole
// kernel}] (there is no profiler for what happens inside a block).
template <int C, bool Timed>
__global__ void __launch_bounds__(kThreads, 1) knn2_wgmma(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int stage_bytes = p.resident ? kTSlabBytes : kTSlabBytes + kQSlabBytes;
  const int q_bytes = p.resident ? p.kbs * kQSlabBytes : 0;
  const int norm_off = q_bytes + p.stages * stage_bytes;
  const uint32_t q_s = base;
  const uint32_t stage_s = base + q_bytes;
  const uint32_t norm_s = base + norm_off;
  const uint32_t bars = norm_s + p.stages * kTNormBytes;  // full[i] at 8 i, empty[i] at 8 (stages + i)
  const uint32_t empty0 = bars + 8 * p.stages;
  int* flag = reinterpret_cast<int*>(smem + norm_off + p.stages * kTNormBytes + 16 * kMaxStages);
  const uint32_t q_bar = smem_u32(flag) + 8;  // the resident query tile's copy
  const float* norm_smem = reinterpret_cast<const float*>(smem + norm_off);

  const int split = blockIdx.x, splits = gridDim.x;
  const int q_tile = blockIdx.y;
  const int pair = blockIdx.z;
  const int t0 = (int)((long long)split * p.t_tiles / splits);
  const int t1 = (int)((long long)(split + 1) * p.t_tiles / splits);
  const int steps = t1 - t0;
  const long long begun = clock64();

  if (threadIdx.x == 0) {
    if (base & 1023u) __trap();  // the swizzle atoms need 1024-byte alignment
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bars + 8 * i, 1);                      // full: the loader's expect_tx
      mbar_init(empty0 + 8 * i, kConsumerThreads);     // empty: both consumer warpgroups
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warpgroup 0: its first thread issues every copy of the sweep, waiting for
  // each stage; the warpgroup gives its registers to the others. A branch on
  // lane 0's value, which the compiler knows is the same on the warp.
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kLoaderRegs));
    if (threadIdx.x == 0) {
      if (p.resident) {  // the query tile's slabs, once
        mbar_expect_tx(q_bar, p.kbs * kQSlabBytes);
        bulk_load(q_s, p.q_slabs + ((long long)pair * p.q_tiles + q_tile) * p.kbs * kQSlabBytes,
                  p.kbs * kQSlabBytes, q_bar);
      }
      Loader loader{0, 0, 0, 0, 0u, steps * p.kbs};
      while (loader.load(p, stage_s, stage_bytes, norm_s, bars, empty0, t0, q_tile, pair)) {
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // ---- consumer warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile
  const int tid = threadIdx.x - 128;
  // warpgroup-uniform to the compiler (lane 0's value): a branch on it parts no warpgroup
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = tid >> 5;            // 0..7: rows [16 warp, 16 warp + 16) of the tile
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's fragment rows: r0, r0 + 8
  Clocks<Timed> clk;
  Walk<Timed> w{p, stage_s, q_s, (uint32_t)(wg * kWgRows * 128), bars, empty0,
                stage_bytes, steps, 0, 0u, 0, 0, 0, clk};

  const float* qn = p.q_norms + ((long long)pair * p.q_tiles + q_tile) * kQueryRows;
  const float qn0 = qn[r0], qn1 = qn[r0 + 8];
  if (p.resident) {
    const long long waited = clk.now();
    mbar_wait(q_bar, 0);  // the query tile's slabs, copied once
    clk.add(kWaiting, waited);
  }
  clk.add(kStart, begun);

  Top2 top0{CUDART_INF_F, INT_MAX, CUDART_INF_F};
  Top2 top1{CUDART_INF_F, INT_MAX, CUDART_INF_F};
  float acc0[kFrag], acc1[kFrag], dot[kFrag];
#pragma unroll
  for (int e = 0; e < kFrag; ++e) dot[e] = 0.f;
  const int col0 = t0 * kTrainRows + 2 * quad;
  const float* tn = norm_smem + 2 * quad;
  if constexpr (C > 0) {
    w.issue_at(acc0, 0, 0);
    w.issue_at(acc1, 1 / C, 1 % C);
    for (int t = 0; t < steps; ++t) {
#pragma unroll
      for (int j = 0; j < C; j += 2) {
        step<C>(w, t, j, acc0, dot, top0, top1, tn, col0, qn0, qn1);
        step<C>(w, t, j + 1, acc1, dot, top0, top1, tn, col0, qn0, qn1);
      }
    }
  } else {
    w.issue(acc0);
    w.issue(acc1);
    const int total = steps * p.chains;
    for (int k = 0, t = 0, c = 0; k < total; k += 2) {
      consume(w, t, c, acc0, dot, top0, top1, tn, col0, qn0, qn1);
      if (++c == p.chains) c = 0, ++t;
      consume(w, t, c, acc1, dot, top0, top1, tn, col0, qn0, qn1);
      if (++c == p.chains) c = 0, ++t;
    }
  }
  wgmma_wait<0>();  // the two chains issued past the end
  fence_fragment(acc0);
  fence_fragment(acc1);

  merge_quad(top0);
  merge_quad(top1);
  const int row = q_tile * kQueryRows + r0;  // this thread's rows: row, row + 8
  const long long out = (long long)pair * p.n;
  if (splits == 1) {
    if (quad == 0) {
      if (row < p.n) {
        p.best_idx[out + row] = top0.idx;
        p.best_dist[out + row] = top0.best;
        p.second_dist[out + row] = top0.second;
      }
      if (row + 8 < p.n) {
        p.best_idx[out + row + 8] = top1.idx;
        p.best_dist[out + row + 8] = top1.best;
        p.second_dist[out + row + 8] = top1.second;
      }
    }
  } else {
    const long long tile_parts = ((long long)pair * p.q_tiles + q_tile) * splits;
    if (quad == 0) {
      const long long o = (tile_parts + split) * kQueryRows + r0;
      p.part_best[o] = top0.best;
      p.part_idx[o] = top0.idx;
      p.part_second[o] = top0.second;
      p.part_best[o + 8] = top1.best;
      p.part_idx[o + 8] = top1.idx;
      p.part_second[o + 8] = top1.second;
    }
    __threadfence();  // the partials before the ticket, for the last block
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (tid == 0)
      *flag = atomicAdd(p.tickets + (long long)pair * p.q_tiles + q_tile, 1) == splits - 1;
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (*flag && tid < kQueryRows) {
      // the last block folds every split's partial in split order
      __threadfence();
      const int r = q_tile * kQueryRows + tid;
      if (r < p.n) {
        const long long o = tile_parts * kQueryRows + tid;
        Top2 t{__ldcg(p.part_best + o), __ldcg(p.part_idx + o), __ldcg(p.part_second + o)};
        for (int s = 1; s < splits; ++s) {
          const long long os = o + (long long)s * kQueryRows;
          merge_top2(t, __ldcg(p.part_best + os), __ldcg(p.part_idx + os),
                     __ldcg(p.part_second + os));
        }
        p.best_idx[out + r] = t.idx;
        p.best_dist[out + r] = t.best;
        p.second_dist[out + r] = t.second;
      }
    }
  }
  if constexpr (Timed) {
    if ((tid & 127) == 0) {
      const long long block = ((long long)pair * p.q_tiles + q_tile) * splits + split;
      long long* c = p.clocks + (block * 2 + wg) * kParts;
      for (int i = 0; i < kParts - 1; ++i) c[i] = clk.part[i];
      c[kParts - 1] = clock64() - begun;
    }
  }
}

// byte offsets of the parts of the scratch, each 256-byte aligned
struct Scratch {
  long long tickets, t_slabs, t_norms, q_slabs, q_norms, parts, total;
};

Scratch scratch_layout(int pairs, int n, int m, int dim, int splits) {
  const Geometry g = geometry(dim);
  const long long q_tiles = (n + kQueryRows - 1) / kQueryRows;
  const long long t_tiles = (m + kTrainRows - 1) / kTrainRows;
  auto up = [](long long x) { return (x + 255) / 256 * 256; };
  Scratch s;
  s.tickets = 0;
  s.t_slabs = up(pairs * q_tiles * 4);
  s.t_norms = s.t_slabs + pairs * t_tiles * g.kbs * (long long)kTSlabBytes;
  s.q_slabs = up(s.t_norms + pairs * t_tiles * kTNormBytes);
  s.q_norms = s.q_slabs + pairs * q_tiles * g.kbs * (long long)kQSlabBytes;
  s.parts = up(s.q_norms + pairs * q_tiles * kQueryRows * 4);
  s.total = s.parts + (splits > 1 ? 3 * pairs * q_tiles * splits * kQueryRows * 4LL : 0);
  return s;
}

bool sizes_ok(int pairs, int n, int m, int dim, int splits) {
  const long long t_tiles = (m + (long long)kTrainRows - 1) / kTrainRows;
  return pairs >= 1 && pairs <= 65535 && n >= 1 && m >= 2 && dim >= 1 && splits >= 1 &&
         splits <= t_tiles && (n + (long long)kQueryRows - 1) / kQueryRows <= 65535;
}

// the chain counts with an instance of their own (even, up to D = 256); every
// other count runs the instance that reads it at run time (C = 0)
template <int... Cs>
struct ChainList {};
using Chains = ChainList<0, 2, 4, 6, 8, 10, 12, 14, 16>;
constexpr int kStaticChains = 16;

template <int... Cs>
cudaError_t set_smem_limit(ChainList<Cs...>) {
  cudaError_t err = cudaSuccess;
  auto one = [&](auto f) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  };
  (one(knn2_wgmma<Cs, false>), ...);
  (one(knn2_wgmma<Cs, true>), ...);
  return err;
}

template <int... Cs>
void launch_sweep(ChainList<Cs...>, int chains, bool timed, dim3 grid, int smem, cudaStream_t s,
                  const Params& p) {
  const int pick = chains % 2 == 0 && chains <= kStaticChains ? chains : 0;
  auto one = [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (C != pick) return;
    if (timed)
      knn2_wgmma<C, true><<<grid, kThreads, smem, s>>>(p);
    else
      knn2_wgmma<C, false><<<grid, kThreads, smem, s>>>(p);
  };
  (one(std::integral_constant<int, Cs>{}), ...);
}

}  // namespace

// Bytes of scratch mv_knn2_wgmma_f32 needs for these sizes, or -1 for sizes
// it does not take.
extern "C" long long mv_knn2_wgmma_scratch_bytes(int pairs, int n, int m, int dim, int splits) {
  if (!sizes_ok(pairs, n, m, dim, splits)) return -1;
  return scratch_layout(pairs, n, m, dim, splits).total;
}

// query [pairs, n, dim], train [pairs, m, dim] float32 contiguous on the
// device, any dim >= 1; scratch of mv_knn2_wgmma_scratch_bytes bytes (256-byte
// aligned); 1 <= splits <= ceil(m / 128); outputs [pairs, n]; clocks is null
// or int64 [pairs * ceil(n / 128) * splits, 2, 6] (see knn2_wgmma). Two
// launches on `stream`; does not synchronise; returns the first CUDA error
// of its launches (0 for none).
extern "C" int mv_knn2_wgmma_f32(const float* query, const float* train, void* scratch,
                                 int pairs, int n, int m, int dim, int splits, int* best_idx,
                                 float* best_dist, float* second_dist, long long* clocks,
                                 void* stream) {
  if (!sizes_ok(pairs, n, m, dim, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attribute_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attribute_set[device]) {  // once a device: the largest any width needs
    err = set_smem_limit(Chains{});
    if (err != cudaSuccess) return (int)err;
    attribute_set[device] = true;
  }
  const Geometry g = geometry(dim);
  // four stages at least: a warpgroup may hold a tile's last slab (its norms)
  // and wait for the next two while the loader refills the fourth
  if (g.stages < 4) return (int)cudaErrorInvalidValue;
  const Scratch lay = scratch_layout(pairs, n, m, dim, splits);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  const int q_tiles = (n + kQueryRows - 1) / kQueryRows;
  const int t_tiles = (m + kTrainRows - 1) / kTrainRows;
  const int n_tickets = pairs * q_tiles;

  SetArgs tr{train, base + lay.t_slabs, reinterpret_cast<float*>(base + lay.t_norms), m,
             t_tiles, kTrainRows, (long long)pairs * t_tiles * kTrainRows};
  SetArgs qu{query, base + lay.q_slabs, reinterpret_cast<float*>(base + lay.q_norms), n,
             q_tiles, kQueryRows, (long long)pairs * q_tiles * kQueryRows};
  const int warps_a_block = 8;
  const long long rows = tr.padded_rows + qu.padded_rows;
  split_sets<<<(unsigned)((rows + warps_a_block - 1) / warps_a_block), 32 * warps_a_block, 0,
               s>>>(tr, qu, dim, g.kbs, reinterpret_cast<int*>(base + lay.tickets), n_tickets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.q_slabs = base + lay.q_slabs;
  p.q_norms = reinterpret_cast<const float*>(base + lay.q_norms);
  p.t_slabs = base + lay.t_slabs;
  p.t_norms = reinterpret_cast<const float*>(base + lay.t_norms);
  p.n = n;
  p.dim = dim;
  p.kbs = g.kbs;
  p.chains = g.chains;
  p.q_tiles = q_tiles;
  p.t_tiles = t_tiles;
  p.stages = g.stages;
  p.resident = g.resident;
  const long long part = (long long)n_tickets * splits * kQueryRows;
  p.part_best = reinterpret_cast<float*>(base + lay.parts);
  p.part_idx = reinterpret_cast<int*>(base + lay.parts) + part;
  p.part_second = reinterpret_cast<float*>(base + lay.parts) + 2 * part;
  p.tickets = reinterpret_cast<int*>(base + lay.tickets);
  p.best_idx = best_idx;
  p.best_dist = best_dist;
  p.second_dist = second_dist;
  p.clocks = clocks;
  launch_sweep(Chains{}, g.chains, clocks != nullptr, dim3(splits, q_tiles, pairs),
               g.smem_bytes, s, p);
  return (int)cudaGetLastError();
}
