// Fused squared-L2 distance + running top-2 for descriptor matching on the
// tensor cores of Hopper (sm_90a): split-TF32 wgmma, asynchronous tile loads.
//
// Replaces the TPU kernel multiview_tpu/sfm/matching.py::matched_pairs_pallas
// (pl.pallas_call at matching.py:186), for descriptor widths 64 and 128. The
// first port of that kernel, csrc/knn2.cu (FP32 FMA on the CUDA cores), stays
// for every other width and as the FP32 oracle on the card.
//
// What bounds it on the H100. A pair costs 2*N*M*D FLOP against
// (N + M)*D*4 + 12*N bytes: about 1000 FLOP per byte, so operations bound it,
// not memory.
//
//   shape (pairs x N x M x D)   FLOP     bytes    TF32 tensor cores   FP32 CUDA cores   memory
//                                                 (495 TFLOP/s)       (67 TFLOP/s)      (3.35 TB/s)
//   8 x 4096 x 4096 x 128       34.4 G   33.9 MB  0.069 ms            0.513 ms          0.010 ms
//   1 x 10000 x 10000 x 128     25.6 G   10.4 MB  0.052 ms            0.382 ms          0.003 ms
//
// The FMA kernel can at best reach the CUDA-core column. This one moves the
// products to the tensor cores and keeps FP32 accuracy by computing each dot
// product three times over (3xTF32), so its own floor is three times the
// tensor-core column.
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
//   zero and the chains are added on the CUDA cores, rounding to nearest
//   (mean error then 7e-8, the largest below the FMA kernel's). Row norms are
//   exact FP32 sums of the unsplit rows (same summation order as
//   csrc/knn2.cu) and the distance stays max(|q|^2 + |t|^2 - 2 q.t, 0).
// * Pre-pass (split_rows): one warp per row computes the norm and writes hi
//   and lo directly as the shared-memory image of a 64-row tile, in the
//   K-major, 128-byte-swizzled order that wgmma reads, followed by the tile's
//   64 norms. Rows past the end of the set are zero with norm +inf, so their
//   distance is +inf and they never win: ragged edges need no pad rows in the
//   data and no test in the inner loop.
// * Main kernel: a block owns one 64-row query tile for a whole sweep over
//   the train tiles [t0, t1) of its split. One producer thread keeps train
//   tile images in flight with cp.async.bulk (one linear copy lands a tile in
//   place; completion on an mbarrier) into a ring of stages; the query tile is
//   loaded once. Two consumer warpgroups take alternate train tiles: each
//   issues the wgmma chains (m64n64k8, both operands K-major from shared
//   memory, FP32 accumulators in registers, two chains in flight), releases
//   the stage as soon as the last chain has retired, and folds its fragment
//   into a running (best, index, second) per row in registers while the other
//   warpgroup's chains run. Columns reach a thread in increasing index and the
//   comparisons are strict, so ties keep the lowest index and an exact
//   duplicate gives second == best. At the end of the sweep the four threads
//   of a quad, then the two warpgroups, merge ordered by (distance, index).
// * Filling the card at one pair: the sweep is split over `splits` blocks per
//   query tile (chosen by the caller from the block count and the SM count);
//   each writes a partial top-2 and merge_splits folds them per row by
//   (distance, index).
//
// Nothing here allocates or synchronises: the caller provides the scratch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kTileRows = 64;          // rows of a query or train tile
constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // + the producer's warp
constexpr int kNormBytes = kTileRows * 4;
constexpr long long kSpinLimit = 4000000000LL;  // clocks before a stuck wait traps

template <int D>
struct Geometry {
  static_assert(D % 32 == 0, "a k-block is 32 floats (one 128-byte swizzle row)");
  static constexpr int kBlocksK = D / 32;
  // k-steps (8 dimensions each) that the tensor cores sum before the result
  // moves to the CUDA cores; see "Exactness" in the head note
  static constexpr int kChainSteps = 2;
  static constexpr int kChains = D / 8 / kChainSteps;
  static constexpr int kHalfBytes = kTileRows * D * 4;       // hi (or lo) of a tile
  static constexpr int kTileBytes = 2 * kHalfBytes;          // hi + lo
  static constexpr int kImageBytes = kTileBytes + kNormBytes;  // + norms
  static constexpr int kStageStride = (kImageBytes + 1023) / 1024 * 1024;
  static constexpr int kStages = D >= 128 ? 2 : 4;
  static constexpr int kBarrierBytes = 128;                  // 2*kStages + 1 mbarriers
  static constexpr int kMergeBytes = 1024;                   // 64 rows x (float, int, float)
  static constexpr int kSmemBytes =
      kTileBytes + kStages * kStageStride + kBarrierBytes + kMergeBytes + 1024;
};

// ---------------------------------------------------------------- pre-pass

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xffffe000u);
}

// One warp per padded row of x [sets, rows, D]: writes the tile images
// [sets, tiles, {hi, lo}[D/32][64][32 swizzled], norms[64]].
template <int D>
__global__ void split_rows(const float* __restrict__ x, unsigned char* __restrict__ images,
                           int rows, int tiles, long long padded_rows_total) {
  using G = Geometry<D>;
  const long long prow = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (prow >= padded_rows_total) return;  // uniform per warp
  const long long tile = prow / kTileRows;  // over all sets
  const int r = (int)(prow % kTileRows);
  const long long set = tile / tiles;
  const int row = (int)(tile % tiles) * kTileRows + r;
  const bool live = row < rows;
  const float* src = x + (set * rows + (live ? row : 0)) * D;
  unsigned char* image = images + tile * G::kImageBytes;
  float* hi = reinterpret_cast<float*>(image);
  float* lo = reinterpret_cast<float*>(image + G::kHalfBytes);
  const int swz = (((lane >> 2) ^ (r & 7)) << 2) | (lane & 3);
  float s = 0.f;
#pragma unroll
  for (int kb = 0; kb < G::kBlocksK; ++kb) {
    const float v = live ? src[kb * 32 + lane] : 0.f;
    s = fmaf(v, v, s);
    const float h = tf32_round(v);
    const int o = (kb * kTileRows + r) * 32 + swz;
    hi[o] = h;
    lo[o] = tf32_round(v - h);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0)
    reinterpret_cast<float*>(image + G::kTileBytes)[r] = live ? s : CUDART_INF_F;
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

// Waits until the barrier's phase differs from `parity`. A wait that does not
// end (a lost copy, a wrong byte count) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kSpinLimit) __trap();
  } while (!done);
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

// acc (64x64 FP32 fragment) = A(64x8) . B(64x8)^T + (scale_d ? acc : 0)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
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
__device__ __forceinline__ void fence_fragment(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One chain: `Steps` k-steps (8 floats each) of the three split products,
// small terms first, summed by the tensor cores into `acc` (overwritten), and
// committed as one group. Chain c covers k-steps [c Steps, (c + 1) Steps); a
// k-block of 4 k-steps is 64 rows x 128 bytes, a k-step 32 bytes inside the row.
template <int Steps>
__device__ __forceinline__ void issue_chain(float (&acc)[32], uint64_t q_hi, uint64_t q_lo,
                                            uint64_t t_hi, uint64_t t_lo, int c) {
  fence_fragment(acc);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint64_t da = pass == 0 ? q_lo : q_hi;
    const uint64_t db = pass == 1 ? t_lo : t_hi;
#pragma unroll
    for (int k = 0; k < Steps; ++k) {
      const int step = c * Steps + k;
      const uint64_t off = (uint64_t)(((step >> 2) * kTileRows * 128 + (step & 3) * 32) >> 4);
      wgmma_m64n64k8_tf32(acc, da + off, db + off, (pass | k) != 0);
    }
  }
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

// grid (splits, query tiles, pairs); block kThreads. Partials are
// [pairs, splits, n]. With `clocks` not null, the first thread of each consumer
// warpgroup also writes its clock counts [block, warpgroup, {waiting for a
// tile, wgmma chains, top-2 fold, whole sweep}] (there is no profiler for
// what happens inside a block).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
knn2_wgmma(const unsigned char* __restrict__ q_images, const unsigned char* __restrict__ t_images,
           int n, int q_tiles, int t_tiles, float* __restrict__ part_best,
           int* __restrict__ part_idx, float* __restrict__ part_second,
           long long* __restrict__ clocks) {
  using G = Geometry<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t stage_s = base + G::kTileBytes;
  const uint32_t bars = stage_s + G::kStages * G::kStageStride;
  const uint32_t q_bar = bars + 16 * G::kStages;
  // full[i] at bars + 8 i, empty[i] at bars + 8 (kStages + i)
  Top2* merge_s = reinterpret_cast<Top2*>(smem + G::kTileBytes + G::kStages * G::kStageStride +
                                          G::kBarrierBytes);

  const int split = blockIdx.x, splits = gridDim.x;
  const int q_tile = blockIdx.y;
  const int pair = blockIdx.z;
  const int t0 = (int)((long long)split * t_tiles / splits);
  const int t1 = (int)((long long)(split + 1) * t_tiles / splits);
  const int steps = t1 - t0;
  const unsigned char* q_image = q_images + ((size_t)pair * q_tiles + q_tile) * G::kImageBytes;
  const unsigned char* t_image = t_images + ((size_t)pair * t_tiles + t0) * G::kImageBytes;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::kStages; ++i) {
      mbar_init(bars + 8 * i, 1);                    // full: the producer's expect_tx
      mbar_init(bars + 8 * (G::kStages + i), 128);   // empty: one consumer warpgroup
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_bar, G::kTileBytes);
      bulk_load(q_s, q_image, G::kTileBytes, q_bar);
      for (int i = 0; i < steps; ++i) {
        const int st = i % G::kStages;
        const uint32_t round = (uint32_t)(i / G::kStages) & 1u;
        mbar_wait(bars + 8 * (G::kStages + st), round ^ 1u);  // first round passes at once
        mbar_expect_tx(bars + 8 * st, G::kImageBytes);
        bulk_load(stage_s + st * G::kStageStride, t_image + (size_t)i * G::kImageBytes,
                  G::kImageBytes, bars + 8 * st);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes steps wg, wg + 2, ...
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int warp_in_wg = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  const int r0 = 16 * warp_in_wg + (lane >> 2);  // this thread's fragment rows: r0, r0 + 8
  const float* q_norm = reinterpret_cast<const float*>(q_image + G::kTileBytes);
  const float qn0 = q_norm[r0];
  const float qn1 = q_norm[r0 + 8];
  Top2 top0{CUDART_INF_F, INT_MAX, CUDART_INF_F};
  Top2 top1{CUDART_INF_F, INT_MAX, CUDART_INF_F};
  float acc[2][32];  // two chains in flight, by turns
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;

  const bool timed = clocks != nullptr && (threadIdx.x & 127) == 0;
  long long waited = 0, multiplied = 0, folded = 0, mark = 0;
  const long long begun = timed ? clock64() : 0;
  mbar_wait(q_bar, 0);
  const uint64_t q_hi = smem_desc(q_s);
  const uint64_t q_lo = smem_desc(q_s + G::kHalfBytes);

  for (int i = wg; i < steps; i += 2) {
    const int st = i % G::kStages;
    const uint32_t round = (uint32_t)(i / G::kStages) & 1u;
    if (timed) mark = clock64();
    mbar_wait(bars + 8 * st, round);
    if (timed) waited += clock64() - mark, mark = clock64();
    const uint32_t tile_s = stage_s + st * G::kStageStride;
    const float2* t_norm = reinterpret_cast<const float2*>(
        smem + G::kTileBytes + st * G::kStageStride + G::kTileBytes);
    float2 tn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) tn[j] = t_norm[4 * j + quad];

    const uint64_t t_hi = smem_desc(tile_s);
    const uint64_t t_lo = smem_desc(tile_s + G::kHalfBytes);
    float dot[32];
    issue_chain<G::kChainSteps>(acc[0], q_hi, q_lo, t_hi, t_lo, 0);
#pragma unroll
    for (int c = 0; c < G::kChains; ++c) {
      if (c + 1 < G::kChains) {
        issue_chain<G::kChainSteps>(acc[(c + 1) & 1], q_hi, q_lo, t_hi, t_lo, c + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_fragment(acc[c & 1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) dot[e] = c == 0 ? acc[0][e] : dot[e] + acc[c & 1][e];
    }
    mbar_arrive(bars + 8 * (G::kStages + st));  // the stage may be refilled
    if (timed) multiplied += clock64() - mark, mark = clock64();

    // fragment: dot[4j + {0,1}] = row r0, columns 8j + 2 quad + {0,1}; dot[4j + {2,3}] = row r0 + 8
    const int col0 = (t0 + i) * kTileRows + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + 8 * j;
      push_top2(fmaxf(qn0 + tn[j].x - 2.f * dot[4 * j + 0], 0.f), c, top0);
      push_top2(fmaxf(qn0 + tn[j].y - 2.f * dot[4 * j + 1], 0.f), c + 1, top0);
      push_top2(fmaxf(qn1 + tn[j].x - 2.f * dot[4 * j + 2], 0.f), c, top1);
      push_top2(fmaxf(qn1 + tn[j].y - 2.f * dot[4 * j + 3], 0.f), c + 1, top1);
    }
    if (timed) folded += clock64() - mark;
  }
  if (timed) {
    const size_t block = ((size_t)pair * q_tiles + q_tile) * splits + split;
    long long* out = clocks + (block * 2 + wg) * 4;
    out[0] = waited;
    out[1] = multiplied;
    out[2] = folded;
    out[3] = clock64() - begun;
  }

  merge_quad(top0);
  merge_quad(top1);
  if (wg == 1 && quad == 0) {
    merge_s[r0] = top0;
    merge_s[r0 + 8] = top1;
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");  // the consumers only
  if (wg == 0 && quad == 0) {
    const Top2 o0 = merge_s[r0];
    const Top2 o1 = merge_s[r0 + 8];
    merge_top2(top0, o0.best, o0.idx, o0.second);
    merge_top2(top1, o1.best, o1.idx, o1.second);
    const size_t out = ((size_t)pair * splits + split) * n;
    const int row0 = q_tile * kTileRows + r0;
    if (row0 < n) {
      part_best[out + row0] = top0.best;
      part_idx[out + row0] = top0.idx;
      part_second[out + row0] = top0.second;
    }
    if (row0 + 8 < n) {
      part_best[out + row0 + 8] = top1.best;
      part_idx[out + row0 + 8] = top1.idx;
      part_second[out + row0 + 8] = top1.second;
    }
  }
}

// One thread per query row: folds the `splits` partial top-2s.
__global__ void merge_splits(const float* __restrict__ part_best, const int* __restrict__ part_idx,
                             const float* __restrict__ part_second, int pairs, int splits, int n,
                             int* __restrict__ best_idx, float* __restrict__ best_dist,
                             float* __restrict__ second_dist) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)pairs * n) return;
  const long long pair = e / n;
  const int row = (int)(e % n);
  const size_t first = (size_t)pair * splits * n + row;
  Top2 t{part_best[first], part_idx[first], part_second[first]};
  for (int s = 1; s < splits; ++s) {
    const size_t o = first + (size_t)s * n;
    merge_top2(t, part_best[o], part_idx[o], part_second[o]);
  }
  best_idx[e] = t.idx;
  best_dist[e] = t.best;
  second_dist[e] = t.second;
}

template <int D>
cudaError_t launch(const float* query, const float* train, unsigned char* q_images,
                   unsigned char* t_images, int pairs, int n, int m, int splits,
                   float* part_best, int* part_idx, float* part_second, int* best_idx,
                   float* best_dist, float* second_dist, long long* clocks, cudaStream_t s) {
  using G = Geometry<D>;
  const int q_tiles = (n + kTileRows - 1) / kTileRows;
  const int t_tiles = (m + kTileRows - 1) / kTileRows;
  if (splits < 1 || splits > t_tiles) return cudaErrorInvalidValue;
  const int rows_per_block = 8;  // warps of a split_rows block
  const long long q_rows = (long long)pairs * q_tiles * kTileRows;
  const long long t_rows = (long long)pairs * t_tiles * kTileRows;
  split_rows<D><<<(unsigned)((q_rows + rows_per_block - 1) / rows_per_block),
                  32 * rows_per_block, 0, s>>>(query, q_images, n, q_tiles, q_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_rows<D><<<(unsigned)((t_rows + rows_per_block - 1) / rows_per_block),
                  32 * rows_per_block, 0, s>>>(train, t_images, m, t_tiles, t_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(knn2_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, q_tiles, pairs);
  knn2_wgmma<D><<<grid, kThreads, G::kSmemBytes, s>>>(q_images, t_images, n, q_tiles, t_tiles,
                                                      part_best, part_idx, part_second, clocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long out_rows = (long long)pairs * n;
  merge_splits<<<(unsigned)((out_rows + 255) / 256), 256, 0, s>>>(
      part_best, part_idx, part_second, pairs, splits, n, best_idx, best_dist, second_dist);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the image of one 64-row tile (hi, lo, norms) at width `dim`, or 0
// for a width this kernel does not take. The scratch of a set of `rows` rows
// is pairs * ceil(rows / 64) images.
extern "C" int mv_knn2_wgmma_image_bytes(int dim) {
  if (dim == 128) return Geometry<128>::kImageBytes;
  if (dim == 64) return Geometry<64>::kImageBytes;
  return 0;
}

// query [pairs, n, dim], train [pairs, m, dim] float32 contiguous on the
// device, dim 64 or 128. q_images and t_images are scratch of
// pairs * ceil(n / 64) and pairs * ceil(m / 64) tile images; part_* are scratch
// [pairs, splits, n] with 1 <= splits <= ceil(m / 64); outputs [pairs, n];
// clocks is null or int64 [pairs * ceil(n / 64) * splits, 2, 4] (see knn2_wgmma).
// Launches on `stream`, does not synchronise, and returns the first CUDA error
// of its launches (0 for none).
extern "C" int mv_knn2_wgmma_f32(const float* query, const float* train, void* q_images,
                                 void* t_images, int pairs, int n, int m, int dim, int splits,
                                 float* part_best, int* part_idx, float* part_second,
                                 int* best_idx, float* best_dist, float* second_dist,
                                 long long* clocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* qi = static_cast<unsigned char*>(q_images);
  unsigned char* ti = static_cast<unsigned char*>(t_images);
  if (dim == 128)
    return (int)launch<128>(query, train, qi, ti, pairs, n, m, splits, part_best, part_idx,
                            part_second, best_idx, best_dist, second_dist, clocks, s);
  if (dim == 64)
    return (int)launch<64>(query, train, qi, ti, pairs, n, m, splits, part_best, part_idx,
                           part_second, best_idx, best_dist, second_dist, clocks, s);
  return (int)cudaErrorInvalidValue;
}
