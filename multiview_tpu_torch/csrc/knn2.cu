// Fused squared-L2 distance + running top-2 for descriptor matching on
// Hopper (sm_90a).
//
// Replaces the TPU kernel multiview_tpu/sfm/matching.py::matched_pairs_pallas
// (pl.pallas_call at matching.py:186). For every query row of every image pair
// it computes the squared L2 distance max(|q|^2 + |t|^2 - 2 q.t, 0) to every
// train row (the formula of matching.py::knn2, norms computed once per row) and
// reduces it on the fly to (best index, best distance, second-best distance).
// The [N, M] distance matrix never reaches device memory.
//
// What bounds it on the H100: a pair costs about 2*N*M*D FLOP against
// (N + M)*D*4 bytes read. At the main path's K = N = M = 4096, D = 128 that is
// 4.3 GFLOP over 4 MB, about 1000 FLOP per byte, far above the card's ratio of
// FP32 CUDA-core FLOP/s to memory bandwidth (about 20): the kernel is compute
// bound. This first version runs plain FP32 FMA on the CUDA cores (no tensor
// cores: TF32 keeps about three decimal digits and flips near-ties in the
// 0.8 ratio test). Each 256-thread block owns a 64-query x 64-train output
// tile per step and each thread a 4x4 register tile; 32-dim slices of the
// query and train rows are staged through shared memory, transposed and
// padded so the inner loop reads without bank conflicts. The running top-2
// of each (thread, query) lives in registers over the whole train sweep, and
// the 16 partial results of a query are merged through shared memory at the
// end. Ragged edges (N, M not multiples of 64, D not a multiple of 32) are
// masked in the kernel. The wgmma/TMA version comes in a later PR.
//
// Ties keep the lowest train index (as argmin / top_k and the Pallas merge
// do); an exact duplicate gives second_dist == best_dist.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;                   // query rows per block
constexpr int kTileM = 64;                   // train rows per step
constexpr int kTileK = 32;                   // descriptor dims per smem slice
constexpr int kLanesM = 16;                  // threads sharing one query row
constexpr int kLanesQ = kThreads / kLanesM;  // 16
constexpr int kRowsQ = kTileQ / kLanesQ;     // 4 query rows per thread
constexpr int kColsM = kTileM / kLanesM;     // 4 train rows per thread
static_assert(kTileQ == kTileM, "the tile loader fills both tiles in one loop");
static_assert((kTileQ * kTileK) % kThreads == 0, "tile load must divide evenly");

// One warp per row: out[r] = sum_d x[r, d]^2.
__global__ void row_sq_norms(const float* __restrict__ x, float* __restrict__ out,
                             long long rows, int dim) {
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform per warp
  const float* p = x + row * dim;
  float s = 0.f;
  for (int d = lane; d < dim; d += 32) s = fmaf(p[d], p[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

__device__ __forceinline__ void push_top2(float d, int j, float& b1, int& i1, float& b2) {
  if (d < b1) {
    b2 = b1;
    b1 = d;
    i1 = j;
  } else if (d < b2) {
    b2 = d;
  }
}

__global__ void __launch_bounds__(kThreads)
knn2_top2(const float* __restrict__ query, const float* __restrict__ train,
          const float* __restrict__ qnorm, const float* __restrict__ tnorm,
          int n, int m, int dim, int* __restrict__ best_idx,
          float* __restrict__ best_dist, float* __restrict__ second_dist) {
  __shared__ float qs[kTileK][kTileQ + 1];
  __shared__ float ts[kTileK][kTileM + 1];
  __shared__ float mb1[kLanesM][kTileQ];
  __shared__ float mb2[kLanesM][kTileQ];
  __shared__ int mi1[kLanesM][kTileQ];

  const int pair = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int tx = tid % kLanesM;
  const int ty = tid / kLanesM;
  const float* qp = query + (size_t)pair * n * dim;
  const float* tp = train + (size_t)pair * m * dim;
  const float* qn = qnorm + (size_t)pair * n;
  const float* tn = tnorm + (size_t)pair * m;

  float b1[kRowsQ], b2[kRowsQ], qnr[kRowsQ];
  int i1[kRowsQ];
#pragma unroll
  for (int i = 0; i < kRowsQ; ++i) {
    const int row = q0 + ty + kLanesQ * i;
    b1[i] = CUDART_INF_F;
    b2[i] = CUDART_INF_F;
    i1[i] = INT_MAX;
    qnr[i] = row < n ? qn[row] : 0.f;
  }

  for (int m0 = 0; m0 < m; m0 += kTileM) {
    float acc[kRowsQ][kColsM];
#pragma unroll
    for (int i = 0; i < kRowsQ; ++i)
#pragma unroll
      for (int j = 0; j < kColsM; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += kTileK) {
#pragma unroll
      for (int l = 0; l < kTileQ * kTileK / kThreads; ++l) {
        const int e = tid + kThreads * l;
        const int r = e / kTileK;
        const int c = e % kTileK;
        const int col = k0 + c;
        const int qrow = q0 + r;
        const int trow = m0 + r;
        qs[c][r] = (qrow < n && col < dim) ? qp[(size_t)qrow * dim + col] : 0.f;
        ts[c][r] = (trow < m && col < dim) ? tp[(size_t)trow * dim + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kTileK; ++c) {
        float a[kRowsQ], b[kColsM];
#pragma unroll
        for (int i = 0; i < kRowsQ; ++i) a[i] = qs[c][ty + kLanesQ * i];
#pragma unroll
        for (int j = 0; j < kColsM; ++j) b[j] = ts[c][tx + kLanesM * j];
#pragma unroll
        for (int i = 0; i < kRowsQ; ++i)
#pragma unroll
          for (int j = 0; j < kColsM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // train columns of this thread come in increasing index order, so the
    // strict comparisons of push_top2 keep the lowest index on ties
#pragma unroll
    for (int j = 0; j < kColsM; ++j) {
      const int col = m0 + tx + kLanesM * j;
      if (col < m) {
        const float tnj = tn[col];
#pragma unroll
        for (int i = 0; i < kRowsQ; ++i) {
          const float d = fmaxf(qnr[i] + tnj - 2.f * acc[i][j], 0.f);
          push_top2(d, col, b1[i], i1[i], b2[i]);
        }
      }
    }
  }

  // merge the 16 partial top-2s of each query row, ordered by (dist, index)
#pragma unroll
  for (int i = 0; i < kRowsQ; ++i) {
    const int r = ty + kLanesQ * i;
    mb1[tx][r] = b1[i];
    mb2[tx][r] = b2[i];
    mi1[tx][r] = i1[i];
  }
  __syncthreads();
  if (tid < kTileQ) {
    const int r = tid;
    float best = mb1[0][r];
    float second = mb2[0][r];
    int idx = mi1[0][r];
    for (int s = 1; s < kLanesM; ++s) {
      const float c1 = mb1[s][r];
      const float c2 = mb2[s][r];
      const int j1 = mi1[s][r];
      if (c1 < best || (c1 == best && j1 < idx)) {
        second = fminf(best, c2);
        best = c1;
        idx = j1;
      } else {
        second = fminf(second, c1);
      }
    }
    const int row = q0 + r;
    if (row < n) {
      const size_t o = (size_t)pair * n + row;
      best_idx[o] = idx;
      best_dist[o] = best;
      second_dist[o] = second;
    }
  }
}

}  // namespace

// query [pairs, n, dim], train [pairs, m, dim] float32 contiguous on the device;
// qnorm [pairs, n] and tnorm [pairs, m] are scratch; outputs [pairs, n].
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int mv_knn2_f32(const float* query, const float* train, float* qnorm,
                           float* tnorm, int pairs, int n, int m, int dim,
                           int* best_idx, float* best_dist, float* second_dist,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qrows = (long long)pairs * n;
  const long long trows = (long long)pairs * m;
  const int rows_per_block = kThreads / 32;
  row_sq_norms<<<(unsigned)((qrows + rows_per_block - 1) / rows_per_block), kThreads, 0, s>>>(
      query, qnorm, qrows, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_sq_norms<<<(unsigned)((trows + rows_per_block - 1) / rows_per_block), kThreads, 0, s>>>(
      train, tnorm, trows, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTileQ - 1) / kTileQ, pairs);
  knn2_top2<<<grid, kThreads, 0, s>>>(query, train, qnorm, tnorm, n, m, dim, best_idx,
                                      best_dist, second_dist);
  return (int)cudaGetLastError();
}
