// The per-iteration assembly of the bundle adjustment's Schur-LM
// (multiview_tpu_torch/solver/assembly.py, called once an LM iteration by
// solver/schur.py), for Hopper (sm_90a). It replaces the eager composition of
// batched block products, index_add_, gathers and the batched 7x7
// torch.linalg.inv that the port ran, the counterpart of
// multiview_tpu/solver/schur.py:960-1081 with inv3x3_spd at :295-330 (XLA
// code: the JAX package has no pallas_call there). Over the residual
// families of one shard, rows n with a camera block J_c[n] [k, b] (columns:
// begin pose 7, end pose 7, the family's b - 14 constant columns), a point
// block J_p[n] [k, 3] and the residual r[n] [k] where the family has them:
//
//   rows pass     g_c raw = J_c^T r, cam diag = sum_k J_c^2 (per column, the
//                 pose columns added to each row's poses), g_p = J_p^T r and
//                 Hpp = J_p^T J_p (6 unique entries) per point
//   points pass   pt_diag = clamp(diag Hpp), Hpp^-1 = inv3x3_spd(Hpp + lam
//                 diag(pt_diag)) (the diagonally normalised adjugate, zero
//                 where det <= 0); per camera column the clamped diagonal,
//                 dc = lam cam_diag cam_free + (1 - cam_free), precond =
//                 1 / (cam_diag cam_free + dc), g_c = cam_free g_c raw
//   blocks pass   SCHUR_JACOBI: per row and side (begin, end) the 28 unique
//                 entries of jb^T jb - E Hpp^-1 E^T, jb = J_c[n][:, side] *
//                 cam_free of the side's pose, E = jb^T J_p[n]; summed per
//                 pose. No [N,7,7] or [N,7,3] is stored: the reference's
//                 packed form
//   poses pass    each pose block + diag(dc) inverted (Gauss-Jordan with
//                 partial pivoting); a zero pivot sets the device flag
//                 `singular` (the wrapper raises on it at the LM loop's host
//                 sync) and stores a zero inverse
//
// Every sum and product is taken in float64 for float32 tensors too (B - E
// Hpp^-1 E^T cancels); the sums live in float64 scratch (`acc`, `blocks`,
// `hinv`) and the outputs are rounded once.
//
// Which launch runs what: every launch is cooperative (cudaLaunchKernelEx with
// the cooperative attribute; a grid of the blocks that fit on the card at
// once) and zeroes its own sums in a phase 0. On one shard one launch runs
// every pass, grid barriers between them. With several shards a shard's sums
// must be added over the shards (and the processes) before the points pass
// (ShardMesh.sum in solver/assembly.py), so the wrapper makes one launch a
// shard of the rows pass, one of the points pass on the lead device, one a
// shard of the blocks pass (reading the summed Hpp^-1) and one of the poses
// pass.
//
// Rows: a warp takes 32 consecutive rows of one family at a time (a chunk),
// one lane a row; the grid's warps stride over the chunks. Sums over rows:
//   poses     a warp whose lanes share one pose sums each value with a
//             reduce-scatter of shuffles; otherwise a __match_any_sync
//             shuffle tree over the lanes of each pose; then one add a pose
//             and value into this warp's own copy of the sums in shared
//             memory (no atomics: one lane writes an address at a time), or,
//             where a copy a warp does not fit, a float64 global atomic. The
//             block adds its warps' copies with one global atomic an entry
//             at its end. A row whose begin and end pose are one pose adds
//             its two sides first.
//   constants a reduce-scatter a warp (a chunk is of one family), one add a
//             column.
//   points    runs of lanes of one point (calibrate's track-major rows) are
//             summed by a segmented scan first, then one float64 global
//             atomic a run and value.
// The order of the atomics, and the last bits of the float64 sums, vary from
// run to run; the outputs, rounded to float32, vary in their last bit at
// most where a sum lies on a rounding boundary.
//
// Bound: bytes. The assembly must read J_c, J_p, r and the row indices once
// (at the benchmark's 384000 float32 pixel rows 89.1 + 9.2 + 3.1 + 9.2 MB:
// 33 us at 3.35 TB/s) and write its outputs (a few hundred KB); its
// operations (about 8 k b a row, 400 a SCHUR_JACOBI row and side) are far
// below the FP64 rate. This design reads every row once in the rows pass and
// again in the blocks pass (SCHUR_JACOBI only), straight from global memory
// (a lane reads its row's contiguous span; the warp's 32 rows are one span).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxFamilies = 32;   // families of one launch (the wrapper refuses more)
constexpr int kFields = 10;        // int64 fields of one family in the host table
constexpr int kThreads = 256;      // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;         // rows of a warp's unit of work
constexpr int kPoseCols = 7;
constexpr int kFirstConst = 14;    // camera columns before the constant ones
constexpr int kBlock = 28;         // unique entries of a symmetric 7x7 pose block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCopyBudget = 200 * 1024;  // per-warp copies of the sums in shared memory
constexpr int kRows = 1, kPoints = 2, kBlocks = 4, kPoses = 8;

struct Family {
  const void* j_cam;        // [n, k, b], or null: the family has no camera block
  const void* j_pt;         // [n, k, 3], or null: it touches no point
  const long long* beg;     // [n] (with j_cam)
  const long long* end;     // [n] (with j_cam)
  const long long* cols;    // [b - 14] the constant columns (with j_cam)
  const long long* pidx;    // [n] (with j_pt)
  const void* r;            // [n, k] residuals, or null: no gradient
  long long n;
  long long first_chunk;    // the family's first chunk among all families'
  int k, b;
};

template <typename T>
struct Params {
  Family f[kMaxFamilies];
  int count;
  int passes;               // kRows | kPoints | kBlocks | kPoses
  long long chunks;
  const T* cf;              // [total] cam_free
  const T* lam;             // [1] the LM damping
  long long num_points, total, num_ref;
  double* acc;              // [2 total + 9 num_points]: g_c raw, cam diag, g_p [P,3], Hpp [P,6]
  double* blocks;           // [num_ref, 28] the pose blocks' sums
  double* hinv;             // [num_points, 9] Hpp^-1 in float64 (the blocks pass's), or null
  T* g_c;                   // [total], or null: no gradient
  T* g_p;                   // [num_points, 3], or null
  T* hpp;                   // [num_points, 3, 3]
  T* cam_diag;              // [total]
  T* pt_diag;               // [num_points, 3]
  T* hpp_inv;               // [num_points, 3, 3]
  T* dc;                    // [total]
  T* precond;               // [total]
  T* pose_inv;              // [num_ref, 7, 7]
  int* singular;            // set to 1 where a pose block has a zero pivot
  int cam_copies;           // 1: a copy a warp of the camera sums in shared memory
  int block_copies;         // 1: a copy a warp of the pose blocks' sums
};

template <typename T>
__device__ __forceinline__ double ld(const T* p) {
  return static_cast<double>(__ldg(p));
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ double clamp_nan(double v, double lo, double hi) {
  return v != v ? v : fmin(fmax(v, lo), hi);
}

__device__ __forceinline__ double clamp_diag(double v) { return clamp_nan(v, 1e-12, 1e32); }

// Where a warp's sums go: its own copy in shared memory (no two lanes of the
// warp add to one address at once), or the global sums by atomics
struct Sink {
  double* sh;
  double* gl;
  __device__ __forceinline__ void add(long long i, double v) const {
    if (sh)
      sh[i] += v;
    else
      atomicAdd(gl + i, v);
  }
};

// Sums V = 2^q values over the 32 lanes with a reduce-scatter: 16 / 2 + ... + 1
// shuffles in the halving rounds, one each in the others. Returns in lane l
// the warp's total of value (l >> (5 - q)); the lanes with l % 2^(5 - q) == 0
// hold each total once.
template <int V>
__device__ __forceinline__ double reduce_scatter(double (&v)[V]) {
  const int lane = threadIdx.x & 31;
  int n = V;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      const int h = n / 2;
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < h) {
          const double send = upper ? v[i] : v[i + h];
          const double keep = upper ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
      n = h;
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
    }
  }
  return v[0];
}

template <int V>
__device__ __forceinline__ int scatter_shift() {
  return V == 32 ? 0 : V == 16 ? 1 : V == 8 ? 2 : V == 4 ? 3 : V == 2 ? 4 : 5;
}

// Sums v[0..N) over the lanes of `peers` (the lanes whose key equals this
// lane's) into the lowest of them, by a tree of shuffles: in each round a lane
// adds the value of the next remaining peer above it, and the peers of odd
// rank drop out. Every lane of the warp must call it.
template <int N, int V>
__device__ __forceinline__ void reduce_peers(unsigned peers, double (&v)[V]) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, rest != 0u)) {
    const int next = __ffs(rest);            // 1 + the lane of the next peer above, 0 if none
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const double t = __shfl_sync(kFull, v[i], src);
      if (next) v[i] += t;
    }
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// Adds the first N of a lane's V values (V a power of two, the rest 0) to key
// `key` (key < 0: nothing, and the lane's values are 0): index(key, j) is
// value j's place in the sums. Every lane of the warp calls it.
template <int N, int V, typename Index>
__device__ __forceinline__ void add_keyed(long long key, double (&v)[V], const Sink& sink,
                                          Index index) {
  const unsigned valid = __ballot_sync(kFull, key >= 0);
  if (valid == 0u) return;
  const long long k0 = __shfl_sync(kFull, key, __ffs(valid) - 1);
  const int lane = threadIdx.x & 31;
  if (__all_sync(kFull, key < 0 || key == k0)) {
    const double t = reduce_scatter<V>(v);
    const int j = lane >> scatter_shift<V>();
    if ((lane & ((1 << scatter_shift<V>()) - 1)) == 0 && j < N) sink.add(index(k0, j), t);
  } else {
    const unsigned peers = __match_any_sync(kFull, key);
    reduce_peers<N>(peers, v);
    if (key >= 0 && lane == __ffs(peers) - 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) sink.add(index(key, j), v[j]);
    }
  }
}

// Adds v[0..9) (g_p 3, Hpp's 6 unique entries) to point `key` (key < 0:
// nothing). Every lane calls it: runs of lanes with one point are summed by a
// segmented scan first, then one global atomic a run and value.
__device__ __forceinline__ void add_point(double* gp, double* hpp, long long key, double (&v)[9]) {
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(kFull, key, 1);
  const bool head = key >= 0 && (lane == 0 || prev != key);
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned valid = __ballot_sync(kFull, key >= 0);
  if (heads != valid) {
    const unsigned breaks = heads | ~valid;
    const unsigned above = lane == 31 ? 0u : breaks & (0xffffffffu << (lane + 1));
    const int run_end = above ? __ffs(above) - 2 : 31;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const double t = __shfl_down_sync(kFull, v[j], o);
        if (lane + o <= run_end) v[j] += t;
      }
    }
  }
  if (head) {
#pragma unroll
    for (int j = 0; j < 3; ++j) atomicAdd(gp + key * 3 + j, v[j]);
#pragma unroll
    for (int j = 0; j < 6; ++j) atomicAdd(hpp + key * 6 + j, v[3 + j]);
  }
}

// The index of entry (i, j), i <= j, of a symmetric 7x7 block among its 28
__host__ __device__ __forceinline__ int sym7(int i, int j) { return i * 7 - i * (i - 1) / 2 + j - i; }

// The rows pass over one chunk of a family (K components a row)
template <int K, typename T>
__device__ __forceinline__ void rows_chunk(const Params<T>& p, const Family& f, long long row0,
                                           const Sink& cam) {
  const int lane = threadIdx.x & 31;
  const long long row = row0 + lane;
  const bool valid = row < f.n;
  const long long C = p.total;
  double rr[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    rr[i] = (valid && f.r) ? ld(static_cast<const T*>(f.r) + row * K + i) : 0.0;
  if (f.j_cam) {
    const int b = f.b;
    const T* J = static_cast<const T*>(f.j_cam) + (valid ? row : 0) * K * b;
    long long kb = valid ? __ldg(f.beg + row) : -1, ke = valid ? __ldg(f.end + row) : -1;
    // g of the pose's 7 columns, then their diagonal; 2 unused
    double vb[16], ve[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) vb[j] = ve[j] = 0.0;
    if (valid) {
#pragma unroll
      for (int j = 0; j < kPoseCols; ++j) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const double a = ld(J + i * b + j), c = ld(J + i * b + kPoseCols + j);
          vb[j] += a * rr[i];
          vb[kPoseCols + j] += a * a;
          ve[j] += c * rr[i];
          ve[kPoseCols + j] += c * c;
        }
      }
    }
    if (kb == ke) {
      // one pose: its two sides added first, the end side left empty
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        vb[j] += ve[j];
        ve[j] = 0.0;
      }
      ke = -1;
    }
    auto pose_index = [C](long long pose, int j) {
      return (j < kPoseCols ? 0 : C) + pose * kPoseCols + j % kPoseCols;
    };
    add_keyed<2 * kPoseCols>(kb, vb, cam, pose_index);
    add_keyed<2 * kPoseCols>(ke, ve, cam, pose_index);
    const int nconst = b - kFirstConst;
    for (int c0 = 0; c0 < nconst; c0 += 16) {
      double v[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        double g = 0.0, d = 0.0;
        if (valid && c0 + j < nconst) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const double a = ld(J + i * b + kFirstConst + c0 + j);
            g += a * rr[i];
            d += a * a;
          }
        }
        v[j] = g;
        v[16 + j] = d;
      }
      const double t = reduce_scatter<32>(v);
      const int c = c0 + (lane & 15);
      if (c < nconst) cam.add((lane < 16 ? 0 : C) + __ldg(f.cols + c), t);
    }
  }
  if (f.j_pt) {
    double v[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) v[j] = 0.0;
    if (valid) {
      const T* P = static_cast<const T*>(f.j_pt) + row * K * 3;
      double q[K][3];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m) q[i][m] = ld(P + i * 3 + m);
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int m = 0; m < 3; ++m) v[m] += q[i][m] * rr[i];
        v[3] += q[i][0] * q[i][0];
        v[4] += q[i][0] * q[i][1];
        v[5] += q[i][0] * q[i][2];
        v[6] += q[i][1] * q[i][1];
        v[7] += q[i][1] * q[i][2];
        v[8] += q[i][2] * q[i][2];
      }
    }
    add_point(p.acc + 2 * C, p.acc + 2 * C + 3 * p.num_points, valid ? __ldg(f.pidx + row) : -1,
              v);
  }
}

// bb (28 unique entries) += jb^T jb - E Hinv E^T of one row's side: jb = the
// side's 7 columns of J [K, b] times cam_free of its pose, E = jb^T Jp
template <int K, typename T>
__device__ __forceinline__ void side_block(const T* J, int b, int side, long long pose,
                                           const T* cf, bool pt, const double (&Jp)[K][3],
                                           const double (&H)[9], double (&bb)[32]) {
  double jb[K][kPoseCols];
#pragma unroll
  for (int c = 0; c < kPoseCols; ++c) {
    const double fp = ld(cf + pose * kPoseCols + c);
#pragma unroll
    for (int i = 0; i < K; ++i) jb[i][c] = ld(J + i * b + side * kPoseCols + c) * fp;
  }
#pragma unroll
  for (int c1 = 0; c1 < kPoseCols; ++c1)
#pragma unroll
    for (int c2 = c1; c2 < kPoseCols; ++c2) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < K; ++i) s += jb[i][c1] * jb[i][c2];
      bb[sym7(c1, c2)] += s;
    }
  if (!pt) return;
  double E[kPoseCols][3];
#pragma unroll
  for (int c = 0; c < kPoseCols; ++c)
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < K; ++i) s += jb[i][c] * Jp[i][m];
      E[c][m] = s;
    }
#pragma unroll
  for (int c1 = 0; c1 < kPoseCols; ++c1) {
    double W[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) W[q] = E[c1][0] * H[q] + E[c1][1] * H[3 + q] + E[c1][2] * H[6 + q];
#pragma unroll
    for (int c2 = c1; c2 < kPoseCols; ++c2)
      bb[sym7(c1, c2)] -= W[0] * E[c2][0] + W[1] * E[c2][1] + W[2] * E[c2][2];
  }
}

// The blocks pass over one chunk of a family with a camera block
template <int K, typename T>
__device__ __forceinline__ void blocks_chunk(const Params<T>& p, const Family& f, long long row0,
                                             const Sink& blk) {
  const int lane = threadIdx.x & 31;
  const long long row = row0 + lane;
  const bool valid = row < f.n;
  const int b = f.b;
  const bool pt = f.j_pt != nullptr;
  const T* J = static_cast<const T*>(f.j_cam) + (valid ? row : 0) * K * b;
  const long long kb = valid ? __ldg(f.beg + row) : -1, ke = valid ? __ldg(f.end + row) : -1;
  double Jp[K][3], H[9];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int m = 0; m < 3; ++m) Jp[i][m] = 0.0;
#pragma unroll
  for (int j = 0; j < 9; ++j) H[j] = 0.0;
  if (valid && pt) {
    const T* P = static_cast<const T*>(f.j_pt) + row * K * 3;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int m = 0; m < 3; ++m) Jp[i][m] = ld(P + i * 3 + m);
    const double* h = p.hinv + __ldg(f.pidx + row) * 9;
#pragma unroll
    for (int j = 0; j < 9; ++j) H[j] = __ldcg(h + j);
  }
  auto block_index = [](long long pose, int j) { return pose * kBlock + j; };
  double bb[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) bb[j] = 0.0;
  const bool merged = valid && kb == ke;
  if (valid) side_block<K>(J, b, 0, kb, p.cf, pt, Jp, H, bb);
  if (merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);
  add_keyed<kBlock>(kb, bb, blk, block_index);
#pragma unroll
  for (int j = 0; j < 32; ++j) bb[j] = 0.0;
  if (valid && !merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);
  add_keyed<kBlock>(valid && !merged ? ke : -1ll, bb, blk, block_index);
}

// Hpp + lam diag(pt_diag) of one point inverted by the diagonally normalised
// adjugate (solver/assembly.py::inv3x3_spd), in float64
__device__ __forceinline__ void inv3x3_spd(const double (&A)[9], double (&out)[9]) {
  double d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = sqrt(A[4 * i] != A[4 * i] ? A[4 * i] : fmax(A[4 * i], 1e-32));
  double M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[3 * i + j] = A[3 * i + j] / (d[i] * d[j]);
  const double a = M[0], b = M[1], c = M[2], dd = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
               i = M[8];
  const double c00 = e * i - f * h, c10 = f * g - dd * i, c20 = dd * h - e * g;
  const double det = a * c00 + b * c10 + c * c20;
  const double inv_det = det > 0.0 ? 1.0 / det : 0.0;
  const double adj[9] = {c00, c * h - b * i, b * f - c * e,
                         c10, a * i - c * g, c * dd - a * f,
                         c20, b * g - a * h, a * e - b * dd};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) out[3 * r + s] = adj[3 * r + s] * inv_det / (d[r] * d[s]);
}

// In-place Gauss-Jordan inverse of a 7x7 block with partial pivoting (the LU
// that torch.linalg.inv runs); false where a pivot is 0
__device__ bool invert7(double (&a)[7][7], double (&inv)[7][7]) {
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 7; ++j) inv[i][j] = i == j ? 1.0 : 0.0;
  for (int col = 0; col < 7; ++col) {
    int piv = col;
    double best = fabs(a[col][col]);
    for (int r = col + 1; r < 7; ++r)
      if (fabs(a[r][col]) > best) {
        best = fabs(a[r][col]);
        piv = r;
      }
    if (!(best > 0.0)) return false;
    if (piv != col) {
      for (int j = 0; j < 7; ++j) {
        const double t = a[col][j];
        a[col][j] = a[piv][j];
        a[piv][j] = t;
        const double u = inv[col][j];
        inv[col][j] = inv[piv][j];
        inv[piv][j] = u;
      }
    }
    const double s = 1.0 / a[col][col];
    for (int j = 0; j < 7; ++j) {
      a[col][j] *= s;
      inv[col][j] *= s;
    }
    for (int r = 0; r < 7; ++r) {
      if (r == col) continue;
      const double m = a[r][col];
      if (m == 0.0) continue;
      for (int j = 0; j < 7; ++j) {
        a[r][j] -= m * a[col][j];
        inv[r][j] -= m * inv[col][j];
      }
    }
  }
  return true;
}

// The family of chunk c and its first row
template <typename T>
__device__ __forceinline__ int chunk_family(const Params<T>& p, long long c, long long& row0) {
  int fi = 0;
  while (fi + 1 < p.count && p.f[fi + 1].first_chunk <= c) ++fi;
  row0 = (c - p.f[fi].first_chunk) * kChunk;
  return fi;
}

// Zeroes a warp copy region of `size` doubles a warp
__device__ __forceinline__ void zero_shared(double* sh, long long size) {
  for (long long i = threadIdx.x; i < size; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();
}

// Adds the block's warp copies (`size` doubles each) to the global sums
__device__ __forceinline__ void flush_copies(const double* sh, long long size, double* gl) {
  __syncthreads();
  for (long long i = threadIdx.x; i < size; i += blockDim.x) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += sh[w * size + i];
    if (v != 0.0) atomicAdd(gl + i, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) assembly_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) double smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const long long C = p.total, P = p.num_points, R = p.num_ref;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const bool rows = p.passes & kRows, points = p.passes & kPoints, blocks = p.passes & kBlocks,
             poses = p.passes & kPoses;

  // phase 0: the launch's own sums start at 0
  if (rows)
    for (long long i = gt; i < 2 * C + 9 * P; i += gs) p.acc[i] = 0.0;
  if (blocks)
    for (long long i = gt; i < R * kBlock; i += gs) p.blocks[i] = 0.0;
  if (rows || blocks) grid.sync();

  if (rows) {
    const long long size = 2 * C;
    Sink cam{p.cam_copies ? smem + warp * size : nullptr, p.acc};
    if (p.cam_copies) zero_shared(smem, kWarps * size);
    for (long long c = gwarp; c < p.chunks; c += nwarps) {
      long long row0;
      const Family& f = p.f[chunk_family(p, c, row0)];
      if (f.k == 2)
        rows_chunk<2>(p, f, row0, cam);
      else
        rows_chunk<3>(p, f, row0, cam);
    }
    if (p.cam_copies) flush_copies(smem, size, p.acc);
    if (points || blocks || poses) grid.sync();
  }

  if (points) {
    const double lam = ld(p.lam);
    const double* gp = p.acc + 2 * C;
    const double* hs = gp + 3 * P;
    for (long long i = gt; i < P; i += gs) {
      // written by other blocks' atomics in this launch: read from L2
      double h[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) h[j] = __ldcg(hs + i * 6 + j);
      const double H[9] = {h[0], h[1], h[2], h[1], h[3], h[4], h[2], h[4], h[5]};
      double A[9], out[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        A[j] = H[j];
        p.hpp[i * 9 + j] = static_cast<T>(H[j]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double pd = clamp_diag(H[4 * j]);
        p.pt_diag[i * 3 + j] = static_cast<T>(pd);
        A[4 * j] += lam * pd;
      }
      inv3x3_spd(A, out);
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        p.hpp_inv[i * 9 + j] = static_cast<T>(out[j]);
        if (p.hinv) p.hinv[i * 9 + j] = out[j];
      }
      if (p.g_p)
#pragma unroll
        for (int j = 0; j < 3; ++j) p.g_p[i * 3 + j] = static_cast<T>(__ldcg(gp + i * 3 + j));
    }
    for (long long j = gt; j < C; j += gs) {
      const double cd = clamp_diag(__ldcg(p.acc + C + j)), cf = ld(p.cf + j);
      const double dc = lam * cd * cf + (1.0 - cf);
      p.cam_diag[j] = static_cast<T>(cd);
      p.dc[j] = static_cast<T>(dc);
      p.precond[j] = static_cast<T>(1.0 / (cd * cf + dc));
      if (p.g_c) p.g_c[j] = static_cast<T>(__ldcg(p.acc + j) * cf);
    }
    if (blocks || poses) grid.sync();
  }

  if (blocks) {
    const long long size = R * kBlock;
    Sink blk{p.block_copies ? smem + warp * size : nullptr, p.blocks};
    if (p.block_copies) zero_shared(smem, kWarps * size);
    for (long long c = gwarp; c < p.chunks; c += nwarps) {
      long long row0;
      const Family& f = p.f[chunk_family(p, c, row0)];
      if (!f.j_cam) continue;            // uniform over the warp: a chunk is of one family
      if (f.k == 2)
        blocks_chunk<2>(p, f, row0, blk);
      else
        blocks_chunk<3>(p, f, row0, blk);
    }
    if (p.block_copies) flush_copies(smem, size, p.blocks);
    if (poses) grid.sync();
  }

  if (poses) {
    const double lam = ld(p.lam);
    for (long long r = gt; r < R; r += gs) {
      double a[7][7], inv[7][7];
      for (int i = 0; i < 7; ++i)
        for (int j = i; j < 7; ++j) a[i][j] = a[j][i] = __ldcg(p.blocks + r * kBlock + sym7(i, j));
      for (int i = 0; i < 7; ++i) {
        const long long col = r * kPoseCols + i;
        const double cf = ld(p.cf + col);
        a[i][i] += lam * clamp_diag(__ldcg(p.acc + C + col)) * cf + (1.0 - cf);
      }
      const bool ok = invert7(a, inv);
      if (!ok) *p.singular = 1;
      for (int i = 0; i < 7; ++i)
        for (int j = 0; j < 7; ++j)
          p.pose_inv[r * 49 + i * 7 + j] = static_cast<T>(ok ? inv[i][j] : 0.0);
    }
  }
}

// Per-device launch state: SM count, and co-resident blocks an SM by element
// size and shared memory
struct DeviceState {
  int sms = 0;
  int set[2] = {0, 0};          // the shared-memory attribute set (float, double)
  long long smem[2] = {-1, -1};
  int blocks[2] = {0, 0};
};
DeviceState g_devices[64];

template <typename T>
cudaError_t run(const long long* table, int families, int passes, const void* cf,
                const void* lam, long long num_points, long long total, long long num_ref,
                double* acc, double* blocks, double* hinv, void* g_c, void* g_p, void* hpp,
                void* cam_diag, void* pt_diag, void* hpp_inv, void* dc, void* precond,
                void* pose_inv, int* singular, long long* info, cudaStream_t stream) {
  if (families < 0 || families > kMaxFamilies) return cudaErrorInvalidValue;
  Params<T> p{};
  p.count = families;
  p.passes = passes;
  long long chunks = 0;
  for (int i = 0; i < families; ++i) {
    const long long* e = table + static_cast<long long>(i) * kFields;
    Family& f = p.f[i];
    f.j_cam = reinterpret_cast<const void*>(e[0]);
    f.j_pt = reinterpret_cast<const void*>(e[1]);
    f.beg = reinterpret_cast<const long long*>(e[2]);
    f.end = reinterpret_cast<const long long*>(e[3]);
    f.cols = reinterpret_cast<const long long*>(e[4]);
    f.pidx = reinterpret_cast<const long long*>(e[5]);
    f.r = reinterpret_cast<const void*>(e[6]);
    f.n = e[7];
    f.k = static_cast<int>(e[8]);
    f.b = static_cast<int>(e[9]);
    if (f.k < 2 || f.k > 3 || f.n < 0 || (f.j_cam && f.b < kFirstConst)) return cudaErrorInvalidValue;
    f.first_chunk = chunks;
    chunks += (f.n + kChunk - 1) / kChunk;
  }
  p.chunks = chunks;
  p.cf = static_cast<const T*>(cf);
  p.lam = static_cast<const T*>(lam);
  p.num_points = num_points;
  p.total = total;
  p.num_ref = num_ref;
  p.acc = acc;
  p.blocks = blocks;
  p.hinv = hinv;
  p.g_c = static_cast<T*>(g_c);
  p.g_p = static_cast<T*>(g_p);
  p.hpp = static_cast<T*>(hpp);
  p.cam_diag = static_cast<T*>(cam_diag);
  p.pt_diag = static_cast<T*>(pt_diag);
  p.hpp_inv = static_cast<T*>(hpp_inv);
  p.dc = static_cast<T*>(dc);
  p.precond = static_cast<T*>(precond);
  p.pose_inv = static_cast<T*>(pose_inv);
  p.singular = singular;
  if ((passes & kBlocks) && !hinv) return cudaErrorInvalidValue;
  if ((passes & kPoses) && !singular) return cudaErrorInvalidValue;
  // a copy a warp of the camera sums (g_c raw, diag) and of the pose blocks'
  // sums, where they fit
  const long long cam_bytes = kWarps * 2 * total * 8ll;
  const long long block_bytes = kWarps * num_ref * kBlock * 8ll;
  p.cam_copies = (passes & kRows) && cam_bytes <= kCopyBudget;
  p.block_copies = (passes & kBlocks) && block_bytes <= kCopyBudget;
  const long long smem = std::max(p.cam_copies ? cam_bytes : 0, p.block_copies ? block_bytes : 0);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceState& ds = g_devices[dev];
  const int t = sizeof(T) == 8;
  if (ds.sms == 0) {
    err = cudaDeviceGetAttribute(&ds.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!ds.set[t]) {
    err = cudaFuncSetAttribute(assembly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCopyBudget);
    if (err != cudaSuccess) return err;
    ds.set[t] = 1;
  }
  if (ds.smem[t] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ds.blocks[t], assembly_kernel<T>,
                                                        kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (ds.blocks[t] < 1) return cudaErrorCooperativeLaunchTooLarge;
    ds.smem[t] = smem;
  }
  const int grid = ds.blocks[t] * ds.sms;
  if (info) {
    info[0] = grid;
    info[1] = kThreads;
    info[2] = smem;
    info[3] = p.cam_copies;
    info[4] = p.block_copies;
    info[5] = chunks;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, assembly_kernel<T>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One cooperative launch on `stream`, without synchronising; returns the
// first CUDA error (0 for none). `elem`: the element size (4: float32, 8:
// float64). `table` holds 10 int64 per family: pointers to J_c [n,k,b] (0:
// none), J_p [n,k,3] (0: none), begin and end poses [n], constant columns
// [b-14], points [n], residuals [n,k] (0: no gradient), then n, k, b; pointers
// on the device, indices int64, every array contiguous. `passes` (bits): 1 the
// rows pass (acc [2 total + 9 num_points] float64, zeroed first), 2 the
// points pass (reads acc, lam [1] and cam_free [total]; writes hpp, pt_diag,
// hpp_inv, cam_diag, dc, precond, and g_c, g_p where not null; hinv [9
// num_points] float64 where not null), 4 the blocks pass (reads hinv and
// cam_free; blocks [28 num_ref] float64, zeroed first), 8 the poses pass
// (reads blocks, acc, lam, cam_free; writes pose_inv [num_ref,7,7] and sets
// *singular to 1 on a zero pivot). `info` (null: not asked) receives the
// grid, the threads a block, the dynamic shared memory, whether the camera
// sums and the pose blocks' sums took a copy a warp in shared memory (1) or
// global atomics (0), and the chunks of 32 rows.
extern "C" int mv_lm_assembly(int elem, const long long* table, int families, int passes,
                              const void* cam_free, const void* lam, long long num_points,
                              long long total, long long num_ref, double* acc, double* blocks,
                              double* hinv, void* g_c, void* g_p, void* hpp, void* cam_diag,
                              void* pt_diag, void* hpp_inv, void* dc, void* precond,
                              void* pose_inv, int* singular, long long* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes < 1 || passes > 15) return cudaErrorInvalidValue;
  if (elem == 4)
    return run<float>(table, families, passes, cam_free, lam, num_points, total, num_ref, acc,
                      blocks, hinv, g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc, precond,
                      pose_inv, singular, info, s);
  if (elem == 8)
    return run<double>(table, families, passes, cam_free, lam, num_points, total, num_ref, acc,
                       blocks, hinv, g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc, precond,
                       pose_inv, singular, info, s);
  return cudaErrorInvalidValue;
}
