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
//   poses pass    each pose block + diag(dc) inverted by a warp (Gauss-Jordan
//                 with partial pivoting, the LU's choice of pivots that
//                 torch.linalg.inv makes); a zero pivot sets the device flag
//                 `singular` (the wrapper raises on it at the LM loop's host
//                 sync) and stores a zero inverse
//
// Every sum and product is taken in float64 for float32 tensors too (B - E
// Hpp^-1 E^T cancels); the sums live in float64 scratch (`acc`, `blocks`,
// `hinv`) and the outputs are rounded once.
//
// Which launch runs what: every launch is cooperative (cudaLaunchKernelEx with
// the cooperative attribute; one block an SM). On one shard one launch runs
// every pass, a grid barrier between two passes (one with jacobi, three with
// SCHUR_JACOBI), and leaves its scratch at 0 for the next (`clear`: each sum
// is cleared by the thread that reads it last; the caller allocates it
// zeroed). With several shards a shard's sums must be added over the shards
// (and the processes) before the points pass (ShardMesh.sum in
// solver/assembly.py), so the wrapper makes one launch a shard of the rows
// pass, one of the points pass on the lead device, one a shard of the blocks
// pass (reading the summed Hpp^-1) and one of the poses pass; the rows and
// blocks launches zero their sums first (`zero_first`).
//
// Rows (row_tiles.cuh, as schur_mv.cu walks them): each block takes a
// contiguous span of 32-row chunks, even in bytes, and stages its tiles
// (J_c, J_p, r, beg, end, pidx of tile_rows rows: contiguous spans) into
// shared memory with 16-byte cp.async copies, two in flight while a third is
// computed; a lane computes its row from shared memory. The rows pass walks
// the tiles forward, the blocks pass in reverse, starting on the tiles the
// rows pass left in the ring: a system whose rows fit in the blocks' shared
// memory (calibrate's) is read from device memory once. Sums over rows:
//   poses     a warp whose lanes share one pose sums each value with a
//             reduce-scatter of shuffles; otherwise a __match_any_sync
//             shuffle tree over the lanes of each pose; then one add a pose
//             and value into this warp's own copy of a window of the block's
//             poses in shared memory (no atomics: one lane writes an address
//             at a time; the window starts at the pose of the block's first
//             row), or, for a pose outside it, a float64 global atomic. The
//             block adds its warps' copies with one global atomic an entry
//             at the pass's end. In the rows pass a thread keeps running
//             sums of its rows' poses while they stay the same pose (the
//             cube's frame-major rows: a reduction a few times a pass), and a
//             row whose begin and end pose are one pose adds its two sides
//             first.
//   constants a reduce-scatter a warp, one add a column into the warp's own
//             copy; the block adds its copies at each change of family.
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
// below the FP64 rate. This design reads every row once through shared
// memory (and again in the blocks pass for the rows that did not stay there)
// and adds 9 float64 global atomics a row for the points.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "row_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using row_tiles::align16;
using row_tiles::block_span;
using row_tiles::kChunk;
using row_tiles::locate;
using row_tiles::TileRef;

constexpr int kMaxFamilies = 32;   // families of one launch (the wrapper refuses more)
constexpr int kFields = 10;        // int64 fields of one family in the host table
constexpr int kThreads = 256;      // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kPoseCols = 7;
constexpr int kFirstConst = 14;    // camera columns before the constant ones
constexpr int kBlock = 28;         // unique entries of a symmetric 7x7 pose block
constexpr int kPoseSums = 2 * kPoseCols;  // the rows pass's sums of a pose: g, diag
constexpr int kWindow = 32;        // poses of the per-warp copies in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmem = 230400;      // dynamic shared memory a block (sm_90: 227 KB at most)
constexpr int kRows = 1, kPoints = 2, kBlocks = 4, kPoses = 8;
constexpr int kMarks = 5;          // timer marks a block: start, after each pass

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
  long long weight;         // bytes a row reads: the blocks' spans are even in bytes
  int k, b;
};

template <typename T>
struct Params {
  Family f[kMaxFamilies];
  int count;
  int passes;               // kRows | kPoints | kBlocks | kPoses
  int zero_first;           // the launch zeroes its sums first (several shards)
  int clear;                // the launch leaves its scratch at 0 (one shard)
  long long weight;         // the bytes of every family's chunks
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
  const int* halt;          // set: return at once (the LM loop's stop flag), or null
  long long* marks;         // [grid, kMarks] %globaltimer a block, or null
  int window, stride;       // poses of the per-warp copies, doubles a pose (14 or 28)
  int max_const;            // the most constant columns of a family
  int tile_rows, slots, slot_bytes;
  int off_const, off_ring;  // shared memory: window copies at 0, constants, the ring
};

// The byte offsets of a tile's arrays in its slot: J_c at 0, J_p, r, beg,
// end, pidx (each where the family has it)
struct SlotLayout {
  int jp, r, beg, end, pidx, bytes;
};

__host__ __device__ __forceinline__ SlotLayout slot_layout(const Family& f, int rows, int elem) {
  SlotLayout l;
  l.jp = f.j_cam ? align16(static_cast<long long>(rows) * f.k * f.b * elem) : 0;
  l.r = l.jp + (f.j_pt ? align16(static_cast<long long>(rows) * f.k * 3 * elem) : 0);
  l.beg = l.r + (f.r ? align16(static_cast<long long>(rows) * f.k * elem) : 0);
  l.end = l.beg + (f.j_cam ? align16(rows * 8ll) : 0);
  l.pidx = l.end + (f.j_cam ? align16(rows * 8ll) : 0);
  l.bytes = l.pidx + (f.j_pt ? align16(rows * 8ll) : 0);
  return l;
}

// One tile's arrays in its slot
template <typename T>
struct Tile {
  const T* jc;
  const T* jp;
  const T* r;
  const long long* beg;
  const long long* end;
  const long long* pidx;
};

template <typename T>
__device__ __forceinline__ Tile<T> tile_in(const Family& f, int tile_rows, unsigned char* slot) {
  const SlotLayout l = slot_layout(f, tile_rows, sizeof(T));
  return {reinterpret_cast<const T*>(slot), reinterpret_cast<const T*>(slot + l.jp),
          f.r ? reinterpret_cast<const T*>(slot + l.r) : nullptr,
          reinterpret_cast<const long long*>(slot + l.beg),
          reinterpret_cast<const long long*>(slot + l.end),
          reinterpret_cast<const long long*>(slot + l.pidx)};
}

template <typename T>
__device__ __forceinline__ void issue_tile(const Params<T>& p, const TileRef& t,
                                           unsigned char* slot) {
  using row_tiles::copy_async;
  const Family& f = p.f[t.f];
  const SlotLayout l = slot_layout(f, p.tile_rows, sizeof(T));
  const long long rk = static_cast<long long>(t.rows) * f.k;
  if (f.j_cam) {
    copy_async(slot, static_cast<const unsigned char*>(f.j_cam) + t.row0 * f.k * f.b * sizeof(T),
               rk * f.b * sizeof(T));
    copy_async(slot + l.beg, reinterpret_cast<const unsigned char*>(f.beg + t.row0), t.rows * 8ll);
    copy_async(slot + l.end, reinterpret_cast<const unsigned char*>(f.end + t.row0), t.rows * 8ll);
  }
  if (f.j_pt) {
    copy_async(slot + l.jp,
               static_cast<const unsigned char*>(f.j_pt) + t.row0 * f.k * 3 * sizeof(T),
               rk * 3 * sizeof(T));
    copy_async(slot + l.pidx, reinterpret_cast<const unsigned char*>(f.pidx + t.row0),
               t.rows * 8ll);
  }
  if (f.r)
    copy_async(slot + l.r, static_cast<const unsigned char*>(f.r) + t.row0 * f.k * sizeof(T),
               rk * sizeof(T));
}

template <typename T>
__device__ __forceinline__ double ld(const T* p) {
  return static_cast<double>(__ldg(p));
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ double clamp_nan(double v, double lo, double hi) {
  return v != v ? v : fmin(fmax(v, lo), hi);
}

__device__ __forceinline__ double clamp_diag(double v) { return clamp_nan(v, 1e-12, 1e32); }

__device__ __forceinline__ long long global_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

// Where a warp's sums of a pose go: this warp's copy of the block's window
// of poses [p0, p0 + window) in shared memory, `stride` values a pose (no two
// lanes of the warp add to one address at once), or for a pose outside it a
// float64 global atomic at global(pose, j)
template <typename Global>
struct PoseSink {
  double* win;
  long long p0;
  int window, stride;
  Global global;
  __device__ __forceinline__ void add(long long pose, int j, double v) const {
    const long long rel = pose - p0;
    if (rel >= 0 && rel < window)
      win[rel * stride + j] += v;
    else
      atomicAdd(global(pose, j), v);
  }
};

// Adds the first N of a lane's V values (V a power of two, the rest 0) to pose
// `key` (key < 0: nothing, and the lane's values are 0). Every lane of the
// warp calls it.
template <int N, int V, typename Sink>
__device__ __forceinline__ void add_keyed(long long key, double (&v)[V], const Sink& sink) {
  const unsigned valid = __ballot_sync(kFull, key >= 0);
  if (valid == 0u) return;
  const long long k0 = __shfl_sync(kFull, key, __ffs(valid) - 1);
  const int lane = threadIdx.x & 31;
  if (__all_sync(kFull, key < 0 || key == k0)) {
    const double t = reduce_scatter<V>(v);
    const int j = lane >> scatter_shift<V>();
    if ((lane & ((1 << scatter_shift<V>()) - 1)) == 0 && j < N) sink.add(k0, j, t);
  } else {
    const unsigned peers = __match_any_sync(kFull, key);
    reduce_peers<N>(peers, v);
    if (key >= 0 && lane == __ffs(peers) - 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) sink.add(key, j, v[j]);
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

// A thread's running sums of the rows pass over its rows, in registers (a
// warp reduction a row is a chain of shuffles the block's 8 warps cannot
// hide): the g and diagonal of its rows' begin pose and end pose while they
// stay the same pose (14 values each, 2 unused), and of its family's first 16
// constant columns (g 0-15, diagonal 16-31)
struct RowSums {
  long long kb = -1, ke = -1;
  double b[16], e[16], c[32];
};

// Adds a pose's sums acc (key < 0: none, and acc is 0) over the warp and
// clears them; every lane of the warp calls it
template <typename Sink>
__device__ __forceinline__ void flush_pose(const Sink& cam, long long& key, double (&acc)[16]) {
  add_keyed<kPoseSums>(key, acc, cam);
  key = -1;
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0;
}

// Adds the family's constant-column sums of every lane of the warp into the
// warp's copy in shared memory (cst: g at 0, diagonal at max_const) and
// clears them; every lane calls it
__device__ __forceinline__ void flush_consts(double (&c)[32], double* cst, int nconst,
                                             int max_const) {
  const int lane = threadIdx.x & 31;
  const double t = reduce_scatter<32>(c);
  const int col = lane & 15;
  if (col < nconst) cst[(lane < 16 ? 0 : max_const) + col] += t;
#pragma unroll
  for (int j = 0; j < 32; ++j) c[j] = 0.0;
}

// The rows pass over one tile's rows (K components a row), a lane a row: the
// pose and constant-column sums into the thread's running sums, the points'
// sums by global atomics
template <int K, typename T, typename Sink>
__device__ __forceinline__ void rows_tile(const Params<T>& p, const Family& f, const Tile<T>& s,
                                          int rows, const Sink& cam, double* cst, RowSums& sum) {
  const int lane = threadIdx.x & 31;
  const long long C = p.total;
  const int b = f.b, nconst = f.j_cam ? b - kFirstConst : 0;
  for (int rb = (threadIdx.x >> 5) * 32; rb < rows; rb += blockDim.x) {
    const int row = rb + lane;
    const bool valid = row < rows;
    double rr[K];
#pragma unroll
    for (int i = 0; i < K; ++i)
      rr[i] = (valid && s.r) ? static_cast<double>(s.r[row * K + i]) : 0.0;
    if (f.j_cam) {
      const T* J = s.jc + (valid ? row : 0) * K * b;
      const long long kb = valid ? s.beg[row] : -1;
      // one pose: its two sides go to the begin pose's sums
      const long long ke = valid && s.end[row] != kb ? s.end[row] : -1;
      // where a lane's pose changes, the warp adds its sums first
      if (__any_sync(kFull, kb >= 0 && sum.kb >= 0 && kb != sum.kb)) flush_pose(cam, sum.kb, sum.b);
      if (__any_sync(kFull, ke >= 0 && sum.ke >= 0 && ke != sum.ke)) flush_pose(cam, sum.ke, sum.e);
      if (valid) {
        sum.kb = kb;
        if (ke >= 0) sum.ke = ke;
#pragma unroll
        for (int j = 0; j < kPoseCols; ++j) {
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const double a = J[i * b + j], c = J[i * b + kPoseCols + j];
            sum.b[j] += a * rr[i];
            sum.b[kPoseCols + j] += a * a;
            if (ke >= 0) {
              sum.e[j] += c * rr[i];
              sum.e[kPoseCols + j] += c * c;
            } else {
              sum.b[j] += c * rr[i];
              sum.b[kPoseCols + j] += c * c;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j < nconst) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const double a = J[i * b + kFirstConst + j];
              sum.c[j] += a * rr[i];
              sum.c[16 + j] += a * a;
            }
          }
        }
      }
      // constant columns past the first 16 (rpc's coefficients): a warp
      // reduction a row group
      for (int c0 = 16; c0 < nconst; c0 += 16) {
        double v[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          double g = 0.0, d = 0.0;
          if (valid && c0 + j < nconst) {
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const double a = J[i * b + kFirstConst + c0 + j];
              g += a * rr[i];
              d += a * a;
            }
          }
          v[j] = g;
          v[16 + j] = d;
        }
        const double t = reduce_scatter<32>(v);
        const int c = c0 + (lane & 15);
        if (c < nconst) cst[(lane < 16 ? 0 : p.max_const) + c] += t;
      }
    }
    if (f.j_pt) {
      double v[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) v[j] = 0.0;
      if (valid) {
        const T* P = s.jp + row * K * 3;
        double q[K][3];
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int m = 0; m < 3; ++m) q[i][m] = P[i * 3 + m];
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
      add_point(p.acc + 2 * C, p.acc + 2 * C + 3 * p.num_points, valid ? s.pidx[row] : -1, v);
    }
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
    for (int i = 0; i < K; ++i)
      jb[i][c] = static_cast<double>(J[i * b + side * kPoseCols + c]) * fp;
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

// The blocks pass over one tile's rows of a family with a camera block
template <int K, typename T, typename Sink>
__device__ __forceinline__ void blocks_tile(const Params<T>& p, const Family& f, const Tile<T>& s,
                                            int rows, const Sink& blk) {
  const int lane = threadIdx.x & 31;
  const int b = f.b;
  const bool pt = f.j_pt != nullptr;
  for (int rb = (threadIdx.x >> 5) * 32; rb < rows; rb += blockDim.x) {
    const int row = rb + lane;
    const bool valid = row < rows;
    const T* J = s.jc + (valid ? row : 0) * K * b;
    const long long kb = valid ? s.beg[row] : -1, ke = valid ? s.end[row] : -1;
    double Jp[K][3], H[9];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int m = 0; m < 3; ++m) Jp[i][m] = 0.0;
#pragma unroll
    for (int j = 0; j < 9; ++j) H[j] = 0.0;
    if (valid && pt) {
      const T* P = s.jp + row * K * 3;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m) Jp[i][m] = P[i * 3 + m];
      // written by this launch's points pass: read from L2
      const double* h = p.hinv + s.pidx[row] * 9;
#pragma unroll
      for (int j = 0; j < 9; ++j) H[j] = __ldcg(h + j);
    }
    double bb[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) bb[j] = 0.0;
    const bool merged = valid && kb == ke;
    if (valid) side_block<K>(J, b, 0, kb, p.cf, pt, Jp, H, bb);
    if (merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);
    add_keyed<kBlock>(kb, bb, blk);
#pragma unroll
    for (int j = 0; j < 32; ++j) bb[j] = 0.0;
    if (valid && !merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);
    add_keyed<kBlock>(valid && !merged ? ke : -1ll, bb, blk);
  }
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

// Gauss-Jordan inverse of a 7x7 block by one warp: lane i < 7 holds row i of
// [A | I] (a, inv) in registers. For each column the pivot is the largest
// |entry| at or below the diagonal, the lowest row on ties (the partial
// pivoting of LU, as a scan with strict > picks it), found by a shuffle
// arg-max; the rows swap by shuffles, the pivot row is scaled and broadcast,
// and every other lane eliminates. Returns false (in every lane) where a
// pivot is 0 or NaN.
__device__ __forceinline__ bool invert7_warp(double (&a)[7], double (&inv)[7]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int col = 0; col < 7; ++col) {
    if (__shfl_sync(kFull, a[col], col) != __shfl_sync(kFull, a[col], col)) return false;
    double v = lane >= col && lane < 7 ? fabs(a[col]) : -1.0;
    if (v != v) v = -1.0;
    int at = lane;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const double ov = __shfl_xor_sync(kFull, v, o);
      const int oat = __shfl_xor_sync(kFull, at, o);
      if (ov > v || (ov == v && oat < at)) {
        v = ov;
        at = oat;
      }
    }
    if (!(v > 0.0)) return false;
    if (at != col) {
      const int src = lane == col ? at : lane == at ? col : lane;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        a[j] = __shfl_sync(kFull, a[j], src);
        inv[j] = __shfl_sync(kFull, inv[j], src);
      }
    }
    const double s = 1.0 / __shfl_sync(kFull, a[col], col);
    if (lane == col) {
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        a[j] *= s;
        inv[j] *= s;
      }
    }
    double pa[7], pi[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      pa[j] = __shfl_sync(kFull, a[j], col);
      pi[j] = __shfl_sync(kFull, inv[j], col);
    }
    const double m = a[col];
    if (lane < 7 && lane != col && m != 0.0) {
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        a[j] -= m * pa[j];
        inv[j] -= m * pi[j];
      }
    }
  }
  return true;
}

// A block's state over the passes: its span of tiles, the window of poses
// its warps sum into, its constant-column copies
template <typename T>
struct Block {
  const Params<T>& p;
  unsigned char* smem;
  long long c0, c1, p0;
  int tiles, cur;

  __device__ Block(const Params<T>& q, unsigned char* sm) : p(q), smem(sm) {
    block_span(p.f, p.count, p.weight, blockIdx.x, gridDim.x, c0, c1);
    tiles = locate(p.f, p.count, c0, c1, p.tile_rows, -1).rows;
    p0 = 0;
    if (p.window < p.num_ref && tiles > 0) {
      const TileRef t0 = locate(p.f, p.count, c0, c1, p.tile_rows, 0);
      if (p.f[t0.f].j_cam) {
        const long long first = p.f[t0.f].beg[t0.row0];
        p0 = first < 0 ? 0 : first > p.num_ref - p.window ? p.num_ref - p.window : first;
      }
    }
    cur = -1;
  }

  __device__ double* window(int stride) const {
    return reinterpret_cast<double*>(smem) + (threadIdx.x >> 5) * p.window * stride;
  }
  __device__ double* consts() const {
    return reinterpret_cast<double*>(smem + p.off_const) + (threadIdx.x >> 5) * 2 * p.max_const;
  }

  // the warps' copies start at 0 (the window, p.stride values a pose, and
  // the constants)
  __device__ void zero() const {
    double* w = reinterpret_cast<double*>(smem);
    for (int i = threadIdx.x; i < kWarps * p.window * p.stride; i += blockDim.x) w[i] = 0.0;
    double* c = reinterpret_cast<double*>(smem + p.off_const);
    for (int i = threadIdx.x; i < kWarps * 2 * p.max_const; i += blockDim.x) c[i] = 0.0;
    __syncthreads();
  }

  // adds the warps' window copies to the global sums (global(pose, j)) and
  // clears them
  template <typename Global>
  __device__ void flush_window(int stride, Global global) const {
    __syncthreads();
    double* w = reinterpret_cast<double*>(smem);
    const int size = p.window * stride;
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
      double v = 0.0;
      for (int k = 0; k < kWarps; ++k) {
        v += w[k * size + i];
        w[k * size + i] = 0.0;
      }
      if (v != 0.0) atomicAdd(global(p0 + i / stride, i % stride), v);
    }
    __syncthreads();
  }

  // at a change of family in the rows pass: the last family's constant
  // columns' sums (the threads' running sums c, then the warps' copies) added
  // to acc
  __device__ void on_family(int fi, double (&c)[32]) {
    if (fi == cur) return;
    if (cur >= 0 && p.f[cur].j_cam)
      flush_consts(c, consts(), p.f[cur].b - kFirstConst, p.max_const);
    __syncthreads();
    if (cur >= 0 && p.f[cur].j_cam) {
      const Family& f = p.f[cur];
      double* c = reinterpret_cast<double*>(smem + p.off_const);
      for (int i = threadIdx.x; i < f.b - kFirstConst; i += blockDim.x) {
        double g = 0.0, d = 0.0;
        for (int k = 0; k < kWarps; ++k) {
          g += c[k * 2 * p.max_const + i];
          d += c[k * 2 * p.max_const + p.max_const + i];
          c[k * 2 * p.max_const + i] = c[k * 2 * p.max_const + p.max_const + i] = 0.0;
        }
        const long long col = __ldg(f.cols + i);
        if (g != 0.0) atomicAdd(p.acc + col, g);
        if (d != 0.0) atomicAdd(p.acc + p.total + col, d);
      }
    }
    cur = fi;
    __syncthreads();
  }

  template <typename Body>
  __device__ void walk(bool reverse, int resident, Body body) const {
    row_tiles::walk(
        tiles, reverse, resident, p.slots, p.slot_bytes, smem + p.off_ring,
        [&](int i) { return locate(p.f, p.count, c0, c1, p.tile_rows, i); },
        [&](const TileRef& t, unsigned char* slot) { issue_tile(p, t, slot); }, body);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) assembly_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long C = p.total, P = p.num_points, R = p.num_ref;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool rows = p.passes & kRows, points = p.passes & kPoints, blocks = p.passes & kBlocks,
             poses = p.passes & kPoses;
  // the LM loop has stopped: written by an earlier launch on the stream, so
  // every block reads the same value before the first grid barrier
  if (p.halt && *p.halt) return;
  long long* const mark = p.marks && threadIdx.x == 0 ? p.marks + blockIdx.x * kMarks : nullptr;
  if (mark) mark[0] = global_timer();
  Block<T> blk(p, smem);

  // several shards: the launch's own sums start at 0
  if (p.zero_first) {
    if (rows)
      for (long long i = gt; i < 2 * C + 9 * P; i += gs) p.acc[i] = 0.0;
    if (blocks)
      for (long long i = gt; i < R * kBlock; i += gs) p.blocks[i] = 0.0;
    if (rows || blocks) grid.sync();
  }

  if (rows) {
    blk.zero();                    // the blocks pass's layout too: shared memory starts undefined
    auto global = [&](long long pose, int j) {
      return p.acc + (j < kPoseCols ? 0 : C) + pose * kPoseCols + j % kPoseCols;
    };
    const PoseSink<decltype(global)> cam{blk.window(kPoseSums), blk.p0, p.window, kPoseSums,
                                         global};
    double* const cst = blk.consts();
    RowSums sum;
#pragma unroll
    for (int j = 0; j < 16; ++j) sum.b[j] = sum.e[j] = 0.0;
#pragma unroll
    for (int j = 0; j < 32; ++j) sum.c[j] = 0.0;
    blk.walk(false, 0, [&](const TileRef& t, unsigned char* slot) {
      blk.on_family(t.f, sum.c);
      const Family& f = p.f[t.f];
      const Tile<T> s = tile_in<T>(f, p.tile_rows, slot);
      if (f.k == 2)
        rows_tile<2>(p, f, s, t.rows, cam, cst, sum);
      else
        rows_tile<3>(p, f, s, t.rows, cam, cst, sum);
    });
    flush_pose(cam, sum.kb, sum.b);
    flush_pose(cam, sum.ke, sum.e);
    blk.on_family(-1, sum.c);
    blk.flush_window(kPoseSums, global);
    if (mark) mark[1] = global_timer();
    if (points || blocks || poses) grid.sync();
  }

  if (points) {
    const double lam = ld(p.lam);
    double* const gp = p.acc + 2 * C;
    double* const hs = gp + 3 * P;
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
      double g[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = __ldcg(gp + i * 3 + j);
      if (p.g_p)
#pragma unroll
        for (int j = 0; j < 3; ++j) p.g_p[i * 3 + j] = static_cast<T>(g[j]);
      if (p.clear) {
#pragma unroll
        for (int j = 0; j < 3; ++j) gp[i * 3 + j] = 0.0;
#pragma unroll
        for (int j = 0; j < 6; ++j) hs[i * 6 + j] = 0.0;
      }
    }
    for (long long j = gt; j < C; j += gs) {
      const double cd = clamp_diag(__ldcg(p.acc + C + j)), cf = ld(p.cf + j);
      const double dc = lam * cd * cf + (1.0 - cf);
      p.cam_diag[j] = static_cast<T>(cd);
      p.dc[j] = static_cast<T>(dc);
      p.precond[j] = static_cast<T>(1.0 / (cd * cf + dc));
      if (p.g_c) p.g_c[j] = static_cast<T>(__ldcg(p.acc + j) * cf);
      if (p.clear) {
        p.acc[j] = 0.0;
        // the poses pass reads the pose columns' diagonal again, and clears it
        if (!poses || j >= kPoseCols * R) p.acc[C + j] = 0.0;
      }
    }
    if (mark) mark[2] = global_timer();
    if (blocks || poses) grid.sync();
  }

  if (blocks) {
    if (!rows) blk.zero();
    auto global = [&](long long pose, int j) { return p.blocks + pose * kBlock + j; };
    const PoseSink<decltype(global)> sink{blk.window(kBlock), blk.p0, p.window, kBlock, global};
    // the rows pass's last tiles are still in the ring: walk back from them
    blk.walk(true, rows ? min(blk.tiles, p.slots) : 0, [&](const TileRef& t, unsigned char* slot) {
      const Family& f = p.f[t.f];
      if (!f.j_cam) return;              // uniform over the block: a tile is of one family
      const Tile<T> s = tile_in<T>(f, p.tile_rows, slot);
      if (f.k == 2)
        blocks_tile<2>(p, f, s, t.rows, sink);
      else
        blocks_tile<3>(p, f, s, t.rows, sink);
    });
    blk.flush_window(kBlock, global);
    if (mark) mark[3] = global_timer();
    if (poses) grid.sync();
  }

  if (poses) {
    const double lam = ld(p.lam);
    const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
    const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
    const bool row = lane < 7;
    for (long long r = gwarp; r < R; r += nwarps) {
      double a[7], inv[7];
      const long long col = r * kPoseCols + lane;
      double* const bk = p.blocks + r * kBlock;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        a[j] = row ? __ldcg(bk + (lane <= j ? sym7(lane, j) : sym7(j, lane))) : 0.0;
        inv[j] = row && j == lane ? 1.0 : 0.0;
      }
      if (row) {
        const double cf = ld(p.cf + col);
        const double d = lam * clamp_diag(__ldcg(p.acc + C + col)) * cf + (1.0 - cf);
#pragma unroll
        for (int j = 0; j < 7; ++j)
          if (j == lane) a[j] += d;
      }
      __syncwarp();
      if (p.clear && row) {
        for (int j = lane; j < 7; ++j) bk[sym7(lane, j)] = 0.0;
        p.acc[C + col] = 0.0;
      }
      const bool ok = invert7_warp(a, inv);
      if (!ok && lane == 0) *p.singular = 1;
      if (row) {
#pragma unroll
        for (int j = 0; j < 7; ++j)
          p.pose_inv[r * 49 + lane * 7 + j] = static_cast<T>(ok ? inv[j] : 0.0);
      }
    }
    if (mark) mark[4] = global_timer();
  }
}

// Per-device launch state: SM count, co-resident blocks an SM (float, double)
struct DeviceState {
  int sms = 0;
  int blocks[2] = {0, 0};
};
DeviceState g_devices[64];

template <typename T>
cudaError_t run(const long long* table, int families, int passes, int zero_first,
                const void* cf, const void* lam, long long num_points, long long total,
                long long num_ref, double* acc, double* blocks, double* hinv, void* g_c,
                void* g_p, void* hpp, void* cam_diag, void* pt_diag, void* hpp_inv, void* dc,
                void* precond, void* pose_inv, int* singular, const int* halt, long long* marks,
                long long* info, cudaStream_t stream) {
  if (families < 0 || families > kMaxFamilies) return cudaErrorInvalidValue;
  Params<T> p{};
  p.halt = halt;
  p.count = families;
  p.passes = passes;
  p.zero_first = zero_first;
  p.clear = !zero_first;
  const int elem = sizeof(T);
  long long chunks = 0, weight = 0;
  int max_const = 0;
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
    // an empty family's tensors may have no storage (null pointers)
    if (f.k < 2 || f.k > 3 || f.n < 0 || (f.j_cam && f.b < kFirstConst) ||
        (f.n > 0 && !f.j_cam && !f.j_pt))
      return cudaErrorInvalidValue;
    f.first_chunk = chunks;
    chunks += (f.n + kChunk - 1) / kChunk;
    f.weight = (f.j_cam ? static_cast<long long>(f.k) * f.b * elem + 16 : 0) +
               (f.j_pt ? 3ll * f.k * elem + 8 : 0) + (f.r ? static_cast<long long>(f.k) * elem : 0);
    weight += (f.n + kChunk - 1) / kChunk * kChunk * f.weight;
    if (f.j_cam) max_const = std::max(max_const, f.b - kFirstConst);
  }
  p.weight = weight;
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
  p.marks = marks;
  if ((passes & kBlocks) && !hinv) return cudaErrorInvalidValue;
  if ((passes & kPoses) && !singular) return cudaErrorInvalidValue;
  // shared memory: the warps' window copies (28 values a pose where the
  // blocks pass runs; the rows pass uses 14), their constant-column copies,
  // the ring
  p.window = static_cast<int>(std::min<long long>(num_ref, kWindow));
  p.stride = (passes & kBlocks) ? kBlock : kPoseSums;
  p.max_const = max_const;
  p.off_const = align16(8ll * kWarps * p.window * p.stride);
  p.off_ring = p.off_const + align16(8ll * kWarps * 2 * max_const);
  const int avail = kSmem - p.off_ring;
  auto slot_bytes = [&](int rows) {
    int most = 0;
    for (int i = 0; i < families; ++i) most = std::max(most, slot_layout(p.f[i], rows, elem).bytes);
    return most;
  };
  int rows = 512;
  while (rows > 8 && 3ll * slot_bytes(rows) > avail) rows -= rows > 64 ? 32 : 8;
  if (3ll * slot_bytes(rows) > avail) return cudaErrorInvalidValue;
  p.tile_rows = rows;
  p.slot_bytes = std::max(slot_bytes(rows), 16);
  p.slots = avail / p.slot_bytes;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceState& ds = g_devices[dev];
  int& nb = ds.blocks[elem == 8];
  if (nb == 0) {
    err = cudaDeviceGetAttribute(&ds.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(assembly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, assembly_kernel<T>, kThreads, kSmem);
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorCooperativeLaunchTooLarge;
  }
  const int grid = nb * ds.sms;
  if (info) {
    // the rows the blocks pass finds in shared memory, and the bytes of rows
    // the launch reads from device memory
    long long resident = 0, read = 0;
    for (int g = 0; g < grid; ++g) {
      long long a, b;
      block_span(p.f, families, p.weight, g, grid, a, b);
      const int tiles = locate(p.f, families, a, b, rows, -1).rows;
      const int kept = std::min(tiles, p.slots);
      for (int i = 0; i < tiles; ++i) {
        const TileRef t = locate(p.f, families, a, b, rows, i);
        const long long bytes = static_cast<long long>(t.rows) * p.f[t.f].weight;
        const bool again = (passes & kBlocks) && p.f[t.f].j_cam;
        if (passes & kRows) read += bytes;
        if (again && (passes & kRows) && i >= tiles - kept) resident += t.rows;
        else if (again) read += bytes;
      }
    }
    info[0] = grid;
    info[1] = kThreads;
    info[2] = kSmem;
    info[3] = p.window;
    info[4] = rows;
    info[5] = p.slots;
    info[6] = chunks;
    info[7] = resident;
    info[8] = read;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
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
// rows pass (sums into acc [2 total + 9 num_points] float64), 2 the points
// pass (reads acc, lam [1] and cam_free [total]; writes hpp, pt_diag,
// hpp_inv, cam_diag, dc, precond, and g_c, g_p where not null; hinv [9
// num_points] float64 where not null), 4 the blocks pass (reads hinv and
// cam_free; sums into blocks [28 num_ref] float64), 8 the poses pass (reads
// blocks, acc, lam, cam_free; writes pose_inv [num_ref,7,7] and sets
// *singular to 1 on a zero pivot). `halt` (null: never): where *halt is set
// the launch returns at once (the LM loop has stopped). `zero_first`: 1, the launch zeroes acc
// (rows pass) and blocks (blocks pass) first; 0, it finds them at 0 and
// leaves them at 0 after reading them (the launch of every pass: the caller
// allocates them zeroed once). `marks` (null: not asked) receives 5
// %globaltimer stamps a block: its start and the end of each pass it ran.
// `info` (null: not asked) receives the grid, the threads a block, the
// dynamic shared memory, the poses of the warps' window copies, the rows a
// tile, the ring's slots, the chunks of 32 rows, the rows the blocks pass
// found in shared memory and the bytes of rows the launch read from device
// memory.
extern "C" int mv_lm_assembly(int elem, const long long* table, int families, int passes,
                              int zero_first, const void* cam_free, const void* lam,
                              long long num_points, long long total, long long num_ref,
                              double* acc, double* blocks, double* hinv, void* g_c, void* g_p,
                              void* hpp, void* cam_diag, void* pt_diag, void* hpp_inv, void* dc,
                              void* precond, void* pose_inv, int* singular, const int* halt,
                              long long* marks, long long* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes < 1 || passes > 15) return cudaErrorInvalidValue;
  if (elem == 4)
    return run<float>(table, families, passes, zero_first, cam_free, lam, num_points, total,
                      num_ref, acc, blocks, hinv, g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc,
                      precond, pose_inv, singular, halt, marks, info, s);
  if (elem == 8)
    return run<double>(table, families, passes, zero_first, cam_free, lam, num_points, total,
                       num_ref, acc, blocks, hinv, g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc,
                       precond, pose_inv, singular, halt, marks, info, s);
  return cudaErrorInvalidValue;
}
