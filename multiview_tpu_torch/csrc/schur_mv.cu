// The Schur complement matvec of the bundle adjustment's conjugate gradients
// (multiview_tpu_torch/solver/schur.py, linear_solver "cg_blocks"), for Hopper
// (sm_90a). It replaces the eager composition of gathers, batched block
// products and index_add_ that the port ran per matvec, the counterpart of
// multiview_tpu/solver/schur.py:1147 (XLA code: the JAX package has no
// pallas_call there). Over the residual families of one shard:
//
//   S x = cam_free * J_c^T (u - J_p Hpp^-1 J_p^T u) + dc * x,   u = J_c (cam_free * x)
//
// Row n of a family has a camera block J_c[n] [k, b] (pixel rows k = 2, depth
// rows k = 3, the row loops compiled for each; columns: its bracket's begin
// pose 7, end pose 7, then the family's b - 14 constant columns) and, where
// it touches a point, a point block J_p[n] [k, 3]. A family without a camera block (the xyz priors) adds
// nothing to S x and is left out of the table; one without a point block
// (depth against the mesh) skips the point side.
//
// One persistent, cooperative launch (cudaLaunchKernelEx with the cooperative
// attribute; a grid of the blocks that fit on the card at once, one an SM):
//   phase 0       g_p = 0; out = dc * x (0 without dc)
//   grid barrier
//   point pass    g_p[p] += J_p[n]^T u_n;  u_n stored (3 MB at the cube, coalesced)
//   grid barrier
//   points        w[p] = Hpp^-1[p] g_p[p], once a point
//   grid barrier
//   camera pass   v_n = u_n - J_p[n] w[p];  out[c] += cam_free[c] (J_c^T v)[c]
// The epilogue is folded into the camera pass: out starts at dc * x and each
// sum is added scaled by its column's cam_free. Which launch runs what:
//   one shard:    a whole CG solve of cg_blocks is one launch of
//                 cg_solve_kernel (below): the right-hand side, every step's
//                 matvec and update, the back-substitution's product and,
//                 where asked, the LM iteration's trial point. Called
//                 alone, S x is one launch of both passes of schur_kernel; the
//                 right-hand side one launch of the camera pass with u = 0 (x
//                 null, dc null); the back-substitution's product one launch
//                 of the point pass with u stored.
//   more shards:  a shard's g_p must be summed over the shards (and the
//                 processes) between the passes (ShardMesh.sum in
//                 solver/schur_matvec.py), so S x is a point-pass launch and
//                 a camera-pass launch a shard (dc * x added on the first
//                 shard of all only; the shards' outs summed).
//
// Rows (row_tiles.cuh). Each block walks a contiguous span of 32-row chunks,
// family by family, in tiles of tile_rows rows (one thread a row), staged into
// shared memory with 16-byte cp.async copies (J_c, J_p, beg, end, pidx of the tile: each one
// contiguous span), two tiles in flight while a third is computed. The tiles
// go round a ring of `slots` slots that fills the block's shared memory, so
// when the point pass ends its last `slots` tiles are still there: the camera
// pass takes those first, from shared memory, then rereads the others in the
// reverse order of the point pass, so that the rows the point pass read last
// (the likeliest to be still in the 50 MB L2) come first.
//
// In the LM loop the table holds half 0 of the loop's current and trial
// halves (solver/lm_step.py::Halves): each tile's copy reads the state's
// `sel` (an __ldg, cached) and fetches J from the half it picks (`half` bytes
// on a half).
//
// Sums. The camera pass's, in each thread's registers over its rows: a row
// whose begin and end pose are one pose adds its two 7-column halves first
// (every row of the benchmark's cube, every dt_bracket = 0 row); a thread
// keeps running sums of its begin pose's and its end pose's columns while
// they stay the same pose, and of its family's first 16 constant columns.
// Where a lane's pose changes, its warp adds its sums (a reduce-scatter of 9
// shuffles where the warp's lanes share a pose, else a tree of shuffles over
// the lanes of each pose and one add a pose) into
// the block's copy of g_c's pose columns in shared memory (the whole of them
// where they fit, else a window of poses from the block's first row; a pose
// outside it adds to out with a global atomic; where the pose columns are
// few, each warp has a copy of its own, so that only a warp's lanes contend
// for an address); the block adds its copies to out once, at the end. The
// constant columns: at the end of a family, a reduce-scatter a warp, a block
// sum in shared memory, one global atomic a block and column. Point columns: rows of one point that lie together
// (calibrate's track-major rows) are summed by a segmented warp scan first,
// then one atomic a run and column. Right in any row order; atomics make the
// order of the sums, and the last bits, vary from run to run (as index_add_
// on the card does).
//
// Why so: the camera pass, with 8 warps an SM, is bound by the latency of
// its instructions, not by its bytes (per-phase SM clocks on the card: the
// tiles were always in shared memory before they were needed). So it reads
// u and w back (5 values a row) instead of rebuilding them (85 loads and
// multiply-adds), keeps its sums in registers instead of a warp reduction
// a row (a chain of shuffles, with shared-memory float atomics that are
// compare-and-swap loops), and compiles its row loop for k = 2 and k = 3.
//
// Bound: bytes. A matvec must read J_c, J_p and the row indices once (at the
// benchmark's 384000 float32 pixel rows 89.1 + 9.2 + 9.2 MB: 32 us at 3.35
// TB/s); its 4 N k b operations are far below the FP32 rate. This design reads
// them once from device memory in the point pass and again in the camera pass
// for the rows that did not stay in shared memory (132 SMs hold about 29 MB:
// all of calibrate's systems, a fifth of the cube's rows), part of those from
// L2, and writes and reads u (2 x 3 MB at the cube): its ceiling is that
// traffic and three grid barriers. On the card (chip_smoke.py phase 3c, SM
// clocks) the cube's point pass streams its 108 MB at about 2.9 TB/s (37 us),
// the barriers, phase 0 and the per-point phase take about 10 us, and the
// camera pass, bound by its instructions' latency, the rest (about 50 us of
// 0.097 ms against the bound's 0.032 ms).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "cg_step.cuh"
#include "lm_trial.cuh"
#include "row_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxFamilies = 32;   // families of one launch (the wrapper refuses more)
constexpr int kFields = 10;        // int64 fields of one family in the host table
constexpr int kThreads = 256;      // threads of a block
using row_tiles::align16;
using row_tiles::block_span;
using row_tiles::kChunk;
using row_tiles::locate;
using row_tiles::TileRef;
constexpr int kPoseCols = 7;
constexpr int kFirstConst = 14;    // camera columns before the constant ones
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmem = 230400;      // dynamic shared memory a block (sm_90: 227 KB at most)
constexpr int kXBudget = 48 * 1024;  // x * cam_free kept whole in shared memory up to this
constexpr int kGBudget = 32 * 1024;  // the pose-column copy of g_c (whole or a window)
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCopyBudget = 24 * 1024;  // a copy a warp where they all fit this
constexpr int kPointPass = 1, kCameraPass = 2;

struct Family {
  const void* j_cam;        // [n, k, b]
  const void* j_pt;         // [n, k, 3], or null: the family touches no point
  const long long* beg;     // [n] pose of each row's bracket begin
  const long long* end;     // [n] pose of its end
  const long long* cols;    // [b - 14] the family's constant columns
  const long long* pidx;    // [n] point of each row (null with j_pt)
  long long n;
  long long u_offset;       // first element of the family in the flat u
  long long first_chunk;    // the family's first 32-row chunk among all families'
  long long weight;         // bytes a row reads: the blocks' spans are even in bytes
  int k, b;
};

template <typename T>
struct Params {
  Family f[kMaxFamilies];
  int count;
  int passes;               // kPointPass | kCameraPass
  long long weight;         // the bytes of every family's 32-row chunks
  const T* x;               // null: u = 0
  const T* cf;              // [total] cam_free
  const T* dc;              // [total]; null: out starts at 0
  const T* hpp_inv;         // [num_points, 3, 3]
  T* g_p;                   // [num_points, 3]: the point pass's sum, the camera pass's input
  T* out;                   // [total]
  T* u_out;                 // null or [sum n k]: u stored by the point pass (and read
                            // back by the camera pass of the same launch)
  T* w;                     // [num_points, 3] scratch: Hpp^-1 g_p
  const int* halt;          // set: the launch returns at once (the LM loop's stop flag), or null
  const int* sel;           // the LM loop's current half of J (null: J as the table holds it)
  long long half;           // bytes from half 0 to half 1 of the LM loop's halves
  long long num_points, total, num_ref;
  int tile_rows, slots, full_x, wposes, copies, max_const;
  int off_xcf, off_g, off_const, off_slots, slot_bytes;
};

// The byte offsets of a tile's arrays in its slot: J_c, J_p, beg, end, pidx
struct SlotLayout {
  int jp, beg, end, pidx, bytes;
};

__host__ __device__ __forceinline__ SlotLayout slot_layout(int tile_rows, int k, int b,
                                                           bool with_pt, int elem) {
  SlotLayout l;
  l.jp = align16(static_cast<long long>(tile_rows) * k * b * elem);
  l.beg = l.jp + (with_pt ? align16(static_cast<long long>(tile_rows) * k * 3 * elem) : 0);
  l.end = l.beg + align16(tile_rows * 8ll);
  l.pidx = l.end + align16(tile_rows * 8ll);
  l.bytes = l.pidx + (with_pt ? align16(tile_rows * 8ll) : 0);
  return l;
}

template <typename T>
__device__ __forceinline__ void issue_tile(const Params<T>& p, const TileRef& t,
                                           unsigned char* slot) {
  // bytes from the table's J (half 0) to the current half's (the LM loop's sel)
  const long long off = p.sel ? static_cast<long long>(__ldg(p.sel)) * p.half : 0;
  const Family& f = p.f[t.f];
  const int kb = f.k * f.b;
  const SlotLayout l = slot_layout(p.tile_rows, f.k, f.b, f.j_pt != nullptr, sizeof(T));
  using row_tiles::copy_async;
  copy_async(slot, static_cast<const unsigned char*>(f.j_cam) + off + t.row0 * kb * sizeof(T),
             static_cast<long long>(t.rows) * kb * sizeof(T));
  copy_async(slot + l.beg, reinterpret_cast<const unsigned char*>(f.beg + t.row0), t.rows * 8ll);
  copy_async(slot + l.end, reinterpret_cast<const unsigned char*>(f.end + t.row0), t.rows * 8ll);
  if (f.j_pt) {
    copy_async(slot + l.jp,
               static_cast<const unsigned char*>(f.j_pt) + off + t.row0 * f.k * 3 * sizeof(T),
               static_cast<long long>(t.rows) * f.k * 3 * sizeof(T));
    copy_async(slot + l.pidx, reinterpret_cast<const unsigned char*>(f.pidx + t.row0),
               t.rows * 8ll);
  }
}

// Walks the block's tiles [c0, c1) through the ring (row_tiles::walk)
template <typename T, typename Body>
__device__ __forceinline__ void walk(const Params<T>& p, long long c0, long long c1, int tiles,
                                     bool reverse, int resident, unsigned char* slots, Body body) {
  row_tiles::walk(
      tiles, reverse, resident, p.slots, p.slot_bytes, slots,
      [&](int i) { return locate(p.f, p.count, c0, c1, p.tile_rows, i); },
      [&](const TileRef& t, unsigned char* slot) { issue_tile(p, t, slot); }, body);
}

// Sums V = 2^q values over the 32 lanes with a reduce-scatter: 16 / 2 + ... + 1
// shuffles in the halving rounds, one each in the others. Returns in lane l
// the warp's total of value (l >> (5 - q)); the lanes with
// l % 2^(5 - q) == 0 hold each total once.
template <int V, typename T>
__device__ __forceinline__ T reduce_scatter(T (&v)[V]) {
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
          const T send = upper ? v[i] : v[i + h];
          const T keep = upper ? v[i + h] : v[i];
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
__device__ __forceinline__ int scatter_index() {
  constexpr int q = V == 32 ? 5 : V == 16 ? 4 : V == 8 ? 3 : V == 4 ? 2 : V == 2 ? 1 : 0;
  return (threadIdx.x & 31) >> (5 - q);
}
template <int V>
__device__ __forceinline__ bool scatter_writer() {
  constexpr int q = V == 32 ? 5 : V == 16 ? 4 : V == 8 ? 3 : V == 4 ? 2 : V == 2 ? 1 : 0;
  return ((threadIdx.x & 31) & ((1 << (5 - q)) - 1)) == 0;
}

// What the passes read besides the tiles, copied once into registers (the
// kernel's parameters are read through a generic address, which a store or an
// atomic the compiler cannot tell apart from them makes it load again)
template <typename T>
struct Ctx {
  const T* __restrict__ x;        // null: u = 0
  const T* __restrict__ cf;
  const T* __restrict__ hpp_inv;
  T* g_p;
  T* w;
  T* out;
  const T* xcf;       // [total] x * cam_free in shared memory, or null: read from global
  T* g;               // [copies][wposes * 7] pose columns of poses p0 .. p0 + wposes, shared
  T* gw;              // this warp's copy (the one copy where there is one)
  T* cst;             // [max_const] the current family's constant columns' sums, shared
  T* xconst;          // [max_const] x * cam_free at them, shared
  long long p0;
  int wposes, copies;
};

// One tile's family, in registers
template <typename T>
struct Fam {
  const long long* cols;
  long long u_offset;
  int k, b, nconst;
  bool with_pt;
};

template <typename T>
__device__ __forceinline__ Fam<T> fam_of(const Family& f) {
  return {f.cols, f.u_offset, f.k, f.b, f.b - kFirstConst, f.j_pt != nullptr};
}

template <typename T>
__device__ __forceinline__ T xcf_at(const Ctx<T>& c, long long col) {
  // x may have been written by other blocks of this launch (the fused CG
  // solve's p): read it from L2
  return c.xcf ? c.xcf[col] : __ldcg(c.x + col) * __ldg(c.cf + col);
}

// u = J (cam_free * x) of one row, J [K, b] row-major
template <int K, typename T>
__device__ __forceinline__ void row_u(const Ctx<T>& c, const T* J, int b, long long beg,
                                      long long end, T (&u)[3]) {
  u[0] = u[1] = u[2] = T(0);
  const long long pose[2] = {beg * kPoseCols, end * kPoseCols};
#pragma unroll
  for (int side = 0; side < 2; ++side) {
#pragma unroll
    for (int j = 0; j < kPoseCols; ++j) {
      const T xv = xcf_at(c, pose[side] + j);
#pragma unroll
      for (int r = 0; r < K; ++r) u[r] += J[r * b + side * kPoseCols + j] * xv;
    }
  }
  for (int j = kFirstConst; j < b; ++j) {
    const T xv = c.xconst[j - kFirstConst];
#pragma unroll
    for (int r = 0; r < K; ++r) u[r] += J[r * b + j] * xv;
  }
}

template <typename T>
__device__ __forceinline__ void add_pose_col(const Ctx<T>& c, long long pose, int j, T v) {
  const long long rel = pose - c.p0;
  if (rel >= 0 && rel < c.wposes) {
    atomicAdd(c.gw + rel * kPoseCols + j, v);
  } else {
    const long long col = pose * kPoseCols + j;
    atomicAdd(c.out + col, __ldg(c.cf + col) * v);
  }
}

// Sums v over the lanes of `peers` (the lanes whose key equals this lane's)
// into the lowest of them, by a tree of shuffles: in each round a lane adds
// the value of the next remaining peer above it, and the peers of odd rank
// drop out. Every lane of the warp must call it.
template <typename T, int V>
__device__ __forceinline__ void reduce_peers(unsigned peers, T (&v)[V]) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, rest != 0u)) {
    const int next = __ffs(rest);            // 1 + the lane of the next peer above, 0 if none
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T t = __shfl_sync(kFull, v[i], src);
      if (next) v[i] += t;
    }
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// Adds a pose's 7 columns o[0..7) (o[7] = 0) to out and clears them; key < 0:
// nothing to add, and o is 0. Every lane of the warp calls it: a warp of one
// pose sums with a reduce-scatter first (9 shuffles); a warp of several poses
// (track-major rows) sums the lanes of each pose with a tree of shuffles, so
// that each pose is added once a warp, without lanes contending
template <typename T>
__device__ __forceinline__ void flush_pose(const Ctx<T>& c, long long& key, T (&o)[8]) {
  const unsigned valid = __ballot_sync(kFull, key >= 0);
  if (valid != 0u) {
    const long long k0 = __shfl_sync(kFull, key, __ffs(valid) - 1);
    if (__all_sync(kFull, key < 0 || key == k0)) {
      const T v = reduce_scatter<8>(o);
      const int j = scatter_index<8>();
      if (scatter_writer<8>() && j < kPoseCols) add_pose_col(c, k0, j, v);
    } else {
      const unsigned peers = __match_any_sync(kFull, key);
      reduce_peers(peers, o);
      if (key >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
#pragma unroll
        for (int j = 0; j < kPoseCols; ++j) add_pose_col(c, key, j, o[j]);
      }
    }
  }
  key = -1;
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = T(0);
}

// A thread's running sums of the camera pass over its rows, in registers
// (float atomics on shared memory are compare-and-swap loops, and a warp
// reduction a row is a chain of shuffles the 8 warps of a block cannot hide):
// the columns of its rows' begin pose and end pose while they stay the same
// pose, and the current family's first 16 constant columns.
template <typename T>
struct Sums {
  long long kb = -1, ke = -1;
  T b[8], e[8], c[16];
};

// Adds one row's columns o[0..7) of pose `key` (key < 0: none) to a running
// sum, flushing the warp's sums first where a lane's pose changes
template <typename T>
__device__ __forceinline__ void add_pose(const Ctx<T>& c, long long key, const T (&o)[8],
                                         long long& akey, T (&acc)[8]) {
  if (__any_sync(kFull, key >= 0 && akey >= 0 && key != akey)) flush_pose(c, akey, acc);
  if (key >= 0) {
    akey = key;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += o[j];
  }
}

// Adds v[0..3) to point `key`'s g_p (key < 0: nothing). Every lane calls it:
// runs of lanes with one point are summed by a segmented scan first.
template <typename T>
__device__ __forceinline__ void add_point(T* g_p, long long key, T (&v)[3]) {
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
      for (int j = 0; j < 3; ++j) {
        const T t = __shfl_down_sync(kFull, v[j], o);
        if (lane + o <= run_end) v[j] += t;
      }
    }
  }
  if (head) {
#pragma unroll
    for (int j = 0; j < 3; ++j) atomicAdd(g_p + key * 3 + j, v[j]);
  }
}

// The point pass over one tile's rows (K components a row): u stored where
// asked, J_p^T u added to g_p
template <int K, typename T>
__device__ __forceinline__ void point_rows(const Ctx<T>& c, int rows, int b, const T* jc,
                                           const T* jp, const long long* beg,
                                           const long long* end, const long long* pidx, T* u_dst,
                                           bool with_pt) {
  const int lane = threadIdx.x & 31, kb = K * b;
  for (int rb = (threadIdx.x >> 5) * 32; rb < rows; rb += blockDim.x) {
    const int r = rb + lane;
    const bool valid = r < rows;
    T u[3] = {T(0), T(0), T(0)};
    if (valid && c.x) row_u<K>(c, jc + r * kb, b, beg[r], end[r], u);
    if (valid && u_dst) {
#pragma unroll
      for (int i = 0; i < K; ++i) u_dst[r * K + i] = u[i];
    }
    if (with_pt) {
      T v[3] = {T(0), T(0), T(0)};
      if (valid) {
        const T* P = jp + r * K * 3;
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int i = 0; i < K; ++i) v[j] += P[i * 3 + j] * u[i];
      }
      add_point(c.g_p, valid ? pidx[r] : -1ll, v);
    }
  }
}

// The camera pass over one tile's rows (K components a row): v = u - J_p w,
// J_c^T v into the thread's running sums
template <int K, typename T>
__device__ __forceinline__ void camera_rows(const Ctx<T>& c, int rows, int b, int nconst,
                                            const T* jc, const T* jp, const long long* beg,
                                            const long long* end, const long long* pidx,
                                            const T* u_src, bool pt_side, Sums<T>& sum) {
  const int lane = threadIdx.x & 31, kb = K * b;
  for (int rb = (threadIdx.x >> 5) * 32; rb < rows; rb += blockDim.x) {
    const int r = rb + lane;
    const bool valid = r < rows;
    const T* J = jc + (valid ? r : 0) * kb;
    T v[3] = {T(0), T(0), T(0)};
    long long kb0 = -1, ke0 = -1;
    if (valid) {
      kb0 = beg[r];
      ke0 = end[r];
      T w[3] = {T(0), T(0), T(0)};
      if (pt_side) {
        const long long pt = pidx[r];
#pragma unroll
        for (int i = 0; i < 3; ++i) w[i] = __ldcg(c.w + pt * 3 + i);
      }
      if (u_src) {
#pragma unroll
        for (int i = 0; i < K; ++i) v[i] = __ldcg(u_src + r * K + i);
      } else if (c.x) {
        row_u<K>(c, J, b, kb0, ke0, v);
      }
      if (pt_side) {
        const T* P = jp + r * K * 3;
#pragma unroll
        for (int i = 0; i < K; ++i) v[i] -= P[3 * i] * w[0] + P[3 * i + 1] * w[1] + P[3 * i + 2] * w[2];
      }
    }
    T ob[8], oe[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ob[j] = oe[j] = T(0);
      if (valid && j < kPoseCols) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          ob[j] += J[i * b + j] * v[i];
          oe[j] += J[i * b + kPoseCols + j] * v[i];
        }
      }
    }
    if (kb0 == ke0) {
      // one pose: its two halves summed, the end side left empty
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ob[j] += oe[j];
        oe[j] = T(0);
      }
      ke0 = -1;
    }
    add_pose(c, kb0, ob, sum.kb, sum.b);
    add_pose(c, ke0, oe, sum.ke, sum.e);
    if (valid) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < nconst) {
#pragma unroll
          for (int i = 0; i < K; ++i) sum.c[j] += J[i * b + kFirstConst + j] * v[i];
        }
      }
    }
    // constant columns past the first 16 (rpc's coefficients): a warp
    // reduction a row
    for (int c0c = 16; c0c < nconst; c0c += 16) {
      T o[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j] = T(0);
        if (valid && c0c + j < nconst) {
#pragma unroll
          for (int i = 0; i < K; ++i) o[j] += J[i * b + kFirstConst + c0c + j] * v[i];
        }
      }
      const T total = reduce_scatter<16>(o);
      const int j = c0c + scatter_index<16>();
      if (scatter_writer<16>() && j < nconst) atomicAdd(c.cst + j, total);
    }
  }
}

// w = Hpp^-1 g of one point
template <typename T>
__device__ __forceinline__ void hpp_solve(const T* H, const T (&g)[3], T* w) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    w[r] = __ldg(H + 3 * r) * g[0] + __ldg(H + 3 * r + 1) * g[1] + __ldg(H + 3 * r + 2) * g[2];
}

// w = Hpp^-1 g_p, once a point, before the camera pass reads it (g_p summed
// by this launch's point pass: read from L2)
template <typename T>
__device__ __forceinline__ void solve_points(const Ctx<T>& c, long long num_points) {
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < num_points; i += gs) {
    const T g[3] = {__ldcg(c.g_p + i * 3), __ldcg(c.g_p + i * 3 + 1), __ldcg(c.g_p + i * 3 + 2)};
    hpp_solve(c.hpp_inv + i * 9, g, c.w + i * 3);
  }
}

// One block's state over the passes of a launch: its span of tiles, its
// sums in shared memory and the camera pass's running sums in registers.
// c.x (null: u = 0) and c.out are the caller's to set before each pass.
template <typename T>
struct Passes {
  const Params<T>& p;
  Ctx<T> c;
  unsigned char* slots;
  long long c0, c1;
  int tiles, cur;
  Fam<T> fc;
  Sums<T> sum;

  // xcf: x * cam_free kept whole in shared memory, or null
  __device__ Passes(const Params<T>& q, unsigned char* smem, const T* xcf) : p(q) {
    c.x = p.x;
    c.cf = p.cf;
    c.hpp_inv = p.hpp_inv;
    c.g_p = p.g_p;
    c.w = p.w;
    c.out = p.out;
    c.xcf = xcf;
    c.g = reinterpret_cast<T*>(smem + p.off_g);
    c.cst = reinterpret_cast<T*>(smem + p.off_const);
    c.xconst = c.cst + p.max_const;
    c.wposes = p.wposes;
    c.copies = p.copies;
    c.gw = c.g + (c.copies > 1 ? (threadIdx.x >> 5) * c.wposes * kPoseCols : 0);
    slots = smem + p.off_slots;
    block_span(p.f, p.count, p.weight, blockIdx.x, gridDim.x, c0, c1);
    tiles = locate(p.f, p.count, c0, c1, p.tile_rows, -1).rows;
    c.p0 = 0;
    if (c.wposes < p.num_ref && tiles > 0) {
      const TileRef t0 = locate(p.f, p.count, c0, c1, p.tile_rows, 0);
      const long long first = p.f[t0.f].beg[t0.row0];
      c.p0 = first < 0 ? 0 : first > p.num_ref - c.wposes ? p.num_ref - c.wposes : first;
    }
    cur = -1;
    fc = Fam<T>{};
#pragma unroll
    for (int j = 0; j < 16; ++j) sum.c[j] = T(0);
#pragma unroll
    for (int j = 0; j < 8; ++j) sum.b[j] = sum.e[j] = T(0);
  }

  // the tiles the next walk finds in shared memory (left there by the last)
  __device__ int resident() const { return min(tiles, p.slots); }

  // the block's pose-column copies and constant-column sums start at 0
  __device__ void zero_sums() {
    for (int i = threadIdx.x; i < c.copies * c.wposes * kPoseCols; i += blockDim.x) c.g[i] = T(0);
    for (int i = threadIdx.x; i < p.max_const; i += blockDim.x) c.cst[i] = T(0);
  }

  // the family of the next tile: its constant columns' x * cam_free (and, in
  // the camera pass, the previous family's sums added to out)
  __device__ void on_family(int fi, bool flush) {
    if (fi == cur) return;
    if (flush && cur >= 0) {
      // the threads' sums of the constant columns 0-15: a reduce-scatter a
      // warp, then shared memory
      const int i = scatter_index<16>();
      const T v = reduce_scatter<16>(sum.c);
      if (scatter_writer<16>() && i < fc.nconst) atomicAdd(c.cst + i, v);
#pragma unroll
      for (int j = 0; j < 16; ++j) sum.c[j] = T(0);
    }
    __syncthreads();
    if (flush && cur >= 0) {
      for (int i = threadIdx.x; i < fc.nconst; i += blockDim.x) {
        const long long col = fc.cols[i];
        atomicAdd(c.out + col, __ldg(c.cf + col) * c.cst[i]);
        c.cst[i] = T(0);
      }
    }
    cur = fi;
    if (fi >= 0) {
      fc = fam_of<T>(p.f[fi]);
      for (int i = threadIdx.x; i < fc.nconst; i += blockDim.x)
        c.xconst[i] = c.x ? xcf_at(c, fc.cols[i]) : T(0);
    }
    __syncthreads();
  }

  // g_p += J_p^T u over the block's rows, u = J_c (cam_free * x) stored in
  // u_out where it is not null
  __device__ void point_pass(int resident_tiles, T* u_out) {
    walk(p, c0, c1, tiles, false, resident_tiles, slots,
         [&](const TileRef& t, unsigned char* slot) {
      on_family(t.f, false);
      const int k = fc.k, b = fc.b;
      const SlotLayout l = slot_layout(p.tile_rows, k, b, fc.with_pt, sizeof(T));
      const T* jc = reinterpret_cast<const T*>(slot);
      const T* jp = reinterpret_cast<const T*>(slot + l.jp);
      const long long* beg = reinterpret_cast<const long long*>(slot + l.beg);
      const long long* end = reinterpret_cast<const long long*>(slot + l.end);
      const long long* pidx = reinterpret_cast<const long long*>(slot + l.pidx);
      T* const u_dst = u_out ? u_out + fc.u_offset + t.row0 * k : nullptr;
      if (k == 2)
        point_rows<2>(c, t.rows, b, jc, jp, beg, end, pidx, u_dst, fc.with_pt);
      else
        point_rows<3>(c, t.rows, b, jc, jp, beg, end, pidx, u_dst, fc.with_pt);
    });
    __syncthreads();
  }

  // out += cam_free * J_c^T (u - J_p w) over the block's rows, the tiles in
  // reverse; u read back from u_back (null: recomputed from c.x, or 0)
  __device__ void camera_pass(int resident_tiles, const T* u_back) {
    const bool with_gp = c.g_p != nullptr;
    walk(p, c0, c1, tiles, true, resident_tiles, slots, [&](const TileRef& t, unsigned char* slot) {
      on_family(t.f, true);
      const int k = fc.k, b = fc.b, nconst = fc.nconst;
      const bool pt_side = with_gp && fc.with_pt;
      const T* const u_src = u_back ? u_back + fc.u_offset + t.row0 * k : nullptr;
      const SlotLayout l = slot_layout(p.tile_rows, k, b, fc.with_pt, sizeof(T));
      const T* jc = reinterpret_cast<const T*>(slot);
      const T* jp = reinterpret_cast<const T*>(slot + l.jp);
      const long long* beg = reinterpret_cast<const long long*>(slot + l.beg);
      const long long* end = reinterpret_cast<const long long*>(slot + l.end);
      const long long* pidx = reinterpret_cast<const long long*>(slot + l.pidx);
      if (k == 2)
        camera_rows<2>(c, t.rows, b, nconst, jc, jp, beg, end, pidx, u_src, pt_side, sum);
      else
        camera_rows<3>(c, t.rows, b, nconst, jc, jp, beg, end, pidx, u_src, pt_side, sum);
    });
    flush_pose(c, sum.kb, sum.b);
    flush_pose(c, sum.ke, sum.e);
    on_family(-1, true);
    // the block's pose-column copies added to out once, and cleared for the
    // next camera pass
    for (int i = threadIdx.x; i < c.wposes * kPoseCols; i += blockDim.x) {
      T v = T(0);
      for (int w = 0; w < c.copies; ++w) {
        v += c.g[w * c.wposes * kPoseCols + i];
        c.g[w * c.wposes * kPoseCols + i] = T(0);
      }
      if (v != T(0)) {
        const long long col = c.p0 * kPoseCols + i;
        atomicAdd(c.out + col, __ldg(c.cf + col) * v);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) schur_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (p.halt && *p.halt) return;   // written by an earlier launch: every block alike
  T* const xcf = (p.full_x && p.x) ? reinterpret_cast<T*>(smem + p.off_xcf) : nullptr;
  Passes<T> b(p, smem, xcf);
  const bool point = p.passes & kPointPass, camera = p.passes & kCameraPass;

  // phase 0: zero g_p, start out, stage x * cam_free and zero the block's sums
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  if (point)
    for (long long i = gt; i < p.num_points * 3; i += gs) p.g_p[i] = T(0);
  if (camera)
    for (long long i = gt; i < p.total; i += gs) p.out[i] = p.dc ? p.dc[i] * p.x[i] : T(0);
  if (xcf) {
#pragma unroll 4
    for (long long i = threadIdx.x; i < p.total; i += blockDim.x)
      xcf[i] = __ldg(p.x + i) * __ldg(p.cf + i);
  }
  b.zero_sums();
  if (camera && !point) solve_points(b.c, p.num_points);
  cg::grid_group grid = cg::this_grid();
  __syncthreads();
  grid.sync();

  if (point) {
    b.point_pass(0, p.u_out);
    if (camera) {
      grid.sync();
      solve_points(b.c, p.num_points);
      grid.sync();
    }
  }
  if (!camera) return;
  // u of this launch's point pass, read back (else recomputed from x)
  b.camera_pass(point ? b.resident() : 0, point ? p.u_out : nullptr);
}

// ----------------------------------------------------------------------------
// The whole CG of one LM iteration on one shard, in one cooperative launch
// ----------------------------------------------------------------------------
//
// It replaces, on one shard, the per-step path (a launch of schur_kernel a
// matvec, a launch of cg_step.cu a step, the host reading the stop test every
// few steps) and the two launches around it; the counterpart of the
// reference's jax.lax.while_loop (multiview_tpu/solver/schur.py:1200-1233),
// whose test runs on the device. The launch runs:
//   1. the right-hand side: w = Hpp^-1 g_p, the camera pass with u = 0 into
//      ap[1], then in every block rhs = -(g_c + ap[1]);
//   2. the start of cg_step.cuh (x = 0, r = rhs, p = z = M^-1 r, the test);
//   3. while the test holds (a forced solve: `force` steps, no test) and
//      fewer than `iterations` steps ran: the matvec's point pass, w = Hpp^-1
//      g_p, its camera pass into ap[k % 2] (g_p cleared for the next point
//      pass meanwhile), then the step of cg_step.cuh;
//   4. the back-substitution's point pass on the final x: u = J_c (cam_free *
//      x) and J_p^T u into g_p;
//   5. where asked, the LM iteration's trial point (lm_trial.cuh, the
//      arithmetic of lm_step.cu's trial_kernel, so the bits are its): each
//      thread's camera entries cam + x * cam_free, clamped, and step_c, then,
//      after a grid barrier (every block's J_p^T u summed), its points' dp =
//      Hpp^-1 (-g_p - J_p^T u) and points + dp, read in half *sel of the LM
//      loop's halves and written in half 1 - *sel. The LM iteration launches
//      no trial kernel of its own.
// A step crosses three grid barriers (a fourth where x * cam_free does not
// fit in shared memory). The step's vector work runs in every block alike:
// the dots take cg_step.cuh's fixed order in each, so every block reads the
// same alpha, beta and stop test, the blocks leave the loop together, and the
// bits are those of cg_step.cu from the same Ap. Each block reads the step's
// r, p and Ap from L2 (C entries: 1143 at the cube), recomputes the new r and
// z = M^-1 r where it reads them, stages the next matvec's x * cam_free into
// its own shared memory and stores its share of x, r, p and the next Ap's
// start dc * p (every gridDim.x-th stride of kThreads entries); r, p and Ap
// are double-buffered, so no block overwrites what another still reads. So
// the start of the next matvec (phase 0 of schur_kernel) needs no barrier of
// its own. The rows stay in shared memory between the passes: the camera pass
// walks the tiles in reverse and the point pass forward, each starting on the
// tiles the other left there, so a system whose rows fit in the blocks'
// shared memory (calibrate's) reads them from device memory once a solve.

template <typename T>
struct SolveParams {
  Params<T> m;              // the system; m.g_p, m.w, m.u_out the passes' scratch
  const T* g_c;             // [total] the reduced gradient's camera part
  const T* g_in;            // [num_points, 3] the points' gradient
  cg_step::Precond<T> pc;
  T* x;                     // [total] the solution
  T* r[2];                  // [total] each: the residual, double-buffered
  T* pv[2];                 // the search direction
  T* ap[2];                 // S p (ap[1] first holds the right-hand side's camera sum)
  double* state;            // [4]: rz, stop2, active, the step count
  long long* count;         // the step count in int64
  double tol2;
  int iterations, force;
  // the trial point (cam null: none): cam [total] and points [P, 3] half 0 of
  // the LM loop's halves (read in half *m.sel, written in half 1 - *m.sel),
  // lower and upper [total] (null: unbounded), dp [P, 3] and step_c [total]
  const T* cam;
  const T* points;
  const T* lower;
  const T* upper;
  T* dp;
  T* step_c;
};

// a of the LM loop's half h (`half` bytes a half)
template <typename T>
__device__ __forceinline__ T* half_of(const T* a, int h, long long half) {
  return reinterpret_cast<T*>(
      const_cast<unsigned char*>(reinterpret_cast<const unsigned char*>(a) + h * half));
}

// cg_step.cuh's vectors in the fused solve (see above); cur: the buffer of
// the step's r, p and Ap, -1 at the start (r = rhs, computed where read)
template <typename T>
struct Fused {
  const SolveParams<T>& q;
  T* xcf;
  int cur = -1;
  double alpha = 0.0;
  __device__ bool mine(long long i) const {
    return (i / cg_step::kThreads) % gridDim.x == blockIdx.x;
  }
  __device__ int nxt() const { return cur < 0 ? 0 : cur ^ 1; }
  __device__ T rhs(long long i) const { return -(__ldg(q.g_c + i) + __ldcg(q.ap[1] + i)); }
  __device__ void set_start(long long i, T r) const {
    if (mine(i)) {
      q.r[0][i] = r;
      q.x[i] = T(0);
    }
  }
  __device__ void sync() const {}
  __device__ T r(long long i) const { return cur < 0 ? rhs(i) : __ldcg(q.r[cur] + i); }
  __device__ T p(long long i) const { return __ldcg(q.pv[cur] + i); }
  __device__ T ap(long long i) const { return __ldcg(q.ap[cur] + i); }
  __device__ T x(long long i) const { return mine(i) ? __ldcg(q.x + i) : T(0); }
  __device__ void set_xr(long long i, T x, T r) const {
    if (mine(i)) {
      q.x[i] = x;
      q.r[nxt()][i] = r;
    }
  }
  __device__ T r_new(long long i) const { return cg_step::r_next(r(i), alpha, ap(i)); }
  __device__ void set_z(long long, T) const {}
  __device__ T z(long long i) const {
    return static_cast<T>(cg_step::apply(q.pc, i, [&](long long j) { return r_new(j); }));
  }
  __device__ void set_p(long long i, T pn) const {
    const int o = nxt();
    if (mine(i)) {
      q.pv[o][i] = pn;
      q.ap[o][i] = __ldg(q.m.dc + i) * pn;
    }
    if (xcf) xcf[i] = pn * __ldg(q.m.cf + i);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    cg_solve_kernel(const __grid_constant__ SolveParams<T> q) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double sh[cg_step::kWarps];
  const Params<T>& p = q.m;
  // the LM loop has stopped (the flag is written only by an earlier launch on
  // the stream, lm_step.cu's accept): every block returns before any barrier
  if (p.halt && *p.halt) return;
  T* const xcf = p.full_x ? reinterpret_cast<T*>(smem + p.off_xcf) : nullptr;
  Passes<T> b(p, smem, xcf);
  cg::grid_group grid = cg::this_grid();
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n = p.total, P = p.num_points;

  // 1. the right-hand side's camera pass: w = Hpp^-1 g, its sum from 0
  for (long long i = gt; i < P; i += gs) {
    const T g[3] = {__ldg(q.g_in + i * 3), __ldg(q.g_in + i * 3 + 1), __ldg(q.g_in + i * 3 + 2)};
    hpp_solve(p.hpp_inv + i * 9, g, p.w + i * 3);
#pragma unroll
    for (int j = 0; j < 3; ++j) p.g_p[i * 3 + j] = T(0);
  }
  for (long long i = gt; i < n; i += gs) q.ap[1][i] = T(0);
  b.zero_sums();
  __syncthreads();
  grid.sync();
  b.c.x = nullptr;
  b.c.out = q.ap[1];
  b.camera_pass(0, nullptr);
  grid.sync();

  // 2. the start, in every block alike
  Fused<T> v{q, xcf};
  cg_step::State s = cg_step::start(v, q.pc, n, q.tol2, sh);
  __syncthreads();
  if (!xcf) grid.sync();           // the point pass reads p from device memory

  // 3. the steps
  const bool forced = q.force >= 0;
  const int limit = forced ? q.force : q.iterations;
  int k = 0;
  for (; k < limit && (forced || s.active); ++k) {
    const int cur = k & 1;
    b.c.x = q.pv[cur];
    b.c.out = q.ap[cur];
    b.point_pass(b.resident(), p.u_out);
    grid.sync();
    solve_points(b.c, P);
    grid.sync();
    for (long long i = gt; i < 3 * P; i += gs) p.g_p[i] = T(0);
    b.camera_pass(b.resident(), p.u_out);
    grid.sync();
    v.cur = cur;
    cg_step::step(v, q.pc, n, !forced, s, sh);
    __syncthreads();
    if (!xcf) grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    q.state[0] = s.rz;
    q.state[1] = s.stop2;
    q.state[2] = s.active ? 1.0 : 0.0;
    q.state[3] = static_cast<double>(k);
    q.count[0] = k;
  }

  // 4. the back-substitution's product
  grid.sync();                     // every block's share of x
  b.c.x = q.x;
  if (xcf)
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      xcf[i] = __ldcg(q.x + i) * __ldg(p.cf + i);
  __syncthreads();
  b.point_pass(b.resident(), p.u_out);

  // 5. the trial point
  if (!q.cam) return;
  const int h = __ldg(p.sel);
  const T* cam = half_of(q.cam, h, p.half);
  T* cam_t = half_of(q.cam, 1 - h, p.half);
  for (long long i = gt; i < n; i += gs)
    cam_t[i] = lm_trial::camera(cam[i], __ldcg(q.x + i), __ldg(p.cf + i), q.lower, q.upper, i,
                                q.step_c[i]);
  grid.sync();                     // every block's J_p^T u
  const T* pts = half_of(q.points, h, p.half);
  T* pts_t = half_of(q.points, 1 - h, p.half);
  for (long long i = gt; i < P; i += gs) {
    T g[3], ju[3], dp[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[j] = __ldg(q.g_in + i * 3 + j);
      ju[j] = __ldcg(p.g_p + i * 3 + j);
    }
    lm_trial::point(p.hpp_inv + i * 9, g, ju, dp);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q.dp[i * 3 + j] = dp[j];
      pts_t[i * 3 + j] = lm_trial::add(pts[i * 3 + j], dp[j]);
    }
  }
}

// Per-device launch state: SM count and co-resident blocks an SM of each
// kernel (schur_kernel float, double; cg_solve_kernel float, double)
struct DeviceState {
  int sms = 0;
  int blocks[4] = {0, 0, 0, 0};
};
DeviceState g_devices[64];

// Reads the host table into p's families and lays out its shared memory:
// x * cam_free (where whole), the pose-column copy, the constant columns'
// sums and x, then the ring of tile slots
template <typename T>
cudaError_t plan(const long long* table, int families, long long num_points, long long total,
                 long long num_ref, Params<T>& p) {
  if (families < 0 || families > kMaxFamilies) return cudaErrorInvalidValue;
  p.count = families;
  int max_const = 0;
  long long chunks = 0, weight = 0;
  for (int i = 0; i < families; ++i) {
    const long long* e = table + static_cast<long long>(i) * kFields;
    Family& f = p.f[i];
    f.j_cam = reinterpret_cast<const void*>(e[0]);
    f.j_pt = reinterpret_cast<const void*>(e[1]);
    f.beg = reinterpret_cast<const long long*>(e[2]);
    f.end = reinterpret_cast<const long long*>(e[3]);
    f.cols = reinterpret_cast<const long long*>(e[4]);
    f.pidx = reinterpret_cast<const long long*>(e[5]);
    f.n = e[6];
    f.u_offset = e[7];
    f.k = static_cast<int>(e[8]);
    f.b = static_cast<int>(e[9]);
    if (f.k < 2 || f.k > 3 || f.b < kFirstConst || f.n < 0) return cudaErrorInvalidValue;
    f.first_chunk = chunks;
    chunks += (f.n + kChunk - 1) / kChunk;
    f.weight = static_cast<long long>(f.k) * f.b * sizeof(T) + 16 +
               (f.j_pt ? 3ll * f.k * sizeof(T) + 8 : 0);
    weight += (f.n + kChunk - 1) / kChunk * kChunk * f.weight;
    max_const = std::max(max_const, f.b - kFirstConst);
  }
  p.weight = weight;
  p.num_points = num_points;
  p.total = total;
  p.num_ref = num_ref;
  p.max_const = max_const;
  const int elem = sizeof(T);
  p.full_x = total * elem <= kXBudget;
  p.wposes = static_cast<int>(std::min<long long>(num_ref, kGBudget / (kPoseCols * elem)));
  p.off_xcf = 0;
  p.off_g = p.full_x ? align16(total * elem) : 0;
  // where the pose columns are few (calibrate's systems), each warp sums into
  // its own copy: lanes of several poses add with shared-memory float
  // atomics, compare-and-swap loops that the block's 8 warps on one copy
  // made a contention (twice the matvec's time on a 12-pose system)
  p.copies = kWarps * p.wposes * kPoseCols * elem <= kWarpCopyBudget ? kWarps : 1;
  p.off_const = p.off_g + align16(static_cast<long long>(p.copies) * p.wposes * kPoseCols * elem);
  p.off_slots = p.off_const + align16(2ll * max_const * elem);
  const int avail = kSmem - p.off_slots;
  auto slot_bytes = [&](int rows) {
    int most = 0;
    for (int i = 0; i < families; ++i)
      most = std::max(most, slot_layout(rows, p.f[i].k, p.f[i].b, p.f[i].j_pt != nullptr, elem).bytes);
    return most;
  };
  int rows = 512;
  while (rows > 8 && 3ll * slot_bytes(rows) > avail) rows -= rows > 64 ? 32 : 8;
  if (3ll * slot_bytes(rows) > avail) return cudaErrorInvalidValue;
  p.tile_rows = rows;
  p.slot_bytes = std::max(slot_bytes(rows), 16);
  p.slots = avail / p.slot_bytes;
  return cudaSuccess;
}

// The grid of a cooperative launch of `kernel` (the blocks that fit on the
// card at once); `which` indexes DeviceState::blocks
template <typename K>
cudaError_t grid_of(K kernel, int which, int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  DeviceState& ds = g_devices[dev];
  int& nb = ds.blocks[which];
  if (nb == 0) {
    err = cudaDeviceGetAttribute(&ds.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorCooperativeLaunchTooLarge;
  }
  grid = nb * ds.sms;
  return cudaSuccess;
}

template <typename K, typename P>
cudaError_t launch_cooperative(K kernel, const P& params, int grid, cudaStream_t stream) {
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch's shape (see mv_schur and mv_cg_solve): the rows the walks find
// in shared memory at their start (the first min(tiles, slots) tiles of each
// block's span with `first`, else the last ones), and the bytes of rows a
// point pass and a camera pass read from device memory when each starts on
// the tiles the other left
template <typename T>
void report(const Params<T>& p, int grid, bool first, long long* info) {
  long long resident = 0, reread = 0;
  for (int g = 0; g < grid; ++g) {
    long long a, b;
    block_span(p.f, p.count, p.weight, g, grid, a, b);
    const int tiles = locate(p.f, p.count, a, b, p.tile_rows, -1).rows;
    const int kept = std::min(tiles, p.slots);
    for (int i = 0; i < tiles; ++i) {
      const TileRef t = locate(p.f, p.count, a, b, p.tile_rows, i);
      if (first ? i < kept : i >= tiles - kept) resident += t.rows;
      // the point pass reads tiles kept.., the camera pass ..tiles - kept
      reread += ((i >= kept) + (i < tiles - kept)) * static_cast<long long>(t.rows) *
                p.f[t.f].weight;
    }
  }
  info[0] = grid;
  info[1] = kThreads;
  info[2] = p.tile_rows;
  info[3] = p.slots;
  info[4] = resident;
  info[5] = p.wposes;
  info[6] = p.full_x;
  info[7] = p.copies;
  info[8] = reread;
  info[9] = p.full_x ? 3 : 4;      // grid barriers a CG step
}

template <typename T>
cudaError_t run(const long long* table, int families, int passes, const void* x, const void* cf,
                const void* dc, const void* hpp_inv, long long num_points, long long total,
                long long num_ref, void* g_p, void* w, void* out, void* u, const int* halt,
                const int* sel, long long half, long long* info, cudaStream_t stream) {
  Params<T> p{};
  cudaError_t err = plan(table, families, num_points, total, num_ref, p);
  if (err != cudaSuccess) return err;
  if (half < 0) return cudaErrorInvalidValue;
  p.passes = passes;
  p.halt = halt;
  p.sel = sel;
  p.half = half;
  p.x = static_cast<const T*>(x);
  p.cf = static_cast<const T*>(cf);
  p.dc = static_cast<const T*>(dc);
  p.hpp_inv = static_cast<const T*>(hpp_inv);
  p.g_p = static_cast<T*>(g_p);
  p.out = static_cast<T*>(out);
  p.u_out = static_cast<T*>(u);
  p.w = static_cast<T*>(w);
  if ((passes & kCameraPass) && g_p && !w) return cudaErrorInvalidValue;
  int grid = 0;
  err = grid_of(schur_kernel<T>, sizeof(T) == 8, grid);
  if (err != cudaSuccess) return err;
  if (info) {
    long long shape[10];
    report(p, grid, false, shape);
    // the rows the camera pass finds in shared memory (after its point pass)
    if (!((passes & kPointPass) && (passes & kCameraPass))) shape[4] = 0;
    std::copy(shape, shape + 8, info);
  }
  return launch_cooperative(schur_kernel<T>, p, grid, stream);
}

template <typename T>
cudaError_t run_solve(const long long* table, int families, const void* cf, const void* dc,
                      const void* hpp_inv, const void* g_c, const void* g_in,
                      const void* precond, const void* pose_inv, long long nposes,
                      long long num_points, long long total, long long num_ref, int iterations,
                      int force, double tol2, void* x, void* r, void* pv, void* ap, void* u,
                      void* g_p, void* w, double* state, long long* count, const int* halt,
                      const int* sel, long long half, const long long* trial, long long* info,
                      cudaStream_t stream) {
  if (total < 1 || half < 0 || nposes < 0 || 7 * nposes > total || (nposes > 0 && !pose_inv) ||
      iterations < 0 || force < -1 || !g_c || !g_in || !precond || !x || !r || !pv || !ap ||
      !u || !g_p || !w || !state || !count)
    return cudaErrorInvalidValue;
  SolveParams<T> q{};
  cudaError_t err = plan(table, families, num_points, total, num_ref, q.m);
  if (err != cudaSuccess) return err;
  Params<T>& p = q.m;
  p.passes = kPointPass | kCameraPass;
  p.cf = static_cast<const T*>(cf);
  p.dc = static_cast<const T*>(dc);
  p.hpp_inv = static_cast<const T*>(hpp_inv);
  p.g_p = static_cast<T*>(g_p);
  p.w = static_cast<T*>(w);
  p.u_out = static_cast<T*>(u);
  q.g_c = static_cast<const T*>(g_c);
  q.g_in = static_cast<const T*>(g_in);
  q.pc = {static_cast<const T*>(precond), static_cast<const T*>(pose_inv), nposes};
  q.x = static_cast<T*>(x);
  for (int i = 0; i < 2; ++i) {
    q.r[i] = static_cast<T*>(r) + i * total;
    q.pv[i] = static_cast<T*>(pv) + i * total;
    q.ap[i] = static_cast<T*>(ap) + i * total;
  }
  q.state = state;
  q.count = count;
  p.halt = halt;
  p.sel = sel;
  p.half = half;
  q.tol2 = tol2;
  q.iterations = iterations;
  q.force = force;
  if (trial) {
    // cam, points, lower, upper, dp, step_c
    if (!trial[0] || !trial[1] || !trial[4] || !trial[5] || !sel) return cudaErrorInvalidValue;
    q.cam = reinterpret_cast<const T*>(trial[0]);
    q.points = reinterpret_cast<const T*>(trial[1]);
    q.lower = reinterpret_cast<const T*>(trial[2]);
    q.upper = reinterpret_cast<const T*>(trial[3]);
    q.dp = reinterpret_cast<T*>(trial[4]);
    q.step_c = reinterpret_cast<T*>(trial[5]);
  }
  int grid = 0;
  err = grid_of(cg_solve_kernel<T>, 2 + (sizeof(T) == 8), grid);
  if (err != cudaSuccess) return err;
  if (info) report(p, grid, true, info);
  return launch_cooperative(cg_solve_kernel<T>, q, grid, stream);
}

}  // namespace

// One cooperative launch on `stream`, without synchronising; returns the
// first CUDA error (0 for none). `elem`: the element size (4: float32, 8:
// float64). `table` holds 10 int64 per family with a camera block: pointers to
// J_c [n,k,b], J_p [n,k,3] (0: none), begin and end poses [n], constant
// columns [b-14], points [n] (0 with J_p), then n, the family's offset in the
// flat u, k, b; pointers on the device, indices int64, every array contiguous.
// `passes`: 1 the point pass (g_p [num_points, 3] = J_p^T u, zeroed first; u
// [sum n k] stored unless null), 2 the camera pass (out [total] = dc * x +
// cam_free * J_c^T (u - J_p Hpp^-1 g_p); dc null: no dc * x; x null: u = 0;
// g_p null: no point side; w [num_points, 3] scratch for Hpp^-1 g_p), 3 both
// (S x; u, where given, is stored by the point pass and read back by the
// camera pass). `halt` (null: never): where *halt is set the launch returns
// at once (the LM loop has stopped). `sel` (null: J as the table holds it):
// the table holds half 0 of the LM loop's halves, and the launch reads J in
// half *sel, `half` bytes on. `info` (null: not asked) receives
// the grid, the threads a block, the rows a tile, the ring's slots, the rows
// the camera pass found in shared memory, the poses whose columns a block sums
// in shared memory, whether x * cam_free was kept whole there (1) or read
// from global memory (0), and the copies of the pose columns (one a warp, or
// one).
extern "C" int mv_schur(int elem, const long long* table, int families, int passes,
                        const void* x, const void* cam_free, const void* dc, const void* hpp_inv,
                        long long num_points, long long total, long long num_ref, void* g_p,
                        void* w, void* out, void* u, const int* halt, const int* sel,
                        long long half, long long* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes < 1 || passes > 3) return cudaErrorInvalidValue;
  if (elem == 4)
    return run<float>(table, families, passes, x, cam_free, dc, hpp_inv, num_points, total,
                      num_ref, g_p, w, out, u, halt, sel, half, info, s);
  if (elem == 8)
    return run<double>(table, families, passes, x, cam_free, dc, hpp_inv, num_points, total,
                       num_ref, g_p, w, out, u, halt, sel, half, info, s);
  return cudaErrorInvalidValue;
}

// The whole CG of one LM iteration on one shard: one cooperative launch on
// `stream`, without synchronising; returns the first CUDA error (0 for none).
// `table`, `elem`, cam_free [total], dc [total], hpp_inv [num_points, 3, 3]
// as mv_schur takes them; g_c [total] and g_p_in [num_points, 3] the
// gradient (rhs = -(g_c - cam_free * J_c^T J_p Hpp^-1 g_p_in)); precond
// [total] and pose_inv [nposes, 7, 7] (null with nposes 0) the
// preconditioner. It runs CG from x = 0 while |r|^2 > tol2 |rhs|^2 and fewer
// than `iterations` steps ran, or, with force >= 0, exactly `force` steps
// with no test. Outputs: x [total]; state [4] float64: rz, stop2, whether a
// next step would run, the steps run; count [1] int64: the steps run. Where
// *halt is set (halt null: never) it returns at once (the LM loop has
// stopped); `sel` and `half` as mv_schur takes them. Scratch: r, p, ap [2 total] each, u
// [sum n k] (zeros where a family has no camera block), g_p and w
// [num_points, 3]; u ends as J_c (cam_free * x) and g_p as J_p^T u (the
// back-substitution's product). `trial` (null: none) holds 6 addresses: cam
// [total] and points [num_points, 3] (half 0 of the LM loop's halves: read in
// half *sel, the trial point written in half 1 - *sel), lower and upper
// [total] (each null where unbounded), dp [num_points, 3] and step_c [total];
// the launch then ends with the LM iteration's trial point. `info` (null: not
// asked) receives the grid, the threads a block, the rows a tile, the ring's
// slots, the rows a point pass finds in shared memory at its start, the pose
// window, whether x * cam_free is kept whole in shared memory, the copies of
// the pose columns, the bytes of rows a step reads from device memory and the
// grid barriers a step crosses.
extern "C" int mv_cg_solve(int elem, const long long* table, int families, const void* cam_free,
                           const void* dc, const void* hpp_inv, const void* g_c,
                           const void* g_p_in, const void* precond, const void* pose_inv,
                           long long nposes, long long num_points, long long total,
                           long long num_ref, int iterations, int force, double tol2, void* x,
                           void* r, void* p, void* ap, void* u, void* g_p, void* w,
                           double* state, long long* count, const int* halt, const int* sel,
                           long long half, const long long* trial, long long* info,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return run_solve<float>(table, families, cam_free, dc, hpp_inv, g_c, g_p_in, precond,
                            pose_inv, nposes, num_points, total, num_ref, iterations, force, tol2,
                            x, r, p, ap, u, g_p, w, state, count, halt, sel, half, trial, info,
                            s);
  if (elem == 8)
    return run_solve<double>(table, families, cam_free, dc, hpp_inv, g_c, g_p_in, precond,
                             pose_inv, nposes, num_points, total, num_ref, iterations, force,
                             tol2, x, r, p, ap, u, g_p, w, state, count, halt, sel, half, trial,
                             info, s);
  return cudaErrorInvalidValue;
}
