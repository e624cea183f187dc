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
// rows k = 3; columns: its bracket's begin pose 7, end pose 7, then the
// family's b - 14 constant columns) and, where it touches a point, a point
// block J_p[n] [k, 3]. Three launches:
//   point pass    g_p[p] += J_p[n]^T u_n                 (u stored where asked)
//   camera pass   v_n = u_n - J_p[n] Hpp^-1[p] g_p[p];   g_c += J_c[n]^T v_n
//   epilogue      out = cam_free * g_c + dc * x
// The camera pass needs the whole g_p (a grid-wide dependency, across shards a
// sum), so it is a second launch; it recomputes u instead of reading it back.
// A family without a camera block (the xyz priors) adds nothing to S x and is
// left out of the table; one without a point block (depth against the mesh)
// skips the point side.
//
// Bound: bytes. A matvec must read J_c, J_p and the row indices once (at the
// benchmark's 384000 float32 pixel rows 89.1 + 9.2 + 9.2 MB: 32 us at 3.35
// TB/s); its 4 N k b operations are far below the FP32 rate. This design reads
// J_c twice (once a pass), so half the bound is its ceiling. A block stages its
// rows' camera blocks, one contiguous span, in shared memory with 16-byte
// cp.async copies; each thread then owns one row.
//
// Sums: g_p takes one atomic a row and column (the rows of a point are spread
// over the rows). Pose columns: the rows of a warp that share a pose are summed
// first (__match_any_sync peers, a tree of shuffles; right for any row order),
// then the first of them adds the sums, one atomic a pose column per warp.
// Constant columns, which every row of a family adds into: a warp sum, a block
// sum in shared memory, then one atomic a block and column. Atomics make the
// order of the sums vary from run to run, as index_add_ on the card does.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxFamilies = 16;   // families of one launch; more go in further launches
constexpr int kFields = 10;        // int64 fields of one family in the host table
constexpr int kMaxRows = 128;      // rows (threads) of a block
constexpr int kPoseCols = 7;
constexpr int kFirstConst = 14;    // camera columns before the constant ones
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedLimit = 232448;   // bytes of shared memory a block may use (sm_90)

struct Family {
  const void* j_cam;        // [n, k, b]
  const void* j_pt;         // [n, k, 3], or null: the family touches no point
  const long long* beg;     // [n] pose of each row's bracket begin
  const long long* end;     // [n] pose of its end
  const long long* cols;    // [b - 14] the family's constant columns
  const long long* pidx;    // [n] point of each row (null with j_pt)
  long long n;
  long long u_offset;       // first element of the family in the flat u
  int k, b;
  int first_block;          // first block of the family in the grid
};

struct Table {
  Family f[kMaxFamilies];
  int count;
};

__device__ __forceinline__ const Family& family_of(const Table& t) {
  int fi = 0;
#pragma unroll
  for (int i = 1; i < kMaxFamilies; ++i)
    if (i < t.count && static_cast<int>(blockIdx.x) >= t.f[i].first_block) fi = i;
  return t.f[fi];
}

// The block's rows of J_c (one contiguous span) into shared memory: 16-byte
// cp.async copies, all of a thread's in flight at once (a loop of plain loads
// waits out the memory's latency once per element), then the tail. The
// caller waits with cp_async_wait before its __syncthreads.
template <typename T>
__device__ __forceinline__ void stage_rows(const Family& f, long long row0, int rows, T* tile) {
  const int kb = f.k * f.b;
  const T* src = static_cast<const T*>(f.j_cam) + row0 * kb;
  const int count = rows * kb;
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15ull) == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const int chunks = count / kPer;
    const char* s = reinterpret_cast<const char*>(src);
    const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(tile));
    for (int i = threadIdx.x; i < chunks; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * i),
                   "l"(s + 16ll * i));
    asm volatile("cp.async.commit_group;\n" ::);
    done = chunks * kPer;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// u = J x_cols of one row: J [k, b] row-major; x_cols gathered by pose, the
// constant columns' (cam_free * x) from shared memory.
template <typename T>
__device__ __forceinline__ void row_product(const T* J, int k, int b, const T* __restrict__ x,
                                            const T* __restrict__ cf, long long beg,
                                            long long end, const T* xconst, T (&u)[3]) {
  u[0] = u[1] = u[2] = T(0);
  const long long pose[2] = {beg * kPoseCols, end * kPoseCols};
#pragma unroll
  for (int side = 0; side < 2; ++side) {
#pragma unroll
    for (int j = 0; j < kPoseCols; ++j) {
      const long long col = pose[side] + j;
      const T xv = x[col] * cf[col];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < k) u[c] += J[c * b + side * kPoseCols + j] * xv;
    }
  }
  for (int j = kFirstConst; j < b; ++j) {
    const T xv = xconst[j - kFirstConst];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < k) u[c] += J[c * b + j] * xv;
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// J_c[:, first:first+7]^T v of each row, summed over the warp's rows of the
// same pose, into g_c's pose columns. Rows past the family's end come with
// pose -1 and add nothing. Every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void pose_columns(const T* J, int k, int b, bool valid,
                                             const T (&v)[3], int first, long long pose,
                                             T* __restrict__ g_c) {
  T o[kPoseCols];
#pragma unroll
  for (int j = 0; j < kPoseCols; ++j) {
    o[j] = T(0);
    if (valid) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < k) o[j] += J[c * b + first + j] * v[c];
    }
  }
  const unsigned peers = __match_any_sync(kFull, pose);
  reduce_peers(peers, o);
  if (pose >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
#pragma unroll
    for (int j = 0; j < kPoseCols; ++j) atomicAdd(g_c + pose * kPoseCols + j, o[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxRows)
point_pass(const __grid_constant__ Table t, const T* __restrict__ x, const T* __restrict__ cf,
           T* __restrict__ g_p, T* __restrict__ u_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Family& f = family_of(t);
  const int kb = f.k * f.b;
  const int nconst = f.b - kFirstConst;
  const long long row0 = static_cast<long long>(blockIdx.x - f.first_block) * blockDim.x;
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x), f.n - row0));
  T* xconst = tile + blockDim.x * kb;
  stage_rows(f, row0, rows, tile);
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) {
    const long long col = f.cols[i];
    xconst[i] = x[col] * cf[col];
  }
  cp_async_wait();
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;                     // no warp-wide step follows
  const long long n = row0 + r;
  T u[3];
  row_product(tile + r * kb, f.k, f.b, x, cf, f.beg[n], f.end[n], xconst, u);
  if (u_out) {
    T* dst = u_out + f.u_offset + n * f.k;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < f.k) dst[c] = u[c];
  }
  if (f.j_pt) {
    const T* P = static_cast<const T*>(f.j_pt) + n * f.k * 3;
    T* g = g_p + f.pidx[n] * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < f.k) s += P[c * 3 + j] * u[c];
      atomicAdd(g + j, s);
    }
  }
}

// x null: u = 0 (the right-hand side's product); g_p null: no point side.
template <typename T>
__global__ void __launch_bounds__(kMaxRows)
camera_pass(const __grid_constant__ Table t, const T* __restrict__ x, const T* __restrict__ cf,
            const T* __restrict__ hpp_inv, const T* __restrict__ g_p, T* __restrict__ g_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const Family& f = family_of(t);
  const int kb = f.k * f.b;
  const int nconst = f.b - kFirstConst;
  const long long row0 = static_cast<long long>(blockIdx.x - f.first_block) * blockDim.x;
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x), f.n - row0));
  T* xconst = tile + blockDim.x * kb;
  T* acc = xconst + nconst;
  stage_rows(f, row0, rows, tile);
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) {
    if (x) {
      const long long col = f.cols[i];
      xconst[i] = x[col] * cf[col];
    }
    acc[i] = T(0);
  }
  cp_async_wait();
  __syncthreads();
  const int r = threadIdx.x;
  const bool valid = r < rows;
  const T* J = tile + r * kb;
  T v[3] = {T(0), T(0), T(0)};
  long long beg = -1, end = -1;
  if (valid) {
    const long long n = row0 + r;
    beg = f.beg[n];
    end = f.end[n];
    if (x) row_product(J, f.k, f.b, x, cf, beg, end, xconst, v);
    if (g_p && f.j_pt) {
      const long long p = f.pidx[n];
      const T* H = hpp_inv + p * 9;
      const T* g = g_p + p * 3;
      T w[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) w[i] = H[3 * i] * g[0] + H[3 * i + 1] * g[1] + H[3 * i + 2] * g[2];
      const T* P = static_cast<const T*>(f.j_pt) + n * f.k * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < f.k) v[c] -= P[3 * c] * w[0] + P[3 * c + 1] * w[1] + P[3 * c + 2] * w[2];
    }
  }
  pose_columns(J, f.k, f.b, valid, v, 0, beg, g_c);
  pose_columns(J, f.k, f.b, valid, v, kPoseCols, end, g_c);
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < nconst; ++i) {
    T s = T(0);
    if (valid) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c < f.k) s += J[c * f.b + kFirstConst + i] * v[c];
    }
    s = warp_sum(s);
    if (lane == 0) atomicAdd(acc + i, s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) atomicAdd(g_c + f.cols[i], acc[i]);
}

// x null: out = cam_free * g_c (dc unread).
template <typename T>
__global__ void epilogue(long long total, const T* __restrict__ g_c, const T* __restrict__ cf,
                         const T* __restrict__ dc, const T* __restrict__ x, T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = x ? g_c[i] * cf[i] + dc[i] * x[i] : g_c[i] * cf[i];
}

// One launch of `kernel` per kMaxFamilies families of the host table; blocks
// of up to 128 rows (fewer where the widest family's rows would not fit in
// shared memory). `launched` counts the launches made.
template <typename T, typename Kernel, typename... Args>
cudaError_t launch_families(Kernel kernel, bool with_acc, const long long* table, int families,
                            int* launched, cudaStream_t s, Args... args) {
  for (int first = 0; first < families; first += kMaxFamilies) {
    Table tb{};
    tb.count = families - first < kMaxFamilies ? families - first : kMaxFamilies;
    int max_kb = 0, max_const = 0;
    for (int i = 0; i < tb.count; ++i) {
      const long long* e = table + static_cast<long long>(first + i) * kFields;
      Family& f = tb.f[i];
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
      if (f.k < 1 || f.k > 3 || f.b < kFirstConst || f.n < 0) return cudaErrorInvalidValue;
      max_kb = std::max(max_kb, f.k * f.b);
      max_const = std::max(max_const, f.b - kFirstConst);
    }
    auto shared = [&](int rows) {
      return (static_cast<size_t>(rows) * max_kb + (with_acc ? 2 : 1) * max_const) * sizeof(T);
    };
    int rows = kMaxRows;
    while (rows > 32 && shared(rows) > static_cast<size_t>(kSharedLimit)) rows -= 32;
    if (shared(rows) > static_cast<size_t>(kSharedLimit)) return cudaErrorInvalidValue;
    long long blocks = 0;
    for (int i = 0; i < tb.count; ++i) {
      tb.f[i].first_block = static_cast<int>(blocks);
      blocks += (tb.f[i].n + rows - 1) / rows;
    }
    if (blocks == 0) continue;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t bytes = shared(rows);
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    kernel<<<static_cast<unsigned>(blocks), rows, bytes, s>>>(tb, args...);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run_point_pass(const long long* table, int families, const void* x, const void* cf,
                           long long num_points, void* g_p, void* u, int* launched,
                           cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(g_p, 0, static_cast<size_t>(num_points) * 3 * sizeof(T), s);
  if (err != cudaSuccess) return err;
  return launch_families<T>(point_pass<T>, false, table, families, launched, s,
                            static_cast<const T*>(x), static_cast<const T*>(cf),
                            static_cast<T*>(g_p), static_cast<T*>(u));
}

template <typename T>
cudaError_t run_camera_pass(const long long* table, int families, const void* x, const void* cf,
                            const void* hpp_inv, const void* g_p, long long total, void* g_c,
                            int* launched, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(g_c, 0, static_cast<size_t>(total) * sizeof(T), s);
  if (err != cudaSuccess) return err;
  return launch_families<T>(camera_pass<T>, true, table, families, launched, s,
                            static_cast<const T*>(x), static_cast<const T*>(cf),
                            static_cast<const T*>(hpp_inv), static_cast<const T*>(g_p),
                            static_cast<T*>(g_c));
}

template <typename T>
cudaError_t run_epilogue(long long total, const void* g_c, const void* cf, const void* dc,
                         const void* x, void* out, cudaStream_t s) {
  if (total <= 0) return cudaSuccess;
  const int threads = 256;
  epilogue<T><<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      total, static_cast<const T*>(g_c), static_cast<const T*>(cf), static_cast<const T*>(dc),
      static_cast<const T*>(x), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Every function takes `elem`, the element size (4: float32, 8: float64), and
// launches on `stream` without synchronising; it returns the first CUDA error
// (0 for none). `table` holds 10 int64 per family with a camera block:
// pointers to J_c [n,k,b], J_p [n,k,3] (0: none), begin and end poses [n],
// constant columns [b-14], points [n] (0 with J_p), then n, the family's
// offset in the flat u, k, b; pointers on the device, indices int64, every
// array contiguous. `launched` receives the number of kernel launches.

// g_p [num_points, 3] = sum of J_p^T u, u = J_c (cam_free * x); u [sum n k]
// (null: not stored) receives u of the families in the table.
extern "C" int mv_schur_point_pass(int elem, const long long* table, int families,
                                   const void* x, const void* cam_free, long long num_points,
                                   void* g_p, void* u, int* launched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (elem == 4)
    return run_point_pass<float>(table, families, x, cam_free, num_points, g_p, u, launched, s);
  if (elem == 8)
    return run_point_pass<double>(table, families, x, cam_free, num_points, g_p, u, launched, s);
  return cudaErrorInvalidValue;
}

// g_c [total] = J_c^T (u - J_p Hpp^-1 g_p) summed per column; x null: u = 0;
// g_p null: no point side. hpp_inv [num_points, 3, 3].
extern "C" int mv_schur_camera_pass(int elem, const long long* table, int families,
                                    const void* x, const void* cam_free, const void* hpp_inv,
                                    const void* g_p, long long total, void* g_c, int* launched,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (elem == 4)
    return run_camera_pass<float>(table, families, x, cam_free, hpp_inv, g_p, total, g_c,
                                  launched, s);
  if (elem == 8)
    return run_camera_pass<double>(table, families, x, cam_free, hpp_inv, g_p, total, g_c,
                                   launched, s);
  return cudaErrorInvalidValue;
}

// out [total] = cam_free * g_c + dc * x; x null: cam_free * g_c.
extern "C" int mv_schur_epilogue(int elem, long long total, const void* g_c,
                                 const void* cam_free, const void* dc, const void* x, void* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4) return run_epilogue<float>(total, g_c, cam_free, dc, x, out, s);
  if (elem == 8) return run_epilogue<double>(total, g_c, cam_free, dc, x, out, s);
  return cudaErrorInvalidValue;
}
