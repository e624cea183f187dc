// The step and the accept of one Levenberg-Marquardt iteration of the bundle
// adjustment's Schur-LM (multiview_tpu_torch/solver/schur.py, through
// solver/lm_step.py), for Hopper (sm_90a). It replaces the eager bookkeeping
// the port ran after each CG solve (about 90 small operations an iteration
// at the benchmark's cube: the point step, the trial point, the cost, the
// model reduction's products and dots, the scalar update and the torch.where
// selects of every block), the counterpart of multiview_tpu/solver/schur.py:
// 1241-1295 (XLA code inside the reference's jax.lax.while_loop: the JAX
// package has no pallas_call there). Two launches an iteration:
//
//   trial   (after the CG solve) a point a thread: dp = Hpp^-1 (-g_p -
//           J_p^T u); a camera entry a thread: cam_t = clamp(cam + x *
//           cam_free, lower, upper), step_c = cam_t - cam; pts_t = points + dp.
//   accept  (after the row blocks at the trial point) one cooperative launch:
//           the rows' sums |r_t|^2 and |Jd|^2 (Jd = u + J_p dp a row, J_p the
//           current blocks; u = J_c step_c where the cameras are bounded; the
//           rows of Jd given in linear_solver "cg") and the dots of pred
//           (step_c.g_c, dp.g_p, step_c' diag step_c, dp' diag dp); a grid
//           barrier; then in every block alike the sums over the blocks in
//           block order, the model reduction, good, rho, lam, nu,
//           rel_decrease and done; on good the trial's cam, points, blocks
//           and residual copied over the current ones (a table of spans, 16
//           bytes a thread); block 0 writes the LM state.
//
// The same kernel with other passes starts a solve (init: cost = c0 =
// |r|^2 / 2, lam0, nu = 2, the counters at 0) and serves several shards: a
// rows launch a shard (its two row sums), the partials summed over the
// shards in shard order (ShardMesh.sum), one scalars launch on the lead, and
// a copy launch a shard that reads `good` from the state.
//
// The LM state lives in float64 on the device (slots below) and the host
// reads it every LM_CHECK_EVERY iterations on one shard of cg_blocks, every
// iteration on the other paths. `halt`, set by accept where done
// (or a SCHUR_JACOBI block was singular) and the caller asks for it, makes
// every later launch of the solve return at once: this kernel's, the row
// blocks', the assembly's and the CG solve's. accept is the only writer of
// the flag and runs as an earlier launch on the same stream, so every block
// of a launch reads the same value before its first grid barrier.
//
// Sums. Every sum that decides good or done is taken in float64 in a fixed
// order, with no atomics: a thread sums its entries in index order, a block
// takes cg_step.cuh's fixed butterfly, and every block sums the blocks'
// partials with the same assignment of partials to threads and the same
// butterfly. The grid is fixed on a card, so two launches on the same inputs
// decide alike, and the shards' partials summed in shard order make two
// ranks agree bit for bit.
//
// Bound: bytes. At the benchmark's cube (384000 float32 pixel rows, B = 29,
// 2400 points) the accept must read r_t, u, J_p and the row's point index
// once (18.4 MB: 5.5 us at 3.35 TB/s), and that is the function's bound. The
// trial moves a few hundred KB. This design also copies J_c, J_p and r on an
// accepted step (202.8 MB read and written: 61 us more), as 16-byte loads and
// stores a thread over the grid. The alternative, a device-side index into
// double buffers that the row blocks, assembly and Schur kernels would read,
// needs no copy but puts an indirection into three kernels. The copy was
// chosen without building that alternative; chip_smoke.py phase 3g measures
// the copy's cost (an accepted accept less a rejected one).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cg_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = cg_step::kThreads;  // 256: cg_step::block_sum's block
constexpr int kMaxFamilies = 32;
constexpr int kMaxCopies = 80;
constexpr int kSums = 6;
constexpr int kFamilyFields = 5;   // int64 a family in the host table
constexpr int kCopyFields = 3;     // int64 a span in the host copy table
// passes
constexpr int kRows = 1, kScalars = 2, kCopy = 4, kInit = 8;
// the LM state's float64 slots; kFlags holds two int32, halt then singular
enum Slot {
  kCost, kLam, kNu, kC0, kIter, kCgTotal, kNewCost, kPred, kRho, kGood, kDone, kRel, kFlags,
  kSlots
};

struct Family {
  const void* jp;           // [n, k, 3] the current point blocks, or null
  const long long* pidx;    // [n] (null with jp)
  long long n;
  long long off;            // the family's first element in the flat rows
  int k;
};

struct Span {
  void* dst;
  const void* src;
  long long bytes;          // a multiple of 4
};

template <typename T>
struct AcceptParams {
  Family f[kMaxFamilies];
  Span c[kMaxCopies];
  int count, copies;
  int passes, gate;
  long long C, P;
  const T* r;               // [rows] the trial's residual (init: the current one)
  const T* u;               // [rows] the camera half of Jd, or null (0)
  const T* jd;              // [rows] Jd itself ("cg"), or null
  const T* dp;              // [P, 3]
  const T* step_c;          // [C]
  const T* g_c;             // [C]
  const T* g_p;             // [P, 3]
  const T* cam_diag;        // [C]
  const T* pt_diag;         // [P, 3]
  const long long* cg_count;  // the iteration's CG steps, or null (0)
  const double* rows_in;    // [2] the rows' sums of every shard, or null: this launch's
  double* rows_out;         // [2] this shard's rows' sums (a rows launch), or null
  double* partial;          // [grid, kSums] scratch
  double* state;            // [kSlots]
  T* typed;                 // [2] lam, cost in T
  int* halt;                // null: never halted
  const int* singular;      // null: none
  double lam0;
};

__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x != x ? x : (x < lo ? lo : x);    // torch.clamp_min: NaN stays NaN
}

template <typename T>
__device__ __forceinline__ double d(T v) {
  return static_cast<double>(v);
}

// The rows' two sums of one thread, entries in index order a family
template <typename T>
__device__ void row_sums(const AcceptParams<T>& p, long long gt, long long gs, double& sr,
                         double& sj) {
  for (int fi = 0; fi < p.count; ++fi) {
    const Family& f = p.f[fi];
    const long long m = f.n * f.k;
    const T* jp = static_cast<const T*>(f.jp);
    for (long long e = gt; e < m; e += gs) {
      const long long i = f.off + e;
      const double rt = d(__ldg(p.r + i));
      sr += rt * rt;
      if (!p.dp) continue;
      double j;
      if (p.jd) {
        j = d(__ldg(p.jd + i));
      } else {
        j = p.u ? d(__ldg(p.u + i)) : 0.0;
        if (jp) {
          const T* b = jp + e * 3;
          const T* x = p.dp + __ldg(f.pidx + e / f.k) * 3;
          j += d(__ldg(b)) * d(__ldg(x)) + d(__ldg(b + 1)) * d(__ldg(x + 1)) +
               d(__ldg(b + 2)) * d(__ldg(x + 2));
        }
      }
      sj += j * j;
    }
  }
}

// The copy table's spans over the grid: 16 bytes a thread where both ends
// allow, else 4
__device__ void copy_spans(const Span* c, int copies, long long gt, long long gs) {
  for (int s = 0; s < copies; ++s) {
    const unsigned char* src = static_cast<const unsigned char*>(c[s].src);
    unsigned char* dst = static_cast<unsigned char*>(c[s].dst);
    const long long bytes = c[s].bytes;
    long long done = 0;
    if (((reinterpret_cast<unsigned long long>(src) | reinterpret_cast<unsigned long long>(dst)) &
         15ull) == 0) {
      const long long n16 = bytes / 16;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (long long i = gt; i < n16; i += gs) d4[i] = __ldcs(s4 + i);
      done = n16 * 16;
    }
    const int* s1 = reinterpret_cast<const int*>(src + done);
    int* d1 = reinterpret_cast<int*>(dst + done);
    for (long long i = gt; i < (bytes - done) / 4; i += gs) d1[i] = s1[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) accept_kernel(const __grid_constant__ AcceptParams<T> p) {
  __shared__ double sh[cg_step::kWarps];
  __shared__ double tot[kSums];
  if (p.halt && *p.halt) return;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  // the state as this iteration found it, read by every block before the
  // barrier (block 0 rewrites it after)
  const double cost = p.state[kCost], lam = p.state[kLam], nu = p.state[kNu];
  const bool rows = p.passes & (kRows | kInit), scalars = p.passes & kScalars;

  if (p.passes == kCopy) {          // a shard's copy after the lead's scalars
    if (p.state[kGood] != 0.0) copy_spans(p.c, p.copies, gt, gs);
    return;
  }

  double s[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (rows && !p.rows_in) row_sums(p, gt, gs, s[0], s[1]);
  if (scalars) {
    for (long long i = gt; i < p.C; i += gs) {
      const double sc = d(__ldg(p.step_c + i));
      s[2] += sc * d(__ldg(p.g_c + i));
      s[4] += d(__ldg(p.cam_diag + i)) * sc * sc;
    }
    for (long long i = gt; i < 3 * p.P; i += gs) {
      const double x = d(__ldg(p.dp + i));
      s[3] += x * d(__ldg(p.g_p + i));
      s[5] += d(__ldg(p.pt_diag + i)) * x * x;
    }
  }
#pragma unroll
  for (int i = 0; i < kSums; ++i) s[i] = cg_step::block_sum(s[i], sh);
  if (threadIdx.x == 0)
    for (int i = 0; i < kSums; ++i) p.partial[blockIdx.x * kSums + i] = s[i];
  cg::this_grid().sync();
  // every block: the blocks' partials, each thread a fixed share of them,
  // the same butterfly
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    double t = 0.0;
    for (int g = threadIdx.x; g < static_cast<int>(gridDim.x); g += blockDim.x)
      t += __ldcg(p.partial + g * kSums + i);
    t = cg_step::block_sum(t, sh);
    if (threadIdx.x == 0) tot[i] = t;
  }
  __syncthreads();
  const double sr = p.rows_in ? p.rows_in[0] : tot[0];
  const double sj = p.rows_in ? p.rows_in[1] : tot[1];
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;

  if (!scalars && !(p.passes & kInit)) {   // a shard's rows launch
    if (lead) {
      p.rows_out[0] = tot[0];
      p.rows_out[1] = tot[1];
    }
    return;
  }
  if (p.passes & kInit) {
    if (lead) {
      const double c = 0.5 * sr;
      for (int i = 0; i < kFlags; ++i) p.state[i] = 0.0;
      p.state[kCost] = c;
      p.state[kC0] = c;
      p.state[kLam] = p.lam0;
      p.state[kNu] = 2.0;
      int* flags = reinterpret_cast<int*>(p.state + kFlags);
      flags[0] = flags[1] = 0;
      p.typed[0] = static_cast<T>(p.lam0);
      p.typed[1] = static_cast<T>(c);
    }
    return;
  }

  // the scalar update of solver/lm_step.py::accept_plain, in every block
  const double new_cost = 0.5 * sr;
  const double pred = -(tot[2] + tot[3]) - 0.5 * sj - 0.5 * lam * (tot[4] + tot[5]);
  const bool good = new_cost < cost && isfinite(new_cost);
  const double rho = (cost - new_cost) / clamp_min(fabs(pred), 1e-30);
  const double t = 2.0 * rho - 1.0;
  const double lam_dec = lam * clamp_min(1.0 - t * t * t, 1.0 / 3.0);
  const double lam_new = good ? clamp_min(lam_dec, 1e-14) : lam * nu;
  const double nu_new = good ? 2.0 : nu * 2.0;
  const double rel = fabs(cost - new_cost) / clamp_min(cost, 1e-30);
  const bool done = (good && rel < 1e-10) || lam > 1e12;
  if (lead) {
    const double kept = good ? new_cost : cost;
    p.state[kCost] = kept;
    p.state[kLam] = lam_new;
    p.state[kNu] = nu_new;
    p.state[kIter] += 1.0;
    p.state[kCgTotal] += p.cg_count ? static_cast<double>(*p.cg_count) : 0.0;
    p.state[kNewCost] = new_cost;
    p.state[kPred] = pred;
    p.state[kRho] = rho;
    p.state[kGood] = good ? 1.0 : 0.0;
    p.state[kDone] = done ? 1.0 : 0.0;
    p.state[kRel] = rel;
    p.typed[0] = static_cast<T>(lam_new);
    p.typed[1] = static_cast<T>(kept);
    if (p.gate && p.halt && (done || (p.singular && *p.singular))) *p.halt = 1;
  }
  if (good && (p.passes & kCopy)) copy_spans(p.c, p.copies, gt, gs);
}

template <typename T>
struct TrialParams {
  long long C, P;
  const T* cam;
  const T* points;
  const T* x;
  const T* cam_free;
  const T* lower;           // or null
  const T* upper;           // or null
  const T* hpp_inv;         // [P, 3, 3]
  const T* g_p;
  const T* jtp_u;
  T* cam_t;
  T* pts_t;
  T* dp;
  T* step_c;
  const int* halt;
};

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {   // torch.maximum: NaN from either side
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) trial_kernel(const __grid_constant__ TrialParams<T> p) {
  if (p.halt && *p.halt) return;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < p.C) {
    const T c = p.cam[i];
    // x * cam_free is exact (cam_free is 0 or 1): one rounding, as the plain sum
    T v = c + p.x[i] * p.cam_free[i];
    if (p.lower) v = tmax(v, p.lower[i]);
    if (p.upper) v = tmin(v, p.upper[i]);
    p.cam_t[i] = v;
    p.step_c[i] = v - c;
  }
  if (i < p.P) {
    T g[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j] = -p.g_p[i * 3 + j] - p.jtp_u[i * 3 + j];
    const T* h = p.hpp_inv + i * 9;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T step = static_cast<T>(d(h[3 * r]) * d(g[0]) + d(h[3 * r + 1]) * d(g[1]) +
                                    d(h[3 * r + 2]) * d(g[2]));
      p.dp[i * 3 + r] = step;
      p.pts_t[i * 3 + r] = p.points[i * 3 + r] + step;
    }
  }
}

// The grid of a cooperative launch of accept_kernel<T>: the blocks that fit
// on the card at once (per device, cached)
struct DeviceGrid {
  int grid[2] = {0, 0};
};
DeviceGrid g_grids[64];

template <typename T>
cudaError_t grid_of(int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int& g = g_grids[dev].grid[sizeof(T) == 8];
  if (g == 0) {
    int sms = 0, nb = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, accept_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorCooperativeLaunchTooLarge;
    g = nb * sms;
  }
  grid = g;
  return cudaSuccess;
}

template <typename T>
cudaError_t run_accept(int passes, int gate, const long long* table, int families,
                       const long long* copies, int ncopies, long long C, long long P,
                       const void* r, const void* u, const void* jd, const void* dp,
                       const void* step_c, const void* g_c, const void* g_p,
                       const void* cam_diag, const void* pt_diag, const long long* cg_count,
                       const double* rows_in, double* rows_out, double* partial,
                       long long partial_blocks, double* state, void* typed, int* halt,
                       const int* singular, double lam0, long long* info, cudaStream_t stream) {
  if (families < 0 || families > kMaxFamilies || ncopies < 0 || ncopies > kMaxCopies || !state ||
      !partial)
    return cudaErrorInvalidValue;
  AcceptParams<T> p{};
  p.count = families;
  for (int i = 0; i < families; ++i) {
    const long long* e = table + static_cast<long long>(i) * kFamilyFields;
    p.f[i].jp = reinterpret_cast<const void*>(e[0]);
    p.f[i].pidx = reinterpret_cast<const long long*>(e[1]);
    p.f[i].n = e[2];
    p.f[i].off = e[3];
    p.f[i].k = static_cast<int>(e[4]);
    if (p.f[i].n < 0 || p.f[i].k < 1 || (p.f[i].jp && !p.f[i].pidx)) return cudaErrorInvalidValue;
  }
  p.copies = ncopies;
  for (int i = 0; i < ncopies; ++i) {
    const long long* e = copies + static_cast<long long>(i) * kCopyFields;
    p.c[i].dst = reinterpret_cast<void*>(e[0]);
    p.c[i].src = reinterpret_cast<const void*>(e[1]);
    p.c[i].bytes = e[2];
    if (e[2] < 0 || e[2] % 4) return cudaErrorInvalidValue;
  }
  p.passes = passes;
  p.gate = gate;
  p.C = C;
  p.P = P;
  p.r = static_cast<const T*>(r);
  p.u = static_cast<const T*>(u);
  p.jd = static_cast<const T*>(jd);
  p.dp = static_cast<const T*>(dp);
  p.step_c = static_cast<const T*>(step_c);
  p.g_c = static_cast<const T*>(g_c);
  p.g_p = static_cast<const T*>(g_p);
  p.cam_diag = static_cast<const T*>(cam_diag);
  p.pt_diag = static_cast<const T*>(pt_diag);
  p.cg_count = cg_count;
  p.rows_in = rows_in;
  p.rows_out = rows_out;
  p.partial = partial;
  p.state = state;
  p.typed = static_cast<T*>(typed);
  p.halt = halt;
  p.singular = singular;
  p.lam0 = lam0;
  const bool scalars = passes & kScalars, rows = passes & (kRows | kInit);
  if ((rows && !rows_in && !r) || (scalars && (!step_c || !g_c || !g_p || !cam_diag ||
                                               !pt_diag || !dp)) ||
      (passes == kRows && !rows_out) || ((scalars || (passes & kInit)) && !typed))
    return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = grid_of<T>(grid);
  if (err != cudaSuccess) return err;
  if (grid > partial_blocks) return cudaErrorInvalidValue;
  if (info) {
    info[0] = grid;
    info[1] = kThreads;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, accept_kernel<T>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_trial(long long C, long long P, const void* cam, const void* points,
                      const void* x, const void* cam_free, const void* lower, const void* upper,
                      const void* hpp_inv, const void* g_p, const void* jtp_u, void* cam_t,
                      void* pts_t, void* dp, void* step_c, const int* halt,
                      cudaStream_t stream) {
  if (C < 0 || P < 0 || !cam || !x || !cam_free || !cam_t || !step_c ||
      (P > 0 && (!points || !hpp_inv || !g_p || !jtp_u || !pts_t || !dp)))
    return cudaErrorInvalidValue;
  TrialParams<T> p{};
  p.C = C;
  p.P = P;
  p.cam = static_cast<const T*>(cam);
  p.points = static_cast<const T*>(points);
  p.x = static_cast<const T*>(x);
  p.cam_free = static_cast<const T*>(cam_free);
  p.lower = static_cast<const T*>(lower);
  p.upper = static_cast<const T*>(upper);
  p.hpp_inv = static_cast<const T*>(hpp_inv);
  p.g_p = static_cast<const T*>(g_p);
  p.jtp_u = static_cast<const T*>(jtp_u);
  p.cam_t = static_cast<T*>(cam_t);
  p.pts_t = static_cast<T*>(pts_t);
  p.dp = static_cast<T*>(dp);
  p.step_c = static_cast<T*>(step_c);
  p.halt = halt;
  const long long n = C > P ? C : P;
  if (n == 0) return cudaSuccess;
  trial_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The trial point of one LM iteration: one launch on `stream`, without
// synchronising; returns the first CUDA error (0 for none). `elem`: 4
// (float32) or 8 (float64). Reads cam, x (the CG's step), cam_free [C],
// lower and upper [C] (each null: unbounded), points, g_p, jtp_u [P, 3] and
// hpp_inv [P, 3, 3]; writes cam_t, step_c [C], pts_t, dp [P, 3]. Returns at
// once where `halt` (null: never) is set.
extern "C" int mv_lm_trial(int elem, long long C, long long P, const void* cam, const void* points,
                           const void* x, const void* cam_free, const void* lower,
                           const void* upper, const void* hpp_inv, const void* g_p,
                           const void* jtp_u, void* cam_t, void* pts_t, void* dp, void* step_c,
                           const int* halt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return run_trial<float>(C, P, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                            cam_t, pts_t, dp, step_c, halt, s);
  if (elem == 8)
    return run_trial<double>(C, P, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                             cam_t, pts_t, dp, step_c, halt, s);
  return cudaErrorInvalidValue;
}

// The accept of one LM iteration (or a solve's start, or a shard's part of
// either): one cooperative launch on `stream`, without synchronising;
// returns the first CUDA error (0 for none). `table` holds 5 int64 a family
// in the flat rows' order: its current point blocks J_p [n, k, 3] (0: none),
// its point indices [n] (0 with J_p), n, its first element in the flat
// rows, k. `copies` holds 3 int64 a span: destination, source, bytes (a
// multiple of 4), copied where the step is good. `passes` (bits): 1 the rows'
// sums (|r|^2 of r, |Jd|^2 where dp is given) into rows_out [2] (a shard's
// launch), 2 the scalar update from this launch's or rows_in's row sums
// with the dots of step_c, g_c, cam_diag [C] and dp, g_p, pt_diag [P, 3],
// 4 the copy (alone: where state's good is set), 8 the start of a solve
// (the state from |r|^2 and lam0). state [14] float64: cost, lam, nu, c0,
// iterations, CG total, new_cost, pred, rho, good, done, rel_decrease, then
// two int32, halt and singular; typed [2] lam and cost in the element type.
// partial: [partial_blocks, 6] float64 scratch (at least the grid). `gate`:
// set halt where done or *singular. `info` (null: not asked) receives the
// grid and the threads a block.
extern "C" int mv_lm_accept(int elem, int passes, int gate, const long long* table, int families,
                            const long long* copies, int ncopies, long long C, long long P,
                            const void* r, const void* u, const void* jd, const void* dp,
                            const void* step_c, const void* g_c, const void* g_p,
                            const void* cam_diag, const void* pt_diag, const long long* cg_count,
                            const double* rows_in, double* rows_out, double* partial,
                            long long partial_blocks, double* state, void* typed, int* halt,
                            const int* singular, double lam0, long long* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes < 1 || passes > 15) return cudaErrorInvalidValue;
  if (elem == 4)
    return run_accept<float>(passes, gate, table, families, copies, ncopies, C, P, r, u, jd, dp,
                             step_c, g_c, g_p, cam_diag, pt_diag, cg_count, rows_in, rows_out,
                             partial, partial_blocks, state, typed, halt, singular, lam0, info,
                             s);
  if (elem == 8)
    return run_accept<double>(passes, gate, table, families, copies, ncopies, C, P, r, u, jd,
                              dp, step_c, g_c, g_p, cam_diag, pt_diag, cg_count, rows_in,
                              rows_out, partial, partial_blocks, state, typed, halt, singular,
                              lam0, info, s);
  return cudaErrorInvalidValue;
}
