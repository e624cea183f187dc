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
//   accept  (after the row blocks at the trial point) one ordinary launch:
//           a row a thread, the rows' sums |r_t|^2 and |Jd|^2 (Jd = u + J_p
//           dp, J_p the current blocks; u = J_c step_c where the cameras are
//           bounded; the rows of Jd given in linear_solver "cg") and the dots
//           of pred (step_c.g_c, dp.g_p, step_c' diag step_c, dp' diag dp);
//           each block's six sums to its slot of `partial`, then a ticket;
//           the last block to take one sums the partials in block order and
//           alone takes the model reduction, good, rho, lam, nu,
//           rel_decrease and done, writes the LM state and flips `sel` on a
//           good step.
//
// Two halves, no copy. The loop on the card keeps its current and its trial
// cameras, points, row blocks and residual in two halves of one allocation a
// device (solver/lm_step.py::Halves): half 1 lies `half` bytes after half 0,
// every array at the same place in each. The int32 `sel` in the LM state
// says which half is current. trial reads the cameras and points of half sel
// and writes the trial point into half 1 - sel; the row blocks at the trial
// point (row_blocks.cu) write half 1 - sel; the assembly, the Schur matvec
// and the CG solve (lm_assembly.cu, schur_mv.cu) read half sel; accept reads
// J_p of half sel and r_t of half 1 - sel. Each kernel reads sel once at its
// start, as it reads `halt`. An accepted step flips sel: the trial's half
// becomes the current one and nothing is copied. accept is the only writer of
// sel and of halt, and runs as an earlier launch on the same stream than every
// kernel that reads them, so every block of a launch reads the same value.
// The host learns sel at its read of the state (every LM_CHECK_EVERY
// iterations) and takes the result from that half.
//
// The same kernel with other passes starts a solve (init: cost = c0 =
// |r|^2 / 2 of half 0, lam0, nu = 2, the counters and sel at 0) and serves
// several shards: a rows launch a shard (its two row sums), the partials
// summed over the shards in shard order (ShardMesh.sum), one scalars launch
// on the lead.
//
// Sums. Every sum that decides good or done is taken in float64 in a fixed
// order, with no atomic on a value: a thread sums its rows in index order, a
// block takes cg_step.cuh's fixed butterfly, and the last block sums the
// blocks' partials with a fixed assignment of partials to threads and the
// same butterfly, in block order. Which block arrives last does not change
// the bits. The grid depends on the rows alone, so two launches on the same
// inputs decide alike, and the shards' partials summed in shard order make
// two ranks agree bit for bit. The ticket counter lives beside the state;
// the last block sets it back to 0, so the next launch, and a CUDA graph's
// next replay, start clean.
//
// Bound: bytes. At the benchmark's cube (384000 float32 pixel rows, B = 29,
// 2400 points) the accept must read r_t, u, J_p and the row's point index
// once (18.4 MB: 5.5 us at 3.35 TB/s), and that is the function's bound. A
// thread takes one row: its point index and that point's dp once, its k
// components of r_t and u and its k x 3 block of J_p (8-byte or 16-byte
// loads where a k = 2 family's arrays allow). The trial moves a few hundred
// KB.

#include <cuda_runtime.h>

#include "cg_step.cuh"
#include "lm_trial.cuh"

namespace {

constexpr int kThreads = cg_step::kThreads;  // 256: cg_step::block_sum's block
constexpr int kMaxFamilies = 32;
constexpr int kSums = 6;
constexpr int kFamilyFields = 5;   // int64 a family in the host table
// passes
constexpr int kRows = 1, kScalars = 2, kInit = 4;
// the LM state's float64 slots; kFlags holds two int32, halt then singular;
// kSel two int32, sel then the accept's ticket counter
enum Slot {
  kCost, kLam, kNu, kC0, kIter, kCgTotal, kNewCost, kPred, kRho, kGood, kDone, kRel, kFlags,
  kSel, kSlots
};

struct Family {
  const void* jp;           // [n, k, 3] the point blocks of half 0, or null
  const long long* pidx;    // [n] (null with jp)
  long long n;
  long long off;            // the family's first element in the flat rows
  long long row0;           // its first row among all families' rows
  int k;
  int vec;                  // k = 2 with r, u, Jd and J_p rows aligned to 2 elements
};

template <typename T>
struct AcceptParams {
  Family f[kMaxFamilies];
  int count;
  int passes, gate;
  long long C, P;
  long long rows;           // the families' rows
  const T* r;               // [rows] the residual of half 0 (accept: r_t is read in half
                            // 1 - sel; init: the current one, half 0)
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
  double* state;            // [kSlots]: the ticket counter (and on the lead the LM state)
  const int* sel;           // the current half (null: half 0)
  long long half;           // bytes from half 0 to half 1
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

// The array whose half-0 copy is at p, in the half `bytes` on
template <typename T>
__device__ __forceinline__ const T* at(const void* p, long long bytes) {
  return reinterpret_cast<const T*>(static_cast<const unsigned char*>(p) + bytes);
}
template <typename T>
__device__ __forceinline__ T* at_w(const void* p, long long bytes) {
  return const_cast<T*>(at<T>(p, bytes));
}

// Two values of T at p: one 8- or 16-byte load where `vec` (p aligned to it)
template <typename T>
__device__ __forceinline__ void load2(const T* p, bool vec, double& a, double& b);
template <>
__device__ __forceinline__ void load2<float>(const float* p, bool vec, double& a, double& b) {
  if (vec) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    a = v.x;
    b = v.y;
  } else {
    a = __ldg(p);
    b = __ldg(p + 1);
  }
}
template <>
__device__ __forceinline__ void load2<double>(const double* p, bool vec, double& a, double& b) {
  if (vec) {
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    a = v.x;
    b = v.y;
  } else {
    a = __ldg(p);
    b = __ldg(p + 1);
  }
}

// One row of K components: |r_t|^2 into sr and, where dp is given, |Jd|^2 into sj
template <typename T, int K>
__device__ __forceinline__ void row_k(const T* rt, const T* u, const T* jd, const T* jp,
                                      const long long* pidx, const T* dp, long long i, bool vec,
                                      double& sr, double& sj) {
  double r[K], j[K];
  if (K == 2) {
    load2(rt + 2 * i, vec, r[0], r[K - 1]);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) r[c] = d(__ldg(rt + K * i + c));
  }
#pragma unroll
  for (int c = 0; c < K; ++c) sr += r[c] * r[c];
  if (!dp) return;
  const T* src = jd ? jd : u;
  if (!src) {
#pragma unroll
    for (int c = 0; c < K; ++c) j[c] = 0.0;
  } else if (K == 2) {
    load2(src + 2 * i, vec, j[0], j[K - 1]);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) j[c] = d(__ldg(src + K * i + c));
  }
  if (!jd && jp) {
    const T* x = dp + __ldg(pidx + i) * 3;
    const double x0 = d(__ldg(x)), x1 = d(__ldg(x + 1)), x2 = d(__ldg(x + 2));
    double b[3 * K];
    if (K == 2) {
#pragma unroll
      for (int q = 0; q < 3; ++q) load2(jp + 6 * i + 2 * q, vec, b[2 * q], b[2 * q + K - 1]);
    } else {
#pragma unroll
      for (int q = 0; q < 3 * K; ++q) b[q] = d(__ldg(jp + 3 * K * i + q));
    }
#pragma unroll
    for (int c = 0; c < K; ++c) j[c] += b[3 * c] * x0 + b[3 * c + 1] * x1 + b[3 * c + 2] * x2;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) sj += j[c] * j[c];
}

// The block's sums of v, each in every thread with the bits cg_step::block_sum
// gives it (a butterfly a warp, then one over the warps' sums), the kSums
// values side by side: two barriers in all. sh: kSums * kWarps doubles.
__device__ __forceinline__ void block_sums(double (&v)[kSums], double* sh) {
  constexpr int kWarps = cg_step::kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSums; ++i)
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) v[i] += __shfl_xor_sync(cg_step::kFull, v[i], o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kSums; ++i) sh[i * kWarps + warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    double t = lane < kWarps ? sh[i * kWarps + lane] : 0.0;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) t += __shfl_xor_sync(cg_step::kFull, t, o);
    v[i] = t;
  }
  __syncthreads();                 // sh is reused by the next sums
}

// Row i of a family of any other k: its components one by one
template <typename T>
__device__ __forceinline__ void row_any(const T* rt, const T* u, const T* jd, const T* jp,
                                        const long long* pidx, const T* dp, long long i, int k,
                                        double& sr, double& sj) {
  for (int c = 0; c < k; ++c) {
    const long long e = i * k + c;
    const double rv = d(__ldg(rt + e));
    sr += rv * rv;
    if (!dp) continue;
    double j;
    if (jd) {
      j = d(__ldg(jd + e));
    } else {
      j = u ? d(__ldg(u + e)) : 0.0;
      if (jp) {
        const T* b = jp + e * 3;
        const T* x = dp + __ldg(pidx + i) * 3;
        j += d(__ldg(b)) * d(__ldg(x)) + d(__ldg(b + 1)) * d(__ldg(x + 1)) +
             d(__ldg(b + 2)) * d(__ldg(x + 2));
      }
    }
    sj += j * j;
  }
}

// The rows' two sums of one thread: one row of all the families' rows each
// pass of its grid stride (rows in index order)
template <typename T>
__device__ void row_sums(const AcceptParams<T>& p, const T* r, long long cur, long long gt,
                         long long gs, double& sr, double& sj) {
  for (long long g = gt; g < p.rows; g += gs) {
    int fi = 0;
    while (fi + 1 < p.count && g >= p.f[fi + 1].row0) ++fi;
    const Family& f = p.f[fi];
    const long long i = g - f.row0;
    const T* rt = r + f.off;
    const T* u = p.u ? p.u + f.off : nullptr;
    const T* jd = p.jd ? p.jd + f.off : nullptr;
    const T* jp = f.jp ? at<T>(f.jp, cur) : nullptr;
    if (f.k == 2)
      row_k<T, 2>(rt, u, jd, jp, f.pidx, p.dp, i, f.vec, sr, sj);
    else if (f.k == 3)
      row_k<T, 3>(rt, u, jd, jp, f.pidx, p.dp, i, false, sr, sj);
    else
      row_any(rt, u, jd, jp, f.pidx, p.dp, i, f.k, sr, sj);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) accept_kernel(const __grid_constant__ AcceptParams<T> p) {
  __shared__ double sh[kSums * cg_step::kWarps];
  __shared__ int last;
  // the solve has stopped: written by an earlier launch on the stream, so
  // every block returns before it takes a ticket
  if (p.halt && *p.halt) return;
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gs = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool init = p.passes & kInit, scalars = p.passes & kScalars;
  const int h = p.sel ? *p.sel : 0;
  const long long cur = h * p.half;

  double s[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if ((p.passes & (kRows | kInit)) && !p.rows_in)
    row_sums(p, init ? p.r : at<T>(p.r, (1 - h) * p.half), cur, gt, gs, s[0], s[1]);
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
  block_sums(s, sh);
  unsigned* ticket = reinterpret_cast<unsigned*>(p.state + kSel) + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSums; ++i) p.partial[blockIdx.x * kSums + i] = s[i];
    __threadfence();             // the partials before the ticket, for the last block
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the state the update reads, loaded before the partials' sums so that the
  // loads overlap them
  double cost = 0.0, lam = 0.0, nu = 0.0, iters = 0.0, cg_total = 0.0, cg_steps = 0.0;
  int singular = 0;
  if (threadIdx.x == 0 && scalars) {
    cost = __ldcg(p.state + kCost);
    lam = __ldcg(p.state + kLam);
    nu = __ldcg(p.state + kNu);
    iters = __ldcg(p.state + kIter);
    cg_total = __ldcg(p.state + kCgTotal);
    cg_steps = p.cg_count ? static_cast<double>(__ldcg(p.cg_count)) : 0.0;
    singular = p.singular ? __ldcg(p.singular) : 0;
  }
  // the last block: the blocks' partials in block order, each thread a fixed
  // share of them (blocks g, g + 2 kThreads, ... and g + kThreads, g + 3
  // kThreads, ... summed apart, then added: their loads in flight together),
  // the same butterflies
  double tot[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, odd[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int grid = static_cast<int>(gridDim.x), bd = static_cast<int>(blockDim.x);
  for (int g = threadIdx.x; g < grid; g += 2 * bd) {
    const bool two = g + bd < grid;
    double a[kSums], b[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      a[i] = __ldcg(p.partial + g * kSums + i);
      b[i] = two ? __ldcg(p.partial + (g + bd) * kSums + i) : 0.0;
    }
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      tot[i] += a[i];
      odd[i] += b[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kSums; ++i) tot[i] += odd[i];
  block_sums(tot, sh);
  if (threadIdx.x != 0) return;
  *ticket = 0u;                  // the next launch (a graph's next replay) starts clean
  const double sr = p.rows_in ? p.rows_in[0] : tot[0];
  const double sj = p.rows_in ? p.rows_in[1] : tot[1];

  if (!scalars && !init) {       // a shard's rows launch
    p.rows_out[0] = tot[0];
    p.rows_out[1] = tot[1];
    return;
  }
  int* flags = reinterpret_cast<int*>(p.state + kFlags);
  int* sel = reinterpret_cast<int*>(p.state + kSel);
  if (init) {
    const double c = 0.5 * sr;
    for (int i = 0; i < kFlags; ++i) p.state[i] = 0.0;
    p.state[kCost] = c;
    p.state[kC0] = c;
    p.state[kLam] = p.lam0;
    p.state[kNu] = 2.0;
    flags[0] = flags[1] = 0;
    sel[0] = 0;
    p.typed[0] = static_cast<T>(p.lam0);
    p.typed[1] = static_cast<T>(c);
    return;
  }

  // the scalar update of solver/lm_step.py::accept_plain
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
  const double kept = good ? new_cost : cost;
  p.state[kCost] = kept;
  p.state[kLam] = lam_new;
  p.state[kNu] = nu_new;
  p.state[kIter] = iters + 1.0;
  p.state[kCgTotal] = cg_total + cg_steps;
  p.state[kNewCost] = new_cost;
  p.state[kPred] = pred;
  p.state[kRho] = rho;
  p.state[kGood] = good ? 1.0 : 0.0;
  p.state[kDone] = done ? 1.0 : 0.0;
  p.state[kRel] = rel;
  if (good) sel[0] = 1 - h;      // the trial's half is the current one
  p.typed[0] = static_cast<T>(lam_new);
  p.typed[1] = static_cast<T>(kept);
  if (p.gate && p.halt && (done || singular)) *p.halt = 1;
}

template <typename T>
struct TrialParams {
  long long C, P;
  const T* cam;             // [C] half 0
  const T* points;          // [P, 3] half 0
  const T* x;
  const T* cam_free;
  const T* lower;           // or null
  const T* upper;           // or null
  const T* hpp_inv;         // [P, 3, 3]
  const T* g_p;
  const T* jtp_u;
  T* dp;
  T* step_c;
  const int* sel;
  long long half;
  const int* halt;
};

// The trial point (lm_trial.cuh: the same arithmetic as the tail of
// schur_mv.cu's cg_solve_kernel, which computes it on one shard of cg_blocks)
template <typename T>
__global__ void __launch_bounds__(kThreads) trial_kernel(const __grid_constant__ TrialParams<T> p) {
  if (p.halt && *p.halt) return;
  const int h = *p.sel;
  const long long now = h * p.half, next = (1 - h) * p.half;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < p.C) {
    T step;
    const T v = lm_trial::camera(at<T>(p.cam, now)[i], p.x[i], p.cam_free[i], p.lower, p.upper,
                                 i, step);
    at_w<T>(p.cam, next)[i] = v;
    p.step_c[i] = step;
  }
  if (i < p.P) {
    T g[3], ju[3], dp[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[j] = p.g_p[i * 3 + j];
      ju[j] = p.jtp_u[i * 3 + j];
    }
    lm_trial::point(p.hpp_inv + i * 9, g, ju, dp);
    const T* pt = at<T>(p.points, now) + i * 3;
    T* pt_t = at_w<T>(p.points, next) + i * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      p.dp[i * 3 + r] = dp[r];
      pt_t[r] = lm_trial::add(pt[r], dp[r]);
    }
  }
}

template <typename T>
cudaError_t run_accept(int passes, int gate, const long long* table, int families, long long C,
                       long long P, const void* r, const void* u, const void* jd, const void* dp,
                       const void* step_c, const void* g_c, const void* g_p,
                       const void* cam_diag, const void* pt_diag, const long long* cg_count,
                       const double* rows_in, double* rows_out, double* partial,
                       long long partial_blocks, double* state, const int* sel, long long half,
                       void* typed, int* halt, const int* singular, double lam0, long long* info,
                       cudaStream_t stream) {
  // the halves lie a multiple of 16 bytes apart, so a row's alignment is the
  // same in both
  if (families < 0 || families > kMaxFamilies || !state || !partial || half < 0 || half % 16)
    return cudaErrorInvalidValue;
  AcceptParams<T> p{};
  p.count = families;
  long long rows = 0;
  const unsigned long long two = 2 * sizeof(T) - 1;
  for (int i = 0; i < families; ++i) {
    const long long* e = table + static_cast<long long>(i) * kFamilyFields;
    Family& f = p.f[i];
    f.jp = reinterpret_cast<const void*>(e[0]);
    f.pidx = reinterpret_cast<const long long*>(e[1]);
    f.n = e[2];
    f.off = e[3];
    f.k = static_cast<int>(e[4]);
    if (f.n < 0 || f.k < 1 || (f.jp && !f.pidx)) return cudaErrorInvalidValue;
    f.row0 = rows;
    rows += f.n;
    const auto at_off = [&](const void* a) {
      return a ? reinterpret_cast<unsigned long long>(a) + f.off * sizeof(T) : 0ull;
    };
    f.vec = f.k == 2 && ((at_off(r) | at_off(u) | at_off(jd) |
                          reinterpret_cast<unsigned long long>(f.jp)) & two) == 0;
  }
  p.rows = rows;
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
  p.sel = sel;
  p.half = half;
  p.typed = static_cast<T*>(typed);
  p.halt = halt;
  p.singular = singular;
  p.lam0 = lam0;
  const bool scalars = passes & kScalars, has_rows = passes & (kRows | kInit);
  if ((has_rows && !rows_in && !r) || (scalars && (!step_c || !g_c || !g_p || !cam_diag ||
                                                   !pt_diag || !dp)) ||
      (passes == kRows && !rows_out) || ((scalars || (passes & kInit)) && !typed))
    return cudaErrorInvalidValue;
  // a row a thread, the camera and point entries of the scalars likewise; at
  // least one block, at most partial_blocks (more rows a thread beyond)
  long long work = rows_in ? 0 : rows;
  if (scalars) work = work > C ? work : C;
  if (scalars) work = work > 3 * P ? work : 3 * P;
  long long grid = (work + kThreads - 1) / kThreads;
  grid = grid < 1 ? 1 : (grid > partial_blocks ? partial_blocks : grid);
  if (info) {
    info[0] = grid;
    info[1] = kThreads;
  }
  accept_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_trial(long long C, long long P, const void* cam, const void* points,
                      const void* x, const void* cam_free, const void* lower, const void* upper,
                      const void* hpp_inv, const void* g_p, const void* jtp_u, void* dp,
                      void* step_c, const int* sel, long long half, const int* halt,
                      cudaStream_t stream) {
  if (C < 0 || P < 0 || !cam || !x || !cam_free || !step_c || !sel || half <= 0 ||
      (P > 0 && (!points || !hpp_inv || !g_p || !jtp_u || !dp)))
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
  p.dp = static_cast<T*>(dp);
  p.step_c = static_cast<T*>(step_c);
  p.sel = sel;
  p.half = half;
  p.halt = halt;
  const long long n = C > P ? C : P;
  if (n == 0) return cudaSuccess;
  trial_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The trial point of one LM iteration: one launch on `stream`, without
// synchronising; returns the first CUDA error (0 for none). `elem`: 4
// (float32) or 8 (float64). cam [C] and points [P, 3] point into half 0 of
// the halves (half 1 `half` bytes on): it reads them in half *sel and writes
// cam_t and pts_t into half 1 - *sel. Also reads x (the CG's step), cam_free
// [C], lower and upper [C] (each null: unbounded), g_p, jtp_u [P, 3] and
// hpp_inv [P, 3, 3]; writes step_c [C] and dp [P, 3]. Returns at once where
// `halt` (null: never) is set.
extern "C" int mv_lm_trial(int elem, long long C, long long P, const void* cam, const void* points,
                           const void* x, const void* cam_free, const void* lower,
                           const void* upper, const void* hpp_inv, const void* g_p,
                           const void* jtp_u, void* dp, void* step_c, const int* sel,
                           long long half, const int* halt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return run_trial<float>(C, P, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                            dp, step_c, sel, half, halt, s);
  if (elem == 8)
    return run_trial<double>(C, P, cam, points, x, cam_free, lower, upper, hpp_inv, g_p, jtp_u,
                             dp, step_c, sel, half, halt, s);
  return cudaErrorInvalidValue;
}

// The accept of one LM iteration (or a solve's start, or a shard's part of
// either): one launch on `stream`, without synchronising; returns the first
// CUDA error (0 for none). `table` holds 5 int64 a family in the flat rows'
// order: its point blocks J_p [n, k, 3] in half 0 (0: none), its point
// indices [n] (0 with J_p), n, its first element in the flat rows, k. r: the
// flat residual of half 0. `passes` (bits): 1 the rows' sums (|r_t|^2 of r in
// half 1 - *sel, |Jd|^2 with J_p in half *sel where dp is given) into
// rows_out [2] (a shard's launch), 2 the scalar update from this launch's or
// rows_in's row sums with the dots of step_c, g_c, cam_diag [C] and dp, g_p,
// pt_diag [P, 3], flipping *sel on a good step, 4 the start of a solve (the
// state from |r|^2 of half 0 and lam0). sel null: *sel taken as 0 (a shard's
// rows launch at a solve's start passes half 0 too: r itself). state [14] float64: cost,
// lam, nu, c0, iterations, CG total, new_cost, pred, rho, good, done,
// rel_decrease, then four int32: halt, singular, sel and the ticket counter
// (0 between launches); typed [2] lam and cost in the element type. partial:
// [partial_blocks, 6] float64 scratch. `gate`: set halt where done or
// *singular. `info` (null: not asked) receives the grid and the threads a
// block.
extern "C" int mv_lm_accept(int elem, int passes, int gate, const long long* table, int families,
                            long long C, long long P, const void* r, const void* u,
                            const void* jd, const void* dp, const void* step_c, const void* g_c,
                            const void* g_p, const void* cam_diag, const void* pt_diag,
                            const long long* cg_count, const double* rows_in, double* rows_out,
                            double* partial, long long partial_blocks, double* state,
                            const int* sel, long long half, void* typed, int* halt,
                            const int* singular, double lam0, long long* info, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes < 1 || passes > 7 || ((passes & kInit) && (passes & (kRows | kScalars))))
    return cudaErrorInvalidValue;
  if (elem == 4)
    return run_accept<float>(passes, gate, table, families, C, P, r, u, jd, dp, step_c, g_c, g_p,
                             cam_diag, pt_diag, cg_count, rows_in, rows_out, partial,
                             partial_blocks, state, sel, half, typed, halt, singular, lam0, info,
                             s);
  if (elem == 8)
    return run_accept<double>(passes, gate, table, families, C, P, r, u, jd, dp, step_c, g_c,
                              g_p, cam_diag, pt_diag, cg_count, rows_in, rows_out, partial,
                              partial_blocks, state, sel, half, typed, halt, singular, lam0,
                              info, s);
  return cudaErrorInvalidValue;
}
