// The arithmetic of one step of the bundle adjustment's preconditioned
// conjugate gradients, shared by the kernel that runs a step a launch
// (cg_step.cu, after the caller's matvec) and the kernel that runs a whole
// CG solve in one cooperative launch (schur_mv.cu, cg_solve_kernel). One copy
// of it, so both give the same bits from the same inputs:
//
//   start   x = 0, r = rhs, z = M^-1 r, p = z, rz = r.z, stop2 = tol^2 r.r,
//           active = (r.r > stop2)
//   step    (after Ap = S p) alpha = rz / p.Ap (0 where p.Ap <= 0);
//           x += alpha p; r -= alpha Ap; z = M^-1 r; beta = r.z / rz (rz taken
//           as 1 where it is <= 0); p = z + beta p; rz = r.z; then the stop
//           test of the next step, active = (r.r > stop2)
//
// M^-1: the SCHUR_JACOBI 7x7 inverses on the first 7 nposes entries and the
// scalar preconditioner on the rest (nposes = 0: Jacobi). Every dot, alpha
// and beta is taken in float64; the vectors are stored in their dtype T. The
// dots are block reductions of a block of kThreads threads: thread t sums
// entries t, t + kThreads, ... in index order, then a fixed butterfly of
// shuffles a warp and one over the warps. The order never changes, so two
// processes with the same inputs get the same bits (no atomics).
//
// The two kernels keep their vectors differently, so the loops below reach
// them through a policy V:
//   start:  rhs(i); set_start(i, r) stores r = rhs and x = 0; sync(); r(i) the
//           stored r; set_p(i, z) stores p = z
//   step:   p(i), ap(i), x(i), r(i) (the r before the step); set_xr(i, x, r)
//           stores the new x and r; sync(); r_new(i) the new r; set_z(i, z),
//           z(i) the stored z; set_p(i, p) stores the new p
// where sync() makes what the block stored visible to all its threads.

#pragma once

#include <cuda_runtime.h>

namespace cg_step {

constexpr int kThreads = 256;      // threads of the block that takes the dots
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The block's sum of v, the same bits in every thread: a butterfly a warp (a
// lane adds its partner's partial to its own: a + b and b + a are one
// number), then the same over the warps' sums. sh: kWarps doubles of shared
// memory.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double t = lane < kWarps ? sh[lane] : 0.0;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  __syncthreads();                 // sh is reused by the next sum
  return t;
}

// The preconditioner: precond [n], pose_inv [nposes, 7, 7] (null with nposes 0)
template <typename T>
struct Precond {
  const T* precond;
  const T* pose_inv;
  long long nposes;
};

// (M^-1 r)[i], r(j) the stored r at entry j
template <typename T, typename R>
__device__ __forceinline__ double apply(const Precond<T>& m, long long i, R r) {
  if (i < 7 * m.nposes) {
    const long long pose = i / 7, row = i % 7;
    const T* mi = m.pose_inv + pose * 49 + row * 7;
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < 7; ++j)
      s += static_cast<double>(mi[j]) * static_cast<double>(r(pose * 7 + j));
    return s;
  }
  return static_cast<double>(m.precond[i]) * static_cast<double>(r(i));
}

template <typename T>
__device__ __forceinline__ T x_next(T x, double alpha, T p) {
  return static_cast<T>(static_cast<double>(x) + alpha * static_cast<double>(p));
}
template <typename T>
__device__ __forceinline__ T r_next(T r, double alpha, T ap) {
  return static_cast<T>(static_cast<double>(r) - alpha * static_cast<double>(ap));
}
template <typename T>
__device__ __forceinline__ T p_next(T z, double beta, T p) {
  return static_cast<T>(static_cast<double>(z) + beta * static_cast<double>(p));
}

// The state of a solve: rz, stop2 = tol^2 rhs.rhs, whether the next step runs
struct State {
  double rz, stop2;
  bool active;
};

template <typename T, typename V>
__device__ __forceinline__ State start(V& v, const Precond<T>& m, long long n, double tol2,
                                       double* sh) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) v.set_start(i, v.rhs(i));
  v.sync();
  double rz = 0.0, rr = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const T z = static_cast<T>(apply(m, i, [&](long long j) { return v.r(j); }));
    v.set_p(i, z);
    const double ri = static_cast<double>(v.r(i));
    rz += ri * static_cast<double>(z);
    rr += ri * ri;
  }
  rz = block_sum(rz, sh);
  rr = block_sum(rr, sh);
  const double stop2 = tol2 * rr;
  return {rz, stop2, rr > stop2};
}

// One step after the matvec; `test`: take the stop test of the next step
// (a forced step keeps s.active as it is)
template <typename T, typename V>
__device__ __forceinline__ void step(V& v, const Precond<T>& m, long long n, bool test, State& s,
                                     double* sh) {
  double pap = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    pap += static_cast<double>(v.p(i)) * static_cast<double>(v.ap(i));
  pap = block_sum(pap, sh);
  const double alpha = pap > 0.0 ? s.rz / pap : 0.0;
  v.alpha = alpha;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    v.set_xr(i, x_next(v.x(i), alpha, v.p(i)), r_next(v.r(i), alpha, v.ap(i)));
  v.sync();                        // z reads the other entries of a pose's r
  double rzn = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const T z = static_cast<T>(apply(m, i, [&](long long j) { return v.r_new(j); }));
    v.set_z(i, z);
    rzn += static_cast<double>(v.r_new(i)) * static_cast<double>(z);
  }
  rzn = block_sum(rzn, sh);
  const double beta = rzn / (s.rz > 0.0 ? s.rz : 1.0);
  double rr = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    v.set_p(i, p_next(v.z(i), beta, v.p(i)));
    const double ri = static_cast<double>(v.r_new(i));
    rr += ri * ri;
  }
  rr = block_sum(rr, sh);
  s.rz = rzn;
  if (test) s.active = rr > s.stop2;
}

}  // namespace cg_step
