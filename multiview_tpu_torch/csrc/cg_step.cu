// The vector work of one step of the bundle adjustment's preconditioned
// conjugate gradients (multiview_tpu_torch/solver/cg.py, the reduced camera
// system of solver/schur.py), for Hopper (sm_90a). It replaces the eager
// update the port ran around each Schur matvec (about 30 small operations:
// dots, axpys, the SCHUR_JACOBI apply, the torch.where mask), the
// counterpart of cg_body and cg_cond of multiview_tpu/solver/schur.py:1200-1233
// with precond_apply at :1084-1094 (XLA code: the JAX package has no
// pallas_call there).
//
// One block per launch (the camera vectors are short: 1143 entries at the
// benchmark's cube, a few hundred in calibrate), so the three dots are block
// reductions in a fixed order (cg_step.cuh, whose arithmetic the fused solve
// of schur_mv.cu shares: the same inputs give the same bits in both). The
// launches of one CG solve:
//
//   start   x = 0, r = rhs, z = M^-1 r, p = z, rz, stop2, active, the count 0
//   step    (after the matvec Ap = S p; none of this where `active` is 0)
//           the step of cg_step.cuh, the count + 1, the stop test of the
//           next step
//   forced  a step with no stop test and no mask (debug_force_cg)
//
// The state (rz, stop2, active, count) lives in four float64 on the device;
// the host reads `active` every CG_CHECK_EVERY steps. This per-step path is
// the one of several shards (whose matvec sums over the shards between its
// passes) and of the linear solvers whose matvec is not schur_mv.cu's; a
// single-shard cg_blocks solve runs the whole CG in schur_mv.cu instead.
//
// Bound: the launch. A step reads 5 vectors and writes 4 (C = 1143 at the
// cube: about 40 KB, 0.01 us at 3.35 TB/s), so its least time is that of a
// launch; the library also holds an empty kernel (mv_cg_empty) to measure it.

#include <cuda_runtime.h>

#include "cg_step.cuh"

namespace {

constexpr int kStart = 0, kStep = 1, kForced = 2;

template <typename T>
struct Params {
  int mode;
  long long n;
  T* x;
  T* r;
  T* p;
  T* z;                     // scratch: M^-1 r
  const T* v;               // rhs (start) or Ap (step)
  cg_step::Precond<T> m;
  double tol2;              // cg_tolerance^2
  double* state;            // [4]: rz, stop2, active, count
};

// The vectors of cg_step.cuh's loops, in device memory, updated in place
template <typename T>
struct InPlace {
  const Params<T>& q;
  double alpha = 0.0;
  __device__ T rhs(long long i) const { return q.v[i]; }
  __device__ void set_start(long long i, T r) const {
    q.r[i] = r;
    q.x[i] = T(0);
  }
  __device__ void sync() const { __syncthreads(); }
  __device__ T r(long long i) const { return q.r[i]; }
  __device__ T r_new(long long i) const { return q.r[i]; }
  __device__ T p(long long i) const { return q.p[i]; }
  __device__ T ap(long long i) const { return q.v[i]; }
  __device__ T x(long long i) const { return q.x[i]; }
  __device__ T z(long long i) const { return q.z[i]; }
  __device__ void set_xr(long long i, T x, T r) const {
    q.x[i] = x;
    q.r[i] = r;
  }
  __device__ void set_z(long long i, T z) const { q.z[i] = z; }
  __device__ void set_p(long long i, T p) const { q.p[i] = p; }
};

template <typename T>
__global__ void __launch_bounds__(cg_step::kThreads) cg_kernel(const Params<T> q) {
  __shared__ double sh[cg_step::kWarps];
  double* st = q.state;
  InPlace<T> v{q};
  if (q.mode == kStart) {
    const cg_step::State s = cg_step::start(v, q.m, q.n, q.tol2, sh);
    if (threadIdx.x == 0) {
      st[0] = s.rz;
      st[1] = s.stop2;
      st[2] = s.active ? 1.0 : 0.0;
      st[3] = 0.0;
    }
    return;
  }
  if (q.mode == kStep && st[2] == 0.0) return;   // the same for every thread
  cg_step::State s{st[0], st[1], true};
  cg_step::step(v, q.m, q.n, q.mode == kStep, s, sh);
  if (threadIdx.x == 0) {
    st[0] = s.rz;
    if (q.mode == kStep) st[2] = s.active ? 1.0 : 0.0;
    st[3] += 1.0;
  }
}

__global__ void empty_kernel() {}

template <typename T>
cudaError_t run(int mode, long long n, long long nposes, void* x, void* r, void* p, void* z,
                const void* v, const void* precond, const void* pose_inv, double tol2,
                double* state, cudaStream_t stream) {
  if (mode < kStart || mode > kForced || n < 1 || nposes < 0 || 7 * nposes > n ||
      (nposes > 0 && !pose_inv))
    return cudaErrorInvalidValue;
  Params<T> q{mode, n, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
              static_cast<T*>(z), static_cast<const T*>(v),
              {static_cast<const T*>(precond), static_cast<const T*>(pose_inv), nposes}, tol2,
              state};
  cg_kernel<T><<<1, cg_step::kThreads, 0, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

// One launch of one block on `stream`, without synchronising; returns the
// first CUDA error (0 for none). `elem`: 4 (float32) or 8 (float64). `mode`:
// 0 start (v = rhs), 1 step (v = A p, masked by the device's stop test), 2
// forced step (no test, no mask). x, r, p, z, v, precond [n]; pose_inv
// [nposes, 7, 7] (null with nposes 0); state [4] float64 (rz, stop2, active,
// count); all on the device, contiguous.
extern "C" int mv_cg(int elem, int mode, long long n, long long nposes, void* x, void* r,
                     void* p, void* z, const void* v, const void* precond, const void* pose_inv,
                     double tol2, double* state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 4)
    return run<float>(mode, n, nposes, x, r, p, z, v, precond, pose_inv, tol2, state, s);
  if (elem == 8)
    return run<double>(mode, n, nposes, x, r, p, z, v, precond, pose_inv, tol2, state, s);
  return cudaErrorInvalidValue;
}

// An empty kernel, one block of one thread: the least time of a launch
extern "C" int mv_cg_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
