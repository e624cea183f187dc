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
// reductions: each thread sums its entries in index order, then a fixed
// butterfly of shuffles a warp and one over the warps. The order never
// changes, so two processes with the same inputs get the same bits (no
// atomics). Every dot, alpha and beta is taken in float64; the vectors are
// stored in the tensors' dtype. The launches of one CG solve:
//
//   start   x = 0, r = rhs, z = M^-1 r, p = z, rz = r.z, stop2 = tol^2 rhs.rhs,
//           active = (r.r > stop2), the step count 0
//   step    (after the matvec Ap = S p; none of this where `active` is 0)
//           alpha = rz / p.Ap (0 where p.Ap <= 0); x += alpha p; r -= alpha Ap;
//           z = M^-1 r; beta = r.z / rz (rz taken as 1 where it is <= 0);
//           p = z + beta p; rz = r.z; the count + 1; then the stop test of the
//           next step, active = (r.r > stop2)
//   forced  a step with no stop test and no mask (debug_force_cg)
//
// M^-1: the SCHUR_JACOBI 7x7 inverses on the first 7 nposes entries and the
// scalar preconditioner on the rest (nposes = 0: Jacobi, the scalar one on
// every entry). The state (rz, stop2, active, count) lives in four float64
// on the device; the host reads `active` every CG_CHECK_EVERY steps.
//
// Bound: the launch. A step reads 5 vectors and writes 4 (C = 1143 at the
// cube: about 40 KB, 0.01 us at 3.35 TB/s), so its least time is that of a
// launch; the library also holds an empty kernel (mv_cg_empty) to measure it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStart = 0, kStep = 1, kForced = 2;

template <typename T>
struct Params {
  int mode;
  long long n, nposes;
  T* x;
  T* r;
  T* p;
  T* z;                     // scratch: M^-1 r
  const T* v;               // rhs (start) or Ap (step)
  const T* precond;         // [n] the scalar preconditioner
  const T* pose_inv;        // [nposes, 7, 7] (null with nposes 0)
  double tol2;              // cg_tolerance^2
  double* state;            // [4]: rz, stop2, active, count
};

// The block's sum of v, the same bits in every thread: a butterfly a warp (a
// lane adds its partner's partial to its own: a + b and b + a are one
// number), then the same over the warps' sums
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

// (M^-1 r)[i], r as stored
template <typename T>
__device__ __forceinline__ double apply(const Params<T>& p, long long i) {
  if (i < 7 * p.nposes) {
    const long long pose = i / 7, row = i % 7;
    const T* m = p.pose_inv + pose * 49 + row * 7;
    const T* rr = p.r + pose * 7;
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < 7; ++j) s += static_cast<double>(m[j]) * static_cast<double>(rr[j]);
    return s;
  }
  return static_cast<double>(p.precond[i]) * static_cast<double>(p.r[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_kernel(const Params<T> p) {
  __shared__ double sh[kWarps];
  double* st = p.state;
  const long long n = p.n;
  if (p.mode == kStart) {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      p.r[i] = p.v[i];
      p.x[i] = T(0);
    }
    __syncthreads();
    double rz = 0.0, rr = 0.0;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      const T z = static_cast<T>(apply(p, i));
      p.p[i] = z;
      const double ri = static_cast<double>(p.r[i]);
      rz += ri * static_cast<double>(z);
      rr += ri * ri;
    }
    rz = block_sum(rz, sh);
    rr = block_sum(rr, sh);
    if (threadIdx.x == 0) {
      st[0] = rz;
      st[1] = p.tol2 * rr;
      st[2] = rr > st[1] ? 1.0 : 0.0;
      st[3] = 0.0;
    }
    return;
  }
  if (p.mode == kStep && st[2] == 0.0) return;   // the same for every thread
  const double rz = st[0];
  double pap = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    pap += static_cast<double>(p.p[i]) * static_cast<double>(p.v[i]);
  pap = block_sum(pap, sh);
  const double alpha = pap > 0.0 ? rz / pap : 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const double pi = static_cast<double>(p.p[i]);
    p.x[i] = static_cast<T>(static_cast<double>(p.x[i]) + alpha * pi);
    p.r[i] = static_cast<T>(static_cast<double>(p.r[i]) - alpha * static_cast<double>(p.v[i]));
  }
  __syncthreads();                 // z reads the other entries of a pose's r
  double rzn = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const T z = static_cast<T>(apply(p, i));
    p.z[i] = z;
    rzn += static_cast<double>(p.r[i]) * static_cast<double>(z);
  }
  rzn = block_sum(rzn, sh);
  const double beta = rzn / (rz > 0.0 ? rz : 1.0);
  double rr = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    p.p[i] = static_cast<T>(static_cast<double>(p.z[i]) + beta * static_cast<double>(p.p[i]));
    const double ri = static_cast<double>(p.r[i]);
    rr += ri * ri;
  }
  rr = block_sum(rr, sh);
  if (threadIdx.x == 0) {
    st[0] = rzn;
    if (p.mode == kStep) st[2] = rr > st[1] ? 1.0 : 0.0;
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
  Params<T> q{mode, n, nposes, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
              static_cast<T*>(z), static_cast<const T*>(v), static_cast<const T*>(precond),
              static_cast<const T*>(pose_inv), tol2, state};
  cg_kernel<T><<<1, kThreads, 0, stream>>>(q);
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
