// The arithmetic of an LM iteration's trial point (the counterpart of
// multiview_tpu/solver/schur.py:1244-1247), shared by lm_step.cu's
// trial_kernel and the tail of schur_mv.cu's cg_solve_kernel, so that both
// give the same bits from the same inputs:
//
//   camera entry   cam_t = clamp(cam + x * cam_free, lower, upper),
//                  step_c = cam_t - cam
//   point          dp = Hpp^-1 (-g_p - J_p^T u) (the 3x3 product in float64),
//                  pts_t = points + dp
//
// Every operation is an explicitly rounded intrinsic: no multiply-add is
// contracted differently in the two kernels.

#pragma once

#include <cuda_runtime.h>

namespace lm_trial {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {   // torch.maximum: NaN from either side
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// cam_t of entry i (lower, upper: null where unbounded); step_c = cam_t - c
template <typename T>
__device__ __forceinline__ T camera(T c, T x, T cf, const T* lower, const T* upper, long long i,
                                    T& step) {
  // x * cam_free is exact (cam_free is 0 or 1): one rounding, as the plain sum
  T v = add(c, mul(x, cf));
  if (lower) v = tmax(v, lower[i]);
  if (upper) v = tmin(v, upper[i]);
  step = sub(v, c);
  return v;
}

// dp of one point from its Hpp^-1 (h3, row-major), g_p and J_p^T u
template <typename T>
__device__ __forceinline__ void point(const T* h3, const T (&g_p)[3], const T (&jtp_u)[3],
                                      T (&dp)[3]) {
  double g[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = static_cast<double>(sub(-g_p[j], jtp_u[j]));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const double s = __dadd_rn(__dadd_rn(__dmul_rn(static_cast<double>(h3[3 * r]), g[0]),
                                         __dmul_rn(static_cast<double>(h3[3 * r + 1]), g[1])),
                               __dmul_rn(static_cast<double>(h3[3 * r + 2]), g[2]));
    dp[r] = static_cast<T>(s);
  }
}

}  // namespace lm_trial
