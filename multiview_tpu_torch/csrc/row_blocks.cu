// Per-row robustified residuals and block Jacobians of the bundle
// adjustment's residual families (multiview_tpu_torch/solver/row_blocks.py),
// for Hopper (sm_90a). It replaces, on the card, the per-family autograd of
// the port's plain version (k reverse passes through the residual graph, with
// per-row copies of every shared block), the counterpart of
// _pixel_row_blocks / _depth_row_blocks / _prior_row_blocks in
// multiview_tpu/solver/schur.py:88-244 (XLA code: vmap of jacrev; the JAX
// package has no pallas_call there).
//
// One launch a family; one thread a row, a block of up to 128 consecutive
// rows. A row reads its indices, gathers its bracket's two poses and its point
// itself (no [N,7] gather is written), and reads the family's sensor values
// (rig, offset, focal, centre, distortion, depth_to_image, scale) from shared
// memory, loaded by every thread of the block once. It writes
//   res   [N, k]        the robustified, masked residual,
//   J_cam [N, k, B]     the camera block, columns in the plain version's order,
//   J_pt  [N, k, 3]     the point block (none for depth against the mesh),
// into shared memory; the block then stores each of the three as the one
// contiguous span its rows make, 16 bytes a thread and store, so the solver,
// csrc/schur_mv.cu and the assembly read them as they read the plain
// version's. The block's rows are sized so that its tiles fit (rpc of degree 8
// in float64 takes 32 rows a block).
//
//   family                 k  B                       inputs a row
//   pixel (none/fov/tsai)  2  25 + d (beg7 end7 rig7  28 + d
//                                off focal ctr2 dist d)
//   pixel (rpc, degree g)  2  25 + d, d = 4 (g+1)(g+2) - 4
//                                                     28 + d / 2 (the
//                                                     undistort half is unused)
//   depth, triangulated    3  30 | 35 (beg7 end7 rig7 33 | 38
//                                off d2i 7|12 scale)
//   depth, mesh            3  30 | 35                 30 | 35
//   xyz prior              3  none                    3
//
// Derivatives: forward mode on dual numbers (Jet<T, W>: a value and W
// derivative slots), as Ceres' AutoDiffCostFunction, which the reference
// rig_calibrator uses on the same cost functors, with the chain split where
// the blocks meet. The head maps the bracket's poses, the rig and the offset
// (slerp, rig, world-to-camera) to the camera-frame point X_c of a pixel row,
// or to the depth point in the world M of a depth row; the tail maps X_c to
// the residual (projection, distortion, the Cauchy weight, the mask), or M and
// the point to it. A row evaluates the head once in plain numbers (a moving
// pixel row, dt_bracket != 0, with the offset seeded, which gives its column
// too), then the tail once with X_c (M) seeded: the residual and its k x 3
// Jacobian along X_c (M); then the tail with the sensor's own inputs seeded
// in turn (focal and centre; the distortion coefficients, or rpc's
// numerators and denominators). Each block of the head is then seeded, at
// most kPixelHeadWidth / kDepthHeadWidth inputs a pass and every other input
// a plain number (registers hold W + 1 values a live quantity), and its
// columns are the tail's k x 3 Jacobian times the head's 3 x W. The point
// block of a pixel row seeds the point through X_c = R x + t alone; a depth
// row's point block is minus the tail's Jacobian along M. A row with
// dt_bracket == 0 skips the end pose's, the rig's and the offset's passes
// (a depth row's offset column comes out 0 from its sensor pass): their
// columns are exactly 0. The value is the same in every pass (the same
// operations on the same numbers), so every branch is taken alike in every
// pass. The rpc map is differentiated by hand: along the centred pixel by
// its 2x2 Jacobian, and along its coefficients by a tail pass that seeds the
// map's two numerators and two denominators, whose derivatives along a
// coefficient are that coefficient's monomial.
//
// Precision: the arithmetic is float64 whatever the tensors' dtype (C below);
// float32 tensors are read into float64 and the outputs rounded to float32.
// In float32 the residual chain (poses far from the origin, slerp, projection)
// errs by 2e-4 to 3.4e-4 of max |res| on calibrate's families, a float32
// evaluation and the plain version's alike; in float64 the kernel meets the
// plain version's float64 result to 1e-4 of max |res| whatever the tensors'
// dtype. The branch thresholds that depend on the dtype (slerp's 16 eps, the
// norm's tiny) are the tensors' dtype's, as in the plain version.
//
// Branches: each of the plain version's branches and ties, as autograd
// differentiates them: the quaternion normalised on read (clamp_min of the
// norm at the dtype's tiny), slerp's sign flip at dot < 0, |dot| (no gradient
// at 0) clamped at 1 (no gradient above), its lerp branch at
// dot > 1 - 16 eps(T); dt_bracket == 0: alpha = 0 and the interpolated pose
// itself (the rig ignored); in the tail the camera z clamped to 1e-8 where
// |z| < 1e-8 (a zero row of the tail's Jacobian along z), fov's
// clamp_min(r^2, 1e-24) and its ru > 1e-5 branch, tsai's optional k3, the
// Cauchy weight sqrt(rho(s)/s), 1 (no gradient) at s <= 1e-20, the mask
// multiplied last; the mesh target zeroed where the ray missed before the
// residual; the prior's th <= 0 branch without a weight.
//
// Bound (chip_smoke.py phase 3d): the larger of the bytes a call must move
// over the memory rate and the FLOPs of the function itself (the value and
// its reverse-mode Jacobian, counted there a row) over the FP32 rate; bytes
// bound every family. This design's ceiling is its float64 arithmetic, not
// its bytes: a row of the benchmark's cube (dt_bracket == 0) runs the head in
// plain numbers, three tail passes of 3, 3 and 4 inputs, the begin pose's two
// head passes (4 + 3 inputs) and the point's, some 5-6k float64 operations,
// which at the card's 34 TFLOP/s of FP64 outside the tensor cores take about
// as long as the bound's bytes; the registers (168 a pixel kernel, 255 a
// depth kernel, no spill) leave 3 and 2 blocks of 128 rows an SM to hide
// the gathers and the arithmetic's latency.
//
// The arithmetic compiles for the host too (g++ -x c++), so that it can be
// checked against the plain version without a card.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MV_HD __host__ __device__ __forceinline__
#else
#define MV_HD inline
#endif

#include <cfloat>
#include <cmath>
#include <type_traits>
#include <utility>


namespace rowblocks {

using C = double;                 // the arithmetic's type, whatever the tensors' dtype
constexpr int kRows = 128;        // rows (threads) of a block at most
constexpr int kRpcMaxDeg = 8;     // the highest rpc degree the kernel takes
// Inputs a head pass seeds at most, and blocks an SM each kernel is compiled
// for (its register cap): pixel rows 4 and 3 (168 registers, no spill),
// depth rows 7 and 1 (their passes are wider; a cap spills)
constexpr int kPixelHeadWidth = 4, kPixelMinBlocks = 3;
constexpr int kDepthHeadWidth = 7;
// rpc_num_params_from_degree (geometry/distortion.py): the distort half's count
MV_HD constexpr int rpc_half(int deg) { return 2 * (deg + 1) * (deg + 2) - 2; }
// sensor values a family keeps in shared memory: 13 + the rpc distort half
constexpr int kSensorMax = 13 + rpc_half(kRpcMaxDeg);

// ---------------------------------------------------------------------------
// Scalars
// ---------------------------------------------------------------------------

MV_HD float msqrt(float x) { return sqrtf(x); }
MV_HD double msqrt(double x) { return sqrt(x); }
MV_HD float msin(float x) { return sinf(x); }
MV_HD double msin(double x) { return sin(x); }
MV_HD float mcos(float x) { return cosf(x); }
MV_HD double mcos(double x) { return cos(x); }
MV_HD float macos(float x) { return acosf(x); }
MV_HD double macos(double x) { return acos(x); }
MV_HD float matan(float x) { return atanf(x); }
MV_HD double matan(double x) { return atan(x); }
MV_HD float mtan(float x) { return tanf(x); }
MV_HD double mtan(double x) { return tan(x); }
MV_HD float mlog1p(float x) { return log1pf(x); }
MV_HD double mlog1p(double x) { return log1p(x); }
MV_HD float val(float x) { return x; }
MV_HD double val(double x) { return x; }

template <typename T> struct Lim;
template <> struct Lim<float> {
  static MV_HD float eps() { return FLT_EPSILON; }
  static MV_HD float tiny() { return FLT_MIN; }
};
template <> struct Lim<double> {
  static MV_HD double eps() { return DBL_EPSILON; }
  static MV_HD double tiny() { return DBL_MIN; }
};

// ---------------------------------------------------------------------------
// Jet<T, W>: a value and its derivatives along W seeded inputs
// ---------------------------------------------------------------------------

template <typename T, int W>
struct Jet {
  T v;
  T d[W];
  MV_HD Jet() {}
  MV_HD Jet(T x) : v(x) {
#pragma unroll
    for (int j = 0; j < W; ++j) d[j] = T(0);
  }
};

template <typename T, int W> MV_HD T val(const Jet<T, W>& a) { return a.v; }

template <typename T, int W>
MV_HD Jet<T, W> operator+(const Jet<T, W>& a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator+(const Jet<T, W>& a, T b) {
  Jet<T, W> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator+(T a, const Jet<T, W>& b) {
  Jet<T, W> r = b;
  r.v = a + b.v;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator-(const Jet<T, W>& a) {
  Jet<T, W> r;
  r.v = -a.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = -a.d[j];
  return r;
}
template <typename T, int W>
MV_HD Jet<T, W> operator-(const Jet<T, W>& a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] - b.d[j];
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator-(const Jet<T, W>& a, T b) {
  Jet<T, W> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator-(T a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a - b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = -b.d[j];
  return r;
}
template <typename T, int W>
MV_HD Jet<T, W> operator*(const Jet<T, W>& a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * b.v + a.v * b.d[j];
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator*(const Jet<T, W>& a, T b) {
  Jet<T, W> r;
  r.v = a.v * b;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * b;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator*(T a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a * b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a * b.d[j];
  return r;
}
template <typename T, int W>
MV_HD Jet<T, W> operator/(const Jet<T, W>& a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a.v / b.v;
  const T inv = T(1) / b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = (a.d[j] - r.v * b.d[j]) * inv;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator/(const Jet<T, W>& a, T b) {
  Jet<T, W> r;
  r.v = a.v / b;
  const T inv = T(1) / b;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * inv;
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> operator/(T a, const Jet<T, W>& b) {
  Jet<T, W> r;
  r.v = a / b.v;
  const T f = -r.v / b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = f * b.d[j];
  return r;
}

// f(a) with f'(a) = df: the chain rule's one multiply a slot
template <typename T, int W> MV_HD Jet<T, W> chain(const Jet<T, W>& a, T fv, T df) {
  Jet<T, W> r;
  r.v = fv;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = df * a.d[j];
  return r;
}
template <typename T, int W> MV_HD Jet<T, W> msqrt(const Jet<T, W>& a) {
  const T s = msqrt(a.v);
  return chain(a, s, T(0.5) / s);
}
template <typename T, int W> MV_HD Jet<T, W> msin(const Jet<T, W>& a) {
  return chain(a, msin(a.v), mcos(a.v));
}
template <typename T, int W> MV_HD Jet<T, W> macos(const Jet<T, W>& a) {
  return chain(a, macos(a.v), -T(1) / msqrt(T(1) - a.v * a.v));
}
template <typename T, int W> MV_HD Jet<T, W> matan(const Jet<T, W>& a) {
  return chain(a, matan(a.v), T(1) / (T(1) + a.v * a.v));
}
template <typename T, int W> MV_HD Jet<T, W> mtan(const Jet<T, W>& a) {
  const T t = mtan(a.v);
  return chain(a, t, T(1) + t * t);
}
template <typename T, int W> MV_HD Jet<T, W> mlog1p(const Jet<T, W>& a) {
  return chain(a, mlog1p(a.v), T(1) / (T(1) + a.v));
}

// The type of a op b: a Jet where either is one, else T
template <class A, class B> using Pr = decltype(std::declval<A>() + std::declval<B>());

// A block's type in a pass: Jet<C, W> where the pass seeds it, else C
template <int PASS, int BLOCK, int W>
using Blk = typename std::conditional<PASS == BLOCK, Jet<C, W>, C>::type;

template <typename T> MV_HD void seed(T& x, T v, int) { x = v; }
template <typename T, int W> MV_HD void seed(Jet<T, W>& x, T v, int slot) {
  x = Jet<T, W>(v);
  x.d[slot] = T(1);
}

// f(a, b) with df/da = da and df/db = db: the chain rule through a map
// computed by hand
MV_HD C lin2(C, C, C v, C, C) { return v; }
template <typename T, int W>
MV_HD Jet<T, W> lin2(const Jet<T, W>& a, const Jet<T, W>& b, T v, T da, T db) {
  Jet<T, W> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = da * a.d[j] + db * b.d[j];
  return r;
}

// The derivative slots of r into dst[0..W), in the tensors' dtype T
template <typename T, int W> MV_HD void emit(const Jet<C, W>& r, T* dst) {
#pragma unroll
  for (int j = 0; j < W; ++j) dst[j] = static_cast<T>(r.d[j]);
}

// ---------------------------------------------------------------------------
// Poses [tx ty tz qx qy qz qw] (geometry/pose.py)
// ---------------------------------------------------------------------------

// quat_normalize, in place: q / clamp_min(|q|, tiny of the tensors' dtype T)
template <typename T, class S> MV_HD void normalize4(S (&q)[4]) {
  S n = msqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  if (val(n) < C(Lim<T>::tiny())) n = S(C(Lim<T>::tiny()));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// pose_q: the quaternion of a pose, normalised on read
template <typename T, class S> MV_HD void pose_q(const S (&p)[7], S (&q)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = p[3 + i];
  normalize4<T>(q);
}

template <class A, class B> MV_HD void qmul(const A (&a)[4], const B (&b)[4], Pr<A, B> (&r)[4]) {
  r[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  r[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  r[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  r[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

template <class A, class B> MV_HD void cross(const A (&a)[3], const B (&b)[3], Pr<A, B> (&r)[3]) {
  r[0] = a[1] * b[2] - a[2] * b[1];
  r[1] = a[2] * b[0] - a[0] * b[2];
  r[2] = a[0] * b[1] - a[1] * b[0];
}

// quat_rotate: v + 2 (qw (qv x v) + qv x (qv x v))
template <typename T, class A, class B>
MV_HD void rotate(const A (&q)[4], const B (&v)[3], Pr<A, B> (&r)[3]) {
  using R = Pr<A, B>;
  const A qv[3] = {q[0], q[1], q[2]};
  R uv[3], uuv[3];
  cross(qv, v, uv);
  cross(qv, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = v[i] + C(2) * (q[3] * uv[i] + uuv[i]);
}

// pose_apply: R(q) x + t
template <typename T, class A, class B>
MV_HD void pose_apply(const A (&p)[7], const B (&x)[3], Pr<A, B> (&r)[3]) {
  A q[4];
  pose_q<T>(p, q);
  rotate<T>(q, x, r);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = r[i] + p[i];
}

// quat_slerp (Eigen's, short path, lerp where nearly parallel)
template <typename T, class A, class B, class AL>
MV_HD void slerp(const A (&q0)[4], const B (&q1in)[4], const AL& a, Pr<Pr<A, B>, AL> (&r)[4]) {
  using D = Pr<A, B>;
  using P = Pr<D, AL>;
  D dot = q0[0] * q1in[0] + q0[1] * q1in[1] + q0[2] * q1in[2] + q0[3] * q1in[3];
  const bool flip = val(dot) < C(0);
  B q1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q1[i] = flip ? -q1in[i] : q1in[i];
  // abs (sgn 0 at 0), then clamp to [0, 1] (no gradient outside)
  D c = flip ? -dot : dot;
  if (val(dot) == C(0) || val(c) > C(1)) c = D(val(c) > C(1) ? C(1) : C(0));
  // the lerp branch at 16 eps of the tensors' dtype, as the plain version
  const bool near = val(c) > C(1) - C(16) * C(Lim<T>::eps());
  P w0, w1;
  if (near) {
    w0 = C(1) - a;
    w1 = a;
  } else {
    const D theta = macos(c);
    const D st = msin(theta);
    w0 = msin((C(1) - a) * theta) / st;
    w1 = msin(a * theta) / st;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = w0 * q0[i] + w1 * q1[i];
  normalize4<T>(r);
}

// The type of the bracketed world->cam pose of a pass
template <class SB, class SE, class SR, class SO> using PoseT = Pr<Pr<Pr<SB, SE>, SR>, SO>;

// world_to_cam_from_bracket: ref_to_cam * interp(world->ref) at
// alpha = (dt_cam - offset) / dt_bracket; dt_bracket == 0: alpha = 0 and the
// interpolated pose itself (the rig ignored)
template <typename T, class SB, class SE, class SR, class SO>
MV_HD void world_to_cam(const SB (&beg)[7], const SE (&end)[7], const SR (&rig)[7], const SO& off,
                        C dt_cam, C dt_bracket, PoseT<SB, SE, SR, SO> (&w2c)[7]) {
  using I = Pr<Pr<SB, SE>, SO>;
  const bool degenerate = dt_bracket == C(0);
  SO alpha;
  if (degenerate)
    alpha = SO(C(0));
  else
    alpha = (dt_cam - off) / dt_bracket;
  I interp[7];
#pragma unroll
  for (int i = 0; i < 3; ++i) interp[i] = (C(1) - alpha) * beg[i] + alpha * end[i];
  SB q0[4];
  SE q1[4];
  pose_q<T>(beg, q0);
  pose_q<T>(end, q1);
  I qi[4];
  slerp<T>(q0, q1, alpha, qi);
#pragma unroll
  for (int i = 0; i < 4; ++i) interp[3 + i] = qi[i];
  if (degenerate) {
#pragma unroll
    for (int i = 0; i < 7; ++i) w2c[i] = interp[i];
    return;
  }
  // pose_compose(rig, interp): both quaternions normalised on read
  SR qa[4];
  pose_q<T>(rig, qa);
  I qb[4];
  pose_q<T>(interp, qb);
  const I it[3] = {interp[0], interp[1], interp[2]};
  Pr<SR, I> t[3];
  rotate<T>(qa, it, t);
  Pr<SR, I> q[4];
  qmul(qa, qb, q);
#pragma unroll
  for (int i = 0; i < 3; ++i) w2c[i] = t[i] + rig[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) w2c[3 + i] = q[i];
}

// sqrt(rho(s) / s) of the Cauchy loss times the mask, 1 at s <= 1e-20
template <int K, class S> MV_HD void robustify(S (&res)[K], C a2, C mask) {
  S s = res[0] * res[0];
#pragma unroll
  for (int i = 1; i < K; ++i) s = s + res[i] * res[i];
  S w = S(C(1));
  if (val(s) > C(1e-20)) w = msqrt(a2 * mlog1p(s / a2) / s);
  const S m = w * mask;
#pragma unroll
  for (int i = 0; i < K; ++i) res[i] = res[i] * m;
}

// ---------------------------------------------------------------------------
// The families: the row's inputs, the head, the tail, the row
// ---------------------------------------------------------------------------

enum Model { kNone = 0, kFov = 1, kTsai4 = 2, kTsai5 = 3, kRpc = 4 };

// The distortion coefficients a tail pass seeds (rpc: none; its coefficients
// have a pass of their own)
MV_HD constexpr int num_coeffs(int model) {
  return model == kFov ? 1 : model == kTsai4 ? 4 : model == kTsai5 ? 5 : 0;
}

// The distortion coefficients a pixel family reads: all d, or rpc's distort half
MV_HD int coeffs_read(int model, int ndist) { return model == kRpc ? ndist / 2 : ndist; }

// The rpc degree of a distort half of n coefficients (0: none fits)
MV_HD int rpc_degree(int n) {
  for (int deg = 1; deg <= kRpcMaxDeg; ++deg)
    if (rpc_half(deg) == n) return deg;
  return 0;
}

// compute_rpc (geometry/distortion.py) at the centred pixel (x, y), with the
// distort half c = [num_x | den_x | num_y | den_y] of degree deg: the powers
// xp, yp [0..deg], the numerators v, the denominators w, the map f = v / w
// and its derivatives df[c][k] along (x, y). The monomials are x^(g-i) y^i,
// g = 0..deg, i = 0..g, in the reference's order (the denominators' from
// g = 1); a power's derivative is k x^(k-1), as autograd's of x ** k.
MV_HD void rpc_map(const C* c, int deg, C x, C y, C* xp, C* yp, C (&v)[2], C (&w)[2],
                   C (&f)[2], C (&df)[2][2]) {
  const int nl = (deg + 1) * (deg + 2) / 2, dl = nl - 1;
  const C* num[2] = {c, c + nl + dl};
  const C* den[2] = {c + nl, c + 2 * nl + dl};
  xp[0] = yp[0] = C(1);
  for (int k = 1; k <= deg; ++k) {
    xp[k] = xp[k - 1] * x;
    yp[k] = yp[k - 1] * y;
  }
  C sw[2] = {C(0), C(0)}, dv[2][2] = {{C(0), C(0)}, {C(0), C(0)}};
  C dw[2][2] = {{C(0), C(0)}, {C(0), C(0)}};
  v[0] = v[1] = C(0);
  int j = 0;
  for (int g = 0; g <= deg; ++g) {
    for (int i = 0; i <= g; ++i, ++j) {
      const int a = g - i;
      const C m = xp[a] * yp[i];
      const C mx = a > 0 ? C(a) * xp[a - 1] * yp[i] : C(0);
      const C my = i > 0 ? C(i) * xp[a] * yp[i - 1] : C(0);
      for (int o = 0; o < 2; ++o) {
        v[o] += num[o][j] * m;
        dv[o][0] += num[o][j] * mx;
        dv[o][1] += num[o][j] * my;
        if (j > 0) {
          sw[o] += den[o][j - 1] * m;
          dw[o][0] += den[o][j - 1] * mx;
          dw[o][1] += den[o][j - 1] * my;
        }
      }
    }
  }
  for (int o = 0; o < 2; ++o) {
    w[o] = C(1) + sw[o];
    f[o] = v[o] / w[o];
    for (int k = 0; k < 2; ++k) df[o][k] = (dv[o][k] - f[o] * dw[o][k]) / w[o];
  }
}

// Everything a launch reads, typed (the host's RowBlocksArgs)
template <typename T>
struct Args {
  long long n;
  C weight, a2;
  int robust;
  int ndist;  // pixel: the sensor's distortion coefficients d
  const T* poses;
  const long long* beg;
  const long long* end;
  const T* points;
  const long long* pidx;
  const T* dt_cam;
  const T* dt_bracket;
  const unsigned char* mask;
  const T* rig;
  const T* offset;
  const T* pix;
  const T* focal;
  const T* ctr;
  const T* dist;
  const T* dist_half;
  const T* depth_xyz;
  const T* d2i;
  const T* dscale;
  const T* mesh_xyz;
  const unsigned char* mesh_mask;
  const T* ref_xyz;
  T* res;
  T* j_cam;
  T* j_pt;
  const int* halt;  // set: return at once (the LM loop's stop flag; null: never)
  const int* sel;   // the LM loop's current half (null: the arrays as given)
  long long half;   // bytes from half 0 to half 1 of the LM loop's halves
  int flip;         // 1: the arrays of half 1 - sel (the trial point), 0: of half sel
};

// The LM loop keeps its current and trial point, blocks and residual in two
// halves (solver/lm_step.py::Halves): Args holds half 0, and a launch reads
// the state's arrays (poses, rig, offset, intrinsics, depth_to_image, scale,
// points) and writes its outputs `o` bytes on (0: half 0, or no halves). The
// observations are not halved.
template <typename P>
MV_HD P* at_half(P* p, long long o) {
  return reinterpret_cast<P*>(reinterpret_cast<unsigned long long>(p) + o);
}

// The row's own numbers (gathered poses and point), in C
struct Row {
  C beg[7], end[7], x[3], dt_cam, dt_bracket, mask;
};

template <typename T> MV_HD void load_bracket(const Args<T>& a, long long i, Row& r,
                                              long long o = 0) {
  const T* poses = at_half(a.poses, o);
  const T* b = poses + a.beg[i] * 7;
  const T* e = poses + a.end[i] * 7;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    r.beg[j] = b[j];
    r.end[j] = e[j];
  }
  r.dt_cam = a.dt_cam[i];
  r.dt_bracket = a.dt_bracket[i];
  r.mask = a.mask[i] ? C(1) : C(0);
}

// Sensor values: rig 0-6, offset 7, then pixel: focal 8, ctr 9-10,
// dist_half 11-12, dist 13.. (rpc: the distort half); depth: d2i
// 8..8+nd-1, scale 8+nd
MV_HD int pixel_sensor_count(int model, int ndist) { return 13 + coeffs_read(model, ndist); }
template <typename T> MV_HD C pixel_sensor_value(const Args<T>& a, int i, long long o = 0) {
  if (i < 7) return at_half(a.rig, o)[i];
  if (i == 7) return at_half(a.offset, o)[0];
  if (i == 8) return at_half(a.focal, o)[0];
  if (i < 11) return at_half(a.ctr, o)[i - 9];
  if (i < 13) return a.dist_half[i - 11];
  return at_half(a.dist, o)[i - 13];
}
template <typename T> MV_HD C depth_sensor_value(const Args<T>& a, int nd, int i, long long o = 0) {
  if (i < 7) return at_half(a.rig, o)[i];
  if (i == 7) return at_half(a.offset, o)[0];
  if (i < 8 + nd) return at_half(a.d2i, o)[i - 8];
  return at_half(a.dscale, o)[0];
}
template <typename T> MV_HD void load_pixel_sensor(const Args<T>& a, int model, C* sp) {
  for (int i = 0; i < pixel_sensor_count(model, a.ndist); ++i) sp[i] = pixel_sensor_value(a, i);
}
template <typename T> MV_HD void load_depth_sensor(const Args<T>& a, int nd, C* sp) {
  for (int i = 0; i < 9 + nd; ++i) sp[i] = depth_sensor_value(a, nd, i);
}

// A head pass's inputs: block BLK's values FIRST .. FIRST + W - 1 seeded
// (slots 0 .. W - 1), its others Jets without derivative, every other block
// a plain number
template <int FIRST, int W> MV_HD void seed_at(C& x, C v, int) { x = v; }
template <int FIRST, int W, int W2> MV_HD void seed_at(Jet<C, W2>& x, C v, int i) {
  x = Jet<C, W2>(v);
  if (i >= FIRST && i < FIRST + W) x.d[i - FIRST] = C(1);
}

// The columns base .. base + W - 1 of each of the K components: the tail's
// Jacobian tx [K][3] along the split point times the head's derivatives
template <typename T, int K, int W>
MV_HD void emit_cols(const C (&tx)[K][3], const Jet<C, W> (&h)[3], T* dst, int stride) {
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int j = 0; j < W; ++j)
      dst[c * stride + j] =
          static_cast<T>(tx[c][0] * h[0].d[j] + tx[c][1] * h[1].d[j] + tx[c][2] * h[2].d[j]);
}

template <typename T, int K>
MV_HD void zero_cols(T* dst, int stride, int first, int count) {
#pragma unroll
  for (int c = 0; c < K; ++c)
    for (int j = 0; j < count; ++j) dst[c * stride + first + j] = T(0);
}

// --- pixel rows (BracketedCamError) ----------------------------------------

// The head: X_c = world_to_cam(beg, end, rig, offset) applied to the point.
// Blocks: 0 beg, 1 end, 2 rig, 3 the offset; BLK < 0 seeds none.
template <typename T, int BLK, int FIRST, int W, class X>
MV_HD void pixel_head(const Row& in, const C* sp, X (&xc)[3]) {
  using SB = Blk<BLK, 0, W>;
  using SE = Blk<BLK, 1, W>;
  using SR = Blk<BLK, 2, W>;
  using SO = Blk<BLK, 3, W>;
  SB beg[7];
  SE end[7];
  SR rig[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    seed_at<FIRST, W>(beg[i], in.beg[i], i);
    seed_at<FIRST, W>(end[i], in.end[i], i);
    seed_at<FIRST, W>(rig[i], sp[i], i);
  }
  SO off;
  seed_at<FIRST, W>(off, sp[7], 0);
  PoseT<SB, SE, SR, SO> w2c[7];
  world_to_cam<T>(beg, end, rig, off, in.dt_cam, in.dt_bracket, w2c);
  pose_apply<T>(w2c, in.x, xc);
}

// The tail from X_c: the projection (z clamped), the distortion, the residual
// and its weight. Pass 0 seeds X_c (res and its Jacobian tx along X_c), pass 1
// the focal and the centre (columns 22-24), pass 2 the distortion
// coefficients (columns 25..; rpc: its numerators and denominators, whose
// coefficients' columns are their monomials times those derivatives).
template <typename T, int MODEL, int TP>
MV_HD void pixel_tail(const C (&xv)[3], const T* pix, const C* sp, C a2, C mask, int deg, int B,
                      T* res, T* jc, C (&tx)[2][3]) {
  constexpr int D = num_coeffs(MODEL);
  constexpr bool kCoeffPass = MODEL == kRpc && TP == 2;
  constexpr bool kDistPass = TP == 2 && (D > 0);
  constexpr int DW = D > 0 ? D : 1;
  using SX = typename std::conditional<TP == 0, Jet<C, 3>, C>::type;
  using SF = typename std::conditional<TP == 1, Jet<C, 3>, C>::type;
  using SD = typename std::conditional<kDistPass, Jet<C, DW>, C>::type;
  SX xc[3];
  SF focal, ctr[2];
  SD dist[DW];
#pragma unroll
  for (int i = 0; i < 3; ++i) seed_at<0, 3>(xc[i], xv[i], i);
  seed_at<0, 3>(focal, sp[8], 0);
  seed_at<0, 3>(ctr[0], sp[9], 1);
  seed_at<0, 3>(ctr[1], sp[10], 2);
#pragma unroll
  for (int i = 0; i < DW; ++i)
    if (i < D) seed_at<0, DW>(dist[i], sp[13 + i], i);
  const C dh[2] = {sp[11], sp[12]};
  // project_rows: z clamped to 1e-8 where |z| < 1e-8
  SX z = xc[2];
  if (val(z) < C(1e-8) && val(z) > -C(1e-8)) z = SX(C(1e-8));
  using U = Pr<SF, SX>;
  const U u[2] = {focal * (xc[0] / z), focal * (xc[1] / z)};
  using V = Pr<U, SD>;
  using P = typename std::conditional<kCoeffPass, Jet<C, 4>, V>::type;
  P p[2];
  C xp[kRpcMaxDeg + 1], yp[kRpcMaxDeg + 1];
  if constexpr (MODEL == kNone) {
    for (int c = 0; c < 2; ++c) p[c] = u[c] + ctr[c] - dh[c];
  } else if constexpr (MODEL == kFov) {
    const SD pre1 = C(1) / dist[0];
    const SD pre2 = C(2) * mtan(dist[0] / C(2));
    const U nrm[2] = {u[0] / focal, u[1] / focal};
    U ss = nrm[0] * nrm[0] + nrm[1] * nrm[1];
    if (val(ss) < C(1e-24)) ss = U(C(1e-24));
    const U ru = msqrt(ss);
    V conv = V(C(1));
    if (val(ru) > C(1e-5)) conv = matan(ru * pre2) * pre1 / ru;
    for (int c = 0; c < 2; ++c) p[c] = (ctr[c] - dh[c]) + conv * nrm[c] * focal;
  } else if constexpr (MODEL == kRpc) {
    // rpc reads neither the focal nor the optical centre but through the
    // undistorted centred pixel u
    C v[2], w[2], f[2], df[2][2];
    rpc_map(sp + 13, deg, val(u[0]), val(u[1]), xp, yp, v, w, f, df);
    if constexpr (kCoeffPass) {
      P q[4];
      for (int o = 0; o < 2; ++o) {
        seed(q[2 * o], v[o], 2 * o);
        seed(q[2 * o + 1], w[o], 2 * o + 1);
        p[o] = q[2 * o] / q[2 * o + 1];
      }
    } else {
      for (int c = 0; c < 2; ++c) p[c] = lin2(u[0], u[1], f[c], df[c][0], df[c][1]);
    }
  } else {
    const U nx = u[0] / focal, ny = u[1] / focal;
    const U r2 = nx * nx + ny * ny;
    V radial = C(1) + dist[0] * r2 + dist[1] * r2 * r2;
    if constexpr (D == 5) radial = radial + dist[D - 1] * r2 * r2 * r2;
    const V dx = radial * nx + C(2) * dist[2] * nx * ny + dist[3] * (r2 + C(2) * nx * nx);
    const V dy = radial * ny + dist[2] * (r2 + C(2) * ny * ny) + C(2) * dist[3] * nx * ny;
    p[0] = dx * focal + (ctr[0] - dh[0]);
    p[1] = dy * focal + (ctr[1] - dh[1]);
  }
  P r[2];
  for (int c = 0; c < 2; ++c) r[c] = p[c] + dh[c] - C(pix[c]);
  robustify<2>(r, a2, mask);
  if constexpr (TP == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      res[c] = static_cast<T>(val(r[c]));
#pragma unroll
      for (int i = 0; i < 3; ++i) tx[c][i] = r[c].d[i];
    }
  } else if constexpr (TP == 1) {
    for (int c = 0; c < 2; ++c) emit(r[c], jc + c * B + 22);
  } else if constexpr (kCoeffPass) {
    // a coefficient's column: d r / d (its numerator or denominator) times
    // its monomial; the undistort half's columns are 0
    const int nl = (deg + 1) * (deg + 2) / 2, dl = nl - 1, nh = 2 * (nl + dl);
    for (int c = 0; c < 2; ++c) {
      T* col = jc + c * B + 25;
      const C* g = r[c].d;
      int j = 0;
      for (int e = 0; e <= deg; ++e) {
        for (int i = 0; i <= e; ++i, ++j) {
          const C m = xp[e - i] * yp[i];
          col[j] = static_cast<T>(g[0] * m);
          col[nl + dl + j] = static_cast<T>(g[2] * m);
          if (j > 0) {
            col[nl + j - 1] = static_cast<T>(g[1] * m);
            col[2 * nl + dl + j - 1] = static_cast<T>(g[3] * m);
          }
        }
      }
      for (int k = nh; k < 2 * nh; ++k) col[k] = T(0);
    }
  } else {
    for (int c = 0; c < 2; ++c) emit(r[c], jc + c * B + 25);
  }
}

// A head block's columns, kPixelHeadWidth inputs a pass
template <typename T, int BLK, int FIRST, int NB>
MV_HD void pixel_block(const Row& in, const C* sp, const C (&tx)[2][3], int B, T* jc) {
  constexpr int W = NB - FIRST < kPixelHeadWidth ? NB - FIRST : kPixelHeadWidth;
  Jet<C, W> h[3];
  pixel_head<T, BLK, FIRST, W>(in, sp, h);
  emit_cols<T, 2, W>(tx, h, jc + 7 * BLK + FIRST, B);
  if constexpr (FIRST + W < NB) pixel_block<T, BLK, FIRST + W, NB>(in, sp, tx, B, jc);
}

// A whole pixel row into res [2], jc [2, B], jp [2, 3]
template <typename T, int MODEL>
MV_HD void pixel_row_into(const Row& in, const T* pix, const C* sp, C a2, int deg, int B, T* res,
                          T* jc, T* jp) {
  C xc[3], tx[2][3];
  const bool moving = in.dt_bracket != C(0);
  Jet<C, 1> xo[3];
  if (moving) {
    // the value and the offset's derivative in one pass
    pixel_head<T, 3, 0, 1>(in, sp, xo);
#pragma unroll
    for (int i = 0; i < 3; ++i) xc[i] = xo[i].v;
  } else {
    pixel_head<T, -1, 0, 1>(in, sp, xc);
  }
  pixel_tail<T, MODEL, 0>(xc, pix, sp, a2, in.mask, deg, B, res, jc, tx);
  pixel_tail<T, MODEL, 1>(xc, pix, sp, a2, in.mask, deg, B, res, jc, tx);
  if constexpr (MODEL == kRpc || num_coeffs(MODEL) > 0)
    pixel_tail<T, MODEL, 2>(xc, pix, sp, a2, in.mask, deg, B, res, jc, tx);
  {
    // the point: X_c = R(w2c) x + t, w2c in plain numbers
    C beg[7], end[7], rig[7], w2c[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      beg[i] = in.beg[i];
      end[i] = in.end[i];
      rig[i] = sp[i];
    }
    world_to_cam<T>(beg, end, rig, sp[7], in.dt_cam, in.dt_bracket, w2c);
    Jet<C, 3> x[3], h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) seed_at<0, 3>(x[i], in.x[i], i);
    pose_apply<T>(w2c, x, h);
    emit_cols<T, 2, 3>(tx, h, jp, 3);
  }
  pixel_block<T, 0, 0, 7>(in, sp, tx, B, jc);
  if (moving) {
    pixel_block<T, 1, 0, 7>(in, sp, tx, B, jc);
    pixel_block<T, 2, 0, 7>(in, sp, tx, B, jc);
    emit_cols<T, 2, 1>(tx, xo, jc + 21, B);
  } else {
    // alpha = 0 and the rig ignored: the end pose, the rig and the offset
    // have exact zero columns
    zero_cols<T, 2>(jc, B, 7, 15);
  }
}

// --- depth rows (BracketedDepthError / BracketedDepthMeshError) ------------

// The head: the depth point in the world, M = world_to_cam(beg, end, rig,
// offset)^-1 applied to depth_to_cam(d2i, scale, xyz). Blocks: 0 beg, 1 end,
// 2 rig, 3 (offset, depth_to_image nd, scale); BLK < 0 seeds none.
template <typename T, bool AFFINE, int BLK, int FIRST, int W, class M>
MV_HD void depth_head(const Row& in, const T* xyz, const C* sp, M (&mw)[3]) {
  constexpr int ND = AFFINE ? 12 : 7;
  using SB = Blk<BLK, 0, W>;
  using SE = Blk<BLK, 1, W>;
  using SR = Blk<BLK, 2, W>;
  using SI = Blk<BLK, 3, W>;
  SB beg[7];
  SE end[7];
  SR rig[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    seed_at<FIRST, W>(beg[i], in.beg[i], i);
    seed_at<FIRST, W>(end[i], in.end[i], i);
    seed_at<FIRST, W>(rig[i], sp[i], i);
  }
  SI off, d2i[ND], scale;
  seed_at<FIRST, W>(off, sp[7], 0);
#pragma unroll
  for (int i = 0; i < ND; ++i) seed_at<FIRST, W>(d2i[i], sp[8 + i], 1 + i);
  seed_at<FIRST, W>(scale, sp[8 + ND], 1 + ND);

  using W2 = PoseT<SB, SE, SR, SI>;
  W2 w2c[7];
  world_to_cam<T>(beg, end, rig, off, in.dt_cam, in.dt_bracket, w2c);
  // depth_to_cam_points: scale * linear(d2i) x + t
  SI L[9], t[3];
  if constexpr (AFFINE) {
    for (int i = 0; i < 9; ++i) L[i] = d2i[i] * scale;
    for (int i = 0; i < 3; ++i) t[i] = d2i[9 + i];
  } else {
    SI q[4];
    for (int i = 0; i < 4; ++i) q[i] = d2i[3 + i];
    normalize4<T>(q);
    const SI xx = q[0] * q[0], yy = q[1] * q[1], zz = q[2] * q[2];
    const SI xy = q[0] * q[1], xz = q[0] * q[2], yz = q[1] * q[2];
    const SI wx = q[3] * q[0], wy = q[3] * q[1], wz = q[3] * q[2];
    const SI R[9] = {C(1) - C(2) * (yy + zz), C(2) * (xy - wz), C(2) * (xz + wy),
                     C(2) * (xy + wz), C(1) - C(2) * (xx + zz), C(2) * (yz - wx),
                     C(2) * (xz - wy), C(2) * (yz + wx), C(1) - C(2) * (xx + yy)};
    for (int i = 0; i < 9; ++i) L[i] = R[i] * scale;
    for (int i = 0; i < 3; ++i) t[i] = d2i[i];
  }
  SI mc[3];
  const C x3[3] = {C(xyz[0]), C(xyz[1]), C(xyz[2])};
  for (int i = 0; i < 3; ++i) mc[i] = L[3 * i] * x3[0] + L[3 * i + 1] * x3[1] + L[3 * i + 2] * x3[2] + t[i];
  // pose_inverse(w2c), then pose_apply (its quaternion normalised on read again)
  W2 qw[4];
  pose_q<T>(w2c, qw);
  W2 inv[7];
  for (int i = 0; i < 3; ++i) inv[3 + i] = -qw[i];
  inv[6] = qw[3];
  const W2 qi[4] = {inv[3], inv[4], inv[5], inv[6]};
  const W2 tw[3] = {w2c[0], w2c[1], w2c[2]};
  W2 ti[3];
  rotate<T>(qi, tw, ti);
  for (int i = 0; i < 3; ++i) inv[i] = -ti[i];
  pose_apply<T>(inv, mc, mw);
}

// The tail from M: r = weight (target - M), its Cauchy weight and mask; res
// and its Jacobian tm along M
template <typename T>
MV_HD void depth_tail(const C (&mv)[3], const C (&target)[3], C weight, C a2, C mask, T* res,
                      C (&tm)[3][3]) {
  Jet<C, 3> m[3], r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) seed_at<0, 3>(m[i], mv[i], i);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = weight * (target[i] - m[i]);
  robustify<3>(r, a2, mask);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    res[c] = static_cast<T>(val(r[c]));
#pragma unroll
    for (int i = 0; i < 3; ++i) tm[c][i] = r[c].d[i];
  }
}

template <typename T, bool AFFINE, int BLK, int FIRST, int NB>
MV_HD void depth_block(const Row& in, const T* xyz, const C* sp, const C (&tm)[3][3], int B,
                       T* jc) {
  constexpr int W = NB - FIRST < kDepthHeadWidth ? NB - FIRST : kDepthHeadWidth;
  Jet<C, W> h[3];
  depth_head<T, AFFINE, BLK, FIRST, W>(in, xyz, sp, h);
  emit_cols<T, 3, W>(tm, h, jc + 7 * BLK + FIRST, B);
  if constexpr (FIRST + W < NB) depth_block<T, AFFINE, BLK, FIRST + W, NB>(in, xyz, sp, tm, B, jc);
}

// A whole depth row into res [3], jc [3, B], jp [3, 3] (none for the mesh)
template <typename T, bool AFFINE, bool MESH>
MV_HD void depth_row_into(const Row& in, const T* xyz, const C (&target)[3], const C* sp,
                          C weight, C a2, T* res, T* jc, T* jp) {
  constexpr int ND = AFFINE ? 12 : 7;
  constexpr int B = 23 + ND;
  C mw[3], tm[3][3];
  depth_head<T, AFFINE, -1, 0, 1>(in, xyz, sp, mw);
  depth_tail<T>(mw, MESH ? target : in.x, weight, a2, in.mask, res, tm);
  if constexpr (!MESH) {
    // r = weight (x - M): along the point, minus the tail's Jacobian along M
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < 3; ++j) jp[c * 3 + j] = static_cast<T>(-tm[c][j]);
  }
  depth_block<T, AFFINE, 0, 0, 7>(in, xyz, sp, tm, B, jc);
  if (in.dt_bracket != C(0)) {
    depth_block<T, AFFINE, 1, 0, 7>(in, xyz, sp, tm, B, jc);
    depth_block<T, AFFINE, 2, 0, 7>(in, xyz, sp, tm, B, jc);
  } else {
    zero_cols<T, 3>(jc, B, 7, 14);
  }
  depth_block<T, AFFINE, 3, 0, 2 + ND>(in, xyz, sp, tm, B, jc);
}

// The xyz prior (XYZError), one pass: the point's three inputs
template <typename T>
MV_HD void prior_row_into(const T* pt, const T* ref, C mask, C weight, C a2, bool robust, T* res,
                          T* jp) {
  Jet<C, 3> x[3], r[3];
  for (int i = 0; i < 3; ++i) seed(x[i], C(pt[i]), i);
  for (int i = 0; i < 3; ++i) r[i] = weight * (x[i] - C(ref[i]));
  if (robust) {
    robustify<3>(r, a2, mask);
  } else {
    for (int i = 0; i < 3; ++i) r[i] = r[i] * mask;
  }
  for (int c = 0; c < 3; ++c) {
    res[c] = static_cast<T>(val(r[c]));
    emit(r[c], jp + c * 3);
  }
}

// The row's inputs gathered, then the row into the given outputs
template <typename T, int MODEL>
MV_HD void pixel_row_at(const Args<T>& a, const C* sp, long long i, T* res, T* jc, T* jp,
                        long long o = 0) {
  const int deg = MODEL == kRpc ? rpc_degree(a.ndist / 2) : 0;
  const int B = 25 + (MODEL == kRpc ? a.ndist : num_coeffs(MODEL));
  Row in;
  load_bracket(a, i, in, o);
  const T* pt = at_half(a.points, o) + a.pidx[i] * 3;
  for (int j = 0; j < 3; ++j) in.x[j] = pt[j];
  pixel_row_into<T, MODEL>(in, a.pix + 2 * i, sp, a.a2, deg, B, res, jc, jp);
}

template <typename T, bool AFFINE, bool MESH>
MV_HD void depth_row_at(const Args<T>& a, const C* sp, long long i, T* res, T* jc, T* jp,
                        long long o = 0) {
  Row in;
  load_bracket(a, i, in, o);
  C target[3] = {C(0), C(0), C(0)};
  if constexpr (MESH) {
    // mesh_target: a miss is zeroed before the residual, and masked
    const bool hit = a.mesh_mask == nullptr || a.mesh_mask[i];
    if (hit)
      for (int j = 0; j < 3; ++j) target[j] = a.mesh_xyz[3 * i + j];
    if (!hit) in.mask = C(0);
    for (int j = 0; j < 3; ++j) in.x[j] = C(0);
  } else {
    const T* pt = at_half(a.points, o) + a.pidx[i] * 3;
    for (int j = 0; j < 3; ++j) in.x[j] = pt[j];
  }
  depth_row_into<T, AFFINE, MESH>(in, a.depth_xyz + 3 * i, target, sp, a.weight, a.a2, res, jc,
                                  jp);
}

template <typename T>
MV_HD void prior_row_at(const Args<T>& a, long long i, T* res, T* jp, long long o = 0) {
  const T* pt = at_half(a.points, o) + a.pidx[i] * 3;
  const C mask = a.mask[i] ? C(1) : C(0);
  prior_row_into<T>(pt, a.ref_xyz + 3 * i, mask, a.weight, a.a2, a.robust != 0, res, jp);
}

// Row i written in place (the host build's loop)
template <typename T, int MODEL>
MV_HD void pixel_row(const Args<T>& a, const C* sp, long long i) {
  const int B = 25 + (MODEL == kRpc ? a.ndist : num_coeffs(MODEL));
  pixel_row_at<T, MODEL>(a, sp, i, a.res + 2 * i, a.j_cam + 2 * B * i, a.j_pt + 6 * i);
}

template <typename T, bool AFFINE, bool MESH>
MV_HD void depth_row(const Args<T>& a, const C* sp, long long i) {
  constexpr int B = 23 + (AFFINE ? 12 : 7);
  depth_row_at<T, AFFINE, MESH>(a, sp, i, a.res + 3 * i, a.j_cam + 3 * B * i,
                                MESH ? nullptr : a.j_pt + 9 * i);
}

template <typename T>
MV_HD void prior_row(const Args<T>& a, long long i) {
  prior_row_at<T>(a, i, a.res + 3 * i, a.j_pt + 9 * i);
}

}  // namespace rowblocks

// ---------------------------------------------------------------------------
// The host's arguments (solver/row_blocks.py::_Args mirrors this layout)
// ---------------------------------------------------------------------------

struct RowBlocksArgs {
  int family;   // 0 pixel, 1 depth, 2 prior
  int elem;     // bytes of T: 4 or 8
  int model;    // pixel: 0 none, 1 fov, 2 tsai (4 coefficients), 3 tsai (5), 4 rpc
  int affine;   // depth: depth_to_image is 12 affine numbers (else a 7-number pose)
  int mesh;     // depth: the target is the mesh point (no point block)
  int robust;   // prior: th > 0 (Cauchy); pixel and depth rows are always robust
  int ndist;    // pixel: the sensor's distortion coefficients d (rpc: both halves)
  long long n;
  double weight;
  double threshold;
  const void* poses;
  const void* beg;
  const void* end;
  const void* points;
  const void* pidx;
  const void* dt_cam;
  const void* dt_bracket;
  const void* mask;
  const void* rig;
  const void* offset;
  const void* pix;
  const void* focal;
  const void* ctr;
  const void* dist;
  const void* dist_half;
  const void* depth_xyz;
  const void* d2i;
  const void* dscale;
  const void* mesh_xyz;
  const void* mesh_mask;
  const void* ref_xyz;
  void* res;
  void* j_cam;
  void* j_pt;
  const void* halt;  // int32: where set, the launch returns at once (null: never)
  const void* sel;   // int32: the LM loop's current half, or null (see at_half)
  long long half;    // bytes from half 0 to half 1
  int flip;          // 1: evaluate the half other than sel's
};

template <typename T>
rowblocks::Args<T> typed_args(const RowBlocksArgs& h) {
  rowblocks::Args<T> a;
  a.n = h.n;
  a.weight = h.weight;
  a.a2 = h.threshold * h.threshold;
  a.robust = h.robust;
  a.ndist = h.ndist;
  a.poses = static_cast<const T*>(h.poses);
  a.beg = static_cast<const long long*>(h.beg);
  a.end = static_cast<const long long*>(h.end);
  a.points = static_cast<const T*>(h.points);
  a.pidx = static_cast<const long long*>(h.pidx);
  a.dt_cam = static_cast<const T*>(h.dt_cam);
  a.dt_bracket = static_cast<const T*>(h.dt_bracket);
  a.mask = static_cast<const unsigned char*>(h.mask);
  a.rig = static_cast<const T*>(h.rig);
  a.offset = static_cast<const T*>(h.offset);
  a.pix = static_cast<const T*>(h.pix);
  a.focal = static_cast<const T*>(h.focal);
  a.ctr = static_cast<const T*>(h.ctr);
  a.dist = static_cast<const T*>(h.dist);
  a.dist_half = static_cast<const T*>(h.dist_half);
  a.depth_xyz = static_cast<const T*>(h.depth_xyz);
  a.d2i = static_cast<const T*>(h.d2i);
  a.dscale = static_cast<const T*>(h.dscale);
  a.mesh_xyz = static_cast<const T*>(h.mesh_xyz);
  a.mesh_mask = static_cast<const unsigned char*>(h.mesh_mask);
  a.ref_xyz = static_cast<const T*>(h.ref_xyz);
  a.res = static_cast<T*>(h.res);
  a.j_cam = static_cast<T*>(h.j_cam);
  a.j_pt = static_cast<T*>(h.j_pt);
  a.halt = static_cast<const int*>(h.halt);
  a.sel = static_cast<const int*>(h.sel);
  a.half = h.half;
  a.flip = h.flip;
  return a;
}

#ifdef __CUDACC__

namespace rowblocks {

// Where a block keeps its sensor values and its rows' outputs in shared
// memory (byte offsets), and the outputs' widths a row
struct Tile {
  int res, jc, jp;       // offsets of the staged res, J_cam, J_pt
  int k, kb, kp;         // values a row: res k, J_cam k B, J_pt k 3 (0: none)
};

constexpr int kSensorBytes = kSensorMax * sizeof(C);

// bytes from the table's half 0 to the half a launch reads and writes (the
// LM loop's sel ^ flip), once a thread
template <typename T>
__device__ __forceinline__ long long half_offset(const Args<T>& a) {
  return a.sel ? ((*a.sel ^ a.flip) & 1) * a.half : 0;
}

// count values of T from shared memory to the global span dst, by every
// thread: 16-byte stores where both ends allow
template <typename T>
__device__ __forceinline__ void store_span(T* dst, const T* src, long long count) {
  long long done = 0;
  if (((reinterpret_cast<unsigned long long>(dst) | reinterpret_cast<unsigned long long>(src)) &
       15ull) == 0) {
    constexpr int kPer = 16 / sizeof(T);
    const long long n16 = count / kPer;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = threadIdx.x; i < n16; i += blockDim.x) d[i] = s[i];
    done = n16 * kPer;
  }
  for (long long i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// The block's staged outputs to their spans of res, J_cam and J_pt
template <typename T>
__device__ __forceinline__ void store_tile(const Args<T>& a, const Tile& t, const unsigned char* smem,
                                           long long row0, int rows, long long o) {
  __syncthreads();
  store_span(at_half(a.res, o) + row0 * t.k, reinterpret_cast<const T*>(smem + t.res),
             static_cast<long long>(rows) * t.k);
  if (t.kb)
    store_span(at_half(a.j_cam, o) + row0 * t.kb, reinterpret_cast<const T*>(smem + t.jc),
               static_cast<long long>(rows) * t.kb);
  if (t.kp)
    store_span(at_half(a.j_pt, o) + row0 * t.kp, reinterpret_cast<const T*>(smem + t.jp),
               static_cast<long long>(rows) * t.kp);
}

template <typename T, int MODEL>
__global__ void __launch_bounds__(kRows, kPixelMinBlocks) pixel_kernel(Args<T> a, Tile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (a.halt && *a.halt) return;  // the solve has stopped (written by an earlier launch)
  const long long o = half_offset(a);
  C* sp = reinterpret_cast<C*>(smem);
  for (int i = threadIdx.x; i < pixel_sensor_count(MODEL, a.ndist); i += blockDim.x)
    sp[i] = pixel_sensor_value(a, i, o);
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x), a.n - row0));
  const int r = threadIdx.x;
  if (r < rows)
    pixel_row_at<T, MODEL>(a, sp, row0 + r, reinterpret_cast<T*>(smem + t.res) + r * t.k,
                           reinterpret_cast<T*>(smem + t.jc) + r * t.kb,
                           reinterpret_cast<T*>(smem + t.jp) + r * t.kp, o);
  store_tile(a, t, smem, row0, rows, o);
}

template <typename T, bool AFFINE, bool MESH>
__global__ void __launch_bounds__(kRows) depth_kernel(Args<T> a, Tile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (a.halt && *a.halt) return;  // the solve has stopped (written by an earlier launch)
  const long long o = half_offset(a);
  constexpr int ND = AFFINE ? 12 : 7;
  C* sp = reinterpret_cast<C*>(smem);
  for (int i = threadIdx.x; i < 9 + ND; i += blockDim.x) sp[i] = depth_sensor_value(a, ND, i, o);
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x), a.n - row0));
  const int r = threadIdx.x;
  if (r < rows)
    depth_row_at<T, AFFINE, MESH>(a, sp, row0 + r, reinterpret_cast<T*>(smem + t.res) + r * t.k,
                                  reinterpret_cast<T*>(smem + t.jc) + r * t.kb,
                                  MESH ? nullptr : reinterpret_cast<T*>(smem + t.jp) + r * t.kp,
                                  o);
  store_tile(a, t, smem, row0, rows, o);
}

template <typename T>
__global__ void __launch_bounds__(kRows) prior_kernel(Args<T> a, Tile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (a.halt && *a.halt) return;  // the solve has stopped (written by an earlier launch)
  const long long o = half_offset(a);
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x), a.n - row0));
  const int r = threadIdx.x;
  if (r < rows)
    prior_row_at<T>(a, row0 + r, reinterpret_cast<T*>(smem + t.res) + r * t.k,
                    reinterpret_cast<T*>(smem + t.jp) + r * t.kp, o);
  store_tile(a, t, smem, row0, rows, o);
}

constexpr int kTileBudget = 52 * 1024;   // a block's shared memory, for 4 blocks an SM
constexpr int kSmemMax = 232448;         // a block's shared memory at most (sm_90)

__host__ __forceinline__ int align16h(long long b) { return static_cast<int>((b + 15) & ~15ll); }

// One launch of the family's kernel: rows a block from 128 down (in 32s) until
// its tile fits kTileBudget, else 32
template <typename T, typename Kernel>
int go(Kernel kernel, const Args<T>& a, int k, int kb, int kp, cudaStream_t stream) {
  Tile t;
  t.k = k;
  t.kb = kb;
  t.kp = kp;
  auto bytes = [&](int rows) {
    t.res = kSensorBytes;
    t.jc = t.res + align16h(static_cast<long long>(rows) * k * sizeof(T));
    t.jp = t.jc + align16h(static_cast<long long>(rows) * kb * sizeof(T));
    return t.jp + align16h(static_cast<long long>(rows) * kp * sizeof(T));
  };
  int rows = kRows;
  while (rows > 32 && bytes(rows) > kTileBudget) rows -= 32;
  const int smem = bytes(rows);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.n + rows - 1) / rows));
  kernel<<<grid, rows, smem, stream>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

// Picks the instantiation; returns -1 for a combination that has none, else
// the launch's cudaError_t
template <typename T>
int launch(const RowBlocksArgs& h, cudaStream_t s) {
  const Args<T> a = typed_args<T>(h);
  if (h.family == 0) {
    const int B = 25 + h.ndist;
    switch (h.model) {
      case kNone:
        if (h.ndist != 0) return -1;
        return go<T>(pixel_kernel<T, kNone>, a, 2, 2 * B, 6, s);
      case kFov:
        if (h.ndist != 1) return -1;
        return go<T>(pixel_kernel<T, kFov>, a, 2, 2 * B, 6, s);
      case kTsai4:
        if (h.ndist != 4) return -1;
        return go<T>(pixel_kernel<T, kTsai4>, a, 2, 2 * B, 6, s);
      case kTsai5:
        if (h.ndist != 5) return -1;
        return go<T>(pixel_kernel<T, kTsai5>, a, 2, 2 * B, 6, s);
      case kRpc:
        if (h.ndist % 2 != 0 || rpc_degree(h.ndist / 2) == 0) return -1;
        return go<T>(pixel_kernel<T, kRpc>, a, 2, 2 * B, 6, s);
      default: return -1;
    }
  }
  if (h.family == 1) {
    const int B = 23 + (h.affine ? 12 : 7);
    if (h.affine && h.mesh) return go<T>(depth_kernel<T, true, true>, a, 3, 3 * B, 0, s);
    if (h.affine) return go<T>(depth_kernel<T, true, false>, a, 3, 3 * B, 9, s);
    if (h.mesh) return go<T>(depth_kernel<T, false, true>, a, 3, 3 * B, 0, s);
    return go<T>(depth_kernel<T, false, false>, a, 3, 3 * B, 9, s);
  }
  if (h.family == 2) return go<T>(prior_kernel<T>, a, 3, 0, 9, s);
  return -1;
}

}  // namespace rowblocks

// One launch: res, J_cam and J_pt of every row of the family. Returns 0, a
// cudaError_t, or -1 for a family, model or element size it has no kernel for.
extern "C" int mv_row_blocks(const RowBlocksArgs* h, void* stream) {
  if (h->n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h->elem == 4) return rowblocks::launch<float>(*h, s);
  if (h->elem == 8) return rowblocks::launch<double>(*h, s);
  return -1;
}

#endif  // __CUDACC__
