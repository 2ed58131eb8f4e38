// Kernel B1: fused Snavely reprojection evaluation of one signature group.
//
// Replaces ceres_tpu/pallas_eval.py GroupKernel.__call__ (the inner
// `kernel` of the pallas_call at pallas_eval.py:571), specialised to the
// Snavely functors (ceres_tpu/examples/snavely.py:38 and :54), templated on
// the camera model:
//   - AngleAxisCamera: [angle-axis(3) | t(3) | f k1 k2], tangent 9;
//   - QuaternionCamera<true>: [q(4) | t(3) | f k1 k2] on
//     Quaternion x Euclidean(6), whose plus-Jacobian is fused in, so the
//     camera columns come out in its 9-wide tangent space (GroupKernel's
//     manifold branch, pallas_eval.py:306-314);
//   - QuaternionCamera<false>: the same camera without a manifold, tangent
//     10 (its ambient coordinates).
// The models share the projection, the distortion, the loss, the Triggs
// correction and the fixed-order cost reduction.
//
// One thread per observation l:
//   - gathers camera row rows0[l] of tbl0 [cnt0, amb] and point row
//     rows1[l] of tbl1 [cnt1, 3] (the gather_T of
//     evaluator._group_eval_pallas, fused) and the observation pair obs[l]
//     (one 8- or 16-byte load);
//   - evaluates the residual in the order of the PyTorch and JAX functors,
//     including the small-angle branch of the angle-axis rotation, and, in
//     the Jacobian instantiation, its 2 x (tangent + 3) Jacobian by a
//     hand-derived chain: rotation (R = dRX/dX and dRX/d(rotation
//     parameters) from the rotation's own values), translation (the
//     identity), projection (one reciprocal of the depth), distortion and
//     focal length (a 2 x 2 block), then 2 x 3 by 3 x k products. The
//     quaternion rotation p' = p + w t + v x t, t = 2 v x p
//     (rotation.unit_quaternion_rotate_point, which does not normalize q)
//     has dp'/dp = I + 2w[v]x + 2[v]x^2, dp'/dw = t and dp'/dv_j =
//     w ep + e_j x t + v x ep with ep = 2 e_j x p; with the manifold the
//     3 x 4 block dp'/dq is multiplied by the 4 x 3 plus-Jacobian PJ(q),
//     whose columns are e_i (x) q (manifolds._QuaternionBase.plus_jacobian);
//   - applies the loss by its code (none, Trivial, Huber, SoftLOne, Cauchy,
//     Arctan, Tolerant, Tukey, times the scale of any ScaledLoss around it,
//     each rho as loss.py writes it) and the Triggs correction exactly as
//     pallas_eval._lane_corrector / corrector.correct_batched;
//   - writes res [2, n], jac0 [2 * tangent, n], jac1 [6, n] (row rr*t + j,
//     observation-minor so neighbouring threads write neighbouring words)
//     and adds rho0 into its block's cost partial; a lane whose mask entry
//     is 0 (a pad lane of a sharded group: the optional mask [n] in the
//     state's dtype, JAX's mask_T) writes 0 to its residuals and Jacobian
//     columns and adds 0, and a null mask leaves every lane as it was.
// A second single-block launch sums the per-block partials in a fixed
// order: the cost is deterministic without atomics.
//
// Bound on an H100: its arithmetic, in the earlier design of this kernel,
// which carried forward-mode duals over all 12 parameters (Jet<T, 12>)
// through every operation, 12 IEEE divides per dual quotient and separate
// sin and cos calls: the residual-only launch, which stores 2 of the 26
// rows, took 85% of the Jacobian launch's time (0.4270 against 0.5029 ms at
// BAL-1778 in float32 on an H100 80GB HBM3 at 700 W). Here each derivative
// is formed once, where it is born: the rotation's 3 x 3 blocks from its
// values, one reciprocal per denominator and one sincos (the quaternion
// rotation needs none), ~540 operations per observation against ~1,900,
// and the residual-only launch is its own instantiation with no derivative
// code. What is left is the 612 MB it must move (device memory) and the
// two row gathers: the camera table (64 KB) stays in L1, the point table
// in L2. Not built with fast math: sin/cos/sqrt/log/exp round as
// PyTorch's do.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ T tiny_of();
template <>
__device__ __forceinline__ float tiny_of<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double tiny_of<double>() { return DBL_MIN; }

template <typename T>
__device__ __forceinline__ T clamp_tiny(T x) {
  return x > tiny_of<T>() ? x : tiny_of<T>();
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }

__device__ __forceinline__ void load_pair(const float* p, float* x, float* y) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  *x = v.x;
  *y = v.y;
}
__device__ __forceinline__ void load_pair(const double* p, double* x, double* y) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  *x = v.x;
  *y = v.y;
}

template <typename T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The camera models. kAmb: the camera's ambient size; kRot: the rotation's
// ambient size (the translation starts there); kRotTan: the rotation's
// columns in the Jacobian; kTan = kRotTan + 6.
//
// rotate<T, kJac>(c, X, rot, R, dRc): rot = the rotated point; with kJac,
// R[i][j] = d rot_i / d X_j and dRc[i][j] = d rot_i / d (rotation column j).
struct AngleAxisCamera {
  static constexpr int kAmb = 9, kRot = 3, kRotTan = 3, kTan = 9;

  template <typename T, bool kJac>
  __device__ __forceinline__ static void rotate(const T* c, const T X[3], T rot[3], T R[3][3],
                                                T dRa[3][kRotTan]) {
    const T a0 = c[0], a1 = c[1], a2 = c[2];
    // angle_axis_rotate_point (snavely.py:17-32)
    const T theta2 = a0 * a0 + a1 * a1 + a2 * a2;
    if (theta2 < T(1e-24)) {
      // p + a x p
      rot[0] = X[0] + (a1 * X[2] - a2 * X[1]);
      rot[1] = X[1] + (a2 * X[0] - a0 * X[2]);
      rot[2] = X[2] + (a0 * X[1] - a1 * X[0]);
      if (kJac) {
        R[0][0] = T(1), R[0][1] = -a2, R[0][2] = a1;
        R[1][0] = a2, R[1][1] = T(1), R[1][2] = -a0;
        R[2][0] = -a1, R[2][1] = a0, R[2][2] = T(1);
        dRa[0][0] = T(0), dRa[0][1] = X[2], dRa[0][2] = -X[1];
        dRa[1][0] = -X[2], dRa[1][1] = T(0), dRa[1][2] = X[0];
        dRa[2][0] = X[1], dRa[2][1] = -X[0], dRa[2][2] = T(0);
      }
      return;
    }
    const T theta = sqrt(theta2);  // theta2 >= 1e-24: the 1e-32 clamp is idle
    T sn, cs;
    sin_cos(theta, &sn, &cs);
    const T inv = T(1) / theta;
    const T w[3] = {a0 * inv, a1 * inv, a2 * inv};
    T wxX[3];
    cross(w, X, wxX);
    const T wX = w[0] * X[0] + w[1] * X[1] + w[2] * X[2];
    const T omc = T(1) - cs;
    const T tmp = wX * omc;
#pragma unroll
    for (int i = 0; i < 3; ++i) rot[i] = cs * X[i] + sn * wxX[i] + tmp * w[i];
    if (kJac) {
      // R = cos I + sin [w]x + (1 - cos) w wᵀ
      const T K[3][3] = {{T(0), -w[2], w[1]}, {w[2], T(0), -w[0]}, {-w[1], w[0], T(0)}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          R[i][j] = (i == j ? cs : T(0)) + sn * K[i][j] + omc * w[i] * w[j];
        }
      }
      // d/da_j: theta' = w_j, cos' = -sin w_j, sin' = cos w_j,
      // w' = (e_j - w w_j) / theta
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T dw[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) dw[k] = ((k == j ? T(1) : T(0)) - w[k] * w[j]) * inv;
        T dwxX[3];
        cross(dw, X, dwxX);
        const T dwX = dw[0] * X[0] + dw[1] * X[1] + dw[2] * X[2];
        const T coef = sn * w[j] * wX + omc * dwX;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          dRa[i][j] = -sn * w[j] * X[i] + cs * w[j] * wxX[i] + sn * dwxX[i] + coef * w[i] +
                      tmp * dw[i];
        }
      }
    }
  }
};

template <bool kManifold>
struct QuaternionCamera {
  static constexpr int kAmb = 10, kRot = 4, kRotTan = kManifold ? 3 : 4;
  static constexpr int kTan = kRotTan + 6;

  template <typename T, bool kJac>
  __device__ __forceinline__ static void rotate(const T* c, const T X[3], T rot[3], T R[3][3],
                                                T dRq[3][kRotTan]) {
    // unit_quaternion_rotate_point (rotation.py): t = 2 v x p,
    // p + w t + v x t; q = [w, v] as given, not normalized
    const T qw = c[0];
    const T v[3] = {c[1], c[2], c[3]};
    T vxX[3], t[3], vxt[3];
    cross(v, X, vxX);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = T(2) * vxX[i];
    cross(v, t, vxt);
#pragma unroll
    for (int i = 0; i < 3; ++i) rot[i] = X[i] + qw * t[i] + vxt[i];
    if (kJac) jacobian(qw, v, X, t, R, dRq);
  }

  // d rot / dq, ambient: column 0 (w) is t; column 1 + j (v_j) is
  // w ep + e_j x t + v x ep with ep = 2 e_j x X; and R, column j:
  // e_j + w ve + v x ve with ve = 2 v x e_j; with the manifold,
  // dRq = (d rot / dq) PJ(q)
  template <typename T>
  __device__ __forceinline__ static void jacobian(T qw, const T v[3], const T X[3], const T t[3],
                                                  T R[3][3], T dRq[3][kRotTan]) {
    T dq[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) dq[i][0] = t[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T e[3] = {T(j == 0), T(j == 1), T(j == 2)};
      T ep[3], et[3], vep[3], ve[3], vve[3];
      cross(e, X, ep);
#pragma unroll
      for (int i = 0; i < 3; ++i) ep[i] *= T(2);
      cross(e, t, et);
      cross(v, ep, vep);
      cross(v, e, ve);
#pragma unroll
      for (int i = 0; i < 3; ++i) ve[i] *= T(2);
      cross(v, ve, vve);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dq[i][1 + j] = qw * ep[i] + et[i] + vep[i];
        R[i][j] = e[i] + qw * ve[i] + vve[i];
      }
    }
    if (kManifold) {
      // PJ(q) [4][3], rows (w, x, y, z): columns e_x (x) q, e_y (x) q,
      // e_z (x) q
      const T qx = v[0], qy = v[1], qz = v[2];
      const T PJ[4][3] = {{-qx, -qy, -qz}, {qw, qz, -qy}, {-qz, qw, qx}, {qy, -qx, qw}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dRq[i][j] = dq[i][0] * PJ[0][j] + dq[i][1] * PJ[1][j] + dq[i][2] * PJ[2][j] +
                      dq[i][3] * PJ[3][j];
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < kRotTan; ++j) dRq[i][j] = dq[i][j];
      }
    }
  }
};

// Residual of the camera model's functor for camera c [kAmb] and point X
// [3], and, when kJac, its Jacobian J [2][kTan + 3] (columns: the rotation
// in tangent space, translation, f, k1, k2, then the point).
template <typename T, class Cam, bool kJac>
__device__ __forceinline__ void reprojection(const T* c, const T X[3], T ox, T oy, T res[2],
                                             T J[2][Cam::kTan + 3]) {
  constexpr int kR = Cam::kRot, kRT = Cam::kRotTan, kT = Cam::kTan;
  T rot[3], R[3][3], dRc[3][kRT];
  Cam::template rotate<T, kJac>(c, X, rot, R, dRc);
  const T q0 = rot[0] + c[kR];
  const T q1 = rot[1] + c[kR + 1];
  const T q2 = rot[2] + c[kR + 2];
  // BAL convention: negative z plane projection
  const T iz = T(1) / q2;
  const T xp = -q0 * iz;
  const T yp = -q1 * iz;
  const T f = c[kR + 3], k1 = c[kR + 4], k2 = c[kR + 5];
  const T r2 = xp * xp + yp * yp;
  const T dist = T(1) + r2 * (k1 + k2 * r2);
  const T fd = f * dist;
  res[0] = fd * xp - ox;
  res[1] = fd * yp - oy;
  if (kJac) {
    // P = d(r0, r1) / d(xp, yp); M = d(r0, r1) / dq = P d(xp, yp) / dq
    const T g = T(2) * f * (k1 + T(2) * k2 * r2);
    const T p00 = fd + g * xp * xp;
    const T p01 = g * xp * yp;
    const T p11 = fd + g * yp * yp;
    const T M[2][3] = {{-p00 * iz, -p01 * iz, -(p00 * xp + p01 * yp) * iz},
                       {-p01 * iz, -p11 * iz, -(p01 * xp + p11 * yp) * iz}};
    const T pr[2] = {xp, yp};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kRT; ++j) {
        J[i][j] = M[i][0] * dRc[0][j] + M[i][1] * dRc[1][j] + M[i][2] * dRc[2][j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        J[i][kRT + j] = M[i][j];
        J[i][kT + j] = M[i][0] * R[0][j] + M[i][1] * R[1][j] + M[i][2] * R[2][j];
      }
      J[i][kRT + 3] = dist * pr[i];
      J[i][kRT + 4] = f * r2 * pr[i];
      J[i][kRT + 5] = f * r2 * r2 * pr[i];
    }
  }
}

// The loss codes of eval_kernel.loss_code. kind 0: no loss (cost 0.5 s, no
// correction); 1 Trivial; 2 Huber(a); 3 SoftLOne(a); 4 Cauchy(a);
// 5 Arctan(a); 6 Tolerant(a, b); 7 Tukey(a). scale multiplies rho (a
// ScaledLoss around the coded loss, 1 without one); c is Tolerant's
// constant b log1p(exp(-a / b)), formed on the host.
struct LossCode {
  int kind;
  double a, b, c, scale;
};

// rho(s) as loss.py writes it for each kind; the constants are formed in
// double and rounded once to T, as PyTorch does a Python float.
template <typename T>
__device__ __forceinline__ void loss_rho(const LossCode& L, T s, T* rho0, T* rho1, T* rho2) {
  const double a = L.a;
  switch (L.kind) {
    case 2: {  // HuberLoss
      const T a2 = static_cast<T>(a * a);
      const bool out = s > a2;
      const T sm = s > a2 ? s : a2;
      const T rt = sqrt(sm);
      *rho0 = out ? static_cast<T>(2.0 * a) * rt - a2 : s;
      *rho1 = out ? clamp_tiny(static_cast<T>(a) / rt) : T(1);
      *rho2 = out ? -*rho1 / (T(2) * sm) : T(0);
      break;
    }
    case 3: {  // SoftLOneLoss
      const double b = a * a, c = 1.0 / b;
      const T total = T(1) + s * static_cast<T>(c);
      const T tmp = sqrt(total);
      *rho0 = static_cast<T>(2.0 * b) * (tmp - T(1));
      *rho1 = clamp_tiny(T(1) / tmp);
      *rho2 = -(static_cast<T>(c) * *rho1) / (T(2) * total);
      break;
    }
    case 4: {  // CauchyLoss
      const double b = a * a, c = 1.0 / b;
      const T total = T(1) + s * static_cast<T>(c);
      const T inv = T(1) / total;
      *rho0 = static_cast<T>(b) * log(total);
      *rho1 = clamp_tiny(inv);
      *rho2 = static_cast<T>(-c) * inv * inv;
      break;
    }
    case 5: {  // ArctanLoss
      const double b = 1.0 / (a * a);
      const T inv = T(1) / (T(1) + s * s * static_cast<T>(b));
      *rho0 = static_cast<T>(a) * atan2(s, static_cast<T>(a));
      *rho1 = clamp_tiny(inv);
      *rho2 = T(-2) * s * static_cast<T>(b) * inv * inv;
      break;
    }
    case 6: {  // TolerantLoss
      const T b = static_cast<T>(L.b);
      const T x = (s - static_cast<T>(a)) / b;
      const bool big = x > T(36);
      const T xs = big ? T(0) : x;
      const T ex = exp(xs);
      const T c = static_cast<T>(L.c);
      *rho0 = big ? s - static_cast<T>(a) - c : b * log1p(ex) - c;
      *rho1 = big ? T(1) : clamp_tiny(ex / (T(1) + ex));
      *rho2 = big ? T(0) : T(0.5) / (b * (T(1) + cosh(xs)));
      break;
    }
    case 7: {  // TukeyLoss
      const double a2d = a * a;
      const T a2 = static_cast<T>(a2d);
      const bool inlier = s <= a2;
      const T value = inlier ? T(1) - s / a2 : T(0);
      const T value_sq = value * value;
      *rho0 = inlier ? static_cast<T>(a2d / 3.0) * (T(1) - value_sq * value)
                     : static_cast<T>(a2d / 3.0);
      *rho1 = inlier ? value_sq : T(0);
      *rho2 = inlier ? static_cast<T>(-2.0 / a2d) * value : T(0);
      break;
    }
    default:  // 1: TrivialLoss
      *rho0 = s;
      *rho1 = T(1);
      *rho2 = T(0);
  }
  if (L.scale != 1.0) {
    const T sc = static_cast<T>(L.scale);
    *rho0 = sc * *rho0;
    *rho1 = sc * *rho1;
    *rho2 = sc * *rho2;
  }
}

template <typename T, class Cam, bool kJac>
__global__ void __launch_bounds__(kBlock)
    eval_snavely_kernel(const T* __restrict__ tbl0, const int* __restrict__ rows0,
                        const T* __restrict__ tbl1, const int* __restrict__ rows1,
                        const T* __restrict__ obs, const T* __restrict__ mask, int n,
                        LossCode loss, T* __restrict__ res, T* __restrict__ jac0,
                        T* __restrict__ jac1, T* __restrict__ partials) {
  constexpr int kT = Cam::kTan;
  __shared__ T sh[kBlock];
  const int l = blockIdx.x * kBlock + threadIdx.x;
  T rho0 = T(0);
  if (l < n) {
    const size_t N = static_cast<size_t>(n);
    const T* cam = tbl0 + static_cast<size_t>(rows0[l]) * Cam::kAmb;
    const T* pt = tbl1 + static_cast<size_t>(rows1[l]) * 3;
    T c[Cam::kAmb], x[3], ox, oy;
#pragma unroll
    for (int k = 0; k < Cam::kAmb; ++k) c[k] = cam[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pt[k];
    load_pair(obs + 2 * static_cast<size_t>(l), &ox, &oy);
    T r[2], J[2][kT + 3];
    reprojection<T, Cam, kJac>(c, x, ox, oy, r, J);
    const T s = r[0] * r[0] + r[1] * r[1];
    T res_scale = T(1), jac_scale = T(1), alpha_sq_norm = T(0);
    if (loss.kind == 0) {
      rho0 = s;
    } else {
      T rho1, rho2;
      loss_rho(loss, s, &rho0, &rho1, &rho2);
      // Triggs correction (corrector.correct_batched)
      const T sqrt_rho1 = sqrt(rho1);
      const bool inlier = (s > T(0)) && (rho2 > T(0));
      const T safe_sq_norm = inlier ? s : T(1);
      const T safe_rho1 = rho1 > T(0) ? rho1 : T(1);
      const T d = T(1) + T(2) * s * rho2 / safe_rho1;
      const T alpha = inlier ? T(1) - sqrt(d > T(0) ? d : T(0)) : T(0);
      res_scale = inlier ? sqrt_rho1 / (T(1) - alpha) : sqrt_rho1;
      jac_scale = sqrt_rho1;
      alpha_sq_norm = inlier ? alpha / safe_sq_norm : T(0);
    }
    // a pad lane of a sharded group (mask 0) writes 0 and adds nothing to
    // the cost; a null mask: every lane is real
    const bool live = mask == nullptr || mask[l] != T(0);
    if (!live) rho0 = T(0);
    res[l] = live ? res_scale * r[0] : T(0);
    res[N + l] = live ? res_scale * r[1] : T(0);
    if (kJac) {
#pragma unroll
      for (int k = 0; k < kT + 3; ++k) {
        const T rtj = r[0] * J[0][k] + r[1] * J[1][k];
        const T j0 = live ? jac_scale * (J[0][k] - alpha_sq_norm * r[0] * rtj) : T(0);
        const T j1 = live ? jac_scale * (J[1][k] - alpha_sq_norm * r[1] * rtj) : T(0);
        if (k < kT) {
          jac0[static_cast<size_t>(k) * N + l] = j0;
          jac0[static_cast<size_t>(kT + k) * N + l] = j1;
        } else {
          jac1[static_cast<size_t>(k - kT) * N + l] = j0;
          jac1[static_cast<size_t>(3 + k - kT) * N + l] = j1;
        }
      }
    }
  }
  sh[threadIdx.x] = rho0;
  __syncthreads();
  for (int w = kBlock / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
}

// cost = 0.5 * sum(partials), one block, fixed order.
template <typename T>
__global__ void __launch_bounds__(1024) sum_partials_kernel(const T* __restrict__ partials,
                                                            int m, T* __restrict__ cost) {
  __shared__ T sh[1024];
  T acc = T(0);
  for (int i = threadIdx.x; i < m; i += 1024) acc += partials[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[0] = T(0.5) * sh[0];
}

template <typename T, class Cam>
void launch_model(int blocks, cudaStream_t stream, int with_jac, const T* tbl0, const int* rows0,
                  const T* tbl1, const int* rows1, const T* obs, const T* mask, int n,
                  const LossCode& loss, T* res, T* jac0, T* jac1, T* partials) {
  if (with_jac) {
    eval_snavely_kernel<T, Cam, true><<<blocks, kBlock, 0, stream>>>(
        tbl0, rows0, tbl1, rows1, obs, mask, n, loss, res, jac0, jac1, partials);
  } else {
    eval_snavely_kernel<T, Cam, false><<<blocks, kBlock, 0, stream>>>(
        tbl0, rows0, tbl1, rows1, obs, mask, n, loss, res, jac0, jac1, partials);
  }
}

// model: 0 angle-axis, 1 quaternion on its manifold (tangent 9),
// 2 quaternion without a manifold (tangent 10)
template <typename T>
int launch(int model, const T* tbl0, const int* rows0, const T* tbl1, const int* rows1,
           const T* obs, const T* mask, int n, int loss_kind, double loss_a, double loss_b, double loss_c,
           double loss_scale, int with_jac, T* res, T* jac0, T* jac1, T* partials, T* cost,
           cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  if (reinterpret_cast<size_t>(obs) % (2 * sizeof(T)) != 0 || model < 0 || model > 2 ||
      loss_kind < 0 || loss_kind > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LossCode loss{loss_kind, loss_a, loss_b, loss_c, loss_scale};
  if (blocks > 0) {
    if (model == 0) {
      launch_model<T, AngleAxisCamera>(blocks, stream, with_jac, tbl0, rows0, tbl1, rows1, obs,
                                       mask, n, loss, res, jac0, jac1, partials);
    } else if (model == 1) {
      launch_model<T, QuaternionCamera<true>>(blocks, stream, with_jac, tbl0, rows0, tbl1, rows1,
                                              obs, mask, n, loss, res, jac0, jac1, partials);
    } else {
      launch_model<T, QuaternionCamera<false>>(blocks, stream, with_jac, tbl0, rows0, tbl1,
                                               rows1, obs, mask, n, loss, res, jac0, jac1,
                                               partials);
    }
  }
  sum_partials_kernel<T><<<1, 1024, 0, stream>>>(partials, blocks, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctt_eval_snavely_f32(int model, const float* tbl0, const int* rows0,
                                    const float* tbl1, const int* rows1, const float* obs,
                                    const float* mask, int n, int loss_kind, double loss_a,
                                    double loss_b, double loss_c, double loss_scale, int with_jac,
                                    float* res, float* jac0, float* jac1, float* partials,
                                    float* cost, void* stream) {
  return launch<float>(model, tbl0, rows0, tbl1, rows1, obs, mask, n, loss_kind, loss_a, loss_b,
                       loss_c, loss_scale, with_jac, res, jac0, jac1, partials, cost,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_eval_snavely_f64(int model, const double* tbl0, const int* rows0,
                                    const double* tbl1, const int* rows1, const double* obs,
                                    const double* mask, int n, int loss_kind, double loss_a,
                                    double loss_b, double loss_c, double loss_scale, int with_jac,
                                    double* res, double* jac0, double* jac1, double* partials,
                                    double* cost, void* stream) {
  return launch<double>(model, tbl0, rows0, tbl1, rows1, obs, mask, n, loss_kind, loss_a, loss_b,
                        loss_c, loss_scale, with_jac, res, jac0, jac1, partials, cost,
                        static_cast<cudaStream_t>(stream));
}
