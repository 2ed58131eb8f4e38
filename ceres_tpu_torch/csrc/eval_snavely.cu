// Kernel B1: fused Snavely reprojection evaluation of one signature group.
//
// Replaces ceres_tpu/pallas_eval.py GroupKernel.__call__ (the inner
// `kernel` of the pallas_call at pallas_eval.py:571), specialised to the
// Snavely 9+3 functor (ceres_tpu/examples/snavely.py:38).
//
// One thread per observation l:
//   - gathers camera row rows0[l] of tbl0 [cnt0, 9] and point row rows1[l]
//     of tbl1 [cnt1, 3] (the gather_T of evaluator._group_eval_pallas,
//     fused) and the observation pair obs[l] (one 8- or 16-byte load);
//   - evaluates the residual in the order of the PyTorch and JAX functors,
//     including the small-angle branch of the rotation, and, in the
//     Jacobian instantiation, its 2 x 12 Jacobian by a hand-derived chain:
//     rotation (R = dRX/dX and dRX/d(angle-axis), from the rotation's own
//     sin, cos, 1/theta and axis), translation (the identity), projection
//     (one reciprocal of the depth), distortion and focal length (a 2 x 2
//     block), then two 2 x 3 by 3 x 3 products;
//   - applies TrivialLoss or Huber(a) and the Triggs correction exactly as
//     pallas_eval._lane_corrector / corrector.correct_batched;
//   - writes res [2, n], jac0 [18, n], jac1 [6, n] (row rr*t + j,
//     observation-minor so neighbouring threads write neighbouring words)
//     and adds rho0 into its block's cost partial.
// A second single-block launch sums the per-block partials in a fixed
// order: the cost is deterministic without atomics.
//
// Bound on an H100: its arithmetic, in the earlier design of this kernel,
// which carried forward-mode duals over all 12 parameters (Jet<T, 12>)
// through every operation, 12 IEEE divides per dual quotient and separate
// sin and cos calls: the residual-only launch, which stores 2 of the 26
// rows, took 85% of the Jacobian launch's time (0.4270 against 0.5029 ms at
// BAL-1778 in float32 on an H100 80GB HBM3 at 700 W). Here each derivative is formed once, where it is born: the
// rotation's 3 x 3 blocks from its values, one reciprocal per denominator
// and one sincos, ~540 operations per observation against ~1,900, and
// the residual-only launch is its own instantiation with no derivative
// code. What is left is the 612 MB it must move (device memory) and the
// two row gathers: the camera table (64 KB) stays in L1, the point table
// in L2. Not built with fast math: sin/cos/sqrt round as PyTorch's do.

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

// Residual of snavely_reprojection_error (snavely.py) for camera c [9] and
// point X [3], and, when kJac, its Jacobian J [2][12] (columns: angle-axis,
// translation, f, k1, k2, then the point).
template <typename T, bool kJac>
__device__ __forceinline__ void snavely(const T* c, const T* X, T ox, T oy, T res[2],
                                        T J[2][12]) {
  const T a0 = c[0], a1 = c[1], a2 = c[2];
  // angle_axis_rotate_point (snavely.py:17-32): rot = R(a) X; R[i][j] =
  // d rot_i / d X_j, dRa[i][j] = d rot_i / d a_j
  const T theta2 = a0 * a0 + a1 * a1 + a2 * a2;
  T rot[3], R[3][3], dRa[3][3];
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
  } else {
    const T theta = sqrt(theta2);  // theta2 >= 1e-24: the 1e-32 clamp is idle
    T sn, cs;
    sin_cos(theta, &sn, &cs);
    const T inv = T(1) / theta;
    const T w[3] = {a0 * inv, a1 * inv, a2 * inv};
    const T wxX[3] = {w[1] * X[2] - w[2] * X[1], w[2] * X[0] - w[0] * X[2],
                      w[0] * X[1] - w[1] * X[0]};
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
        for (int j = 0; j < 3; ++j) R[i][j] = (i == j ? cs : T(0)) + sn * K[i][j] + omc * w[i] * w[j];
      }
      // d/da_j: theta' = w_j, cos' = -sin w_j, sin' = cos w_j,
      // w' = (e_j - w w_j) / theta
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T dw[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) dw[k] = ((k == j ? T(1) : T(0)) - w[k] * w[j]) * inv;
        const T dwxX[3] = {dw[1] * X[2] - dw[2] * X[1], dw[2] * X[0] - dw[0] * X[2],
                           dw[0] * X[1] - dw[1] * X[0]};
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
  const T q0 = rot[0] + c[3];
  const T q1 = rot[1] + c[4];
  const T q2 = rot[2] + c[5];
  // BAL convention: negative z plane projection
  const T iz = T(1) / q2;
  const T xp = -q0 * iz;
  const T yp = -q1 * iz;
  const T f = c[6], k1 = c[7], k2 = c[8];
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
      for (int j = 0; j < 3; ++j) {
        J[i][j] = M[i][0] * dRa[0][j] + M[i][1] * dRa[1][j] + M[i][2] * dRa[2][j];
        J[i][3 + j] = M[i][j];
        J[i][9 + j] = M[i][0] * R[0][j] + M[i][1] * R[1][j] + M[i][2] * R[2][j];
      }
      J[i][6] = dist * pr[i];
      J[i][7] = f * r2 * pr[i];
      J[i][8] = f * r2 * r2 * pr[i];
    }
  }
}

template <typename T, bool kJac>
__global__ void __launch_bounds__(kBlock)
    eval_snavely_kernel(const T* __restrict__ tbl0, const int* __restrict__ rows0,
                        const T* __restrict__ tbl1, const int* __restrict__ rows1,
                        const T* __restrict__ obs, int n, int loss_kind, double loss_a,
                        T* __restrict__ res, T* __restrict__ jac0, T* __restrict__ jac1,
                        T* __restrict__ partials) {
  __shared__ T sh[kBlock];
  const int l = blockIdx.x * kBlock + threadIdx.x;
  T rho0 = T(0);
  if (l < n) {
    const size_t N = static_cast<size_t>(n);
    const T* cam = tbl0 + static_cast<size_t>(rows0[l]) * 9;
    const T* pt = tbl1 + static_cast<size_t>(rows1[l]) * 3;
    T c[9], x[3], ox, oy;
#pragma unroll
    for (int k = 0; k < 9; ++k) c[k] = cam[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = pt[k];
    load_pair(obs + 2 * static_cast<size_t>(l), &ox, &oy);
    T r[2], J[2][12];
    snavely<T, kJac>(c, x, ox, oy, r, J);
    const T s = r[0] * r[0] + r[1] * r[1];
    T res_scale = T(1), jac_scale = T(1), alpha_sq_norm = T(0);
    if (loss_kind == 0) {
      rho0 = s;
    } else {
      T rho1, rho2;
      if (loss_kind == 1) {
        rho0 = s;
        rho1 = T(1);
        rho2 = T(0);
      } else {
        // HuberLoss.rho (loss.py)
        const T a = static_cast<T>(loss_a);
        const T a2 = static_cast<T>(loss_a * loss_a);
        const T two_a = static_cast<T>(2.0 * loss_a);
        const bool out = s > a2;
        const T sm = s > a2 ? s : a2;
        const T rt = sqrt(sm);
        rho0 = out ? two_a * rt - a2 : s;
        const T q = a / rt;
        rho1 = out ? (q > tiny_of<T>() ? q : tiny_of<T>()) : T(1);
        rho2 = out ? -rho1 / (T(2) * sm) : T(0);
      }
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
    res[l] = res_scale * r[0];
    res[N + l] = res_scale * r[1];
    if (kJac) {
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        const T rtj = r[0] * J[0][k] + r[1] * J[1][k];
        const T j0 = jac_scale * (J[0][k] - alpha_sq_norm * r[0] * rtj);
        const T j1 = jac_scale * (J[1][k] - alpha_sq_norm * r[1] * rtj);
        if (k < 9) {
          jac0[static_cast<size_t>(k) * N + l] = j0;
          jac0[static_cast<size_t>(9 + k) * N + l] = j1;
        } else {
          jac1[static_cast<size_t>(k - 9) * N + l] = j0;
          jac1[static_cast<size_t>(3 + k - 9) * N + l] = j1;
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

template <typename T>
int launch(const T* tbl0, const int* rows0, const T* tbl1, const int* rows1, const T* obs, int n,
           int loss_kind, double loss_a, int with_jac, T* res, T* jac0, T* jac1, T* partials,
           T* cost, cudaStream_t stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  if (reinterpret_cast<size_t>(obs) % (2 * sizeof(T)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks > 0) {
    if (with_jac) {
      eval_snavely_kernel<T, true><<<blocks, kBlock, 0, stream>>>(
          tbl0, rows0, tbl1, rows1, obs, n, loss_kind, loss_a, res, jac0, jac1, partials);
    } else {
      eval_snavely_kernel<T, false><<<blocks, kBlock, 0, stream>>>(
          tbl0, rows0, tbl1, rows1, obs, n, loss_kind, loss_a, res, jac0, jac1, partials);
    }
  }
  sum_partials_kernel<T><<<1, 1024, 0, stream>>>(partials, blocks, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctt_eval_snavely_f32(const float* tbl0, const int* rows0, const float* tbl1,
                                    const int* rows1, const float* obs, int n, int loss_kind,
                                    double loss_a, int with_jac, float* res, float* jac0,
                                    float* jac1, float* partials, float* cost, void* stream) {
  return launch<float>(tbl0, rows0, tbl1, rows1, obs, n, loss_kind, loss_a, with_jac, res, jac0,
                       jac1, partials, cost, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_eval_snavely_f64(const double* tbl0, const int* rows0, const double* tbl1,
                                    const int* rows1, const double* obs, int n, int loss_kind,
                                    double loss_a, int with_jac, double* res, double* jac0,
                                    double* jac1, double* partials, double* cost, void* stream) {
  return launch<double>(tbl0, rows0, tbl1, rows1, obs, n, loss_kind, loss_a, with_jac, res, jac0,
                        jac1, partials, cost, static_cast<cudaStream_t>(stream));
}
