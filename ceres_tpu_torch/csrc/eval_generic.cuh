// Kernel "B1 generic": fused evaluation of one signature group for any
// cost functor that functor_codegen.py can generate.
//
// Replaces ceres_tpu/pallas_eval.py GroupKernel.__call__ (the inner
// `kernel` of the pallas_call at pallas_eval.py:571) for every functor,
// loss and manifold the generator traces (the Snavely functors keep their
// hand-derived kernel, eval_snavely.cu). This header is the hand-written
// template; the generator emits a struct G with the group's functor,
// its manifolds' plus-Jacobians and its loss as straight-line code generic
// in the scalar types T and S, and instantiates the entry points below
// (CTT_EVAL_GENERIC_ENTRY). One nvcc run per structural signature: the
// functor's constants (a filter's taps, a loss's scale) come in the buffer
// c[], as JAX passes them as kernel inputs (_pack_const).
//
// One thread per residual block l:
//   - gathers its parameters from the [cnt, size] state table of each
//     position (rows[p][l]) and its data rows;
//   - in the Jacobian instantiation evaluates the functor on
//     Jet<S, N> (N = the group's total tangent: the reference's Jet
//     evaluation, autodiff.h:318), each Euclidean parameter seeded with its
//     unit tangent and each manifold position with the columns of its
//     plus-Jacobian, so the columns come out in tangent space
//     (pallas_eval.py:306-314); the residual-only instantiation runs the
//     functor on S itself;
//   - for a functor with an analytic rule (an AnalyticCostFunction, or
//     one nested in a larger functor) the generated code computes the
//     rule's fn and jac on the parameters' values in S and forms its
//     output's tangent as sum_k jac[:, k] x_k.v (rule_value / rule_add):
//     the user's Jacobian, chained through the plus-Jacobian columns, as
//     JAX's lane interpreter runs the inlined custom_jvp rule
//     (pallas_eval.py:47-57, 295), never the derivative of the primal;
//   - applies the traced rho and the Triggs correction as
//     pallas_eval._lane_corrector (:346-365) / corrector.correct_batched;
//   - writes res [r, n] and one [r * t_p, n] leaf per position (row
//     rr * t_p + j, pallas_eval.py:514-524; observation-minor, so
//     neighbouring threads write neighbouring words) and adds rho0 into its
//     block's cost partial.
// A second single-block launch sums the per-block partials in a fixed
// order: the cost is deterministic without atomics.
//
// Bound on an H100: the bytes it must move (the parameter rows, data,
// residuals and leaves) for the Fields-of-Experts groups, whose functors
// are a few multiply-adds; the Jet arithmetic (2N + 1 operations per
// product) for wide functors such as Snavely's. The design keeps every
// intermediate in registers (one thread per block, straight-line code);
// at N = 25 a Jet value is 26 registers, and ptxas' report says whether the
// live set spills. Not built with fast math: the transcendental functions
// round as CUDA's IEEE versions do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ctt {

constexpr int kBlock = 128;

template <class S, int N>
struct Jet {
  S a;
  S v[N];
  __device__ __forceinline__ Jet() {}
  __device__ __forceinline__ Jet(S x) : a(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = S(0);
  }
};

template <class S>
__device__ __forceinline__ S val(S x) { return x; }
template <class S, int N>
__device__ __forceinline__ S val(const Jet<S, N>& x) { return x.a; }

// an analytic rule's output (functor_codegen's "rule" node): value r, then
// one multiply-add of the rule's Jacobian entry j by each parameter input's
// tangent, as the plain version's jvp (J times the tangent) does: a
// non-finite entry reaches every column alike. In the residual-only
// instantiation (T = S) only the value remains.
template <class T, class S>
__device__ __forceinline__ T rule_value(S r) { return T(r); }
template <class S, int N>
__device__ __forceinline__ void rule_add(Jet<S, N>& o, S j, const Jet<S, N>& x) {
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] += j * x.v[k];
}
template <class S>
__device__ __forceinline__ void rule_add(S&, S, S) {}

// value `r` with tangent d * x.v
template <class S, int N>
__device__ __forceinline__ Jet<S, N> chain(const Jet<S, N>& x, S r, S d) {
  Jet<S, N> o;
  o.a = r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = d * x.v[k];
  return o;
}

// ---- arithmetic ---------------------------------------------------------
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator+(const Jet<S, N>& x, const Jet<S, N>& y) {
  Jet<S, N> o;
  o.a = x.a + y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x.v[k] + y.v[k];
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator+(const Jet<S, N>& x, S y) {
  Jet<S, N> o = x;
  o.a = x.a + y;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator+(S x, const Jet<S, N>& y) {
  Jet<S, N> o = y;
  o.a = x + y.a;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& x) {
  Jet<S, N> o;
  o.a = -x.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = -x.v[k];
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& x, const Jet<S, N>& y) {
  Jet<S, N> o;
  o.a = x.a - y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x.v[k] - y.v[k];
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& x, S y) {
  Jet<S, N> o = x;
  o.a = x.a - y;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator-(S x, const Jet<S, N>& y) {
  Jet<S, N> o;
  o.a = x - y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = -y.v[k];
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator*(const Jet<S, N>& x, const Jet<S, N>& y) {
  Jet<S, N> o;
  o.a = x.a * y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x.v[k] * y.a + x.a * y.v[k];
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator*(const Jet<S, N>& x, S y) {
  Jet<S, N> o;
  o.a = x.a * y;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x.v[k] * y;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator*(S x, const Jet<S, N>& y) {
  Jet<S, N> o;
  o.a = x * y.a;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x * y.v[k];
  return o;
}
// quotients: the value as S computes it (the residual-only instantiation
// gives the same residuals), the tangent through one reciprocal
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator/(const Jet<S, N>& x, const Jet<S, N>& y) {
  const S inv = S(1) / y.a;
  const S r = x.a / y.a;
  Jet<S, N> o;
  o.a = r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = (x.v[k] - r * y.v[k]) * inv;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator/(const Jet<S, N>& x, S y) {
  const S inv = S(1) / y;
  Jet<S, N> o;
  o.a = x.a / y;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = x.v[k] * inv;
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> operator/(S x, const Jet<S, N>& y) {
  const S inv = S(1) / y.a;
  const S r = x / y.a;
  Jet<S, N> o;
  o.a = r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = (S(0) - r * y.v[k]) * inv;
  return o;
}

// ---- functions: S overloads (float, double), then the Jet rules -------
#define CTT_S_UNARY(name, ff, df)                                      \
  __device__ __forceinline__ float f_##name(float x) { return ff(x); } \
  __device__ __forceinline__ double f_##name(double x) { return df(x); }
CTT_S_UNARY(sqrt, sqrtf, sqrt)
CTT_S_UNARY(exp, expf, exp)
CTT_S_UNARY(expm1, expm1f, expm1)
CTT_S_UNARY(log, logf, log)
CTT_S_UNARY(log1p, log1pf, log1p)
CTT_S_UNARY(sin, sinf, sin)
CTT_S_UNARY(cos, cosf, cos)
CTT_S_UNARY(tan, tanf, tan)
CTT_S_UNARY(asin, asinf, asin)
CTT_S_UNARY(acos, acosf, acos)
CTT_S_UNARY(atan, atanf, atan)
CTT_S_UNARY(sinh, sinhf, sinh)
CTT_S_UNARY(cosh, coshf, cosh)
CTT_S_UNARY(tanh, tanhf, tanh)
CTT_S_UNARY(abs, fabsf, fabs)
CTT_S_UNARY(floor, floorf, floor)
CTT_S_UNARY(ceil, ceilf, ceil)
CTT_S_UNARY(trunc, truncf, trunc)
CTT_S_UNARY(round, rintf, rint)
#undef CTT_S_UNARY

template <class S>
__device__ __forceinline__ S f_rsqrt(S x) { return S(1) / f_sqrt(x); }
template <class S>
__device__ __forceinline__ S f_recip(S x) { return S(1) / x; }
template <class S>
__device__ __forceinline__ S f_sign(S x) { return x > S(0) ? S(1) : (x < S(0) ? S(-1) : S(0)); }
template <class S>
__device__ __forceinline__ bool f_isnan(S x) { return x != x; }
template <class S>
__device__ __forceinline__ bool f_isinf(S x) { return f_abs(x) == S(INFINITY); }
template <class S>
__device__ __forceinline__ bool f_isfinite(S x) { return !f_isnan(x) && !f_isinf(x); }
__device__ __forceinline__ float f_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double f_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float f_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double f_pow(double x, double y) { return pow(x, y); }
// torch.maximum / minimum: NaN propagates
template <class S>
__device__ __forceinline__ S f_max(S x, S y) { return (x > y || x != x) ? x : y; }
template <class S>
__device__ __forceinline__ S f_min(S x, S y) { return (x < y || x != x) ? x : y; }
template <class S>
__device__ __forceinline__ S f_powc(S x, S e) { return f_pow(x, e); }
// an integer power: exponents 0-3 as products (as torch's pow does)
template <class S>
__device__ __forceinline__ S f_ipow(S x, int e) {
  if (e == 0) return S(1);
  if (e == 1) return x;
  if (e == 2) return x * x;
  if (e == 3) return x * x * x;
  return f_pow(x, S(e));
}

template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_sqrt(const Jet<S, N>& x) {
  const S r = f_sqrt(x.a);
  return chain(x, r, S(1) / (S(2) * r));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_rsqrt(const Jet<S, N>& x) {
  const S r = S(1) / f_sqrt(x.a);
  return chain(x, r, S(-0.5) * r / x.a);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_exp(const Jet<S, N>& x) {
  const S r = f_exp(x.a);
  return chain(x, r, r);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_expm1(const Jet<S, N>& x) {
  return chain(x, f_expm1(x.a), f_exp(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_log(const Jet<S, N>& x) {
  return chain(x, f_log(x.a), S(1) / x.a);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_log1p(const Jet<S, N>& x) {
  return chain(x, f_log1p(x.a), S(1) / (S(1) + x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_sin(const Jet<S, N>& x) {
  return chain(x, f_sin(x.a), f_cos(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_cos(const Jet<S, N>& x) {
  return chain(x, f_cos(x.a), -f_sin(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_tan(const Jet<S, N>& x) {
  const S t = f_tan(x.a);
  return chain(x, t, S(1) + t * t);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_asin(const Jet<S, N>& x) {
  return chain(x, f_asin(x.a), S(1) / f_sqrt(S(1) - x.a * x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_acos(const Jet<S, N>& x) {
  return chain(x, f_acos(x.a), S(-1) / f_sqrt(S(1) - x.a * x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_atan(const Jet<S, N>& x) {
  return chain(x, f_atan(x.a), S(1) / (S(1) + x.a * x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_sinh(const Jet<S, N>& x) {
  return chain(x, f_sinh(x.a), f_cosh(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_cosh(const Jet<S, N>& x) {
  return chain(x, f_cosh(x.a), f_sinh(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_tanh(const Jet<S, N>& x) {
  const S t = f_tanh(x.a);
  return chain(x, t, S(1) - t * t);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_abs(const Jet<S, N>& x) {
  return chain(x, f_abs(x.a), f_sign(x.a));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_recip(const Jet<S, N>& x) {
  const S r = S(1) / x.a;
  return chain(x, r, -r * r);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_powc(const Jet<S, N>& x, S e) {
  return chain(x, f_pow(x.a, e), e * f_pow(x.a, e - S(1)));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_ipow(const Jet<S, N>& x, int e) {
  return chain(x, f_ipow(x.a, e), S(e) * f_ipow(x.a, e - 1));
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_atan2(const Jet<S, N>& y, const Jet<S, N>& x) {
  const S inv = S(1) / (y.a * y.a + x.a * x.a);
  Jet<S, N> o;
  o.a = f_atan2(y.a, x.a);
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = (y.v[k] * x.a - x.v[k] * y.a) * inv;
  return o;
}
// torch's rule: the tangent of the larger, half of each at a tie
template <class S, int N>
__device__ __forceinline__ Jet<S, N> max_min(const Jet<S, N>& x, const Jet<S, N>& y, S r, S w) {
  Jet<S, N> o;
  o.a = r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = y.v[k] + w * (x.v[k] - y.v[k]);
  return o;
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_max(const Jet<S, N>& x, const Jet<S, N>& y) {
  const S w = x.a == y.a ? S(0.5) : (x.a > y.a ? S(1) : S(0));
  return max_min(x, y, f_max(x.a, y.a), w);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_min(const Jet<S, N>& x, const Jet<S, N>& y) {
  const S w = x.a == y.a ? S(0.5) : (x.a < y.a ? S(1) : S(0));
  return max_min(x, y, f_min(x.a, y.a), w);
}
template <class S, int N>
__device__ __forceinline__ Jet<S, N> f_pow(const Jet<S, N>& x, const Jet<S, N>& y) {
  const S r = f_pow(x.a, y.a);
  const S dx = y.a * f_pow(x.a, y.a - S(1));
  const S dy = r * f_log(x.a);
  Jet<S, N> o;
  o.a = r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.v[k] = dx * x.v[k] + dy * y.v[k];
  return o;
}

// ---- the kernel ----------------------------------------------------------
template <class G, class S>
struct Args {
  const S* tbl[G::kPos];
  const int* rows[G::kPos];
  const S* data[G::kData > 0 ? G::kData : 1];
  S* leaf[G::kPos];
};

template <class G, class S, bool kJac>
__global__ void __launch_bounds__(kBlock)
    eval_generic_kernel(const Args<G, S> a, const S* __restrict__ c, int n,
                        S* __restrict__ res, S* __restrict__ partials) {
  __shared__ S sh[kBlock];
  const int l = blockIdx.x * kBlock + threadIdx.x;
  S rho0 = S(0);
  if (l < n) {
    const size_t N = static_cast<size_t>(n);
    S x[G::kA];
#pragma unroll
    for (int p = 0; p < G::kPos; ++p) {
      const S* row = a.tbl[p] + static_cast<size_t>(a.rows[p][l]) * G::amb(p);
#pragma unroll
      for (int j = 0; j < G::amb(p); ++j) x[G::aoff(p) + j] = row[j];
    }
    S d[G::kD > 0 ? G::kD : 1];
#pragma unroll
    for (int q = 0; q < G::kData; ++q) {
      const S* row = a.data[q] + static_cast<size_t>(l) * G::dsize(q);
#pragma unroll
      for (int j = 0; j < G::dsize(q); ++j) d[G::doff(q) + j] = row[j];
    }
    using J = Jet<S, (kJac ? G::kN : 1)>;
    S r[G::kR];
    J out[kJac ? G::kR : 1];
    if constexpr (kJac) {
      J xj[G::kA];
#pragma unroll
      for (int p = 0; p < G::kPos; ++p) {
#pragma unroll
        for (int j = 0; j < G::amb(p); ++j) {
          xj[G::aoff(p) + j] = J(x[G::aoff(p) + j]);
          if (!G::manifold(p)) xj[G::aoff(p) + j].v[G::toff(p) + j] = S(1);
        }
      }
      G::template seed_manifolds<J, S>(x, c, xj);
      G::template functor<J, S>(xj, d, c, out);
#pragma unroll
      for (int rr = 0; rr < G::kR; ++rr) r[rr] = out[rr].a;
    } else {
      G::template functor<S, S>(x, d, c, r);
    }
    S s = S(0);
#pragma unroll
    for (int rr = 0; rr < G::kR; ++rr) s += r[rr] * r[rr];
    S res_scale = S(1), jac_scale = S(1), alpha_sq_norm = S(0);
    if (G::kLoss) {
      S rho[3];
      G::template rho<S>(s, c, rho);
      rho0 = rho[0];
      const S rho1 = rho[1], rho2 = rho[2];
      // Triggs correction (corrector.correct_batched)
      const S sqrt_rho1 = f_sqrt(rho1);
      const bool inlier = (s > S(0)) && (rho2 > S(0));
      const S safe_sq_norm = inlier ? s : S(1);
      const S safe_rho1 = rho1 > S(0) ? rho1 : S(1);
      const S dd = S(1) + S(2) * s * rho2 / safe_rho1;
      const S alpha = inlier ? S(1) - f_sqrt(dd > S(0) ? dd : S(0)) : S(0);
      res_scale = inlier ? sqrt_rho1 / (S(1) - alpha) : sqrt_rho1;
      jac_scale = sqrt_rho1;
      alpha_sq_norm = inlier ? alpha / safe_sq_norm : S(0);
    } else {
      rho0 = s;
    }
#pragma unroll
    for (int rr = 0; rr < G::kR; ++rr) res[rr * N + l] = res_scale * r[rr];
    if constexpr (kJac) {
#pragma unroll
      for (int p = 0; p < G::kPos; ++p) {
#pragma unroll
        for (int j = 0; j < G::tan(p); ++j) {
          const int k = G::toff(p) + j;
          S rtj = S(0);
#pragma unroll
          for (int rr = 0; rr < G::kR; ++rr) rtj += r[rr] * out[rr].v[k];
#pragma unroll
          for (int rr = 0; rr < G::kR; ++rr) {
            a.leaf[p][static_cast<size_t>(rr * G::tan(p) + j) * N + l] =
                jac_scale * (out[rr].v[k] - alpha_sq_norm * r[rr] * rtj);
          }
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
template <class S>
__global__ void __launch_bounds__(1024) eval_generic_sum_kernel(const S* __restrict__ partials,
                                                                int m, S* __restrict__ cost) {
  __shared__ S sh[1024];
  S acc = S(0);
  for (int i = threadIdx.x; i < m; i += 1024) acc += partials[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) cost[0] = S(0.5) * sh[0];
}

// ptrs: tbl[kPos], rows[kPos], data[kData], leaf[kPos] (leaves unused
// without the Jacobian)
template <class G, class S>
int launch(int with_jac, void* const* ptrs, const S* c, int n, S* res, S* partials, S* cost,
           cudaStream_t stream) {
  Args<G, S> a;
  int k = 0;
  for (int p = 0; p < G::kPos; ++p) a.tbl[p] = static_cast<const S*>(ptrs[k++]);
  for (int p = 0; p < G::kPos; ++p) a.rows[p] = static_cast<const int*>(ptrs[k++]);
  for (int q = 0; q < G::kData; ++q) a.data[q] = static_cast<const S*>(ptrs[k++]);
  for (int p = 0; p < G::kPos; ++p) a.leaf[p] = static_cast<S*>(ptrs[k++]);
  const int blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0) {
    if (with_jac) {
      eval_generic_kernel<G, S, true><<<blocks, kBlock, 0, stream>>>(a, c, n, res, partials);
    } else {
      eval_generic_kernel<G, S, false><<<blocks, kBlock, 0, stream>>>(a, c, n, res, partials);
    }
  }
  eval_generic_sum_kernel<S><<<1, 1024, 0, stream>>>(partials, blocks, cost);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// The plain C entry points of one generated source (ctypes binds them):
// each returns cudaGetLastError() after its launches.
#define CTT_EVAL_GENERIC_ENTRY(G)                                                          \
  extern "C" int ctt_eval_generic_f32(int with_jac, void* const* ptrs, const float* c,     \
                                      int n, float* res, float* partials, float* cost,     \
                                      void* stream) {                                      \
    return ctt::launch<G, float>(with_jac, ptrs, c, n, res, partials, cost,                \
                                 static_cast<cudaStream_t>(stream));                       \
  }                                                                                        \
  extern "C" int ctt_eval_generic_f64(int with_jac, void* const* ptrs, const double* c,    \
                                      int n, double* res, double* partials, double* cost,  \
                                      void* stream) {                                      \
    return ctt::launch<G, double>(with_jac, ptrs, c, n, res, partials, cost,               \
                                  static_cast<cudaStream_t>(stream));                      \
  }
