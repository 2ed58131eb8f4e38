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
//   - in the Jacobian instantiation evaluates the functor on Jet<S, N>, N
//     the group's total tangent (the reference's Jet evaluation,
//     autodiff.h:318), each Euclidean parameter seeded with its unit
//     tangent and each manifold position with the columns of its
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
//
// One launch per evaluation. Each block sums its rho0 (warp trees, then
// its warps in order), writes the partial and takes a ticket from a
// per-program int32 counter on the card by one acquire-release atomic
// (it releases the partial, and the last block acquires every earlier
// one; its other threads read after the block's barrier); the block that
// takes the last ticket sums the partials in a fixed order (each thread a
// fixed stride, the warp trees, the warps in order), so the cost is the
// same from run to run, and sets the counter back to 0 for the next
// launch or replay. The atomics on the one counter and the final block's
// read of every partial are the price of the one launch: blocks of 512
// threads quarter both against 128 where n fills a block per SM (n >=
// kWideLanes; below, 128-thread blocks spread a small group over more
// SMs), and a grid of at most kMaxBlocks, each block striding over the
// lanes beyond, bounds them at BAL-sized n (19,532 blocks' atomics on the
// one counter cost more than the kernel's own work). The first lane of a
// thread is evaluated before the stride loop: with the loop alone, nvcc
// compiled the FoE groups' Jacobian passes 1-4% slower on the H100.
// Measured there against the parent's two launches (a fence, then a
// relaxed atomic, 256-thread blocks and the plain loop cost the FoE 3x3
// clique 5%): PERF.md §6. (Counters per group of blocks, with a sum per
// group, cost more: two rounds of atomic and sum in series.)
//
// The tangent is not split across threads. A split launch (thread (l, s)
// evaluating a slice of the columns on a narrower Jet, every slice
// recomputing the primal) was built and measured on the H100: at FoE 5x5
// (N = 25, n = 36,157) two and three slices took 0.00921 and 0.00783 ms
// against one slice's 0.00637 (PERF.md §6), and a bitwise equal split
// needed builds without FMA contraction. One Jet<S, N> pass per thread
// stays.
//
// Bound on an H100: the bytes it must move (the parameter rows, data,
// residuals and leaves) for the Fields-of-Experts groups, whose functors
// are a few multiply-adds; the Jet arithmetic (2N + 1 operations per
// product) for wide functors such as Snavely's. At the denoising sizes the
// bound is a few microseconds, so the fixed cost of a launch (and of a
// second, dependent one) and a grid of a few blocks per SM are what the
// design removes. Every intermediate stays in registers (straight-line
// code); ptxas' report says whether the live set spills. Not built with
// fast math: the transcendental functions round as CUDA's IEEE versions
// do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ctt {

// threads per block: 512 where the grid still has a block per SM (n >=
// kWideLanes, eval_kernel.generic_block), else 128
constexpr int kNarrowBlock = 128, kWideBlock = 512;
constexpr int kWideLanes = 132 * kWideBlock;
// the most blocks a launch takes; a block strides over the lanes beyond
// (eval_kernel.GENERIC_MAX_BLOCKS)
constexpr int kMaxBlocks = 2048;

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
  const S* mask;  // [n]: 0 on a pad lane of a sharded group; null: all real
};

// the residual scaling, the Jacobian scaling and alpha / |r|^2 of the
// Triggs correction (corrector.correct_batched), and rho0
template <class S>
struct Scales {
  S res, jac, alpha_sq_norm, rho0;
};

template <class G, class S>
__device__ __forceinline__ Scales<S> loss_scales(const S* r, const S* c) {
  S s = S(0);
#pragma unroll
  for (int rr = 0; rr < G::kR; ++rr) s += r[rr] * r[rr];
  Scales<S> o{S(1), S(1), S(0), s};
  if (G::kLoss) {
    S rho[3];
    G::template rho<S>(s, c, rho);
    o.rho0 = rho[0];
    const S rho1 = rho[1], rho2 = rho[2];
    const S sqrt_rho1 = f_sqrt(rho1);
    const bool inlier = (s > S(0)) && (rho2 > S(0));
    const S safe_sq_norm = inlier ? s : S(1);
    const S safe_rho1 = rho1 > S(0) ? rho1 : S(1);
    const S dd = S(1) + S(2) * s * rho2 / safe_rho1;
    const S alpha = inlier ? S(1) - f_sqrt(dd > S(0) ? dd : S(0)) : S(0);
    o.res = inlier ? sqrt_rho1 / (S(1) - alpha) : sqrt_rho1;
    o.jac = sqrt_rho1;
    o.alpha_sq_norm = inlier ? alpha / safe_sq_norm : S(0);
  }
  return o;
}

// the parameters and data of block l, gathered from the state tables
// through the read-only cache (explicitly: the kernel's atomic would
// otherwise keep the compiler from using it)
template <class G, class S>
__device__ __forceinline__ void gather(const Args<G, S>& a, int l, S* x, S* d) {
#pragma unroll
  for (int p = 0; p < G::kPos; ++p) {
    const S* row = a.tbl[p] + static_cast<size_t>(__ldg(a.rows[p] + l)) * G::amb(p);
#pragma unroll
    for (int j = 0; j < G::amb(p); ++j) x[G::aoff(p) + j] = __ldg(row + j);
  }
#pragma unroll
  for (int q = 0; q < G::kData; ++q) {
    const S* row = a.data[q] + static_cast<size_t>(l) * G::dsize(q);
#pragma unroll
    for (int j = 0; j < G::dsize(q); ++j) d[G::doff(q) + j] = __ldg(row + j);
  }
}

// the next ticket of *counter, by an acquire-release atomic at device
// scope: this thread's earlier writes are visible to the thread that takes
// a later ticket, and the earlier tickets' writes to this one
__device__ __forceinline__ int take_ticket(int* counter) {
  int prev;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

// Block l: the gather; with the Jacobian the functor on Jet<S, N>, each
// Euclidean coordinate seeded with its unit tangent and each manifold
// position with its plus-Jacobian, and the Triggs correction of every
// column into the leaves; without it the functor on S. Writes res and
// returns rho0.
template <class G, class S, bool kJac>
__device__ __forceinline__ S eval_block(const Args<G, S>& a, const S* __restrict__ c, int l,
                                        int n, S* __restrict__ res) {
  const size_t N = static_cast<size_t>(n);
  S x[G::kA];
  S d[G::kD > 0 ? G::kD : 1];
  gather(a, l, x, d);
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
  const Scales<S> sc = loss_scales<G, S>(r, c);
  // a masked lane writes 0 and returns 0 (JAX's ok_i, pallas_eval.py:483-494)
  const bool live = a.mask == nullptr || __ldg(a.mask + l) != S(0);
#pragma unroll
  for (int rr = 0; rr < G::kR; ++rr) res[rr * N + l] = live ? sc.res * r[rr] : S(0);
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
              live ? sc.jac * (out[rr].v[k] - sc.alpha_sq_norm * r[rr] * rtj) : S(0);
        }
      }
    }
  }
  return live ? sc.rho0 : S(0);
}

// sum over a warp, lane 0 holding it: a fixed tree
template <class S>
__device__ __forceinline__ S warp_sum(S v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <class G, class S, bool kJac, int kBlock>
__global__ void __launch_bounds__(kBlock)
    eval_generic_kernel(const Args<G, S> a, const S* __restrict__ c, int n,
                        S* __restrict__ res, S* __restrict__ partials, int* __restrict__ ticket,
                        S* __restrict__ cost) {
  __shared__ S sh[kBlock / 32];
  __shared__ bool last;
  S rho0 = S(0);
  const int l0 = blockIdx.x * kBlock + threadIdx.x;
  if (l0 < n) rho0 = eval_block<G, S, kJac>(a, c, l0, n, res);
  for (int l = l0 + gridDim.x * kBlock; l < n; l += gridDim.x * kBlock) {
    rho0 += eval_block<G, S, kJac>(a, c, l, n, res);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S v = warp_sum(rho0);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    S b = sh[0];
#pragma unroll
    for (int w = 1; w < kBlock / 32; ++w) b += sh[w];
    partials[blockIdx.x] = b;
    last = take_ticket(ticket) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: cost = 0.5 * sum(partials), each thread a fixed stride,
  // then the warp trees and the warps in order
  S acc = S(0);
#pragma unroll 8
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kBlock) {
    acc += __ldcg(partials + i);
  }
  acc = warp_sum(acc);
  if (lane == 0) sh[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S total = sh[0];
#pragma unroll
    for (int w = 1; w < kBlock / 32; ++w) total += sh[w];
    cost[0] = S(0.5) * total;
    *ticket = 0;
  }
}

template <class G, class S, int kBlock>
void launch_blocks(int with_jac, const Args<G, S>& a, const S* c, int n, S* res, S* partials,
                   int* ticket, S* cost, cudaStream_t stream) {
  const int tiles = n > 0 ? (n + kBlock - 1) / kBlock : 1;
  const int blocks = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  if (with_jac) {
    eval_generic_kernel<G, S, true, kBlock><<<blocks, kBlock, 0, stream>>>(a, c, n, res, partials,
                                                                          ticket, cost);
  } else {
    eval_generic_kernel<G, S, false, kBlock><<<blocks, kBlock, 0, stream>>>(
        a, c, n, res, partials, ticket, cost);
  }
}

// ptrs: tbl[kPos], rows[kPos], data[kData], leaf[kPos] (leaves unused
// without the Jacobian), mask (null, or [n] in S); partials [min(kMaxBlocks, max(1, ceil(n /
// kBlock)))]; ticket an int32 on the card that is 0 between launches.
template <class G, class S>
int launch(int with_jac, void* const* ptrs, const S* c, int n, S* res, S* partials,
           int* ticket, S* cost, cudaStream_t stream) {
  Args<G, S> a;
  int k = 0;
  for (int p = 0; p < G::kPos; ++p) a.tbl[p] = static_cast<const S*>(ptrs[k++]);
  for (int p = 0; p < G::kPos; ++p) a.rows[p] = static_cast<const int*>(ptrs[k++]);
  for (int q = 0; q < G::kData; ++q) a.data[q] = static_cast<const S*>(ptrs[k++]);
  for (int p = 0; p < G::kPos; ++p) a.leaf[p] = static_cast<S*>(ptrs[k++]);
  a.mask = static_cast<const S*>(ptrs[k++]);
  // at least one block: it writes the cost (0 for n == 0)
  if (n >= kWideLanes) {
    launch_blocks<G, S, kWideBlock>(with_jac, a, c, n, res, partials, ticket, cost, stream);
  } else {
    launch_blocks<G, S, kNarrowBlock>(with_jac, a, c, n, res, partials, ticket, cost, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctt

// The plain C entry points of one generated source (ctypes binds them):
// each returns cudaGetLastError() after its launch.
#define CTT_EVAL_GENERIC_ENTRY(G)                                                          \
  extern "C" int ctt_eval_generic_f32(int with_jac, void* const* ptrs, const float* c,     \
                                      int n, float* res, float* partials, int* ticket,     \
                                      float* cost, void* stream) {                         \
    return ctt::launch<G, float>(with_jac, ptrs, c, n, res, partials, ticket, cost,        \
                                 static_cast<cudaStream_t>(stream));                       \
  }                                                                                        \
  extern "C" int ctt_eval_generic_f64(int with_jac, void* const* ptrs, const double* c,    \
                                      int n, double* res, double* partials, int* ticket,   \
                                      double* cost, void* stream) {                        \
    return ctt::launch<G, double>(with_jac, ptrs, c, n, res, partials, ticket, cost,       \
                                  static_cast<cudaStream_t>(stream));                      \
  }
