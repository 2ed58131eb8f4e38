// Kernel B5: the SCHUR_JACOBI camera blocks of the reduced camera system.
//
// Replaces ceres_tpu/linalg/pallas_schur.py _p0_kernel (via p0_seg_call and
// p0_apply). For every camera c, over the observations l of c,
//     P_c = sum_l [ F_lᵀ F_l − (E_lᵀ F_l)ᵀ M_p(l)⁻¹ (E_lᵀ F_l) ]
// with F_l [r x tf] and E_l [r x te] the lane's blocks of the
// scale-materialized leaves and M_p⁻¹ the te x te block of the lane's point p
// in the [te*te, cnt_e] inverse table: the ridge (EᵀE)⁻¹ of schur_prepare, or
// the (EᵀE + D_e²)⁻¹ of schur_solve. The LM diagonal D_f² is the caller's.
// A lane whose point row is outside [0, cnt_e) adds F_lᵀ F_l only.
//
// tf, te and r are run-time values (tf <= kMaxTf, te <= kMaxTe). One block
// per camera, one warp per row a of P_c: the warps walk the camera CSR
// (perm[offsets[c] .. offsets[c+1]) lists its lanes in lane order) in step,
// 32 lanes at a time, so a lane's F and E columns are fetched from device
// memory once and served to the other warps from L1. Per lane, warp a forms
//     u = M⁻ᵀ (EᵀF)[:, a],   w = E u   (r values),
// and row a of the lane's block is then sum_i (F[i, a] − w_i) F[i, b]: FᵀF
// and the correction in one pass, with the tf − a sums of the upper triangle
// (b >= a) in registers. A warp-shuffle tree finishes each sum in a fixed
// order, so two runs are bitwise equal without atomics; the lower triangle is
// written as the mirror. The dump column (constant cameras) is not computed.
// The TPU kernel's (d, r*t, n_pad) segment copies, one-hot MXU reduce and
// 3-plane bf16 split serve only the TPU and have no counterpart here.
//
// Bound on an H100: device memory, read in gathers. Per observation the block
// reads the F block (r*tf values), the E block (r*te), the point row and the
// point's te*te inverse block, in camera (CSR) order rather than lane order,
// like B3. The [tf*tf, n] per-lane contributions that the plain composition
// materializes (1.6 GB in float32 at BAL-1778) never exist.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTf = 16;  // tf x 32 threads per block <= 512
constexpr int kMaxTe = 8;

template <typename T>
__global__ void __launch_bounds__(kMaxTf * 32)
    schur_p0_kernel(const T* __restrict__ F, const T* __restrict__ E,
                    const int* __restrict__ rows_e, const int* __restrict__ perm,
                    const int* __restrict__ offsets, const T* __restrict__ minv, int cnt_e,
                    int n, int r, int te, int tf, int ncols_out, T* __restrict__ out) {
  const int c = blockIdx.x;
  const int a = threadIdx.y;
  const size_t N = static_cast<size_t>(n);
  T acc[kMaxTf];
#pragma unroll
  for (int b = 0; b < kMaxTf; ++b) acc[b] = T(0);

  const int beg = offsets[c];
  const int end = offsets[c + 1];
  for (int k = beg + threadIdx.x; k < end; k += 32) {
    const int l = perm[k];
    const int p = rows_e[l];
    T u[kMaxTe];
#pragma unroll
    for (int e = 0; e < kMaxTe; ++e) u[e] = T(0);
    if (p >= 0 && p < cnt_e) {
      // (EᵀF)[:, a], then u = M⁻ᵀ (EᵀF)[:, a]
      T etf[kMaxTe];
#pragma unroll
      for (int e = 0; e < kMaxTe; ++e) etf[e] = T(0);
      for (int i = 0; i < r; ++i) {
        const T fa = F[static_cast<size_t>(i * tf + a) * N + l];
#pragma unroll
        for (int e = 0; e < kMaxTe; ++e) {
          if (e < te) etf[e] += E[static_cast<size_t>(i * te + e) * N + l] * fa;
        }
      }
#pragma unroll
      for (int e2 = 0; e2 < kMaxTe; ++e2) {
        if (e2 >= te) continue;
        T s = T(0);
#pragma unroll
        for (int e = 0; e < kMaxTe; ++e) {
          if (e < te) s += minv[static_cast<size_t>(e * te + e2) * cnt_e + p] * etf[e];
        }
        u[e2] = s;
      }
    }
    for (int i = 0; i < r; ++i) {
      T w = T(0);
#pragma unroll
      for (int e = 0; e < kMaxTe; ++e) {
        if (e < te) w += E[static_cast<size_t>(i * te + e) * N + l] * u[e];
      }
      const T g = F[static_cast<size_t>(i * tf + a) * N + l] - w;
#pragma unroll
      for (int b = 0; b < kMaxTf; ++b) {
        if (b >= a && b < tf) acc[b] += g * F[static_cast<size_t>(i * tf + b) * N + l];
      }
    }
  }

  // fixed-order reduction over the warp's 32 lanes
#pragma unroll
  for (int b = 0; b < kMaxTf; ++b) {
    if (b < a || b >= tf) continue;
    T v = acc[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) {
      out[static_cast<size_t>(a * tf + b) * ncols_out + c] = v;
      out[static_cast<size_t>(b * tf + a) * ncols_out + c] = v;
    }
  }
}

template <typename T>
int launch(const T* F, const T* E, const int* rows_e, const int* perm, const int* offsets,
           const T* minv, int cnt_e, int n, int r, int te, int tf, int ncols_out, T* out,
           cudaStream_t stream) {
  if (tf < 1 || tf > kMaxTf || te < 1 || te > kMaxTe) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ncols_out > 0) {
    schur_p0_kernel<T><<<ncols_out, dim3(32, tf), 0, stream>>>(F, E, rows_e, perm, offsets, minv,
                                                                cnt_e, n, r, te, tf, ncols_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctt_schur_p0_f32(const float* F, const float* E, const int* rows_e,
                                const int* perm, const int* offsets, const float* minv, int cnt_e,
                                int n, int r, int te, int tf, int ncols_out, float* out,
                                void* stream) {
  return launch<float>(F, E, rows_e, perm, offsets, minv, cnt_e, n, r, te, tf, ncols_out, out,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_p0_f64(const double* F, const double* E, const int* rows_e,
                                const int* perm, const int* offsets, const double* minv,
                                int cnt_e, int n, int r, int te, int tf, int ncols_out,
                                double* out, void* stream) {
  return launch<double>(F, E, rows_e, perm, offsets, minv, cnt_e, n, r, te, tf, ncols_out, out,
                        static_cast<cudaStream_t>(stream));
}
