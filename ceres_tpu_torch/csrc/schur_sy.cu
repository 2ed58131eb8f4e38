// Kernel B4: the PCG matvec of the reduced camera system, S·y, whole.
//
// Replaces ceres_tpu/linalg/pallas_schur.py _sy_kernel (via _seg_call and
// sy_apply). With F [r*tf, n] and E [r*te, n] the scale-materialized camera
// and point leaves and M_p⁻¹ = (EᵀE + D_e²)⁻¹ the te x te block of point p
// (the inverse table minv [te*te, cnt_e]),
//     S y = Fᵀ (F y − E t2) (+ D_f² y),   t2_p = M_p⁻¹ Σ_{j of p} E_jᵀ F_j y.
// The TPU kernel does it in one pass over (d, r*t, n_pad) segment copies and
// keeps t1 = F y in VMEM scratch. Here the sum over a point's observations
// and the sum over a camera's observations run in two orders, so two passes,
// and no [r, n] intermediate reaches device memory:
//
//   (a) point pass (sy_point_kernel), one thread per point, in place on the
//       bucket layout: observation j of point p sits at lane
//       lane_start + j*n_seg + (p - out_row) (program.py), so across a warp
//       consecutive points read consecutive lanes of the lane-order F and E,
//       each once. The thread gathers y for each observation's camera, forms
//       t1_j = F_j y and s = Σ_j E_jᵀ t1_j in registers, then t2 = M_p⁻¹ s,
//       and writes only t2, point-major [cnt_e, ld] (ld = te rounded up to
//       4: one aligned record per point), 16 MB at BAL-1778 in float32,
//       which stays in the 50 MB L2 for pass (b).
//   (b) slot pass (sy_fold_kernel), one block per chunk of one camera's slots
//       (program.camera_layout) on the camera-ordered twins of F and E and
//       the point row of each slot, the inputs kernel B5 takes. The block
//       loads its camera's y column once; each thread takes slots tid,
//       tid + 256, ...: it gathers the slot's t2 record, forms
//       diff = F_slot y_c − E_slot t2 in registers and adds F_slotᵀ diff into
//       its tf sums. A warp-shuffle tree and a fixed pass over the warps give
//       the chunk's column of partial [tf, nchunks].
//   finish (camera_chunks.cuh, as B3 and B5 combine), one thread per
//       output: a camera's chunks added in index order, then + D_f² y when
//       the caller passes D_f², rounded as a product and then a sum (no
//       FMA), so that folding it here changes no bits against out + dsq·y;
//       the dump column (constant cameras) is 0.
// Two runs are bitwise equal without atomics.
//
// Bound on an H100: device memory. Per observation pass (a) reads the F and
// E blocks and a camera row once, coalesced, and gathers tf values of y (a
// [tf, ncols] table that stays in L1/L2); pass (b) reads the twins and a
// point row once, coalesced, and gathers one t2 record from L2. The earlier
// design of this kernel wrote diff = t1 − E t2 [r, n] to device memory, read
// E twice and then gathered diff at random in a second kernel (B3); this one
// streams the leaves twice and moves no intermediate of size n. The twins and leaves are
// loaded with ld.global.cs (evict-first), so their stream does not push t2
// and y out of L2. The BA shape (r, tf, te) = (2, 9, 3) has its own
// instantiation with every loop unrolled; other shapes within sy_meta's
// bounds run a generic one, sized for the largest (in float32 its slot pass
// takes 128 registers against 48, and S·y at BAL-1778 on an H100 runs
// ~1.6x slower on it: PERF.md, PR 4).
//
// Leaves of float, double or bfloat16 (leaf.cuh). bfloat16 leaves are the
// mixed-precision solves' matvec (_sy_kernel with bf16=True): F, E and their
// twins are bfloat16, everything else float. The vector operands are rounded
// to bfloat16 where _sy_kernel casts them to the leaf type: y as it is
// gathered (pallas_schur.py:308-309), t1 before Eᵀt1 (:319-320), t2 before
// E t2 (:335-338) and diff before Fᵀdiff (:343); t2 = M⁻¹ s, every product
// and every sum stay float, and the output is float. _sy_kernel forms t1 in
// bfloat16 and subtracts that value in diff = t1 − E t2, so the slot pass
// subtracts the rounded t1 too: the point pass derived t2 from it, and diff
// stays the projection of one t1 (linalg/schur_kernels.py). The passes, their
// loads and the combine are those of float, with half the leaf bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "camera_chunks.cuh"
#include "leaf.cuh"

namespace {

constexpr int kBlock = 256;  // threads per block of both passes
constexpr int kWarps = kBlock / 32;
constexpr int kMaxR = 4;
constexpr int kMaxTf = 16;
constexpr int kMaxTe = 8;
constexpr int kMaxRTf = 32;

// one 4-value record, 16-byte aligned
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Pass (a). kExact: r, tf, te are kR, kTf, kTe (and ld == 4 == kTe + 1);
// otherwise they are run-time values bounded by them.
template <typename L, int kR, int kTf, int kTe, bool kExact>
__global__ void __launch_bounds__(kBlock)
    sy_point_kernel(const L* __restrict__ F, const L* __restrict__ E,
                    const int* __restrict__ rows_f,
                    const typename leaf::Leaf<L>::V* __restrict__ y, int ncols_f,
                    const int* __restrict__ segs, const int* __restrict__ pt_start,
                    int nb, int num_points, const typename leaf::Leaf<L>::V* __restrict__ minv,
                    int cnt_e, int n, int r_rt, int te_rt, int tf_rt, int ld,
                    typename leaf::Leaf<L>::V* __restrict__ t2) {
  using Lf = leaf::Leaf<L>;
  using T = typename Lf::V;
  const int r = kExact ? kR : r_rt;
  const int te = kExact ? kTe : te_rt;
  const int tf = kExact ? kTf : tf_rt;
  // the last blocks first: the buckets run in degree order (program.py), so
  // the points with the most observations start early instead of trailing
  const int g = (gridDim.x - 1 - blockIdx.x) * kBlock + threadIdx.x;
  if (g >= num_points) return;
  // bucket b with pt_start[b] <= g < pt_start[b+1]
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pt_start[mid] <= g) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int lane_start = segs[4 * lo + 0];
  const int n_seg = segs[4 * lo + 1];
  const int d = segs[4 * lo + 2];
  const int out_row = segs[4 * lo + 3];
  const int e = g - pt_start[lo];
  const int p = out_row + e;
  const size_t N = static_cast<size_t>(n);

  T s[kTe];
#pragma unroll
  for (int a = 0; a < kTe; ++a) s[a] = T(0);
  int c_next = __ldcs(rows_f + lane_start + e);
  for (int j = 0; j < d; ++j) {
    const int lane = lane_start + j * n_seg + e;
    const int c = c_next;
    if (j + 1 < d) c_next = __ldcs(rows_f + lane + n_seg);  // the next camera row, early
    if (c < 0 || c >= ncols_f - 1) continue;  // dump column: t1 = 0
    T yc[kTf];
#pragma unroll
    for (int k = 0; k < kTf; ++k) {
      yc[k] = k < tf ? Lf::round(y[static_cast<size_t>(k) * ncols_f + c]) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (i >= r) continue;
      T t1 = T(0);
#pragma unroll
      for (int k = 0; k < kTf; ++k) {
        if (k < tf) t1 += Lf::ldcs(F + static_cast<size_t>(i * tf + k) * N + lane) * yc[k];
      }
      t1 = Lf::round(t1);
#pragma unroll
      for (int a = 0; a < kTe; ++a) {
        if (a < te) s[a] += Lf::ldcs(E + static_cast<size_t>(i * te + a) * N + lane) * t1;
      }
    }
  }

  // t2 = M_p⁻¹ s, written as point p's record (zero past te)
  T out[kExact ? 4 : kMaxTe];
#pragma unroll
  for (int a = 0; a < (kExact ? 4 : kMaxTe); ++a) {
    T acc = T(0);
    if (a < te) {
#pragma unroll
      for (int b = 0; b < kTe; ++b) {
        if (b < te) acc += __ldcs(minv + static_cast<size_t>(a * te + b) * cnt_e + p) * s[b];
      }
    }
    out[a] = acc;
  }
  T* rec = t2 + static_cast<size_t>(p) * ld;
  if (kExact) {
    store4(rec, out);
  } else {
#pragma unroll
    for (int a = 0; a < kMaxTe; ++a) {
      if (a < ld) rec[a] = out[a];
    }
  }
}

// Pass (b), over the chunks of every camera but the dump column.
template <typename L, int kR, int kTf, int kTe, bool kExact>
__global__ void __launch_bounds__(kBlock)
    sy_fold_kernel(const L* __restrict__ F, const L* __restrict__ E,
                   const int* __restrict__ prow, const int* __restrict__ chunk_start,
                   const int* __restrict__ slot_row,
                   const typename leaf::Leaf<L>::V* __restrict__ y, int ncols_f,
                   const typename leaf::Leaf<L>::V* __restrict__ t2, int ld, int cnt_e, int n_pad,
                   int r_rt, int te_rt, int tf_rt, int nchunks,
                   typename leaf::Leaf<L>::V* __restrict__ partial) {
  using Lf = leaf::Leaf<L>;
  using T = typename Lf::V;
  __shared__ T sh[kWarps][kTf];
  const int r = kExact ? kR : r_rt;
  const int te = kExact ? kTe : te_rt;
  const int tf = kExact ? kTf : tf_rt;
  const int m = blockIdx.x;
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int c = slot_row[beg];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);

  T yc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) {
    yc[k] = k < tf ? Lf::round(y[static_cast<size_t>(k) * ncols_f + c]) : T(0);
  }
  T acc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) acc[k] = T(0);

  for (int k = beg + threadIdx.x; k < end; k += kBlock) {
    const int p = __ldcs(prow + k);
    if (p < 0) continue;  // padding: the twins are zero there
    T tt[kExact ? 4 : kTe];
    if (kExact) {
      if (p < cnt_e) {
        load4(t2 + static_cast<size_t>(p) * ld, tt);
#pragma unroll
        for (int a = 0; a < 4; ++a) tt[a] = Lf::round(tt[a]);
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a) tt[a] = T(0);
      }
    } else {
#pragma unroll
      for (int a = 0; a < kTe; ++a) {
        tt[a] = (a < te && p < cnt_e) ? Lf::round(t2[static_cast<size_t>(p) * ld + a]) : T(0);
      }
    }
    T f[kR][kTf];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int a = 0; a < kTf; ++a) {
        f[i][a] =
            (i < r && a < tf) ? Lf::ldcs(F + static_cast<size_t>(i * tf + a) * NP + k) : T(0);
      }
    }
    T diff[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      T t1 = T(0);
      T et2 = T(0);
      if (i < r) {
#pragma unroll
        for (int a = 0; a < kTf; ++a) {
          if (a < tf) t1 += f[i][a] * yc[a];
        }
#pragma unroll
        for (int b = 0; b < kTe; ++b) {
          if (b < te) et2 += Lf::ldcs(E + static_cast<size_t>(i * te + b) * NP + k) * tt[b];
        }
      }
      diff[i] = Lf::round(Lf::round(t1) - et2);
    }
#pragma unroll
    for (int a = 0; a < kTf; ++a) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        if (i < r) acc[a] += f[i][a] * diff[i];
      }
    }
  }

  // fixed-order reduction: the warp's 32 lanes, then the block's warps
#pragma unroll
  for (int a = 0; a < kTf; ++a) {
    T v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < tf) {
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sh[w][threadIdx.x];
    partial[static_cast<size_t>(threadIdx.x) * nchunks + m] = v;
  }
}

bool shape_ok(int r, int te, int tf) {
  return r >= 1 && r <= kMaxR && te >= 1 && te <= kMaxTe && tf >= 1 && tf <= kMaxTf &&
         r * tf <= kMaxRTf;
}

bool exact_ba(int r, int te, int tf, int ld) { return r == 2 && tf == 9 && te == 3 && ld == 4; }

template <typename L, typename T = typename leaf::Leaf<L>::V>
int launch_point(const L* F, const L* E, const int* rows_f, const T* y, int ncols_f,
                 const int* segs, const int* pt_start, int nb, int num_points, const T* minv,
                 int cnt_e, int n, int r, int te, int tf, T* t2, int ld, cudaStream_t stream) {
  if (!shape_ok(r, te, tf) || ld < te || ld > kMaxTe || ld % 4 != 0 ||
      reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (num_points + kBlock - 1) / kBlock;
  if (blocks > 0) {
    if (exact_ba(r, te, tf, ld)) {
      sy_point_kernel<L, 2, 9, 3, true><<<blocks, kBlock, 0, stream>>>(
          F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r, te, tf,
          ld, t2);
    } else {
      sy_point_kernel<L, kMaxR, kMaxTf, kMaxTe, false><<<blocks, kBlock, 0, stream>>>(
          F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r, te, tf,
          ld, t2);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename L, typename T = typename leaf::Leaf<L>::V>
int launch_fold(const L* F, const L* E, const int* prow, const int* chunk_start,
                const int* row_chunks, const int* slot_row, const T* y, const T* dsq,
                int ncols_f, const T* t2, int ld, int cnt_e, int n_pad, int r, int te, int tf,
                int nchunks, T* partial, T* out, cudaStream_t stream) {
  if (!shape_ok(r, te, tf) || ld < te || reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    if (exact_ba(r, te, tf, ld)) {
      sy_fold_kernel<L, 2, 9, 3, true><<<nchunks, kBlock, 0, stream>>>(
          F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld, cnt_e, n_pad, r, te, tf,
          nchunks, partial);
    } else {
      sy_fold_kernel<L, kMaxR, kMaxTf, kMaxTe, false><<<nchunks, kBlock, 0, stream>>>(
          F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld, cnt_e, n_pad, r, te, tf,
          nchunks, partial);
    }
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // the dump column (the last) has no chunk in partial: it stays 0
  camera_chunks::launch_chunk_sum<T>(partial, row_chunks, tf, nchunks, ncols_f, ncols_f - 1, y,
                                     dsq, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctt_schur_sy_point_f32(const float* F, const float* E, const int* rows_f,
                                      const float* y, int ncols_f, const int* segs,
                                      const int* pt_start, int nb, int num_points,
                                      const float* minv, int cnt_e, int n, int r, int te, int tf,
                                      float* t2, int ld, void* stream) {
  return launch_point<float>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv,
                             cnt_e, n, r, te, tf, t2, ld, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_point_f64(const double* F, const double* E, const int* rows_f,
                                      const double* y, int ncols_f, const int* segs,
                                      const int* pt_start, int nb, int num_points,
                                      const double* minv, int cnt_e, int n, int r, int te, int tf,
                                      double* t2, int ld, void* stream) {
  return launch_point<double>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv,
                              cnt_e, n, r, te, tf, t2, ld, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_fold_f32(const float* F, const float* E, const int* prow,
                                     const int* chunk_start, const int* row_chunks,
                                     const int* slot_row, const float* y, const float* dsq,
                                     int ncols_f, const float* t2, int ld, int cnt_e, int n_pad,
                                     int r, int te, int tf, int nchunks, float* partial,
                                     float* out, void* stream) {
  return launch_fold<float>(F, E, prow, chunk_start, row_chunks, slot_row, y, dsq, ncols_f, t2,
                            ld, cnt_e, n_pad, r, te, tf, nchunks, partial, out,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_fold_f64(const double* F, const double* E, const int* prow,
                                     const int* chunk_start, const int* row_chunks,
                                     const int* slot_row, const double* y, const double* dsq,
                                     int ncols_f, const double* t2, int ld, int cnt_e, int n_pad,
                                     int r, int te, int tf, int nchunks, double* partial,
                                     double* out, void* stream) {
  return launch_fold<double>(F, E, prow, chunk_start, row_chunks, slot_row, y, dsq, ncols_f, t2,
                             ld, cnt_e, n_pad, r, te, tf, nchunks, partial, out,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_point_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E,
                                       const int* rows_f, const float* y, int ncols_f,
                                       const int* segs, const int* pt_start, int nb,
                                       int num_points, const float* minv, int cnt_e, int n, int r,
                                       int te, int tf, float* t2, int ld, void* stream) {
  return launch_point<__nv_bfloat16>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points,
                                     minv, cnt_e, n, r, te, tf, t2, ld,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_fold_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E,
                                      const int* prow, const int* chunk_start,
                                      const int* row_chunks, const int* slot_row, const float* y,
                                      const float* dsq, int ncols_f, const float* t2, int ld,
                                      int cnt_e, int n_pad, int r, int te, int tf, int nchunks,
                                      float* partial, float* out, void* stream) {
  return launch_fold<__nv_bfloat16>(F, E, prow, chunk_start, row_chunks, slot_row, y, dsq,
                                    ncols_f, t2, ld, cnt_e, n_pad, r, te, tf, nchunks, partial,
                                    out, static_cast<cudaStream_t>(stream));
}
