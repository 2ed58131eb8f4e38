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
//       4: ld/4 aligned 16-byte records per point), 16 MB at BAL-1778 in
//       float32, which stays in the 50 MB L2 for pass (b).
//   (b) slot pass (sy_fold_kernel), one block per chunk of one camera's slots
//       (program.camera_layout) on the camera-ordered twins of F and E and
//       the point row of each slot, the inputs kernel B5 takes. The block
//       loads its camera's y column once; each thread takes slots tid,
//       tid + 256, ...: it gathers the slot's t2 records, forms
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
// and y out of L2.
//
// Every kernel here is shape-exact, as the TPU kernel is (_sy_kernel takes
// d, r, te and tf as static arguments, pallas_schur.py:260-275): the block
// sizes (r, tf, te) are template arguments, every loop over them unrolled,
// every array sized by them (the F words of a slot stay in registers
// between their two uses in both slot passes) and t2 moved as ld/4 16-byte
// records. The library (schur_sy.cu) instantiates the BA shape
// (r, tf, te) = (2, 9, 3); every other shape within sy_meta's bounds
// (kMaxR, kMaxTf, kMaxTe, kMaxRTf below, which linalg/schur_kernels.py
// repeats) is a source of its own that schur_kernels.sy_source writes and
// cuda_lib.build_generated compiles at first use (CTT_SCHUR_SY_ENTRY). The
// kernels take the launcher's r, te, tf as arguments they do not read, so
// that the BA shape's kernels keep the parameter layout, and so the SASS,
// of their first design (PERF.md). A launcher refuses any other shape and
// any t2 record width but ld (cudaErrorInvalidValue).
//
// Leaves of float, double or bfloat16 (leaf.cuh). bfloat16 leaves are the
// mixed-precision solves' matvec (_sy_kernel with bf16=True, :383): F, E
// and their twins are bfloat16, everything else float. The vector operands
// are rounded to bfloat16 where _sy_kernel casts them to the leaf type: y
// as it is gathered (pallas_schur.py:308-309), t1 before Eᵀt1 (:319-320),
// t2 before E t2 (:335-338) and diff before Fᵀdiff (:343); t2 = M⁻¹ s,
// every product and every sum stay float, and the output is float.
// _sy_kernel forms t1 in bfloat16 and subtracts that value in
// diff = t1 − E t2, so the slot pass subtracts the rounded t1 too: the
// point pass derived t2 from it, and diff stays the projection of one t1
// (linalg/schur_kernels.py).
//
// The bfloat16 passes have kernels of their own; float and double keep the
// ones above. Halving the leaf bytes halved the bound, but on the float
// kernels' access pattern pass (a) took 31% less time and pass (b) 7% less
// (PERF.md §6): the bytes were not what bound them.
//   (a) sy_point_shared_kernel. The float kernel gathers an observation's
//       tf values of y from device memory at a stride of ncols: 9
//       scattered loads per observation at BAL-1778, each warp
//       instruction touching 32 cameras' lines (from L1, where the 64 KB
//       table mostly stays). Here each block of 1,024 threads stages the
//       [tf, ncols] float y table in shared memory (smem_table.cuh, as
//       B2's shared-memory kernel) and gathers from there. The work per
//       point is point_t2, the float kernel's own, so both give bitwise the
//       same t2: a table larger than a block's shared memory (BAL-13682:
//       9 x 13,683 x 4 B = 493 KB) takes sy_point_kernel
//       (smem_table::table_fits, as B2's gather_branch). On the H100 this
//       gained little (PERF.md §6): the gathers were not what bound the
//       pass. Its leaf loads stay 2 bytes a thread: observation j of points
//       e ... e + 7 are consecutive lanes, but a bucket's n_seg is no
//       multiple of 8, and the pass already runs at about 3/4 of its bound.
//   (b) sy_fold_bf16_kernel. The float kernel runs a 2048-slot chunk on
//       256 threads, 8 slots one after another per thread, each slot with
//       24 two-byte twin loads and a dependent prow -> t2 gather, so
//       nothing of the next slot is in flight while one waits. Here a
//       thread takes kFoldSlots = 4 consecutive slots: one 8-byte load of
//       them per twin row, their prow as one int4 and their t2 records
//       gathered together, then per slot diff and Fᵀdiff in slot order.
//       A block of 64 threads takes a 256-slot piece of a chunk, so many
//       pieces are resident per SM; the combine adds a chunk's pieces in
//       order, then its chunks. (8 slots a thread with 16-byte loads,
//       one warp a piece, ran ~1% slower: PERF.md §6.) Runs and chunks
//       start at multiples of 32 slots (program.camera_layout), so every
//       load is aligned when n_pad is a multiple of 8 and the twins and
//       prow are 16-byte aligned; otherwise the launcher returns
//       cudaErrorInvalidValue (there is no one-slot-at-a-time path).
// Each sums in one fixed order, without atomics: bitwise from run to run
// (the slot pass in another order than the float kernel's). Bound on an
// H100: device memory, the leaves read once per pass, so the two passes'
// bounds together are about twice the function's (PERF.md §6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "camera_chunks.cuh"
#include "leaf.cuh"
#include "smem_table.cuh"

namespace schur_sy {
namespace {

constexpr int kBlock = 256;  // threads per block of the float and double passes
constexpr int kWarps = kBlock / 32;
// the shapes sy_meta admits (linalg/schur_kernels.py MAX_R, MAX_TF, MAX_TE,
// MAX_RTF): the registers of the slot passes' F words grow with r*tf
constexpr int kMaxR = 4;
constexpr int kMaxTf = 16;
constexpr int kMaxTe = 8;
constexpr int kMaxRTf = 32;
constexpr int kFoldSlots = 4;  // slots a thread of the bfloat16 slot pass
constexpr int kPieceSlots = 256;  // slots a block of the bfloat16 slot pass (a piece of a chunk)
constexpr int kPieces = 2048 / kPieceSlots;  // pieces of a chunk of program.TWIN_CHUNK slots

template <int kR, int kTf, int kTe>
struct Shape {
  static_assert(kR >= 1 && kR <= kMaxR && kTf >= 1 && kTf <= kMaxTf && kTe >= 1 &&
                    kTe <= kMaxTe && kR * kTf <= kMaxRTf,
                "a shape sy_meta admits");
  // t2's record: te rounded up to 4, ld/4 16-byte records a point
  static constexpr int kLd = (kTe + 3) / 4 * 4;
  // the bfloat16 point pass's blocks (threads, and blocks an SM must
  // hold): two of 1,024, 32 registers a thread, where s[te] and y_c[tf]
  // take at most 13 of them (the BA shape; (2, 10, 3), whose pass ran 6%
  // faster so than at one block of 56 registers and 4% faster than at
  // three of 512: PERF.md §6, PR 19); else one, up to 64 registers
  static constexpr int kPointThreads = 1024;
  static constexpr int kPointMinBlocks = kTf + kTe <= 13 ? 2 : 1;
};

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

// Pass (a)'s work for the g-th point with observations (over the buckets),
// its y gathered from ytab [tf, ncols_f]: device memory in sy_point_kernel,
// shared memory in sy_point_shared_kernel (bfloat16 leaves), the same sums
// in the same order, so both give bitwise the same t2; ld is the record
// width Shape::kLd, which the launcher checked.
template <typename L, int kR, int kTf, int kTe>
__device__ __forceinline__ void point_t2(
    const L* __restrict__ F, const L* __restrict__ E, const int* __restrict__ rows_f,
    const typename leaf::Leaf<L>::V* __restrict__ ytab, int ncols_f,
    const int* __restrict__ segs, const int* __restrict__ pt_start, int nb,
    const typename leaf::Leaf<L>::V* __restrict__ minv, int cnt_e, int n, int ld,
    typename leaf::Leaf<L>::V* __restrict__ t2, int g) {
  using Lf = leaf::Leaf<L>;
  using T = typename Lf::V;
  constexpr int kLd = Shape<kR, kTf, kTe>::kLd;
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
    for (int k = 0; k < kTf; ++k) yc[k] = Lf::round(ytab[static_cast<size_t>(k) * ncols_f + c]);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      T t1 = T(0);
#pragma unroll
      for (int k = 0; k < kTf; ++k) {
        t1 += Lf::ldcs(F + static_cast<size_t>(i * kTf + k) * N + lane) * yc[k];
      }
      t1 = Lf::round(t1);
#pragma unroll
      for (int a = 0; a < kTe; ++a) {
        s[a] += Lf::ldcs(E + static_cast<size_t>(i * kTe + a) * N + lane) * t1;
      }
    }
  }

  // t2 = M_p⁻¹ s, written as point p's records (zero past te)
  T out[kLd];
#pragma unroll
  for (int a = 0; a < kLd; ++a) {
    T acc = T(0);
    if (a < kTe) {
#pragma unroll
      for (int b = 0; b < kTe; ++b) {
        acc += __ldcs(minv + static_cast<size_t>(a * kTe + b) * cnt_e + p) * s[b];
      }
    }
    out[a] = acc;
  }
  T* rec = t2 + static_cast<size_t>(p) * ld;
#pragma unroll
  for (int h = 0; h < kLd / 4; ++h) store4(rec + 4 * h, out + 4 * h);
}

// Pass (a), one thread per point, y gathered from device memory.
template <typename L, int kR, int kTf, int kTe>
__global__ void __launch_bounds__(kBlock)
    sy_point_kernel(const L* __restrict__ F, const L* __restrict__ E,
                    const int* __restrict__ rows_f,
                    const typename leaf::Leaf<L>::V* __restrict__ y, int ncols_f,
                    const int* __restrict__ segs, const int* __restrict__ pt_start,
                    int nb, int num_points, const typename leaf::Leaf<L>::V* __restrict__ minv,
                    int cnt_e, int n, int /*r*/, int /*te*/, int /*tf*/, int ld,
                    typename leaf::Leaf<L>::V* __restrict__ t2) {
  // the last blocks first: the buckets run in degree order (program.py), so
  // the points with the most observations start early instead of trailing
  const int g = (gridDim.x - 1 - blockIdx.x) * kBlock + threadIdx.x;
  if (g >= num_points) return;
  point_t2<L, kR, kTf, kTe>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, minv, cnt_e, n, ld,
                            t2, g);
}

// Pass (a) on bfloat16 leaves with the [tf, ncols_f] float y table staged
// in shared memory (smem_table.cuh; dynamic, table_smem bytes): each block
// stages the table, then takes Shape::kPointThreads consecutive points, one a
// thread, the last blocks first (as sy_point_kernel). Large blocks amortize
// the staging: at BAL-1778 (64 KB) two blocks of 1,024 fill an SM's 2,048
// threads, the point pass being a chain of dependent loads per thread that
// wants every warp the SM holds; a larger shape takes one block an SM
// (Shape::kPointMinBlocks). (A persistent
// grid of the resident blocks, each staging the table once, ran slower on
// the H100 than the float kernel's own grid: PERF.md §6.) tf_rt is kTf.
template <int kR, int kTf, int kTe>
__global__ void __launch_bounds__(Shape<kR, kTf, kTe>::kPointThreads,
                                  Shape<kR, kTf, kTe>::kPointMinBlocks)
    sy_point_shared_kernel(const __nv_bfloat16* __restrict__ F,
                           const __nv_bfloat16* __restrict__ E, const int* __restrict__ rows_f,
                           const float* __restrict__ y, int ncols_f, const int* __restrict__ segs,
                           const int* __restrict__ pt_start, int nb, int num_points,
                           const float* __restrict__ minv, int cnt_e, int n, int /*r*/,
                           int /*te*/, int tf_rt, int ld, float* __restrict__ t2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  bool pending;
  const float* tbl = smem_table::begin_stage(y, tf_rt * ncols_f, smem, &bar, &pending);
  __syncthreads();  // the head and tail, and the barrier's initialisation
  if (pending) smem_table::wait_body(&bar);
  const int g = (gridDim.x - 1 - blockIdx.x) * Shape<kR, kTf, kTe>::kPointThreads + threadIdx.x;
  if (g < num_points) {
    point_t2<__nv_bfloat16, kR, kTf, kTe>(F, E, rows_f, tbl, ncols_f, segs, pt_start, nb, minv,
                                          cnt_e, n, ld, t2, g);
  }
}

// Pass (b), over the chunks of every camera but the dump column.
template <typename L, int kR, int kTf, int kTe>
__global__ void __launch_bounds__(kBlock)
    sy_fold_kernel(const L* __restrict__ F, const L* __restrict__ E,
                   const int* __restrict__ prow, const int* __restrict__ chunk_start,
                   const int* __restrict__ slot_row,
                   const typename leaf::Leaf<L>::V* __restrict__ y, int ncols_f,
                   const typename leaf::Leaf<L>::V* __restrict__ t2, int ld, int cnt_e, int n_pad,
                   int /*r*/, int /*te*/, int /*tf*/, int nchunks,
                   typename leaf::Leaf<L>::V* __restrict__ partial) {
  using Lf = leaf::Leaf<L>;
  using T = typename Lf::V;
  constexpr int kLd = Shape<kR, kTf, kTe>::kLd;
  __shared__ T sh[kWarps][kTf];
  const int m = blockIdx.x;
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int c = slot_row[beg];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);

  T yc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) yc[k] = Lf::round(y[static_cast<size_t>(k) * ncols_f + c]);
  T acc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) acc[k] = T(0);

  for (int k = beg + threadIdx.x; k < end; k += kBlock) {
    const int p = __ldcs(prow + k);
    if (p < 0) continue;  // padding: the twins are zero there
    T tt[kLd];
    if (p < cnt_e) {
#pragma unroll
      for (int h = 0; h < kLd / 4; ++h) load4(t2 + static_cast<size_t>(p) * ld + 4 * h, tt + 4 * h);
#pragma unroll
      for (int a = 0; a < kLd; ++a) tt[a] = Lf::round(tt[a]);
    } else {
#pragma unroll
      for (int a = 0; a < kLd; ++a) tt[a] = T(0);
    }
    T f[kR][kTf];  // the slot's F, read once for F y and Fᵀdiff
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int a = 0; a < kTf; ++a) f[i][a] = Lf::ldcs(F + static_cast<size_t>(i * kTf + a) * NP + k);
    }
    T diff[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      T t1 = T(0);
      T et2 = T(0);
#pragma unroll
      for (int a = 0; a < kTf; ++a) t1 += f[i][a] * yc[a];
#pragma unroll
      for (int b = 0; b < kTe; ++b) {
        et2 += Lf::ldcs(E + static_cast<size_t>(i * kTe + b) * NP + k) * tt[b];
      }
      diff[i] = Lf::round(Lf::round(t1) - et2);
    }
#pragma unroll
    for (int a = 0; a < kTf; ++a) {
#pragma unroll
      for (int i = 0; i < kR; ++i) acc[a] += f[i][a] * diff[i];
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
  if (threadIdx.x < kTf) {
    T v = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += sh[w][threadIdx.x];
    partial[static_cast<size_t>(threadIdx.x) * nchunks + m] = v;
  }
}

// Pass (b) on bfloat16 twins, one block per piece of kPieceSlots slots of
// a chunk (kPieces blocks a chunk; a piece past the chunk's end writes 0).
// Each thread takes K consecutive slots of its piece (K = kFoldSlots, so a
// piece is kPieceSlots / K threads): one K-slot load (2K bytes) per twin
// row, the K point rows as int4 loads and their K t2 records gathered
// together, so nothing of one slot waits for another; then per slot
// diff = round(round(F y_c) − E round(t2)) and Fᵀdiff summed in slot
// order, the piece's warps by the shuffle tree and in order, and each
// piece's tf sums written to partial [tf, nchunks * kPieces]
// (camera_chunks.cuh chunk_parts_sum adds them). Small blocks keep many
// pieces resident per SM, so one piece's loads overlap another's
// arithmetic. Runs and chunks start at multiples of 32 slots
// (program.camera_layout), so every load is aligned when n_pad is a
// multiple of 8 and the twins and prow are 16-byte aligned (the launcher
// checks). The F words stay in registers between their two uses.
template <int kR, int kTf, int kTe, int K>
__global__ void __launch_bounds__(kPieceSlots / K)
    sy_fold_bf16_kernel(const __nv_bfloat16* __restrict__ F, const __nv_bfloat16* __restrict__ E,
                        const int* __restrict__ prow, const int* __restrict__ chunk_start,
                        const int* __restrict__ slot_row, const float* __restrict__ y,
                        int ncols_f, const float* __restrict__ t2, int ld, int cnt_e, int n_pad,
                        int /*r*/, int /*te*/, int /*tf*/, int nchunks,
                        float* __restrict__ partial) {
  using Lf = leaf::Leaf<__nv_bfloat16>;
  constexpr int kW = K / 2;  // 32-bit words of one row's K slots
  constexpr int kPieceWarps = kPieceSlots / K / 32;
  constexpr int kLd = Shape<kR, kTf, kTe>::kLd;
  __shared__ float sh[kPieceWarps][kTf];
  const int m = blockIdx.x / kPieces;
  const int beg = chunk_start[m] + (blockIdx.x - m * kPieces) * kPieceSlots;
  const int end = chunk_start[m + 1];
  const size_t pstride = static_cast<size_t>(nchunks) * kPieces;
  if (beg >= end) {  // no slot in this piece
    if (threadIdx.x < kTf) partial[threadIdx.x * pstride + blockIdx.x] = 0.0f;
    return;
  }
  const int c = slot_row[beg];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);
  auto row = [&](const __nv_bfloat16* twin, int j, int k0) {
    return twin + static_cast<size_t>(j) * NP + k0;
  };

  float yc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) yc[k] = Lf::round(y[static_cast<size_t>(k) * ncols_f + c]);
  float acc[kTf];
#pragma unroll
  for (int k = 0; k < kTf; ++k) acc[k] = 0.0f;

  const int k0 = beg + threadIdx.x * K;
  if (k0 < end) {
    int p[K];
#pragma unroll
    for (int h = 0; h < K / 4; ++h) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(prow + k0) + h);
      p[4 * h] = q.x;
      p[4 * h + 1] = q.y;
      p[4 * h + 2] = q.z;
      p[4 * h + 3] = q.w;
    }
    bool live[K];  // padding (-1) and rows past t2 meet t2 = 0
#pragma unroll
    for (int s = 0; s < K; ++s) live[s] = p[s] >= 0 && p[s] < cnt_e;

    // t1 = F y_c per slot and row
    unsigned fw[kR * kTf][kW];
    float t1[K][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int s = 0; s < K; ++s) t1[s][i] = 0.0f;
#pragma unroll
      for (int a = 0; a < kTf; ++a) {
        unsigned w[kW];
        leaf::ldcs_bf16_words<K>(row(F, i * kTf + a, k0), w);
#pragma unroll
        for (int h = 0; h < kW; ++h) fw[i * kTf + a][h] = w[h];
#pragma unroll
        for (int s = 0; s < K; ++s) t1[s][i] += leaf::bf16_word_value(w, s) * yc[a];
      }
    }

    // E round(t2) per slot and row, over b ascending
    float et2[K][kR];
#pragma unroll
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int i = 0; i < kR; ++i) et2[s][i] = 0.0f;
    }
    float tt[K][kLd];  // ld/4 16-byte records per slot
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (live[s]) {
#pragma unroll
        for (int h = 0; h < kLd / 4; ++h) {
          load4(t2 + static_cast<size_t>(p[s]) * ld + 4 * h, tt[s] + 4 * h);
        }
#pragma unroll
        for (int b = 0; b < kLd; ++b) tt[s][b] = Lf::round(tt[s][b]);
      } else {
#pragma unroll
        for (int b = 0; b < kLd; ++b) tt[s][b] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int b = 0; b < kTe; ++b) {
        unsigned w[kW];
        leaf::ldcs_bf16_words<K>(row(E, i * kTe + b, k0), w);
#pragma unroll
        for (int s = 0; s < K; ++s) et2[s][i] += leaf::bf16_word_value(w, s) * tt[s][b];
      }
    }

    float diff[K][kR];
#pragma unroll
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int i = 0; i < kR; ++i) diff[s][i] = Lf::round(Lf::round(t1[s][i]) - et2[s][i]);
    }

    // Fᵀdiff, slot by slot
#pragma unroll
    for (int a = 0; a < kTf; ++a) {
      unsigned fa[kR][kW];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int h = 0; h < kW; ++h) fa[i][h] = fw[i * kTf + a][h];
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[a] += leaf::bf16_word_value(fa[i], s) * diff[s][i];
      }
    }
  }

  // fixed-order reduction: the warp's 32 lanes, then the piece's warps
#pragma unroll
  for (int a = 0; a < kTf; ++a) {
    float v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sh[warp][a] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTf) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kPieceWarps; ++w) v += sh[w][threadIdx.x];
    partial[threadIdx.x * pstride + blockIdx.x] = v;
  }
}

// whether (r, te, tf, ld) is the instantiated shape and its record width
template <int kR, int kTf, int kTe>
bool is_shape(int r, int te, int tf, int ld) {
  return r == kR && te == kTe && tf == kTf && ld == Shape<kR, kTf, kTe>::kLd;
}

template <typename L, int kR, int kTf, int kTe, typename T = typename leaf::Leaf<L>::V>
int launch_point(const L* F, const L* E, const int* rows_f, const T* y, int ncols_f,
                 const int* segs, const int* pt_start, int nb, int num_points, const T* minv,
                 int cnt_e, int n, int r, int te, int tf, T* t2, int ld, cudaStream_t stream) {
  if (!is_shape<kR, kTf, kTe>(r, te, tf, ld) || reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (num_points + kBlock - 1) / kBlock;
  if (blocks > 0) {
    sy_point_kernel<L, kR, kTf, kTe><<<blocks, kBlock, 0, stream>>>(
        F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r, te, tf, ld,
        t2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename L, int kR, int kTf, int kTe, typename T = typename leaf::Leaf<L>::V>
int launch_fold(const L* F, const L* E, const int* prow, const int* chunk_start,
                const int* row_chunks, const int* slot_row, const T* y, const T* dsq,
                int ncols_f, const T* t2, int ld, int cnt_e, int n_pad, int r, int te, int tf,
                int nchunks, T* partial, T* out, cudaStream_t stream) {
  if (!is_shape<kR, kTf, kTe>(r, te, tf, ld) || reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    sy_fold_kernel<L, kR, kTf, kTe><<<nchunks, kBlock, 0, stream>>>(
        F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld, cnt_e, n_pad, r, te, tf, nchunks,
        partial);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // the dump column (the last) has no chunk in partial: it stays 0
  camera_chunks::launch_chunk_sum<T>(partial, row_chunks, tf, nchunks, ncols_f, ncols_f - 1, y,
                                     dsq, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 point pass: the y table in shared memory where it fits
// (smem_table::table_fits, as B2's gather_branch); else the float pass's
// kernel on bfloat16 leaves, which gives bitwise the same t2.
template <int kR, int kTf, int kTe>
int launch_point_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E, const int* rows_f,
                      const float* y, int ncols_f, const int* segs, const int* pt_start, int nb,
                      int num_points, const float* minv, int cnt_e, int n, int r, int te, int tf,
                      float* t2, int ld, cudaStream_t stream) {
  if (!smem_table::table_fits(1LL * tf * ncols_f)) {
    return launch_point<__nv_bfloat16, kR, kTf, kTe>(F, E, rows_f, y, ncols_f, segs, pt_start,
                                                     nb, num_points, minv, cnt_e, n, r, te, tf,
                                                     t2, ld, stream);
  }
  if (!is_shape<kR, kTf, kTe>(r, te, tf, ld) || reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_points <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_table::table_smem(1LL * tf * ncols_f);
  auto kernel = sy_point_shared_kernel<kR, kTf, kTe>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  constexpr int threads = Shape<kR, kTf, kTe>::kPointThreads;
  kernel<<<(num_points + threads - 1) / threads, threads, smem, stream>>>(
      F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r, te, tf, ld, t2);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 slot pass reads kFoldSlots slots of a twin row (and of prow)
// at once: n_pad a multiple of 8 and the twins and prow 16-byte aligned, or
// cudaErrorInvalidValue (every twin the port makes is; there is no
// one-slot-at-a-time path).
template <int kR, int kTf, int kTe>
int launch_fold_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E, const int* prow,
                     const int* chunk_start, const int* row_chunks, const int* slot_row,
                     const float* y, const float* dsq, int ncols_f, const float* t2, int ld,
                     int cnt_e, int n_pad, int r, int te, int tf, int nchunks, float* partial,
                     float* out, cudaStream_t stream) {
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (!is_shape<kR, kTf, kTe>(r, te, tf, ld) || !aligned(t2) || n_pad % 8 != 0 || !aligned(F) ||
      !aligned(E) || !aligned(prow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    const long long blocks = 1LL * nchunks * kPieces;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    constexpr int threads = kPieceSlots / kFoldSlots;
    sy_fold_bf16_kernel<kR, kTf, kTe, kFoldSlots><<<blocks, threads, 0, stream>>>(
        F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld, cnt_e, n_pad, r, te, tf, nchunks,
        partial);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // the dump column (the last) has no chunk in partial: it stays 0
  camera_chunks::launch_chunk_parts_sum<float>(partial, row_chunks, tf, nchunks, kPieces, ncols_f,
                                               ncols_f - 1, y, dsq, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace schur_sy

// The six entry points of B4 at one shape (R, TF, TE): the point and slot
// passes for float, double and bfloat16 leaves (linalg/schur_kernels.py
// sy_point_pass / sy_fold_pass; their C signatures are cuda_lib's
// ctt_schur_sy_point / ctt_schur_sy_fold).
#define CTT_SCHUR_SY_POINT(SFX, L, T, LAUNCH)                                                    \
  extern "C" int ctt_schur_sy_point_##SFX(const L* F, const L* E, const int* rows_f, const T* y, \
                                          int ncols_f, const int* segs, const int* pt_start,     \
                                          int nb, int num_points, const T* minv, int cnt_e,      \
                                          int n, int r, int te, int tf, T* t2, int ld,           \
                                          void* stream) {                                        \
    return LAUNCH(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r,   \
                  te, tf, t2, ld, static_cast<cudaStream_t>(stream));                            \
  }
#define CTT_SCHUR_SY_FOLD(SFX, L, T, LAUNCH)                                                    \
  extern "C" int ctt_schur_sy_fold_##SFX(const L* F, const L* E, const int* prow,               \
                                         const int* chunk_start, const int* row_chunks,         \
                                         const int* slot_row, const T* y, const T* dsq,         \
                                         int ncols_f, const T* t2, int ld, int cnt_e,           \
                                         int n_pad, int r, int te, int tf, int nchunks,         \
                                         T* partial, T* out, void* stream) {                    \
    return LAUNCH(F, E, prow, chunk_start, row_chunks, slot_row, y, dsq, ncols_f, t2, ld, cnt_e, \
                  n_pad, r, te, tf, nchunks, partial, out, static_cast<cudaStream_t>(stream));   \
  }
#define CTT_SCHUR_SY_ENTRY(R, TF, TE)                                                            \
  CTT_SCHUR_SY_POINT(f32, float, float, (schur_sy::launch_point<float, R, TF, TE>))              \
  CTT_SCHUR_SY_POINT(f64, double, double, (schur_sy::launch_point<double, R, TF, TE>))           \
  CTT_SCHUR_SY_POINT(bf16, __nv_bfloat16, float, (schur_sy::launch_point_bf16<R, TF, TE>))       \
  CTT_SCHUR_SY_FOLD(f32, float, float, (schur_sy::launch_fold<float, R, TF, TE>))                \
  CTT_SCHUR_SY_FOLD(f64, double, double, (schur_sy::launch_fold<double, R, TF, TE>))             \
  CTT_SCHUR_SY_FOLD(bf16, __nv_bfloat16, float, (schur_sy::launch_fold_bf16<R, TF, TE>))
