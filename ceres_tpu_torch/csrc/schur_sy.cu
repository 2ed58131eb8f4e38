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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "camera_chunks.cuh"
#include "leaf.cuh"
#include "smem_table.cuh"

namespace {

constexpr int kBlock = 256;  // threads per block of both passes
constexpr int kWarps = kBlock / 32;
constexpr int kMaxR = 4;
constexpr int kMaxTf = 16;
constexpr int kMaxTe = 8;
constexpr int kMaxRTf = 32;
constexpr int kFoldSlots = 4;  // slots a thread of the bfloat16 slot pass
constexpr int kPieceSlots = 256;  // slots a block of the bfloat16 slot pass (a piece of a chunk)
constexpr int kPieces = 2048 / kPieceSlots;  // pieces of a chunk of program.TWIN_CHUNK slots
// threads a block of the bfloat16 point pass: the BA shape in 32 registers,
// two blocks an SM; the generic shapes take 80 registers, blocks of kBlock
constexpr int kPointBlock = 1024;
__host__ __device__ constexpr int point_threads(bool exact) { return exact ? kPointBlock : kBlock; }

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
// in the same order, so both give bitwise the same t2. kExact: r, tf, te
// are kR, kTf, kTe (and ld == 4 == kTe + 1); otherwise they are run-time
// values bounded by them.
template <typename L, int kR, int kTf, int kTe, bool kExact>
__device__ __forceinline__ void point_t2(
    const L* __restrict__ F, const L* __restrict__ E, const int* __restrict__ rows_f,
    const typename leaf::Leaf<L>::V* __restrict__ ytab, int ncols_f,
    const int* __restrict__ segs, const int* __restrict__ pt_start, int nb,
    const typename leaf::Leaf<L>::V* __restrict__ minv, int cnt_e, int n, int r_rt, int te_rt,
    int tf_rt, int ld, typename leaf::Leaf<L>::V* __restrict__ t2, int g) {
  using Lf = leaf::Leaf<L>;
  using T = typename Lf::V;
  const int r = kExact ? kR : r_rt;
  const int te = kExact ? kTe : te_rt;
  const int tf = kExact ? kTf : tf_rt;
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
      yc[k] = k < tf ? Lf::round(ytab[static_cast<size_t>(k) * ncols_f + c]) : T(0);
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

// Pass (a), one thread per point, y gathered from device memory.
template <typename L, int kR, int kTf, int kTe, bool kExact>
__global__ void __launch_bounds__(kBlock)
    sy_point_kernel(const L* __restrict__ F, const L* __restrict__ E,
                    const int* __restrict__ rows_f,
                    const typename leaf::Leaf<L>::V* __restrict__ y, int ncols_f,
                    const int* __restrict__ segs, const int* __restrict__ pt_start,
                    int nb, int num_points, const typename leaf::Leaf<L>::V* __restrict__ minv,
                    int cnt_e, int n, int r_rt, int te_rt, int tf_rt, int ld,
                    typename leaf::Leaf<L>::V* __restrict__ t2) {
  // the last blocks first: the buckets run in degree order (program.py), so
  // the points with the most observations start early instead of trailing
  const int g = (gridDim.x - 1 - blockIdx.x) * kBlock + threadIdx.x;
  if (g >= num_points) return;
  point_t2<L, kR, kTf, kTe, kExact>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, minv, cnt_e, n,
                                     r_rt, te_rt, tf_rt, ld, t2, g);
}

// Pass (a) on bfloat16 leaves with the [tf, ncols_f] float y table staged
// in shared memory (smem_table.cuh; dynamic, table_smem bytes): each block
// stages the table, then takes point_threads consecutive points, one a
// thread, the last blocks first (as sy_point_kernel). Large blocks amortize
// the staging: at BAL-1778 (64 KB) two blocks of 1,024 fill an SM's 2,048
// threads, the point pass being a chain of dependent loads per thread that
// wants every warp the SM holds. (A persistent grid of the resident
// blocks, each staging the table once, ran slower on the H100 than the
// float kernel's own grid: PERF.md §6.)
template <int kR, int kTf, int kTe, bool kExact>
__global__ void __launch_bounds__(point_threads(kExact), kExact ? 2048 / kPointBlock : 1)
    sy_point_shared_kernel(const __nv_bfloat16* __restrict__ F,
                           const __nv_bfloat16* __restrict__ E, const int* __restrict__ rows_f,
                           const float* __restrict__ y, int ncols_f, const int* __restrict__ segs,
                           const int* __restrict__ pt_start, int nb, int num_points,
                           const float* __restrict__ minv, int cnt_e, int n, int r_rt, int te_rt,
                           int tf_rt, int ld, float* __restrict__ t2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  bool pending;
  const float* tbl = smem_table::begin_stage(y, tf_rt * ncols_f, smem, &bar, &pending);
  __syncthreads();  // the head and tail, and the barrier's initialisation
  if (pending) smem_table::wait_body(&bar);
  const int g = (gridDim.x - 1 - blockIdx.x) * point_threads(kExact) + threadIdx.x;
  if (g < num_points) {
    point_t2<__nv_bfloat16, kR, kTf, kTe, kExact>(F, E, rows_f, tbl, ncols_f, segs, pt_start, nb,
                                                  minv, cnt_e, n, r_rt, te_rt, tf_rt, ld, t2, g);
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
// checks). The BA shape keeps its F words in registers between their two
// uses; the generic shapes load them again (from L1).
template <int kR, int kTf, int kTe, bool kExact, int K>
__global__ void __launch_bounds__(kPieceSlots / K)
    sy_fold_bf16_kernel(const __nv_bfloat16* __restrict__ F, const __nv_bfloat16* __restrict__ E,
                        const int* __restrict__ prow, const int* __restrict__ chunk_start,
                        const int* __restrict__ slot_row, const float* __restrict__ y,
                        int ncols_f, const float* __restrict__ t2, int ld, int cnt_e, int n_pad,
                        int r_rt, int te_rt, int tf_rt, int nchunks, float* __restrict__ partial) {
  using Lf = leaf::Leaf<__nv_bfloat16>;
  constexpr int kW = K / 2;  // 32-bit words of one row's K slots
  constexpr int kPieceWarps = kPieceSlots / K / 32;
  __shared__ float sh[kPieceWarps][kTf];
  const int r = kExact ? kR : r_rt;
  const int te = kExact ? kTe : te_rt;
  const int tf = kExact ? kTf : tf_rt;
  const int m = blockIdx.x / kPieces;
  const int beg = chunk_start[m] + (blockIdx.x - m * kPieces) * kPieceSlots;
  const int end = chunk_start[m + 1];
  const size_t pstride = static_cast<size_t>(nchunks) * kPieces;
  if (beg >= end) {  // no slot in this piece
    if (threadIdx.x < tf) partial[threadIdx.x * pstride + blockIdx.x] = 0.0f;
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
  for (int k = 0; k < kTf; ++k) {
    yc[k] = k < tf ? Lf::round(y[static_cast<size_t>(k) * ncols_f + c]) : 0.0f;
  }
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
    unsigned fw[kExact ? kR * kTf : 1][kW];
    float t1[K][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int s = 0; s < K; ++s) t1[s][i] = 0.0f;
#pragma unroll
      for (int a = 0; a < kTf; ++a) {
        if (i < r && a < tf) {
          unsigned w[kW];
          leaf::ldcs_bf16_words<K>(row(F, i * tf + a, k0), w);
          if constexpr (kExact) {
#pragma unroll
            for (int h = 0; h < kW; ++h) fw[i * kTf + a][h] = w[h];
          }
#pragma unroll
          for (int s = 0; s < K; ++s) t1[s][i] += leaf::bf16_word_value(w, s) * yc[a];
        }
      }
    }

    // E round(t2) per slot and row, over b ascending
    float et2[K][kR];
#pragma unroll
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int i = 0; i < kR; ++i) et2[s][i] = 0.0f;
    }
    if constexpr (kExact) {
      float tt[K][4];  // one 16-byte record per slot
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (live[s]) {
          load4(t2 + static_cast<size_t>(p[s]) * ld, tt[s]);
#pragma unroll
          for (int b = 0; b < 4; ++b) tt[s][b] = Lf::round(tt[s][b]);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) tt[s][b] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int b = 0; b < kTe; ++b) {
          unsigned w[kW];
          leaf::ldcs_bf16_words<K>(row(E, i * kTe + b, k0), w);
#pragma unroll
          for (int s = 0; s < K; ++s) {
            et2[s][i] += leaf::bf16_word_value(w, s) * tt[s][b];
          }
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < kTe; ++b) {
        if (b < te) {
          float tb[K];
#pragma unroll
          for (int s = 0; s < K; ++s) {
            tb[s] = live[s] ? Lf::round(t2[static_cast<size_t>(p[s]) * ld + b]) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            if (i < r) {
              unsigned w[kW];
              leaf::ldcs_bf16_words<K>(row(E, i * te + b, k0), w);
#pragma unroll
              for (int s = 0; s < K; ++s) et2[s][i] += leaf::bf16_word_value(w, s) * tb[s];
            }
          }
        }
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
      if (a < tf) {
        unsigned fa[kR][kW];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if (i < r) {
            if constexpr (kExact) {
#pragma unroll
              for (int h = 0; h < kW; ++h) fa[i][h] = fw[i * kTf + a][h];
            } else {
              leaf::ldcs_bf16_words<K>(row(F, i * tf + a, k0), fa[i]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < K; ++s) {
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            if (i < r) acc[a] += leaf::bf16_word_value(fa[i], s) * diff[s][i];
          }
        }
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
  if (threadIdx.x < tf) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kPieceWarps; ++w) v += sh[w][threadIdx.x];
    partial[threadIdx.x * pstride + blockIdx.x] = v;
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

// The bfloat16 point pass: the y table in shared memory where it fits
// (smem_table::table_fits, as B2's gather_branch), on a persistent grid of
// as many blocks as are resident at once; else the first version's kernel,
// which gives bitwise the same t2.
int launch_point_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E, const int* rows_f,
                      const float* y, int ncols_f, const int* segs, const int* pt_start, int nb,
                      int num_points, const float* minv, int cnt_e, int n, int r, int te, int tf,
                      float* t2, int ld, cudaStream_t stream) {
  if (!smem_table::table_fits(1LL * tf * ncols_f)) {
    return launch_point<__nv_bfloat16>(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points,
                                       minv, cnt_e, n, r, te, tf, t2, ld, stream);
  }
  if (!shape_ok(r, te, tf) || ld < te || ld > kMaxTe || ld % 4 != 0 ||
      reinterpret_cast<size_t>(t2) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_points <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_table::table_smem(1LL * tf * ncols_f);
  const bool exact = exact_ba(r, te, tf, ld);
  auto kernel = exact ? sy_point_shared_kernel<2, 9, 3, true>
                      : sy_point_shared_kernel<kMaxR, kMaxTf, kMaxTe, false>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int threads = point_threads(exact);
  kernel<<<(num_points + threads - 1) / threads, threads, smem, stream>>>(
      F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e, n, r, te, tf, ld, t2);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 slot pass reads kFoldSlots slots of a twin row (and of prow)
// at once: n_pad a multiple of 8 and the twins and prow 16-byte aligned, or
// cudaErrorInvalidValue (every twin the port makes is; there is no
// one-slot-at-a-time path).
int launch_fold_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E, const int* prow,
                     const int* chunk_start, const int* row_chunks, const int* slot_row,
                     const float* y, const float* dsq, int ncols_f, const float* t2, int ld,
                     int cnt_e, int n_pad, int r, int te, int tf, int nchunks, float* partial,
                     float* out, cudaStream_t stream) {
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (!shape_ok(r, te, tf) || ld < te || !aligned(t2) || n_pad % 8 != 0 || !aligned(F) ||
      !aligned(E) || !aligned(prow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nchunks > 0) {
    const long long blocks = 1LL * nchunks * kPieces;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    constexpr int threads = kPieceSlots / kFoldSlots;
    if (exact_ba(r, te, tf, ld)) {
      sy_fold_bf16_kernel<2, 9, 3, true, kFoldSlots><<<blocks, threads, 0, stream>>>(
          F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld, cnt_e, n_pad, r, te, tf,
          nchunks, partial);
    } else {
      sy_fold_bf16_kernel<kMaxR, kMaxTf, kMaxTe, false, kFoldSlots>
          <<<blocks, threads, 0, stream>>>(F, E, prow, chunk_start, slot_row, y, ncols_f, t2, ld,
                                           cnt_e, n_pad, r, te, tf, nchunks, partial);
    }
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // the dump column (the last) has no chunk in partial: it stays 0
  camera_chunks::launch_chunk_parts_sum<float>(partial, row_chunks, tf, nchunks, kPieces, ncols_f,
                                               ncols_f - 1, y, dsq, out, stream);
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
  return launch_point_bf16(F, E, rows_f, y, ncols_f, segs, pt_start, nb, num_points, minv, cnt_e,
                           n, r, te, tf, t2, ld, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_sy_fold_bf16(const __nv_bfloat16* F, const __nv_bfloat16* E,
                                      const int* prow, const int* chunk_start,
                                      const int* row_chunks, const int* slot_row, const float* y,
                                      const float* dsq, int ncols_f, const float* t2, int ld,
                                      int cnt_e, int n_pad, int r, int te, int tf, int nchunks,
                                      float* partial, float* out, void* stream) {
  return launch_fold_bf16(F, E, prow, chunk_start, row_chunks, slot_row, y, dsq, ncols_f, t2, ld,
                          cnt_e, n_pad, r, te, tf, nchunks, partial, out,
                          static_cast<cudaStream_t>(stream));
}
