// Kernels B2 and B3: the camera-side Jacobian products of the Schur solve.
//
// B2 gather_contract replaces ceres_tpu/pallas_onehot.py
// _gather_contract_kernel (via gather_contract):
//     out[i, l] = sum_j jac[i*t + j, l] * table[j, rows[l]]
// the last table column is the dump column of constant blocks and gathers
// zero.
//
// B3 contract_reduce replaces pallas_onehot.py _contract_reduce_kernel (via
// contract_reduce):
//     out[j, c] = sum_{slots k of c} sum_i twin[i*t + j, k] * u[i, perm[k]]
// (u == nullptr means u = 1 with r = 1: a plain segmented sum of the twin's
// rows). The twin is the leaf copied into camera order: camera c's
// observations fill slots [offsets[c], offsets[c+1]), padded with zero
// columns (perm = -1) to a multiple of 32, so every run starts 128-byte
// aligned in float32 (program.py camera_layout, jacobian.py make_twin).
// One block per chunk of at most 2048 slots of one camera, with all t rows
// in the block (passes of kRows rows, each reading rows of its own): a warp
// reads 32 consecutive slots of a row, i.e. whole 128-byte lines, and
// gathers only u (2 values per slot, from an [r, n] array that the
// previous kernel has just left in L2). A warp-shuffle tree and a fixed
// pass over the warps give the chunk's sums; camera_chunks.cuh adds a
// camera's chunks in index order. Bitwise reproducible, no atomics.
//
// Bound on an H100: device memory. B2 streams the [r*t, n] leaf once and
// reads rows and writes out once. Its first version (gather_contract_kernel)
// runs one lane per thread and reads its t table values table[j * ncols +
// c] at a stride of ncols; on bfloat16 leaves it loads 2 bytes per thread
// per row, and halving the leaf bytes (f32 -> bf16) cut the bound by 43%
// but its time by 15%. So bfloat16 leaves have a second kernel,
// gather_contract_shared_kernel:
//   - a persistent grid (as many blocks as are resident at once, from the
//     occupancy calculator) striding over the lanes; each block copies the
//     [t, ncols] float table into dynamic shared memory once, by a bulk
//     asynchronous copy (cp.async.bulk, completing on an mbarrier) of its
//     16-byte-aligned body; the head before the first 16-byte boundary and
//     the tail after the last one (the table may be a view, and 9 x 1,779
//     floats are not a multiple of 16 bytes) go by plain loads; the rows of
//     the block's first lanes are loaded while the copy is in flight. Up to
//     227 KB of table, the limit raised by cudaFuncSetAttribute;
//   - each thread takes 16 bytes of each leaf row (8 lanes), loads its rows
//     the same way and stores its outputs wide; where n is not a multiple
//     of 8 or a pointer is not 16-byte aligned, the same lanes go one by
//     one.
// The first version serves a table larger than shared memory (BAL-13682:
// 9 x 13,683 x 4 B = 493 KB) and float32 and float64 leaves, where on the
// H100 it was faster than the shared-memory kernel at BAL-1778 (PERF.md
// §6). gather_reduce.gather_branch chooses by (t, ncols, dtype); both
// count as the same kernel. Each lane's sum keeps the first version's
// order (j ascending, the same rounding of the table), so both give
// bitwise the same output.
//
// B3 streams the [r*t, n_pad] twin once, coalesced, plus perm and u. The
// TPU kernel's one-hot matmul into a resident output has no counterpart: H100
// blocks run in no order, so the camera order is made in memory instead. The
// one-hot planes, integer mantissa splits and MXU passes of the TPU kernels
// are dropped: plain FMAs are exact enough in f32. B3 loads the twin
// with ld.global.cs (evict-first in L2), so its stream does not push u out
// of L2.
//
// B3 on bfloat16 twins has a kernel of its own, contract_reduce_bf16_kernel
// (replacing _contract_reduce_kernel on bf16 leaves, pallas_onehot.py:
// 153-162). On contract_reduce_kernel's pattern, 8 slots one after another
// per thread, each a dependent perm -> u chain and 18 two-byte twin loads,
// halving the twin's bytes (f32 -> bf16) cut its time by 16% (PERF.md
// §6). Here a thread takes 8 consecutive slots: one 16-byte load per twin
// row, perm as two int4 and the 8 x r gathers of u issued together; one
// warp, a block of its own, takes 256 slots of a chunk, so many are
// resident per SM and one's loads overlap another's arithmetic, and the
// combine adds a chunk's 8 warps in order, then its chunks. Alignment:
// runs and chunks start at multiples of 32 slots, so the loads are aligned
// when n_pad is a multiple of 8 and the twin and perm are 16-byte aligned;
// otherwise the launcher returns cudaErrorInvalidValue (no one-slot path).
// What bounds it next is u: [r, n] float in lane order (the caller's
// contract), two random 4-byte reads a slot, each a 32-byte sector (about
// 320 MB of sector traffic per call at BAL-1778, from an array of 40 MB
// that the twin's stream shares L2 with; PERF.md §6).
//
// Both also come batched over k columns (gather_contract_batched_kernel,
// contract_reduce_batched_kernel): the contract jax.vmap makes of the TPU
// kernels for the covariance's batched PCG (ceres_tpu/covariance.py:212),
// where the table or u carries a column axis and the leaf, rows and twin
// do not. They keep that axis innermost in memory and walk the twin, so
// each reads the twin once and moves about what its bound counts (the
// leaf once, rows, the k tables or u's and the k outputs); each column is
// bitwise the single-vector kernel's output (on bfloat16 twins, that of
// contract_reduce_bf16_kernel). Their notes are at the kernels.
//
// Each is instantiated for float and double, and for bfloat16 leaves
// (leaf.cuh: the mixed-precision solves, half the leaf bytes): B2 rounds the
// table to bfloat16 as the TPU kernel reads a bfloat16 table
// (pallas_onehot.py:120-126), B3 rounds u (:153-162); products and sums
// are float, and so are the table, u and the outputs.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "camera_chunks.cuh"
#include "leaf.cuh"
#include "smem_table.cuh"

namespace {

constexpr int kGatherBlock = 256;
constexpr int kSharedBlock = 512;  // B2's shared-memory kernel
constexpr int kReduceBlock = 256;
constexpr int kRows = 16;  // output rows per pass of a B3 block
constexpr int kSlots = 8;  // consecutive slots a thread of the bfloat16 B3 (16 bytes of a row)
constexpr int kPieceSlots = 32 * kSlots;     // slots a warp of the bfloat16 B3 (a piece of a chunk)
constexpr int kPieces = 2048 / kPieceSlots;  // pieces of a chunk of program.TWIN_CHUNK slots

template <typename L>
__global__ void __launch_bounds__(kGatherBlock)
    gather_contract_kernel(const L* __restrict__ jac, const int* __restrict__ rows,
                           const typename leaf::Leaf<L>::V* __restrict__ table, int n, int r,
                           int t, int ncols, typename leaf::Leaf<L>::V* __restrict__ out) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  const int l = blockIdx.x * kGatherBlock + threadIdx.x;
  if (l >= n) return;
  const size_t N = static_cast<size_t>(n);
  const int c = rows[l];
  const bool live = c >= 0 && c < ncols - 1;
  for (int i = 0; i < r; ++i) {
    V acc = V(0);
    if (live) {
      for (int j = 0; j < t; ++j) {
        acc += Lf::ld(jac + static_cast<size_t>(i * t + j) * N + l) *
               Lf::round(table[static_cast<size_t>(j) * ncols + c]);
      }
    }
    out[static_cast<size_t>(i) * N + l] = acc;
  }
}

// 16 bytes of a bfloat16 leaf row: 8 consecutive lanes, widened to float
__device__ __forceinline__ void load_bf16x8(const __nv_bfloat16* p, float* out) {
  union {
    uint4 u;
    unsigned short e[8];
  } w;
  w.u = __ldcs(reinterpret_cast<const uint4*>(p));
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = __bfloat162float(__ushort_as_bfloat16(w.e[k]));
}

// B2 on bfloat16 leaves with the float table staged in shared memory
// (dynamic, t * ncols values plus 16 bytes of alignment slack): a
// persistent grid of kSharedBlock threads, each taking 8 consecutive lanes
// (`wide`: n a multiple of 8 and jac, rows, out 16-byte aligned; else the
// same lanes one by one).
__global__ void __launch_bounds__(kSharedBlock)
    gather_contract_shared_kernel(const __nv_bfloat16* __restrict__ jac,
                                  const int* __restrict__ rows, const float* __restrict__ table,
                                  int n, int r, int t, int ncols, float* __restrict__ out,
                                  int wide) {
  using Lf = leaf::Leaf<__nv_bfloat16>;
  constexpr int K = 8;
  const size_t N = static_cast<size_t>(n);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  bool pending;
  const float* tbl = smem_table::begin_stage(table, t * ncols, smem, &bar, &pending);
  __syncthreads();  // the head and tail, and the barrier's initialisation
  const int groups = (n + K - 1) / K;
  for (int g = blockIdx.x * kSharedBlock + threadIdx.x; g < groups;
       g += gridDim.x * kSharedBlock) {
    const int l0 = g * K;
    int c[K];
    if (wide) {
      const int4 u = *reinterpret_cast<const int4*>(rows + l0);
      const int4 v = *reinterpret_cast<const int4*>(rows + l0 + 4);
      c[0] = u.x, c[1] = u.y, c[2] = u.z, c[3] = u.w;
      c[4] = v.x, c[5] = v.y, c[6] = v.z, c[7] = v.w;
    } else {
#pragma unroll
      for (int v = 0; v < K; ++v) c[v] = l0 + v < n ? rows[l0 + v] : -1;
    }
    if (pending) {  // the block's first lanes: the rows above overlap the copy
      smem_table::wait_body(&bar);
      pending = false;
    }
    bool live[K];
#pragma unroll
    for (int v = 0; v < K; ++v) live[v] = c[v] >= 0 && c[v] < ncols - 1;
    for (int i = 0; i < r; ++i) {
      float acc[K];
#pragma unroll
      for (int v = 0; v < K; ++v) acc[v] = 0.0f;
#pragma unroll 9
      for (int j = 0; j < t; ++j) {
        const __nv_bfloat16* row = jac + static_cast<size_t>(i * t + j) * N + l0;
        float x[K];
        if (wide) {
          load_bf16x8(row, x);
        } else {
#pragma unroll
          for (int v = 0; v < K; ++v) x[v] = l0 + v < n ? Lf::ld(row + v) : 0.0f;
        }
        const float* tj = tbl + static_cast<size_t>(j) * ncols;
#pragma unroll
        for (int v = 0; v < K; ++v) {
          if (live[v]) acc[v] += x[v] * Lf::round(tj[c[v]]);
        }
      }
      float* o = out + static_cast<size_t>(i) * N + l0;
      if (wide) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(o + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int v = 0; v < K; ++v) {
          if (l0 + v < n) o[v] = acc[v];
        }
      }
    }
  }
  if (pending) smem_table::wait_body(&bar);  // a block with no lanes: the copy ends before it exits
}

template <typename L>
__global__ void __launch_bounds__(kReduceBlock)
    contract_reduce_kernel(const L* __restrict__ twin, const int* __restrict__ perm,
                           const int* __restrict__ chunk_start,
                           const typename leaf::Leaf<L>::V* __restrict__ u, int n, int n_pad,
                           int r, int t, int nchunks,
                           typename leaf::Leaf<L>::V* __restrict__ partial) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  __shared__ V sh[kReduceBlock / 32][kRows];
  const int m = blockIdx.x;
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);
  const size_t N = static_cast<size_t>(n);
  for (int j0 = 0; j0 < t; j0 += kRows) {
    const int nj = min(kRows, t - j0);
    V acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = V(0);
    for (int k = beg + threadIdx.x; k < end; k += kReduceBlock) {
      if (u != nullptr) {
        const int l = perm[k];
        if (l < 0) continue;  // padding: the twin is zero there
        for (int i = 0; i < r; ++i) {
          const V w = Lf::round(u[static_cast<size_t>(i) * N + l]);
          const L* col = twin + static_cast<size_t>(i * t + j0) * NP + k;
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            if (q < nj) acc[q] += Lf::ldcs(col + q * NP) * w;
          }
        }
      } else {
        const L* col = twin + static_cast<size_t>(j0) * NP + k;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (q < nj) acc[q] += Lf::ldcs(col + q * NP);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      V v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) sh[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < nj) {
      V s = V(0);
#pragma unroll
      for (int w = 0; w < kReduceBlock / 32; ++w) s += sh[w][threadIdx.x];
      partial[static_cast<size_t>(j0 + threadIdx.x) * nchunks + m] = s;
    }
    __syncthreads();
  }
}

// B3 on bfloat16 twins, one warp per piece of kPieceSlots slots of a
// chunk (kPieces warps a chunk, each a block of its own, so that many are
// resident per SM and one's loads overlap another's arithmetic). Each
// thread takes kSlots consecutive slots: one 16-byte load per twin row,
// its lanes as two int4 loads of perm and the kSlots x r gathers of u
// issued together, so nothing of one slot waits for another. Per output
// row it adds its slots in order, each over i (a padding slot adds
// nothing); the warp's shuffle tree gives the piece's sums, written to
// partial [t, nchunks * kPieces], and camera_chunks.cuh's chunk_parts_sum
// adds a chunk's pieces in order, then a camera's chunks: the order of one
// 256-thread block per chunk whose warps are added in order (the batched
// B3's bfloat16 instantiation visits the same slot streams, so each of its
// columns is bitwise this kernel's output). R > 0: the camera shapes
// (r = R, t = T <= kRows: one pass, every word and u value in registers);
// R = 0: any r and t, passes of kRows rows, one word of a row serving
// every slot when r == 1, read again (from L1) for each slot when r > 1,
// which keeps that order.
template <int R, int T>
__global__ void __launch_bounds__(32)
    contract_reduce_bf16_kernel(const __nv_bfloat16* __restrict__ twin,
                                const int* __restrict__ perm, const int* __restrict__ chunk_start,
                                const float* __restrict__ u, int n, int n_pad, int r_rt, int t_rt,
                                int nchunks, float* __restrict__ partial) {
  using Lf = leaf::Leaf<__nv_bfloat16>;
  constexpr int K = kSlots;
  constexpr int kP = R > 0 ? T : kRows;  // rows of a pass
  const int r = R > 0 ? R : r_rt;
  const int t = R > 0 ? T : t_rt;
  const int m = blockIdx.x / kPieces;
  const int beg = chunk_start[m] + (blockIdx.x - m * kPieces) * kPieceSlots;
  const int end = chunk_start[m + 1];
  const size_t pstride = static_cast<size_t>(nchunks) * kPieces;
  if (beg >= end) {  // no slot in this piece
    for (int j = threadIdx.x; j < t; j += 32) partial[j * pstride + blockIdx.x] = 0.0f;
    return;
  }
  const int k0 = beg + threadIdx.x * K;
  const bool mine = k0 < end;  // chunks are whole multiples of 32 slots
  const size_t NP = static_cast<size_t>(n_pad);
  const size_t N = static_cast<size_t>(n);
  auto row = [&](int j) { return twin + static_cast<size_t>(j) * NP + k0; };
  int l[K];  // the slots' lanes, -1 on padding
  bool add[K];
#pragma unroll
  for (int s = 0; s < K; ++s) l[s] = -1;
  if (mine && u != nullptr) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(perm + k0));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(perm + k0) + 1);
    l[0] = a.x, l[1] = a.y, l[2] = a.z, l[3] = a.w;
    l[4] = b.x, l[5] = b.y, l[6] = b.z, l[7] = b.w;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) add[s] = mine && (u == nullptr || l[s] >= 0);
  // round(u) of the slots, gathered before the twin rows arrive (R > 0)
  float w[R > 0 ? R : 1][K];
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        w[i][s] = add[s] ? Lf::round(u[static_cast<size_t>(i) * N + l[s]]) : 0.0f;
      }
    }
  }
  for (int j0 = 0; j0 < t; j0 += kP) {
    const int nj = min(kP, t - j0);
    float acc[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) acc[q] = 0.0f;
    if (mine) {
      if constexpr (R > 0) {
        unsigned x[R][kP][K / 2];
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int q = 0; q < kP; ++q) leaf::ldcs_bf16_words<K>(row(i * T + q), x[i][q]);
        }
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (add[s]) {
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
              for (int q = 0; q < kP; ++q) {
                acc[q] += leaf::bf16_word_value(x[i][q], s) * w[i][s];
              }
            }
          }
        }
      } else if (u == nullptr || r == 1) {
        float ws[K];  // u == nullptr: the segmented sum (x * 1 is x)
#pragma unroll
        for (int s = 0; s < K; ++s) {
          ws[s] = u == nullptr ? 1.0f : add[s] ? Lf::round(u[l[s]]) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          if (q < nj) {
            unsigned x[K / 2];
            leaf::ldcs_bf16_words<K>(row(j0 + q), x);
#pragma unroll
            for (int s = 0; s < K; ++s) {
              if (add[s]) acc[q] += leaf::bf16_word_value(x, s) * ws[s];
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kP; ++q) {
          if (q < nj) {
#pragma unroll
            for (int s = 0; s < K; ++s) {
              if (add[s]) {
                for (int i = 0; i < r; ++i) {
                  unsigned x[K / 2];
                  leaf::ldcs_bf16_words<K>(row(i * t + j0 + q), x);
                  acc[q] += leaf::bf16_word_value(x, s) *
                            Lf::round(u[static_cast<size_t>(i) * N + l[s]]);
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      float v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (threadIdx.x == 0 && q < nj) partial[(j0 + q) * pstride + blockIdx.x] = v;
    }
  }
}

// ---- B2 and B3 over k columns at once ------------------------------------
//
// The contract jax.vmap makes of _gather_contract_kernel and
// _contract_reduce_kernel for the covariance's batched PCG
// (ceres_tpu/covariance.py:212): the table or u carries a column axis, the
// leaf, rows and twin do not. Both keep that axis innermost in memory:
// residual-space vectors are [n, r, k] (lane l's r*k values one contiguous
// row: 1,152 bytes at k = 72 in double), class tables [ncols, t, k]
// (gather_reduce.py: views of those, logical [k, r, n] and [k, t, ncols]).
// Both walk the twin (the leaf in camera order, a chunk of at most
// kChunkSlots slots per camera): a chunk's camera table slice is read once
// per chunk, and a slot's lane is one row. Bound on an H100: device memory,
// the leaf once, rows, the k tables and the k u's or outputs (1.45 GB of
// the 1.63 GB at Dubrovnik-356's shape in double; PERF.md §6).
//
// Each column is bitwise the single-vector kernel's output on it: the same
// sums in the same order (below).

constexpr int kChunkSlots = 2048;               // program.TWIN_CHUNK
constexpr int kStreams = kReduceBlock;          // contract_reduce_kernel's slot streams
constexpr int kMaxP = kChunkSlots / kStreams;   // slots of one stream (8)
constexpr int kStages = 4;                      // B3 batched: visits in flight
constexpr int kB3MaxCols = 128;                 // B3 batched: columns of a block
constexpr int kB2Threads = 256;                 // B2 batched: threads of a block at most
constexpr int kB2Split = 4;                     // B2 batched: blocks per chunk
constexpr int kB2Tile = 128;                    // B2 batched: slots per staged tile
constexpr int kAnyRows = 8;                     // rows per pass of the any-(r, t) B3
constexpr int kMaxSmem = 232448;                // the H100's 227 KB a block

// A twin element as B3 batched stages it: cp.async copies 4, 8 or 16
// bytes, so a bfloat16 element travels in the 4-byte word that holds it
// (its half picked by the slot's parity: rows and chunks start at even
// slots) and is widened as Leaf<bf16>::ldcs widens it.
template <typename L>
struct TwinWord {
  using W = L;
  __device__ __forceinline__ static const W* at(const L* p) { return p; }
  __device__ __forceinline__ static L value(W w, int) { return w; }
};

template <>
struct TwinWord<__nv_bfloat16> {
  using W = unsigned;
  __device__ __forceinline__ static const W* at(const __nv_bfloat16* p) {
    return reinterpret_cast<const W*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  }
  __device__ __forceinline__ static float value(W w, int odd) {
    return __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(odd ? w >> 16 : w & 0xffffu)));
  }
};

// N words from 16-byte-aligned shared memory, by 16-byte loads (the
// buffer holds whole 16-byte units past N)
template <typename W, int N>
__device__ __forceinline__ void load_words(const W* p, W (&out)[N]) {
  constexpr int kPer = 16 / sizeof(W);
#pragma unroll
  for (int c = 0; c < (N + kPer - 1) / kPer; ++c) {
    union {
      uint4 v;
      W w[kPer];
    } tmp;
    tmp.v = reinterpret_cast<const uint4*>(p)[c];
#pragma unroll
    for (int z = 0; z < kPer; ++z) {
      if (c * kPer + z < N) out[c * kPer + z] = tmp.w[z];
    }
  }
}

// B3 over k columns (replaces the vmapped _contract_reduce_kernel; its
// first version transposed u to [n, r, k] in a pass of its own and
// read the twin once per group of 8 columns, ~6 GB at Dubrovnik-356's
// shape for a bound of 1.63):
//     partial[m, j, e] = sum_{slots s of chunk m} sum_i twin[i*t + j, s] * u[perm[s], i, e]
// One block per (chunk, row pass, block of up to kB3MaxCols columns), the
// blocks of a chunk adjacent; H groups of column threads, thread (h, e)
// owning column e's sums of rows j0 + h*JT ... + JT - 1 of the pass. The
// block walks the chunk's slots once, so the twin is read once and u (the
// bound) once, each lane's row by 16-byte cp.async into a ring of kStages
// buffers in shared memory (the u rows of the slots of one "visit", and
// their twin values, a visit ahead of use by kStages - 1), with the
// chunk's perm staged first. Two row groups (the camera shapes in double)
// halve a thread's sums and registers and double the warps that hide the
// copies' latency; the u rows they share are staged once.
//
// The order: contract_reduce_kernel sums slot stream q (thread q: slots q,
// q + 256, ... of the chunk, each over i; contract_reduce_bf16_kernel's
// thread q: slots 8q ... 8q + 7) per thread, adds the 32 streams of a warp
// by the shuffle tree (offsets 16, 8, 4, 2, 1) and the 8 warps in order
// from 0. Here visit v is stream 32*(v / 32) + bitrev5(v % 32): in
// that order the shuffle tree is a left-to-right binary tree over the
// visits, which each thread folds with one pending sum per level (lv0 ..
// lv4) and adds each warp's root to its total. So every (column, row) sum
// is bitwise contract_reduce_kernel's on that column; camera_chunks.cuh's
// chunk_sum_lanes_kernel adds a camera's chunks in index order. No atomics.
//
// R > 0: the camera shapes (r = R, t <= H*JT, one pass, the twin values of
// a slot by 16-byte shared loads); R = 0: any r, passes of H*JT rows.
template <typename L, int R, int JT, int H>
__global__ void __launch_bounds__(H * kB3MaxCols)
    contract_reduce_batched_kernel(const L* __restrict__ twin, const int* __restrict__ perm,
                                   const int* __restrict__ chunk_start,
                                   const typename leaf::Leaf<L>::V* __restrict__ u, int n_pad,
                                   int r_arg, int t, int k, int ncb, int npass, int cbp, int wide,
                                   typename leaf::Leaf<L>::V* __restrict__ partial) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  using Tw = TwinWord<L>;
  using W = typename Tw::W;
  const int r = R > 0 ? R : r_arg;
  const int cols = blockDim.x / H;  // column threads of a row group
  const int h = threadIdx.x / cols;
  const int ct = threadIdx.x - h * cols;
  const int cb = blockIdx.x % ncb;
  const int rest = blockIdx.x / ncb;
  const int jb = (rest % npass) * H * JT;  // the pass's first row
  const int m = rest / npass;
  const int j0 = jb + h * JT;              // this thread's first row
  const int nj = max(0, min(JT, t - j0));
  const int e0 = cb * cols;
  const int cbw = min(cols, k - e0);
  const bool active = ct < cbw;
  const int beg = chunk_start[m];
  const int S = chunk_start[m + 1] - beg;
  const int rth = (r * JT + 3) & ~3;  // a slot's staged twin words of one row group (16-byte units)
  const int rtp = H * rth;
  const size_t NP = static_cast<size_t>(n_pad);
  extern __shared__ __align__(16) unsigned char smem[];
  int* perm_sh = reinterpret_cast<int*>(smem);
  V* ush = reinterpret_cast<V*>(smem + kChunkSlots * sizeof(int));
  W* tsh = reinterpret_cast<W*>(ush + static_cast<size_t>(kStages) * kMaxP * r * cbp);
  for (int s = threadIdx.x; s < S; s += blockDim.x) perm_sh[s] = perm[beg + s];
  __syncthreads();
  const int per = wide ? 16 / static_cast<int>(sizeof(V)) : 1;  // values per copy
  const int units = (cbw + per - 1) / per;                       // copies per (slot, row i)
  // a thread's copies, fixed for every visit: unit `uc` of the u rows
  // (slot p, row i) = rho0, rho0 + rstep, ... (rstep >= 1: units <= cbw <=
  // blockDim), and twin word `w0` of slots p0, p0 + pstep, ... (none if its
  // row is past t)
  const int rstep = blockDim.x / units;
  const int uc = threadIdx.x % units;
  const int rho0 = static_cast<int>(threadIdx.x) < rstep * units ? threadIdx.x / units : kMaxP * r;
  const int rn = H * r * JT;  // twin words a slot, one per (row group, i, row)
  const int pstep = blockDim.x / rn;
  const int w0 = threadIdx.x % rn;
  const int hw = w0 / (r * JT);
  const int iw = (w0 - hw * r * JT) / JT;
  const int jw = w0 - hw * r * JT - iw * JT;
  const bool real = jb + hw * JT + jw < t;
  const int p0 = static_cast<int>(threadIdx.x) < pstep * rn && real ? threadIdx.x / rn : kMaxP;
  const L* trow = twin + static_cast<size_t>(iw * t + jb + hw * JT + jw) * NP + beg;
  const int tdst = hw * rth + iw * JT + jw;

  auto stream_of = [](int v) { return (v & ~31) | static_cast<int>(__brev(v & 31) >> 27); };
  // slot p of stream q, as the single kernel's thread q takes them:
  // contract_reduce_kernel q, q + 256, ...; contract_reduce_bf16_kernel 8
  // consecutive slots from 8q on (chunks are whole multiples of 32 slots)
  constexpr bool kRun = std::is_same<L, __nv_bfloat16>::value;
  auto slot_of = [](int q, int p) { return kRun ? kMaxP * q + p : q + kStreams * p; };
  auto slots_of = [S](int q) {
    if (kRun) return kMaxP * q < S ? kMaxP : 0;
    return q < S ? (S - q + kStreams - 1) / kStreams : 0;
  };
  // stage visit v (if any) into buffer v % kStages; always one commit group
  auto stage_visit = [&](int v) {
    if (v < kStreams) {
      const int q = stream_of(v);
      const int P = slots_of(q);
      V* ub = ush + static_cast<size_t>(v % kStages) * kMaxP * r * cbp;
      W* tb = tsh + static_cast<size_t>(v % kStages) * kMaxP * rtp;
      for (int rho = rho0; rho < P * r; rho += rstep) {
        const int p = rho / r;
        const int l = perm_sh[slot_of(q, p)];
        if (l < 0) continue;  // padding: the twin is zero there
        V* dst = ub + static_cast<size_t>(rho) * cbp + uc * per;
        const V* src = u + (static_cast<size_t>(l) * r + (rho - p * r)) * k + e0 + uc * per;
        if (wide) {
          __pipeline_memcpy_async(dst, src, 16);
        } else {
          __pipeline_memcpy_async(dst, src, sizeof(V));
        }
      }
      if (pstep > 0) {
        for (int p = p0; p < P; p += pstep) {
          const int s = slot_of(q, p);
          if (perm_sh[s] < 0) continue;
          __pipeline_memcpy_async(tb + p * rtp + tdst, Tw::at(trow + s), sizeof(W));
        }
      } else {  // more twin words a slot than threads
        for (int idx = threadIdx.x; idx < P * rn; idx += blockDim.x) {
          const int p = idx / rn;
          const int x = idx - p * rn;
          const int hx = x / (r * JT);
          const int ix = (x - hx * r * JT) / JT;
          const int jx = x - hx * r * JT - ix * JT;
          const int s = slot_of(q, p);
          if (jb + hx * JT + jx >= t || perm_sh[s] < 0) continue;
          const L* src = twin + static_cast<size_t>(ix * t + jb + hx * JT + jx) * NP + beg + s;
          __pipeline_memcpy_async(tb + p * rtp + hx * rth + ix * JT + jx, Tw::at(src),
                                  sizeof(W));
        }
      }
    }
    __pipeline_commit();
  };

  // the tree's levels 0-2 in registers; levels 3-4 and the total, touched
  // every 8th, 16th and 32nd visit, in this thread's own shared memory
  // ([3][JT][blockDim]: no other thread reads them)
  V acc[JT], lv0[JT], lv1[JT], lv2[JT];
  V* lv3 = reinterpret_cast<V*>(tsh + static_cast<size_t>(kStages) * kMaxP * rtp) + threadIdx.x;
  V* lv4 = lv3 + JT * blockDim.x;
  V* tot = lv4 + JT * blockDim.x;
#pragma unroll
  for (int jj = 0; jj < JT; ++jj) {
    tot[jj * blockDim.x] = V(0);
    lv0[jj] = lv1[jj] = lv2[jj] = V(0);
  }
#pragma unroll
  for (int v = 0; v < kStages - 1; ++v) stage_visit(v);
  for (int v = 0; v < kStreams; ++v) {
    __pipeline_wait_prior(kStages - 2);  // this thread's copies of visit v have landed
    __syncthreads();                     // everyone's; and buffer (v - 1) % kStages is free
    stage_visit(v + kStages - 1);
    const int q = stream_of(v);
    const int P = slots_of(q);
    const V* ub = ush + static_cast<size_t>(v % kStages) * kMaxP * r * cbp + ct;
    const W* tb = tsh + static_cast<size_t>(v % kStages) * kMaxP * rtp + h * rth;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) acc[jj] = V(0);
    for (int p = 0; p < P; ++p) {
      if (perm_sh[slot_of(q, p)] < 0) continue;
      const int odd = slot_of(q, p) & 1;  // a bfloat16 slot's half of its word
      if constexpr (R > 0) {
        W x[R * JT];  // words past nj are never stored: their sums are dropped
        load_words(tb + p * rtp, x);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const V w = active ? Lf::round(ub[(p * R + i) * cbp]) : V(0);
#pragma unroll
          for (int jj = 0; jj < JT; ++jj) acc[jj] += Tw::value(x[i * JT + jj], odd) * w;
        }
      } else {
        for (int i = 0; i < r; ++i) {
          const V w = active ? Lf::round(ub[(p * r + i) * cbp]) : V(0);
          const W* x = tb + p * rtp + i * JT;
#pragma unroll
          for (int jj = 0; jj < JT; ++jj) {
            if (jj < nj) acc[jj] += Tw::value(x[jj], odd) * w;
          }
        }
      }
    }
    // fold visit v into the warp tree: level b holds a pending left sum
    const int mm = v & 31;
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      V x = acc[jj];
      if (!(mm & 1)) {
        lv0[jj] = x;
      } else {
        x = lv0[jj] + x;
        if (!(mm & 2)) {
          lv1[jj] = x;
        } else {
          x = lv1[jj] + x;
          if (!(mm & 4)) {
            lv2[jj] = x;
          } else {
            x = lv2[jj] + x;
            const int o = jj * blockDim.x;
            if (!(mm & 8)) {
              lv3[o] = x;
            } else {
              x = lv3[o] + x;
              if (!(mm & 16)) {
                lv4[o] = x;
              } else {
                tot[o] += lv4[o] + x;  // the warp's root, added in warp order
              }
            }
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      if (jj < nj) {
        partial[(static_cast<size_t>(m) * t + j0 + jj) * k + e0 + ct] = tot[jj * blockDim.x];
      }
    }
  }
}

// B2 over k columns (replaces the vmapped _gather_contract_kernel; its
// first version ran in lane order and gathered each lane's camera
// table per column, ~6.5 GB of scattered table reads at Dubrovnik-356's
// shape):
//     out[l, i, e] = sum_j jac[i*t + j, l] * table[rows[l], j, e]
// on the twin instead: kB2Split blocks per (chunk, block of columns), the
// blocks of a chunk adjacent, each over whole tiles of `tile` slots of the
// chunk. A chunk is one camera c (slot_row), so each thread reads its VE
// (16 bytes of) columns of the camera's [t, k] table slice once, into
// registers (rounded as the single-vector kernel rounds the table). The
// tiles' perm and r*t twin rows are staged in shared memory by coalesced
// 16-byte cp.async, double-buffered: the next tile's loads are in flight
// while this one is computed. Thread = (slot of the SP at once, row i,
// group of VE columns): per slot it reads the slot's t twin values of row
// i (one or two slots a warp: broadcasts) and stores its VE sums with one
// 16-byte store, so a slot's r*k outputs are one contiguous row
// out[perm[s], :, :] written whole. Padding slots write nothing; the dump
// column's chunks write zeros; every lane is one slot, so written once.
// Each sum runs as gather_contract_kernel's (j ascending from 0, the same
// rounding of the table): each column is bitwise its output.
//
// R, T > 0: the camera shapes; R = T = 0: any r, t (table values read per
// slot from L1).
template <typename L, int R, int T>
__global__ void __launch_bounds__(kB2Threads)
    gather_contract_batched_kernel(const L* __restrict__ twin, const int* __restrict__ perm,
                                   const int* __restrict__ chunk_start,
                                   const int* __restrict__ slot_row,
                                   const typename leaf::Leaf<L>::V* __restrict__ table, int n_pad,
                                   int r_arg, int t_arg, int ncols, int k, int ncb, int nev,
                                   int tile, int wide,
                                   typename leaf::Leaf<L>::V* __restrict__ out) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  constexpr int VE = 16 / sizeof(V);
  constexpr int LE = 16 / sizeof(L);  // leaf values per 16-byte copy
  const int r = R > 0 ? R : r_arg;
  const int t = T > 0 ? T : t_arg;
  const int rt = r * t;
  const int cb = blockIdx.x % ncb;
  const int rest = blockIdx.x / ncb;
  const int part = rest % kB2Split;
  const int m = rest / kB2Split;
  const int cbeg = chunk_start[m];
  const int cend = chunk_start[m + 1];
  const int per_part = ((cend - cbeg + tile - 1) / tile + kB2Split - 1) / kB2Split;  // tiles
  const int beg = cbeg + part * per_part * tile;
  const int end = min(cend, beg + per_part * tile);
  if (beg >= end) return;  // the whole block: no slots in this part
  const int e0 = cb * nev * VE;
  const int cbw = min(nev * VE, k - e0);
  const int ng = (cbw + VE - 1) / VE;  // this block's column groups
  const int tps = r * ng;              // threads per slot
  const int sp = blockDim.x / tps;     // slots at once
  const int sl = threadIdx.x / tps;
  const int i = (threadIdx.x - sl * tps) / ng;
  const int g = threadIdx.x - sl * tps - i * ng;
  const int e = e0 + g * VE;
  const bool full = wide && e + VE <= k;
  const int c = slot_row[cbeg];
  const bool live = c < ncols - 1;  // the dump column gathers zero
  const size_t NP = static_cast<size_t>(n_pad);
  const V* tc = table + static_cast<size_t>(c) * t * k + e;  // row j at tc + j*k
  extern __shared__ __align__(16) unsigned char smem[];
  int* psh = reinterpret_cast<int*>(smem);                       // [2][tile]
  L* tsh = reinterpret_cast<L*>(smem + 2 * tile * sizeof(int));  // [2][rt][tile]
  // tile [t0, t0 + tile) into buffer b: boundaries are multiples of 32 slots
  auto stage = [&](int t0, int b) {
    const int nt = min(tile, end - t0);
    for (int x = threadIdx.x; x < nt / 4; x += blockDim.x) {
      __pipeline_memcpy_async(psh + b * tile + 4 * x, perm + t0 + 4 * x, 16);
    }
    const int upr = nt / LE;
    for (int x = threadIdx.x; x < rt * upr; x += blockDim.x) {
      const int row = x / upr;
      const int u = x - row * upr;
      __pipeline_memcpy_async(tsh + (static_cast<size_t>(b) * rt + row) * tile + u * LE,
                              twin + row * NP + t0 + u * LE, 16);
    }
    __pipeline_commit();
  };
  auto store = [&](V* o, const V (&a)[VE]) {
    if (full) {
      if constexpr (VE == 2) {
        *reinterpret_cast<double2*>(o) = make_double2(a[0], a[1]);
      } else {
        *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
      }
    } else {
#pragma unroll
      for (int z = 0; z < VE; ++z) {
        if (e + z < k) o[z] = a[z];
      }
    }
  };
  V y[T > 0 ? T : 1][VE];
  if constexpr (T > 0) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
#pragma unroll
      for (int z = 0; z < VE; ++z) {
        y[j][z] = live && sl < sp && e + z < k ? Lf::round(__ldg(tc + j * k + z)) : V(0);
      }
    }
  }
  stage(beg, 0);
  int b = 0;
  for (int t0 = beg; t0 < end; t0 += tile, b ^= 1) {
    if (t0 + tile < end) {
      stage(t0 + tile, b ^ 1);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);  // this thread's copies of tile t0
    __syncthreads();           // everyone's
    const int nt = min(tile, end - t0);
    const int* ps = psh + b * tile;
    const L* ts = tsh + (static_cast<size_t>(b) * rt + i * t) * tile;  // row i*t + j at ts + j*tile
    for (int s = sl; sl < sp && s < nt; s += sp) {
      const int l = ps[s];
      if (l < 0) continue;  // padding
      V a[VE];
#pragma unroll
      for (int z = 0; z < VE; ++z) a[z] = V(0);
      if (live) {
        if constexpr (T > 0) {
          V x[T];
#pragma unroll
          for (int j = 0; j < T; ++j) x[j] = Lf::ld(ts + j * tile + s);
#pragma unroll
          for (int z = 0; z < VE; ++z) {
#pragma unroll
            for (int j = 0; j < T; ++j) a[z] += x[j] * y[j][z];
          }
        } else {
          for (int j = 0; j < t; ++j) {
            const V x = Lf::ld(ts + j * tile + s);
#pragma unroll
            for (int z = 0; z < VE; ++z) {
              if (e + z < k) a[z] += x * Lf::round(__ldg(tc + j * k + z));
            }
          }
        }
      }
      store(out + (static_cast<size_t>(l) * r + i) * k + e, a);
    }
    __syncthreads();  // buffer b is free for tile t0 + 2 * tile
  }
}

template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_gather(const L* jac, const int* rows, const V* table, int n, int r, int t, int ncols,
                  V* out, cudaStream_t stream) {
  const int blocks = (n + kGatherBlock - 1) / kGatherBlock;
  if (blocks > 0) {
    gather_contract_kernel<L><<<blocks, kGatherBlock, 0, stream>>>(jac, rows, table, n, r, t,
                                                                   ncols, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// the shared-memory kernel: the table plus the slack that aligns its body
// (gather_reduce.SHARED_TABLE_MAX_BYTES keeps it within the H100's 227 KB
// per block), as many blocks as are resident at once
int launch_gather_shared(const __nv_bfloat16* jac, const int* rows, const float* table, int n,
                         int r, int t, int ncols, float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int wide = n % 8 == 0 && aligned(jac) && aligned(rows) && aligned(out);
  const size_t smem = static_cast<size_t>(t) * ncols * sizeof(float) + 16;
  auto kernel = gather_contract_shared_kernel;
  cudaError_t rc = cudaSuccess;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSharedBlock, smem)) !=
          cudaSuccess) {
    return static_cast<int>(rc);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = ((n + 7) / 8 + kSharedBlock - 1) / kSharedBlock;
  const long long resident = 1LL * per_sm * sms;
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<blocks, kSharedBlock, smem, stream>>>(jac, rows, table, n, r, t, ncols, out, wide);
  return static_cast<int>(cudaGetLastError());
}

template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_reduce(const L* twin, const int* perm, const int* chunk_start, const int* row_chunks,
                  const V* u, int n, int n_pad, int r, int t, int nchunks, int ncols, V* partial,
                  V* out, cudaStream_t stream) {
  if (t > 0 && nchunks > 0) {
    contract_reduce_kernel<L><<<nchunks, kReduceBlock, 0, stream>>>(twin, perm, chunk_start, u, n,
                                                                    n_pad, r, t, nchunks, partial);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  camera_chunks::launch_chunk_sum<V>(partial, row_chunks, t, nchunks, ncols, ncols, nullptr,
                                     nullptr, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 B3 reads kSlots slots of a twin row (and of perm) at once:
// n_pad a multiple of 8 and the twin and perm 16-byte aligned, or
// cudaErrorInvalidValue (every twin the port makes is; there is no
// one-slot-at-a-time path).
int launch_reduce_bf16(const __nv_bfloat16* twin, const int* perm, const int* chunk_start,
                       const int* row_chunks, const float* u, int n, int n_pad, int r, int t,
                       int nchunks, int ncols, float* partial, float* out, cudaStream_t stream) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (n_pad % kSlots != 0 || !aligned(twin) || !aligned(perm)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (t > 0 && nchunks > 0) {
    const long long blocks = 1LL * nchunks * kPieces;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (r == 2 && t == 9) {
      contract_reduce_bf16_kernel<2, 9><<<blocks, 32, 0, stream>>>(twin, perm, chunk_start, u, n,
                                                                   n_pad, r, t, nchunks, partial);
    } else if (r == 2 && t == 10) {
      contract_reduce_bf16_kernel<2, 10><<<blocks, 32, 0, stream>>>(
          twin, perm, chunk_start, u, n, n_pad, r, t, nchunks, partial);
    } else {
      contract_reduce_bf16_kernel<0, 0><<<blocks, 32, 0, stream>>>(twin, perm, chunk_start, u, n,
                                                                   n_pad, r, t, nchunks, partial);
    }
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  camera_chunks::launch_chunk_parts_sum<float>(partial, row_chunks, t, nchunks, kPieces, ncols,
                                               ncols, nullptr, nullptr, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// the batched B2: the camera shapes (r = 2 and t = 9: angle-axis or
// quaternion-on-manifold cameras; t = 10: quaternion cameras without a
// manifold) with their table slice in registers, else any r, t; tiles of
// 128 slots, fewer where two tiles of a large r*t would pass the 227 KB
template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_gather_batched(const L* twin, const int* perm, const int* chunk_start,
                          const int* slot_row, const V* table, int n_pad, int r, int t, int ncols,
                          int k, int nchunks, V* out, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(V);
  if (nchunks <= 0 || k <= 0 || r <= 0 || r > kB2Threads) {
    return static_cast<int>(cudaGetLastError());
  }
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int wide = (k * sizeof(V)) % 16 == 0 && aligned(table) && aligned(out);
  const int groups = (k + VE - 1) / VE;
  const int nev = groups < kB2Threads / r ? groups : kB2Threads / r;  // column groups a block
  const int ncb = (groups + nev - 1) / nev;
  const int tps = r * nev;
  const int threads = (kB2Threads / tps) * tps;
  int tile = kB2Tile;
  auto smem = [&](int tl) { return 2 * static_cast<size_t>(tl) * (sizeof(int) + r * t * sizeof(L)); };
  while (smem(tile) > kMaxSmem && tile > 32) tile /= 2;
  if (smem(tile) > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = 1LL * nchunks * kB2Split * ncb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto launch = [&](auto kernel) {
    cudaError_t rc = cudaSuccess;
    if (smem(tile) > 48 * 1024) {
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem(tile)));
    }
    if (rc != cudaSuccess) return rc;
    kernel<<<static_cast<unsigned>(blocks), threads, smem(tile), stream>>>(
        twin, perm, chunk_start, slot_row, table, n_pad, r, t, ncols, k, ncb, nev, tile, wide,
        out);
    return cudaGetLastError();
  };
  cudaError_t rc;
  if (r == 2 && t == 9) {
    rc = launch(gather_contract_batched_kernel<L, 2, 9>);
  } else if (r == 2 && t == 10) {
    rc = launch(gather_contract_batched_kernel<L, 2, 10>);
  } else {
    rc = launch(gather_contract_batched_kernel<L, 0, 0>);
  }
  return static_cast<int>(rc);
}

// the batched B3 with H row groups of JT rows: block size, shared memory
// (the chunk's perm, kStages buffers of kMaxP slots' u rows and twin
// words, three tree levels a thread), the limit raised past 48 KB; fewer
// columns a block where a large r would pass the 227 KB
template <typename L, int R, int JT, int H, typename V = typename leaf::Leaf<L>::V>
cudaError_t launch_reduce_batched_pass(const L* twin, const int* perm, const int* chunk_start,
                                       const V* u, int n_pad, int r, int t, int k, int nchunks,
                                       V* partial, cudaStream_t stream) {
  using W = typename TwinWord<L>::W;
  auto kernel = contract_reduce_batched_kernel<L, R, JT, H>;
  const int npass = (t + H * JT - 1) / (H * JT);
  const int rtp = H * ((r * JT + 3) & ~3);
  int cols = (k < kB3MaxCols ? (k + 31) / 32 : kB3MaxCols / 32) * 32;
  int cbp = 0;
  size_t smem = 0;
  for (; cols >= 32; cols -= 32) {
    const int cbw = k < cols ? k : cols;
    const int vpu = 16 / static_cast<int>(sizeof(V));
    cbp = (cbw + vpu - 1) / vpu * vpu;
    smem = kChunkSlots * sizeof(int) + static_cast<size_t>(kStages) * kMaxP * r * cbp * sizeof(V) +
           static_cast<size_t>(kStages) * kMaxP * rtp * sizeof(W) +
           3 * static_cast<size_t>(JT) * cols * H * sizeof(V);
    if (smem <= kMaxSmem) break;
  }
  if (cols < 32) return cudaErrorInvalidConfiguration;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const int ncb = (k + cols - 1) / cols;
  const long long blocks = 1LL * nchunks * npass * ncb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int wide = (k * sizeof(V)) % 16 == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0;
  kernel<<<static_cast<unsigned>(blocks), cols * H, smem, stream>>>(
      twin, perm, chunk_start, u, n_pad, r, t, k, ncb, npass, cbp, wide, partial);
  return cudaGetLastError();
}

template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_reduce_batched(const L* twin, const int* perm, const int* chunk_start,
                          const int* row_chunks, const V* u, int n_pad, int r, int t, int k,
                          int nchunks, int ncols, V* partial, V* out, cudaStream_t stream) {
  if (t > 0 && k > 0 && nchunks > 0 && r > 0) {
    cudaError_t rc;
    // the camera shapes: double sums in two row groups (rows 0-4, 5-8 or
    // 5-9), float sums in one. On the H100 at k = 72 the double kernel
    // waits on its copies and gains from the warps two groups add (1.16-1.22
    // ms against 1.52-1.60), the float one is bound by its instructions and
    // loses (2.96 against 2.57-2.59; PERF.md §6)
    if (r == 2 && (t == 9 || t == 10)) {
      if constexpr (sizeof(V) == 8) {
        rc = launch_reduce_batched_pass<L, 2, 5, 2>(twin, perm, chunk_start, u, n_pad, r, t, k,
                                                    nchunks, partial, stream);
      } else if (t == 9) {
        rc = launch_reduce_batched_pass<L, 2, 9, 1>(twin, perm, chunk_start, u, n_pad, r, t, k,
                                                    nchunks, partial, stream);
      } else {
        rc = launch_reduce_batched_pass<L, 2, 10, 1>(twin, perm, chunk_start, u, n_pad, r, t,
                                                     k, nchunks, partial, stream);
      }
    } else {
      rc = launch_reduce_batched_pass<L, 0, kAnyRows, 1>(twin, perm, chunk_start, u, n_pad, r,
                                                         t, k, nchunks, partial, stream);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  camera_chunks::launch_chunk_sum_lanes<V>(partial, row_chunks, t * k, ncols, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the batched B2 and B3 (gather_reduce.gather_contract_batched /
// contract_reduce_batched), the column axis innermost: table [ncols, t, k],
// out [n, r, k]; u [n, r, k], partial [nchunks, t, k], out [ncols, t, k]
#define CTT_BATCHED(SUFFIX, L, V)                                                                 \
  extern "C" int ctt_gather_contract_batched##SUFFIX(                                             \
      const L* twin, const int* perm, const int* chunk_start, const int* slot_row,               \
      const V* table, int n_pad, int r, int t, int ncols, int k, int nchunks, V* out,             \
      void* stream) {                                                                             \
    return launch_gather_batched<L>(twin, perm, chunk_start, slot_row, table, n_pad, r, t, ncols, \
                                    k, nchunks, out, static_cast<cudaStream_t>(stream));          \
  }                                                                                               \
  extern "C" int ctt_contract_reduce_batched##SUFFIX(                                             \
      const L* twin, const int* perm, const int* chunk_start, const int* row_chunks, const V* u, \
      int n_pad, int r, int t, int k, int nchunks, int ncols, V* partial, V* out, void* stream) { \
    return launch_reduce_batched<L>(twin, perm, chunk_start, row_chunks, u, n_pad, r, t, k,      \
                                    nchunks, ncols, partial, out,                                 \
                                    static_cast<cudaStream_t>(stream));                           \
  }
CTT_BATCHED(_f32, float, float)
CTT_BATCHED(_f64, double, double)
CTT_BATCHED(_bf16, __nv_bfloat16, float)
#undef CTT_BATCHED

extern "C" int ctt_gather_contract_f32(const float* jac, const int* rows, const float* table,
                                       int n, int r, int t, int ncols, float* out, void* stream) {
  return launch_gather<float>(jac, rows, table, n, r, t, ncols, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_gather_contract_f64(const double* jac, const int* rows, const double* table,
                                       int n, int r, int t, int ncols, double* out, void* stream) {
  return launch_gather<double>(jac, rows, table, n, r, t, ncols, out,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_contract_reduce_f32(const float* twin, const int* perm, const int* chunk_start,
                                       const int* row_chunks, const float* u, int n, int n_pad,
                                       int r, int t, int nchunks, int ncols, float* partial,
                                       float* out, void* stream) {
  return launch_reduce<float>(twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, nchunks,
                              ncols, partial, out, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_contract_reduce_f64(const double* twin, const int* perm,
                                       const int* chunk_start, const int* row_chunks,
                                       const double* u, int n, int n_pad, int r, int t,
                                       int nchunks, int ncols, double* partial, double* out,
                                       void* stream) {
  return launch_reduce<double>(twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, nchunks,
                               ncols, partial, out, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_gather_contract_bf16(const __nv_bfloat16* jac, const int* rows,
                                        const float* table, int n, int r, int t, int ncols,
                                        float* out, void* stream) {
  return launch_gather<__nv_bfloat16>(jac, rows, table, n, r, t, ncols, out,
                                      static_cast<cudaStream_t>(stream));
}

// B2 on bfloat16 leaves with the table in shared memory
// (gather_reduce.gather_branch "shared")
extern "C" int ctt_gather_contract_shared_bf16(const __nv_bfloat16* jac, const int* rows,
                                               const float* table, int n, int r, int t,
                                               int ncols, float* out, void* stream) {
  return launch_gather_shared(jac, rows, table, n, r, t, ncols, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_contract_reduce_bf16(const __nv_bfloat16* twin, const int* perm,
                                        const int* chunk_start, const int* row_chunks,
                                        const float* u, int n, int n_pad, int r, int t,
                                        int nchunks, int ncols, float* partial, float* out,
                                        void* stream) {
  return launch_reduce_bf16(twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, nchunks,
                            ncols, partial, out, static_cast<cudaStream_t>(stream));
}
