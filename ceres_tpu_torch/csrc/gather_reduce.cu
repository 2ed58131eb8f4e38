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
// Both also come batched over k columns (gather_contract_batched_kernel,
// contract_reduce_batched_kernel): the contract jax.vmap makes of the TPU
// kernels for the covariance's batched PCG (ceres_tpu/covariance.py:212),
// where the table or u carries a column axis and the leaf, rows and twin
// do not. Bound on an H100: device memory, the leaf once, rows, the k
// tables or u's and the k outputs. Run column by column, the single-vector
// kernels would read the leaf k times (at Dubrovnik-356's shape in float64,
// 181 MB per read); the batched B2 reads it once (a lane's leaf values in
// registers) and the batched B3 once per group of G columns. Each
// column is bitwise the single-vector kernel's output: the same sums in the
// same order.
//
// Each is instantiated for float and double, and for bfloat16 leaves
// (leaf.cuh: the mixed-precision solves, half the leaf bytes): B2 rounds the
// table to bfloat16 as the TPU kernel reads a bfloat16 table
// (pallas_onehot.py:120-126), B3 rounds u (:153-162); products and sums
// are float, and so are the table, u and the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "camera_chunks.cuh"
#include "leaf.cuh"

namespace {

constexpr int kGatherBlock = 256;
constexpr int kSharedBlock = 512;  // B2's shared-memory kernel
constexpr int kReduceBlock = 256;
constexpr int kRows = 16;  // output rows per pass of a B3 block

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage table[0, count) into shared memory at sh (sh + head 16-byte
// aligned, head = the elements before table's first 16-byte boundary):
// the aligned body by one bulk copy that completes on *bar, head and tail
// by plain loads. Returns the body's bytes (0: nothing to wait for). The
// caller synchronizes the block, then waits (wait_body) before reading.
__device__ __forceinline__ int stage_table(const float* table, int count, int head, float* sh,
                                           unsigned long long* bar) {
  const int body_bytes = static_cast<int>((static_cast<size_t>(count - head) * 4) & ~size_t(15));
  const int body = body_bytes / 4;
  if (threadIdx.x == 0 && body_bytes > 0) {
    const unsigned b = smem_u32(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                 "r"(body_bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(sh + head)),
        "l"(table + head), "r"(body_bytes), "r"(b)
        : "memory");
  }
  for (int k = threadIdx.x; k < head; k += blockDim.x) sh[k] = table[k];
  for (int k = head + body + threadIdx.x; k < count; k += blockDim.x) sh[k] = table[k];
  return body_bytes;
}

__device__ __forceinline__ void wait_body(unsigned long long* bar) {
  const unsigned b = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
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
  const int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(table) & 15)) & 15) / 4);
  const int count = t * ncols;
  const int h = head < count ? head : count;
  float* tbl = reinterpret_cast<float*>(smem + ((16 - h * 4) & 15));
  bool pending = stage_table(table, count, h, tbl, &bar) > 0;
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
      wait_body(&bar);
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
  if (pending) wait_body(&bar);  // a block with no lanes: the copy ends before it exits
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

// B2 over k columns at once (the contract jax.vmap makes of
// _gather_contract_kernel for the covariance's batched PCG,
// ceres_tpu/covariance.py:212): out[e, i, l] = sum_j jac[i*t + j, l] *
// table[e, j, rows[l]], the table given as [k, ncols, t] (the wrapper's
// transposed copy of [k, t, ncols]: one column's table is contiguous, and
// a lane's t values of it too, so the block's lanes, which sweep the
// columns together, find the column they are on in L1). One thread per
// lane: with R, T > 0 its R*T leaf values are loaded once into registers
// and serve all k columns; R = T = 0 takes any r, t and reads the leaf
// again per column (from L1/L2). Each column's sums run as
// gather_contract_kernel's (j ascending, the same rounding of the table),
// so each column is bitwise that kernel's output.
template <typename L, int R, int T>
__global__ void __launch_bounds__(kGatherBlock)
    gather_contract_batched_kernel(const L* __restrict__ jac, const int* __restrict__ rows,
                                   const typename leaf::Leaf<L>::V* __restrict__ table, int n,
                                   int r, int t, int ncols, int k,
                                   typename leaf::Leaf<L>::V* __restrict__ out) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  const int l = blockIdx.x * kGatherBlock + threadIdx.x;
  if (l >= n) return;
  const size_t N = static_cast<size_t>(n);
  const int c = rows[l];
  if (!(c >= 0 && c < ncols - 1)) {  // the dump column gathers zero
    for (int q = 0; q < k * r; ++q) out[static_cast<size_t>(q) * N + l] = V(0);
    return;
  }
  const size_t col_stride = static_cast<size_t>(ncols) * t;
  const V* tc = table + static_cast<size_t>(c) * t;
  if constexpr (R > 0) {
    V x[R * T];
#pragma unroll
    for (int q = 0; q < R * T; ++q) x[q] = Lf::ld(jac + static_cast<size_t>(q) * N + l);
    for (int e = 0; e < k; ++e) {
      const V* te = tc + e * col_stride;
      V y[T];
#pragma unroll
      for (int j = 0; j < T; ++j) y[j] = Lf::round(te[j]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        V acc = V(0);
#pragma unroll
        for (int j = 0; j < T; ++j) acc += x[i * T + j] * y[j];
        out[(static_cast<size_t>(e) * R + i) * N + l] = acc;
      }
    }
  } else {
    for (int e = 0; e < k; ++e) {
      const V* te = tc + e * col_stride;
      for (int i = 0; i < r; ++i) {
        V acc = V(0);
        for (int j = 0; j < t; ++j) {
          acc += Lf::ld(jac + static_cast<size_t>(i * t + j) * N + l) * Lf::round(te[j]);
        }
        out[(static_cast<size_t>(e) * r + i) * N + l] = acc;
      }
    }
  }
}

// B3 over k columns at once (the vmapped _contract_reduce_kernel): one
// block per (chunk, group of G columns), the same 256 threads and
// slot-to-thread map as contract_reduce_kernel. A thread loads each slot's
// twin values once for the group and forms the products with the group's
// u values, so the twin is read ceil(k / G) times for k columns (G =
// kBatchCols = 8: at 200 registers a thread for float64 and 124 for float
// vectors, no spills; 4 and 16 were slower on the H100). u comes
// lane-major, [n, r, k] (lanes_major_kernel's copy of [k, r, n]): the
// slots of a camera gather lanes from all over n, and this way a slot's G
// values of one row are one contiguous load (32 or 64 bytes) instead of G
// scattered sectors. Each (column, row) sum runs in the single-vector
// kernel's order (slots of the thread ascending, i ascending, the same
// shuffle tree and pass over the warps), and rows are independent, so the
// passes of kBatchRows rows (not kRows) change nothing: each column is
// bitwise contract_reduce_kernel's output. partial is [k*t, nchunks].
constexpr int kBatchCols = 8;
constexpr int kBatchRows = 9;
constexpr int kTile = 32;  // lanes_major_kernel's tiles: 32 x 32, 32 x 8 threads

// u [k, r, n] -> [n, r, k]: for each row i the [k, n] matrix transposed
// through a shared-memory tile (reads and writes coalesced; torch's strided
// copy of the same permutation took ~3.5 ms at k = 72, n = 1,255,268 in
// float64 on the H100)
template <typename V>
__global__ void __launch_bounds__(kTile * 8)
    lanes_major_kernel(const V* __restrict__ u, int k, int r, int n, V* __restrict__ out) {
  __shared__ V tile[kTile][kTile + 1];
  const int l0 = blockIdx.x * kTile;
  const int e0 = blockIdx.y * kTile;
  const int i = blockIdx.z;
  const size_t N = static_cast<size_t>(n);
  for (int y = threadIdx.y; y < kTile; y += 8) {
    const int e = e0 + y, l = l0 + threadIdx.x;
    if (e < k && l < n) tile[y][threadIdx.x] = u[(static_cast<size_t>(e) * r + i) * N + l];
  }
  __syncthreads();
  for (int y = threadIdx.y; y < kTile; y += 8) {
    const int l = l0 + y, e = e0 + threadIdx.x;
    if (e < k && l < n) out[(static_cast<size_t>(l) * r + i) * k + e] = tile[threadIdx.x][y];
  }
}

template <typename L>
__global__ void __launch_bounds__(kReduceBlock)
    contract_reduce_batched_kernel(const L* __restrict__ twin, const int* __restrict__ perm,
                                   const int* __restrict__ chunk_start,
                                   const typename leaf::Leaf<L>::V* __restrict__ u, int n,
                                   int n_pad, int r, int t, int k, int nchunks,
                                   typename leaf::Leaf<L>::V* __restrict__ partial) {
  using Lf = leaf::Leaf<L>;
  using V = typename Lf::V;
  __shared__ V sh[kReduceBlock / 32][kBatchCols][kBatchRows];
  const int m = blockIdx.x;
  const int e0 = blockIdx.y * kBatchCols;
  const int ne = min(kBatchCols, k - e0);
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);
  for (int j0 = 0; j0 < t; j0 += kBatchRows) {
    const int nj = min(kBatchRows, t - j0);
    V acc[kBatchCols][kBatchRows];
#pragma unroll
    for (int c = 0; c < kBatchCols; ++c) {
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) acc[c][q] = V(0);
    }
    for (int s = beg + threadIdx.x; s < end; s += kReduceBlock) {
      const int l = perm[s];
      if (l < 0) continue;  // padding: the twin is zero there
      for (int i = 0; i < r; ++i) {
        const L* col = twin + static_cast<size_t>(i * t + j0) * NP + s;
        V x[kBatchRows];
#pragma unroll
        for (int q = 0; q < kBatchRows; ++q) x[q] = q < nj ? Lf::ldcs(col + q * NP) : V(0);
        const V* ui = u + (static_cast<size_t>(l) * r + i) * k + e0;
#pragma unroll
        for (int c = 0; c < kBatchCols; ++c) {
          if (c < ne) {
            const V w = Lf::round(ui[c]);
#pragma unroll
            for (int q = 0; q < kBatchRows; ++q) {
              if (q < nj) acc[c][q] += x[q] * w;
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kBatchCols; ++c) {
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) {
        V v = acc[c][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) sh[warp][c][q] = v;
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < ne * nj; o += kReduceBlock) {
      const int c = o / nj;
      const int q = o - c * nj;
      V s = V(0);
#pragma unroll
      for (int w = 0; w < kReduceBlock / 32; ++w) s += sh[w][c][q];
      partial[(static_cast<size_t>(e0 + c) * t + j0 + q) * nchunks + m] = s;
    }
    __syncthreads();
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

// the batched B2: the leaf in registers for the camera shapes (r = 2 and
// t = 9: angle-axis or quaternion-on-manifold cameras; t = 10: quaternion
// cameras without a manifold), else the kernel that reads it per column
template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_gather_batched(const L* jac, const int* rows, const V* table, int n, int r, int t,
                          int ncols, int k, V* out, cudaStream_t stream) {
  const int blocks = (n + kGatherBlock - 1) / kGatherBlock;
  if (blocks > 0 && k > 0) {
    if (r == 2 && t == 9) {
      gather_contract_batched_kernel<L, 2, 9>
          <<<blocks, kGatherBlock, 0, stream>>>(jac, rows, table, n, r, t, ncols, k, out);
    } else if (r == 2 && t == 10) {
      gather_contract_batched_kernel<L, 2, 10>
          <<<blocks, kGatherBlock, 0, stream>>>(jac, rows, table, n, r, t, ncols, k, out);
    } else {
      gather_contract_batched_kernel<L, 0, 0>
          <<<blocks, kGatherBlock, 0, stream>>>(jac, rows, table, n, r, t, ncols, k, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename L, typename V = typename leaf::Leaf<L>::V>
int launch_reduce_batched(const L* twin, const int* perm, const int* chunk_start,
                          const int* row_chunks, const V* u, int n, int n_pad, int r, int t,
                          int k, int nchunks, int ncols, V* u_lanes, V* partial, V* out,
                          cudaStream_t stream) {
  if (t > 0 && k > 0 && nchunks > 0) {
    if (n > 0 && r > 0) {
      const dim3 tgrid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile, r);
      lanes_major_kernel<V><<<tgrid, dim3(kTile, 8), 0, stream>>>(u, k, r, n, u_lanes);
    }
    const dim3 grid(nchunks, (k + kBatchCols - 1) / kBatchCols);
    contract_reduce_batched_kernel<L><<<grid, kReduceBlock, 0, stream>>>(
        twin, perm, chunk_start, u_lanes, n, n_pad, r, t, k, nchunks, partial);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  camera_chunks::launch_chunk_sum<V>(partial, row_chunks, k * t, nchunks, ncols, ncols, nullptr,
                                     nullptr, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the batched B2 and B3 (gather_reduce.gather_contract_batched /
// contract_reduce_batched): table [k, ncols, t], out [k, r, n]; u [k, r, n],
// u_lanes [n, r, k] (scratch), partial [k*t, nchunks], out [k, t, ncols]
#define CTT_BATCHED(SUFFIX, L, V)                                                                 \
  extern "C" int ctt_gather_contract_batched##SUFFIX(const L* jac, const int* rows,               \
                                                     const V* table, int n, int r, int t,         \
                                                     int ncols, int k, V* out, void* stream) {    \
    return launch_gather_batched<L>(jac, rows, table, n, r, t, ncols, k, out,                     \
                                    static_cast<cudaStream_t>(stream));                           \
  }                                                                                               \
  extern "C" int ctt_contract_reduce_batched##SUFFIX(                                             \
      const L* twin, const int* perm, const int* chunk_start, const int* row_chunks, const V* u, \
      int n, int n_pad, int r, int t, int k, int nchunks, int ncols, V* u_lanes, V* partial,     \
      V* out, void* stream) {                                                                     \
    return launch_reduce_batched<L>(twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t, k,   \
                                    nchunks, ncols, u_lanes, partial, out,                        \
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
  return launch_reduce<__nv_bfloat16>(twin, perm, chunk_start, row_chunks, u, n, n_pad, r, t,
                                      nchunks, ncols, partial, out,
                                      static_cast<cudaStream_t>(stream));
}
