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

}  // namespace

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
