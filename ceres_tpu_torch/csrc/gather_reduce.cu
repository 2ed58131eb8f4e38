// Kernels B2 and B3: the camera-side Jacobian products of the Schur solve.
//
// B2 gather_contract replaces ceres_tpu/pallas_onehot.py
// _gather_contract_kernel (via gather_contract):
//     out[i, l] = sum_j jac[i*t + j, l] * table[j, rows[l]]
// one thread per observation; the last table column is the dump column of
// constant blocks and gathers zero.
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
// Bound on an H100: device memory. B2 streams the [r*t, n] leaf once
// (coalesced: neighbouring threads read neighbouring lanes) and gathers from a
// [t, ncols] table small enough to stay in L2 (9 x 1779 values at BAL-1778).
// B3 streams the [r*t, n_pad] twin once, coalesced, plus perm and u. The
// TPU kernel's one-hot matmul into a resident output has no counterpart: H100
// blocks run in no order, so the camera order is made in memory instead. The
// one-hot planes, integer mantissa splits and MXU passes of the TPU kernels
// are dropped: plain FMAs are exact enough in f32. Loads are plain per-thread
// loads: each value is used once, by the thread that loads it, so staging
// through shared memory would add a copy and no reuse. B3 loads the twin
// with ld.global.cs (evict-first in L2), so its stream does not push u out
// of L2.

#include <cuda_runtime.h>

#include "camera_chunks.cuh"

namespace {

constexpr int kGatherBlock = 256;
constexpr int kReduceBlock = 256;
constexpr int kRows = 16;  // output rows per pass of a B3 block

template <typename T>
__global__ void __launch_bounds__(kGatherBlock)
    gather_contract_kernel(const T* __restrict__ jac, const int* __restrict__ rows,
                           const T* __restrict__ table, int n, int r, int t, int ncols,
                           T* __restrict__ out) {
  const int l = blockIdx.x * kGatherBlock + threadIdx.x;
  if (l >= n) return;
  const size_t N = static_cast<size_t>(n);
  const int c = rows[l];
  const bool live = c >= 0 && c < ncols - 1;
  for (int i = 0; i < r; ++i) {
    T acc = T(0);
    if (live) {
      for (int j = 0; j < t; ++j) {
        acc += jac[static_cast<size_t>(i * t + j) * N + l] * table[static_cast<size_t>(j) * ncols + c];
      }
    }
    out[static_cast<size_t>(i) * N + l] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceBlock)
    contract_reduce_kernel(const T* __restrict__ twin, const int* __restrict__ perm,
                           const int* __restrict__ chunk_start, const T* __restrict__ u, int n,
                           int n_pad, int r, int t, int nchunks, T* __restrict__ partial) {
  __shared__ T sh[kReduceBlock / 32][kRows];
  const int m = blockIdx.x;
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t NP = static_cast<size_t>(n_pad);
  const size_t N = static_cast<size_t>(n);
  for (int j0 = 0; j0 < t; j0 += kRows) {
    const int nj = min(kRows, t - j0);
    T acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = T(0);
    for (int k = beg + threadIdx.x; k < end; k += kReduceBlock) {
      if (u != nullptr) {
        const int l = perm[k];
        if (l < 0) continue;  // padding: the twin is zero there
        for (int i = 0; i < r; ++i) {
          const T w = u[static_cast<size_t>(i) * N + l];
          const T* col = twin + static_cast<size_t>(i * t + j0) * NP + k;
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            if (q < nj) acc[q] += __ldcs(col + q * NP) * w;
          }
        }
      } else {
        const T* col = twin + static_cast<size_t>(j0) * NP + k;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (q < nj) acc[q] += __ldcs(col + q * NP);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      T v = acc[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) sh[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < nj) {
      T s = T(0);
#pragma unroll
      for (int w = 0; w < kReduceBlock / 32; ++w) s += sh[w][threadIdx.x];
      partial[static_cast<size_t>(j0 + threadIdx.x) * nchunks + m] = s;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_gather(const T* jac, const int* rows, const T* table, int n, int r, int t, int ncols,
                  T* out, cudaStream_t stream) {
  const int blocks = (n + kGatherBlock - 1) / kGatherBlock;
  if (blocks > 0) {
    gather_contract_kernel<T><<<blocks, kGatherBlock, 0, stream>>>(jac, rows, table, n, r, t,
                                                                   ncols, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(const T* twin, const int* perm, const int* chunk_start, const int* row_chunks,
                  const T* u, int n, int n_pad, int r, int t, int nchunks, int ncols, T* partial,
                  T* out, cudaStream_t stream) {
  if (t > 0 && nchunks > 0) {
    contract_reduce_kernel<T><<<nchunks, kReduceBlock, 0, stream>>>(twin, perm, chunk_start, u, n,
                                                                    n_pad, r, t, nchunks, partial);
  }
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  camera_chunks::launch_chunk_sum<T>(partial, row_chunks, t, nchunks, ncols, ncols, nullptr,
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
