// The second pass of kernels B3, B4 and B5: combine per-chunk partial sums.
//
// These kernels read a camera-ordered, padded copy of a Jacobian leaf (the
// "twin", ceres_tpu_torch/jacobian.py make_twin) and run one block per
// chunk of at most TWIN_CHUNK slots; a chunk never straddles two cameras
// (program.py camera_layout). Each block writes its k sums to column m of
// partial [k, nchunks]. This pass adds camera c's chunks
// [row_chunks[c], row_chunks[c+1]) in index order, one thread per output:
// the result does not depend on how blocks were scheduled, so two runs are
// bitwise equal without atomics. A camera without observations gets 0.
// Columns c >= live_cols are 0 (B4 runs no chunk of its dump column). When
// dsq is given, the other columns get + dsq·y (y, dsq and out all [k, ncols]),
// rounded as a product and then a sum (no FMA), as out + dsq·y rounds. B3
// and B5 pass live_cols = ncols and no y or dsq.
#pragma once

#include <cuda_runtime.h>

// internal linkage: each translation unit that includes this header keeps
// its own copy of the kernel (no relocatable device code across files)
namespace camera_chunks {
namespace {

constexpr int kSumBlock = 256;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kSumBlock)
    chunk_sum_kernel(const T* __restrict__ partial, const int* __restrict__ row_chunks, int k,
                     int nchunks, int ncols, int live_cols, const T* __restrict__ y,
                     const T* __restrict__ dsq, T* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * kSumBlock + threadIdx.x;
  if (idx >= static_cast<long long>(k) * ncols) return;
  const int e = static_cast<int>(idx / ncols);
  const int c = static_cast<int>(idx % ncols);
  T s = T(0);
  if (c < live_cols) {
    const T* row = partial + static_cast<size_t>(e) * nchunks;
    for (int m = row_chunks[c]; m < row_chunks[c + 1]; ++m) s += row[m];
    if (dsq != nullptr) s = add_rn(s, mul_rn(dsq[idx], y[idx]));
  }
  out[idx] = s;
}

template <typename T>
void launch_chunk_sum(const T* partial, const int* row_chunks, int k, int nchunks, int ncols,
                      int live_cols, const T* y, const T* dsq, T* out, cudaStream_t stream) {
  const long long total = static_cast<long long>(k) * ncols;
  if (total > 0) {
    const int blocks = static_cast<int>((total + kSumBlock - 1) / kSumBlock);
    chunk_sum_kernel<T><<<blocks, kSumBlock, 0, stream>>>(partial, row_chunks, k, nchunks, ncols,
                                                          live_cols, y, dsq, out);
  }
}

}  // namespace
}  // namespace camera_chunks
