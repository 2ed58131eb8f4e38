// The bfloat16 copy of a Jacobian's leaves and twins for the mixed-precision
// solves' PCG matvec (jacobian.py BlockJacobian.astype): every tensor of a
// list rounded to bfloat16, round-to-nearest-even, in one launch (up to
// kMaxTensors tensors a launch).
//
// It replaces no TPU kernel: ceres_tpu casts with astype
// (ceres_tpu/jacobian.py:436-458) and leaves the copy to XLA. On the card
// that copy was one PyTorch copy kernel per tensor, which a device trace
// cannot tell from the rest of the elementwise work; one launch of its own
// gives the copy a name, a launch counter and a roofline share.
//
// The result is bitwise Tensor.to(torch.bfloat16) on every finite value and
// on the infinities: float32 goes through __floats2bfloat162_rn, which is
// the rounding of PyTorch's own conversion on the card; float64 is rounded
// to float first, as PyTorch's copy does (c10::BFloat16 is made from a
// float). A NaN stays a NaN.
//
// Bound on an H100: device memory, each value read once (4 or 8 bytes) and
// written once (2 bytes); at BAL-1778 the F and E leaves and their twins
// are ~240M values, ~1.45 GB moved from float32. Design: the tensors' table
// (source, destination, count, first block) travels by value in the launch's
// parameters (__grid_constant__: read in place, never copied to local
// memory), so a CUDA graph that captures the launch holds it and nothing is
// uploaded. Each block takes kBlockValues consecutive values of one tensor,
// each thread 8 of them: two 16-byte loads (four from float64), one 16-byte
// store, with no cache hint and no loop, as PyTorch's own copy kernel does
// it (four such steps a thread with evict-first loads ran ~3% slower than
// Tensor.to's four launches on an H100; this design ~1.6% faster). A
// tensor whose pointers are not 16-byte aligned, and the last values of a
// tensor whose count is not a multiple of 8, go one value at a time.

#include <climits>
#include <cstdint>

#include "leaf.cuh"

namespace leaf_to_bf16 {
namespace {

constexpr int kMaxTensors = 32;
constexpr int kThreads = 256;
constexpr int kVec = 8;  // values a thread converts
constexpr long long kBlockValues = 1LL * kThreads * kVec;

template <typename S>
struct Copies {
  const S* src[kMaxTensors];
  __nv_bfloat16* dst[kMaxTensors];
  long long n[kMaxTensors];
  // tensor k's blocks are [first_block[k], first_block[k + 1])
  long long first_block[kMaxTensors + 1];
  int count;
};

// 8 consecutive source values (p 16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, float (&v)[kVec]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 a = reinterpret_cast<const double2*>(p)[h];
    v[2 * h] = static_cast<float>(a.x);
    v[2 * h + 1] = static_cast<float>(a.y);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    leaf_to_bf16_kernel(const __grid_constant__ Copies<S> c) {
  const long long b = blockIdx.x;
  int k = 0;  // the tensor of this block (an empty tensor owns no block)
  while (k + 1 < c.count && c.first_block[k + 1] <= b) ++k;
  const S* __restrict__ src = c.src[k];
  __nv_bfloat16* __restrict__ dst = c.dst[k];
  const long long n = c.n[k];
  const long long i = (b - c.first_block[k]) * kBlockValues + 1LL * threadIdx.x * kVec;
  if (i >= n) return;
  const bool wide =
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16 == 0;
  if (wide && i + kVec <= n) {
    float v[kVec];
    load8(src + i, v);
    uint4 w;
    w.x = leaf::bf16_word(v[0], v[1]);
    w.y = leaf::bf16_word(v[2], v[3]);
    w.z = leaf::bf16_word(v[4], v[5]);
    w.w = leaf::bf16_word(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + i) = w;
  } else {
    for (long long j = i; j < min(n, i + kVec); ++j) {
      dst[j] = __float2bfloat16_rn(static_cast<float>(src[j]));
    }
  }
}

// src, dst and n are host arrays of `count` entries: the sources, the
// destinations (each n[k] values, contiguous) and the counts. Tensors go
// kMaxTensors to a launch; *launches is set to the number of launches made
// (a group of empty tensors makes none).
template <typename S>
int launch(const void* const* src, void* const* dst, const long long* n, int count,
           int* launches, cudaStream_t stream) {
  *launches = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < count; ++k) {
    if (n[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int lo = 0; lo < count; lo += kMaxTensors) {
    Copies<S> c{};
    c.count = count - lo < kMaxTensors ? count - lo : kMaxTensors;
    long long blocks = 0;
    for (int k = 0; k < c.count; ++k) {
      c.src[k] = static_cast<const S*>(src[lo + k]);
      c.dst[k] = static_cast<__nv_bfloat16*>(dst[lo + k]);
      c.n[k] = n[lo + k];
      c.first_block[k] = blocks;
      blocks += (n[lo + k] + kBlockValues - 1) / kBlockValues;
    }
    c.first_block[c.count] = blocks;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (blocks > 0) {
      leaf_to_bf16_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(c);
      ++*launches;
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace
}  // namespace leaf_to_bf16

extern "C" int ctt_leaf_to_bf16_f32(const void* const* src, void* const* dst, const long long* n,
                                    int count, int* launches, cudaStream_t stream) {
  return leaf_to_bf16::launch<float>(src, dst, n, count, launches, stream);
}

extern "C" int ctt_leaf_to_bf16_f64(const void* const* src, void* const* dst, const long long* n,
                                    int count, int* launches, cudaStream_t stream) {
  return leaf_to_bf16::launch<double>(src, dst, n, count, launches, stream);
}
