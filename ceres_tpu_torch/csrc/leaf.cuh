// The leaf types of kernels B2, B3 and B4: how a Jacobian leaf is loaded
// and what precision the vectors it meets are rounded to.
//
// Leaf<T> for float and double: leaves, vectors and sums all in T, and
// nothing rounded. Leaf<__nv_bfloat16> serves the mixed-precision solves
// (ceres_tpu/linalg/pallas_schur.py _sy_kernel with bf16=True,
// pallas_onehot.py _gather_contract_kernel and _contract_reduce_kernel on
// bf16 leaves): the leaves are bfloat16 and are widened exactly to float;
// vectors, accumulators and outputs are float. A vector operand is rounded
// to bfloat16 (round) where the TPU kernel casts it to the leaf type, and
// its product with a leaf is then formed in float, where it is exact (two
// 8-bit significands). The TPU kernels round those products, and some
// sums, to bfloat16: a deliberate deviation toward precision.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace leaf {
namespace {

template <typename T>
struct Leaf {
  using V = T;  // vectors, accumulators, outputs
  __device__ __forceinline__ static V ld(const T* p) { return *p; }
  // evict-first (ld.global.cs): a streamed leaf does not push the
  // kernel's reused vectors out of L2
  __device__ __forceinline__ static V ldcs(const T* p) { return __ldcs(p); }
  __device__ __forceinline__ static V round(V x) { return x; }
};

template <>
struct Leaf<__nv_bfloat16> {
  using V = float;
  __device__ __forceinline__ static V ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ __forceinline__ static V ldcs(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
  __device__ __forceinline__ static V round(V x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// K = 8 or 4 consecutive bfloat16 values of a row as K/2 32-bit words, by
// one evict-first load of 2K bytes (16 or 8; the address aligned to it)
template <int K>
__device__ __forceinline__ void ldcs_bf16_words(const __nv_bfloat16* p, unsigned (&w)[K / 2]) {
  static_assert(K == 8 || K == 4, "8 or 4 bfloat16 values a load");
  if constexpr (K == 8) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

// element e of such words, widened exactly to float (a bfloat16 value is
// the high half of a float's bits; element e is the low half of word e/2
// when e is even, its high half when e is odd)
__device__ __forceinline__ float bf16_word_value(const unsigned* w, int e) {
  const unsigned x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// The inverse: two floats rounded to bfloat16 (round-to-nearest-even, as
// Tensor.to(torch.bfloat16) rounds on the card) as one 32-bit word, `lo` the
// element of the lower address
__device__ __forceinline__ unsigned bf16_word(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

}  // namespace
}  // namespace leaf
