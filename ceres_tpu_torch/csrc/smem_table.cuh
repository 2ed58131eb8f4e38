// A float table staged in a block's shared memory: the camera tables that
// kernels B2 (gather_contract_shared_kernel, gather_reduce.cu) and B4's
// point pass (sy_point_shared_kernel, schur_sy.cuh) gather from at random
// columns. One bulk asynchronous copy (cp.async.bulk, completing on an
// mbarrier) brings the table's 16-byte-aligned body; the head before its
// first 16-byte boundary and the tail after its last one go by plain
// loads (a table may be a view, and 9 x 1,779 floats are not a multiple
// of 16 bytes). The caller's dynamic shared memory holds the table plus 16
// bytes of slack (table_smem): the body lands 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace smem_table {
namespace {

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

// The table [count] floats at `table` staged in `smem` (dynamic shared
// memory of table_smem(count) bytes): returns where its element 0 lies,
// and sets *pending when the body's copy is in flight (wait_body on bar).
__device__ __forceinline__ float* begin_stage(const float* table, int count, unsigned char* smem,
                                              unsigned long long* bar, bool* pending) {
  const int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(table) & 15)) & 15) / 4);
  const int h = head < count ? head : count;
  float* tbl = reinterpret_cast<float*>(smem + ((16 - h * 4) & 15));
  *pending = stage_table(table, count, h, tbl, bar) > 0;
  return tbl;
}

// dynamic shared memory for a staged table of `count` floats
inline size_t table_smem(long long count) { return static_cast<size_t>(count) * 4 + 16; }

// Whether a table of `count` floats may be staged: at most
// gather_reduce.SHARED_TABLE_MAX_BYTES, an H100 block's 227 KB (232,448
// bytes) less a kilobyte for the alignment slack and the kernel's barrier.
constexpr long long kMaxTableBytes = 232448 - 1024;
inline bool table_fits(long long count) { return count * 4 <= kMaxTableBytes; }

}  // namespace
}  // namespace smem_table
