// Kernel B5: the SCHUR_JACOBI camera blocks of the reduced camera system.
//
// Replaces ceres_tpu/linalg/pallas_schur.py _p0_kernel (via p0_seg_call and
// p0_apply). For every camera c, over the observations of c,
//     P_c = sum_l [ F_lᵀ F_l − (E_lᵀ F_l)ᵀ M_p(l)⁻¹ (E_lᵀ F_l) ]
// with F_l [r x tf] and E_l [r x te] the observation's blocks of the
// scale-materialized leaves and M_p⁻¹ the te x te block of its point p:
// the ridge (EᵀE)⁻¹ of schur_prepare, or the (EᵀE + D_e²)⁻¹ of
// schur_solve, here point-major, [cnt_e, te*te] (the wrapper transposes
// the solver's [te*te, cnt_e] table), so that a slot's block is one
// 36-byte record in one or two sectors rather than nine scattered values.
// The LM diagonal D_f² is the caller's. An observation whose point row is
// outside [0, cnt_e) adds F_lᵀ F_l only.
//
// Inputs are camera-ordered: the F and E twins [r*tf, n_pad], [r*te, n_pad]
// (the leaves copied into the slot order of the padded camera CSR, zero on
// padding; jacobian.py make_twin) and the point row of each slot (-1 on
// padding). tf, te and r are run-time values (tf <= kMaxTf, te <= kMaxTe,
// r <= kMaxR, r*tf <= kMaxRTf: the bounds sy_meta checks). The twins'
// rows are n_pad long, a multiple of 32 slots, and 16-byte aligned.
//
// One block of 256 threads per chunk of at most 2048 slots of one camera
// (program.py camera_layout), in tiles of kTile slots (256, or 128 or 64
// where the shapes need more shared memory) that pass through a ring of two
// stages in shared memory:
//   copy. While the current tile is computed, cp.async copies of the next
//      tile's F and E columns (16 bytes each: a warp copies whole 128-byte
//      lines; runs and chunks start and end on 32-slot boundaries, so a
//      16-byte group is all inside or all outside the chunk) and of each of
//      its slots' inverse blocks (gathered: a camera's points are
//      scattered) are in flight, and so are the point rows of the tile
//      after it, which the next gather needs. No load's latency is exposed
//      in the arithmetic, and none holds a register.
//   A. thread x takes slot x of the current tile: it forms Q = E M⁻¹ Eᵀ
//      (r x r) from the slot's E column and inverse block (zero where the
//      point row is outside the table) and stores H = F − Qᵀ F
//      beside F, so that row a of the slot's block is sum_k H[k, a] F[k, b]
//      (FᵀF and the correction in one product).
//   B. the tf(tf+1)/2 entries (a, b >= a) of P_c are dealt round-robin to
//      the warps; lane j of a warp adds slots j, j+32, ... of the tile from
//      shared memory into its registers.
// At the end a warp-shuffle tree sums each entry over the warp's lanes and
// the chunk's block goes to column m of partial [tf*tf, nchunks], mirrored;
// camera_chunks.cuh adds a camera's chunks in index order. Two runs are
// bitwise equal without atomics. The dump column is not computed: the grid
// stops before the last camera's chunks.
//
// Bound on an H100: device memory. Per slot the block reads r*(tf + te)
// values of the twins and a point row once, coalesced, and gathers one
// te*te inverse block (35.8 MB in all at BAL-1778, read ~5 times over);
// the ~3 GFLOP in all at BAL-1778 are ~20x below the FMA rate for those
// bytes, so tensor cores would not pay. The TPU kernel's
// (d, r*t, n_pad) segment copies, one-hot MXU reduce and 3-plane bf16 split
// serve only the TPU and have no counterpart here.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "camera_chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTf = 16;
constexpr int kMaxTe = 8;
constexpr int kMaxR = 4;
constexpr int kMaxRTf = 32;  // rows of the F and H tiles in shared memory
constexpr int kMaxEntries = kMaxTf * (kMaxTf + 1) / 2;
constexpr int kEntriesPerWarp = (kMaxEntries + kWarps - 1) / kWarps;

// Shared memory of one block, in T: F [2][r*tf][kTile], E [2][r*te][kTile],
// the inverse blocks [2][te*te][kTile], H [r*tf][kTile], then the point
// rows [2][kTile] as int.
template <typename T>
size_t smem_bytes(int k_tile, int r, int te, int tf) {
  return static_cast<size_t>(3 * r * tf + 2 * r * te + 2 * te * te) * k_tile * sizeof(T) +
         2 * k_tile * sizeof(int);
}

// cp.async the rows [rows][k0, k0 + kTile) of a [rows, n_pad] twin into
// dst [rows][kTile], 16 bytes at a time; slots at or past `end` become 0.
template <typename T, int kTile>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int rows,
                                          size_t NP, int k0, int end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = kTile / kVec;
  for (int v = threadIdx.x; v < rows * kVecs; v += kThreads) {
    const int row = v / kVecs;
    const int s = (v % kVecs) * kVec;
    T* d = dst + row * kTile + s;
    if (k0 + s < end) {
      __pipeline_memcpy_async(d, src + row * NP + k0 + s, 16);
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q) d[q] = T(0);
    }
  }
}

// cp.async the point rows of slots [k0, k0 + kTile) into sP [kTile]; -1
// past `end`.
template <int kTile>
__device__ __forceinline__ void copy_prow(int* sP, const int* __restrict__ prow, int k0,
                                          int end) {
  for (int s = threadIdx.x * 4; s < kTile; s += kThreads * 4) {
    if (k0 + s < end) {
      __pipeline_memcpy_async(sP + s, prow + k0 + s, 16);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) sP[s + q] = -1;
    }
  }
}

// cp.async the te*te inverse block of each slot's point (rows sP, landed)
// from the point-major table into sM [te*te][kTile]; zero where the point
// row is outside [0, cnt_e).
template <typename T, int kTile>
__device__ __forceinline__ void copy_minv(T* sM, const int* sP, const T* __restrict__ minv,
                                          int cnt_e, int te2) {
  const int tid = threadIdx.x;
  if (tid >= kTile) return;
  const int p = sP[tid];
  if (p >= 0 && p < cnt_e) {
    const T* rec = minv + static_cast<size_t>(p) * te2;
    for (int i = 0; i < te2; ++i) __pipeline_memcpy_async(sM + i * kTile + tid, rec + i, sizeof(T));
  } else {
    for (int i = 0; i < te2; ++i) sM[i * kTile + tid] = T(0);
  }
}

template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
    schur_p0_kernel(const T* __restrict__ F, const T* __restrict__ E,
                    const int* __restrict__ prow, const int* __restrict__ chunk_start,
                    const T* __restrict__ minv, int cnt_e, int n_pad, int r, int te, int tf,
                    int nchunks, T* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rtf = r * tf;
  const int rte = r * te;
  const int te2 = te * te;
  T* sF = reinterpret_cast<T*>(smem_raw);  // [2][rtf][kTile]
  T* sE = sF + 2 * rtf * kTile;            // [2][rte][kTile]
  T* sM = sE + 2 * rte * kTile;            // [2][te2][kTile]
  T* sH = sM + 2 * te2 * kTile;            // [rtf][kTile]
  int* sP = reinterpret_cast<int*>(sH + rtf * kTile);  // [2][kTile]
  __shared__ unsigned char ent_a[kMaxEntries];
  __shared__ unsigned char ent_b[kMaxEntries];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ne = tf * (tf + 1) / 2;
  for (int e = tid; e < ne; e += kThreads) {
    int a = 0;
    int rem = e;
    while (rem >= tf - a) {
      rem -= tf - a;
      ++a;
    }
    ent_a[e] = static_cast<unsigned char>(a);
    ent_b[e] = static_cast<unsigned char>(a + rem);
  }

  const int m = blockIdx.x;
  const int beg = chunk_start[m];
  const int end = chunk_start[m + 1];
  const int ntiles = (end - beg + kTile - 1) / kTile;
  const size_t NP = static_cast<size_t>(n_pad);
  T acc[kEntriesPerWarp];
#pragma unroll
  for (int q = 0; q < kEntriesPerWarp; ++q) acc[q] = T(0);

  // prologue: the point rows of tile 0, then tile 0 and the point rows of
  // tile 1 in flight
  copy_prow<kTile>(sP, prow, beg, end);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  copy_rows<T, kTile>(sF, F, rtf, NP, beg, end);
  copy_rows<T, kTile>(sE, E, rte, NP, beg, end);
  copy_minv<T, kTile>(sM, sP, minv, cnt_e, te2);
  __pipeline_commit();
  if (ntiles > 1) copy_prow<kTile>(sP + kTile, prow, beg + kTile, end);
  __pipeline_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int nx = st ^ 1;
    __pipeline_wait_prior(0);  // tile t and the point rows of tile t+1 have landed
    __syncthreads();
    if (t + 1 < ntiles) {
      const int k1 = beg + (t + 1) * kTile;
      copy_rows<T, kTile>(sF + nx * rtf * kTile, F, rtf, NP, k1, end);
      copy_rows<T, kTile>(sE + nx * rte * kTile, E, rte, NP, k1, end);
      copy_minv<T, kTile>(sM + nx * te2 * kTile, sP + nx * kTile, minv, cnt_e, te2);
    }
    if (t + 2 < ntiles) copy_prow<kTile>(sP + st * kTile, prow, beg + (t + 2) * kTile, end);
    __pipeline_commit();
    const T* tF = sF + st * rtf * kTile;
    const T* tE = sE + st * rte * kTile;
    const T* tM = sM + st * te2 * kTile;

    // A. Q = E M⁻¹ Eᵀ and H = F − Qᵀ F for slot tid of the tile
    if (tid < kTile) {
      T q[kMaxR][kMaxR];
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) q[i][j] = T(0);
      }
      const T* ec = tE + tid;  // E[i, e] = ec[(i * te + e) * kTile]
#pragma unroll
      for (int e2 = 0; e2 < kMaxTe; ++e2) {
        if (e2 >= te) continue;
        T w[kMaxR];
#pragma unroll
        for (int i = 0; i < kMaxR; ++i) w[i] = T(0);
#pragma unroll
        for (int e = 0; e < kMaxTe; ++e) {
          if (e >= te) continue;
          const T mv = tM[(e * te + e2) * kTile + tid];
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) {
            if (i < r) w[i] += ec[(i * te + e) * kTile] * mv;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) {
          if (j >= r) continue;
          const T ej = ec[(j * te + e2) * kTile];
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) q[i][j] += w[i] * ej;
        }
      }
      for (int a = 0; a < tf; ++a) {
        T fa[kMaxR];
#pragma unroll
        for (int i = 0; i < kMaxR; ++i) fa[i] = i < r ? tF[(i * tf + a) * kTile + tid] : T(0);
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) {
          if (j >= r) continue;
          T h = fa[j];
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) h -= q[i][j] * fa[i];
          sH[(j * tf + a) * kTile + tid] = h;
        }
      }
    }
    __syncthreads();

    // B. entry (a, b) += sum over the tile's slots of sum_i H[i, a] F[i, b]
#pragma unroll
    for (int qq = 0; qq < kEntriesPerWarp; ++qq) {
      const int e = warp + kWarps * qq;
      if (e < ne) {
        const int a = ent_a[e];
        const int b = ent_b[e];
        T s = acc[qq];
        for (int i = 0; i < r; ++i) {
          const T* h = sH + (i * tf + a) * kTile;
          const T* f = tF + (i * tf + b) * kTile;
#pragma unroll
          for (int sl = lane; sl < kTile; sl += 32) s += h[sl] * f[sl];
        }
        acc[qq] = s;
      }
    }
    __syncthreads();  // the stage and H are rewritten next
  }

  // fixed-order reduction over the warp's 32 lanes; mirror the lower half
#pragma unroll
  for (int qq = 0; qq < kEntriesPerWarp; ++qq) {
    const int e = warp + kWarps * qq;
    if (e >= ne) continue;
    T v = acc[qq];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) {
      const int a = ent_a[e];
      const int b = ent_b[e];
      partial[static_cast<size_t>(a * tf + b) * nchunks + m] = v;
      partial[static_cast<size_t>(b * tf + a) * nchunks + m] = v;
    }
  }
}

template <typename T, int kTile>
int launch_tile(const T* F, const T* E, const int* prow, const int* chunk_start, const T* minv,
                int cnt_e, int n_pad, int r, int te, int tf, int nchunks, T* partial,
                cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes<T>(kTile, r, te, tf));
  const cudaError_t rc = cudaFuncSetAttribute(
      schur_p0_kernel<T, kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  schur_p0_kernel<T, kTile><<<nchunks, kThreads, smem, stream>>>(
      F, E, prow, chunk_start, minv, cnt_e, n_pad, r, te, tf, nchunks, partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* F, const T* E, const int* prow, const int* chunk_start, const int* row_chunks,
           const T* minv, int cnt_e, int n_pad, int r, int te, int tf, int nchunks, int ncols_out,
           T* partial, T* out, cudaStream_t stream) {
  if (tf < 1 || tf > kMaxTf || te < 1 || te > kMaxTe || r < 1 || r > kMaxR ||
      r * tf > kMaxRTf || n_pad % 32 != 0 ||
      (reinterpret_cast<size_t>(F) | reinterpret_cast<size_t>(E) |
       reinterpret_cast<size_t>(prow)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the largest tile whose stages fit in a block's 227 KB of shared memory
  constexpr size_t kSmem = 232448;
  if (nchunks > 0) {
    int rc;
    if (sizeof(T) == 4 && smem_bytes<T>(256, r, te, tf) <= kSmem) {
      rc = launch_tile<T, 256>(F, E, prow, chunk_start, minv, cnt_e, n_pad, r, te, tf, nchunks,
                               partial, stream);
    } else if (smem_bytes<T>(128, r, te, tf) <= kSmem) {
      rc = launch_tile<T, 128>(F, E, prow, chunk_start, minv, cnt_e, n_pad, r, te, tf, nchunks,
                               partial, stream);
    } else {
      rc = launch_tile<T, 64>(F, E, prow, chunk_start, minv, cnt_e, n_pad, r, te, tf, nchunks,
                              partial, stream);
    }
    if (rc != 0) return rc;
  }
  camera_chunks::launch_chunk_sum<T>(partial, row_chunks, tf * tf, nchunks, ncols_out, ncols_out,
                                     nullptr, nullptr, out, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ctt_schur_p0_f32(const float* F, const float* E, const int* prow,
                                const int* chunk_start, const int* row_chunks, const float* minv,
                                int cnt_e, int n_pad, int r, int te, int tf, int nchunks,
                                int ncols_out, float* partial, float* out, void* stream) {
  return launch<float>(F, E, prow, chunk_start, row_chunks, minv, cnt_e, n_pad, r, te, tf,
                       nchunks, ncols_out, partial, out, static_cast<cudaStream_t>(stream));
}

extern "C" int ctt_schur_p0_f64(const double* F, const double* E, const int* prow,
                                const int* chunk_start, const int* row_chunks, const double* minv,
                                int cnt_e, int n_pad, int r, int te, int tf, int nchunks,
                                int ncols_out, double* partial, double* out, void* stream) {
  return launch<double>(F, E, prow, chunk_start, row_chunks, minv, cnt_e, n_pad, r, te, tf,
                        nchunks, ncols_out, partial, out, static_cast<cudaStream_t>(stream));
}
