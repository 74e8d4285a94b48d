// Building blocks of the flash-attention kernels for Hopper (sm_90a), shared
// by the forward (B1, flash_attention_fwd.cu) and the split backward, B2a
// (dq, flash_attention_bwd_dq.cu) and B2b (dk and dv,
// flash_attention_bwd_dkv.cu): the bf16 mma.sync m16n8k16 product and its
// operands read through ldmatrix, the cp.async copies of the two-stage tile
// ring, the ring's shared-memory size and the 1-D launch. Each .cu file says
// which TPU kernel it replaces, its arithmetic and what bounds it.
//
// The fused backward (B3, flash_attention_bwd_fused.cu) carries its own
// copies of the same helpers. Its dq, dk and dv equal the split pair's bit
// for bit because both issue the same mma.sync products on the same bf16
// operands in the same accumulation order; ldmatrix and cp.async move those
// operands, they do not change them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int TILE = 64;       // rows of a CTA's tile and of a streamed tile
constexpr int NTHREADS = 128;  // 4 warps x 16 of the CTA's rows
constexpr int PAD = 8;         // bf16 elements of row padding (16 bytes)
static_assert(NTHREADS == 2 * TILE, "one thread per 4-byte row value");

// Dynamic shared memory of the ring: two stages, each two [64][D + PAD]
// bf16 tiles and two 64-entry rows of 4-byte values.
template <int D>
constexpr size_t ring_bytes() {
  return (size_t)4 * TILE * (D + PAD) * 2 + 4 * TILE * 4;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices; lane i names row i % 8 of matrix i / 8. Lane
// (g, t4) = (lane / 4, lane % 4) receives row g, columns 2 t4 and 2 t4 + 1 of
// each matrix (.trans: column g, rows 2 t4 and 2 t4 + 1), the first in the
// low half: the pairs that mma.sync's B fragments hold.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [row0, row0 + 64) of one head (row r at src + r *
// row_stride) into dst [64][D + PAD]; rows at or past S are zero-filled
// with plain stores (the barrier that publishes the copy publishes them).
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int S,
                                                int row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < TILE * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    __nv_bfloat16* d = dst + r * (D + PAD) + cc * 8;
    if (row0 + r < S)
      cp_async16(d, src + (size_t)(row0 + r) * row_stride + cc * 8);
    else
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
  }
}

// A-fragments of this warp's 16 rows of a [64][D + PAD] tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* tile,
                                             int wr, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = tile + (wr + g) * (D + PAD) + kk * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * (D + PAD);
    f[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
}

// acc[16 x N] = A[16 x D] . T^T, T the first N rows of a [64][D + PAD] tile
// (rows = columns of the product); each acc[n] sums over kk in ascending
// order. One ldmatrix gives the B fragments (b0, b1) of columns n and n + 1.
template <int D, int N = TILE>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile + ((n + (mi >> 1)) * 8 + ri) * (D + PAD) + kk * 16 +
                     (mi & 1) * 8);
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[16 x D] += A . T, A[16 x N] the bf16 re-pack of a [16 x N] f32
// accumulator x, T the first N rows of a [64][D + PAD] tile, rows = the
// product's k index; kk ascending. One ldmatrix.trans gives the B fragments
// (b0, b1) of columns dn and dn + 1.
template <int D, int N = TILE>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4],
                                       const float (&x)[N / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (kk * 16 + (mi & 1) * 8 + ri) * (D + PAD) +
                       (dn + (mi >> 1)) * 8);
      mma_bf16(acc[dn], a, b[0], b[1]);
      mma_bf16(acc[dn + 1], a, b[2], b[3]);
    }
  }
}

// Launch `kernel` on a 1-D grid of `ctas` CTAs (at most 2^31 - 1, the
// grid's x limit) with the ring's dynamic shared memory (above 48 KB only
// once the function allows it).
template <int D, typename Kernel, typename... Args>
int launch(Kernel kernel, long long ctas, cudaStream_t st, Args... args) {
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = ring_bytes<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)ctas, NTHREADS, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
