// Flash-attention backward, dq (B2a), for Hopper (sm_90a): bf16 in, f32
// recompute and accumulation, bf16 dq out.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py
//           _bwd_dq_kernel (launched by _bwd, variant "split").
//
// What it computes: for every (batch, head) and query row i,
//   dq_i = sum_j ds_ij k_j,  ds_ij = p_ij (dp_ij - D_i) * scale,
//   p_ij = exp(s_ij - L_i),  s_ij = q_i . k_j * scale,  dp_ij = dO_i . v_j,
// over the keys j that are valid (mask[b, j] != 0, j < S) and, when causal,
// j <= i; masked pairs have p = 0 exactly (the reference's (s > NEG_INF/2)
// factor), so a row with no valid key gets dq = 0 exactly. L is the forward's
// row logsumexp (B1 writes it) and D = rowsum(dO * O), both f32.
//
// Layout: q, k, v, dO, dq are [B, S, H, D] contiguous (the framework's BSHD),
// read through their strides; lse and dsum are [B, H, S] f32; mask is [B, S]
// int32 (or null = all valid). D is 64 or 128, S is any length.
//
// What bounds it on the H100: at the training shapes (B=8, S=512, H=12, D=64,
// causal) the work is ~4.8 GFLOP (three block products per live pair) over
// ~32 MB: ~150 FLOP/byte, below the bf16 ridge of ~295 FLOP/byte, so device
// memory bounds it (~9.5 us).
//
// Design: B1's structure. One CTA of 4 warps per (64-row q tile, b*h); each
// warp owns 16 query rows. The Q and dO tiles are staged once through shared
// memory into mma.sync A-fragments held in registers, with the rows' L and D.
// K and V tiles of 64 keys stream through shared memory up to the causal
// diagonal; S = Q K^T and dP = dO V^T run on bf16 mma.sync m16n8k16 with f32
// accumulation, p and ds are formed in f32 registers, and ds is re-packed as
// bf16 A-fragments for dq += ds K, accumulated in f32 registers for the whole
// key loop. No shared-memory transpose is needed: K's rows are the product's
// k dimension, read as B1 reads V. Loads are synchronous (no cp.async, TMA or
// wgmma yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA (4 warps x 16)
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)

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

// Copy rows [row0, row0 + 64) of one head (row r at src + r * row_stride)
// into dst [64][D + PAD]; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int S, int row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BK * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < S)
      val = *reinterpret_cast<const int4*>(
          src + (size_t)(row0 + r) * row_stride + cc * 8);
    *reinterpret_cast<int4*>(dst + r * (D + PAD) + cc * 8) = val;
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

// acc[16 x 64] = A[16 x D] . T^T, T a [64][D + PAD] tile (rows = columns of
// the product).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[BK / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int g,
                                        int t4) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const __nv_bfloat16* r = tile + (n * 8 + g) * (D + PAD) + kk * 16 + t4 * 2;
      mma_bf16(acc[n], a[kk], *reinterpret_cast<const uint32_t*>(r),
               *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const int* __restrict__ mask,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int causal,
                    float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[BK * (D + PAD)];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * (D + PAD)];
  __shared__ int sValid[BK];

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row

  // Q and dO tiles -> shared (sK, sV double as staging) -> A fragments.
  load_tile<D>(sK, q + base, q0, S, row_stride);
  load_tile<D>(sV, dout + base, q0, S, row_stride);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D>(qf, sK, wr, g, t4);
  load_a_frags<D>(dof, sV, wr, g, t4);
  __syncthreads();

  // this thread's two query rows: [0] = tile row wr+g, [1] = wr+g+8
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float L[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < S;
    L[i] = in ? lse[(size_t)bh * S + rows[i]] : 0.f;
    Dr[i] = in ? dsum[(size_t)bh * S + rows[i]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  const int* mrow = mask ? mask + (size_t)b * S : nullptr;
  const uint16_t* sKu = reinterpret_cast<const uint16_t*>(sK);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    load_tile<D>(sK, k + base, k0, S, row_stride);
    load_tile<D>(sV, v + base, k0, S, row_stride);
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      sValid[threadIdx.x] = key < S && (mrow == nullptr || mrow[key] != 0);
    }
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    mma_abt<D>(s, qf, sK, g, t4);    // S = Q K^T
    mma_abt<D>(dp, dof, sV, g, t4);  // dP = dO V^T

    // p = exp(s * scale - L) on live pairs, exactly 0 elsewhere;
    // ds = p (dp - D) scale, kept in s
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n * 8 + t4 * 2 + (e & 1);
        const bool ok = sValid[col] && (!causal || k0 + col <= rows[i]);
        const float p = ok ? expf(s[n][e] * sm_scale - L[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - Dr[i]) * sm_scale;
      }
    }

    // dq += ds K: ds re-packs as bf16 A fragments; K rows are the k index
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* kp = sKu + (kk * 16 + t4 * 2) * (D + PAD) + dn * 8 + g;
        const uint32_t b0 = (uint32_t)kp[0] | ((uint32_t)kp[D + PAD] << 16);
        const uint32_t b1 =
            (uint32_t)kp[8 * (D + PAD)] | ((uint32_t)kp[9 * (D + PAD)] << 16);
        mma_bf16(acc[dn], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    __nv_bfloat16* out = dq + base + (size_t)rows[i] * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(out + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[dn][2 * i], acc[dn][2 * i + 1]);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      const void* mask, void* dq, int B, int S,
                                      int H, int D, int causal, float sm_scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* sb = static_cast<const float*>(dsum);
  const auto* mb = static_cast<const int*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(dq);
  if (D == 64)
    flash_bwd_dq_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qb, kb, vb, db, lb, sb, mb, ob, S, H, causal, sm_scale);
  else if (D == 128)
    flash_bwd_dq_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qb, kb, vb, db, lb, sb, mb, ob, S, H, causal, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
