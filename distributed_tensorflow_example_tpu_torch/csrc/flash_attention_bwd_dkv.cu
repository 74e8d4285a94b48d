// Flash-attention backward, dk and dv (B2b), for Hopper (sm_90a): bf16 in,
// f32 recompute and accumulation, bf16 dk and dv out.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py
//           _bwd_dkv_kernel (launched by _bwd, variant "split").
//
// What it computes: for every (batch, head) and key j,
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i,
//   p_ij = exp(s_ij - L_i),  ds_ij = p_ij (dO_i . v_j - D_i) * scale,
//   s_ij = q_i . k_j * scale,
// over the queries i for which key j is live (mask[b, j] != 0, j < S and,
// when causal, i >= j); masked pairs have p = 0 exactly, so a masked key gets
// dk = dv = 0 exactly. L is the forward's row logsumexp and D = rowsum(dO * O).
//
// Layout: as B2a (csrc/flash_attention_bwd_dq.cu): q, k, v, dO, dk, dv
// [B, S, H, D] contiguous; lse and dsum [B, H, S] f32; mask [B, S] int32 or
// null. D is 64 or 128, S is any length.
//
// What bounds it on the H100: at the training shapes (B=8, S=512, H=12, D=64,
// causal) the work is ~6.4 GFLOP (four block products per live pair) over
// ~38 MB: ~170 FLOP/byte, below the bf16 ridge of ~295 FLOP/byte, so device
// memory bounds it (~11.4 us).
//
// Design: one CTA of 4 warps per (64-key tile, b*h); each warp owns 16 keys.
// The K and V tiles are staged once into mma.sync A-fragments held in
// registers. Q and dO tiles of 64 queries, with their L and D, stream through
// shared memory from the diagonal down (causal) or from the first tile. The
// CTA computes the products TRANSPOSED, keys as rows: S^T = K Q^T and
// dP^T = V dO^T, so p^T and ds^T come out in the accumulator layout that
// re-packs directly as A-fragments for dv += p^T dO and dk += ds^T Q, whose
// B operands are Q's and dO's rows read as B1 reads V. That avoids the
// transposed fragments (ldmatrix.trans, or staging p and ds in shared memory)
// the straight form would need. dk and dv accumulate in f32 registers over
// the whole query loop. Loads are synchronous (no cp.async, TMA or wgmma yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per shared-memory tile
constexpr int BK = 64;        // keys per CTA (4 warps x 16)
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
  for (int c = threadIdx.x; c < BQ * CHUNKS; c += NTHREADS) {
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
__device__ __forceinline__ void mma_abt(float (&acc)[BQ / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int g,
                                        int t4) {
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const __nv_bfloat16* r = tile + (n * 8 + g) * (D + PAD) + kk * 16 + t4 * 2;
      mma_bf16(acc[n], a[kk], *reinterpret_cast<const uint32_t*>(r),
               *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// acc[16 x D] += A . T, A[16 x 64] the bf16 re-pack of a [16 x 64] f32
// accumulator x, T a [64][D + PAD] tile (rows = the product's k index).
template <int D>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4],
                                       const float (&x)[BQ / 8][4],
                                       const __nv_bfloat16* tile, int g,
                                       int t4) {
  const uint16_t* tu = reinterpret_cast<const uint16_t*>(tile);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const uint16_t* p = tu + (kk * 16 + t4 * 2) * (D + PAD) + dn * 8 + g;
      const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[D + PAD] << 16);
      const uint32_t b1 =
          (uint32_t)p[8 * (D + PAD)] | ((uint32_t)p[9 * (D + PAD)] << 16);
      mma_bf16(acc[dn], a, b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum,
                     const int* __restrict__ mask,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int causal,
                     float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * (D + PAD)];
  __shared__ __align__(16) __nv_bfloat16 sO[BQ * (D + PAD)];  // dO tile
  __shared__ float sL[BQ], sD[BQ];

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row

  // K and V tiles -> shared (sQ, sO double as staging) -> A fragments.
  load_tile<D>(sQ, k + base, k0, S, row_stride);
  load_tile<D>(sO, v + base, k0, S, row_stride);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, sQ, wr, g, t4);
  load_a_frags<D>(vf, sO, wr, g, t4);
  __syncthreads();

  // this thread's two keys: [0] = tile row wr+g, [1] = wr+g+8
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};
  const int* mrow = mask ? mask + (size_t)b * S : nullptr;
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    live[i] = keys[i] < S && (mrow == nullptr || mrow[keys[i]] != 0);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  const int nq = (S + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // no query above the diagonal
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    load_tile<D>(sQ, q + base, q0, S, row_stride);
    load_tile<D>(sO, dout + base, q0, S, row_stride);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      sD[threadIdx.x] = row < S ? dsum[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    float st[BQ / 8][4], dpt[BQ / 8][4];
    mma_abt<D>(st, kf, sQ, g, t4);   // S^T = K Q^T
    mma_abt<D>(dpt, vf, sO, g, t4);  // dP^T = V dO^T

    // p^T in st, ds^T in dpt; exactly 0 on masked pairs
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n * 8 + t4 * 2 + (e & 1);
        const int query = q0 + col;
        const bool ok = live[i] && query < S && (!causal || keys[i] <= query);
        const float p = ok ? expf(st[n][e] * sm_scale - sL[col]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sD[col]) * sm_scale;
      }
    }

    mma_xt<D>(dva, st, sO, g, t4);   // dv += p^T dO
    mma_xt<D>(dka, dpt, sQ, g, t4);  // dk += ds^T Q
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= S) continue;
    __nv_bfloat16* dkr = dk + base + (size_t)keys[i] * row_stride;
    __nv_bfloat16* dvr = dv + base + (size_t)keys[i] * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(dka[dn][2 * i], dka[dn][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(dva[dn][2 * i], dva[dn][2 * i + 1]);
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dsum,
                                       const void* mask, void* dk, void* dv,
                                       int B, int S, int H, int D, int causal,
                                       float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BK - 1) / BK, B * H);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* sb = static_cast<const float*>(dsum);
  const auto* mb = static_cast<const int*>(mask);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  if (D == 64)
    flash_bwd_dkv_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qb, kb, vb, db, lb, sb, mb, dkb, dvb, S, H, causal, sm_scale);
  else if (D == 128)
    flash_bwd_dkv_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qb, kb, vb, db, lb, sb, mb, dkb, dvb, S, H, causal, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
