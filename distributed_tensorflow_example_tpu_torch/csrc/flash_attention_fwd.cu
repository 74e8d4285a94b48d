// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax, bf16 out.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py
//           _fwd_kernel (launched by _fwd through pl.pallas_call).
//
// What it computes: for every (batch, head) and query row i,
//   o_i = sum_j p_ij v_j,  p_ij = exp(s_ij - m_i) / l_i,  s_ij = q_i . k_j / sqrt(D)
// over the keys j that are valid (mask[b, j] != 0, j < S) and, when causal,
// j <= i; plus the row logsumexp lse_i = m_i + log(l_i) kept for the backward.
// Rows with no valid key give o = 0 (the reference's (s > NEG_INF/2) factor
// and max(l, 1e-20) guard); ragged prefill makes such rows for left pads.
//
// Layout: q, k, v, o are [B, S, H, D] contiguous (the framework's BSHD), read
// through their strides with no fold or transpose; mask is [B, S] int32 (or
// null = all valid); lse is [B, H, S] f32.
//
// What bounds it on the H100: at the prefill shapes (B=8, S=512, H=12, D=64,
// causal) the work is ~3.2 GFLOP over ~25 MB, i.e. ~128 FLOP/byte, below
// the bf16 ridge of ~295 FLOP/byte: device memory bounds it (~7.5 us).
//
// Design: one CTA of 4 warps per (64-row q tile, batch*head); each warp owns
// 16 query rows. The Q tile is staged once through shared memory into
// mma.sync A-fragments held in registers for the whole key loop. K and V
// tiles of 64 keys stream through shared memory (16-byte vector loads,
// rows padded by 16 bytes against bank conflicts); S = Q K^T and O += P V
// run on bf16 mma.sync m16n8k16 with f32 accumulation; the online softmax
// (running max m, normaliser l, rescale of O) stays in f32 registers and
// the score tile never leaves registers. Under causal masking the key loop
// stops at the diagonal. Any S is taken: the ragged last tile is zero-filled
// and masked. No TMA, wgmma or multi-stage pipelining yet: the tile loads
// are synchronous, which leaves memory latency exposed (work for later).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA (4 warps x 16)
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)
constexpr float NEG_INF = -1e30f;

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

// Copy rows [row0, row0 + BK) of one head (row r at src + r * row_stride)
// into dst [BK][D + PAD]; rows at or past S are zero-filled.
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int causal,
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

  // Q tile -> shared (sK doubles as staging) -> A fragments in registers.
  load_tile<D>(sK, q + base, q0, S, row_stride);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = sK + (wr + g) * (D + PAD) + kk * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * (D + PAD);
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
  __syncthreads();

  // this thread's two query rows: [0] = tile row wr+g, [1] = wr+g+8
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  const int* mrow = mask ? mask + (size_t)b * S : nullptr;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    load_tile<D>(sK, k + base, k0, S, row_stride);
    load_tile<D>(sV, v + base, k0, S, row_stride);
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      sValid[threadIdx.x] = key < S && (mrow == nullptr || mrow[key] != 0);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = sK + (n * 8 + g) * (D + PAD) + kk * 16 + t4 * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale + mask, row max
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const int key = k0 + col;
        const bool ok = sValid[col] && (!causal || key <= rows[e >> 1]);
        const float x = ok ? s[n][e] * sm_scale : NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float mnew[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mnew[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - mnew[i]);
    }
    // masked scores contribute an explicit 0 (not exp underflow): a fully
    // masked tile has mnew == NEG_INF and exp(0) would count it
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x > NEG_INF * 0.5f ? expf(x - mnew[e >> 1]) : 0.f;
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
      m[i] = mnew[i];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: the score accumulators re-pack as bf16 A fragments
    const uint16_t* sVu = reinterpret_cast<const uint16_t*>(sV);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vp = sVu + (kk * 16 + t4 * 2) * (D + PAD) + dn * 8 + g;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[D + PAD] << 16);
        const uint32_t b1 =
            (uint32_t)vp[8 * (D + PAD)] | ((uint32_t)vp[9 * (D + PAD)] << 16);
        mma_bf16(acc[dn], a, b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: O / max(l, 1e-20), lse = m + log(max(l, 1e-20))
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    __nv_bfloat16* orow = o + base + (size_t)rows[i] * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[dn][2 * i] * inv[i],
                                acc[dn][2 * i + 1] * inv[i]);
    }
    if (t4 == 0) lse[(size_t)bh * S + rows[i]] = m[i] + logf(fmaxf(l[i], 1e-20f));
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* lse, int B,
                                   int S, int H, int D, int causal,
                                   float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* mb = static_cast<const int*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  if (D == 64)
    flash_fwd_kernel<64><<<grid, NTHREADS, 0, st>>>(qb, kb, vb, mb, ob, lb, S,
                                                    H, causal, sm_scale);
  else if (D == 128)
    flash_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(qb, kb, vb, mb, ob, lb, S,
                                                     H, causal, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
