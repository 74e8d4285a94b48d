// Single-query decode attention over the KV-cache slab for Hopper (sm_90a).
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _kernel (launched by _dispatch through pl.pallas_call).
//
// What it computes: for every (b, h), with the live window
// lo = pad[b] <= j <= pos[b] = hi of the [B, T, H, D] slab,
//   s_j = q . k_j / sqrt(D)                    (f32)
//   p_j = bf16( exp(s_j - max s) / sum exp )   (probabilities cast to V's
//                                               dtype before PV, as the
//                                               reference does)
//   o   = sum_j p_j v_j                        (f32 accumulation, bf16 out)
// An empty window (pad > pos) gives o = 0, like the reference's plain path.
//
// Layout: q and o are [B, H, D]; k and v are the [B, T, H, D] cache slabs,
// read in place through their strides (no transpose, no repacking); pos and
// pad are [B] int32 (a scalar pos is broadcast by the wrapper).
//
// What bounds it on the H100: one query row per (b, h) makes it a pure
// streaming read of the live K/V rows (2 FLOP per byte), far below the
// ~295 FLOP/byte bf16 ridge: device memory bounds it. At B=8, T=640, H=12,
// D=64 the slab pair is 15.7 MB (~4.7 us at 3.35 TB/s).
//
// Design: one CTA of 4 warps per (h, b). Only the live rows [lo, hi] are
// read. Pass 1: warp w takes keys lo+w, lo+w+4, ...; its 32 lanes read one
// 128/256-byte K row together (coalesced), reduce the dot product with
// shuffles, keep a running f32 max and normaliser (online softmax), and
// park the score in shared memory. The four warps' (max, sum) pairs are
// merged once. Pass 2 re-reads each warp's own scores, forms the normalised
// probability, rounds it to bf16, and accumulates p * V rows in f32 per
// lane; the four partial context rows are summed through shared memory.
// Scores for up to T = 8192 slots (32 KB) fit the default 48 KB of shared
// memory beside the partial-sum rows.
// Each CTA reads (hi - lo + 1) * D * 2 bytes of K and of V once; with only
// B*H CTAs the card is under-occupied at small batch (split-K flash-decoding
// is the later fix).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_T = 8192;  // live scores kept in shared memory

template <int D>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ pos, const int* __restrict__ pad,
                   __nv_bfloat16* __restrict__ o, int T, int H,
                   float sm_scale) {
  extern __shared__ float sc[];  // [hi - lo + 1] live scores
  __shared__ float red_m[NWARPS], red_l[NWARPS];
  __shared__ float part[NWARPS][D];
  constexpr int PER = D / 32;  // head-dim elements per lane

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = max(pad[b], 0);
  const int hi = min(pos[b], T - 1);
  const size_t row_stride = (size_t)H * D;
  const size_t slab = (size_t)b * T * row_stride + (size_t)h * D;

  float qv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    qv[i] = __bfloat162float(q[((size_t)b * H + h) * D + lane * PER + i]);

  // pass 1: scores + per-warp online (max, sum)
  float m = NEG_INF, l = 0.f;
  for (int j = lo + warp; j <= hi; j += NWARPS) {
    const __nv_bfloat16* kr = k + slab + (size_t)j * row_stride + lane * PER;
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) d += qv[i] * __bfloat162float(kr[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    const float s = d * sm_scale;
    if (lane == 0) sc[j - lo] = s;
    const float mn = fmaxf(m, s);
    l = l * expf(m - mn) + expf(s - mn);
    m = mn;
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  float M = NEG_INF, L = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red_m[w]);
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) L += red_l[w] * expf(red_m[w] - M);

  // pass 2: bf16-rounded probabilities times V rows, f32 accumulation
  float accv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) accv[i] = 0.f;
  if (L > 0.f) {
    for (int j = lo + warp; j <= hi; j += NWARPS) {
      const float p = __bfloat162float(
          __float2bfloat16_rn(expf(sc[j - lo] - M) / L));
      const __nv_bfloat16* vr = v + slab + (size_t)j * row_stride + lane * PER;
#pragma unroll
      for (int i = 0; i < PER; ++i) accv[i] += p * __bfloat162float(vr[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) part[warp][lane * PER + i] = accv[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += part[w][d];
    o[((size_t)b * H + h) * D + d] = __float2bfloat16_rn(s);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* pad, void* o,
                                int B, int T, int H, int D, float sm_scale,
                                void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (T > MAX_T) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * sizeof(float);
  const dim3 grid(H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* pb = static_cast<const int*>(pos);
  const auto* db = static_cast<const int*>(pad);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (D == 64)
    decode_attn_kernel<64><<<grid, NTHREADS, smem, st>>>(qb, kb, vb, pb, db,
                                                         ob, T, H, sm_scale);
  else if (D == 128)
    decode_attn_kernel<128><<<grid, NTHREADS, smem, st>>>(qb, kb, vb, pb, db,
                                                          ob, T, H, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
