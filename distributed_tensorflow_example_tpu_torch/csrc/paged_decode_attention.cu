// Single-query decode attention through block tables over a shared paged
// KV pool, for Hopper (sm_90a).
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _paged_kernel with float pools (quant=False), launched by
//           _paged_dispatch through pl.pallas_call.
//
// What it computes: row b's logical cache slot j lives in physical block
// block_tables[b, j / Bs] at offset j % Bs of the [N, Bs, H, D] pools. For
// every (b, h), over the live window lo = pad[b] <= j <= pos[b] = hi,
//   s_j = q . k_j / sqrt(D)                    (f32)
//   p_j = bf16( exp(s_j - max s) / sum exp )   (probabilities cast to V's
//                                               dtype before PV, as the
//                                               reference's plain path does)
//   o   = sum_j p_j v_j                        (f32 accumulation, bf16 out)
// Slots outside the window are never read, so they contribute exactly 0
// whatever bytes their block holds: the engine's null block 0 may hold any
// bytes, NaN included. An empty window (pad > pos) gives o = 0, like the
// plain path. A block id outside [0, N) is not read either: the row's
// output is NaN, so a corrupt table shows instead of faulting the card.
//
// Layout: q and o are [B, H, D]; the pools are contiguous [N, Bs, H, D];
// block_tables is [B, NB] int32 (ids repeat across rows where prefix blocks
// are shared); pos and pad are [B] int32.
//
// Constraint: any block size Bs >= 1 (the walk is per slot, so the TPU
// kernel's Bs % 128 gate does not carry over and the serving default
// Bs = 16 runs here), NB * Bs <= 8192 logical slots per row (the live
// scores sit in shared memory), D in {64, 128}.
//
// What bounds it on the H100: one query row per (b, h) streams the live K
// and V rows once (2 FLOP per byte), far below the ~295 FLOP/byte bf16
// ridge: device memory bounds it. The design is B4's (decode_attention.cu)
// with one indirection per slot: one CTA of 4 warps per (h, b) reads only
// the live slots of each block it walks, from block lo / Bs to hi / Bs.
// Pass 1: warp w takes slots lo+w, lo+w+4, ...; its 32 lanes read one
// 128/256-byte K row together (coalesced), reduce the dot product with
// shuffles, keep a running f32 max and normaliser, and park the score in
// shared memory. The four warps' (max, sum) pairs are merged once. Pass 2
// forms each bf16-rounded probability and accumulates p * V rows in f32
// per lane; the four partial context rows are summed through shared
// memory. With only B*H CTAs and 4-byte loads per lane the card is
// under-occupied at small batch (split-K and wider loads are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SLOTS = 8192;  // NB * Bs: live scores kept in shared memory

template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_pool,
                         const __nv_bfloat16* __restrict__ v_pool,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ pos,
                         const int* __restrict__ pad,
                         __nv_bfloat16* __restrict__ o, int N, int Bs,
                         int NB, int H, float sm_scale) {
  extern __shared__ float sc[];  // [hi - lo + 1] live scores
  __shared__ float red_m[NWARPS], red_l[NWARPS];
  __shared__ float part[NWARPS][D];
  __shared__ int bad_block[NWARPS];
  constexpr int PER = D / 32;  // head-dim elements per lane

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = max(pad[b], 0);
  const int hi = min(pos[b], NB * Bs - 1);
  const int* bt = block_tables + (size_t)b * NB;
  const size_t row_stride = (size_t)H * D;  // one pool slot: [H, D]
  const size_t head = (size_t)h * D + lane * PER;

  float qv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    qv[i] = __bfloat162float(q[((size_t)b * H + h) * D + lane * PER + i]);

  // pass 1: scores + per-warp online (max, sum)
  float m = NEG_INF, l = 0.f;
  int bad = 0;
  for (int j = lo + warp; j <= hi; j += NWARPS) {
    const int pb = __ldg(bt + j / Bs);
    if (pb < 0 || pb >= N) {  // corrupt table: never read out of bounds
      bad = 1;
      if (lane == 0) sc[j - lo] = NEG_INF;
      continue;
    }
    const __nv_bfloat16* kr =
        k_pool + ((size_t)pb * Bs + j % Bs) * row_stride + head;
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
    bad_block[warp] = bad;
  }
  __syncthreads();
  float M = NEG_INF, L = 0.f;
  int any_bad = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red_m[w]);
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    L += red_l[w] * expf(red_m[w] - M);
    any_bad |= bad_block[w];
  }

  // pass 2: bf16-rounded probabilities times V rows, f32 accumulation
  float accv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) accv[i] = 0.f;
  // !(L <= 0) also admits a NaN sum: a NaN in a LIVE slot propagates to
  // the output, as in the plain version
  if (!(L <= 0.f) && !any_bad) {
    for (int j = lo + warp; j <= hi; j += NWARPS) {
      const int pb = __ldg(bt + j / Bs);
      const float p = __bfloat162float(
          __float2bfloat16_rn(expf(sc[j - lo] - M) / L));
      const __nv_bfloat16* vr =
          v_pool + ((size_t)pb * Bs + j % Bs) * row_stride + head;
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
    o[((size_t)b * H + h) * D + d] =
        __float2bfloat16_rn(any_bad ? __int_as_float(0x7fc00000) : s);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* pos, const void* pad,
                                      void* o, int B, int N, int Bs, int NB,
                                      int H, int D, float sm_scale,
                                      void* stream) {
  if (B <= 0 || N <= 0 || Bs <= 0 || NB <= 0 || H <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)NB * Bs > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NB * Bs * sizeof(float);
  const dim3 grid(H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* tb = static_cast<const int*>(block_tables);
  const auto* pb = static_cast<const int*>(pos);
  const auto* db = static_cast<const int*>(pad);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (D == 64)
    paged_decode_attn_kernel<64><<<grid, NTHREADS, smem, st>>>(
        qb, kb, vb, tb, pb, db, ob, N, Bs, NB, H, sm_scale);
  else if (D == 128)
    paged_decode_attn_kernel<128><<<grid, NTHREADS, smem, st>>>(
        qb, kb, vb, tb, pb, db, ob, N, Bs, NB, H, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
