// Single-query decode attention through block tables over a shared paged
// int8 KV pool with per-slot f32 scales, for Hopper (sm_90a).
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _paged_kernel with int8 pools (quant=True), launched by
//           _paged_dispatch through pl.pallas_call.
//
// What it computes: row b's logical cache slot j lives in physical block
// pb = block_tables[b, j / Bs] at offset j % Bs of the int8 [N, Bs, H, D]
// pools, with one f32 scale per slot in the [N, Bs] scale pools (the
// token's whole [H, D] row shares it). For every (b, h), over the live
// window lo = pad[b] <= j <= pos[b] = hi,
//   s_j = (q . k_j) / sqrt(D) * k_scale[pb, j % Bs]         (f32)
//   o   = sum_j exp(s_j - max s) * v_scale[pb, j % Bs] * v_j
//         / sum_j exp(s_j - max s)                          (f32, bf16 out)
// This is the arithmetic of the Pallas kernel: the K scale multiplies the
// score of its column and the V scale folds into the probability, so no
// dequantised row is ever built, and p and V stay in f32. (The plain
// version beside the wrapper follows the reference's XLA path instead:
// dequantise to q's dtype, then the slab path, which rounds p to bf16
// before PV. The two differ by bf16 rounding.) The output is in q's dtype.
// Slots outside the window are never read, neither their int8 bytes nor
// their scales: the engine's null block 0 may hold any bytes and NaN
// scales without changing a bit of the output. An empty window (pad >
// pos) gives o = 0. A block id outside [0, N) is not read: the row's
// output is NaN, so a corrupt table shows instead of faulting the card.
//
// Layout: q and o are [B, H, D] bf16; the pools are contiguous int8
// [N, Bs, H, D]; the scales contiguous f32 [N, Bs]; block_tables is
// [B, NB] int32 (ids repeat across rows where prefix blocks are shared);
// pos and pad are [B] int32.
//
// Constraint: any block size Bs >= 1, NB * Bs <= 8192 logical slots per
// row (the live scores sit in shared memory), D in {64, 128}.
//
// What bounds it on the H100: one query row per (b, h) streams the live
// int8 K and V rows once (4 FLOP per byte), far below the ~295 FLOP/byte
// ridge: device memory bounds it, at half the bytes of the bf16 kernel
// (paged_decode_attention.cu) plus 8 bytes of scales per live slot. The
// design is that kernel's, with int8 rows: one CTA of 4 warps per (h, b)
// walks only the live slots through the table. Pass 1: warp w takes slots
// lo+w, lo+w+4, ...; its 32 lanes read one 64- or 128-byte K row slice
// together, each lane 2 or 4 bytes in one char2 / char4 load converted to
// f32 in registers, reduce the dot product with shuffles, multiply in the
// slot's K scale, keep a running f32 max and normaliser, and park the
// score in shared memory. Pass 2 weights each int8 V row by exp(s - max)
// times its V scale and accumulates in f32 per lane; the four partial
// rows are summed through shared memory and divided by the normaliser.
// Like the bf16 kernel it is a latency chain (a dependent table load
// before each row load, small loads per lane); split-K and staging the
// table row in shared memory are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SLOTS = 8192;  // NB * Bs: live scores kept in shared memory

// One lane's PER int8 values of a K/V row, as f32: one 2-byte (D = 64) or
// 4-byte (D = 128) load. The wrapper checks the pools' alignment.
template <int PER>
__device__ __forceinline__ void load_i8(const int8_t* p, float* out);

template <>
__device__ __forceinline__ void load_i8<2>(const int8_t* p, float* out) {
  const char2 c = __ldg(reinterpret_cast<const char2*>(p));
  out[0] = static_cast<float>(c.x);
  out[1] = static_cast<float>(c.y);
}

template <>
__device__ __forceinline__ void load_i8<4>(const int8_t* p, float* out) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  out[0] = static_cast<float>(c.x);
  out[1] = static_cast<float>(c.y);
  out[2] = static_cast<float>(c.z);
  out[3] = static_cast<float>(c.w);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_attn_int8_kernel(const __nv_bfloat16* __restrict__ q,
                              const int8_t* __restrict__ k_pool,
                              const int8_t* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
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

  // pass 1: scores (K scale folded into each column) + per-warp online
  // (max, sum)
  float m = NEG_INF, l = 0.f;
  int bad = 0;
  for (int j = lo + warp; j <= hi; j += NWARPS) {
    const int pb = __ldg(bt + j / Bs);
    if (pb < 0 || pb >= N) {  // corrupt table: never read out of bounds
      bad = 1;
      if (lane == 0) sc[j - lo] = NEG_INF;
      continue;
    }
    const size_t slot = (size_t)pb * Bs + j % Bs;
    float kv[PER];
    load_i8<PER>(k_pool + slot * row_stride + head, kv);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) d += qv[i] * kv[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    const float s = d * sm_scale * __ldg(k_scale + slot);
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

  // pass 2: unnormalised probabilities times the V scale, times the int8
  // V rows, f32 accumulation
  float accv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) accv[i] = 0.f;
  // !(L <= 0) also admits a NaN sum: a NaN in a LIVE slot propagates to
  // the output, as in the plain version
  if (!(L <= 0.f) && !any_bad) {
    for (int j = lo + warp; j <= hi; j += NWARPS) {
      const int pb = __ldg(bt + j / Bs);
      const size_t slot = (size_t)pb * Bs + j % Bs;
      const float w = expf(sc[j - lo] - M) * __ldg(v_scale + slot);
      float vv[PER];
      load_i8<PER>(v_pool + slot * row_stride + head, vv);
#pragma unroll
      for (int i = 0; i < PER; ++i) accv[i] += w * vv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) part[warp][lane * PER + i] = accv[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += part[w][d];
    // an empty window gives 0; a NaN normaliser stays NaN
    const float out = (L <= 0.f) ? 0.f : s / L;
    o[((size_t)b * H + h) * D + d] =
        __float2bfloat16_rn(any_bad ? __int_as_float(0x7fc00000) : out);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, const void* pad, void* o, int B, int N, int Bs, int NB,
    int H, int D, float sm_scale, void* stream) {
  if (B <= 0 || N <= 0 || Bs <= 0 || NB <= 0 || H <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)NB * Bs > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NB * Bs * sizeof(float);
  const dim3 grid(H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const int8_t*>(k_pool);
  const auto* vb = static_cast<const int8_t*>(v_pool);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* tb = static_cast<const int*>(block_tables);
  const auto* pb = static_cast<const int*>(pos);
  const auto* db = static_cast<const int*>(pad);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  if (D == 64)
    paged_decode_attn_int8_kernel<64><<<grid, NTHREADS, smem, st>>>(
        qb, kb, vb, ks, vs, tb, pb, db, ob, N, Bs, NB, H, sm_scale);
  else if (D == 128)
    paged_decode_attn_int8_kernel<128><<<grid, NTHREADS, smem, st>>>(
        qb, kb, vb, ks, vs, tb, pb, db, ob, N, Bs, NB, H, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
