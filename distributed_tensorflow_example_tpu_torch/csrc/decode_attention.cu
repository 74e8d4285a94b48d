// Single-query decode attention over the KV-cache slab for Hopper (sm_90a):
// split-K, with the reference's rounding of the normalised probabilities.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _kernel (launched by _dispatch through pl.pallas_call).
//
// What it computes: for every (b, h), with the live window
// lo = pad[b] <= j <= pos[b] = hi of the [B, T, H, D] slab,
//   s_j = q . k_j / sqrt(D)                        (f32)
//   p_j = bf16( exp(s_j - M) / L ),  M = max_j s_j, L = sum_j exp(s_j - M)
//   o   = bf16( sum_j p_j v_j )                    (f32 accumulation)
// the Pallas slab kernel's function: the NORMALISED softmax is rounded to
// V's dtype before the PV product, so every p_j needs the row's global
// (M, L) before it is formed. An empty window (pad > pos) gives o = 0.
//
// Layout: q and o are [B, H, D]; k and v are the contiguous [B, T, H, D]
// cache slabs, 16-byte aligned, read in place (no transpose, no repacking);
// pos and pad are [B] int32 (a scalar pos is broadcast by the wrapper). The
// wrapper allocates one f32 scratch buffer: the scores [B * H, T], each
// split's (m, l) [B * H, S, 2] and each split's PV partial [B * H, S, D].
// Any T that int32 indexes; D in {64, 128}.
//
// What bounds it on the H100: one query row per (b, h) streams the live K
// and V rows once, 2 * 2 * D bytes per live slot and head for 4 * D FLOP:
// 2 FLOP per byte, far below the ~295 FLOP/byte bf16 ridge, so device
// memory bounds it. At B=8, T=640, H=12, D=64 the live rows are ~13 MB
// (~4 us at 3.35 TB/s). The scores add 8 bytes a live (slot, head), 1/32
// of the K/V bytes at D=64.
//
// Design: the wrapper's plan (ops/cuda/decode_attention.py split_plan, from
// B, H, T and the SM count alone: no host sync) cuts each row into S splits
// of `per` 64-slot tiles; CTA x of each kernel takes row bh = x % (B * H)
// and split x / (B * H). Three kernels run in order on the stream:
//   1. Scores: one CTA of 4 warps per (b, h, split). Per tile, every thread
//      issues all its 16-byte K loads (8 lanes cover a D = 64 row, 16 rows
//      a pass, 4 rows a thread) before it reduces any; the row's lanes sum
//      the dot product with shuffles; the score goes to the scratch row and
//      into the row group's running (m, l). The groups' (m, l) merge in a
//      fixed order into the split's partial.
//   2. PV: the same grid. Each CTA issues its first tile's V rows and score
//      loads, then reduces the row's S partials to (M, L) in a fixed order
//      (every CTA of the row gets the same bits), forms p = bf16(exp(s - M)
//      / L) and accumulates p * v in f32; the groups and warps are summed
//      in order into the split's [D] partial.
//   3. Combine: one CTA per (b, h) sums the S partials in split order (8
//      splits' loads in flight a thread) and writes bf16.
// K and V are each read once; nothing is atomic and every sum runs in a
// fixed order, so two launches on the same inputs are bitwise equal. A
// split outside the window writes the empty partial (m = -inf, l = 0; a
// zero PV partial) and exits. The scores live in the scratch row, not in
// shared memory, so only int32 indexing bounds T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE = 64;              // slots a CTA takes at once
constexpr int EPL = 8;                // bf16 values in one 16-byte load
constexpr int COMBINE_THREADS = 256;

// resident CTAs per SM the score and PV kernels are compiled for: a D = 128
// thread holds twice the rows of a D = 64 one
template <int D>
constexpr int min_ctas() {
  return D == 64 ? 8 : 4;
}

// One lane's 16 bytes of a K or V row as 8 f32 values, the low bf16 first.
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The live slots [lo, hi] of the CTA's split (lo > hi: none). The plan
// starts every split inside the row, so split * per * TILE < T fits int32.
__device__ __forceinline__ void split_window(int b, int split, int per, int T,
                                             const int* pos, const int* pad,
                                             int& lo, int& hi) {
  const long long s0 = (long long)split * per * TILE;
  const long long s1 = min(s0 + (long long)per * TILE, (long long)T) - 1;
  lo = (int)max((long long)max(__ldg(pad + b), 0), s0);
  hi = (int)min((long long)min(__ldg(pos + b), T - 1), s1);
}

// (m, l) <- the merge of two running (max, sum of exp(s - max)) pairs; an
// empty pair is (-inf, 0).
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2,
                                         float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, min_ctas<D>())
score_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const int* __restrict__ pos, const int* __restrict__ pad,
             float* __restrict__ scores, float* __restrict__ ml, int T, int H,
             int BH, int per, int S, float sm_scale) {
  constexpr int LPR = D / EPL;          // lanes per head row
  constexpr int RPW = NTHREADS / LPR;   // rows per pass of the CTA
  constexpr int R = TILE / RPW;         // rows per thread per tile
  __shared__ float red_m[NWARPS], red_l[NWARPS];
  const int bh = blockIdx.x % BH, split = blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / LPR, sub = tid % LPR;
  int lo, hi;
  split_window(b, split, per, T, pos, pad, lo, hi);
  float* out = ml + ((size_t)bh * S + split) * 2;
  if (lo > hi) {  // no live slot: the empty partial
    if (tid == 0) {
      out[0] = -INFINITY;
      out[1] = 0.f;
    }
    return;
  }

  float qf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    qf[e] = __bfloat162float(q[(size_t)bh * D + sub * EPL + e]);
  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* kh =
      k + (size_t)b * T * row_stride + (size_t)h * D + sub * EPL;
  float* sc = scores + (size_t)bh * T;

  float m = -INFINITY, l = 0.f;  // this row group's running max and sum
  const int t_end = hi / TILE;
  for (int t = lo / TILE; t <= t_end; ++t) {
    const long long c0 = (long long)t * TILE;
    uint4 kr[R];
    bool live[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {  // all of this thread's K rows in flight
      const long long j = c0 + g + i * RPW;
      live[i] = j >= lo && j <= hi;
      if (live[i])
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kh + j * row_stride));
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float d = 0.f;
      if (live[i]) {
        float kf[EPL];
        unpack8(kr[i], kf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qf[e] * kf[e];
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (live[i]) {
        const float s = d * sm_scale;
        if (sub == 0) sc[c0 + g + i * RPW] = s;
        const float mn = fmaxf(m, s);
        l = l * expf(m - mn) + expf(s - mn);
        m = mn;
      }
    }
  }

  // the groups' (m, l), merged in a fixed order: shuffles over the group
  // bits of the lane, then the warps in order
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge_ml(m, l, m2, l2);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {
    float M = red_m[0], L = red_l[0];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) merge_ml(M, L, red_m[w], red_l[w]);
    out[0] = M;
    out[1] = L;
  }
}

// This thread's V rows and scores of tile t (rows g, g + RPW, ... of it),
// all loads in flight at once; live[i] marks the rows inside [lo, hi].
template <int R, int RPW>
__device__ __forceinline__ void load_rows(uint4 (&vr)[R], float (&sv)[R],
                                          bool (&live)[R],
                                          const __nv_bfloat16* vh,
                                          const float* sc, size_t row_stride,
                                          int t, int g, int lo, int hi) {
  const long long c0 = (long long)t * TILE;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long j = c0 + g + i * RPW;
    live[i] = j >= lo && j <= hi;
    if (live[i]) {
      vr[i] = __ldg(reinterpret_cast<const uint4*>(vh + j * row_stride));
      sv[i] = __ldg(sc + j);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, min_ctas<D>())
pv_kernel(const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
          const int* __restrict__ pad, const float* __restrict__ scores,
          const float* __restrict__ ml, float* __restrict__ part, int T,
          int H, int BH, int per, int S) {
  constexpr int LPR = D / EPL;
  constexpr int RPW = NTHREADS / LPR;
  constexpr int R = TILE / RPW;
  __shared__ float red_x[NWARPS];
  __shared__ float red[NWARPS][D];
  const int bh = blockIdx.x % BH, split = blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / LPR, sub = tid % LPR;
  int lo, hi;
  split_window(b, split, per, T, pos, pad, lo, hi);
  float* out = part + ((size_t)bh * S + split) * D;
  if (lo > hi) {  // no live slot: a zero partial
    for (int d = tid; d < D; d += NTHREADS) out[d] = 0.f;
    return;
  }

  const size_t row_stride = (size_t)H * D;
  const __nv_bfloat16* vh =
      v + (size_t)b * T * row_stride + (size_t)h * D + sub * EPL;
  const float* sc = scores + (size_t)bh * T;
  uint4 vr[R];
  float sv[R];
  bool live[R];
  const int t0 = lo / TILE, t_end = hi / TILE;
  // the first tile's rows in flight while the row's (M, L) is reduced
  load_rows<R, RPW>(vr, sv, live, vh, sc, row_stride, t0, g, lo, hi);

  // (M, L) over the row's S partials, in the same order in every CTA of the
  // row: M exactly (a max), then L = sum_c l_c exp(m_c - M) by a fixed tree
  const float* mlr = ml + (size_t)bh * S * 2;
  float M = -INFINITY;
  for (int c = tid; c < S; c += NTHREADS) M = fmaxf(M, __ldg(mlr + 2 * c));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) red_x[warp] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red_x[w]);
  __syncthreads();
  float L = 0.f;
  for (int c = tid; c < S; c += NTHREADS) {
    const float lc = __ldg(mlr + 2 * c + 1);
    if (lc != 0.f) L += lc * expf(__ldg(mlr + 2 * c) - M);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, off);
  if (lane == 0) red_x[warp] = L;
  __syncthreads();
  L = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) L += red_x[w];

  // p = bf16(exp(s - M) / L), the reference's rounding; acc += p v in f32
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int t = t0; t <= t_end; ++t) {
    if (t != t0)
      load_rows<R, RPW>(vr, sv, live, vh, sc, row_stride, t, g, lo, hi);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (live[i]) {
        const float p =
            __bfloat162float(__float2bfloat16_rn(expf(sv[i] - M) / L));
        float vf[EPL];
        unpack8(vr[i], vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += p * vf[e];
      }
    }
  }

  // reduce acc over the row groups: shuffles, then the warps in order
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < LPR)
#pragma unroll
    for (int e = 0; e < EPL; ++e) red[warp][sub * EPL + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < D; d += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w][d];
    out[d] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
               int S) {
  constexpr int G = COMBINE_THREADS / D;  // groups of D threads
  constexpr int BATCH = 8;                // splits a thread loads at once
  __shared__ float acc_s[G][D];
  const int bh = blockIdx.x, tid = threadIdx.x, d = tid % D, grp = tid / D;
  const float* p = part + (size_t)bh * S * D;
  // group grp sums the splits grp, grp + G, ... in order
  float acc = 0.f;
  for (int c0 = grp; c0 < S; c0 += BATCH * G) {
    float x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = c0 + i * G;
      x[i] = c < S ? p[(size_t)c * D + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) acc += x[i];
  }
  acc_s[grp][d] = acc;
  __syncthreads();
  if (tid < D) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) a += acc_s[i][tid];
    o[(size_t)bh * D + tid] = __float2bfloat16_rn(a);
  }
}

template <int D>
int launch_dim(const void* q, const void* k, const void* v, const void* pos,
               const void* pad, float* scores, float* ml, float* part,
               void* o, int T, int H, int BH, int per, int S, float sm_scale,
               cudaStream_t st) {
  const unsigned grid = (unsigned)((long long)BH * S);
  const auto* pb = static_cast<const int*>(pos);
  const auto* db = static_cast<const int*>(pad);
  score_kernel<D><<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), pb, db, scores, ml, T, H, BH, per,
      S, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pv_kernel<D><<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(v), pb, db, scores, ml, part, T, H,
      BH, per, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<D><<<BH, COMBINE_THREADS, 0, st>>>(
      part, static_cast<__nv_bfloat16*>(o), S);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Runs the three kernels on `stream`
// and returns cudaGetLastError(): 0 on success. `scratch` holds B * H *
// (T + splits * (D + 2)) floats; the wrapper's plan gives each CTA `per`
// tiles of 64 slots, so splits must be ceil(ceil(T / 64) / per).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* pad,
                                void* scratch, void* o, int B, int T, int H,
                                int D, int per, int splits, float sm_scale,
                                void* stream) {
  const long long bh = (long long)B * H;
  const long long tiles = ((long long)T + TILE - 1) / TILE;
  if (B <= 0 || T <= 0 || H <= 0 || per <= 0 || bh > 0x7fffffffLL ||
      splits != (tiles + per - 1) / per || bh * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* scores = static_cast<float*>(scratch);
  float* ml = scores + bh * T;
  float* part = ml + bh * splits * 2;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dim<64>(q, k, v, pos, pad, scores, ml, part, o, T, H,
                          (int)bh, per, splits, sm_scale, st);
  if (D == 128)
    return launch_dim<128>(q, k, v, pos, pad, scores, ml, part, o, T, H,
                           (int)bh, per, splits, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
