// Split-K single-query decode attention through block tables over a
// shared paged KV pool, for Hopper (sm_90a): the design shared by the bf16
// kernel (paged_decode_attention.cu, QUANT = false) and the int8 kernel
// (paged_decode_attention_int8.cu, QUANT = true). Each .cu file says which
// TPU kernel it replaces, its arithmetic and what bounds it; this header
// holds the two device kernels and the host launch.
//
// Split kernel, one CTA of 4 warps per (b, h, split): a 1-D grid of
// B * H * S CTAs, where CTA x takes row bh = x % (B * H) and, with
// split = x / (B * H), the `per` tiles of TILE = 64 logical slots from
// tile split * per on (the wrapper's plan: per = 1, one tile a CTA, until
// the grid would pass a few CTAs per SM). A CTA whose slots hold no live
// slot writes the empty partial (m = -inf, l = 0) and exits. Over its live
// tiles, in order:
//   1. It stages the tile's block ids (one table load per thread, issued
//      during the previous tile) in shared memory. A live slot whose block
//      id lies outside [0, N) makes the partial NaN (l = NaN) at once.
//   2. Every thread issues all its 16-byte K and V loads of the tile at
//      once: LPR lanes cover one head row (LPR = D * sizeof(elem) / 16),
//      so a thread has R = TILE / (128 / LPR) rows of K and of V in flight
//      before it reduces any. Masked slots (and, int8, their scales) are
//      never read.
//   3. Scores: each lane's dot product over its 16 bytes, reduced over the
//      row's LPR lanes with shuffles, into shared memory.
//   4. Warp 0 moves the running max m to cover the tile, rescales the
//      running sum l by alpha = exp(m_old - m) and adds p = exp(s - m)
//      (f32), and turns p into the PV weight: bf16(p) (QUANT = false, the
//      Pallas float kernel's rounding) or p * v_scale (QUANT = true).
//   5. Each thread rescales its f32 acc by alpha and adds weight * v.
// At the end acc is reduced over the row groups (shuffles, then the 4
// warps through shared memory in warp order) and written with m and l to
// the f32 partial [B * H, S, D + 2].
// Combine kernel, one CTA of 256 threads per (b, h): M = max m over the
// non-empty partials, then L = sum l * exp(m - M) and o = sum acc *
// exp(m - M) / L, each of the 256 / D thread groups over every (256 / D)-th
// split in order with 8 splits' loads in flight, the groups summed in
// order (0 when every partial is empty, NaN when any is NaN).
// Every sum runs in a fixed order and nothing is atomic, so two launches
// on the same inputs are bitwise equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE = 64;  // slots a CTA takes at once: two scores a lane

template <bool QUANT>
struct Pool;
template <>
struct Pool<false> {
  using T = __nv_bfloat16;
  static constexpr int PER16 = 8;  // elements in one 16-byte load
};
template <>
struct Pool<true> {
  using T = int8_t;
  static constexpr int PER16 = 16;
};

// One lane's 16 bytes of a K or V row, as f32: 8 bf16 or 16 int8 values.
template <bool QUANT>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (QUANT) {
#pragma unroll
      for (int k = 0; k < 4; ++k)  // sign-extend byte k
        out[4 * i + k] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * k)) >> 24);
    } else {
      out[2 * i] = __uint_as_float(w[i] << 16);  // the low bf16 first
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// resident CTAs per SM the split kernel is compiled for: 8 caps a D = 64
// thread at 64 registers (ptxas spills a few bytes for it), so the 960
// CTAs of the engine's shape fit the 132 SMs at once; a D = 128 thread
// holds twice the rows
template <int D>
constexpr int split_min_ctas() {
  return D == 64 ? 8 : 4;
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(NTHREADS, split_min_ctas<D>())
split_kernel(const __nv_bfloat16* __restrict__ q,
             const typename Pool<QUANT>::T* __restrict__ k_pool,
             const typename Pool<QUANT>::T* __restrict__ v_pool,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ block_tables,
             const int* __restrict__ pos, const int* __restrict__ pad,
             float* __restrict__ part, int N, int Bs, int NB, int BH, int H,
             int per, int S, float sm_scale) {
  constexpr int EPL = Pool<QUANT>::PER16;    // elements per lane
  constexpr int LPR = D / EPL;               // lanes per head row
  constexpr int RPW = NTHREADS / LPR;        // rows per pass of the CTA
  constexpr int R = TILE / RPW;              // rows per thread per tile
  static_assert(32 % LPR == 0 && TILE % RPW == 0 && TILE <= 64,
                "a row's lanes sit in one warp; warp 0 takes the scores");
  __shared__ int ids[TILE];                  // the tile's block ids
  __shared__ float sc[TILE];                 // scores, then PV weights
  __shared__ float vsc[QUANT ? TILE : 1];    // V scales of live slots
  __shared__ float alpha_s;                  // acc's rescale for this tile
  __shared__ float red[NWARPS][D];

  const int bh = blockIdx.x % BH, split = blockIdx.x / BH;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int T_ = NB * Bs;
  float* out = part + ((size_t)bh * S + split) * (D + 2);
  // this CTA's slots: tiles [split * per, (split + 1) * per) of the row,
  // cut to the live window (in long long: a tile's end may pass int32)
  const int s0 = (int)((long long)split * per * TILE);  // < T_
  const long long s1 = min((long long)s0 + (long long)per * TILE,
                           (long long)T_) - 1;
  const int* bt = block_tables + (size_t)b * NB;
  // the last slot of the tile that starts at slot c0 (c0 + r fits int32
  // for r < TILE; c0 + TILE may not)
  auto tile_end = [T_](int c0) {
    return (int)min((long long)c0 + TILE, (long long)T_) - 1;
  };
  // the first tile's table entries, loaded beside pos / pad; each tile
  // loads the next one's
  int id = 0;
  if (tid <= tile_end(s0) / Bs - s0 / Bs) id = __ldg(bt + s0 / Bs + tid);
  const int lo = (int)max((long long)max(__ldg(pad + b), 0), (long long)s0);
  const int hi = (int)min((long long)min(__ldg(pos + b), T_ - 1), s1);
  if (lo > hi) {  // no live slot: the empty partial
    if (tid == 0) {
      out[D] = -INFINITY;
      out[D + 1] = 0.f;
    }
    return;
  }

  const int g = tid / LPR, sub = tid % LPR;
  float qf[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    qf[e] = __bfloat162float(q[(size_t)bh * D + sub * EPL + e]);
  const size_t row_stride = (size_t)H * D;  // one pool slot: [H, D]
  const size_t head = (size_t)h * D + sub * EPL;

  float m_run = -INFINITY, l_run = 0.f;     // warp 0's running max and sum
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  const int t_end = hi / TILE;
  if (lo / TILE * TILE != s0) {  // the window starts in a later tile
    const int c0 = lo / TILE * TILE;
    if (tid <= tile_end(c0) / Bs - c0 / Bs) id = __ldg(bt + c0 / Bs + tid);
  }
  for (int t = lo / TILE; t <= t_end; ++t) {
    const int c0 = t * TILE, c1 = tile_end(c0);
    const int a = max(lo, c0), z = min(hi, c1);  // live slots of the tile
    const int blk0 = c0 / Bs, nblk = c1 / Bs - blk0 + 1;
    int bad = 0;
    if (tid < nblk) {
      const int blk = blk0 + tid;
      bad = (long long)blk * Bs <= z && (long long)(blk + 1) * Bs > a &&
            (id < 0 || id >= N);
      ids[tid] = id;
    }
    if (t < t_end && tid <= tile_end(c0 + TILE) / Bs - (c0 + TILE) / Bs)
      id = __ldg(bt + (c0 + TILE) / Bs + tid);  // the next tile's entries
    if (__syncthreads_or(bad)) {  // a live slot names a block past the pool
      if (tid == 0) {
        out[D] = 0.f;
        out[D + 1] = __int_as_float(0x7fc00000);
      }
      return;
    }

    // all of this thread's K and V rows of the tile in flight at once
    uint4 kr[R], vr[R];
    float ksv[R], vsv[R];
    bool live[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = c0 + g + i * RPW;
      live[i] = j >= a && j <= z;
      if (live[i]) {
        const size_t slot = (size_t)ids[j / Bs - blk0] * Bs + j % Bs;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(
            k_pool + slot * row_stride + head));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(
            v_pool + slot * row_stride + head));
        if constexpr (QUANT) {
          if (sub == 0) {
            ksv[i] = __ldg(k_scale + slot);
            vsv[i] = __ldg(v_scale + slot);
          }
        }
      }
    }

    // scores
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float d = 0.f;
      if (live[i]) {
        float kf[EPL];
        unpack16<QUANT>(kr[i], kf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) d += qf[e] * kf[e];
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (sub == 0) {
        const int r = g + i * RPW;
        float s = d * sm_scale;
        if constexpr (QUANT) {
          s *= live[i] ? ksv[i] : 0.f;
          vsc[r] = live[i] ? vsv[i] : 0.f;
        }
        sc[r] = s;
      }
    }
    __syncthreads();

    // warp 0: the running max and sum, acc's rescale, the PV weights
    if (warp == 0) {
      const int r0 = lane, r1 = lane + 32;
      const bool l0 = c0 + r0 >= a && c0 + r0 <= z;
      const bool l1 = c0 + r1 >= a && c0 + r1 <= z;
      const float x0 = l0 ? sc[r0] : -INFINITY;
      const float x1 = l1 ? sc[r1] : -INFINITY;
      float m = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float m_new = fmaxf(m_run, m);
      const float p0 = l0 ? expf(x0 - m_new) : 0.f;
      const float p1 = l1 ? expf(x1 - m_new) : 0.f;
      float l = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * alpha + l;
      m_run = m_new;
      if constexpr (QUANT) {
        sc[r0] = p0 * vsc[r0];
        sc[r1] = p1 * vsc[r1];
      } else {
        sc[r0] = __bfloat162float(__float2bfloat16_rn(p0));
        sc[r1] = __bfloat162float(__float2bfloat16_rn(p1));
      }
      if (lane == 0) alpha_s = alpha;
    }
    __syncthreads();

    // acc = alpha acc + weighted V rows, f32
    const float alpha = alpha_s;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (live[i]) {
        const float w = sc[g + i * RPW];
        float vf[EPL];
        unpack16<QUANT>(vr[i], vf);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += w * vf[e];
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
  if (tid == 0) {
    out[D] = m_run;
    out[D + 1] = l_run;
  }
  __syncthreads();
  for (int d = tid; d < D; d += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w][d];
    out[d] = s;
  }
}

constexpr int COMBINE_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
               int S) {
  constexpr int G = COMBINE_THREADS / D;  // groups of D threads
  constexpr int NW = COMBINE_THREADS / 32;
  constexpr int BATCH = 8;                // splits a thread loads at once
  __shared__ float wmax[NW];
  __shared__ float acc_s[G][D];
  __shared__ float l_s[G];
  const int bh = blockIdx.x, tid = threadIdx.x, d = tid % D, grp = tid / D;
  const float* p = part + (size_t)bh * S * (D + 2);
  // M = max m over the non-empty partials (l = 0: empty; l = NaN counts)
  float M = -INFINITY;
  for (int c = tid; c < S; c += COMBINE_THREADS) {
    const float m = p[(size_t)c * (D + 2) + D];
    M = fmaxf(M, p[(size_t)c * (D + 2) + D + 1] != 0.f ? m : -INFINITY);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (tid % 32 == 0) wmax[tid / 32] = M;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w) M = fmaxf(M, wmax[w]);
  // group grp sums the splits grp, grp + G, ... in order, BATCH loads in
  // flight at a time; an empty partial is selected away (its acc was never
  // written), a NaN one poisons L
  float L = 0.f, acc = 0.f;
  for (int c0 = grp; c0 < S; c0 += BATCH * G) {
    float m[BATCH], l[BATCH], x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int c = c0 + k * G;
      const float* pc = p + (size_t)c * (D + 2);
      m[k] = c < S ? pc[D] : 0.f;
      l[k] = c < S ? pc[D + 1] : 0.f;
      x[k] = c < S ? pc[d] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const float w = l[k] != 0.f ? expf(m[k] - M) : 0.f;
      L += l[k] * w;
      acc += w != 0.f ? x[k] * w : 0.f;
    }
  }
  acc_s[grp][d] = acc;
  if (d == 0) l_s[grp] = L;
  __syncthreads();
  if (tid < D) {
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a += acc_s[g][tid];
      ls += l_s[g];
    }
    // an empty window gives exact zeros; a NaN sum stays NaN
    o[(size_t)bh * D + tid] = __float2bfloat16_rn(ls == 0.f ? 0.f : a / ls);
  }
}

template <int D, bool QUANT>
int launch_dim(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale,
               const void* block_tables, const void* pos, const void* pad,
               void* part, void* o, int B, int N, int Bs, int NB, int H,
               int per, int S, float sm_scale, cudaStream_t st) {
  using T = typename Pool<QUANT>::T;
  const int BH = B * H;
  split_kernel<D, QUANT><<<(unsigned)((long long)BH * S), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(pos),
      static_cast<const int*>(pad), static_cast<float*>(part), N, Bs, NB, BH,
      H, per, S, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<D><<<BH, COMBINE_THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(o), S);
  return (int)cudaGetLastError();
}

// Checks the sizes and runs both kernels on `stream`: the wrapper's plan
// gives each CTA `per` tiles of TILE slots, so S must be
// ceil(ceil(NB * Bs / TILE) / per). Returns a cudaError_t as an int.
template <bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* pos, const void* pad,
           void* part, void* o, int B, int N, int Bs, int NB, int H, int D,
           int per, int S, float sm_scale, void* stream) {
  const long long slots = (long long)NB * Bs;
  const long long tiles = (slots + TILE - 1) / TILE;
  if (B <= 0 || N <= 0 || Bs <= 0 || NB <= 0 || H <= 0 || per <= 0 ||
      slots > 0x7fffffffLL || (long long)B * H > 0x7fffffffLL ||
      S != (tiles + per - 1) / per || (long long)B * H * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dim<64, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, pos, pad, part, o, B, N, Bs,
                                 NB, H, per, S, sm_scale, st);
  if (D == 128)
    return launch_dim<128, QUANT>(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, pos, pad, part, o, B, N, Bs,
                                  NB, H, per, S, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged
