// Flash-attention backward, fused dq, dk and dv (B3), for Hopper (sm_90a):
// bf16 in, f32 recompute and accumulation, bf16 dq, dk and dv out.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py
//           _bwd_fused_kernel (launched by _bwd_fused, variant "fused").
//
// What it computes: the split pair's gradients (B2a dq, B2b dk and dv) in one
// pass, s, p, dp and ds formed once per (key tile, query tile) pair:
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i,
//   p_ij = exp(s_ij - L_i),  ds_ij = p_ij (dO_i . v_j - D_i) * scale,
//   s_ij = q_i . k_j * scale,
// over the live pairs (mask[b, j] != 0, j < S, and j <= i when causal).
// Masked pairs have p = 0 exactly, so a query that sees no key gets dq = 0
// and a masked key dk = dv = 0 exactly. Five block products per pair instead
// of the split pair's seven.
//
// Layout: as B2a and B2b (csrc/flash_attention_bwd_dq.cu): q, k, v, dO, dq,
// dk, dv [B, S, H, D] contiguous; lse and dsum [B, H, S] f32; mask [B, S]
// int32 or null. D is 64 or 128, S is any length (the ragged last tile is
// masked). Scratch from the wrapper: dq_acc, an f32 [B, H, S, D] buffer that
// needs no zero fill (the first contribution to each query tile starts from
// zero), and sync, 1 + B*H*nq int32 zeros (a ticket counter, then one
// counter per (b*h, query tile)).
//
// What bounds it on the H100: at the training shapes (B=8, S=512, H=12, D=64,
// causal) the work is ~6.4 GFLOP (five block products per live pair) over
// ~44 MB (q, k, v, dO read once, dq, dk, dv written once): ~150 FLOP/byte,
// below the bf16 ridge of ~295 FLOP/byte, so device memory bounds it. The
// dq round trips through dq_acc (an f32 [64, D] tile read and written per
// pair) add traffic that mostly stays in the 50 MB L2.
//
// Design: B2b's structure, with dq added. One CTA of 4 warps per (64-key
// tile, b*h); each warp owns 16 keys. K and V are staged once into mma.sync
// A-fragments held in registers, and K stays in shared memory as the dq
// product's B operand. The CTA walks the query tiles in ascending order, from
// the causal diagonal (or the first tile) to the end; per tile it computes
// S^T = K Q^T and dP^T = V dO^T, forms p^T and ds^T in f32 registers, and
// adds dv += p^T dO and dk += ds^T Q into f32 registers, exactly as B2b does,
// so dk and dv are B2b's bit for bit.
//
// dq needs ds with queries as rows, the transpose of what the registers
// hold: the bf16 ds^T tile is stored transposed to shared memory and read
// back as A-fragments in B2a's layout (one shared round trip per pair).
// dq for a query tile collects one contribution per live key tile, from as
// many CTAs. They are ordered, not atomic (f32 atomics would make dq differ
// from run to run): per (b*h, query tile) an int32 counter in device memory
// holds the number of key tiles that have contributed. The CTA of key tile
// kt waits until it reads kt (its position among the tile's live key tiles,
// which are 0, 1, ... in ascending order), loads the f32 dq fragment from
// dq_acc (bypassing L1), chains onto it the same mma.sync products, in the
// same kk order, that B2a chains onto its register accumulator for that key
// tile, stores it, fences, and bumps the counter. The last contributor (key
// tile min(nk, qt + 1) - 1 when causal, nk - 1 otherwise) rounds the
// fragment to bf16 and writes dq instead. So dq is B2a's sum in B2a's order,
// and equals it bit for bit wherever the transposed products S^T and dP^T
// equal B2a's S and dP bit for bit.
//
// Deadlock: a CTA must never wait on one that has not started, since a
// spinning CTA holds its SM slot. Each CTA therefore takes a ticket from an
// atomic counter at entry and maps the ticket, not blockIdx, to its work:
// ticket t -> key tile t / (B*H), b*h t % (B*H). A CTA waits only on CTAs of
// the same b*h with smaller key tiles, which hold smaller tickets, so they
// took theirs before it did and are running; the smallest ticket still
// running waits on no one, so every CTA finishes. Loads are synchronous (no
// cp.async, TMA or wgmma yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per shared-memory tile
constexpr int BK = 64;        // keys per CTA (4 warps x 16)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)
constexpr int DSW = BK + PAD; // row width of the staged ds tile

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sO (dO), sK: [64][D + PAD] bf16; sDS: [64][BK + PAD] bf16; sL, sD
  return (size_t)(3 * BQ * (D + PAD) + BQ * DSW) * 2 + 2 * BQ * 4;
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
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

// A-fragments of this warp's 16 rows of a [64][W + PAD] tile.
template <int W>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[W / 16][4],
                                             const __nv_bfloat16* tile,
                                             int wr, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const __nv_bfloat16* r0 = tile + (wr + g) * (W + PAD) + kk * 16 + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * (W + PAD);
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

// B-fragment pair of the product's k rows kk*16 .. kk*16+15 and columns
// dn*8 .. dn*8+7 of a [64][D + PAD] tile whose rows are the k index.
template <int D>
__device__ __forceinline__ void b_frag(const uint16_t* tu, int kk, int dn,
                                       int g, int t4, uint32_t& b0,
                                       uint32_t& b1) {
  const uint16_t* p = tu + (kk * 16 + t4 * 2) * (D + PAD) + dn * 8 + g;
  b0 = (uint32_t)p[0] | ((uint32_t)p[D + PAD] << 16);
  b1 = (uint32_t)p[8 * (D + PAD)] | ((uint32_t)p[9 * (D + PAD)] << 16);
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
      uint32_t b0, b1;
      b_frag<D>(tu, kk, dn, g, t4, b0, b1);
      mma_bf16(acc[dn], a, b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_fused_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       const int* __restrict__ mask,
                       __nv_bfloat16* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ dq_acc, int* __restrict__ sync,
                       int S, int H, int BH, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + BQ * (D + PAD);   // dO tile
  __nv_bfloat16* sK = sO + BQ * (D + PAD);   // resident K tile
  __nv_bfloat16* sDS = sK + BK * (D + PAD);  // ds tile, queries as rows
  float* sL = reinterpret_cast<float*>(sDS + BQ * DSW);
  float* sD = sL + BQ;
  __shared__ int sTicket;

  if (threadIdx.x == 0) sTicket = atomicAdd(sync, 1);
  __syncthreads();
  const int kt = sTicket / BH, bh = sTicket % BH;
  const int nk = (S + BK - 1) / BK, nq = (S + BQ - 1) / BQ;
  int* qcount = sync + 1 + (size_t)bh * nq;  // per query tile of this b*h

  const int k0 = kt * BK;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row

  // K stays in shared memory; V is staged through sO. Both -> A fragments.
  load_tile<D>(sK, k + base, k0, S, row_stride);
  load_tile<D>(sO, v + base, k0, S, row_stride);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, sK, wr, g, t4);
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
  const uint16_t* sKu = reinterpret_cast<const uint16_t*>(sK);

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

    // ds^T -> bf16 ds [query][key] in shared memory
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        sDS[col * DSW + wr + g + 8 * (e >> 1)] = __float2bfloat16_rn(dpt[n][e]);
      }
    }
    __syncthreads();
    uint32_t dsf[BK / 16][4];  // this warp's 16 queries' ds, B2a's A layout
    load_a_frags<BK>(dsf, sDS, wr, g, t4);

    // wait for the key tiles before this one to have added their part
    if (threadIdx.x == 0) {
      while (ld_acquire(qcount + qt) != kt) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();

    const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
    float acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* src = dq_acc + ((size_t)bh * S + rows[i]) * D + t4 * 2;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        float2 x = make_float2(0.f, 0.f);
        if (kt > 0 && rows[i] < S)
          x = __ldcg(reinterpret_cast<const float2*>(src + dn * 8));
        acc[dn][2 * i] = x.x;
        acc[dn][2 * i + 1] = x.y;
      }
    }
    // dq += ds K, B2a's product and order
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b0, b1;
        b_frag<D>(sKu, kk, dn, g, t4, b0, b1);
        mma_bf16(acc[dn], dsf[kk], b0, b1);
      }
    }

    const int last = (causal ? min(nk, qt + 1) : nk) - 1;
    if (kt == last) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] >= S) continue;
        __nv_bfloat16* out = dq + base + (size_t)rows[i] * row_stride;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          *reinterpret_cast<__nv_bfloat162*>(out + dn * 8 + t4 * 2) =
              __floats2bfloat162_rn(acc[dn][2 * i], acc[dn][2 * i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (rows[i] >= S) continue;
        float* dst = dq_acc + ((size_t)bh * S + rows[i]) * D + t4 * 2;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn)
          __stcg(reinterpret_cast<float2*>(dst + dn * 8),
                 make_float2(acc[dn][2 * i], acc[dn][2 * i + 1]));
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicExch(qcount + qt, kt + 1);
    }
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

template <int D>
int launch(const dim3 grid, cudaStream_t st, const __nv_bfloat16* qb,
           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
           const __nv_bfloat16* db, const float* lb, const float* sb,
           const int* mb, __nv_bfloat16* dqb, __nv_bfloat16* dkb,
           __nv_bfloat16* dvb, float* acc, int* sync, int S, int H, int BH,
           int causal, float sm_scale) {
  constexpr size_t bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_fused_kernel<D><<<grid, NTHREADS, bytes, st>>>(
      qb, kb, vb, db, lb, sb, mb, dqb, dkb, dvb, acc, sync, S, H, BH, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success. ``sync`` must hold 1 + B*H*ceil(S/64) zeros.
extern "C" int flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, const void* mask, void* dq, void* dk,
    void* dv, void* dq_acc, void* sync, int B, int S, int H, int D, int causal,
    float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)((S + BK - 1) / BK) * B * H;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* sb = static_cast<const float*>(dsum);
  const auto* mb = static_cast<const int*>(mask);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  auto* acc = static_cast<float*>(dq_acc);
  auto* sy = static_cast<int*>(sync);
  if (D == 64)
    return launch<64>(grid, st, qb, kb, vb, db, lb, sb, mb, dqb, dkb, dvb,
                      acc, sy, S, H, B * H, causal, sm_scale);
  if (D == 128)
    return launch<128>(grid, st, qb, kb, vb, db, lb, sb, mb, dqb, dkb, dvb,
                       acc, sy, S, H, B * H, causal, sm_scale);
  return (int)cudaErrorInvalidValue;
}
