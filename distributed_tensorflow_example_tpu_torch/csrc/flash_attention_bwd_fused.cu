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
// pair) add traffic that mostly stays in the 50 MB L2. In practice the
// kernel is bound by neither: it holds ~250 registers a thread (2 CTAs, 8
// warps, an SM) and issues mma.sync, full-precision expf and the shared
// loads that feed them with little to hide their latency.
//
// Design: B2b's structure, with dq added. One CTA of 4 warps per (64-key
// tile, b*h); each warp owns 16 keys. K and V are staged once into mma.sync
// A-fragments held in registers, and K stays in shared memory as the dq
// product's B operand. The CTA walks the query tiles in ascending order, from
// the causal diagonal (or the first tile) to the end; per tile it computes
// S^T = K Q^T and dP^T = V dO^T, forms p^T and ds^T in f32 registers, and
// adds dv += p^T dO and dk += ds^T Q into f32 registers, exactly as B2b does,
// so dk and dv are B2b's bit for bit. Every mma.sync product, its operands
// and the order in which dq, dk and dv accumulate are those of the split
// pair; what is built around them:
//
// - A two-stage ring: the next query tile's Q, dO, L and D rows are copied
//   with cp.async into the second shared-memory stage while the current
//   tile computes (one cp.async group per tile; ~82 KB of dynamic shared
//   memory a CTA at D = 64).
// - Operands through ldmatrix: the B fragments of the five products (rows
//   of Q, dO or K, plain or transposed) are loaded four 8x8 matrices at a
//   time with ldmatrix(.trans), and ds^T is stored transposed with
//   stmatrix.trans. A B fragment of a transposed operand is otherwise four
//   16-bit loads and two shifts; these move the same bf16 values into the
//   same registers, so no product changes, with ~4x fewer shared-memory
//   instructions.
//
// dq needs ds with queries as rows, the transpose of what the registers
// hold: the bf16 ds^T tile is stored transposed into a ring of shared-memory
// slots and read back as A-fragments in B2a's layout. dq for a query tile
// collects one contribution per live key tile, from as many CTAs. They are
// ordered, not atomic (f32 atomics would make dq differ from run to run):
// per (b*h, query tile) an int32 counter in device memory holds the number
// of key tiles that have contributed. The CTA of key tile kt may chain its
// contribution to query tile qt once the counter reads kt (its position
// among the tile's live key tiles, which are 0, 1, ... in ascending order):
// it loads the f32 dq fragment from dq_acc (bypassing L1), chains onto it
// the same mma.sync products, in the same kk order, that B2a chains onto its
// register accumulator for that key tile, stores it, fences, and bumps the
// counter. The last contributor (key tile min(nk, qt + 1) - 1 when causal,
// nk - 1 otherwise) rounds the fragment to bf16 and writes dq instead. So dq
// is B2a's sum in B2a's order, and equals it bit for bit wherever the
// transposed products S^T and dP^T equal B2a's S and dP bit for bit.
//
// The chain does not idle the CTA: a query tile whose counter is not yet kt
// keeps its ds^T in its ring slot (RING slots: 4 at D = 64, 2 at D = 128)
// and the CTA goes on to the next query tile's S^T, dP^T, dk and dv. After
// each tile it chains the pending tiles, oldest first, while their counters
// allow; it waits on a counter only when the ring is full (to free the
// oldest slot) and after the last tile (to drain the ring). Each query
// tile still receives its contributions in ascending kt order, since the
// counter admits only key tile kt after kt - 1.
//
// Deadlock: a CTA must never wait on one that has not started, since a
// spinning CTA holds its SM slot. Each CTA therefore takes a ticket from an
// atomic counter at entry and maps the ticket, not blockIdx, to its work:
// ticket t -> key tile t / (B*H), b*h t % (B*H). A CTA waits only on the
// counters of its own b*h, which key tiles kt' < kt advance; their CTAs hold
// smaller tickets, so they took theirs before it did and are running. Key
// tile 0 never waits (every counter starts at 0), and a CTA of key tile kt
// that waits needs only key tile kt - 1 to chain the same query tile, which
// it does without waiting on any larger key tile. By induction on kt every
// CTA finishes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per shared-memory tile
constexpr int BK = 64;        // keys per CTA (4 warps x 16)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)
constexpr int DSW = BK + PAD; // row width of a staged ds tile
static_assert(NTHREADS == 2 * BQ, "one thread per L or D row of a tile");

// ds tiles a CTA may keep waiting on the dq chain
template <int D>
__host__ __device__ constexpr int ring() {
  return D == 64 ? 4 : 2;
}

template <int D>
constexpr size_t smem_bytes() {
  // sK, then two stages of sQ and sO (dO): [64][D + PAD] bf16 each; the ds
  // ring: [RING][64][BK + PAD] bf16; two stages of sL and sD: [64] f32
  return (size_t)(5 * BQ * (D + PAD) + ring<D>() * BQ * DSW) * 2 +
         4 * BQ * 4;
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
// low half.
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

// The inverse of ldsm_x4_t: lane (g, t4)'s register j holds row g, columns
// 2 t4 and 2 t4 + 1 of matrix j, stored transposed at the rows lane i names.
__device__ __forceinline__ void stsm_x4_t(void* p, uint32_t r0, uint32_t r1,
                                          uint32_t r2, uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1,%2,%3,%4};\n" ::"r"(smem_addr(p)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Start copying rows [row0, row0 + 64) of one head (row r at src + r *
// row_stride) into dst [64][D + PAD]; rows at or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int S,
                                                int row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BQ * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    __nv_bfloat16* d = dst + r * (D + PAD) + cc * 8;
    if (row0 + r < S)
      cp_async16(d, src + (size_t)(row0 + r) * row_stride + cc * 8);
    else
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
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
// the product). ldmatrix gives B fragments (b0, b1) of columns n and n + 1.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[BQ / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < BQ / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, tile + ((n + (mi >> 1)) * 8 + ri) * (D + PAD) + kk * 16 +
                     (mi & 1) * 8);
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[16 x D] += A . T over k rows kk * 16 .. kk * 16 + 15 of T, a
// [64][D + PAD] tile whose rows are the product's k index: ldmatrix.trans
// gives the B fragments (b0, b1) of columns dn and dn + 1.
template <int D>
__device__ __forceinline__ void mma_kk(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int kk,
                                       int lane) {
  const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
  for (int dn = 0; dn < D / 8; dn += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + (kk * 16 + (mi & 1) * 8 + ri) * (D + PAD) +
                     (dn + (mi >> 1)) * 8);
    mma_bf16(acc[dn], a, b[0], b[1]);
    mma_bf16(acc[dn + 1], a, b[2], b[3]);
  }
}

// acc[16 x D] += A . T, A[16 x 64] the bf16 re-pack of a [16 x 64] f32
// accumulator x, T a [64][D + PAD] tile (rows = the product's k index).
template <int D>
__device__ __forceinline__ void mma_xt(float (&acc)[D / 8][4],
                                       const float (&x)[BQ / 8][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    mma_kk<D>(acc, a, tile, kk, lane);
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
  constexpr int RING = ring<D>();
  constexpr int TILE = BQ * (D + PAD);      // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // resident K
  // stage s: Q at sK + (1 + 2 s) TILE, dO at sK + (2 + 2 s) TILE
  __nv_bfloat16* sDS = sK + 5 * TILE;       // RING ds tiles, queries as rows
  float* sL = reinterpret_cast<float*>(sDS + RING * BQ * DSW);  // [2][64]
  float* sD = sL + 2 * BQ;                                      // [2][64]
  __shared__ int sTicket;

  if (threadIdx.x == 0) sTicket = atomicAdd(sync, 1);
  __syncthreads();
  const int kt = sTicket / BH, bh = sTicket % BH;
  const int nk = (S + BK - 1) / BK, nq = (S + BQ - 1) / BQ;
  int* qcount = sync + 1 + (size_t)bh * nq;  // per query tile of this b*h

  const int k0 = kt * BK;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row

  // start copying query tile qt's Q, dO, L and D rows into stage st
  auto prefetch = [&](int qt, int st) {
    const int q0 = qt * BQ;
    load_tile_async<D>(sK + (1 + 2 * st) * TILE, q + base, q0, S, row_stride);
    load_tile_async<D>(sK + (2 + 2 * st) * TILE, dout + base, q0, S,
                       row_stride);
    const int r = tid % BQ, row = q0 + r;
    float* dst = (tid < BQ ? sL : sD) + st * BQ + r;
    if (row < S)
      cp_async4(dst, (tid < BQ ? lse : dsum) + (size_t)bh * S + row);
    else
      *dst = 0.f;
    cp_async_commit();
  };

  // K stays in shared memory; V is staged through stage 1's dO buffer. Both
  // -> A fragments, while the first query tile lands in stage 0.
  const int first = causal ? k0 / BQ : 0;  // no query above the diagonal
  load_tile_async<D>(sK, k + base, k0, S, row_stride);
  load_tile_async<D>(sK + 4 * TILE, v + base, k0, S, row_stride);
  cp_async_commit();
  prefetch(first, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, sK, wr, g, t4);
  load_a_frags<D>(vf, sK + 4 * TILE, wr, g, t4);
  __syncthreads();  // stage 1 is free for the next tile

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

  // Chain this key tile's contribution to query tile qt's dq (its ds in
  // ring slot (qt - first) % RING) once the tile's counter reads kt; with
  // `block` false, return false at once if it does not yet. Every thread
  // calls it and gets the same answer (thread 0 reads the counter; the
  // barrier broadcasts it).
  auto chain = [&](int qt, bool block) -> bool {
    bool ready = false;
    if (tid == 0) {
      int c = ld_acquire(qcount + qt);
      while (block && c != kt) {
        __nanosleep(32);
        c = ld_acquire(qcount + qt);
      }
      if (c == kt) __threadfence();
      ready = c == kt;
    }
    if (!__syncthreads_or(ready)) return false;
    const int q0 = qt * BQ;
    uint32_t dsf[BK / 16][4];  // this warp's 16 queries' ds, B2a's A layout
    load_a_frags<BK>(dsf, sDS + ((qt - first) % RING) * BQ * DSW, wr, g, t4);
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
    for (int kk = 0; kk < BK / 16; ++kk) mma_kk<D>(acc, dsf[kk], sK, kk, lane);

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
      if (tid == 0) atomicExch(qcount + qt, kt + 1);
    }
    return true;
  };

  int head = first;  // the oldest query tile whose dq contribution waits
  for (int qt = first; qt < nq; ++qt) {
    const int st = (qt - first) & 1;
    if (qt + 1 < nq) {
      prefetch(qt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tQ = sK + (1 + 2 * st) * TILE;
    const __nv_bfloat16* tO = sK + (2 + 2 * st) * TILE;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    const int q0 = qt * BQ;

    float sT[BQ / 8][4], dpt[BQ / 8][4];
    mma_abt<D>(sT, kf, tQ, lane);   // S^T = K Q^T
    mma_abt<D>(dpt, vf, tO, lane);  // dP^T = V dO^T

    // p^T in sT, ds^T in dpt; exactly 0 on masked pairs
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = n * 8 + t4 * 2 + (e & 1);
        const int query = q0 + col;
        const bool ok = live[i] && query < S && (!causal || keys[i] <= query);
        const float p = ok ? expf(sT[n][e] * sm_scale - tL[col]) : 0.f;
        sT[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - tD[col]) * sm_scale;
      }
    }

    mma_xt<D>(dva, sT, tO, lane);   // dv += p^T dO
    mma_xt<D>(dka, dpt, tQ, lane);  // dk += ds^T Q

    // a full ring: the oldest tile's contribution goes first, waiting on
    // its counter, to free its slot
    if (qt - head == RING) {
      chain(head++, true);
      __syncthreads();  // every warp has read the slot this tile takes
    }
    // ds^T -> bf16 ds [query][key] in the tile's ring slot
    __nv_bfloat16* slot = sDS + ((qt - first) % RING) * BQ * DSW;
    {
      const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
      for (int n = 0; n < BQ / 8; n += 2)
        stsm_x4_t(slot + ((n + (mi >> 1)) * 8 + ri) * DSW + wr + (mi & 1) * 8,
                  pack_bf16(dpt[n][0], dpt[n][1]),
                  pack_bf16(dpt[n][2], dpt[n][3]),
                  pack_bf16(dpt[n + 1][0], dpt[n + 1][1]),
                  pack_bf16(dpt[n + 1][2], dpt[n + 1][3]));
    }
    __syncthreads();
    // chain the waiting tiles, oldest first, while their counters allow
    while (head <= qt && chain(head, false)) ++head;
    __syncthreads();  // the stage just read is the next prefetch's target
  }
  while (head < nq) chain(head++, true);

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
