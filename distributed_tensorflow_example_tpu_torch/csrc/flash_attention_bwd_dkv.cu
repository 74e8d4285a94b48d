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
// memory bounds it (~11.4 us). On the H100 it takes ~4.2x that (0.048 ms):
// neither bytes nor tensor-core rate set its pace but latency, each warp's
// chain of ldmatrix, mma.sync and full-precision expf at 8 warps an SM.
//
// Design: one CTA of 4 warps per (64-key tile, b*h); each warp owns 16 keys.
// The K and V tiles are staged once into mma.sync A-fragments held in
// registers. The CTA computes the products TRANSPOSED, keys as rows:
// S^T = K Q^T and dP^T = V dO^T, so p^T and ds^T come out in the
// accumulator layout that re-packs directly as A-fragments for dv += p^T dO
// and dk += ds^T Q. dk and dv accumulate in f32 registers over the query
// tiles in ascending order, from the causal diagonal (or the first tile) to
// the end, kk ascending inside each tile: the fused kernel B3 (csrc/
// flash_attention_bwd_fused.cu) runs the same products in the same order, so
// its dk and dv equal these bit for bit. Around that arithmetic:
//
// - Asynchronous loads: the query tiles' Q, dO, L and D rows stream through
//   a two-stage cp.async ring in dynamic shared memory (~37 KB a CTA at
//   D = 64, ~69 KB at D = 128). The copy of tile qt + 1 is issued right
//   after the one barrier of step qt and lands while tile qt computes.
// - Operands through ldmatrix (csrc/flash_attention.cuh): the B
//   fragments of S^T and dP^T are Q's and dO's rows (ldmatrix), those of
//   dv += p^T dO and dk += ds^T Q their columns (ldmatrix.trans), four 8x8
//   matrices an instruction: the bf16 pairs that element-wise shared loads
//   would put in the same registers, so no product changes.
// - Column blocks at D = 128: each query tile is taken as two blocks of 32
//   queries, S^T, dP^T, p^T, ds^T, dv and dk of one block before the next,
//   so each accumulator still sums kk ascending over the whole tile; a
//   block's scores need half the registers (32 bytes of spills at D = 128,
//   674 for whole tiles). At D = 64 whole tiles run faster: one block.
// - Heaviest first: CTA x of the 1-D grid takes key tile x / (B*H) and b*h
//   x % (B*H), so under causal masking the key tiles with the longest query
//   walks (key tile 0 walks every query tile) start in the first wave.
//   Nothing is summed across CTAs, so the order moves no bit.
// - The predicate where it is needed: a warp whose 16 keys are all live
//   skips the per-element test on a query tile wholly inside S and, when
//   causal, past the diagonal tile. The diagonal tile, the ragged last tile
//   and warps holding a masked key keep it, as p = exp(ok ? x : -inf):
//   exp(-inf) is 0 exactly, the same p as a select after the exp, with no
//   branch around expf for the warp to diverge on.
//
// ptxas gives the D = 64 kernel ~245 registers a thread, no spills: 2 CTAs
// (8 warps) an SM. A third CTA needs 168, which every form tried (half
// tiles, a launch-bounds cap) reached only with spills.

#include "flash_attention.cuh"

namespace {

using namespace flash;
constexpr int BQ = TILE;  // queries per streamed tile
constexpr int BK = TILE;  // keys per CTA (4 warps x 16)

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
                     __nv_bfloat16* __restrict__ dv, int S, int H, int BH,
                     int causal, float sm_scale) {
  constexpr int T = BQ * (D + PAD);  // elements of one staged tile
  constexpr int NC = D == 128 ? BQ / 2 : BQ;  // queries of a column block
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s: Q at ring + 2 s T, dO at ring + (2 s + 1) T; its L row at
  // sLD + 2 s BQ and its D row at sLD + (2 s + 1) BQ
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sLD = reinterpret_cast<float*>(ring + 4 * T);

  const int kt = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int k0 = kt * BK;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row
  const int nq = (S + BQ - 1) / BQ;

  // start copying query tile qt's Q, dO, L and D rows into stage st
  auto prefetch = [&](int qt, int st) {
    const int q0 = qt * BQ;
    load_tile_async<D>(ring + 2 * st * T, q + base, q0, S, row_stride);
    load_tile_async<D>(ring + (2 * st + 1) * T, dout + base, q0, S,
                       row_stride);
    const int r = tid % BQ, row = q0 + r;
    float* dst = sLD + (2 * st + (tid >= BQ)) * BQ + r;
    if (row < S)
      cp_async4(dst, (tid < BQ ? lse : dsum) + (size_t)bh * S + row);
    else
      *dst = 0.f;
    cp_async_commit();
  };

  // K and V -> stage 1 -> A fragments, while the first query tile lands in
  // stage 0
  const int first = causal ? kt : 0;  // no query above the diagonal
  load_tile_async<D>(ring + 2 * T, k + base, k0, S, row_stride);
  load_tile_async<D>(ring + 3 * T, v + base, k0, S, row_stride);
  cp_async_commit();
  prefetch(first, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, ring + 2 * T, wr, g, t4);
  load_a_frags<D>(vf, ring + 3 * T, wr, g, t4);

  // this thread's two keys: [0] = tile row wr+g, [1] = wr+g+8
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};
  const int* mrow = mask ? mask + (size_t)b * S : nullptr;
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    live[i] = keys[i] < S && (mrow == nullptr || mrow[keys[i]] != 0);
  const bool warp_live = __all_sync(0xffffffffu, live[0] && live[1]);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  for (int qt = first; qt < nq; ++qt) {
    const int st = (qt - first) & 1;
    cp_async_wait<0>();
    // tile qt is in stage st for every thread, and every warp is done with
    // stage st ^ 1 (the last tile, or K and V), which the next copy takes
    __syncthreads();
    if (qt + 1 < nq) prefetch(qt + 1, st ^ 1);
    const __nv_bfloat16* tQ = ring + 2 * st * T;
    const __nv_bfloat16* tO = ring + (2 * st + 1) * T;
    const float* tL = sLD + 2 * st * BQ;
    const float* tD = tL + BQ;
    const int q0 = qt * BQ;

    const bool interior = warp_live && q0 + BQ <= S && (!causal || qt > kt);
    // the tile in blocks of NC queries, each with all its products: every
    // accumulator still sums kk ascending over the whole tile
#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      const __nv_bfloat16* cQ = tQ + c0 * (D + PAD);
      const __nv_bfloat16* cO = tO + c0 * (D + PAD);
      float sT[NC / 8][4], dpt[NC / 8][4];
      mma_abt<D, NC>(sT, kf, cQ, lane);   // S^T = K Q^T
      mma_abt<D, NC>(dpt, vf, cO, lane);  // dP^T = V dO^T

      // p^T in sT, ds^T in dpt; exactly 0 on masked pairs
      if (interior) {
#pragma unroll
        for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + n * 8 + t4 * 2 + (e & 1);
            const float p = expf(sT[n][e] * sm_scale - tL[col]);
            sT[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - tD[col]) * sm_scale;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int col = c0 + n * 8 + t4 * 2 + (e & 1);
            const int query = q0 + col;
            const bool ok =
                live[i] && query < S && (!causal || keys[i] <= query);
            const float p =
                expf(ok ? sT[n][e] * sm_scale - tL[col] : -INFINITY);
            sT[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - tD[col]) * sm_scale;
          }
        }
      }

      mma_xt<D, NC>(dva, sT, cO, lane);   // dv += p^T dO
      mma_xt<D, NC>(dka, dpt, cQ, lane);  // dk += ds^T Q
    }
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
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)((S + BK - 1) / BK) * B * H;
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
    return flash::launch<64>(flash_bwd_dkv_kernel<64>, ctas, st, qb, kb,
                                 vb, db, lb, sb, mb, dkb, dvb, S, H, B * H,
                                 causal, sm_scale);
  if (D == 128)
    return flash::launch<128>(flash_bwd_dkv_kernel<128>, ctas, st, qb, kb,
                                  vb, db, lb, sb, mb, dkb, dvb, S, H, B * H,
                                  causal, sm_scale);
  return (int)cudaErrorInvalidValue;
}
