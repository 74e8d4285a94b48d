// Flash-attention backward, dq (B2a), for Hopper (sm_90a): bf16 in, f32
// recompute and accumulation, bf16 dq out.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py
//           _bwd_dq_kernel (launched by _bwd, variant "split").
//
// What it computes: for every (batch, head) and query row i,
//   dq_i = sum_j ds_ij k_j,  ds_ij = p_ij (dp_ij - D_i) * scale,
//   p_ij = exp(s_ij - L_i),  s_ij = q_i . k_j * scale,  dp_ij = dO_i . v_j,
// over the keys j that are valid (mask[b, j] != 0, j < S) and, when causal,
// j <= i; masked pairs have p = 0 exactly (the reference's (s > NEG_INF/2)
// factor), so a row with no valid key gets dq = 0 exactly. L is the forward's
// row logsumexp (B1 writes it) and D = rowsum(dO * O), both f32.
//
// Layout: q, k, v, dO, dq are [B, S, H, D] contiguous (the framework's BSHD),
// read through their strides; lse and dsum are [B, H, S] f32; mask is [B, S]
// int32 (or null = all valid). D is 64 or 128, S is any length.
//
// What bounds it on the H100: at the training shapes (B=8, S=512, H=12, D=64,
// causal) the work is ~4.8 GFLOP (three block products per live pair) over
// ~32 MB: ~150 FLOP/byte, below the bf16 ridge of ~295 FLOP/byte, so device
// memory bounds it (~9.5 us). On the H100 it takes ~3.5x that (0.033 ms):
// neither bytes nor tensor-core rate set its pace but latency, each warp's
// chain of ldmatrix, mma.sync and full-precision expf at 12 warps an SM.
//
// Design: B1's structure. One CTA of 4 warps per (64-row q tile, b*h); each
// warp owns 16 query rows. The Q and dO tiles are staged once through shared
// memory into mma.sync A-fragments held in registers, with the rows' L and D.
// K and V tiles of 64 keys stream through shared memory up to the causal
// diagonal; S = Q K^T and dP = dO V^T run on bf16 mma.sync m16n8k16 with f32
// accumulation, p and ds are formed in f32 registers, and ds is re-packed as
// bf16 A-fragments for dq += ds K, accumulated in f32 registers over the key
// tiles in ascending order, kk ascending inside each tile. The fused kernel
// B3 (csrc/flash_attention_bwd_fused.cu) chains the same products onto dq in
// the same order, so its dq equals this one bit for bit. Around that
// arithmetic:
//
// - Asynchronous loads: the key tiles' K and V rows and their valid flags
//   stream through a two-stage cp.async ring in dynamic shared memory (~37 KB
//   a CTA at D = 64, ~69 KB at D = 128). The copy of tile kt + 1 is issued
//   right after the one barrier of step kt and lands while tile kt computes.
// - Operands through ldmatrix (csrc/flash_attention.cuh): the B
//   fragments of S and dP are K's and V's rows (ldmatrix), those of dq += ds K
//   K's columns (ldmatrix.trans), four 8x8 matrices an instruction: the same
//   bf16 pairs that element-wise shared loads would put in the same
//   registers, so no product changes.
// - Heaviest first: CTA x of the 1-D grid takes b*h x % (B*H) and, under
//   causal masking, query tile nq - 1 - x / (B*H) (x / (B*H) otherwise), so
//   the query tiles with the longest key walks (the last walks every key
//   tile) start in the first wave. Nothing is summed across CTAs, so the
//   order moves no bit.
// - The predicate where it is needed: a warp skips the per-element test on a
//   key tile whose 64 keys are all valid and, when causal, that lies below
//   the diagonal tile. The diagonal tile, the ragged last tile and tiles
//   holding a masked key keep it, as p = exp(ok ? x : -inf): exp(-inf) is 0
//   exactly, the same p as a select after the exp, with no branch around
//   expf for the warp to diverge on.
//
// ptxas gives the D = 64 kernel 168 registers a thread, no spills: 3 CTAs
// (12 warps) an SM. It must stay there: a select after the exp takes 171,
// 2 CTAs an SM and ~14% more time; a launch-bounds cap on 168 spills.

#include "flash_attention.cuh"

namespace {

using namespace flash;
constexpr int BQ = TILE;  // query rows per CTA (4 warps x 16)
constexpr int BK = TILE;  // keys per streamed tile

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    const int* __restrict__ mask,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int BH,
                    int causal, float sm_scale) {
  constexpr int T = BK * (D + PAD);  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s: K at ring + 2 s T, V at ring + (2 s + 1) T, the keys' valid
  // flags (nonzero = valid) at sValid + s BK
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int* sValid = reinterpret_cast<int*>(ring + 4 * T);

  const int nq = (S + BQ - 1) / BQ;
  const int x = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - x : x;
  const int q0 = qt * BQ;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread in group
  const int row_stride = H * D;
  const size_t base = ((size_t)b * S * H + h) * D;  // element (b, 0, h, 0)
  const int wr = warp * 16;                         // warp's first tile row
  const int* mrow = mask ? mask + (size_t)b * S : nullptr;

  // start copying key tile kt's K and V rows and valid flags into stage st
  auto prefetch = [&](int kt, int st) {
    const int k0 = kt * BK;
    load_tile_async<D>(ring + 2 * st * T, k + base, k0, S, row_stride);
    load_tile_async<D>(ring + (2 * st + 1) * T, v + base, k0, S, row_stride);
    if (tid < BK) {
      const int key = k0 + tid;
      int* dst = sValid + st * BK + tid;
      if (key < S && mrow != nullptr)
        cp_async4(dst, mrow + key);
      else
        *dst = key < S;
    }
    cp_async_commit();
  };

  // Q and dO -> stage 1 -> A fragments, while the first key tile lands in
  // stage 0
  load_tile_async<D>(ring + 2 * T, q + base, q0, S, row_stride);
  load_tile_async<D>(ring + 3 * T, dout + base, q0, S, row_stride);
  cp_async_commit();
  prefetch(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D>(qf, ring + 2 * T, wr, g, t4);
  load_a_frags<D>(dof, ring + 3 * T, wr, g, t4);

  // this thread's two query rows: [0] = tile row wr+g, [1] = wr+g+8
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float L[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = rows[i] < S;
    L[i] = in ? lse[(size_t)bh * S + rows[i]] : 0.f;
    Dr[i] = in ? dsum[(size_t)bh * S + rows[i]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, qt + 1);  // no key past the diagonal tile

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    // tile kt is in stage st for every thread, and every warp is done with
    // stage st ^ 1 (the last tile, or Q and dO), which the next copy takes
    __syncthreads();
    if (kt + 1 < nk) prefetch(kt + 1, st ^ 1);
    const __nv_bfloat16* tK = ring + 2 * st * T;
    const __nv_bfloat16* tV = ring + (2 * st + 1) * T;
    const int* tValid = sValid + st * BK;
    const int k0 = kt * BK;

    float s[BK / 8][4], dp[BK / 8][4];
    mma_abt<D>(s, qf, tK, lane);    // S = Q K^T
    mma_abt<D>(dp, dof, tV, lane);  // dP = dO V^T

    // p = exp(s * scale - L) on live pairs, exactly 0 elsewhere;
    // ds = p (dp - D) scale, kept in s
    const bool interior =
        (!causal || kt < qt) &&
        __all_sync(0xffffffffu, tValid[lane] != 0 && tValid[lane + 32] != 0);
    if (interior) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = expf(s[n][e] * sm_scale - L[i]);
          s[n][e] = p * (dp[n][e] - Dr[i]) * sm_scale;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = n * 8 + t4 * 2 + (e & 1);
          const bool ok =
              tValid[col] != 0 && (!causal || k0 + col <= rows[i]);
          const float p = expf(ok ? s[n][e] * sm_scale - L[i] : -INFINITY);
          s[n][e] = p * (dp[n][e] - Dr[i]) * sm_scale;
        }
      }
    }

    mma_xt<D>(acc, s, tK, lane);  // dq += ds K: K's rows are the k index
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    __nv_bfloat16* out = dq + base + (size_t)rows[i] * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(out + dn * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[dn][2 * i], acc[dn][2 * i + 1]);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dsum,
                                      const void* mask, void* dq, int B, int S,
                                      int H, int D, int causal, float sm_scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)((S + BQ - 1) / BQ) * B * H;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* sb = static_cast<const float*>(dsum);
  const auto* mb = static_cast<const int*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(dq);
  if (D == 64)
    return flash::launch<64>(flash_bwd_dq_kernel<64>, ctas, st, qb, kb,
                                 vb, db, lb, sb, mb, ob, S, H, B * H, causal,
                                 sm_scale);
  if (D == 128)
    return flash::launch<128>(flash_bwd_dq_kernel<128>, ctas, st, qb, kb,
                                  vb, db, lb, sb, mb, ob, S, H, B * H, causal,
                                  sm_scale);
  return (int)cudaErrorInvalidValue;
}
