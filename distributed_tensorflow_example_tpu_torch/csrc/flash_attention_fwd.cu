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
// null = all valid); lse is [B, H, S] f32. D is 64 or 128, S is any length.
//
// What bounds it on the H100: at the prefill shapes (B=8, S=512, H=12, D=64,
// causal, left pads) the work is ~2.7 GFLOP over ~25 MB, i.e. ~105
// FLOP/byte, below the bf16 ridge of ~295 FLOP/byte: device memory bounds it
// (~7.6 us). At B=1 S=4096 the causal walks are 64 tiles long, ~26 GFLOP, and
// the tensor cores' rate bounds it (~26 us). On the H100 it takes ~4x and
// ~6x those: neither bytes nor tensor-core rate set its pace but latency,
// each warp's chain of ldmatrix, mma.sync and full-precision expf at 12 warps
// an SM (mma.sync reaches a fraction of the rate that wgmma does).
//
// Design: one CTA of 4 warps per (64-row q tile, batch*head); each warp owns
// 16 query rows. The Q tile is staged once through shared memory into
// mma.sync A-fragments held in registers for the whole key loop. K and V
// tiles of 64 keys stream up to the causal diagonal; S = Q K^T and O += P V
// run on bf16 mma.sync m16n8k16 with f32 accumulation, each accumulator
// summed over kk in ascending order; the online softmax (running max m,
// normaliser l, rescale of O) stays in f32 registers and the score tile never
// leaves registers. The ragged last tile is zero-filled and masked. Around
// that arithmetic, with the helpers of csrc/flash_attention.cuh that B2a and
// B2b use:
//
// - Asynchronous loads: the key tiles' K and V rows and their valid flags
//   stream through a two-stage cp.async ring in dynamic shared memory (~37 KB
//   a CTA at D = 64, ~69 KB at D = 128); Q lands in the second stage while
//   the first key tile lands in the first. The copy of tile kt + 1 is issued
//   right after the one barrier of step kt, which also says every warp is
//   done with the stage it overwrites, and lands while tile kt computes.
// - Operands through ldmatrix: the B fragments of S = Q K^T are K's rows
//   (ldmatrix), those of O += P V V's columns (ldmatrix.trans), four 8x8
//   matrices an instruction: the bf16 pairs that element-wise shared loads
//   would put in the same registers, so no product changes.
// - Heaviest first: CTA x of the 1-D grid takes b*h x % (B*H) and, under
//   causal masking, query tile nq - 1 - x / (B*H) (x / (B*H) otherwise), so
//   the query tiles with the longest key walks start in the first wave.
//   Nothing is summed across CTAs, so the order moves no bit. The grid takes
//   up to 2^31 - 1 CTAs, so B*H has no cap of its own.
// - The predicate where it is needed: the one barrier of a step also says
//   whether all the tile's keys are valid (__syncthreads_and), the same
//   answer in every thread. A tile whose 64 keys are all valid and that lies
//   below the diagonal tile (or any such tile without causal masking) skips
//   the per-element test; the diagonal tile, the ragged last tile and tiles
//   holding a masked key keep it. Every tile forms p = exp(ok ? x - m : -inf):
//   exp(-inf) is +0 exactly, the bits of a select after the exp, with no
//   branch around expf for a warp to diverge on.
//
// Registers (ptxas): 168 a thread at D = 64, no spills, 3 CTAs (12 warps) an
// SM; 208 at D = 128, no spills, 2 CTAs an SM. The launch bounds' minimum (3
// CTAs an SM at D = 64, 1 at D = 128) is what gets ptxas there: without one
// it takes 156 and 176 registers, the same CTAs an SM, and D = 128 takes
// ~18% longer. A minimum that makes ptxas spill is no gain.

#include "flash_attention.cuh"

namespace {

using namespace flash;
constexpr int BQ = TILE;  // query rows per CTA (4 warps x 16)
constexpr int BK = TILE;  // keys per streamed tile
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 3 : 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int BH, int causal,
                 float sm_scale) {
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

  // start copying key tile kt's K and V rows and valid flags into stage st;
  // thread tid < 64 copies key tile row tid's flag
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

  // Q -> stage 1 -> A fragments, while the first key tile lands in stage 0
  load_tile_async<D>(ring + 2 * T, q + base, q0, S, row_stride);
  cp_async_commit();
  prefetch(0, 0);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_frags<D>(qf, ring + 2 * T, wr, g, t4);

  // this thread's two query rows: [0] = tile row wr+g, [1] = wr+g+8
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
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
    // stage st ^ 1 (the last tile, or Q), which the next copy takes; each
    // thread reads the flag it copied itself, the barrier ands them
    const bool all_valid =
        __syncthreads_and(tid >= BK || sValid[st * BK + tid] != 0);
    if (kt + 1 < nk) prefetch(kt + 1, st ^ 1);
    const __nv_bfloat16* tK = ring + 2 * st * T;
    const __nv_bfloat16* tV = ring + (2 * st + 1) * T;
    const int* tValid = sValid + st * BK;
    const int k0 = kt * BK;

    float s[BK / 8][4];
    mma_abt<D>(s, qf, tK, lane);  // S = Q K^T

    // scale + mask, row max
    float mx[2] = {NEG_INF, NEG_INF};
    if (all_valid && (!causal || kt < qt)) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= sm_scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + t4 * 2 + (e & 1);
          const bool ok =
              tValid[col] != 0 && (!causal || k0 + col <= rows[e >> 1]);
          const float x = ok ? s[n][e] * sm_scale : NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
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
    // masked scores contribute an exact 0 (exp(-inf)), not exp underflow: a
    // row with no valid key in this tile has mnew == NEG_INF, and
    // exp(x - mnew) = exp(0) would count its masked scores
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p =
            expf(x > NEG_INF * 0.5f ? x - mnew[e >> 1] : -INFINITY);
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

    // O += P V: p re-packs as bf16 A fragments, V's rows are the k index
    mma_xt<D>(acc, s, tV, lane);
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
    if (t4 == 0)
      lse[(size_t)bh * S + rows[i]] = m[i] + logf(fmaxf(l[i], 1e-20f));
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launch: 0 on success.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* lse, int B,
                                   int S, int H, int D, int causal,
                                   float sm_scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)((S + BQ - 1) / BQ) * B * H;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* mb = static_cast<const int*>(mask);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto* lb = static_cast<float*>(lse);
  if (D == 64)
    return flash::launch<64>(flash_fwd_kernel<64>, ctas, st, qb, kb, vb,
                                 mb, ob, lb, S, H, B * H, causal, sm_scale);
  if (D == 128)
    return flash::launch<128>(flash_fwd_kernel<128>, ctas, st, qb, kb, vb,
                                  mb, ob, lb, S, H, B * H, causal, sm_scale);
  return (int)cudaErrorInvalidValue;
}
