// Single-query decode attention through block tables over a shared paged
// int8 KV pool with per-slot f32 scales, for Hopper (sm_90a): split-K
// flash-decoding.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _paged_kernel with int8 pools (quant=True), launched by
//           _paged_dispatch through pl.pallas_call.
//
// What it computes: row b's logical cache slot j lives in physical block
// pb = block_tables[b, j / Bs] at offset j % Bs of the int8 [N, Bs, H, D]
// pools, with one f32 scale per slot in the [N, Bs] scale pools (the
// token's whole [H, D] row shares it). For every (b, h), over the live
// window lo = pad[b] <= j <= pos[b] = hi, cut into splits c of
// consecutive slots, each walked in tiles of 64 slots with a running max m
// (l and a rescale by exp(m_old - m) when it moves),
//   s_j = (q . k_j) / sqrt(D) * k_scale[pb, j % Bs]           (f32)
//   p_j = exp(s_j - m),  l_c = sum_{j in c} p_j
//   a_c = sum_{j in c} (p_j * v_scale[pb, j % Bs]) v_j        (f32)
//   o   = sum_c a_c e^(m_c - M) / sum_c l_c e^(m_c - M),  M = max_c m_c
// (q's dtype out). This is the arithmetic of the Pallas kernel: the K
// scale multiplies the score of its column and the V scale folds into the
// probability, so no dequantised row is ever built, and p and V stay in
// f32. (The plain version beside the wrapper follows the reference's XLA
// path instead: dequantise to q's dtype, then the slab path, which rounds
// p to bf16 before PV. The two differ by bf16 rounding.) Slots outside the
// window are never read, neither their int8 bytes nor their scales: the
// engine's null block 0 may hold any bytes and NaN scales without changing
// a bit of the output. An empty window (pad > pos) gives o = 0. A block id
// outside [0, N) is not read: the row's output is NaN, so a corrupt table
// shows instead of faulting the card.
//
// Layout: q and o are [B, H, D] bf16; the pools are contiguous int8
// [N, Bs, H, D], 16-byte aligned; the scales contiguous f32 [N, Bs];
// block_tables is [B, NB] int32 (ids repeat across rows where prefix
// blocks are shared); pos and pad are [B] int32; the wrapper allocates the
// f32 partials [B * H, S, D + 2].
//
// Constraint: any block size Bs >= 1, any NB * Bs up to 2^31 - 1 logical
// slots per row, D in {64, 128}.
//
// What bounds it on the H100: one query row per (b, h) streams the live
// int8 K and V rows once, 2 * D bytes per live slot and head plus 8 bytes
// of scales per live slot (136 bytes at D = 64 for one head) for 4 * D
// FLOP: ~4 FLOP per byte, far below the ~295 FLOP/byte ridge, so device
// memory bounds it, at half the bytes of the bf16 kernel
// (paged_decode_attention.cu). The design is that kernel's
// (paged_decode_attention.cuh): S splits of `per` 64-slot tiles per row
// (per = 1 until the grid would pass 16 CTAs per SM), one CTA of 4 warps
// per (b, h, split), each tile's block ids staged once (loaded a tile
// ahead), every lane's 16-byte loads (4 lanes per D = 64 int8 row: 2 K
// and 2 V rows per thread, and the slot's two scales) issued before any
// reduction, one pass into an (m, l, acc) partial, and a second kernel
// that merges the partials of each (b, h) in split order.

#include "paged_decode_attention.cuh"

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launches: 0 on success.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* pos, const void* pad, void* part, void* o, int B, int N,
    int Bs, int NB, int H, int D, int per, int splits, float sm_scale,
    void* stream) {
  return paged::launch<true>(q, k_pool, v_pool, k_scale, v_scale,
                             block_tables, pos, pad, part, o, B, N, Bs, NB,
                             H, D, per, splits, sm_scale, stream);
}
