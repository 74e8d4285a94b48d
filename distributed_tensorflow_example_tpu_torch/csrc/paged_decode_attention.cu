// Single-query decode attention through block tables over a shared paged
// bf16 KV pool, for Hopper (sm_90a): split-K flash-decoding.
//
// Replaces: distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py
//           _paged_kernel with float pools (quant=False), launched by
//           _paged_dispatch through pl.pallas_call.
//
// What it computes: row b's logical cache slot j lives in physical block
// block_tables[b, j / Bs] at offset j % Bs of the [N, Bs, H, D] pools. For
// every (b, h), over the live window lo = pad[b] <= j <= pos[b] = hi, cut
// into splits c of consecutive slots, each walked in tiles of 64 slots
// with a running max m (l and a rescale by exp(m_old - m) when it moves),
//   s_j = q . k_j / sqrt(D)                                   (f32)
//   p_j = exp(s_j - m),  l_c = sum_{j in c} p_j               (f32)
//   a_c = sum_{j in c} bf16(p_j) v_j                          (f32)
//   o   = sum_c a_c e^(m_c - M) / sum_c l_c e^(m_c - M),  M = max_c m_c
// (bf16 out). This is the Pallas float kernel's algebra: the unnormalised
// probability, taken against the running max of its split, is rounded to
// bf16 before the PV product, and the f32 sum divides at the end. Slots
// outside the window are never read, so they contribute exactly 0
// whatever bytes their block holds: the engine's null block 0 may hold any
// bytes, NaN included. An empty window (pad > pos) gives o = 0. A block id
// outside [0, N) is not read either: the row's output is NaN, so a corrupt
// table shows instead of faulting the card.
//
// Layout: q and o are [B, H, D]; the pools are contiguous [N, Bs, H, D],
// 16-byte aligned; block_tables is [B, NB] int32 (ids repeat across rows
// where prefix blocks are shared); pos and pad are [B] int32; the wrapper
// allocates the f32 partials [B * H, S, D + 2].
//
// Constraint: any block size Bs >= 1 (the TPU kernel's Bs % 128 gate does
// not carry over; the serving default Bs = 16 runs here), any NB * Bs up
// to 2^31 - 1 logical slots per row (no score is kept past its tile),
// D in {64, 128}.
//
// What bounds it on the H100: one query row per (b, h) streams the live K
// and V rows once, 2 * 2 * D bytes per live slot and head (256 bytes at
// D = 64) for 4 * D FLOP: 2 FLOP per byte, far below the ~295 FLOP/byte
// bf16 ridge, so device memory bounds it. The design keeps enough bytes in
// flight to stream them (paged_decode_attention.cuh has the details): the
// wrapper splits each row into S splits of `per` 64-slot tiles, one CTA of
// 4 warps per (b, h, split), with per = 1 until the grid would pass 16
// CTAs per SM: 8 x 12 x 10 = 960 CTAs of one tile at the engine's shape,
// 2,112 of 12 tiles for 8 rows of 16,384 slots. Per tile a CTA stages the block
// ids (their loads issued a tile ahead), then every lane issues all of its
// 16-byte K and V loads (8 lanes per D = 64 row, 4 K and 4 V rows per
// thread) before it reduces any, so no row load waits on a table load or
// on another row. One pass: the tile's scores stay in shared memory (64
// floats), the split's (m, l, acc) go to the partials, and a second kernel
// of one CTA per (b, h) merges the S partials in split order.

#include "paged_decode_attention.cuh"

// C entry point (bound with ctypes). Returns cudaGetLastError() after the
// launches: 0 on success.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* pos, const void* pad,
                                      void* part, void* o, int B, int N,
                                      int Bs, int NB, int H, int D, int per,
                                      int splits, float sm_scale,
                                      void* stream) {
  return paged::launch<false>(q, k_pool, v_pool, nullptr, nullptr,
                              block_tables, pos, pad, part, o, B, N, Bs, NB,
                              H, D, per, splits, sm_scale, stream);
}
