"""The port's hand-written Hopper kernels against their plain PyTorch
versions, on the card, at the serving path's widths (GPT-small: 12 heads
of 64). Marked ``gpu``; each test skips where there is no card.

This file imports no JAX, so it also runs where only PyTorch is
installed::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Tolerances, as in ``chip_smoke.py``: each output row (one query of one
head) is held to its relative error max|o - o_ref| / max|o_ref|, since
|o| runs from ~|v| on rows with one live key down to ~|v| / sqrt(n) on
rows with n. Both sides round the probabilities and the output to bf16,
so an element may differ by an ulp or two (one ulp is up to 2^-7 = 7.8e-3
of it). The worst rows of ``chip_smoke.py``'s kernel phases on an H100
are 8.0e-3 (flash) and 1.7e-3 (decode); the limits are a few times that.
The paged kernel follows the Pallas float kernel's algebra, split-K:
each split rounds its unnormalised probabilities exp(s - running max)
to bf16 before the PV product and the f32 sum divides at the end, where
the plain version rounds the normalised softmax; the two differ by bf16
rounding, and its limit is 2e-2, as ``chip_smoke.py``'s. The int8 paged
kernel follows the Pallas kernel's algebra (scales folded into the
scores and the f32 probabilities) where its plain version dequantizes to
bf16 and rounds the probabilities to bf16: held to the same 2e-2. The
flash backward kernels
(dq, and dk with dv, split or fused) round p and ds to bf16 before their
products where the plain versions keep them in f32, and round their
outputs to bf16: each
gradient row (one query's dq, one key's dk or dv, of one head) is held to
2e-2 too, with each row's size floored at a hundredth of the mean row
size: a row whose gradient cancels to zero (the first query of a causal
row has one live key, where ds = p (dp - D) is zero but for rounding) is
held to that absolute error instead. A query row with no live key gets dq
exactly 0, and a masked key gets dk and dv exactly 0. The fused kernel
(B3) runs the split kernels' products in their order, so its outputs
equal theirs bit for bit, and two of its launches agree bit for bit (its
dq accumulation is ordered, not atomic).

One test runs the port's MNIST example on the card (no hand-written
kernel on that path): it must train to the reference's 0.95 test
accuracy. The last three serve through ``serving_http``: a BERT-base
``:predict`` batch launches the flash forward once a layer, an armed
server's request launches the paged kernel as often as a plain one's, and
a 2-replica router fleet serves one replica's bytes with one paged launch
a layer a merged decode step.
"""

import os
import re

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.models.gpt import \
    quantize_kv_rows
from distributed_tensorflow_example_tpu_torch.ops.cuda import (
    decode_attention as da, flash_attention as fa,
    paged_decode_attention as pa)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

FLASH_ROW_REL_TOL = 2e-2
DECODE_ROW_REL_TOL = 1e-2
PAGED_ROW_REL_TOL = 2e-2
FLASH_BWD_ROW_REL_TOL = 2e-2


def _row_rel_err(o, o_ref):
    diff = (o.float() - o_ref.float()).abs().amax(dim=-1)
    size = o_ref.float().abs().amax(dim=-1)
    return (diff / size.clamp_min(torch.finfo(torch.float32).tiny)
            ).max().item()


def _grad_row_err(g, g_ref):
    """:func:`_row_rel_err` with each row's size floored at a hundredth of
    the mean row size (see the module docstring)."""
    diff = (g.float() - g_ref.float()).abs().amax(dim=-1)
    size = g_ref.float().abs().amax(dim=-1)
    return (diff / torch.maximum(size, 1e-2 * size.mean())).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels build and run only there)")
    return torch.device("cuda")


def _randn(gen, shape, dev):
    return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)


@pytest.mark.parametrize("s", [512, 500, 77])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, s, causal):
    gen = torch.Generator().manual_seed(s)
    q, k, v = (_randn(gen, (2, s, 12, 64), cuda) for _ in range(3))
    mask = torch.ones((2, s), dtype=torch.int32, device=cuda)
    mask[1, : s // 3] = 0
    before = fa.flash_attention_fwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    assert fa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask,
                                                  causal=causal)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= FLASH_ROW_REL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    if causal:                       # left-pad rows see no key: zeros
        assert o[1, : s // 3].abs().max().item() == 0


def test_flash_kernel_head_dim_128_and_no_mask(cuda):
    gen = torch.Generator().manual_seed(1)
    q, k, v = (_randn(gen, (1, 200, 4, 128), cuda) for _ in range(3))
    o, _ = fa.flash_attention_fwd(q, k, v, None, causal=True)
    o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, None, causal=True)
    assert _row_rel_err(o, o_ref) <= FLASH_ROW_REL_TOL


@pytest.mark.parametrize("b,s,h,d", [(8, 512, 12, 64), (1, 4096, 12, 64),
                                     (2, 500, 4, 128)])
def test_flash_kernel_is_deterministic(cuda, b, s, h, d):
    """Two launches of B1 bitwise equal: nothing is summed across CTAs,
    whatever order its heaviest-first grid runs them in."""
    gen = torch.Generator().manual_seed(b * s + d)
    q, k, v = (_randn(gen, (b, s, h, d), cuda) for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32, device=cuda)
    mask[b - 1, : s // 5] = 0
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert _row_rel_err(o, o_ref) <= FLASH_ROW_REL_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_with_key_tiles_that_hold_no_valid_key(cuda, causal):
    """Row 0's first 200 keys masked (three whole key tiles with no valid
    key) and every key of row 1 masked: none of those tiles may take B1's
    all-valid shortcut; row 1's output is exactly 0, as are row 0's
    queries that see no key under causal masking, and both rows match the
    plain version, lse included."""
    gen = torch.Generator().manual_seed(19 + causal)
    s = 320
    q, k, v = (_randn(gen, (2, s, 12, 64), cuda) for _ in range(3))
    mask = torch.ones((2, s), dtype=torch.int32, device=cuda)
    mask[0, :200] = 0
    mask[1] = 0
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask,
                                                  causal=causal)
    torch.cuda.synchronize()
    assert o[1].abs().max().item() == 0
    if causal:
        assert o[0, :200].abs().max().item() == 0
    assert _row_rel_err(o, o_ref) <= FLASH_ROW_REL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_flash_kernel_takes_bh_65536(cuda):
    """B*H = 65,536 (B=4096, H=16): one past what a grid with B*H on its y
    axis takes. S=80 gives each row a ragged second key tile; every eighth
    row has 20 left pads, whose queries see no key."""
    gen = torch.Generator().manual_seed(65536)
    q, k, v = (_randn(gen, (4096, 80, 16, 64), cuda) for _ in range(3))
    mask = torch.ones((4096, 80), dtype=torch.int32, device=cuda)
    mask[::8, :20] = 0
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= FLASH_ROW_REL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert o[::8, :20].abs().max().item() == 0


def test_flash_bwd_kernels_take_bh_65536(cuda):
    """B2a, B2b and B3 at B*H = 65,536 (the forward's case) against their
    plain versions, and B3 bitwise the split pair."""
    gen = torch.Generator().manual_seed(65537)
    q, k, v, do = (_randn(gen, (4096, 80, 16, 64), cuda) for _ in range(4))
    mask = torch.ones((4096, 80), dtype=torch.int32, device=cuda)
    mask[::8, :20] = 0
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    split = _split(args, True)
    fused = fa.flash_attention_bwd_fused(*args, causal=True)
    want = _split_plain(args, True)
    torch.cuda.synchronize()
    for g, f, w in zip(split, fused, want):
        assert torch.equal(g, f)
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL
    dq, dk, dv = split
    assert dq[::8, :20].abs().max().item() == 0
    assert dk[::8, :20].abs().max().item() == 0
    assert dv[::8, :20].abs().max().item() == 0


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention_fwd(q, q, q)                  # f32: no fallback
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        q32 = qb[..., :32].contiguous()
        fa.flash_attention_fwd(q32, q32, q32)
    with pytest.raises(ValueError, match="contiguous"):
        t = qb.transpose(1, 2)
        fa.flash_attention_fwd(t, t, t)
    with pytest.raises(TypeError, match="int32 key mask"):
        fa.flash_attention_fwd(qb, qb, qb, torch.ones((1, 64), device=cuda))


def _bwd_case(gen, dev, b, s, h, d, causal, pad):
    """Random bf16 q, k, v, dO; a key mask with ``pad`` dead keys on the
    left of the last row (under causal masking its first ``pad`` queries
    see no key); the forward's lse (B1) and Dsum from its output."""
    q, k, v, do = (_randn(gen, (b, s, h, d), dev) for _ in range(4))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[b - 1, :pad] = 0
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    return q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask


@pytest.mark.parametrize("s", [512, 500, 77])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_match_plain(cuda, s, causal):
    gen = torch.Generator().manual_seed(3 * s + causal)
    pad = s // 3
    args = _bwd_case(gen, cuda, 2, s, 12, 64, causal, pad)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(*args, causal=causal)
    dk, dv = fa.flash_attention_bwd_dkv(*args, causal=causal)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    dq_ref = fa.flash_attention_bwd_dq_plain(*args, causal=causal)
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_plain(*args, causal=causal)
    torch.cuda.synchronize()
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16
        assert _grad_row_err(got, ref) <= FLASH_BWD_ROW_REL_TOL
    # masked keys get no gradient; under causal masking the queries that
    # see no key get none either
    assert dk[1, :pad].abs().max().item() == 0
    assert dv[1, :pad].abs().max().item() == 0
    if causal:
        assert dq[1, :pad].abs().max().item() == 0


@pytest.mark.parametrize("b,s,d", [(64, 128, 64), (3, 200, 128)])
def test_flash_kernels_non_causal_with_trailing_pads(cuda, b, s, d):
    """BERT's layout: non-causal, each row's keys valid up to its length
    and PAD after it (row 0 full, the last row all PAD). B1 and B2a/B2b
    match their plain versions on the rows with a valid key; a padded
    query still attends to its row's keys (its output is not zero); the
    all-PAD row gives zero output and zero dq; a masked key gets zero dk
    and dv; B3 equals B2a/B2b bit for bit on the same inputs."""
    gen = torch.Generator().manual_seed(b + s + d)
    h = 12 if d == 64 else 4
    q, k, v, do = (_randn(gen, (b, s, h, d), cuda) for _ in range(4))
    lens = torch.randint(s // 4, s, (b,), generator=gen)
    lens[0], lens[-1] = s, 0
    mask = (torch.arange(s)[None, :] < lens[:, None]).to(torch.int32).to(cuda)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=False)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, mask)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    got = _split(args, False)
    want = _split_plain(args, False)
    fused = fa.flash_attention_bwd_fused(*args, causal=False)
    torch.cuda.synchronize()
    live = lens > 0
    assert _row_rel_err(o[live], o_ref[live]) <= FLASH_ROW_REL_TOL
    assert (lse[live] - lse_ref[live]).abs().max().item() <= 1e-3
    assert o[1, lens[1]:].abs().amax(dim=(-2, -1)).min().item() > 0
    assert o[-1].abs().max().item() == 0 and got[0][-1].abs().max() == 0
    dead = (mask == 0)[:, :, None, None]
    for g in got[1:]:
        assert (g.float().abs() * dead).max().item() == 0
    for g, r in zip(got, want):
        assert torch.isfinite(g).all()
        assert _grad_row_err(g[live], r[live]) <= FLASH_BWD_ROW_REL_TOL
    assert all(torch.equal(x, y) for x, y in zip(fused, got))


def test_flash_bwd_kernels_head_dim_128_and_no_mask(cuda):
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (_randn(gen, (1, 200, 4, 128), cuda) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, None, causal=True)
    dsum = fa.flash_attention_dsum(do, o)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum, None, True),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, None, True))
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None, True)
    for g, w in zip(got, want):
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL


def test_flash_bwd_kernels_refuse_what_they_do_not_take(cuda):
    gen = torch.Generator().manual_seed(2)
    q, k, v, do, lse, dsum, mask = _bwd_case(gen, cuda, 2, 64, 2, 64, True,
                                             0)
    for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(TypeError, match="bf16"):         # no fallback
            fn(q, k, v, do.float(), lse, dsum, mask, True)
        with pytest.raises(ValueError, match="f32 \\[B,H,S\\] lse"):
            fn(q, k, v, do, lse.to(torch.bfloat16), dsum, mask, True)
        with pytest.raises(ValueError, match="contiguous"):
            t = do.transpose(1, 2).contiguous().transpose(1, 2)
            fn(q, k, v, t, lse, dsum, mask, True)
        with pytest.raises(TypeError, match="int32 key mask"):
            fn(q, k, v, do, lse, dsum, mask.bool(), True)


def _split(args, causal):
    """B2a's dq and B2b's (dk, dv), one launch each."""
    return (fa.flash_attention_bwd_dq(*args, causal=causal),
            *fa.flash_attention_bwd_dkv(*args, causal=causal))


def _split_plain(args, causal):
    return (fa.flash_attention_bwd_dq_plain(*args, causal=causal),
            *fa.flash_attention_bwd_dkv_plain(*args, causal=causal))


@pytest.mark.parametrize("b,s,d", [(1, 4096, 64), (2, 500, 128)])
def test_flash_bwd_kernels_are_deterministic(cuda, b, s, d):
    """B2a and B2b bitwise equal over two launches: nothing is summed
    across CTAs, whatever order they run in. At B=1 S=4096 each causal
    walk is up to 64 tiles long and the longest start first; D=128 takes
    the larger ring and B2b's two column blocks a tile. Both within their
    plain versions' row limit, and B3's outputs bit for bit."""
    gen = torch.Generator().manual_seed(7 * s + d)
    args = _bwd_case(gen, cuda, b, s, 12 if d == 64 else 4, d, True, s // 5)
    got, again = _split(args, True), _split(args, True)
    want = _split_plain(args, True)
    fused = fa.flash_attention_bwd_fused(*args, causal=True)
    torch.cuda.synchronize()
    for g, a, w, f in zip(got, again, want, fused):
        assert torch.equal(g, a)
        assert torch.equal(g, f)
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL
    dq, dk, dv = got
    pad = s // 5
    assert dk[-1, :pad].abs().max().item() == 0
    assert dv[-1, :pad].abs().max().item() == 0
    assert dq[-1, :pad].abs().max().item() == 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernels_with_a_row_of_masked_keys(cuda, causal):
    """Every key of row 1 masked: no pair of that row is live, so its dq,
    dk and dv are exactly 0 (none of its tiles may take the kernels'
    all-live shortcut), while row 0, all keys live, takes the shortcut on
    its interior tiles and still matches the plain versions."""
    gen = torch.Generator().manual_seed(13 + causal)
    s = 320
    args = _bwd_case(gen, cuda, 2, s, 12, 64, causal, s)
    got = _split(args, causal)
    want = _split_plain(args, causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g[1].abs().max().item() == 0
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL


@pytest.mark.parametrize("b,s", [(2, 200), (1, 1000)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_flash_bwd_kernels_ragged_tail_without_pads(cuda, b, s, causal,
                                                    with_mask):
    """S not a multiple of 64 and no key masked (an all-ones mask, or
    none): every tile but the last may take the all-live shortcut, and
    the ragged last tile, whose rows past S are zero-filled, must not."""
    gen = torch.Generator().manual_seed(17 * s + 2 * causal + with_mask)
    q, k, v, do = (_randn(gen, (b, s, 12, 64), cuda) for _ in range(4))
    mask = (torch.ones((b, s), dtype=torch.int32, device=cuda)
            if with_mask else None)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    args = (q, k, v, do, lse, fa.flash_attention_dsum(do, o), mask)
    got = _split(args, causal)
    want = _split_plain(args, causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL


def test_flash_grads_flow_through_the_kernels(cuda):
    """On the card the flash output carries the graph (the detached-output
    fault is gone): one backward launches B2a and B2b once each, and the
    grads match the plain backward on the same saved forward."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (_randn(gen, (2, 256, 12, 64), cuda).requires_grad_()
               for _ in range(3))
    mask = torch.ones((2, 256), dtype=torch.int32, device=cuda)
    mask[1, :40] = 0
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    o = fa.flash_attention(q, k, v, mask=mask, causal=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    (o.float() ** 2).sum().backward()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                n + 1 for n in before)
    with torch.no_grad():
        o2, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True)
        want = fa.flash_attention_bwd_plain(q, k, v, o2,
                                            lse, (2 * o2.float()).to(
                                                torch.bfloat16), mask, True)
    torch.cuda.synchronize()
    for t, w in zip((q, k, v), want):
        assert _grad_row_err(t.grad, w) <= FLASH_BWD_ROW_REL_TOL


@pytest.mark.parametrize("s", [512, 200, 77, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_fused_kernel_matches_plain_and_split(cuda, s, causal):
    """B3 against its plain version (the rows' limit of the split
    kernels), deterministic (two launches bitwise equal: dq is ordered,
    not atomic), dk and dv bitwise B2b's and dq bitwise B2a's (the same
    products in the same order), exact zeros where no pair is live. At
    S=4096 (B=1) the causal walks are longest: 64 tiles."""
    gen = torch.Generator().manual_seed(5 * s + causal)
    pad = s // 3
    args = _bwd_case(gen, cuda, 1 if s == 4096 else 2, s, 12, 64, causal,
                     pad)
    before = fa.flash_attention_bwd_fused.launches
    got = fa.flash_attention_bwd_fused(*args, causal=causal)
    again = fa.flash_attention_bwd_fused(*args, causal=causal)
    assert fa.flash_attention_bwd_fused.launches == before + 2
    want = fa.flash_attention_bwd_fused_plain(*args, causal=causal)
    split = (fa.flash_attention_bwd_dq(*args, causal=causal),
             *fa.flash_attention_bwd_dkv(*args, causal=causal))
    torch.cuda.synchronize()
    for g, a, w, sp in zip(got, again, want, split):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, a)
        assert torch.equal(g, sp)
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL
    dq, dk, dv = got
    assert dk[-1, :pad].abs().max().item() == 0
    assert dv[-1, :pad].abs().max().item() == 0
    if causal:
        assert dq[-1, :pad].abs().max().item() == 0


def test_flash_bwd_fused_kernel_head_dim_128_and_refusals(cuda):
    gen = torch.Generator().manual_seed(12)
    q, k, v, do = (_randn(gen, (1, 200, 4, 128), cuda) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, None, causal=True)
    dsum = fa.flash_attention_dsum(do, o)
    got = fa.flash_attention_bwd_fused(q, k, v, do, lse, dsum, None, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None, True)
    for g, w in zip(got, want):
        assert _grad_row_err(g, w) <= FLASH_BWD_ROW_REL_TOL
    with pytest.raises(TypeError, match="bf16"):             # no fallback
        fa.flash_attention_bwd_fused(q, k, v, do.float(), lse, dsum)
    with pytest.raises(ValueError, match="f32 \\[B,H,S\\] dsum"):
        fa.flash_attention_bwd_fused(q, k, v, do, lse, dsum.half())


@pytest.mark.parametrize("b,s", [(2, 256), (1, 4096)])
def test_flash_grads_flow_through_the_fused_kernel(cuda, b, s):
    """``bwd_variant="fused"``: one backward launches B3 once and B2a, B2b
    never, with the split variant's grads bit for bit; at S=4096 each CTA
    walks 64 query tiles through its two-stage ring and keeps up to four
    ds tiles waiting on the dq chain."""
    gen = torch.Generator().manual_seed(6 + s)
    base = [_randn(gen, (b, s, 12, 64), cuda) for _ in range(3)]
    mask = torch.ones((b, s), dtype=torch.int32, device=cuda)
    mask[b - 1, :40] = 0
    grads = {}
    for variant in ("split", "fused"):
        q, k, v = (t.clone().requires_grad_() for t in base)
        before = (fa.flash_attention_bwd_fused.launches,
                  fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        o = fa.flash_attention(q, k, v, mask=mask, causal=True,
                               bwd_variant=variant)
        (o.float() ** 2).sum().backward()
        after = (fa.flash_attention_bwd_fused.launches,
                 fa.flash_attention_bwd_dq.launches,
                 fa.flash_attention_bwd_dkv.launches)
        fused = variant == "fused"
        assert tuple(a - b for a, b in zip(after, before)) == (
            int(fused), int(not fused), int(not fused))
        grads[variant] = (q.grad, k.grad, v.grad)
    torch.cuda.synchronize()
    for a, b in zip(grads["split"], grads["fused"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t", [640, 613])
@pytest.mark.parametrize("per_row", [True, False])
def test_decode_kernel_matches_plain(cuda, t, per_row):
    gen = torch.Generator().manual_seed(t)
    q = _randn(gen, (8, 12, 64), cuda)
    k, v = (_randn(gen, (8, t, 12, 64), cuda) for _ in range(2))
    pad = torch.randint(0, 128, (8,), generator=gen,
                        dtype=torch.int32).to(cuda)
    pos = (torch.randint(t - 100, t, (8,), generator=gen,
                         dtype=torch.int32).to(cuda) if per_row else t - 1)
    before = da.decode_attention.launches
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    assert da.decode_attention.launches == before + 1
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= DECODE_ROW_REL_TOL


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 2, 64), device=cuda)
    k = torch.zeros((2, 16, 2, 64), device=cuda)
    pad = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        da.decode_attention(q, k, k, pos=3, pad=pad)     # f32: no fallback
    q96 = torch.zeros((2, 2, 96), device=cuda, dtype=torch.bfloat16)
    k96 = torch.zeros((2, 16, 2, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention(q96, k96, k96, pos=3, pad=pad)
    flat = torch.zeros(2 * 16 * 2 * 64 + 4, device=cuda, dtype=torch.bfloat16)
    k_off = flat[4:].view(2, 16, 2, 64)          # 8 bytes past alignment
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention(q.to(torch.bfloat16), k_off, k_off, pos=3,
                            pad=pad)


def _decode_case(gen, dev, *, b=8, t=640, h=12, d=64):
    """B4's inputs: random slabs, per-row pads up to 127 and pos in the
    last 128 slots, row 0's window the whole row."""
    q = _randn(gen, (b, h, d), dev)
    k, v = (_randn(gen, (b, t, h, d), dev) for _ in range(2))
    pad = torch.randint(0, min(128, t), (b,), generator=gen,
                        dtype=torch.int32)
    pos = torch.randint(max(t - 128, 0), t, (b,), generator=gen,
                        dtype=torch.int32)
    pad[0], pos[0] = 0, t - 1
    return q, k, v, pos.to(dev), pad.to(dev)


@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernel_is_deterministic(cuda, d):
    """The split partials are reduced and summed in a fixed order, never
    with atomics: two launches on the same inputs are bitwise equal."""
    gen = torch.Generator().manual_seed(23 + d)
    q, k, v, pos, pad = _decode_case(gen, cuda, d=d)
    o1 = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o2 = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    assert _row_rel_err(o1, o_ref) <= DECODE_ROW_REL_TOL


def test_decode_kernel_empty_window_gives_zeros(cuda):
    """A row whose window is empty (pad > pos) gets exact zeros; the other
    rows of the call still match the plain version."""
    gen = torch.Generator().manual_seed(29)
    q, k, v, pos, pad = _decode_case(gen, cuda)
    pad[3], pos[3] = 300, 299
    pad[5], pos[5] = 640, 639
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert o[3].abs().max().item() == 0 and o[5].abs().max().item() == 0
    ok = torch.ones(8, dtype=torch.bool)
    ok[3] = ok[5] = False
    assert _row_rel_err(o[ok], o_ref[ok]) <= DECODE_ROW_REL_TOL


def test_decode_kernel_takes_a_16384_slot_row(cuda):
    """No cap on the cache length: 8 rows of 16,384 slots (the scores live
    in the scratch row, not in shared memory), against the plain
    version."""
    gen = torch.Generator().manual_seed(31)
    q, k, v, pos, pad = _decode_case(gen, cuda, t=16384)
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= DECODE_ROW_REL_TOL


@pytest.mark.parametrize("b,h,t", [(8, 12, 640), (8, 12, 2560), (2, 2, 640)])
def test_decode_kernel_cuts_the_window_mid_tile(cuda, b, h, t):
    """Tile and split edges cut the live window. 640-slot rows give each
    CTA one tile; on an H100 (132 SMs) 2,560-slot rows give each CTA two,
    so windows also start in a CTA's second tile and cross split edges."""
    gen = torch.Generator().manual_seed(37 * b + h + t)
    q, k, v, _, _ = _decode_case(gen, cuda, b=b, h=h, t=t)
    pad, pos = (torch.tensor(w, dtype=torch.int32, device=cuda)
                for w in zip(*MID_TILE_WINDOWS[:b]))
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= DECODE_ROW_REL_TOL


def test_decode_kernel_with_most_splits_empty(cuda):
    """Windows of under 40 slots in 4,096-slot rows: most splits hold no
    live slot and write empty partials. Against the plain version."""
    gen = torch.Generator().manual_seed(41)
    q, k, v, _, _ = _decode_case(gen, cuda, t=4096)
    pad = torch.randint(0, 4096 - 40, (8,), generator=gen,
                        dtype=torch.int32)
    pos = pad + torch.randint(0, 40, (8,), generator=gen, dtype=torch.int32)
    pad, pos = pad.to(cuda), pos.to(cuda)
    o = da.decode_attention(q, k, v, pos=pos, pad=pad)
    o_ref = da.xla_decode_attention(q, k, v, pos=pos, pad=pad)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= DECODE_ROW_REL_TOL


def _paged_case(gen, dev, *, b=8, h=12, d=64, bs=16, nb=40):
    """Shuffled physical blocks, rows 0-3 sharing their first blocks,
    per-row pos and pad, entries outside each window on the null block
    0."""
    n = 1 + b * nb
    bt = (torch.randperm(n - 1, generator=gen) + 1)[:b * nb].reshape(b, nb)
    bt = bt.to(torch.int32)
    shared = max(1, nb // 5)
    bt[1:4, :shared] = bt[0, :shared]
    pos = torch.randint(nb * bs - 2 * bs, nb * bs, (b,), generator=gen,
                        dtype=torch.int32)
    pad = torch.zeros(b, dtype=torch.int32)
    pad[4:] = torch.randint(1, 3 * bs, (b - 4,), generator=gen,
                            dtype=torch.int32)
    blk = torch.arange(nb)
    for row in range(b):
        bt[row, (blk > pos[row] // bs) | (blk < pad[row] // bs)] = 0
    q = _randn(gen, (b, h, d), dev)
    kp, vp = (_randn(gen, (n, bs, h, d), dev) for _ in range(2))
    return q, kp, vp, dict(block_tables=bt.to(dev), pos=pos.to(dev),
                           pad=pad.to(dev))


@pytest.mark.parametrize("d,bs", [(64, 16), (128, 16), (64, 4)])
def test_paged_kernel_matches_plain_with_nan_null_block(cuda, d, bs):
    gen = torch.Generator().manual_seed(d + bs)
    q, kp, vp, kw = _paged_case(gen, cuda, d=d, bs=bs, nb=640 // bs)
    before = pa.paged_decode_attention.launches
    o = pa.paged_decode_attention(q, kp, vp, **kw)
    assert pa.paged_decode_attention.launches == before + 1
    o_ref = pa.xla_paged_decode_attention(q, kp, vp, **kw)
    # the kernel never reads a masked slot: a NaN null block changes no bit
    # (the plain version multiplies masked V rows by zero, so it is run on
    # the finite pool only)
    kp[0] = vp[0] = float("nan")
    o_nan = pa.paged_decode_attention(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_nan)
    assert o.dtype == vp.dtype
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


def test_paged_kernel_empty_window_and_bad_block_id(cuda):
    """pad > pos gives zeros, as the plain version; a block id past the
    pool is not read and the row comes out NaN."""
    gen = torch.Generator().manual_seed(3)
    q, kp, vp, kw = _paged_case(gen, cuda, b=8, nb=8)
    kw["pad"][5] = kw["pos"][5] + 1
    kw["block_tables"][6, kw["pos"][6] // 16] = kp.shape[0]
    o = pa.paged_decode_attention(q, kp, vp, **kw)
    torch.cuda.synchronize()
    assert o[5].abs().max().item() == 0
    assert torch.isnan(o[6].float()).all()
    ok = [r for r in range(8) if r != 6]
    o_ref = pa.xla_paged_decode_attention(q[ok], kp, vp, block_tables=kw[
        "block_tables"][ok], pos=kw["pos"][ok], pad=kw["pad"][ok])
    assert _row_rel_err(o[ok], o_ref) <= PAGED_ROW_REL_TOL


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 2, 64), device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros((5, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    bt = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    z = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):          # f32: no fallback
        pa.paged_decode_attention(q.float(), kp.float(), kp.float(),
                                  block_tables=bt, pos=z, pad=z)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention(q, kp, kp, block_tables=bt.long(), pos=z,
                                  pad=z)
    with pytest.raises(ValueError, match="head dim"):
        k32 = kp[..., :32].contiguous()
        pa.paged_decode_attention(q[..., :32].contiguous(), k32, k32,
                                  block_tables=bt, pos=z, pad=z)
    with pytest.raises(ValueError, match="contiguous"):
        kt = kp.transpose(0, 1).contiguous().transpose(0, 1)
        pa.paged_decode_attention(q, kt, kt, block_tables=bt, pos=z, pad=z)
    with pytest.raises(ValueError, match="16-byte aligned"):
        km = torch.zeros(kp.numel() + 1, dtype=kp.dtype, device=cuda)[1:]
        km = km.view(kp.shape)
        pa.paged_decode_attention(q, km, km, block_tables=bt, pos=z, pad=z)


def _int8_case(gen, dev, **kw):
    """:func:`_paged_case` with its pools quantized on the card (int8 K/V,
    one f32 scale per slot)."""
    q, kp, vp, tables = _paged_case(gen, dev, **kw)
    kq, ks = quantize_kv_rows(kp)
    vq, vs = quantize_kv_rows(vp)
    return q, kq, vq, dict(tables, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("d,bs", [(64, 16), (128, 16), (64, 128),
                                  (128, 128)])
def test_int8_paged_kernel_matches_plain_with_garbage_null_block(cuda, d,
                                                                  bs):
    gen = torch.Generator().manual_seed(7 * d + bs)
    q, kq, vq, kw = _int8_case(gen, cuda, d=d, bs=bs, nb=640 // bs)
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.launches_int8)
    o = pa.paged_decode_attention(q, kq, vq, **kw)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.launches_int8) == (before[0],
                                                         before[1] + 1)
    o_ref = pa.xla_paged_decode_attention(q, kq, vq, **kw)
    # masked slots are never read, bytes or scales: garbage bytes and NaN
    # scales in the null block 0 change no bit
    kq[0], vq[0] = 127, -128
    kw["k_scale"][0] = kw["v_scale"][0] = float("nan")
    o_nan = pa.paged_decode_attention(q, kq, vq, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_nan)
    assert o.dtype == q.dtype
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


def test_int8_paged_kernel_empty_window_and_bad_block_id(cuda):
    gen = torch.Generator().manual_seed(5)
    q, kq, vq, kw = _int8_case(gen, cuda, b=8, nb=8)
    kw["pad"][5] = kw["pos"][5] + 1
    kw["block_tables"][6, kw["pos"][6] // 16] = kq.shape[0]
    o = pa.paged_decode_attention(q, kq, vq, **kw)
    torch.cuda.synchronize()
    assert o[5].abs().max().item() == 0
    assert torch.isnan(o[6].float()).all()
    ok = [r for r in range(8) if r != 6]
    o_ref = pa.xla_paged_decode_attention(
        q[ok], kq, vq, block_tables=kw["block_tables"][ok],
        pos=kw["pos"][ok], pad=kw["pad"][ok], k_scale=kw["k_scale"],
        v_scale=kw["v_scale"])
    assert _row_rel_err(o[ok], o_ref) <= PAGED_ROW_REL_TOL


def _paged_any(gen, dev, quant, **kw):
    """B5's inputs (:func:`_paged_case`) or, quantized, B6's
    (:func:`_int8_case`)."""
    return (_int8_case if quant else _paged_case)(gen, dev, **kw)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_take_a_16384_slot_row(cuda, quant):
    """No cap on a row's slots: 8 rows of 16,384 (the split-K kernels keep
    no score past its tile), against the plain version."""
    gen = torch.Generator().manual_seed(11 + quant)
    q, k, v, kw = _paged_any(gen, cuda, quant, nb=1024)
    o = pa.paged_decode_attention(q, k, v, **kw)
    o_ref = pa.xla_paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernels_are_deterministic(cuda, quant, d):
    """The split partials are merged in split order, never with atomics:
    two launches on the same inputs are bitwise equal."""
    gen = torch.Generator().manual_seed(13 * d + quant)
    q, k, v, kw = _paged_any(gen, cuda, quant, d=d)
    o1 = pa.paged_decode_attention(q, k, v, **kw)
    o2 = pa.paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


# (pad, pos) per row: edges inside 64-slot tiles and across them, and rows
# with one live slot at a tile's last slot, its first, inside it, and the
# row's first
MID_TILE_WINDOWS = [(5, 70), (63, 63), (64, 64), (300, 300), (17, 639),
                    (0, 0), (100, 130), (630, 638)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,h,nb", [(8, 12, 40), (8, 12, 160), (2, 2, 40)])
def test_paged_kernels_cut_the_window_mid_tile(cuda, quant, b, h, nb):
    """Tile and split edges cut the live window. 640-slot rows give each
    CTA one tile; on an H100 (132 SMs) 2,560-slot rows give each CTA two,
    so windows also start in a CTA's second tile, cross split edges and
    carry the running max from one tile to the next."""
    gen = torch.Generator().manual_seed(17 * b + h + nb + quant)
    q, k, v, kw = _paged_any(gen, cuda, quant, b=max(b, 4), h=h, nb=nb)
    q = q[:b].contiguous()
    pad, pos = (torch.tensor(w, dtype=torch.int32, device=cuda)
                for w in zip(*MID_TILE_WINDOWS[:b]))
    bt = kw["block_tables"][:b].clone()
    bt[bt == 0] = 1                     # every block of the row is real
    kw.update(block_tables=bt, pos=pos, pad=pad)
    o = pa.paged_decode_attention(q, k, v, **kw)
    o_ref = pa.xla_paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_with_most_splits_empty(cuda, quant):
    """Short windows in 4,096-slot rows, the table outside them on the
    null block 0: most splits hold no live slot and write the empty
    partial. Against the plain version, and bitwise against themselves
    with NaN bytes (and, int8, NaN scales) in the null block."""
    gen = torch.Generator().manual_seed(19 + quant)
    bs, nb = 16, 256
    q, k, v, kw = _paged_any(gen, cuda, quant, nb=nb)
    pad = torch.randint(0, nb * bs - 40, (8,), generator=gen,
                        dtype=torch.int32)
    pos = pad + torch.randint(0, 40, (8,), generator=gen, dtype=torch.int32)
    bt = kw["block_tables"].cpu()
    bt[bt == 0] = 1                     # the new windows' blocks are real
    blk = torch.arange(nb)
    for row in range(8):
        bt[row, (blk > pos[row] // bs) | (blk < pad[row] // bs)] = 0
    kw.update(block_tables=bt.to(cuda), pos=pos.to(cuda), pad=pad.to(cuda))
    o = pa.paged_decode_attention(q, k, v, **kw)
    o_ref = pa.xla_paged_decode_attention(q, k, v, **kw)
    if quant:
        k[0], v[0] = 127, -128
        kw["k_scale"][0] = kw["v_scale"][0] = float("nan")
    else:
        k[0] = v[0] = float("nan")
    o_nan = pa.paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_nan)
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernels_at_the_verify_shape(cuda, quant):
    """Speculative verify's shape: 8 rows of 4 lanes become 32 query rows,
    each lane's row sharing its row's block table at the next position.
    One launch a call, against the plain version, and bitwise against a
    second launch."""
    gen = torch.Generator().manual_seed(23 + quant)
    q, k, v, kw = _paged_any(gen, cuda, quant)
    lanes = 4
    bt = kw["block_tables"].cpu()
    bt[bt == 0] = 1                      # the lanes' blocks are real
    pos = kw["pos"].cpu().clamp(max=bt.shape[1] * 16 - lanes)
    kw.update(block_tables=bt.repeat_interleave(lanes, 0).to(cuda),
              pos=(pos[:, None] + torch.arange(lanes)).reshape(-1)
              .to(torch.int32).to(cuda),
              pad=kw["pad"].repeat_interleave(lanes))
    q = _randn(gen, (8 * lanes,) + tuple(q.shape[1:]), cuda)
    name = "launches_int8" if quant else "launches"
    before = getattr(pa.paged_decode_attention, name)
    o = pa.paged_decode_attention(q, k, v, **kw)
    assert getattr(pa.paged_decode_attention, name) == before + 1
    o2 = pa.paged_decode_attention(q, k, v, **kw)
    o_ref = pa.xla_paged_decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    assert _row_rel_err(o, o_ref) <= PAGED_ROW_REL_TOL


@pytest.mark.parametrize("quant", [False, True])
def test_verify_step_runs_the_paged_kernels(cuda, quant):
    """``GPT.decode_verify_batched_paged`` on the card (2 layers of 2
    heads of 64, bf16): one paged-kernel launch a layer for all B·K
    lanes, and the live lanes' logits within the engine's logit
    tolerance of the plain attention's (``chip_smoke.py``'s, 0.08)."""
    from distributed_tensorflow_example_tpu_torch.models.gpt import (
        GPT, GPTConfig)
    cfg = GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                    intermediate=256, max_len=256, dropout=0.0)
    model = GPT(cfg, dtype=torch.bfloat16)
    params = model.init(0, device=cuda)
    stacked = model.stack_decode_params(params)
    gen = torch.Generator().manual_seed(29 + quant)
    b, lanes, bs, nb = 4, 3, 16, 8
    n = 1 + b * nb
    shape = (cfg.layers, n, bs, cfg.heads, 64)
    kf, vf = (_randn(gen, shape, cuda) for _ in range(2))
    if quant:
        (kq, ks), (vq, vs) = quantize_kv_rows(kf), quantize_kv_rows(vf)
        pools = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        pools = {"k": kf, "v": vf}
    bt = ((torch.randperm(n - 1, generator=gen) + 1).reshape(b, nb)
          .to(torch.int32).to(cuda))
    pos = torch.tensor([20, 60, 100, 125], dtype=torch.int32, device=cuda)
    n_tok = torch.tensor([3, 2, 1, 3], dtype=torch.int32, device=cuda)
    tok = torch.randint(0, cfg.vocab_size, (b, lanes), generator=gen,
                        dtype=torch.int32).to(cuda)
    zero = torch.zeros(b, dtype=torch.int32, device=cuda)
    alive = torch.ones(b, dtype=torch.int32, device=cuda)
    name = "launches_int8" if quant else "launches"
    before = getattr(pa.paged_decode_attention, name)
    lg, _ = model.decode_verify_batched_paged(
        params, stacked, {k_: x.clone() for k_, x in pools.items()}, bt, tok,
        pos, zero, alive, n_tok)
    assert getattr(pa.paged_decode_attention, name) == before + cfg.layers
    lg_ref, _ = model.decode_verify_batched_paged(
        params, stacked, {k_: x.clone() for k_, x in pools.items()}, bt, tok,
        pos, zero, alive, n_tok, decode_attention="xla")
    live = (torch.arange(lanes, device=cuda)[None, :] < n_tok[:, None])
    torch.cuda.synchronize()
    assert (lg - lg_ref).abs()[live].max().item() <= 0.08


def test_int8_paged_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 2, 64), device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros((5, 16, 2, 64), device=cuda, dtype=torch.bfloat16)
    k8 = kp.to(torch.int8)
    sc = torch.ones((5, 16), device=cuda)
    bt = torch.ones((2, 2), dtype=torch.int32, device=cuda)
    z = torch.zeros(2, dtype=torch.int32, device=cuda)
    kw = dict(block_tables=bt, pos=z, pad=z)
    with pytest.raises(ValueError, match="describe int8 pools"):
        pa.paged_decode_attention(q, kp, kp, k_scale=sc, v_scale=sc, **kw)
    with pytest.raises(ValueError, match="need k_scale/v_scale"):
        pa.paged_decode_attention(q, k8, k8, **kw)
    with pytest.raises(TypeError, match="f32 scales"):
        pa.paged_decode_attention(q, k8, k8, k_scale=sc.half(), v_scale=sc,
                                  **kw)
    with pytest.raises(TypeError, match="bf16 q"):           # no fallback
        pa.paged_decode_attention(q.float(), k8, k8, k_scale=sc,
                                  v_scale=sc, **kw)
    with pytest.raises(ValueError, match="contiguous k_scale"):
        pa.paged_decode_attention(q, k8, k8, k_scale=sc.t().contiguous().t(),
                                  v_scale=sc, **kw)


def test_mnist_example_trains_on_the_card(cuda, tmp_path, capsys):
    """The port's copy of the reference example, one worker on ``cuda``,
    200 steps at its defaults (hidden 100, batch 256, lr 0.5) with a
    checkpoint: the reference's lines, test accuracy >= 0.95."""
    from distributed_tensorflow_example_tpu_torch.examples import \
        mnist_distributed
    assert mnist_distributed.main(
        ["--device", "cuda", "--train_steps", "200", "--log_every_steps",
         "100", "--ckpt_dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^step 200: loss=[\d.]+ \([\d.]+ steps/s\)$", out,
                     re.M), out
    m = re.search(r"final test accuracy: ([\d.]+)", out)
    assert m and float(m.group(1)) >= 0.95, out
    assert "ckpt-200.npz" in sorted(os.listdir(tmp_path / "ck"))


def test_f32_conv_on_the_card_is_not_tf32(cuda):
    """An f32 ``ops.nn.conv2d`` on the card, with cuDNN's TF32 flag at its
    default (True): output and gradients within 1e-5 of the largest
    value of an f64 evaluation on the CPU (a sum of 3*3*64 products),
    where TF32's 10-bit mantissa would put ~1e-3 there."""
    from distributed_tensorflow_example_tpu_torch.ops import nn
    assert torch.backends.cudnn.allow_tf32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 32, 32, 64, generator=gen)
    w = torch.randn(3, 3, 64, 64, generator=gen)
    ct = torch.randn(8, 16, 16, 64, generator=gen)
    outs = {}
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        xs = x.to(dev, dt).requires_grad_(True)
        ws = w.to(dev, dt).requires_grad_(True)
        y = nn.conv2d({"kernel": ws}, xs, stride=2)
        outs[dev if dev == "cpu" else "cuda"] = (y,) + torch.autograd.grad(
            y, [xs, ws], ct.to(dev, dt))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        err = (got.double().cpu() - want).abs().max()
        assert err <= 1e-5 * want.abs().max(), err


def test_bert_predict_batch_launches_b1_once_a_layer(cuda, tmp_path):
    """A forward export of BERT-base (12 layers of 12 heads of 64, bf16,
    flash; BERT-tiny's heads of 32 are no flash width) served on
    ``:predict`` through the MicroBatcher: one batch of 3 rows (bucket 4)
    launches the flash forward exactly once a layer, and the logits stand
    within the plain attention's (``chip_smoke.py``'s ``:predict`` limit,
    0.1)."""
    import json
    import urllib.request

    from distributed_tensorflow_example_tpu_torch.config import (
        DataConfig, TrainConfig)
    from distributed_tensorflow_example_tpu_torch.models import get_model
    from distributed_tensorflow_example_tpu_torch.serving import (
        export_model, load_servable)
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    model = get_model("bert", TrainConfig(
        model="bert", dtype="bfloat16", attention_impl="flash",
        data=DataConfig(seq_len=64)))
    assert model.cfg.hidden // model.cfg.heads == 64
    gen = torch.Generator().manual_seed(3)
    s = 64
    lens = torch.tensor([s, 40, 17])
    mask = (torch.arange(s)[None] < lens[:, None]).int()
    feats = {"input_ids": (torch.randint(1, 1000, (3, s), generator=gen)
                           * mask).int().numpy(),
             "token_type_ids": torch.zeros((3, s), dtype=torch.int32).numpy(),
             "attention_mask": mask.numpy(),
             "masked_positions": torch.randint(0, 16, (3, 2),
                                               generator=gen).int().numpy()}
    d = str(tmp_path / "bert")
    export_model(model, model.init(0, device=cuda), {}, d,
                 sample_batch=feats)
    with PredictServer(d, scheduler="on", port=0,
                       batch_max_wait_ms=1.0) as srv:
        before = fa.flash_attention_fwd.launches
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/{srv.name}:predict",
            data=json.dumps({"inputs": {k: v.tolist() for k, v in
                                        feats.items()}}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got = torch.tensor(json.loads(r.read())["predictions"])
        launches = fa.flash_attention_fwd.launches - before
        stats = srv.batcher.stats()
    assert stats["batches"] == 1 and stats["padded_rows"] == 1
    assert launches == model.cfg.layers
    plain = load_servable(d)
    plain.model.attention_impl = "xla"
    ref = torch.from_numpy(plain(feats))
    assert (got - ref).abs().max().item() <= 0.1


def test_armed_engine_request_launches_b5_as_a_plain_one(cuda, tmp_path):
    """The same greedy request on a paged export (2 layers of 2 heads of
    64, bf16) through a ``--metrics off --flight_recorder off`` server and
    an armed one (metrics, the always-on span ring, history and SLO,
    incident bundles): equal tokens, equal paged-kernel launches, one a
    layer a decode step."""
    import json
    import urllib.request

    from distributed_tensorflow_example_tpu_torch.models.gpt import (
        GPT, GPTConfig)
    from distributed_tensorflow_example_tpu_torch.obs import trace
    from distributed_tensorflow_example_tpu_torch.serving import \
        export_generator
    from distributed_tensorflow_example_tpu_torch.serving_http import \
        PredictServer
    cfg = GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                    intermediate=256, max_len=64, dropout=0.0)
    model = GPT(cfg, dtype=torch.bfloat16, attention_impl="flash")
    d = str(tmp_path / "paged")
    export_generator(model, model.init(0, device=cuda), d, prompt_len=16,
                     max_new_tokens=12, ragged=True, stepwise=True, slots=4,
                     paged=True, block_size=16, num_blocks=16)
    runs = []
    for kw in ({"metrics": False, "flight_recorder": False},
               {"incident_dir": str(tmp_path / "inc"),
                "history_interval_s": 0.1,
                "slo_spec": "interactive:p95_ms=10000@0.9"}):
        trace.recorder().stop()
        with PredictServer(d, scheduler="on", port=0, **kw) as srv:
            before = pa.paged_decode_attention.launches
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/models/{srv.name}"
                ":generate", data=json.dumps({"inputs": {"input_ids": [
                    list(range(3, 14))]}}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                gens = json.loads(r.read())["generations"]
            runs.append((gens, pa.paged_decode_attention.launches - before))
    trace.recorder().stop()
    (plain, n_plain), (armed, n_armed) = runs
    assert plain == armed and len(plain[0]) == 12
    assert n_plain == n_armed == cfg.layers * 11


def test_two_replica_fleet_serves_one_replicas_bytes(cuda, tmp_path):
    """The same 8 concurrent greedy requests through one server and
    through a 2-replica router fleet on one card (the port's
    ``serving_load`` legs, 2 layers of 2 heads of 64, bf16, 16-slot
    blocks): equal tokens, and the fleet's paged-kernel launches equal
    one a layer a merged decode step."""
    from distributed_tensorflow_example_tpu_torch.experiments import \
        serving_load as sl
    from distributed_tensorflow_example_tpu_torch.models.gpt import (
        GPT, GPTConfig)
    cfg = GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                    intermediate=256, max_len=64, dropout=0.0)
    model = GPT(cfg, dtype=torch.bfloat16, attention_impl="flash")
    sl._RUN.update(device="cuda", lockstep=False)
    d = str(tmp_path / "paged")
    vocab = sl.build_export(d, prompt_len=16, max_new=12, slots=8,
                            paged=True, block_size=16, model=model)
    matrix = sl.make_requests(8, 2, prompt_len=16, max_new=12,
                              vocab=vocab, seed=0)
    one = sl.run_mode(d, matrix, scheduler="on", prompt_len=16)
    before = pa.paged_decode_attention.launches
    fleet = sl.run_router_mode(d, matrix, replicas=2, hedge_after_ms=200)
    launches = pa.paged_decode_attention.launches - before
    assert not one["errors"] and not fleet["errors"]
    assert fleet["_gens"] == one["_gens"]
    assert fleet["router_requests"] == fleet["requests"] == 16
    assert launches == cfg.layers * fleet["decode_steps"] > 0
