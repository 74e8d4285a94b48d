"""The port's attention and its two kernel modules against the JAX
package, on the CPU.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so
these tests hold the plain versions (the card's oracles) to the JAX
package's Pallas kernels, run in interpret mode at shapes where they
engage (S and T multiples of 128, D = 64), and to its XLA paths. f32
cases differ only in summation order (online softmax vs a two-pass
softmax): 2e-5. bf16 cases round the probabilities and outputs to bf16
in both packages: 2 bf16 ulps of the outputs' magnitude.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ops import attention as jattn
from distributed_tensorflow_example_tpu_torch.ops import attention as tattn
from distributed_tensorflow_example_tpu_torch.ops.cuda import (
    decode_attention as tdec, flash_attention as tflash)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

# the pallas package re-exports functions under its modules' names
jdec = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.decode_attention")
jflash = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.flash_attention")

F32_TOL = 2e-5
BF16_TOL = 2e-2          # two bf16 ulps at |o| <~ 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(rs, b, s, h, d, dtype):
    arrs = [(0.5 * rs.randn(b, s, h, d)).astype(np.float32)
            for _ in range(3)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _left_pad_mask(b, s, pads):
    """[B, S] key mask with ``pads[i]`` dead slots on the left of row i:
    under causal masking rows i < pads[i] see no key at all."""
    m = np.ones((b, s), np.int32)
    for i, p in enumerate(pads):
        m[i, :p] = 0
    return m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_xla_matches_reference(causal, masked):
    rs = np.random.RandomState(0)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rs, 2, 24, 3, 16, "float32")
    m = _left_pad_mask(2, 24, [0, 7]) if masked else None
    want = jattn.multi_head_attention(
        jq, jk, jv, causal=causal,
        mask=None if m is None else jnp.asarray(m)[:, None, None, :])
    got = tattn.multi_head_attention(
        tq, tk, tv, causal=causal,
        mask=None if m is None else torch.from_numpy(m)[:, None, None, :])
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    if masked and causal:           # rows 0..6 of batch row 1: no key
        assert not _np(got)[1, :7].any()


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_interpret(s, dtype):
    """The flash wrapper on CPU tensors (the kernel's plain version)
    against the JAX Pallas forward in interpret mode: causal, with a
    left-pad key mask that fully masks some rows (those give zeros in
    both). The logsumexp the kernel also writes matches the Pallas
    kernel's ``L``."""
    b, h, d = 2, 2, 64
    assert jflash.kernel_engages(s, d)
    rs = np.random.RandomState(s)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rs, b, s, h, d, dtype)
    m = _left_pad_mask(b, s, [0, 37])
    want = jflash.flash_attention(jq, jk, jv, mask=jnp.asarray(m),
                                  causal=True)
    got = tflash.flash_attention(tq, tk, tv, mask=torch.from_numpy(m),
                                 causal=True)
    assert got.dtype == tq.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert not _np(got)[1, :37].any() and not _np(want)[1, :37].any()
    # the xla path of the reference agrees as well
    ref = jattn.multi_head_attention(jq, jk, jv, causal=True,
                                     mask=jnp.asarray(m)[:, None, None, :])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    if dtype == "float32":
        fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * h, s, d)  # noqa
        _, lse_ref = jflash._fwd(fold(jq), fold(jk), fold(jv),
                                 jnp.asarray(m), heads=h, blk_q=128,
                                 blk_k=128, causal=True)
        _, lse = tflash.flash_attention_fwd(tq, tk, tv,
                                            torch.from_numpy(m), causal=True)
        np.testing.assert_allclose(
            lse.numpy().reshape(b * h, s), np.asarray(lse_ref)[..., 0],
            rtol=1e-5, atol=1e-4)


def test_flash_through_multi_head_attention_impl_flash():
    rs = np.random.RandomState(1)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rs, 1, 128, 2, 64, "float32")
    want = jattn.multi_head_attention(jq, jk, jv, causal=True, impl="flash")
    got = tattn.multi_head_attention(tq, tk, tv, causal=True, impl="flash")
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_levers_and_bad_impls_are_refused():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(NotImplementedError, match="block_q"):
        tflash.flash_attention(q, q, q, block_q=64)
    with pytest.raises(ValueError, match="impl='flash'"):
        tattn.multi_head_attention(q, q, q, flash_kwargs={"block_q": 64})
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.multi_head_attention(q, q, q, impl="ring")
    # a tensor on neither the card nor the CPU is refused, not computed
    m = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(m, m, m)


@pytest.mark.parametrize("kernel,rows", [
    ("flash_attention", ()), ("flash_attention_bwd_dq", ("lse", "dsum")),
    ("flash_attention_bwd_dkv", ("lse", "dsum")),
    ("flash_attention_bwd_fused", ("lse", "dsum"))])
def test_flash_kernel_checks_take_bh_65536(kernel, rows):
    """The four flash kernels launch 1-D grids of ceil(S/64)*B*H CTAs, so
    B*H has no cap of its own: the checks take B*H = 65,536 (one row a
    head), which the reference's (bh, nq, nk) grid takes too."""
    q = torch.zeros((65536, 1, 1, 64), dtype=torch.bfloat16)
    mask = torch.ones((65536, 1), dtype=torch.int32)
    row = torch.zeros((65536, 1, 1), dtype=torch.float32)
    tensors = {"q": q, "k": q, "v": q, **({"do": q} if rows else {})}
    tflash._check(kernel, q, tensors, mask, {name: row for name in rows})


@pytest.mark.parametrize("b,s,ok", [(2**31 - 1, 64, True),
                                    (2**31 - 2, 65, False),
                                    (2**15, 2**22, False)])
def test_flash_kernel_checks_refuse_past_the_grid_limit(b, s, ok):
    """The one limit left is the grid's: at most 2**31 - 1 CTAs, one per
    (64-row tile, b*h). Meta tensors carry the shapes with no storage."""
    q = torch.empty((b, s, 1, 64), dtype=torch.bfloat16, device="meta")
    if ok:
        tflash._check("flash_attention", q, {"q": q}, None, {})
    else:
        with pytest.raises(ValueError, match="2\\*\\*31 - 1"):
            tflash._check("flash_attention", q, {"q": q}, None, {})


def _decode_inputs(rs, b, t, h, d, dtype):
    q = (0.5 * rs.randn(b, h, d)).astype(np.float32)
    k, v = ((0.5 * rs.randn(b, t, h, d)).astype(np.float32)
            for _ in range(2))
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    return jx, tx


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_interpret_and_xla(t, per_row, dtype):
    """The decode wrapper on CPU tensors (the kernel's plain version)
    against the JAX slab kernel in interpret mode and its XLA path, with
    nonzero per-row pads and a scalar or per-row ``pos``."""
    b, h, d = 3, 2, 64
    assert jdec.tile_friendly(t, d)
    rs = np.random.RandomState(t + per_row)
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rs, b, t, h, d, dtype)
    pad = np.asarray([0, 5, 40], np.int32)
    pos = (np.asarray([t - 1, t - 9, t // 2], np.int32) if per_row
           else np.int32(t - 3))
    kw_j = dict(pos=jnp.asarray(pos), pad=jnp.asarray(pad))
    kw_t = dict(pos=torch.as_tensor(pos), pad=torch.from_numpy(pad))
    kern = jdec.decode_attention(jq, jk, jv, impl="pallas", **kw_j)
    xla = jdec.decode_attention(jq, jk, jv, impl="xla", **kw_j)
    got = tdec.decode_attention(tq, tk, tv, **kw_t)
    assert got.dtype == tv.dtype and tuple(got.shape) == (b, h, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(xla), rtol=tol, atol=tol)
    plain = tdec.xla_decode_attention(tq, tk, tv, **kw_t)
    np.testing.assert_array_equal(_np(got), _np(plain))


def test_decode_wrapper_checks():
    q = torch.zeros(2, 2, 64)
    k = torch.zeros(2, 16, 2, 64)
    pad = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="q shape"):
        tdec.decode_attention(q[:1], k, k, pos=3, pad=pad)
    with pytest.raises(ValueError, match="impl"):
        tdec.decode_attention(q, k, k, pos=3, pad=pad, impl="pallas")
    with pytest.raises(ValueError, match="scalar or"):
        tdec.decode_attention(q, k, k, pos=torch.tensor([1, 2, 3]), pad=pad)
    m = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdec.decode_attention(m, k.to("meta"), k.to("meta"), pos=3, pad=pad)
    # the plain version counts no kernel launch
    before = tdec.decode_attention.launches
    tdec.decode_attention(q, k, k, pos=3, pad=pad)
    assert tdec.decode_attention.launches == before


# B4's split plan (pure Python, shared with the paged kernels): from B, H,
# T and the SM count alone
H100_SMS = 132


def _split_windows(b, h, t, pad, pos):
    """The live slots ``[lo, hi]`` each of B4's CTAs of one row takes, as
    ``csrc/decode_attention.cu`` ``split_window`` cuts them from the plan
    (empty runs left out)."""
    per, splits = tdec.split_plan(b, h, t, H100_SMS)
    run = per * tdec.TILE
    assert (splits - 1) * run < t          # every split starts in the row
    out = []
    for i in range(splits):
        lo = max(pad, 0, i * run)
        hi = min(pos, t - 1, min((i + 1) * run, t) - 1)
        if lo <= hi:
            out.append((lo, hi))
    return out


@pytest.mark.parametrize("b,h,t", [
    (8, 12, 640), (8, 12, 613), (8, 12, 16384), (8, 12, 16383), (1, 1, 1),
    (1, 12, 8193), (2, 2, 100003), (64, 32, 4097)])
@pytest.mark.parametrize("window", ["full", "cut"])
def test_slab_split_plan_covers_every_live_slot_once(b, h, t, window):
    """Each live slot of a row falls in exactly one CTA's run, whatever T
    (16,384 slots, T not a multiple of the 64-slot tile, past the old
    8192-slot cap), and a window cut mid-tile at both ends too."""
    pad, pos = (0, t - 1) if window == "full" else (t // 3 + 5, t - 7)
    if pad > pos:
        pad, pos = 0, 0
    hits = np.zeros(t, np.int64)
    for lo, hi in _split_windows(b, h, t, pad, pos):
        hits[lo:hi + 1] += 1
    live = np.zeros(t, np.int64)
    live[pad:pos + 1] = 1
    np.testing.assert_array_equal(hits, live)


@pytest.mark.parametrize("t", [8320, 16384])
def test_decode_plain_takes_rows_past_8192_slots(t):
    """The CPU path takes T > 8192 through the plain version (no launch)
    and matches the JAX package's XLA slab path on the same numpy
    inputs, in f32 and in bf16."""
    b, h, d = 2, 2, 64
    rs = np.random.RandomState(t)
    pad = np.asarray([0, 4000], np.int32)
    pos = np.asarray([t - 1, t - 300], np.int32)
    for dtype in ("float32", "bfloat16"):
        (jq, jk, jv), (tq, tk, tv) = _decode_inputs(rs, b, t, h, d, dtype)
        want = jdec.xla_decode_attention(jq, jk, jv, pos=jnp.asarray(pos),
                                         pad=jnp.asarray(pad))
        before = tdec.decode_attention.launches
        got = tdec.decode_attention(tq, tk, tv, pos=torch.from_numpy(pos),
                                    pad=torch.from_numpy(pad))
        assert tdec.decode_attention.launches == before
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
