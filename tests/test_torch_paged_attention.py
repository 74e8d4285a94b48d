"""The port's paged decode attention (kernel B5's module) against the JAX
package, on the CPU.

On CPU tensors the wrapper takes its plain version, which gathers each
row's blocks out of the pool and runs the plain slab path. It is held to
the reference's XLA gather path (``xla_paged_decode_attention``) on
shuffled physical blocks, blocks shared across rows, per-row pos/pad and
a NaN-filled null block: f32 on both sides, differing only in summation
order, 1e-5. Both gather paths multiply masked slots by exact-zero
probabilities, so a NaN in the null block reaches exactly the rows whose
table names it, in both packages alike (the kernel on the card never
reads a masked slot; ``tests/test_torch_kernels_gpu.py`` shows its output
does not change). On equal logical contents the plain paged path is
bitwise the plain slab path, as in the reference.

The kernel's own input checks run before any launch, so they are shown
here on CPU and meta tensors.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.ops.cuda import (
    decode_attention as tdec, paged_decode_attention as tpa)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


jdec = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.decode_attention")

F32_TOL = 1e-5
B, H, D = 5, 4, 32


def _case(bs: int, nan_null: bool, seed: int = 0):
    """Pools [N, bs, H, D] with block 0 the null block, tables of shuffled
    physical blocks (rows 1-2 share row 0's first block), per-row pos and
    pad, entries outside a row's window on block 0; row 4's table names
    no null block at all."""
    rs = np.random.RandomState(seed)
    nb = 24 // bs + 1
    n = 1 + B * nb
    kp = rs.randn(n, bs, H, D).astype(np.float32)
    vp = rs.randn(n, bs, H, D).astype(np.float32)
    if nan_null:
        kp[0] = vp[0] = np.nan
    bt = (rs.permutation(n - 1)[:B * nb] + 1).reshape(B, nb)
    bt[1:3, 0] = bt[0, 0]
    t = nb * bs
    pos = np.array([t - 1, 3, bs + 2, t - bs - 1, t - 1], np.int32)
    pad = np.array([0, 0, 1, bs + 1, 2], np.int32)
    for r in range(B - 1):
        blk = np.arange(nb)
        bt[r, (blk > pos[r] // bs) | (blk < pad[r] // bs)] = 0
    q = rs.randn(B, H, D).astype(np.float32)
    return q, kp, vp, bt.astype(np.int32), pos, pad


@pytest.mark.parametrize("nan_null", [False, True])
@pytest.mark.parametrize("bs", [4, 16])
def test_plain_paged_matches_reference_gather(bs, nan_null):
    q, kp, vp, bt, pos, pad = _case(bs, nan_null)
    want = np.asarray(jdec.xla_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), block_tables=bt,
        pos=jnp.asarray(pos), pad=jnp.asarray(pad)))
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        block_tables=torch.from_numpy(bt), pos=torch.from_numpy(pos),
        pad=torch.from_numpy(pad)).numpy()
    assert tpa.paged_decode_attention.launches == before   # plain on CPU
    assert got.dtype == np.float32 and got.shape == (B, H, D)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got[B - 1]).all()          # no null block named
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                               equal_nan=True)


def test_plain_paged_is_bitwise_the_plain_slab_path():
    q, kp, vp, bt, pos, pad = _case(16, nan_null=False, seed=1)
    ks = torch.from_numpy(kp[bt].reshape(B, -1, H, D))
    vs = torch.from_numpy(vp[bt].reshape(B, -1, H, D))
    args = dict(pos=torch.from_numpy(pos), pad=torch.from_numpy(pad))
    slab = tdec.decode_attention(torch.from_numpy(q), ks, vs, **args)
    paged = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        block_tables=torch.from_numpy(bt), **args)
    assert torch.equal(slab, paged)


def _inputs(dtype=torch.bfloat16, d=64, nb=4, bs=16, bt_dtype=torch.int32):
    q = torch.zeros((2, 2, d), dtype=dtype)
    kp = torch.zeros((9, bs, 2, d), dtype=dtype)
    bt = torch.ones((2, nb), dtype=bt_dtype)
    z = torch.zeros(2, dtype=torch.int32)
    return q, kp, kp, bt, z, z


@pytest.mark.parametrize("case,exc,match", [
    (dict(dtype=torch.float32), TypeError, "bf16"),
    (dict(d=32), ValueError, "head dim"),
    ("rows_past_int32", ValueError, "2147483647"),
    ("misaligned", ValueError, "16-byte aligned"),
    (dict(bt_dtype=torch.int64), TypeError, "int32"),
    ("strided", ValueError, "contiguous"),
])
def test_kernel_refuses_what_it_does_not_take(case, exc, match):
    """The kernel's checks, which run before its build and launch: a CUDA
    tensor of these kinds raises instead of falling back. A row may hold
    any number of slots that int32 indexes (the split-K kernel keeps no
    score past its tile), and the pools are read in 16-byte vectors."""
    q, kp, vp, bt, pos, pad = _inputs(**(case if isinstance(case, dict)
                                         else {}))
    if case == "strided":
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
        vp = kp
    if case == "misaligned":            # one bf16 off the 16-byte loads
        kp = torch.zeros(kp.numel() + 1, dtype=kp.dtype)[1:].view(kp.shape)
    if case == "rows_past_int32":       # 2^27 + 1 blocks of 16, no memory
        bt = torch.ones((2, 1), dtype=torch.int32).expand(2, 2**27 + 1)
    with pytest.raises(exc, match=match):
        tpa._launch(q, kp, vp, bt, pos, pad)


def test_wrapper_argument_checks():
    q, kp, vp, bt, pos, pad = _inputs()
    kw = dict(block_tables=bt, pos=pos, pad=pad)
    with pytest.raises(ValueError, match="q shape"):
        tpa.paged_decode_attention(q[:, :1], kp, vp, **kw)
    with pytest.raises(ValueError, match="block_tables shape"):
        tpa.paged_decode_attention(q, kp, vp, block_tables=bt[:1], pos=pos,
                                   pad=pad)
    with pytest.raises(ValueError, match="impl"):
        tpa.paged_decode_attention(q, kp, vp, impl="pallas", **kw)
    # scales belong to int8 pools, and int8 pools need their scales
    with pytest.raises(ValueError, match="describe int8 pools"):
        tpa.paged_decode_attention(q, kp, vp, k_scale=torch.ones(9, 16),
                                   v_scale=torch.ones(9, 16), **kw)
    with pytest.raises(ValueError, match="need k_scale/v_scale"):
        i8 = kp.to(torch.int8)
        tpa.paged_decode_attention(q, i8, i8, **kw)
    meta = [x.to("meta") for x in (q, kp, vp)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpa.paged_decode_attention(*meta, block_tables=bt.to("meta"),
                                   pos=pos, pad=pad)


# the split plan: pure Python, from the shapes and the SM count alone
H100_SMS = 132


@pytest.mark.parametrize("b,h,slots", [
    (8, 12, 640), (1, 12, 640), (2, 2, 64), (3, 5, 1), (8, 12, 16384),
    (1, 1, 1000003), (4, 16, 4095), (64, 32, 8191)])
def test_split_plan_tiles_each_row_once(b, h, slots):
    per, splits = tpa.split_plan(b, h, slots, H100_SMS)
    run = per * tpa.TILE                # slots of one split
    hits = np.zeros(slots, np.int64)
    for i in range(splits):             # CTA (b, h, i) takes [i * run, ...)
        hits[i * run:(i + 1) * run] += 1
    assert (hits == 1).all()
    assert (splits - 1) * run < slots   # no CTA starts past the row
    target = tpa.CTAS_PER_SM * H100_SMS
    assert per == 1 or splits <= -(-target // (b * h))


def test_split_plan_fills_the_card():
    """The engine's decode step (8 rows, 12 heads, 640 slots) gets one
    64-slot tile a CTA: 960 CTAs, over twice the H100's 132 SMs. A
    16,384-slot row is planned like any other: its 256 tiles go 12 to a
    CTA, 2,112 CTAs (16 per SM)."""
    assert tpa.split_plan(8, 12, 640, H100_SMS) == (1, 10)
    assert 8 * 12 * 10 >= 2 * H100_SMS
    assert tpa.split_plan(1, 12, 640, H100_SMS) == (1, 10)
    assert tpa.split_plan(8, 12, 16384, H100_SMS) == (12, 22)
    assert 8 * 12 * 22 == tpa.CTAS_PER_SM * H100_SMS


def test_split_plan_refuses_a_grid_past_int32():
    assert tpa.split_plan(2**15, 2**15, 2**10, H100_SMS)[1] == 1
    with pytest.raises(ValueError, match="splits"):
        tpa.split_plan(2**16, 2**15, 2**10, H100_SMS)
