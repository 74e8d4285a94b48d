"""The port's quantized serving path (int8 KV pools with kernel B6's
module, int8 decode weights) against the JAX package, on bridged GPT-tiny
weights, on the CPU.

- ``quantize_kv_rows`` and the int8 weight stack: the int8 bytes equal the
  reference's bit for bit (both round ``x / scale`` half to even in f32),
  the f32 scales to 1e-7 relative.
- The plain int8 paged attention (what a CPU tensor takes in place of
  kernel B6) against the reference's XLA gather path with scales (f32 on
  both sides, differing only in summation order: 1e-5) and against its
  Pallas kernel in interpret mode (2e-5, the reference's own tolerance
  between its two int8 paths: the kernel folds the scales into the scores
  and probabilities, the gather path multiplies them into the rows first).
- ``paged_prefill`` and ``decode_step_batched_paged`` on int8 pools: the
  written bytes are ``quantize_kv_rows`` of the port's own float rows bit
  for bit; against the reference's written bytes at most one int8 step
  apart (the two packages' f32 K/V rows differ by ~1e-7, which can move a
  value across a rounding midpoint) with scales to 1e-5; a dead row
  leaves pool AND scale bytes alone; logits within 1e-4 of the
  reference's.
- ``generate(weight_quant="int8")``: the reference's greedy tokens, and
  the float path's first token (the prefill runs on float weights).
- The export and the engine, mirroring ``tests/test_quantized_decode.py``:
  knob validation, metadata, equal ``pool_bytes`` doubling the blocks,
  ``validate_quant_meta`` and every loader refusing corrupt metadata, the
  quant-off no-op, the port's int8 engine returning the reference int8
  engine's greedy tokens for 8 concurrent ragged requests, agreement with
  the float oracle of at least the reference's ``INT8_MIN_AGREEMENT``,
  prefix reuse, copy-on-write of a shared int8 block with its scales, and
  ``/stats``.
"""

import dataclasses
import importlib
import json
import os
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import serving as jserving
from distributed_tensorflow_example_tpu import serving_batch as jbatch
from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.models.gpt import \
    quantize_kv_rows as jquantize
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy, quantize_kv_rows)
from distributed_tensorflow_example_tpu_torch.ops.cuda import \
    paged_decode_attention as tpa
from distributed_tensorflow_example_tpu_torch.serving import (
    export_generator, load_servable, load_stepwise, validate_quant_meta)
from distributed_tensorflow_example_tpu_torch.serving_batch import \
    GenerationEngine
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

jdec = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.decode_attention")

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

#: the reference's drift gate for int8 serving against the float oracle
#: (``experiments/serving_load.py`` ``INT8_MIN_AGREEMENT``), copied here
INT8_MIN_AGREEMENT = 0.75
F32_TOL = 1e-5
LOGIT_TOL = 1e-4
SCALE_RTOL = 1e-7
PROMPT_LEN = 8
MAX_NEW = 5
SLOTS = 4
BLOCK = 4


@pytest.fixture(scope="module")
def pair():
    jm = JGPT(JGPTConfig.tiny())
    jp = jm.init(jax.random.key(0))
    tm = GPT(GPTConfig.tiny())
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def one_layer():
    """layers=1: the written K/V rows do not depend on the cache contents
    (qkv is computed before attention), so the bytes a step writes can be
    held exactly against ``quantize_kv_rows`` of the float step's rows."""
    cfg = dict(layers=1)
    jm = JGPT(dataclasses.replace(JGPTConfig.tiny(), **cfg))
    jp = jm.init(jax.random.key(1))
    tm = GPT(dataclasses.replace(GPTConfig.tiny(), **cfg))
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# quantizers: bitwise the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_rows_is_the_references(dtype):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 7, 4, 16).astype(np.float32) * 3
    x[1, 2] = 0.0                                       # an all-zero row
    x[2, 3, 0, :4] = [0.5, -1.5, 2.5, 127.0]            # halfway values
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q, s = quantize_kv_rows(xt)
    wq, ws = jquantize(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == x.shape and tuple(s.shape) == (3, 7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=SCALE_RTOL,
                               atol=0)
    # round to nearest: |x - q * s| <= s / 2; a zero row comes back zeros
    deq = q.float() * s[..., None, None]
    err = (deq - xt.float()).abs()
    assert bool((err <= s[..., None, None] / 2 + 1e-7).all())
    assert bool((deq[1, 2] == 0).all())


def test_int8_weight_stack_is_the_references(pair):
    """``stack_decode_params(weight_quant="int8")``: per-output-channel
    ``kernel_q`` bitwise and ``scale`` to 1e-7 against the reference's
    (``tests/test_decode_fast_path.py``'s quantizer test, held across
    packages), and the dequantized kernels within scale / 2 of the float
    ones."""
    jm, jp, tm, tp = pair
    want = jm.stack_decode_params(jp, weight_quant="int8")
    got = tm.stack_decode_params(tp, weight_quant="int8")
    flt = tm.stack_decode_params(tp)
    for name in ("qkv", "o", "ffn_in", "ffn_out"):
        g, w = got[name], want[name]
        assert set(g) == {"kernel_q", "scale", "bias"} == set(w)
        assert g["kernel_q"].dtype == torch.int8
        np.testing.assert_array_equal(g["kernel_q"].numpy(),
                                      np.asarray(w["kernel_q"]))
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(w["scale"]),
                                   rtol=SCALE_RTOL, atol=0)
        deq = tm._dequant(g)["kernel"]
        assert bool(((deq - flt[name]["kernel"]).abs()
                     <= g["scale"] / 2 + 1e-7).all())
    with pytest.raises(ValueError, match="weight_quant"):
        tm.stack_decode_params(tp, weight_quant="int4")


# ---------------------------------------------------------------------------
# the plain int8 paged attention (kernel B6's module)
# ---------------------------------------------------------------------------

def _int8_case(rs, b, h, d, bs, nb, *, null_garbage=False):
    """Quantized pools (block 0 the null block), shuffled tables, rows 1-2
    sharing row 0's first block, per-row pos/pad, entries outside each
    window on block 0."""
    n = 1 + b * nb
    kq, ks = jquantize(jnp.asarray(rs.randn(n, bs, h, d).astype(np.float32)))
    vq, vs = jquantize(jnp.asarray(rs.randn(n, bs, h, d).astype(np.float32)))
    kq, ks, vq, vs = (np.array(x) for x in (kq, ks, vq, vs))
    if null_garbage:                  # any bytes and NaN scales in block 0
        kq[0], vq[0] = 127, -128
        ks[0] = vs[0] = np.nan
    bt = (rs.permutation(n - 1)[:b * nb] + 1).reshape(b, nb).astype(np.int32)
    bt[1:3, 0] = bt[0, 0]
    t = nb * bs
    pos = rs.randint(t // 2, t, b).astype(np.int32)
    pad = rs.randint(0, bs + 2, b).astype(np.int32)
    pad[0] = 0
    blk = np.arange(nb)
    for r in range(b):
        bt[r, (blk > pos[r] // bs) | (blk < pad[r] // bs)] = 0
    q = rs.randn(b, h, d).astype(np.float32)
    return q, kq, vq, ks, vs, bt, pos, pad


@pytest.mark.parametrize("bs", [4, 16])
def test_plain_int8_paged_matches_reference_gather(bs):
    rs = np.random.RandomState(bs)
    q, kq, vq, ks, vs, bt, pos, pad = _int8_case(rs, 5, 4, 32, bs, 32 // bs)
    want = np.asarray(jdec.xla_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), block_tables=bt,
        pos=jnp.asarray(pos), pad=jnp.asarray(pad), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    before = (tpa.paged_decode_attention.launches,
              tpa.paged_decode_attention.launches_int8)
    got = tpa.paged_decode_attention(
        _t(q), _t(kq), _t(vq), block_tables=_t(bt), pos=_t(pos), pad=_t(pad),
        k_scale=_t(ks), v_scale=_t(vs))
    assert (tpa.paged_decode_attention.launches,
            tpa.paged_decode_attention.launches_int8) == before  # plain
    assert got.dtype == torch.float32                     # q's dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    # the same as dequantizing the pools first and attending in float
    deq = tpa.paged_decode_attention(
        _t(q), _t(kq).float() * _t(ks)[..., None, None],
        _t(vq).float() * _t(vs)[..., None, None], block_tables=_t(bt),
        pos=_t(pos), pad=_t(pad))
    assert torch.equal(deq, got)


def test_plain_int8_paged_matches_reference_kernel_interpret():
    """The reference's Pallas kernel with ``quant=True`` (interpret mode:
    block size 128, D = 64) folds the scales algebraically, as kernel B6
    does; the plain version dequantizes first. Held to 2e-5, the
    reference's own tolerance between its two int8 paths."""
    rs = np.random.RandomState(2)
    q, kq, vq, ks, vs, bt, pos, pad = _int8_case(rs, 2, 2, 64, 128, 3)
    pos[:] = [300, 380]
    bt[:, :3] = np.arange(1, 7, dtype=np.int32).reshape(2, 3)
    kw = dict(block_tables=bt, pos=jnp.asarray(pos), pad=jnp.asarray(pad),
              k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = np.asarray(jdec.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), impl="pallas",
        **kw))
    got = tpa.paged_decode_attention(
        _t(q), _t(kq), _t(vq), block_tables=_t(bt), pos=_t(pos), pad=_t(pad),
        k_scale=_t(ks), v_scale=_t(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_int8_scale_validation_matches_the_reference():
    """Scales and int8 pools travel together; both packages raise on the
    same inputs. The port also requires f32 scales."""
    rs = np.random.RandomState(3)
    q, kq, vq, ks, vs, bt, pos, pad = _int8_case(rs, 1, 2, 32, 4, 2)
    kw = dict(block_tables=_t(bt), pos=_t(pos), pad=_t(pad))
    jkw = dict(block_tables=bt, pos=jnp.asarray(pos), pad=jnp.asarray(pad))
    qt, kt, st = _t(q), _t(kq), _t(ks)
    cases = [
        ("together", dict(k_scale=st), dict(k_scale=jnp.asarray(ks))),
        ("k_scale/v_scale", {}, {}),
        ("scale shape", dict(k_scale=st[:, :2], v_scale=st),
         dict(k_scale=jnp.asarray(ks)[:, :2], v_scale=jnp.asarray(ks))),
    ]
    for match, kws, jkws in cases:
        with pytest.raises(ValueError, match=match):
            tpa.paged_decode_attention(qt, kt, kt, **kw, **kws)
        with pytest.raises(ValueError, match=match):
            jdec.paged_decode_attention(jnp.asarray(q), jnp.asarray(kq),
                                        jnp.asarray(kq), **jkw, **jkws)
    kf = kt.float()
    with pytest.raises(ValueError, match="int8 pools"):
        tpa.paged_decode_attention(qt, kf, kf, k_scale=st, v_scale=st, **kw)
    with pytest.raises(TypeError, match="f32 scales"):
        tpa.paged_decode_attention(qt, kt, kt, k_scale=st.double(),
                                   v_scale=st, **kw)


def _kernel_inputs(d=64, bs=16, nb=4, q_dtype=torch.bfloat16,
                   pool_dtype=torch.int8):
    q = torch.zeros((2, 2, d), dtype=q_dtype)
    kp = torch.zeros((9, bs, 2, d), dtype=pool_dtype)
    sc = torch.ones((9, bs))
    bt = torch.ones((2, nb), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    return q, kp, kp, sc, sc, bt, z, z


@pytest.mark.parametrize("case,exc,match", [
    (dict(q_dtype=torch.float32), TypeError, "bf16 q"),
    (dict(pool_dtype=torch.uint8), TypeError, "int8 k_pool"),
    ("misaligned", ValueError, "aligned"),
    ("misaligned_by_8", ValueError, "16-byte aligned"),
    ("strided_scale", ValueError, "contiguous k_scale"),
    (dict(d=32), ValueError, "head dim"),
    ("rows_past_int32", ValueError, "2147483647"),
])
def test_int8_kernel_refuses_what_it_does_not_take(case, exc, match):
    """Kernel B6's checks, which run before its build and launch: a CUDA
    tensor of these kinds raises instead of falling back."""
    q, kp, vp, ks, vs, bt, pos, pad = _kernel_inputs(
        **(case if isinstance(case, dict) else {}))
    if case == "strided_scale":
        ks = torch.ones((16, 9)).t()
    if case in ("misaligned", "misaligned_by_8"):  # off the 16-byte loads
        off = 1 if case == "misaligned" else 8
        kp = torch.zeros(kp.numel() + off, dtype=torch.int8)[off:].view(
            kp.shape)
    if case == "rows_past_int32":       # 2^27 + 1 blocks of 16, no memory
        bt = torch.ones((2, 1), dtype=torch.int32).expand(2, 2**27 + 1)
    with pytest.raises(exc, match=match):
        tpa._launch(q, kp, vp, bt, pos, pad, ks, vs)


# ---------------------------------------------------------------------------
# model level: quantize-on-write
# ---------------------------------------------------------------------------

def _int8_bytes_close(got, want):
    """At most one int8 step apart (a ~1e-7 difference in the f32 row can
    move a value across a rounding midpoint), and almost all equal."""
    diff = np.abs(got.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99


def test_paged_prefill_int8_matches_reference(one_layer):
    jm, jp, tm, tp = one_layer
    c = tm.cfg
    shape = (c.layers, 6, BLOCK, c.heads, tm.head_dim)
    rs = np.random.RandomState(4)
    p = 6
    ids = np.zeros((1, PROMPT_LEN), np.int32)
    mask = np.zeros((1, PROMPT_LEN), np.int32)
    ids[0, :p] = rs.randint(0, c.vocab_size, p)
    mask[0, :p] = 1
    tr = np.array([2, 4], np.int32)
    old_q = rs.randint(-128, 128, shape).astype(np.int8)
    old_s = rs.rand(*shape[:3]).astype(np.float32)
    pools = [torch.from_numpy(old_q.copy()) for _ in range(2)] + \
        [torch.from_numpy(old_s.copy()) for _ in range(2)]
    lg, kq, vq, ks, vs = tm.paged_prefill(
        tp, _t(ids), _t(mask), pools[0], pools[1], _t(tr),
        k_scale=pools[2], v_scale=pools[3])
    assert all(a is b for a, b in zip((kq, vq, ks, vs), pools))  # in place
    flt = [torch.zeros(shape) for _ in range(2)]
    lg_f, kf, vf = tm.paged_prefill(tp, _t(ids), _t(mask), *flt, _t(tr))
    assert torch.equal(lg, lg_f)            # logits precede any cache read
    for fp, qp, sp in ((kf, kq, ks), (vf, vq, vs)):
        wq, ws = quantize_kv_rows(fp[:, tr])
        assert torch.equal(qp[:, tr], wq) and torch.equal(sp[:, tr], ws)
        untouched = [b for b in range(6) if b not in tr]
        np.testing.assert_array_equal(qp[:, untouched].numpy(),
                                      old_q[:, untouched])
        np.testing.assert_array_equal(sp[:, untouched].numpy(),
                                      old_s[:, untouched])
    want = jm.paged_prefill(
        jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(old_q),
        jnp.asarray(old_q), jnp.asarray(tr), k_scale=jnp.asarray(old_s),
        v_scale=jnp.asarray(old_s))
    np.testing.assert_allclose(lg.numpy(), np.asarray(want[0]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for got, w in zip((kq, vq), want[1:3]):
        _int8_bytes_close(got.numpy(), w)
    for got, w in zip((ks, vs), want[3:5]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=0)
    # the same prompt writes the same bytes again: what lets the prefix
    # cache share int8 blocks
    again = [torch.zeros_like(x) for x in pools]
    tm.paged_prefill(tp, _t(ids), _t(mask), again[0], again[1], _t(tr),
                     k_scale=again[2], v_scale=again[3])
    for a, b in zip(again, pools):
        assert torch.equal(a[:, tr], b[:, tr])


@pytest.mark.parametrize("model", ["one_layer", "pair"])
def test_paged_decode_step_int8_matches_reference(model, request):
    """Three int8 steps with a dead row: logits within 1e-4 of the
    reference's, written bytes within one int8 step and scales to 1e-5;
    on one layer the written bytes are ``quantize_kv_rows`` of the float
    step's own rows bit for bit; the dead row's blocks keep their bytes
    AND scales."""
    jm, jp, tm, tp = request.getfixturevalue(model)
    c = tm.cfg
    l, h, d = c.layers, c.heads, tm.head_dim
    b, nb = 3, 4
    n = 1 + b * nb
    rs = np.random.RandomState(5)
    bt = (rs.permutation(n - 1) + 1).reshape(b, nb).astype(np.int32)
    hq, hs = jquantize(jnp.asarray(rs.randn(l, n, BLOCK, h, d).astype(
        np.float32)))
    hq, hs = np.array(hq), np.array(hs)
    pools0 = {"k": hq, "v": hq[:, ::-1].copy(), "k_scale": hs,
              "v_scale": hs[:, ::-1].copy()}
    steps = [(np.array([5, 9, 3], np.int32), np.array([1, 1, 0], np.int32)),
             (np.array([6, 10, 3], np.int32), np.array([1, 1, 0], np.int32)),
             (np.array([7, 11, 3], np.int32), np.array([1, 1, 0], np.int32))]
    pad = np.array([0, 2, 0], np.int32)
    tok = np.array([5, 7, 11], np.int32)
    pools = {k: torch.from_numpy(v.copy()) for k, v in pools0.items()}
    jpools = {k: jnp.asarray(v) for k, v in pools0.items()}
    stacked = tm.stack_decode_params(tp)
    jstacked = jm.stack_decode_params(jp)
    for pos, alive in steps:
        before = {k: v.clone() for k, v in pools.items()}
        lg, pools = tm.decode_step_batched_paged(
            tp, stacked, pools, _t(bt), _t(tok), _t(pos), _t(pad),
            _t(alive))
        wlg, jpools = jm.decode_step_batched_paged(
            jp, jstacked, jpools, jnp.asarray(bt), jnp.asarray(tok),
            jnp.asarray(pos), jnp.asarray(pad), jnp.asarray(alive),
            decode_attention="xla")
        np.testing.assert_allclose(lg.numpy()[:2], np.asarray(wlg)[:2],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for x in ("k", "v"):
            _int8_bytes_close(pools[x].numpy(), jpools[x])
        for x in ("k_scale", "v_scale"):
            np.testing.assert_allclose(pools[x].numpy(),
                                       np.asarray(jpools[x]), rtol=F32_TOL,
                                       atol=0)
        for x in pools:                    # the dead row touched nothing
            assert torch.equal(pools[x][:, bt[2]], before[x][:, bt[2]])
        if model == "one_layer":
            flt = {x: before[x].float() * before[x + "_scale"][..., None,
                                                               None]
                   for x in ("k", "v")}
            tm.decode_step_batched_paged(tp, stacked, flt, _t(bt), _t(tok),
                                         _t(pos), _t(pad), _t(alive))
            for r in (0, 1):
                pb, off = bt[r, pos[r] // BLOCK], pos[r] % BLOCK
                for x in ("k", "v"):
                    wq, ws = quantize_kv_rows(flt[x][:, pb, off])
                    assert torch.equal(pools[x][:, pb, off], wq)
                    assert torch.equal(pools[x + "_scale"][:, pb, off], ws)
        tok = lg.argmax(-1).to(torch.int32).numpy()


def test_generate_weight_int8_matches_reference(pair):
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(7)
    ids = rs.randint(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :5] = 0
    want = np.asarray(jm.generate(jp, jnp.asarray(ids), 6,
                                  prompt_mask=jnp.asarray(mask),
                                  weight_quant="int8"))
    got = tm.generate(tp, _t(ids), 6, prompt_mask=_t(mask),
                      weight_quant="int8").numpy()
    np.testing.assert_array_equal(got, want)
    full = tm.generate(tp, _t(ids), 6, prompt_mask=_t(mask)).numpy()
    np.testing.assert_array_equal(got[:, 0], full[:, 0])
    with pytest.raises(ValueError, match="decode_impl='stacked'"):
        tm.generate(tp, _t(ids), 2, decode_impl="loop", weight_quant="int8")


# ---------------------------------------------------------------------------
# export level
# ---------------------------------------------------------------------------

def _export_kw(**kw):
    base = dict(prompt_len=PROMPT_LEN, max_new_tokens=MAX_NEW, batch_size=1,
                ragged=True, stepwise=True, slots=SLOTS, paged=True,
                block_size=BLOCK, num_blocks=48)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def int8_dirs(pair, tmp_path_factory):
    """The port's paged exports with an int8 KV pool, without and with
    int8 weights, and the float paged export (the drift oracle)."""
    _, _, tm, tp = pair
    out = {}
    for name, kw in (("kv", dict(kv_cache_dtype="int8")),
                     ("kv_w", dict(kv_cache_dtype="int8",
                                   weight_quant="int8")),
                     ("float", {})):
        d = str(tmp_path_factory.mktemp(name))
        export_generator(tm, tp, d, **_export_kw(**kw))
        out[name] = d
    return out


def test_export_quant_knob_validation(pair, tmp_path):
    _, _, tm, tp = pair
    d = str(tmp_path / "x")
    with pytest.raises(ValueError, match="paged=True"):
        export_generator(tm, tp, d, **_export_kw(paged=False,
                                                 num_blocks=None,
                                                 kv_cache_dtype="int8"))
    with pytest.raises(ValueError, match="paged=True"):       # slab export
        export_generator(tm, tp, d, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="not both"):
        export_generator(tm, tp, d, **_export_kw(pool_bytes=1 << 20))
    with pytest.raises(ValueError, match="weight_quant"):
        export_generator(tm, tp, d, prompt_len=PROMPT_LEN,
                         max_new_tokens=MAX_NEW, weight_quant="int4")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        export_generator(tm, tp, d, **_export_kw(kv_cache_dtype="fp8"))
    assert not os.path.exists(d)


def test_int8_export_metadata_and_pool(int8_dirs):
    with open(os.path.join(int8_dirs["kv_w"], "export.json")) as f:
        meta = json.load(f)
    assert meta["quant_schema"] == 1 and meta["weight_quant"] == "int8"
    sm = meta["stepwise"]
    assert sm["kv_cache_dtype"] == sm["cache_dtype"] == "int8"
    l_, n, bs, h, d = sm["pool_shape"]
    assert sm["kv_scale_shape"] == [l_, n, bs]
    assert sm["kv_scale_dtype"] == "float32"
    # K+V int8 payload plus the two f32 scale rows of each slot
    assert sm["block_bytes"] == 2 * l_ * bs * h * d + 2 * l_ * bs * 4
    sw = load_stepwise(int8_dirs["kv_w"], device="cpu")
    assert sw.kv_cache_dtype == "int8"
    assert "kernel_q" in sw._stacked["qkv"]
    pool = sw.make_pool()
    assert set(pool) == {"cache_k", "cache_v", "cache_k_scale",
                         "cache_v_scale"}
    assert pool["cache_k"].dtype == torch.int8
    assert pool["cache_k_scale"].dtype == torch.float32
    assert tuple(pool["cache_k_scale"].shape) == (l_, n, bs)
    with open(os.path.join(int8_dirs["kv"], "export.json")) as f:
        assert json.load(f)["weight_quant"] is None


def test_equal_pool_bytes_int8_doubles_blocks(pair, tmp_path):
    """At one ``pool_bytes`` budget the int8 export holds exactly twice
    the bf16 export's usable blocks (the scale rows are residency, not
    budget), and ``block_bytes`` still counts them."""
    _, _, tm, tp = pair
    budget = 1 << 20
    counts, block_bytes = {}, {}
    for dtype in ("bf16", "int8"):
        d = str(tmp_path / dtype)
        export_generator(tm, tp, d, **_export_kw(
            num_blocks=None, pool_bytes=budget, kv_cache_dtype=dtype))
        sm = load_stepwise(d, device="cpu").step_meta
        counts[dtype] = int(sm["num_blocks"]) - 1
        block_bytes[dtype] = sm["block_bytes"]
    assert counts["int8"] == 2 * counts["bf16"] >= 2
    assert block_bytes["int8"] > block_bytes["bf16"] // 2


def test_quant_off_is_bitwise_noop(pair, tmp_path):
    """``weight_quant="off"`` + ``kv_cache_dtype="auto"`` write the default
    export: the same metadata, pool and served tokens."""
    _, _, tm, tp = pair
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 1000, (1, PROMPT_LEN), dtype=np.int32)
    mask = np.ones_like(ids)
    outs, metas = [], []
    for name, kw in (("default", {}), ("off", dict(weight_quant="off",
                                                   kv_cache_dtype="auto"))):
        d = str(tmp_path / name)
        export_generator(tm, tp, d, **_export_kw(slots=2, num_blocks=24,
                                                 **kw))
        sv = load_servable(d, device="cpu")
        outs.append(sv({"input_ids": ids, "prompt_mask": mask}))
        metas.append(sv.meta)
        assert set(load_stepwise(d, device="cpu").make_pool()) == {
            "cache_k", "cache_v"}
    np.testing.assert_array_equal(outs[0], outs[1])
    assert metas[0]["weight_quant"] is None
    assert metas[0]["stepwise"] == metas[1]["stepwise"]
    assert "kv_scale_shape" not in metas[0]["stepwise"]


def _int8_meta():
    return {"quant_schema": 1, "weight_quant": "int8",
            "stepwise": {"paged": True, "kv_cache_dtype": "int8",
                         "cache_dtype": "int8",
                         "pool_shape": [2, 9, 4, 4, 32],
                         "kv_scale_shape": [2, 9, 4],
                         "kv_scale_dtype": "float32"}}


@pytest.mark.parametrize("field,value,match", [
    (None, None, None),
    ("quant_schema", 99, "quant_schema"),
    ("weight_quant", "int4", "weight_quant"),
    ("stepwise.paged", False, "paged"),
    ("stepwise.kv_scale_shape", [2, 9, 8], "kv_scale_shape"),
    ("stepwise.kv_scale_dtype", "notadtype", "kv_scale_dtype"),
    ("stepwise.kv_cache_dtype", "alsonotadtype", "kv_cache_dtype"),
])
def test_validate_quant_meta_regressions(field, value, match):
    """The reference's cases, run through both packages' validators."""
    for validate in (validate_quant_meta, jserving.validate_quant_meta):
        m = _int8_meta()
        if field is not None:
            node, _, key = field.rpartition(".")
            (m[node] if node else m)[key] = value
        if match is None:
            validate(m)
            validate({})                          # pre-schema artifact
            validate({"quant_schema": 1, "stepwise": {
                "cache_dtype": "bfloat16", "kv_cache_dtype": "bfloat16"}})
        else:
            with pytest.raises(ValueError, match=match):
                validate(m)


def test_every_loader_rejects_corrupt_quant_meta(int8_dirs, tmp_path):
    d = str(tmp_path / "corrupt")
    shutil.copytree(int8_dirs["kv_w"], d)
    p = os.path.join(d, "export.json")
    with open(p) as f:
        meta = json.load(f)
    for key, value, match in (("kv_scale_shape", [1, 2, 3], "kv_scale_shape"),
                              ("quant_schema", 99, "quant_schema")):
        bad = json.loads(json.dumps(meta))
        (bad["stepwise"] if key.startswith("kv") else bad)[key] = value
        with open(p, "w") as f:
            json.dump(bad, f)
        for load in (lambda: load_stepwise(d, device="cpu"),
                     lambda: load_servable(d, device="cpu"),
                     lambda: PredictServer(d, port=0, device="cpu")):
            with pytest.raises(ValueError, match=match):
                load()


# ---------------------------------------------------------------------------
# engine and HTTP level
# ---------------------------------------------------------------------------

def _prompts(n, seed=0, lo=1, hi=PROMPT_LEN):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 1000, (int(rs.randint(lo, hi + 1)),)
                       ).astype(np.int32) for _ in range(n)]


def _run(eng, prompts):
    """Queue every request before start (one deterministic admission
    wave), run them, close."""
    futs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        eng.close()


def _drain(eng):
    for _ in range(10_000):
        eng._admit()
        if not eng._live:
            if not eng._queue:
                return
            continue
        eng._shared_step()
    raise AssertionError("engine did not drain")


def _agreement(a, b):
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / len(pairs)


@pytest.fixture(scope="module")
def reference_int8(pair, tmp_path_factory):
    """The reference engine's greedy tokens for 8 concurrent ragged
    requests over its own int8 exports (KV only, and KV + weights)."""
    jm, jp, _, _ = pair
    prompts = _prompts(2 * SLOTS, seed=10)
    out, dirs = {}, {}
    for name, kw in (("kv", dict(kv_cache_dtype="int8")),
                     ("kv_w", dict(kv_cache_dtype="int8",
                                   weight_quant="int8"))):
        d = dirs[name] = str(tmp_path_factory.mktemp(f"ref_{name}"))
        jserving.export_generator(jm, jp, d, platforms=("cpu",),
                                  **_export_kw(**kw))
        out[name] = _run(jbatch.GenerationEngine(jserving.load_stepwise(d)),
                         prompts)
    return prompts, out, dirs


@pytest.mark.parametrize("name", ["kv", "kv_w"])
def test_int8_engine_matches_reference_int8_engine(int8_dirs, reference_int8,
                                                   name):
    """8 concurrent ragged requests over 4 slots: the port's int8 engine
    returns the reference int8 engine's greedy tokens exactly, and agrees
    with the float engine (the oracle) at least at the reference's drift
    gate."""
    prompts, ref, _ = reference_int8
    eng = GenerationEngine(load_stepwise(int8_dirs[name], device="cpu"))
    assert eng.kv_cache_dtype == "int8"
    got = _run(eng, prompts)
    assert got == ref[name]
    assert eng.prefills == len(prompts)
    flt = _run(GenerationEngine(load_stepwise(int8_dirs["float"],
                                              device="cpu")), prompts)
    assert _agreement(got, flt) >= INT8_MIN_AGREEMENT
    assert [g[0] for g in got] == [f[0] for f in flt]   # float prefill


def test_int8_prefix_repeat_exact_hits_with_same_tokens(int8_dirs):
    """Quantize-on-write is deterministic, so repeated prompts exact-hit
    the prefix cache: zero new prefills and the same tokens."""
    prompts = _prompts(3, seed=21)
    eng = GenerationEngine(load_stepwise(int8_dirs["kv"], device="cpu"))
    futs = [eng.submit(p) for p in prompts]
    eng.start()
    try:
        first = [f.result(timeout=120) for f in futs]
        pre = eng.prefills
        second = [eng.submit(p).result(timeout=120) for p in prompts]
    finally:
        eng.close()
    assert eng.prefills == pre
    assert first == second
    assert eng.stats()["prefix_cache_hits"] >= len(prompts)


def test_int8_cow_copies_blocks_with_their_scales(int8_dirs,
                                                  reference_int8):
    """A repeat of a prompt ending inside a block mounts the cached tail
    block and copies it before its first write: the int8 bytes and the
    scales of the copy equal the cached block's. The cold request, its
    exact hit and a second hit return the reference engine's tokens. (The
    hit runs its last prompt token through the decode step over the
    dequantized cache where the cold request ran it in the float prefill,
    so the two may differ, in the reference as in the port; two hits may
    not.)"""
    prompt = _prompts(1, seed=13, lo=5, hi=7)[0]
    assert prompt.size % BLOCK
    ref = jbatch.GenerationEngine(jserving.load_stepwise(
        reference_int8[2]["kv"]))
    want = []
    for _ in range(3):
        f = ref.submit(prompt)
        _drain(ref)
        want.append(f.result(timeout=5))
    ref.close()
    eng = GenerationEngine(load_stepwise(int8_dirs["kv"], device="cpu"))
    f1 = eng.submit(prompt)
    _drain(eng)
    copies = []
    copy = eng._copy_block

    def spy(pool, src, dst):
        out = copy(pool, src, dst)
        copies.append({k: (v[:, src].clone(), v[:, dst].clone())
                       for k, v in out.items()})
        return out

    eng._copy_block = spy
    f2 = eng.submit(prompt)
    _drain(eng)
    assert eng.cow_copies >= 1 and copies
    for c in copies:
        assert set(c) == {"cache_k", "cache_v", "cache_k_scale",
                          "cache_v_scale"}
        for src, dst in c.values():
            assert torch.equal(src, dst)
        assert bool((c["cache_k_scale"][0] > 0).any())
    f3 = eng.submit(prompt)
    _drain(eng)
    got = [f.result(timeout=5) for f in (f1, f2, f3)]
    assert got == want
    assert got[1] == got[2]
    eng.close()


def test_int8_bytes_per_token_below_bf16(pair, tmp_path):
    """The engine sizes an int8 pool at one byte an element (plus the
    scale rows), below a bf16 pool's cost per cached token."""
    _, _, tm, tp = pair
    vals = {}
    for dtype in ("bf16", "int8"):
        d = str(tmp_path / dtype)
        export_generator(tm, tp, d, **_export_kw(slots=2, num_blocks=24,
                                                 kv_cache_dtype=dtype))
        eng = GenerationEngine(load_stepwise(d, device="cpu"))
        vals[dtype] = eng.registry.snapshot()[
            "serving_kv_cache_bytes_per_token"]["value"]
        eng.close()
    c = tm.cfg
    assert vals["bf16"] == 2 * c.layers * c.hidden * 2
    assert vals["int8"] == 2 * c.layers * c.hidden + 2 * c.layers * 4
    assert vals["int8"] < vals["bf16"]


def test_int8_engine_on_bf16_compute(pair, tmp_path):
    """The card's configuration on the CPU: bf16 compute over int8 pools
    (the plain paged path dequantizes to bf16), with int8 weights."""
    _, jp, _, _ = pair
    tm = GPT(GPTConfig.tiny(), dtype=torch.bfloat16)
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    d = str(tmp_path / "bf16")
    export_generator(tm, tp, d, **_export_kw(kv_cache_dtype="int8",
                                             weight_quant="int8"))
    prompts = _prompts(SLOTS, seed=23)
    got = _run(GenerationEngine(load_stepwise(d, device="cpu")), prompts)
    assert all(len(g) == MAX_NEW and 0 <= min(g) and max(g) < tm.cfg.vocab_size
               for g in got)
    assert got == _run(GenerationEngine(load_stepwise(d, device="cpu")),
                       prompts)


def test_http_int8_generate_and_stats(int8_dirs, pair):
    """``:generate`` over the int8 export through ``PredictServer``
    (scheduler on): the same tokens as the engine served directly, and
    ``/stats`` reporting the int8 pool."""
    prompts = _prompts(4, seed=22)
    with PredictServer(int8_dirs["kv_w"], port=0, device="cpu") as srv:
        assert srv.scheduler == "on"
        got = []
        for p in prompts:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/models/{srv.name}"
                ":generate",
                data=json.dumps(
                    {"inputs": {"input_ids": [p.tolist()]}}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.loads(r.read())["generations"][0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())["generate"]
    assert stats["kv_cache_dtype"] == "int8"
    assert stats["bytes_resident_peak"] > 0
    want = [_run(GenerationEngine(load_stepwise(int8_dirs["kv_w"],
                                                device="cpu")), [p])[0]
            for p in prompts]
    assert got == want
