"""The port's batched decode steps and paged prefill (the engine's model
methods) against the JAX package's, on bridged GPT-tiny weights, f32, on
the CPU.

- ``decode_step_batched`` (slab pool) over several steps with per-row
  ``pos`` and one dead row, against the reference's own
  ``decode_step_batched`` and, row by row, its ``decode_impl="loop"``
  step (the reference's parity oracle): logits and cache bytes to 1e-4 /
  1e-5 (f32, differing only in summation order); the dead row's cache
  stays as it was.
- ``decode_step_batched_paged`` against the reference's, the same way,
  and bitwise against the port's own slab step on equal logical contents
  (logits and written bytes), as the reference holds its two paths.
- ``paged_prefill``: logits and the written blocks against the
  reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
B, BS, NB = 3, 4, 4                 # rows, block size, blocks per row
T = BS * NB


@pytest.fixture(scope="module")
def pair():
    jm = JGPT(JGPTConfig.tiny())
    jp = jm.init(jax.random.key(0))
    tm = GPT(GPTConfig.tiny())
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


def _slab(tm, seed=0):
    c = tm.cfg
    rs = np.random.RandomState(seed)
    return {n: rs.randn(c.layers, B, T, c.heads, tm.head_dim).astype(
        np.float32) for n in ("k", "v")}


def _paged_from_slab(slab, seed=1):
    """The same logical contents in a pool of shuffled physical blocks
    (block 0 the null block, never named by a live row)."""
    rs = np.random.RandomState(seed)
    l, b, t, h, d = slab["k"].shape
    n = 1 + B * NB
    bt = (rs.permutation(n - 1) + 1).reshape(B, NB).astype(np.int32)
    pools = {}
    for name, x in slab.items():
        pool = rs.randn(l, n, BS, h, d).astype(np.float32)
        for r in range(B):
            for j in range(NB):
                pool[:, bt[r, j]] = x[:, r, j * BS:(j + 1) * BS]
        pools[name] = pool
    return pools, bt


STEPS = [  # per-row pos and alive over three steps; row 2 is dead
    (np.array([5, 9, 3], np.int32), np.array([1, 1, 0], np.int32)),
    (np.array([6, 10, 3], np.int32), np.array([1, 1, 0], np.int32)),
    (np.array([7, 11, 3], np.int32), np.array([1, 1, 0], np.int32)),
]
PAD = np.array([0, 2, 0], np.int32)
TOK0 = np.array([5, 7, 11], np.int32)


def _run_port(tm, tp, slab=None, pools=None, bt=None):
    stacked = tm.stack_decode_params(tp)
    tok, outs = TOK0, []
    for pos, alive in STEPS:
        args = (torch.from_numpy(tok), torch.from_numpy(pos),
                torch.from_numpy(PAD), torch.from_numpy(alive))
        if pools is None:
            lg, slab = tm.decode_step_batched(tp, stacked, slab, *args)
        else:
            lg, pools = tm.decode_step_batched_paged(
                tp, stacked, pools, torch.from_numpy(bt), *args)
        outs.append(lg.numpy())
        tok = lg.argmax(-1).to(torch.int32).numpy()
    return outs, slab if pools is None else pools


def _run_ref(jm, jp, slab=None, pools=None, bt=None):
    stacked = jm.stack_decode_params(jp)
    tok, outs = TOK0, []
    for pos, alive in STEPS:
        args = (jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(PAD),
                jnp.asarray(alive))
        if pools is None:
            lg, slab = jm.decode_step_batched(jp, stacked, slab, *args,
                                              decode_attention="xla")
        else:
            lg, pools = jm.decode_step_batched_paged(
                jp, stacked, pools, jnp.asarray(bt), *args,
                decode_attention="xla")
        outs.append(np.asarray(lg))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    return outs, slab if pools is None else pools


def _torch(d):
    return {n: torch.from_numpy(x.copy()) for n, x in d.items()}


def _jax(d):
    return {n: jnp.asarray(x) for n, x in d.items()}


def test_decode_step_batched_matches_reference(pair):
    jm, jp, tm, tp = pair
    slab0 = _slab(tm)
    got, got_c = _run_port(tm, tp, slab=_torch(slab0))
    want, want_c = _run_ref(jm, jp, slab=_jax(slab0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:2], w[:2], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_c[n].numpy(), np.asarray(want_c[n]),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
        # the dead row rewrote the bytes it read: its slab is unchanged
        np.testing.assert_array_equal(got_c[n][:, 2].numpy(),
                                      slab0[n][:, 2])


def test_decode_step_batched_matches_reference_loop_step(pair):
    """Each live row of the batched step against the reference's
    per-layer loop step run on that row alone (scalar pos)."""
    jm, jp, tm, tp = pair
    slab0 = _slab(tm, seed=2)
    got, _ = _run_port(tm, tp, slab=_torch(slab0))
    c = jm.cfg
    for r in (0, 1):
        caches = {f"layer_{i}": {n: jnp.asarray(slab0[n][i, r:r + 1])
                                 for n in ("k", "v")}
                  for i in range(c.layers)}
        tok = TOK0[r:r + 1]
        for step, (pos, _) in enumerate(STEPS):
            lg, caches = jm._decode_step(jp, caches, jnp.asarray(tok),
                                         jnp.int32(pos[r]),
                                         jnp.asarray(PAD[r:r + 1]))
            np.testing.assert_allclose(got[step][r], np.asarray(lg)[0],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
            tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)


def test_decode_step_batched_paged_matches_reference_and_slab(pair):
    jm, jp, tm, tp = pair
    slab0 = _slab(tm, seed=3)
    pools0, bt = _paged_from_slab(slab0)
    got, got_p = _run_port(tm, tp, pools=_torch(pools0), bt=bt)
    want, want_p = _run_ref(jm, jp, pools=_jax(pools0), bt=bt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:2], w[:2], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_p[n].numpy(), np.asarray(want_p[n]),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
    # bitwise the port's slab step on equal logical contents
    slab_lg, slab_c = _run_port(tm, tp, slab=_torch(slab0))
    for g, s in zip(got, slab_lg):
        np.testing.assert_array_equal(g[:2], s[:2])
    for n in ("k", "v"):
        gathered = got_p[n].numpy()[:, bt].reshape(slab0[n].shape)
        np.testing.assert_array_equal(gathered[:, :2],
                                      slab_c[n].numpy()[:, :2])


def test_paged_prefill_matches_reference(pair):
    jm, jp, tm, tp = pair
    c = tm.cfg
    rs = np.random.RandomState(4)
    prompt_len, p = 8, 6
    ids = np.zeros((1, prompt_len), np.int32)
    mask = np.zeros((1, prompt_len), np.int32)
    ids[0, :p] = rs.randint(0, c.vocab_size, p)
    mask[0, :p] = 1
    table_row = np.array([2, 4], np.int32)
    shape = (c.layers, 6, BS, c.heads, tm.head_dim)
    pools = {n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}
    want_lg, wk, wv = jm.paged_prefill(
        jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pools["k"]),
        jnp.asarray(pools["v"]), jnp.asarray(table_row))
    tpools = _torch(pools)
    got_lg, gk, gv = tm.paged_prefill(
        tp, torch.from_numpy(ids), torch.from_numpy(mask), tpools["k"],
        tpools["v"], torch.from_numpy(table_row))
    assert gk is tpools["k"] and gv is tpools["v"]         # in place
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for got, want, old in ((gk, wk, pools["k"]), (gv, wv, pools["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
        untouched = [b for b in range(6) if b not in table_row]
        np.testing.assert_array_equal(got.numpy()[:, untouched],
                                      old[:, untouched])
