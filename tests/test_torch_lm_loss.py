"""The port's LM-head losses (``ops/losses.py`` ``lm_head_xent``: full,
chunked, fused) against each other and against the JAX package's same
impls, on the CPU in f32.

Inputs are seeded numpy arrays fed to both packages. The vocab (1000)
is not a multiple of the vocab blocks tried, so the fused pass always
pads its last block, and one token's largest logit is tied exactly
between two columns in different blocks, so the argmax's
first-occurrence rule is exercised across blocks. Tolerances are the
reference's own (``tests/test_fused_lm_loss.py``): rtol 1e-6 on losses
and accuracies, 2e-5 (with an atol of 1e-7 for gradients that are ~0)
on gradients; the fused and full impls differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ops import losses as jlosses
from distributed_tensorflow_example_tpu_torch.ops import losses as tlosses

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-7
V, HD = 1000, 32


def _inputs(shape, bias: bool, seed=0):
    """h [*shape, HD], table [V, HD], bias [V] or None, labels and
    weights [*shape]; token 0's best column is copied 500 columns away
    (with its bias), an exact tie the argmax must resolve to the
    earlier column."""
    rs = np.random.RandomState(seed)
    h = rs.randn(*shape, HD).astype(np.float32)
    table = (rs.randn(V, HD) * 0.5).astype(np.float32)
    b = (rs.randn(V) * 0.1).astype(np.float32) if bias else None
    labels = rs.randint(0, V, shape).astype(np.int32)
    w = (rs.rand(*shape) > 0.25).astype(np.float32)
    h0 = h.reshape(-1, HD)[0]
    logits0 = table @ h0 + (0 if b is None else b)
    best = int(np.argmax(logits0))
    first, twin = (best, best + 500) if best < 500 else (best - 500, best)
    src, dst = (first, twin) if best == first else (twin, first)
    table[dst] = table[src]
    if b is not None:
        b[dst] = b[src]
    logits0 = table @ h0 + (0 if b is None else b)
    assert logits0[first] == logits0[twin] == logits0.max()
    assert np.argmax(logits0) == first
    return h, table, b, labels, w


def _torch_run(impl, h, table, b, labels, w, **kw):
    th = torch.tensor(h, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    tb = None if b is None else torch.tensor(b, requires_grad=True)
    loss, acc = tlosses.lm_head_xent(th, tt, torch.tensor(labels),
                                     torch.tensor(w), bias=tb, impl=impl,
                                     **kw)
    leaves = [th, tt] + ([] if tb is None else [tb])
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), float(acc), [g.numpy() for g in grads]


def _jax_run(impl, h, table, b, labels, w, **kw):
    def f(h_, t_, b_):
        return jlosses.lm_head_xent(h_, t_, jnp.asarray(labels),
                                    jnp.asarray(w), bias=b_, impl=impl, **kw)

    args = [jnp.asarray(h), jnp.asarray(table),
            None if b is None else jnp.asarray(b)]
    argnums = (0, 1) if b is None else (0, 1, 2)
    (loss, acc), grads = jax.value_and_grad(f, argnums=argnums,
                                            has_aux=True)(*args)
    return float(loss), float(acc), [np.asarray(g) for g in grads]


def _close(got, want, what):
    gl, ga, gg = got
    wl, wa, wg = want
    np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(ga, wa, rtol=LOSS_RTOL, err_msg=what)
    for i, (a, b) in enumerate(zip(gg, wg)):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} grad {i}")


@pytest.mark.parametrize("head,block", [("bert", 0), ("bert", 256),
                                        ("gpt", 128), ("gpt", 300)])
def test_fused_matches_full_and_the_reference(head, block):
    """BERT's head (MLM positions [B, M], with bias) and GPT's ([B, S],
    no bias): the fused impl's loss, accuracy and the h, table (and
    bias) gradients equal the port's full impl and the reference's fused
    impl."""
    shape = (3, 8) if head == "bert" else (2, 16)
    x = _inputs(shape, bias=head == "bert")
    fused = _torch_run("fused", *x, vocab_block=block)
    _close(fused, _torch_run("full", *x), f"{head} fused vs full")
    _close(fused, _jax_run("fused", *x, vocab_block=block),
           f"{head} fused vs reference")


def test_fused_argmax_keeps_the_earliest_tie_and_pads_the_tail():
    """Per token: the fused argmax equals torch.argmax over the full
    logits (first occurrence across blocks), and the padded tail block
    adds nothing to the log-sum-exp."""
    h, table, b, labels, _ = _inputs((1, 12), bias=True)
    th, tt, tb = (torch.tensor(h[0]), torch.tensor(table),
                  torch.tensor(b))
    nll, idx = tlosses.fused_linear_xent(th, tt, torch.tensor(labels[0]),
                                         bias=tb, vocab_block=128)
    logits = th @ tt.t() + tb
    assert torch.equal(idx.long(), logits.argmax(dim=-1))
    assert int(idx[0]) < 500
    want = (torch.logsumexp(logits, -1)
            - logits.gather(1, torch.tensor(labels[0]).long()[:, None])[:, 0])
    np.testing.assert_allclose(nll.numpy(), want.numpy(), rtol=LOSS_RTOL)


@pytest.mark.parametrize("accuracy", [True, False])
def test_chunked_matches_full_and_the_reference(accuracy):
    """GPT's sequence-chunked impl (4 chunks of 4) equals the full impl
    and the reference's chunked impl; without the argmax both give the
    -1.0 sentinel."""
    x = _inputs((2, 16), bias=False, seed=1)
    got = _torch_run("chunked", *x, seq_chunk=4, accuracy=accuracy)
    _close(got, _torch_run("full", *x, accuracy=accuracy),
           "chunked vs full")
    _close(got, _jax_run("chunked", *x, seq_chunk=4, accuracy=accuracy),
           "chunked vs reference")
    if not accuracy:
        assert got[1] == -1.0


@pytest.mark.parametrize("kw,exc,match", [
    (dict(impl="chunked", seq_chunk=5), ValueError, "must divide"),
    (dict(impl="chunked"), ValueError, "seq_chunk >= 1"),
    (dict(impl="full", vocab_block=64), ValueError, "requires impl='fused'"),
    (dict(impl="fused", seq_chunk=4), ValueError, "chunked impl's lever"),
    (dict(impl="fused", vocab_block=-1), ValueError, "must be >= 1"),
    (dict(impl="blocked"), ValueError, "lm_loss_impl must be one of"),
])
def test_lm_head_xent_refuses_what_the_reference_refuses(kw, exc, match):
    h, table, _, labels, w = _inputs((2, 16), bias=False)
    for pkg, conv in ((tlosses, torch.tensor), (jlosses, jnp.asarray)):
        with pytest.raises(exc, match=match):
            pkg.lm_head_xent(conv(h), conv(table), conv(labels), conv(w),
                             **kw)


# ---------------------------------------------------------------------------
# GPT's every-n accuracy cadence
# ---------------------------------------------------------------------------

GPT_TINY = dict(vocab_size=512, hidden=64, layers=2, heads=2,
                intermediate=128, max_len=64, dropout=0.0)


def _cadence_pair(every: int):
    """GPT-tiny with ``accuracy_every_n=every`` in both packages (no
    dropout), same weights, through each package's sync step (AdamW)."""
    from distributed_tensorflow_example_tpu import config as jconfig
    from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
    from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
    from distributed_tensorflow_example_tpu.models.gpt import \
        GPTConfig as JGPTConfig
    from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
    from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
        SyncReplicas as JSyncReplicas
    from distributed_tensorflow_example_tpu.train import optimizers as jopt
    from distributed_tensorflow_example_tpu_torch import config as tconfig
    from distributed_tensorflow_example_tpu_torch.models.gpt import (
        GPT, GPTConfig, params_from_numpy)
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train import \
        optimizers as topt
    opt = dict(name="adamw", learning_rate=1e-3)
    jm = JGPT(JGPTConfig(**GPT_TINY), accuracy_every_n=every)
    jp, jextras = jm.init(jax.random.key(0)), {}
    tm = GPT(GPTConfig(**GPT_TINY), accuracy_every_n=every)
    textras = {}
    if every != 1:                      # init gives (params, extras)
        (jp, jextras), (_, textras) = jp, tm.init(0, device="cpu")
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(
        jconfig.OptimizerConfig(**opt)), local_mesh(1), donate=False)
    tsync = SyncReplicas(tm.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(**opt)), device="cpu")
    return (jsync, jsync.init(lambda rng: (jp, jextras), seed=0), tsync,
            tsync.init(lambda gen: (tp, textras), seed=0))


def _lm_batch(seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, GPT_TINY["vocab_size"], (4, 32)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def test_every_n_accuracy_cadence_matches_reference(tmp_path):
    """``token_accuracy_every_n=2``: the accuracy is real on steps whose
    counter is a multiple of 2 and the -1.0 sentinel on the others, the
    same as the reference's each step; ``extras/lm_step`` (f32) ticks
    once a step, crosses the npz bridge both ways, and a checkpoint
    written without it fails at restore with the reference's message."""
    from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
    from distributed_tensorflow_example_tpu_torch.ckpt import \
        checkpoint as tckpt
    jsync, js, tsync, ts = _cadence_pair(2)
    assert ts.extras["lm_step"].dtype == torch.float32
    accs = []
    for step in range(4):
        batch = _lm_batch(step)
        js, jmet = jsync.step(js, jsync.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}))
        ts, tmet = tsync.step(ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["token_accuracy"]),
                                   float(jmet["token_accuracy"]), atol=1e-5)
        accs.append(float(tmet["token_accuracy"]))
        assert float(ts.extras["lm_step"]) == step + 1
    assert accs[1] == accs[3] == -1.0 and min(accs[0], accs[2]) >= 0.0
    tckpt.CheckpointManager(str(tmp_path / "port")).save(ts)
    back = jckpt.CheckpointManager(str(tmp_path / "port")).restore(js)
    assert float(back.extras["lm_step"]) == 4.0
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(js, 4)
    again = tckpt.CheckpointManager(str(tmp_path / "ref")).restore(ts)
    assert float(again.extras["lm_step"]) == 4.0
    # the knob turned on over a run written without the counter
    _, _, plain_sync, plain = _cadence_pair(1)
    tckpt.CheckpointManager(str(tmp_path / "old")).save(plain)
    with pytest.raises(KeyError, match="missing leaf 'extras/lm_step'"):
        tckpt.CheckpointManager(str(tmp_path / "old")).restore(ts)


def test_every_n_cadence_refusals_are_the_references():
    """The cadence is refused beside the fused head (its accuracy is
    free) and with microbatches (the counter would tick per microbatch),
    by the model and by the config, as in the reference."""
    from distributed_tensorflow_example_tpu import config as jconfig
    from distributed_tensorflow_example_tpu_torch import config as tconfig
    from distributed_tensorflow_example_tpu_torch.models.gpt import (
        GPT, GPTConfig)
    with pytest.raises(ValueError, match="computes accuracy inside"):
        GPT(GPTConfig(**dict(GPT_TINY, loss_impl="fused")),
            accuracy_every_n=2)
    for mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match="does not compose"):
            mod.lm_loss_settings(mod.TrainConfig(
                token_accuracy_every_n=2,
                sync=mod.SyncConfig(accum_steps=2)))
        with pytest.raises(ValueError, match="at no extra cost"):
            mod.lm_loss_settings(mod.TrainConfig(
                token_accuracy_every_n=2, lm_loss_impl="fused"))
