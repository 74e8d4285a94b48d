"""The port's training step against the JAX package's, on the CPU: the
LM-head loss, GPT's loss, metrics and grads, the learning-rate schedules,
the optimizers and ``SyncReplicas``, on bridged weights and numpy-seeded
inputs, in f32 unless a test says otherwise.

The GPT pair is ``test_torch_gpt.py``'s SMALL configuration (2 heads of
64, so the JAX package's Pallas flash kernel engages at S = 128) with
dropout off in both packages (their random streams differ by design).
Tolerances are stated per test; f32 differences come from summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.ops import losses as jlosses
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.ops import losses as tlosses
from distributed_tensorflow_example_tpu_torch.ops import nn as tnn
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import (
    SyncReplicas, make_sync_train_step)
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.state import (
    param_bytes, param_count)
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, unflatten_dict)
from test_torch_gpt import SMALL

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

F32_TOL = 1e-4


def make_pair(dtype="float32", attention_impl="xla", seed=0):
    """The SMALL GPT in both packages, dropout off, same weights."""
    jm = JGPT(JGPTConfig(**SMALL, dropout=0.0), dtype=getattr(jnp, dtype),
              attention_impl=attention_impl)
    jp = jm.init(jax.random.key(seed))
    tm = GPT(GPTConfig(**SMALL, dropout=0.0), dtype=getattr(torch, dtype),
             attention_impl=attention_impl)
    return jm, jp, tm, params_from_numpy(tm, _flatten(jp), device="cpu")


def lm_batch(b=2, s=128, seed=0, pad_rows=(1,), pad=28):
    """Token ids and an attention mask whose ``pad_rows`` end in ``pad``
    padding tokens (no loss, no key)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, SMALL["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    for r in pad_rows:
        mask[r, s - pad:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_value_and_grad(tm, tp, batch):
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten_dict(tp).items()}
    loss, (aux, _) = tm.loss(unflatten_dict(flat), {}, _torch(batch))
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), aux, dict(zip(flat, grads))


# ---------------------------------------------------------------------------
# LM-head loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accuracy", [True, False])
def test_lm_head_xent_full_matches_reference(accuracy):
    """``impl="full"`` loss and accuracy (and the -1.0 sentinel when the
    argmax is skipped) with zero-weight tokens, f32: 1e-6."""
    rs = np.random.RandomState(0)
    h = rs.randn(2, 9, 16).astype(np.float32)
    table = rs.randn(40, 16).astype(np.float32)
    labels = rs.randint(0, 40, (2, 9)).astype(np.int32)
    w = (rs.rand(2, 9) > 0.3).astype(np.float32)
    want = jlosses.lm_head_xent(jnp.asarray(h), jnp.asarray(table),
                                jnp.asarray(labels), jnp.asarray(w),
                                accuracy=accuracy)
    got = tlosses.lm_head_xent(torch.from_numpy(h), torch.from_numpy(table),
                               torch.from_numpy(labels), torch.from_numpy(w),
                               accuracy=accuracy)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    nll = tlosses.token_nll(torch.from_numpy(h[0] @ table.T),
                            torch.from_numpy(labels[0]))
    ref = jlosses.token_nll(jnp.asarray(h[0] @ table.T),
                            jnp.asarray(labels[0]))
    np.testing.assert_allclose(nll.numpy(), np.asarray(ref), rtol=1e-6)


def test_lm_head_xent_refuses_the_impls_of_a_later_slice():
    """Every impl runs now (``tests/test_torch_lm_loss.py`` holds them
    to the reference); what stays refused is what the reference
    refuses: a chunked impl without a chunk or on a 2-D hidden stream,
    a lever beside the wrong impl, an unknown impl."""
    x = torch.zeros(1, 2, 4)
    t, lab, w = torch.zeros(3, 4), torch.zeros(1, 2, dtype=torch.int32), \
        torch.ones(1, 2)
    with pytest.raises(ValueError, match="seq_chunk >= 1"):
        tlosses.lm_head_xent(x, t, lab, w, impl="chunked")
    with pytest.raises(ValueError, match="ndim=2"):
        tlosses.lm_head_xent(x[0], t, lab[0], w[0], impl="chunked",
                             seq_chunk=1)
    with pytest.raises(ValueError, match="chunked impl's lever"):
        tlosses.lm_head_xent(x, t, lab, w, impl="fused", seq_chunk=1)
    with pytest.raises(ValueError, match="vocab_block"):
        tlosses.lm_head_xent(x, t, lab, w, vocab_block=8)
    with pytest.raises(ValueError, match="lm_loss_impl"):
        tlosses.lm_head_xent(x, t, lab, w, impl="blocked")


# ---------------------------------------------------------------------------
# GPT loss, metrics and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_gpt_loss_metrics_and_grads_match_reference(attention_impl):
    """``GPT.loss`` (loss, token_accuracy) and the grad of every parameter
    against ``jax.value_and_grad(GPT.loss)``, f32, one row padded; then
    ``eval_metrics``. With ``attention_impl="flash"`` the reference runs
    its Pallas kernels (interpret mode) and the port its Function's plain
    versions. Loss and accuracy within 1e-4, grads within rtol 1e-4 /
    atol 1e-6 (the attention's key biases have a zero gradient, by the
    softmax's shift invariance, so theirs is rounding noise ~1e-9 in
    both packages)."""
    jm, jp, tm, tp = make_pair(attention_impl=attention_impl)
    batch = lm_batch()
    (jl, (jaux, _)), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {}, _jax(batch), None)
    tl, taux, tg = _port_value_and_grad(tm, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    np.testing.assert_allclose(float(taux["token_accuracy"]),
                               float(jaux["token_accuracy"]), atol=F32_TOL)
    jg = _flatten(jg)
    assert sorted(jg) == sorted(tg)
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=F32_TOL, atol=1e-6, err_msg=k)
    want = jm.eval_metrics(jp, {}, _jax(batch))
    got = tm.eval_metrics(tp, {}, _torch(batch))
    assert sorted(got) == sorted(want) == ["loss", "perplexity",
                                           "token_accuracy"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=F32_TOL, err_msg=k)


def test_gpt_eval_metrics_valid_rows_match_reference():
    jm, jp, tm, tp = make_pair()
    batch = lm_batch(b=3, s=16, pad_rows=(0,), pad=5)
    batch["__valid__"] = np.array([1, 1, 0], np.int32)
    want = jm.eval_metrics(jp, {}, _jax(batch))
    got = tm.eval_metrics(tp, {}, _torch(batch))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=F32_TOL, err_msg=k)


def test_gpt_grads_close_in_bf16():
    """bf16 compute in both packages (f32 params), flash attention: the
    two round intermediate bf16 values from differently ordered f32 sums,
    so the loss agrees to 1e-2 and each grad leaf to 5e-2 of its norm."""
    jm, jp, tm, tp = make_pair("bfloat16", attention_impl="flash")
    batch = lm_batch(seed=1)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {}, _jax(batch), None)
    tl, _, tg = _port_value_and_grad(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= 1e-2
    jg = _flatten(jg)
    for k, g in tg.items():
        ref = np.asarray(jg[k], np.float32)
        if k.endswith("attn/k/bias"):       # zero up to rounding
            continue
        err = np.linalg.norm(g.float().numpy() - ref) / np.linalg.norm(ref)
        assert err <= 5e-2, (k, err)


def test_gpt_levers_and_dropout():
    """The reference's LM-loss lever validation, ``accuracy_every_n``
    included (refused beside the fused impl, whose accuracy is free);
    dropout applies only with ``train`` and a generator, and is the same
    for the same seed."""
    with pytest.raises(ValueError, match="needs lm_loss_chunk"):
        GPT(GPTConfig(**SMALL, loss_impl="chunked"))
    with pytest.raises(ValueError, match="requires lm_loss_impl='fused'"):
        GPT(GPTConfig(**SMALL, loss_vocab_block=256))
    with pytest.raises(ValueError, match="conflicts"):
        GPT(GPTConfig(**SMALL, loss_impl="fused", loss_chunk=8))
    legacy = GPT(GPTConfig(**SMALL, loss_chunk=8))
    assert legacy.cfg.loss_impl == "chunked"
    with pytest.raises(ValueError, match="computes accuracy inside"):
        GPT(GPTConfig(**SMALL, loss_impl="fused"), accuracy_every_n=4)
    assert GPT(GPTConfig(**SMALL), accuracy_every_n=4).accuracy_every_n == 4
    tm = GPT(GPTConfig(**SMALL, dropout=0.5))
    tp = tm.init(0, device="cpu")
    batch = _torch(lm_batch(s=16))
    plain = tm.encode(tp, batch)
    assert torch.equal(tm.encode(tp, batch, torch.Generator().manual_seed(1)),
                       plain)
    a, b, c = (tm.loss(tp, {}, batch, torch.Generator().manual_seed(s))[0]
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(tm.loss(tp, {}, batch)[0], a)


def test_dropout_keep_share_scale_and_determinism():
    x = torch.ones(200_000)
    y = tnn.dropout(torch.Generator().manual_seed(3), x, 0.1, train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3   # ~6 sigma
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    again = tnn.dropout(torch.Generator().manual_seed(3), x, 0.1, train=True)
    assert torch.equal(y, again)
    assert tnn.dropout(None, x, 0.1, train=False) is x
    assert tnn.dropout(None, x, 0.0, train=True) is x
    xb = x.to(torch.bfloat16)
    assert tnn.dropout(torch.Generator().manual_seed(3), xb, 0.1,
                       train=True).dtype == torch.bfloat16


def test_config_lm_loss_settings_match_reference():
    for kw in ({}, {"lm_loss_chunk": 16}, {"lm_loss_impl": "full"},
               {"lm_loss_impl": "fused"},
               {"lm_loss_impl": "fused", "lm_loss_vocab_block": 512},
               {"token_accuracy_every_n": 4},
               {"lm_loss_impl": "chunked", "lm_loss_chunk": 8}):
        want = jconfig.lm_loss_settings(jconfig.TrainConfig(**kw))
        got = tconfig.lm_loss_settings(tconfig.TrainConfig(**kw))
        assert got == want, kw
    for kw in ({"lm_loss_impl": "chunked"},
               {"lm_loss_impl": "full", "lm_loss_chunk": 4},
               {"lm_loss_chunk": -1}, {"lm_loss_impl": "blocked"},
               {"lm_loss_vocab_block": 64},
               {"lm_loss_impl": "fused", "token_accuracy_every_n": 2},
               {"token_accuracy_every_n": 2,
                "sync": {"accum_steps": 2}}):
        for mod in (jconfig, tconfig):
            cfg = mod.TrainConfig(**{k: v for k, v in kw.items()
                                     if k != "sync"})
            if "sync" in kw:
                cfg = cfg.replace(sync=mod.SyncConfig(**kw["sync"]))
            with pytest.raises(ValueError):
                mod.lm_loss_settings(cfg)
    m = get_model("gpt_tiny", tconfig.TrainConfig(
        model="gpt_tiny", lm_loss_chunk=16))
    assert (m.cfg.loss_impl, m.cfg.loss_chunk) == ("chunked", 16)


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(decay_schedule="constant", total_steps=100),
    dict(decay_schedule="cosine", total_steps=100, end_learning_rate=0.01),
    dict(decay_schedule="linear", total_steps=100),
    dict(decay_schedule="piecewise", decay_boundaries=(40, 70),
         decay_factor=0.5),
    dict(decay_schedule="exponential", decay_steps=20, decay_factor=0.5),
    dict(decay_schedule="polynomial", decay_steps=80, end_learning_rate=0.01,
         decay_power=2.0),
    dict(decay_schedule="natural_exp", decay_steps=25, decay_factor=0.7),
    dict(decay_schedule="inverse_time", decay_steps=10, decay_factor=0.5),
]


@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["decay_schedule"])
def test_make_schedule_matches_optax(kw, warmup):
    """Every count 0..149 (past the horizons) as an int32 tensor, f32:
    within 1e-6 relative (transcendentals differ by an ulp)."""
    counts = np.arange(150, dtype=np.int32)
    cfg = dict(learning_rate=0.3, warmup_steps=warmup, **kw)
    want = jopt.make_schedule(jconfig.OptimizerConfig(**cfg))(
        jnp.asarray(counts))
    got = topt.make_schedule(tconfig.OptimizerConfig(**cfg))(
        torch.from_numpy(counts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        np.asarray(want, np.float32), counts.shape), rtol=1e-6, atol=1e-9)


def test_schedule_validation_matches_reference():
    for kw in (dict(decay_schedule="piecewise"),
               dict(decay_schedule="piecewise", decay_boundaries=(5,),
                    warmup_steps=5),
               dict(decay_schedule="exponential"),
               dict(decay_schedule="polynomial", total_steps=5,
                    warmup_steps=5),
               dict(decay_schedule="weekly", total_steps=5)):
        with pytest.raises(ValueError):
            jopt.make_schedule(jconfig.OptimizerConfig(**kw))
        with pytest.raises(ValueError):
            topt.make_schedule(tconfig.OptimizerConfig(**kw))


OPTIMIZERS = [
    dict(name="sgd"),
    dict(name="sgd", weight_decay=0.1),
    dict(name="momentum", grad_clip_value=0.5),
    dict(name="adam", grad_clip_norm=1.0),
    dict(name="adamw", weight_decay=0.05, grad_clip_norm=2.0,
         wd_mask="exclude_1d"),
    dict(name="adamw", weight_decay=0.05, wd_mask="all"),
]


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_make_optimizer_matches_optax(kw):
    """Four updates on random params and grads (one leaf of each rank),
    with a cosine schedule behind a warmup: params within 1e-6."""
    cfg = dict(learning_rate=0.1, warmup_steps=2, decay_schedule="cosine",
               total_steps=10, **kw)
    rs = np.random.RandomState(0)
    params = {"a": {"kernel": rs.randn(6, 5).astype(np.float32),
                    "bias": rs.randn(5).astype(np.float32)},
              "b": rs.randn(3, 2, 4).astype(np.float32)}
    jtx = jopt.make_optimizer(jconfig.OptimizerConfig(**cfg))
    ttx = topt.make_optimizer(tconfig.OptimizerConfig(**cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    keys = list(flatten_dict(params))
    tp = [torch.from_numpy(v) for v in flatten_dict(params).values()]
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(4):
        grads = jax.tree_util.tree_map(
            lambda x: (2.0 * rs.randn(*x.shape)).astype(np.float32), params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                            jp)
        jp = optax.apply_updates(jp, ju)
        flat_g = flatten_dict(grads)
        tu, ts = ttx.update([torch.from_numpy(flat_g[k]) for k in keys], ts,
                            tp)
        tp = topt.apply_updates(tp, tu)
        want = flatten_dict(jax.tree_util.tree_map(np.asarray, jp))
        for k, got in zip(keys, tp):
            np.testing.assert_allclose(got.numpy(), want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def test_optimizers_of_later_slices_are_refused():
    for kw, exc, match in ((dict(name="lamb", moment_dtype="bfloat16"),
                            ValueError, "not supported for lamb"),
                           (dict(name="lars", moment_dtype="bfloat16"),
                            ValueError, "not supported for lars"),
                           (dict(moment_dtype="float16"), ValueError,
                            "unknown moment_dtype"),
                           (dict(name="lamb", moment_dtype="float16"),
                            ValueError, "unknown moment_dtype"),
                           (dict(name="rmsprop"), ValueError, "unknown"),
                           (dict(wd_mask="odd"), ValueError, "wd_mask")):
        with pytest.raises(exc, match=match):
            topt.make_optimizer(tconfig.OptimizerConfig(**kw))


# ---------------------------------------------------------------------------
# SyncReplicas
# ---------------------------------------------------------------------------

ADAMW = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
             wd_mask="exclude_1d", grad_clip_norm=1.0, warmup_steps=1,
             decay_schedule="cosine", total_steps=3)


def _sync_pair(opt=ADAMW, accum=1, policy="halt"):
    jm, jp, tm, tp = make_pair()
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(jconfig.OptimizerConfig(**opt)),
        local_mesh(1), sync=jconfig.SyncConfig(accum_steps=accum),
        donate=False, anomaly_policy=policy)
    tsync = SyncReplicas(
        tm.loss, topt.make_optimizer(tconfig.OptimizerConfig(**opt)),
        sync=tconfig.SyncConfig(accum_steps=accum), anomaly_policy=policy,
        device="cpu")
    return (jsync, jsync.init(lambda rng: jp, seed=0),
            tsync, tsync.init(lambda gen: tp, seed=0))


# Adam divides each gradient element by its own running RMS, so where an
# element's gradient is near zero an f32 rounding difference between the
# packages is not scaled down with it: such an element may move differently
# by a fraction of one step (measured: one element of 16384 by 4.4e-5 at
# lr 1e-3; all others within 3e-7). Params are held elementwise to a tenth
# of the lr, and at most 0.1% of each leaf's elements may differ by more
# than 2e-6. The attention's key biases have a zero gradient up to rounding
# (~1e-9) in both packages, which Adam turns into moves of up to one lr a
# step: they are held to the three steps' largest possible move, 3 lr.
def _assert_params_close(tstate, jstate, lr):
    want = _flatten(jax.device_get(jstate.params))
    got = params_to_numpy(tstate.params)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("attn/k/bias"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=3 * lr,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0.1 * lr,
                                   err_msg=k)
        off = float(np.mean(np.abs(got[k] - want[k]) > 2e-6))
        assert off <= 1e-3, (k, off)


@pytest.mark.parametrize("accum", [1, 2])
def test_sync_replicas_adamw_steps_match_reference(accum):
    """Three adamw steps (global-norm clip, masked weight decay, warmup
    and cosine) on one batch per step, with ``accum_steps`` 1 and 2:
    per-step metrics (loss and accuracy 1e-5, the unclipped grad-norm
    1e-4 relative, anomaly_count exact) and the params after each step
    (see :func:`_assert_params_close`)."""
    jsync, js, tsync, ts = _sync_pair(accum=accum)
    for step in range(3):
        batch = lm_batch(b=4, s=32, seed=step, pad_rows=(1, 2), pad=6)
        js, jmet = jsync.step(js, jsync.shard_batch(_jax(batch)))
        ts, tmet = tsync.step(ts, batch)
        assert sorted(tmet) == sorted(jmet)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["token_accuracy"]),
                                   float(jmet["token_accuracy"]), atol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        assert int(tmet["anomaly_count"]) == int(jmet["anomaly_count"]) == 0
        assert ts.step == int(js.step) == step + 1
        _assert_params_close(ts, js, ADAMW["learning_rate"])


@pytest.mark.parametrize("policy", ["halt", "skip", "rollback"])
def test_sync_replicas_nan_batch_is_the_identity_update(policy):
    """A batch whose float attention mask holds a NaN makes the loss NaN
    in both packages: the update is the identity (params and optimizer
    state unchanged), ``step`` and ``anomaly_count`` advance, and the
    metrics are the raw values (halt) or -1.0 (skip, rollback); the next
    finite step matches the reference again."""
    jsync, js, tsync, ts = _sync_pair(policy=policy)
    batch = lm_batch(b=4, s=32, seed=1, pad_rows=(1, 2), pad=6)
    js, _ = jsync.step(js, jsync.shard_batch(_jax(batch)))
    ts, _ = tsync.step(ts, batch)
    before = params_to_numpy(ts.params)
    opt_before = [t.clone() for t in jax.tree_util.tree_leaves(
        ts.opt_state, is_leaf=torch.is_tensor)]
    bad = dict(batch, attention_mask=batch["attention_mask"].astype(
        np.float32))
    bad["attention_mask"][0, 3] = np.nan
    js, jmet = jsync.step(js, jsync.shard_batch(_jax(bad)))
    ts, tmet = tsync.step(ts, bad)
    assert int(tmet["anomaly_count"]) == int(jmet["anomaly_count"]) == 1
    assert ts.step == int(js.step) == 2
    for k, v in params_to_numpy(ts.params).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    opt_after = jax.tree_util.tree_leaves(ts.opt_state,
                                          is_leaf=torch.is_tensor)
    assert all(torch.equal(a, b) for a, b in zip(opt_after, opt_before))
    for k in ("loss", "grad_norm", "token_accuracy"):
        if policy == "halt":
            assert np.isnan(float(tmet[k])) == np.isnan(float(jmet[k])), k
        else:
            assert float(tmet[k]) == float(jmet[k]) == -1.0, k
    js, jmet = jsync.step(js, jsync.shard_batch(_jax(batch)))
    ts, tmet = tsync.step(ts, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _assert_params_close(ts, js, ADAMW["learning_rate"])


def test_sync_replicas_refuses_what_a_later_slice_brings():
    """Named for the refusals it held. One replica per rank: shard_map is
    the same step as auto; more replicas than ranks breaks the rule of
    one rank a card, and replicas_to_aggregate other than the world size
    is the reference's ValueError; ``multi_step``, the last later slice's,
    runs."""
    tm = GPT(GPTConfig(**SMALL))
    tx = topt.make_optimizer(tconfig.OptimizerConfig())
    assert SyncReplicas(tm.loss, tx, device="cpu", sync=tconfig.SyncConfig(
        mode="shard_map")).num_replicas == 1
    with pytest.raises(ValueError, match="replicas_to_aggregate"):
        SyncReplicas(tm.loss, tx, device="cpu",
                     sync=tconfig.SyncConfig(replicas_to_aggregate=2))
    with pytest.raises(NotImplementedError, match="one rank a card"):
        make_sync_train_step(tm.loss, tx, 4, device="cpu")
    with pytest.raises(ValueError, match="sync mode"):
        SyncReplicas(tm.loss, tx, sync=tconfig.SyncConfig(mode="ps"),
                     device="cpu")
    with pytest.raises(ValueError, match="anomaly_policy"):
        SyncReplicas(tm.loss, tx, anomaly_policy="ignore", device="cpu")
    sync = SyncReplicas(tm.loss, tx, device="cpu")
    state = sync.init(tm.init, seed=3)
    assert param_count(state.params) == sum(
        int(np.prod(s)) for s in tm.param_shapes().values())
    assert param_bytes(state.params) == 4 * param_count(state.params)
    # the K-step dispatch (slice A3c-2b) runs: two steps of one stack
    # (``tests/test_torch_multi_step.py`` holds it to single steps)
    stack = {k: np.stack([v, v]) for k, v in lm_batch(
        b=2, s=16, seed=0, pad_rows=(1,), pad=3).items()}
    state, met = sync.multi_step(state, stack)
    assert state.step == 2 and np.isfinite(float(met["loss"]))
