"""The port's parameter EMA and bf16 first moments against the JAX
package's (the counterpart of ``tests/test_ema.py``), on the CPU.

The shadow parameters ride in the optimizer state as the chain's last
link (``train/optimizers.py`` ``params_ema``): started at the initial
params, f32 whatever the params' dtype, advanced once an applied step,
kept on a skipped one, checkpointed under the reference's opt-state keys
(``opt_state/<i>/count``, ``opt_state/<i>/ema/<param>``), used by eval
and the export. ``moment_dtype="bfloat16"`` stores the first moment in
bf16 and leaves the step's update to the unrounded f32 moment, as optax
does. Every optimizer state is held leaf by leaf to optax's on the same
gradients; f32 tolerances are stated per test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.mlp import (
    MLP, params_from_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.optimizers import (
    EmaState, find_ema_params, make_optimizer)
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from distributed_tensorflow_example_tpu_torch.utils.pytree import flatten_dict

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _step(tx, params: dict, grads: dict, state):
    """One port update over nested dicts: (new params, new state)."""
    keys = list(params)
    leaves = [params[k] for k in keys]
    upd, state = tx.update([grads[k] for k in keys], state, leaves)
    return dict(zip(keys, topt.apply_updates(leaves, upd))), state


def _init(tx, params: dict):
    return tx.init(list(params.values()))


# ---------------------------------------------------------------------------
# the shadow's arithmetic
# ---------------------------------------------------------------------------

def test_ema_closed_form():
    """3 SGD steps with constant grads: the shadow equals the recurrence
    ``ema <- d ema + (1 - d) params_after_step`` (within 1e-6), and the
    reference's shadow for the same steps bit for bit."""
    d, lr = 0.9, 0.1
    cfg = dict(name="sgd", learning_rate=lr, ema_decay=d)
    tx = make_optimizer(tconfig.OptimizerConfig(**cfg))
    jtx = jopt.make_optimizer(jconfig.OptimizerConfig(**cfg))
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([1.0, -1.0])}
    jparams = {"w": jnp.array([1.0, 2.0])}
    state, js = _init(tx, params), jtx.init(jparams)
    exp_p = np.array([1.0, 2.0])
    exp_ema = exp_p.copy()
    for _ in range(3):
        params, state = _step(tx, params, grads, state)
        ju, js = jtx.update({"w": jnp.array([1.0, -1.0])}, js, jparams)
        jparams = optax.apply_updates(jparams, ju)
        exp_p = exp_p - lr * np.array([1.0, -1.0])
        exp_ema = d * exp_ema + (1 - d) * exp_p
        np.testing.assert_allclose(params["w"].numpy(), exp_p, rtol=1e-6)
        ema = find_ema_params(state, params)
        np.testing.assert_allclose(ema["w"].numpy(), exp_ema, rtol=1e-6)
        np.testing.assert_array_equal(
            ema["w"].numpy(), np.asarray(jopt.find_ema_params(js)["w"]))


def test_ema_debias_ramp():
    """The num_updates ramp: update n decays by min(decay, (1+n)/(10+n)),
    so update 1 uses 2/11, not 0.999."""
    tx = make_optimizer(tconfig.OptimizerConfig(
        name="sgd", learning_rate=0.5, ema_decay=0.999, ema_debias=True))
    params = {"w": torch.tensor([0.0])}
    state = _init(tx, params)
    new, state = _step(tx, params, {"w": torch.tensor([-2.0])}, state)
    assert float(new["w"][0]) == pytest.approx(1.0)
    d1 = 2.0 / 11.0
    np.testing.assert_allclose(find_ema_params(state, new)["w"].numpy(),
                               [d1 * 0.0 + (1 - d1) * 1.0], rtol=1e-6)


def test_ema_starts_at_the_init_params_in_its_own_memory():
    """The shadow starts equal to the params, in buffers of its own (a
    later in-place change of a param leaves it alone)."""
    tx = make_optimizer(tconfig.OptimizerConfig(name="adam",
                                                ema_decay=0.99))
    params = {"k": torch.ones(3, 3)}
    state = _init(tx, params)
    ema = find_ema_params(state, params)
    np.testing.assert_array_equal(ema["k"].numpy(), np.ones((3, 3)))
    params["k"].add_(1.0)
    np.testing.assert_array_equal(ema["k"].numpy(), np.ones((3, 3)))


@pytest.mark.parametrize("name", ["adam", "adafactor"])
def test_find_ema_none_when_disabled(name):
    """No EMA, no shadow: adafactor's momentum average (optax's
    ``EmaState``, the same fields) is not taken for one."""
    tx = make_optimizer(tconfig.OptimizerConfig(name=name, momentum=0.9))
    params = {"k": torch.ones(2, 130)}
    assert find_ema_params(_init(tx, params), params) is None


def test_ema_shadow_stays_f32_under_bf16_params():
    """At decay 0.999 a bf16 shadow would round the 1e-3-scale increments
    away and freeze at init: the shadow is f32 whatever the params'
    dtype, and it moves."""
    tx = make_optimizer(tconfig.OptimizerConfig(
        name="sgd", learning_rate=0.25, ema_decay=0.999))
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = _init(tx, params)
    assert find_ema_params(state, params)["w"].dtype == torch.float32
    for _ in range(4):
        params, state = _step(tx, params,
                              {"w": torch.ones(4, dtype=torch.bfloat16)},
                              state)
    ema = find_ema_params(state, params)
    assert float((ema["w"] - 1.0).abs().max()) > 0


# ---------------------------------------------------------------------------
# every optimizer state against optax's, f32 and bf16 moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adam", "momentum", "adafactor"])
def test_optimizer_state_equals_optax(name, moment_dtype):
    """4 steps on the same random gradients (one leaf factored by
    adafactor, one not, one vector), with the parameter EMA on: every
    leaf of the optimizer state against the reference's by its
    checkpoint key, the stored first moment in ``moment_dtype``, ``nu``
    and the shadows f32. f32 leaves and the params within 1e-6 of each
    leaf's largest value, which shows the update read the unrounded
    moment; bf16 leaves within one bf16 ulp of it (the f32 moments they
    round differ by summation order only, and a value on a rounding
    boundary may go either way). Adafactor's factored statistics sum in
    another order, so one of its bf16 momenta may round the other way and
    move its element's next update by that ulp: under bf16 adafactor the
    f32 leaves and the params are held to lr 2^-8 of their largest value
    (measured: 2 of 18,200 elements of one leaf off by 4.3e-5; the other
    optimizers' bf16 runs measured exact, and an update from the rounded
    moment would miss their 1e-6 by ~25x)."""
    cfg = dict(name=name, learning_rate=0.05, momentum=0.9,
               weight_decay=0.01 if name == "adamw" else 0.0,
               moment_dtype=moment_dtype, ema_decay=0.99, ema_debias=True)
    tx = make_optimizer(tconfig.OptimizerConfig(**cfg))
    jtx = jopt.make_optimizer(jconfig.OptimizerConfig(**cfg))
    rs = np.random.RandomState(0)
    shapes = {"a": (130, 140), "b": (16, 24), "c": (24,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, js = _init(tx, params), jtx.init(jparams)
    for _ in range(4):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        params, state = _step(tx, params, {k: torch.from_numpy(v)
                                           for k, v in g.items()}, state)
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jparams)
        jparams = optax.apply_updates(jparams, ju)
    want = jckpt._flatten({"opt_state": js})
    got = tckpt.to_numpy(dict(tckpt._tree_items(state, "opt_state",
                                                list(params))))
    assert sorted(got) == sorted(want)
    bf16 = [k for k in got if k.startswith(tckpt.BF16_PREFIX)]
    assert bool(bf16) == (moment_dtype == "bfloat16")
    rel = (cfg["learning_rate"] * 2.0 ** -8
           if bf16 and name == "adafactor" else 1e-6)
    for k, w in want.items():
        w = np.asarray(w)
        if k.startswith(tckpt.BF16_PREFIX):
            assert "/mu/" in k or "/trace/" in k or "/ema/" in k, k
            a = torch.from_numpy(got[k].view(np.int16)).view(
                torch.bfloat16).float().numpy()
            b = torch.from_numpy(w.view(np.int16)).view(
                torch.bfloat16).float().numpy()
            tol = 2.0 ** -7 * np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=rel * np.abs(w).max(),
                                       err_msg=k)
    for k in shapes:
        w = np.asarray(jparams[k])
        np.testing.assert_allclose(params[k].numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=k)


def test_lars_and_lamb_refuse_bf16_moments_as_the_reference():
    for name in ("lars", "lamb"):
        for make, cfg in ((make_optimizer, tconfig),
                          (jopt.make_optimizer, jconfig)):
            with pytest.raises(ValueError, match=f"not supported for {name}"):
                make(cfg.OptimizerConfig(name=name, moment_dtype="bfloat16"))


# ---------------------------------------------------------------------------
# the shadow through the sync step, the Trainer and checkpoints
# ---------------------------------------------------------------------------

def _mlp_sync(opt: dict, accum: int = 1, policy: str = "halt"):
    m = MLP()
    sync = SyncReplicas(m.loss, make_optimizer(tconfig.OptimizerConfig(
        **opt)), device="cpu", sync=tconfig.SyncConfig(accum_steps=accum),
        anomaly_policy=policy)
    return m, sync, sync.init(m.init, seed=0)


def test_ema_threads_through_sync_replicas_and_accum():
    """Under ``accum_steps`` 2 the shadow advances once an applied step:
    after each of 3 steps it equals ``d e + (1 - d) p`` recomputed from
    the live params' history (bitwise: the same f32 operations), and a
    NaN step under ``skip`` keeps shadow and count."""
    d = 0.5
    m, sync, state = _mlp_sync(dict(name="sgd", learning_rate=0.1,
                                    ema_decay=d), accum=2)
    data = synthetic_mnist(64, 8)
    batch = {"x": data["train_x"][:32], "y": data["train_y"][:32]}
    closed = {k: v.float().clone()
              for k, v in flatten_dict(state.params).items()}
    dd = torch.tensor(d)
    for _ in range(3):
        state, _ = sync.step(state, batch)
        live = flatten_dict(state.params)
        closed = {k: closed[k] * dd + live[k].float() * (1.0 - dd)
                  for k in closed}
        ema = flatten_dict(find_ema_params(state.opt_state, state.params))
        for k in closed:
            assert torch.equal(ema[k], closed[k]), k
    ema_state = [s for s in state.opt_state if isinstance(s, EmaState)][0]
    assert int(ema_state["count"]) == 3
    m, skip, s0 = _mlp_sync(dict(name="sgd", learning_rate=0.1,
                                 ema_decay=d), policy="skip")
    s1, met = skip.step(s0, {"x": np.full_like(batch["x"], np.nan),
                             "y": batch["y"]})
    assert int(met["anomaly_count"]) == 1
    for a, b in zip(s1.opt_state[-1]["ema"], s0.opt_state[-1]["ema"]):
        assert torch.equal(a, b)
    assert int(s1.opt_state[-1]["count"]) == 0


def _trainer(tmp_path, opt: dict, steps: int, **kw) -> Trainer:
    data = synthetic_mnist(1024, 256)
    cfg = tconfig.TrainConfig(
        model="mlp", train_steps=steps,
        data=tconfig.DataConfig(batch_size=128),
        optimizer=tconfig.OptimizerConfig(**opt),
        obs=tconfig.ObservabilityConfig(log_every_steps=0), **kw)
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": data["train_x"], "y": data["train_y"]},
                   {"x": data["test_x"], "y": data["test_y"]},
                   device="cpu", process_index=0, num_processes=1)


def test_eval_uses_the_shadow_and_takes_a_batch_size(tmp_path):
    """``Trainer.evaluate`` defaults to the shadow when the EMA is on: a
    shadow kept near init (decay 0.9999) scores well under the trained
    live params after 60 steps; ``batch_size`` regroups the eval set
    without moving its metrics (within 1e-6)."""
    with _trainer(tmp_path, dict(name="sgd", learning_rate=0.5,
                                 ema_decay=0.9999), 60) as tr:
        state, summary = tr.train()
        live = tr.evaluate(state, use_ema=False)
        shadow = tr.evaluate(state)
        assert summary["eval"] == shadow
        assert live["accuracy"] > shadow["accuracy"] + 0.1, (live, shadow)
        regrouped = tr.evaluate(state, batch_size=100, use_ema=False)
    for k in live:
        assert regrouped[k] == pytest.approx(live[k], rel=1e-6, abs=1e-7)


def test_explicit_use_ema_without_ema_raises(tmp_path):
    with _trainer(tmp_path, dict(name="sgd", learning_rate=0.5), 1) as tr:
        state, _ = tr.train()
        with pytest.raises(ValueError, match="use_ema"):
            tr.evaluate(state, use_ema=True)


def _ref_pair(opt: dict):
    """The reference's MLP sync step and state (seed 0) and the port's
    on the same weights."""
    jm = JMLP()
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(
        jconfig.OptimizerConfig(**opt)), local_mesh(1), donate=False)
    js = jsync.init(jm.init, seed=0)
    tm = MLP()
    tsync = SyncReplicas(tm.loss, make_optimizer(tconfig.OptimizerConfig(
        **opt)), device="cpu")
    tp = params_from_numpy(tm, jckpt._flatten(jax.device_get(js.params)),
                           "cpu")
    return jsync, js, tsync, tsync.init(lambda gen: tp, seed=0)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_checkpoints_with_ema_cross_both_ways(tmp_path, moment_dtype):
    """AdamW with the EMA and ``moment_dtype``: the reference's checkpoint
    after 2 steps restores into the port (shadows, count, bf16 ``mu``
    bitwise), the next step's loss agrees within 1e-5, and the port's
    checkpoint of that step restores into the reference with every key
    equal to what the port holds; the port restores its own bitwise."""
    opt = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
               moment_dtype=moment_dtype, ema_decay=0.9, ema_debias=True)
    jsync, js, tsync, ts = _ref_pair(opt)
    data = synthetic_mnist(512, 8)
    batches = [{"x": data["train_x"][i * 64:(i + 1) * 64],
                "y": data["train_y"][i * 64:(i + 1) * 64]} for i in range(3)]
    for b in batches[:2]:
        js, _ = jsync.step(js, jsync.shard_batch(b))
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(js)
    ts = tckpt.CheckpointManager(str(tmp_path / "ref")).restore(ts)
    assert ts.step == 2
    want = jckpt._flatten(jax.device_get({"params": js.params,
                                          "opt_state": js.opt_state}))
    got = tckpt.state_arrays(ts)
    assert any("/ema/" in k for k in want)
    assert any(k.startswith("__bf16__/opt_state") for k in want) == (
        moment_dtype == "bfloat16")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    js, jmet = jsync.step(js, jsync.shard_batch(batches[2]))
    ts, tmet = tsync.step(ts, batches[2])
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    tckpt.CheckpointManager(str(tmp_path / "port")).save(ts)
    back = jckpt.CheckpointManager(str(tmp_path / "port")).restore(js)
    assert int(back.step) == 3
    got = tckpt.state_arrays(ts)
    for k, v in jckpt._flatten(jax.device_get(
            {"params": back.params, "opt_state": back.opt_state})).items():
        np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)
    again = tckpt.CheckpointManager(str(tmp_path / "port")).restore(
        tsync.init(MLP().init, seed=5))
    assert isinstance(again.opt_state[-1], EmaState)
    for k, v in tckpt.state_arrays(again).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def test_cli_exports_the_shadow_and_halves_the_moment_bytes(tmp_path):
    """``cli.train --ema_decay 0.9 --moment_dtype bfloat16 --export_dir``:
    the checkpoint's ``mu`` leaves are bf16 (half the f32 run's bytes),
    and the exported params are the final EMA shadow, not the live
    params."""
    base = ["--model", "mlp", "--device", "cpu", "--batch_size", "64",
            "--optimizer", "adam", "--learning_rate", "1e-3",
            "--train_steps", "5", "--log_every_steps", "0",
            "--save_steps", "5"]
    mu_bytes = {}
    for md in ("float32", "bfloat16"):
        ck, ex = str(tmp_path / f"ck_{md}"), str(tmp_path / f"ex_{md}")
        assert tcli.main(base + ["--ckpt_dir", ck, "--export_dir", ex,
                                 "--moment_dtype", md, "--ema_decay",
                                 "0.9"]) == 0
        arrays = tckpt.load_npz(os.path.join(ck, "ckpt-5.npz"))
        mu = {k: v for k, v in arrays.items() if "/mu/" in k}
        assert all(k.startswith("__bf16__/") == (md == "bfloat16")
                   for k in mu)
        mu_bytes[md] = sum(v.nbytes for v in mu.values())
        exported = tckpt.load_npz(os.path.join(ex, "params.npz"))
        for k, v in exported.items():
            np.testing.assert_array_equal(
                v, arrays[f"opt_state/1/ema/{k}"], err_msg=k)
            assert not np.array_equal(v, arrays[f"params/{k}"]) \
                or k.endswith("bias"), k
        with open(os.path.join(ex, "export.json")) as f:
            assert json.load(f)["batch_polymorphic"] is True
    assert mu_bytes["bfloat16"] * 2 == mu_bytes["float32"]
