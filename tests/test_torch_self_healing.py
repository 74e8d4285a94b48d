"""The port's self-healing training loop against the JAX package's, on the
CPU: the fault-spec grammar, one-shot and seeded rules, loader retries,
``poison_batch``, the anomaly policies and their budget, rollback to the
uninterrupted run's params (rtol 1e-6, atol 1e-7, the reference's own
tolerance), rollback discarding the rejected checkpoints, the corrupt
latest checkpoint skipped at restart, and the tiny GPT's rollback run
whose loss stream equals the reference's under the same fault spec
(rtol 1e-5, the Trainer-parity tolerance of ``test_torch_trainer.py``).

The counterparts of ``tests/test_self_healing.py``, held to the port.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.data import bert_data as jdata
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.train import hooks as jhooks
from distributed_tensorflow_example_tpu.train.trainer import \
    Trainer as JTrainer
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
    CheckpointManager
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import (
    CheckpointConfig, DataConfig, ObservabilityConfig, OptimizerConfig,
    TrainConfig, anomaly_settings)
from distributed_tensorflow_example_tpu_torch.data import bert_data as tdata
from distributed_tensorflow_example_tpu_torch.data.loader import (
    PrefetchIterator, make_loader)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig)
from distributed_tensorflow_example_tpu_torch.runtime import faults
from distributed_tensorflow_example_tpu_torch.train import hooks as hooks_lib
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from distributed_tensorflow_example_tpu_torch.utils.pytree import \
    flatten_dict

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

DATA = synthetic_mnist(num_train=640, num_test=64, seed=0)


def _cfg(steps=12, *, ckpt_dir=None, save_steps=0, on_anomaly="halt",
         max_anomalies=10, fault_spec="", log_every=4):
    return TrainConfig(
        model="mlp", train_steps=steps,
        data=DataConfig(batch_size=64, seed=3),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.1),
        checkpoint=CheckpointConfig(directory=ckpt_dir,
                                    save_steps=save_steps),
        obs=ObservabilityConfig(log_every_steps=log_every),
        on_anomaly=on_anomaly, max_anomalies=max_anomalies,
        fault_spec=fault_spec, seed=7)


def _trainer(cfg, hooks=None):
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": DATA["train_x"], "y": DATA["train_y"]},
                   device="cpu", process_index=0, num_processes=1,
                   hooks=hooks)


def _params(state):
    return {k: v.detach().numpy().copy()
            for k, v in flatten_dict(state.params).items()}


class LossStream(hooks_lib.Hook):
    every_steps = 1

    def __init__(self):
        self.losses = []

    def after_step(self, trainer, step, metrics):
        if metrics is not None:
            self.losses.append(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# the fault-spec grammar
# ---------------------------------------------------------------------------

def test_fault_spec_parses_and_validates():
    reg = faults.parse_spec(
        "ckpt.write:step=2:raise=OSError;loader.next:p=0.5;"
        "step.nan:step=7;ckpt.write:step=3:corrupt=truncate;"
        "step.inf:step=9:proc=0", seed=1)
    assert len(reg.rules) == 5
    assert reg.rules[4].describe() == "step.inf:step=9:raise=OSError:proc=0"
    for bad in ("nonsense.site:step=1",          # unknown site
                "loader.next",                   # no trigger
                "loader.next:step=1:p=0.5",      # two triggers
                "loader.next:p=1.5",             # p out of range
                "loader.next:step=0",            # 1-based
                "loader.next:raise=SystemExit:step=1",   # not allowlisted
                "loader.next:corrupt=truncate:step=1",   # corrupt != write
                "ckpt.write:corrupt=shred:step=1",       # unknown mode
                "loader.next:bogus=1:step=1",    # unknown field
                ""):                             # no rules at all
        with pytest.raises(faults.FaultSpecError):
            faults.parse_spec(bad)


def test_fault_step_rules_are_one_shot_and_deterministic():
    reg = faults.parse_spec("ckpt.read:step=2", seed=0)
    assert reg.check("ckpt.read") is None          # invocation 1
    assert reg.check("ckpt.read") is not None      # invocation 2 fires
    assert reg.check("ckpt.read") is None          # spent: replay-safe
    a = faults.parse_spec("loader.next:p=0.5", seed=9)
    b = faults.parse_spec("loader.next:p=0.5", seed=9)
    pattern = [a.check("loader.next") is not None for _ in range(16)]
    assert pattern == [b.check("loader.next") is not None
                       for _ in range(16)]
    assert any(pattern) and not all(pattern)
    # proc= restricts a rule to one rank: rank 0 here, so proc=1 is inert
    other = faults.parse_spec("ckpt.read:step=1:proc=1")
    assert other.check("ckpt.read") is None


def test_anomaly_config_validates():
    with pytest.raises(ValueError, match="on_anomaly"):
        anomaly_settings(_cfg().replace(on_anomaly="explode"))
    with pytest.raises(ValueError, match="max_anomalies"):
        anomaly_settings(_cfg().replace(max_anomalies=-1))
    with pytest.raises(ValueError, match="rollback"):
        anomaly_settings(_cfg(on_anomaly="skip").replace(
            on_anomaly="rollback"))     # no checkpoint directory
    with pytest.raises(ValueError, match="check_nans"):
        cfg = _cfg(on_anomaly="skip")
        cfg.obs.check_nans = True
        anomaly_settings(cfg)
    assert anomaly_settings(_cfg(ckpt_dir="d", save_steps=2,
                                 on_anomaly="rollback",
                                 fault_spec="step.nan:step=1")) == {
        "policy": "rollback", "budget": 10, "fault_spec": "step.nan:step=1"}
    with pytest.raises(SystemExit, match="unknown fault site"):
        tcli.main(["--device", "cpu", "--fault_spec", "bogus.site:p=0.1",
                   "--train_steps", "1"])


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------

def test_nan_skip_keeps_step_count_and_finite_loss_stream():
    """An injected NaN under skip: the clean run's step count, a finite
    loss stream (the skipped step publishes -1.0), one anomaly."""
    with _trainer(_cfg()) as t_ref:
        _, ref = t_ref.train()
    stream = LossStream()
    with _trainer(_cfg(on_anomaly="skip", fault_spec="step.nan:step=7"),
                  hooks=[stream]) as t:
        _, summary = t.train()
    assert summary["final_step"] == ref["final_step"] == 12
    assert len(stream.losses) == 12 and stream.losses[6] == -1.0
    assert all(np.isfinite(x) for x in stream.losses)
    assert int(summary["final_metrics"]["anomaly_count"]) == 1
    assert faults.active() is None          # close() uninstalled it


def test_rollback_repairs_divergence_to_uninterrupted_parity(tmp_path):
    """Rollback restores the last clean verified checkpoint, replays the
    window (the fault spent) and lands on the params of a run that never
    saw the fault."""
    with _trainer(_cfg(20)) as t_ref:
        s_ref, ref = t_ref.train()
    ck = str(tmp_path / "ckpt")
    with _trainer(_cfg(20, ckpt_dir=ck, save_steps=5,
                       on_anomaly="rollback", log_every=5,
                       fault_spec="step.nan:step=8")) as t:
        s, summary = t.train()
        assert t.registry.counter("train_rollbacks_total").value == 1
    assert summary["final_step"] == ref["final_step"] == 20
    assert int(summary["final_metrics"]["anomaly_count"]) == 1
    want, got = _params(s_ref), _params(s)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_anomaly_budget_halts_with_summary():
    spec = ";".join(f"step.nan:step={s}" for s in (2, 4, 6, 8, 10))
    with _trainer(_cfg(20, on_anomaly="skip", max_anomalies=2,
                       log_every=2, fault_spec=spec)) as t:
        _, summary = t.train()
    assert summary["final_step"] < 20
    assert int(summary["final_metrics"]["anomaly_count"]) > 2


def test_loader_faults_are_retried_transparently():
    with _trainer(_cfg(8, fault_spec="loader.next:step=3")) as t:
        _, summary = t.train()
        assert t.train_arrays is not None
    assert summary["final_step"] == 8
    assert int(summary["final_metrics"]["anomaly_count"]) == 0


def test_loader_guard_retries_and_gives_up():
    """``loader.next`` retries re-probe the same invocation (a one-shot
    rule heals; the batch stream is the unfaulted one); a rule that fires
    on every attempt exhausts ``retry_io`` and the error propagates."""
    arrays = {"x": np.arange(80, dtype=np.float32).reshape(40, 2)}
    clean = [b["x"] for _, b in zip(range(5), make_loader(arrays, 4,
                                                          seed=1))]
    faults.install(faults.parse_spec("loader.next:step=2"))
    try:
        it = make_loader(arrays, 4, seed=1)
        assert isinstance(it, faults._GuardedIterator)
        got = [next(it)["x"] for _ in range(5)]
    finally:
        faults.install(None)
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    faults.install(faults.parse_spec("loader.next:p=1.0"))
    old = faults.RETRY_BASE_DELAY
    faults.RETRY_BASE_DELAY = 0.0
    try:
        with pytest.raises(OSError, match="injected fault"):
            next(make_loader(arrays, 4))
    finally:
        faults.RETRY_BASE_DELAY = old
        faults.install(None)
    assert faults.guard_iterator(iter([1])).__class__ is not \
        faults._GuardedIterator


def test_healthy_loss_stream_bit_identical_across_policies(tmp_path):
    """No fault spec: the guarded update's finite branch is the plain
    update, so the loss stream is bitwise the same under every policy."""
    streams, finals = {}, {}
    for policy in ("halt", "skip", "rollback"):
        kw = (dict(ckpt_dir=str(tmp_path / "rb"), save_steps=4)
              if policy == "rollback" else {})
        stream = LossStream()
        with _trainer(_cfg(on_anomaly=policy, **kw), hooks=[stream]) as t:
            s, _ = t.train()
        streams[policy] = stream.losses
        finals[policy] = _params(s)
    assert streams["halt"] == streams["skip"] == streams["rollback"]
    for k in finals["halt"]:
        np.testing.assert_array_equal(finals["halt"][k], finals["skip"][k])


def test_policy_hook_adds_no_off_cadence_materialization():
    h = hooks_lib.AnomalyPolicyHook("rollback", 10, every_steps=100)
    assert not any(h.wants_metrics(s) for s in range(1, 100))
    assert h.wants_metrics(100)
    cfg = _cfg()
    with _trainer(cfg) as t:
        policy_hooks = [x for x in t.hooks
                        if isinstance(x, hooks_lib.AnomalyPolicyHook)]
        assert len(policy_hooks) == 1
        assert policy_hooks[0].every_steps == cfg.obs.log_every_steps


def test_disabled_log_cadence_adds_no_policy_syncs_under_halt(tmp_path):
    with _trainer(_cfg(log_every=0)) as t:
        assert not [h for h in t.hooks
                    if isinstance(h, hooks_lib.AnomalyPolicyHook)]
    with _trainer(_cfg(log_every=0, on_anomaly="rollback",
                       ckpt_dir=str(tmp_path), save_steps=5)) as t2:
        hooks = [h for h in t2.hooks
                 if isinstance(h, hooks_lib.AnomalyPolicyHook)]
        assert len(hooks) == 1 and hooks[0].every_steps == 100


def test_budget_ignores_restored_anomaly_history():
    """The budget charges this run's anomalies only; rollback asks the
    trainer to restore at or before the last clean step."""
    h = hooks_lib.AnomalyPolicyHook("skip", 2, every_steps=1)
    h.observed = h.baseline = 9            # as begin() sets after restore
    assert h.after_step(None, 1, {"anomaly_count": 10}) is None   # 1/2
    assert h.after_step(None, 2, {"anomaly_count": 11}) is None   # 2/2
    assert h.after_step(None, 3, {"anomaly_count": 12}) is True   # 3 > 2

    class _Asks:
        def request_rollback(self, before_step=None):
            self.before = before_step

    rb = hooks_lib.AnomalyPolicyHook("rollback", 5, every_steps=1)
    asks = _Asks()
    assert rb.after_step(asks, 4, {"anomaly_count": 0}) is None
    assert rb.after_step(asks, 5, {"anomaly_count": 1}) is None
    assert asks.before == 4


def test_poison_batch_refuses_integer_only_batches():
    """A step.nan rule that cannot poison anything (an integer token
    batch) raises rather than passing as chaos coverage; a float leaf is
    the one poisoned, in key order."""
    reg = faults.parse_spec("step.nan:step=1;step.inf:step=2", seed=0)
    with pytest.raises(faults.FaultSpecError, match="no floating-point"):
        reg.poison_batch({"input_ids": np.zeros((4, 8), np.int32),
                          "mask": np.ones((4, 8), np.int32)}, step=1)
    batch = {"b": np.ones(3, np.float32), "a": np.ones(3, np.float32),
             "y": np.ones(3, np.int32)}
    out = reg.poison_batch(batch, step=2)
    assert np.isinf(out["a"]).all() and np.isfinite(out["b"]).all()
    assert reg.poison_batch(batch, step=3) is batch


def test_cli_step_fault_on_a_token_batch_is_refused(tmp_path):
    """The CLI's LM corpus is integer-only: ``step.nan`` on it raises the
    FaultSpecError in both packages, at the step it fires."""
    from distributed_tensorflow_example_tpu.cli import train as jcli
    from distributed_tensorflow_example_tpu.runtime import \
        faults as jfaults
    argv = ["--model", "gpt_tiny", "--seq_len", "32", "--batch_size", "8",
            "--train_steps", "3", "--fault_spec", "step.nan:step=2",
            "--log_every_steps", "1"]
    with pytest.raises(faults.FaultSpecError, match="no floating-point"):
        tcli.main(argv + ["--device", "cpu"])
    with pytest.raises(jfaults.FaultSpecError, match="no floating-point"):
        jcli.main(argv)
    assert faults.active() is None and jfaults.active() is None


def test_prefetch_iterator_close_releases_producer():
    import itertools
    import time as _time
    it = PrefetchIterator(iter(itertools.count()), depth=1)
    assert next(it) == 0
    it.close()
    deadline = _time.time() + 5.0
    while it._thread.is_alive() and _time.time() < deadline:
        _time.sleep(0.05)
    assert not it._thread.is_alive(), "producer thread leaked past close()"


# ---------------------------------------------------------------------------
# checkpoints under faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("damage", ["truncate", "zero", "delete"])
def test_trainer_restart_falls_back_past_corrupt_latest(tmp_path, damage):
    ck = str(tmp_path / "ckpt")
    with _trainer(_cfg(10, ckpt_dir=ck, save_steps=5)) as t:
        t.train()
    mgr = CheckpointManager(ck)
    path = mgr.checkpoint_path(mgr.latest_step())
    if damage == "truncate":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif damage == "zero":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 3)
            f.write(b"\0" * (size // 3))
    else:
        os.remove(path)
    with _trainer(_cfg(10, ckpt_dir=ck, save_steps=5)) as t2:
        t2.initialize()
        assert t2.start_step == 5


def test_torn_write_fault_is_caught_at_restart(tmp_path):
    """``ckpt.write:corrupt=truncate`` lets the 2nd save land torn: the
    ring names it, verification rejects it, a restart resumes from the
    1st."""
    ck = str(tmp_path / "ckpt")
    with _trainer(_cfg(10, ckpt_dir=ck, save_steps=5,
                       fault_spec="ckpt.write:step=2:corrupt=truncate")) as t:
        t.train()
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [5, 10]
    assert mgr.latest_valid_step() == 5
    with _trainer(_cfg(10, ckpt_dir=ck, save_steps=5)) as t2:
        t2.initialize()
        assert t2.start_step == 5


def test_rollback_discards_rejected_trajectory_checkpoints(tmp_path):
    """Checkpoints saved after the rollback target hold the skipped
    window: they go, the replay writes the clean ones again, and the
    final ring verifies to its end."""
    ck = str(tmp_path / "ckpt")
    with _trainer(_cfg(20, ckpt_dir=ck, save_steps=2, log_every=5,
                       on_anomaly="rollback",
                       fault_spec="step.nan:step=7")) as t:
        _, summary = t.train()
    assert summary["final_step"] == 20
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == 20
    assert mgr.latest_valid_step() == 20
    state = _trainer(_cfg(20, ckpt_dir=ck, save_steps=2)).initialize()
    assert int(state.anomaly_count) == 1


def test_rollback_without_a_verified_checkpoint_halts(tmp_path):
    """A fault before the first save leaves nothing to restore at or
    before the clean step: the run halts instead of looping."""
    ck = str(tmp_path / "ckpt")
    with _trainer(_cfg(20, ckpt_dir=ck, save_steps=10, log_every=1,
                       on_anomaly="rollback",
                       fault_spec="step.nan:step=3")) as t:
        _, summary = t.train()
    assert summary["final_step"] == 3


# ---------------------------------------------------------------------------
# the tiny GPT's rollback run, both packages
# ---------------------------------------------------------------------------

GPT_TINY = dict(vocab_size=1000, hidden=32, layers=2, heads=2,
                intermediate=64, max_len=32, dropout=0.0)
ADAMW = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
             wd_mask="exclude_1d", grad_clip_norm=1.0)


class _JStream(jhooks.Hook):
    every_steps = 1

    def __init__(self):
        self.losses = []

    def after_step(self, trainer, step, metrics):
        self.losses.append(float(metrics["loss"]))


def _gpt_cfg(pkg, ckpt_dir):
    return pkg.TrainConfig(
        model="gpt", train_steps=10, seed=0,
        data=pkg.DataConfig(batch_size=4, seq_len=32, seed=0),
        optimizer=pkg.OptimizerConfig(**ADAMW),
        checkpoint=pkg.CheckpointConfig(directory=ckpt_dir, save_steps=2),
        obs=pkg.ObservabilityConfig(log_every_steps=1),
        on_anomaly="rollback", fault_spec="step.nan:step=5")


def _float_mask(arrays):
    """The LM corpus with its attention mask as f32: the one float leaf
    both GPTs take, so a ``step.nan`` fault can poison a token batch."""
    return dict(arrays, attention_mask=arrays["attention_mask"].astype(
        np.float32))


def test_gpt_rollback_loss_stream_matches_reference(tmp_path):
    """Both Trainers start from one checkpoint the reference wrote, with
    ``step.nan:step=5`` and rollback: step 5 publishes -1.0, both restore
    step 4 and replay to 10, and the loss streams (11 values) agree
    within 1e-5; both end with anomaly_count 1 and the rejected
    trajectory's checkpoints gone."""
    kw = dict(vocab_size=1000, seq_len=32, num_train=48, num_test=8)
    jtrain, jeval = jdata.get_lm_data(None, **kw)
    ttrain, teval = tdata.get_lm_data(None, **kw)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = JGPT(JGPTConfig(**GPT_TINY))
    jrec = _JStream()
    jtr = JTrainer(jm, _gpt_cfg(jconfig, jdir), _float_mask(jtrain),
                   mesh=local_mesh(1), hooks=[jrec], process_index=0,
                   num_processes=1)
    jckpt.CheckpointManager(jdir).save(jtr.sync.init(jm.init, seed=0), 0)
    shutil.copytree(jdir, tdir)
    with jtr:
        jstate, jsum = jtr.train()

    trec = LossStream()
    ttr = Trainer(GPT(GPTConfig(**GPT_TINY)), _gpt_cfg(tconfig, tdir),
                  _float_mask(ttrain), hooks=[trec], device="cpu")
    with ttr:
        tstate, tsum = ttr.train()
    assert len(jrec.losses) == len(trec.losses) == 11
    assert trec.losses[4] == jrec.losses[4] == -1.0
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    assert tsum["final_step"] == jsum["final_step"] == 10
    assert int(tsum["final_metrics"]["anomaly_count"]) == int(
        jsum["final_metrics"]["anomaly_count"]) == 1
    assert CheckpointManager(tdir).all_steps() == \
        jckpt.CheckpointManager(jdir).all_steps() == [2, 4, 6, 8, 10]
    assert int(jax.device_get(jstate.step)) == tstate.step


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_two_workers_roll_back_and_keep_best_like_one_worker(tmp_path):
    """``cli.train --model mlp`` as two gloo workers against one worker,
    with every rank-0 decision this slice adds to the N-rank path: the
    rollback target (``step.nan`` on both ranks' halves of step 7, rank
    0's verified step broadcast), the best record's verdict, early stop's
    value, and async saves meeting at their barrier. The final checkpoint
    and the best record agree with the one-worker run to the n-chip
    tolerances of ``test_torch_distributed.py``."""
    from test_torch_distributed import (PARAM_ATOL, PARAM_RTOL,
                                        _free_ports, _run_ranks)

    def argv(ck):
        return ["--model", "mlp", "--device", "cpu", "--batch_size", "256",
                "--ckpt_dir", ck, "--save_steps", "4", "--async_save",
                "--log_every_steps", "1", "--train_steps", "12",
                "--fault_spec", "step.nan:step=7", "--on_anomaly",
                "rollback", "--eval_every_steps", "4", "--keep_best_metric",
                "loss", "--keep_best_mode", "min", "--early_stop_metric",
                "accuracy", "--early_stop_patience", "10"]
    one_ck, two_ck = str(tmp_path / "one"), str(tmp_path / "two")
    assert tcli.main(argv(one_ck)) == 0
    hosts = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
    out = _run_ranks([["-m", "distributed_tensorflow_example_tpu_torch.cli."
                       "train", *argv(two_ck), "--worker_hosts", hosts,
                       "--task_index", str(i)] for i in range(2)])
    for r in out:
        assert "restored verified checkpoint step 4" in r.stderr, r.stderr
    one, two = CheckpointManager(one_ck), CheckpointManager(two_ck)
    assert two.all_steps() == one.all_steps()
    assert two.best_step() == one.best_step() is not None
    a = np.load(one.checkpoint_path(12))
    b = np.load(two.checkpoint_path(12))
    for k in a.files:
        if k == "__crc32__":
            continue
        np.testing.assert_allclose(b[k], a[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
    assert int(b["anomaly_count"]) == 1
    with open(os.path.join(two_ck, "early_stop.json")) as f:
        assert set(json.load(f)) == {"best", "misses"}
