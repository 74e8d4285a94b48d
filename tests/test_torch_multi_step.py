"""K training steps a call (``SyncReplicas.multi_step``, ``--steps_per_loop``)
and the bounded queue of launched steps (``--max_inflight_steps``) on the
CPU.

- Against the JAX package: the reference's ``multi_step`` (a ``lax.scan``
  over a [K, B, ...] stack, one CPU device) and the port's on the same
  bridged MLP params and 4 numpy-seeded batches, under ``auto`` and
  ``shard_map``, f32: the params after K steps within the reference's
  own tolerance for scan against sequential steps
  (``tests/test_sync_replicas.py``: rtol 2e-5, atol 1e-6), the last
  step's loss within its 1e-5.
- Against the port's single steps, ``torch.equal`` on every state leaf
  and the last metrics: GPT-tiny dimensions with dropout on, with
  ``accum_steps`` 1 and 2; ``debug_checks`` raising at the global step of
  a NaN inside the stack, with the single steps' message; two gloo ranks
  (``tests/_torch_fsdp_worker.py``, one spawn) at ``data=2`` and
  ``fsdp=2`` (GPT-tiny, dropout on) and ``pipe_mlp`` over ``pipe=2``.
- The Trainer and the CLI, the counterparts of the reference's tests of
  the K-step loop (``tests/test_eval_and_timing.py``,
  ``tests/test_config_knobs.py``): the cadence ValueError, the tail of
  single steps, ``step.*`` faults at their global step, the timing
  hook's ``steps_per_dispatch``, the in-flight waits, and a CLI run at
  K = 2 whose checkpoint equals the K = 1 run's bit for bit.
"""

import json

import jax
import numpy as np
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
from distributed_tensorflow_example_tpu_torch.models.gpt import (GPT,
                                                                 GPTConfig)
from distributed_tensorflow_example_tpu_torch.models.mlp import (
    MLP, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from _torch_fsdp_worker import GPT_TINY
from test_torch_fsdp import load, run_ranks, shared_once

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores, and a CPU step is bitwise
# repeatable only at one thread
torch.set_num_threads(1)

K = 4


def _mlp_batch(seed: int) -> dict:
    """32 rows of the reference test's MLP batch (20 features, 4
    classes)."""
    rs = np.random.RandomState(seed)
    return {"x": rs.rand(32, 20).astype(np.float32),
            "y": rs.randint(0, 4, size=(32,), dtype=np.int32)}


def _stack(batches: list[dict]) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _leaves(state) -> dict:
    return dict(tckpt._state_leaves(state))


def assert_states_equal(a, b):
    """Every leaf of two port states ``torch.equal``, and their steps."""
    assert a.step == b.step
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    assert not bad, bad[:5]


def assert_metrics_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# (a) against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_multi_step_matches_the_reference_multi_step(mode):
    """The reference's ``multi_step`` over a stack of 4 batches on one
    CPU device against the port's, from the same bridged MLP params
    (SGD 0.1, f32, no dropout in the MLP): the step count, the params
    within rtol 2e-5 / atol 1e-6 and the last step's loss within 1e-5
    (the reference's tolerances for its scan against its sequential
    steps)."""
    jm = JMLP(in_dim=20, hidden=16, num_classes=4)
    tm = MLP(in_dim=20, hidden=16, num_classes=4)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(tm, jckpt._flatten(jax.device_get(jp)), "cpu")
    opt = dict(name="sgd", learning_rate=0.1)
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(jconfig.OptimizerConfig(**opt)),
        local_mesh(1), sync=jconfig.SyncConfig(mode=mode))
    tsync = SyncReplicas(
        tm.loss, topt.make_optimizer(tconfig.OptimizerConfig(**opt)),
        sync=tconfig.SyncConfig(mode=mode), device="cpu")
    js = jsync.init(lambda rng: jp, seed=0)
    ts = tsync.init(lambda gen: tp, seed=0)
    stacked = _stack([_mlp_batch(i) for i in range(K)])
    js, jmet = jsync.multi_step(js, jsync.shard_stacked_batch(stacked))
    ts, tmet = tsync.multi_step(ts, stacked)
    assert int(js.step) == ts.step == K
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    want = jckpt._flatten(jax.device_get(js.params))
    got = params_to_numpy(ts.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (b) against the port's single steps
# ---------------------------------------------------------------------------

def _gpt_batches(n: int, b: int = 4, s: int = 16) -> list[dict]:
    """``n`` numpy-seeded GPT batches, the second row of each padded in
    its last 5 tokens."""
    out = []
    for i in range(n):
        rs = np.random.RandomState(50 + i)
        ids = rs.randint(0, GPT_TINY["vocab_size"], (b, s)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[1, -5:] = 0
        out.append({"input_ids": ids, "attention_mask": mask})
    return out


def _gpt_sync(accum: int = 1, **kw):
    model = GPT(GPTConfig(**{**GPT_TINY, "dropout": 0.1}))
    tx = topt.make_optimizer(tconfig.OptimizerConfig(
        name="adamw", learning_rate=1e-3, weight_decay=0.01,
        grad_clip_norm=1.0))
    sync = SyncReplicas(model.loss, tx, device="cpu",
                        sync=tconfig.SyncConfig(accum_steps=accum), **kw)
    return sync, sync.init(model.init, seed=0)


@pytest.mark.parametrize("accum", [1, 2])
def test_multi_step_equals_single_steps_bitwise(accum):
    """GPT-tiny dimensions, dropout 0.1, AdamW with the clip: one
    ``multi_step`` over K stacked batches equals K ``step`` calls leaf for
    leaf (params, moments, counts, anomaly count) and in the last step's
    metrics, with ``accum_steps`` 1 and 2: each step and microbatch keeps
    its own dropout generator. A second call continues the same
    trajectory (its steps are the global steps K+1..2K)."""
    batches = _gpt_batches(2 * K)
    sync_a, single = _gpt_sync(accum)
    sync_b, multi = _gpt_sync(accum)
    for rnd in range(2):
        chunk = batches[rnd * K:(rnd + 1) * K]
        for b in chunk:
            single, met_single = sync_a.step(single, b)
        multi, met_multi = sync_b.multi_step(multi, _stack(chunk))
        assert multi.step == (rnd + 1) * K
        assert_states_equal(single, multi)
        assert_metrics_equal(met_single, met_multi)
    # dropout is on: the same batch at another step draws other masks
    _, at_0 = sync_b.step(multi.replace(step=0), batches[0])
    _, at_5 = sync_b.step(multi.replace(step=5), batches[0])
    assert float(at_0["loss"]) != float(at_5["loss"])


def test_multi_step_refuses_a_ragged_or_empty_stack():
    sync, state = _gpt_sync()
    stack = _stack(_gpt_batches(2))
    with pytest.raises(ValueError, match="leading loop axis"):
        sync.multi_step(state, {**stack,
                                "attention_mask": stack["attention_mask"][:1]})
    with pytest.raises(ValueError, match="leading loop axis"):
        sync.multi_step(state, {k: v[:0] for k, v in stack.items()})


def test_debug_checks_name_the_global_step_inside_the_stack():
    """``debug_checks``: a NaN in the third batch of the second stack
    raises ``FloatingPointError`` naming global step K + 3, the message
    the single steps give; the steps before it ran."""
    tm = MLP(in_dim=20, hidden=16, num_classes=4)
    tx = topt.make_optimizer(tconfig.OptimizerConfig(name="sgd",
                                                     learning_rate=0.1))
    batches = [_mlp_batch(i) for i in range(2 * K)]
    batches[K + 2]["x"][3, 5] = np.nan
    msgs = []
    for multi in (False, True):
        sync = SyncReplicas(tm.loss, tx, device="cpu", debug_checks=True)
        state = sync.init(tm.init, seed=0)
        with pytest.raises(FloatingPointError) as e:
            if multi:
                state, _ = sync.multi_step(state, _stack(batches[:K]))
                assert state.step == K
                sync.multi_step(state, _stack(batches[K:]))
            else:
                for b in batches:
                    state, _ = sync.step(state, b)
        msgs.append(str(e.value))
    assert f"step {K + 3} " in msgs[0]
    assert msgs[0] == msgs[1]


def test_counted_multi_step_counts_the_whole_call():
    """``counted_step(multi=True)`` records the FLOPs of the K-step call:
    K times one step's on the MLP (every product is the same shape)."""
    tm = MLP(in_dim=20, hidden=16, num_classes=4)
    tx = topt.make_optimizer(tconfig.OptimizerConfig(name="sgd"))
    sync = SyncReplicas(tm.loss, tx, device="cpu")
    state = sync.init(tm.init, seed=0)
    sync.counted_step(state, _mlp_batch(0))
    one = sync.last_cost_analysis["flops"]
    out, _ = sync.counted_step(state, _stack([_mlp_batch(i)
                                              for i in range(K)]),
                               multi=True)
    assert out.step == K and one > 0
    assert sync.last_cost_analysis["flops"] == K * one


#: the gloo cases: (task name, model, mesh); GPT-tiny with dropout on
GLOO = {
    "data2-gpt": ("gpt_tiny", dict(data=2)),
    "fsdp2-gpt": ("gpt_tiny", dict(data=1, fsdp=2)),
    "pipe2-pipe_mlp": ("pipe_mlp", dict(data=1, pipe=2)),
}


def _build_gloo(root) -> dict:
    tasks = []
    for name, (model, mesh) in GLOO.items():
        if model == "pipe_mlp":
            rs = np.random.RandomState(7)
            stack = {"x": rs.rand(K, 16, 784).astype(np.float32),
                     "y": rs.randint(0, 10, (K, 16)).astype(np.int32)}
        else:
            stack = _stack(_gpt_batches(K, b=8))
        path = root / f"{name}.npz"
        np.savez(path, **stack)
        tasks.append({"kind": "multi", "name": name, "model": model,
                      "mesh": mesh, "dropout": 0.1, "batches": str(path),
                      "opt": dict(name="adamw", learning_rate=1e-3,
                                  weight_decay=0.01, grad_clip_norm=1.0)})
    run_ranks(2, tasks, root)
    return {(name, r): load(root, name, r) for name in GLOO for r in (0, 1)}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return shared_once(tmp_path_factory, "multi_step_gloo", _build_gloo)


@pytest.mark.parametrize("name", sorted(GLOO))
def test_multi_step_equals_single_steps_on_two_gloo_ranks(gloo, name):
    """Two gloo ranks, each from the seed-0 init on its rows of K global
    batches: one ``multi_step`` call equals K ``step`` calls bit for bit
    (the whole gathered state, the step, the last metrics) on every rank,
    and the ranks hold the same whole state."""
    outs = [gloo[(name, r)] for r in (0, 1)]
    for out in outs:
        single = {k[len("single/"):]: v for k, v in out.items()
                  if k.startswith("single/")}
        multi = {k[len("multi/"):]: v for k, v in out.items()
                 if k.startswith("multi/")}
        assert sorted(single) == sorted(multi)
        assert int(multi["step"]) == K
        bad = [k for k in single
               if not np.array_equal(single[k], multi[k])]
        assert not bad, bad[:5]
    for k in outs[0]:
        if k.startswith("multi/state/"):
            assert np.array_equal(outs[0][k], outs[1][k]), k


# ---------------------------------------------------------------------------
# (c) the Trainer and the CLI
# ---------------------------------------------------------------------------

DATA = synthetic_mnist(num_train=640, num_test=64, seed=0)


def _cfg(**kw) -> tconfig.TrainConfig:
    obs = kw.pop("obs", {})
    return tconfig.TrainConfig(
        model="mlp", train_steps=kw.pop("train_steps", 8),
        data=tconfig.DataConfig(batch_size=64, seed=3),
        optimizer=tconfig.OptimizerConfig(name="sgd", learning_rate=0.1),
        obs=tconfig.ObservabilityConfig(**{"log_every_steps": 4, **obs}),
        **kw)


def _trainer(cfg, evals=False) -> Trainer:
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": DATA["train_x"], "y": DATA["train_y"]},
                   eval_arrays=({"x": DATA["test_x"], "y": DATA["test_y"]}
                                if evals else None),
                   device="cpu", process_index=0, num_processes=1)


@pytest.mark.parametrize("field,kw", [
    ("log_every_steps", dict(obs={"log_every_steps": 6})),
    ("summary_every_steps", dict(obs={"summary_every_steps": 2})),
    ("param_histograms_every_steps",
     dict(obs={"param_histograms_every_steps": 10})),
    ("save_steps", dict(checkpoint=tconfig.CheckpointConfig(
        directory="unused", save_steps=6))),
    ("eval_every_steps", dict(eval_every_steps=2)),
])
def test_trainer_refuses_a_cadence_off_the_loop_boundary(field, kw):
    """Hooks observe loop boundaries only: every set cadence must be a
    multiple of ``steps_per_loop`` (the reference's ValueError)."""
    with pytest.raises(ValueError, match=f"{field}=.* must be a multiple "
                       "of steps_per_loop=4"):
        _trainer(_cfg(steps_per_loop=4, **kw))


def _run(cfg, evals=False):
    """(final state, summary, multi_step calls, step calls)."""
    with _trainer(cfg, evals) as t:
        calls = {"multi": 0, "step": 0}
        for name, attr in (("multi", "multi_step"), ("step", "step")):
            real = getattr(t.sync, attr)

            def counted(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)
            setattr(t.sync, attr, counted)
        state, summary = t.train()
    return state, summary, calls["multi"], calls["step"]


def test_trainer_runs_k_steps_a_call_then_a_tail_of_single_steps():
    """10 steps at K = 4: two ``multi_step`` calls, then 2 single steps;
    the final state and metrics equal the K = 1 run's bit for bit."""
    state, summary, n_multi, n_step = _run(_cfg(train_steps=10,
                                                steps_per_loop=4))
    assert (n_multi, n_step) == (2, 2)
    assert summary["final_step"] == 10 == state.step
    want, want_summary, m1, s1 = _run(_cfg(train_steps=10))
    assert (m1, s1) == (0, 10)
    assert_states_equal(state, want)
    assert summary["final_metrics"] == want_summary["final_metrics"]


def test_step_fault_poisons_its_global_step_inside_a_stack():
    """``step.nan:step=6`` under K = 4 poisons the host batch of global
    step 6, the second of the second stack: under ``on_anomaly`` skip
    the run counts one anomaly and ends equal to the K = 1 run with the
    same fault, and unequal to one whose fault is at step 7."""
    def run(spl, at):
        state, summary, _, _ = _run(_cfg(
            steps_per_loop=spl, on_anomaly="skip",
            fault_spec=f"step.nan:step={at}"))
        assert summary["final_metrics"]["anomaly_count"] == 1.0
        return state
    k4 = run(4, 6)
    assert_states_equal(k4, run(1, 6))
    other = run(4, 7)
    assert not torch.equal(_leaves(k4)["params/fc1/kernel"],
                           _leaves(other)["params/fc1/kernel"])


def test_step_timing_reports_steps_per_dispatch(tmp_path):
    """``--step_timing`` at K = 4 (the counterpart of the reference's
    ``test_step_timing_with_steps_per_loop``): records carry
    ``steps_per_dispatch`` 4 on a cadence of log_every_steps // K
    dispatches, and the first record carries the FLOPs of one K-step
    call, 4 times the K = 1 run's."""
    recs = {}
    for spl in (4, 1):
        path = str(tmp_path / f"m{spl}.jsonl")
        _run(_cfg(train_steps=16, steps_per_loop=spl,
                  obs={"metrics_path": path, "step_timing": True}))
        recs[spl] = [json.loads(line) for line in open(path)]
    timing = [r for r in recs[4] if "step_timing_ms" in r]
    assert [r["step"] for r in timing] == [8, 12, 16]
    assert all(r["step_timing_ms"]["steps_per_dispatch"] == 4
               and r["step_timing_ms"]["n"] == 1 for r in timing)
    flops = {spl: [r["step_cost_analysis"]["flops"] for r in rs
                   if "step_cost_analysis" in r]
             for spl, rs in recs.items()}
    assert flops[1][0] > 0 and flops[4] == [4 * flops[1][0]]


@pytest.mark.parametrize("spl,inflight,timing,waits", [
    (1, 0, False, 0), (1, 1, False, 6), (1, 2, False, 3),
    (2, 1, False, 3), (2, 2, False, 3), (1, 1, True, 0)])
def test_max_inflight_steps_waits_every_n_trained_steps(spl, inflight,
                                                        timing, waits):
    """``max_inflight_steps`` N waits for the device once N trained steps
    are pending (K at a time under ``steps_per_loop`` K); 0 never waits
    mid-loop, and under ``step_timing`` the per-dispatch sync bounds the
    queue instead (the counterpart of the reference's
    ``test_max_inflight_steps_bounds_the_dispatch_queue``)."""
    with _trainer(_cfg(train_steps=6, steps_per_loop=spl,
                       max_inflight_steps=inflight, obs={
                           "log_every_steps": 2, "step_timing": timing}))\
            as t:
        calls = []
        real = t.wait_for_device
        t.wait_for_device = lambda: (calls.append(1), real())[1]
        t.train()
    assert len(calls) == waits


def test_negative_max_inflight_steps_is_refused(tmp_path):
    """A negative ``max_inflight_steps`` is the reference's ValueError, from
    the Trainer and through the CLI, before any step or save."""
    with pytest.raises(ValueError, match="max_inflight_steps must be >= 0"):
        _trainer(_cfg(max_inflight_steps=-1))
    ck = tmp_path / "ck"
    with pytest.raises(ValueError, match="max_inflight_steps must be >= 0"):
        tcli.main(["--model", "mlp", "--device", "cpu", "--train_steps",
                   "1", "--max_inflight_steps", "-1", "--ckpt_dir",
                   str(ck)])
    assert not (ck / "checkpoint").exists()


def test_cli_steps_per_loop_checkpoint_equals_the_single_step_run(tmp_path):
    """gpt_tiny (dropout 0.1) through the CLI for 4 steps with saves
    every 2: at ``--steps_per_loop 2 --max_inflight_steps 2`` the
    checkpoints at steps 2 and 4 equal the K = 1 run's leaf for leaf."""
    dirs = []
    for spl in ("2", "1"):
        d = tmp_path / f"k{spl}"
        assert tcli.main([
            "--model", "gpt_tiny", "--device", "cpu", "--seq_len", "16",
            "--batch_size", "4", "--optimizer", "adamw",
            "--learning_rate", "1e-3", "--train_steps", "4",
            "--save_steps", "2", "--log_every_steps", "2", "--attention",
            "xla", "--ckpt_dir", str(d), "--steps_per_loop", spl,
            "--max_inflight_steps", spl]) == 0
        dirs.append(d)
    for step in (2, 4):
        with np.load(dirs[0] / f"ckpt-{step}.npz") as a, \
                np.load(dirs[1] / f"ckpt-{step}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
            assert not bad, bad[:5]
