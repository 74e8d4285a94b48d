"""The port's eval cadence, early stop and step-timing, profiler and trace
hooks, on the CPU: step-timing records (the reference's keys; the first
record carries the step's FLOPs as ``step_cost_analysis``, counted by
``FlopCounterMode`` where the reference reads XLA's cost analysis:
``tests/test_torch_debug_tools.py`` holds the count), early stop (stops, validates, refuses an unknown metric, keeps its
state across a resume, on every rank rank 0's value), the
``torch.profiler`` hook's Chrome trace, ``--trace_path``'s lanes (data,
step, checkpoint, rollback) and its ring bound, and the CLI flags that
drive them.

The counterparts of ``tests/test_eval_and_timing.py:111-261``, held to
the port.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import (
    CheckpointConfig, DataConfig, ObservabilityConfig, OptimizerConfig,
    TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.obs import trace as obs_trace
from distributed_tensorflow_example_tpu_torch.train import hooks as hooks_lib
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _trainer(cfg, data, evals=True):
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": data["train_x"], "y": data["train_y"]},
                   eval_arrays=({"x": data["test_x"], "y": data["test_y"]}
                                if evals else None),
                   device="cpu", process_index=0, num_processes=1)


def test_step_timing_records(tmp_path):
    metrics_path = str(tmp_path / "metrics.jsonl")
    data = synthetic_mnist(num_train=640, num_test=64, seed=0)
    cfg = TrainConfig(model="mlp", train_steps=8,
                      data=DataConfig(batch_size=64, seed=3),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.1),
                      obs=ObservabilityConfig(log_every_steps=4,
                                              metrics_path=metrics_path,
                                              step_timing=True))
    with _trainer(cfg, data) as t:
        t.train()
        hook = [h for h in t.hooks
                if isinstance(h, hooks_lib.StepTimingHook)][0]
        assert t.last_dispatch_ms is not None and t.last_dispatch_ms > 0
    recs = [json.loads(line) for line in open(metrics_path)]
    timing = [r for r in recs if "step_timing_ms" in r]
    # 7 timed dispatches (the first is kept out): 4 at step 5, 3 at 8
    assert [r["step"] for r in timing] == [5, 8]
    assert [r["step_timing_ms"]["n"] for r in timing] == [4, 3]
    st = timing[0]["step_timing_ms"]
    for key in ("n", "steps_per_dispatch", "mean", "p50", "p90", "p99",
                "max", "first_dispatch_ms"):
        assert key in st, key
    assert st["p99"] >= st["p50"] > 0.0 and st["steps_per_dispatch"] == 1
    # the cost record rides the first timing record only, as in the
    # reference
    assert [r["step"] for r in recs if "step_cost_analysis" in r] == [5]
    assert timing[0]["step_cost_analysis"]["flops"] > 0
    assert hook.last_record["step_timing_ms"] == timing[-1]["step_timing_ms"]


def test_early_stopping_stops_and_validates():
    """A metric that cannot improve (accuracy saturated on this easy set)
    trips the patience long before train_steps; misconfigurations fail
    at construction."""
    data = synthetic_mnist(512, 128)
    cfg = TrainConfig(model="mlp", train_steps=400, eval_every_steps=20,
                      early_stop_metric="accuracy", early_stop_patience=2,
                      data=DataConfig(batch_size=64),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.5))
    with _trainer(cfg, data) as tr:
        _, summary = tr.train()
    assert summary["final_step"] < 400, summary["final_step"]
    assert summary["eval"] == tr._last_eval[1]
    for bad in (cfg.replace(eval_every_steps=0),
                cfg.replace(early_stop_patience=0),
                cfg.replace(early_stop_mode="bigger")):
        with pytest.raises(ValueError, match="early_stop"):
            _trainer(bad, data)
    with pytest.raises(ValueError, match="early_stop"):
        _trainer(cfg, data, evals=False)


def test_early_stop_unknown_metric_raises():
    data = synthetic_mnist(128, 64)
    cfg = TrainConfig(model="mlp", train_steps=4, eval_every_steps=2,
                      early_stop_metric="f1",
                      data=DataConfig(batch_size=64))
    with _trainer(cfg, data) as tr:
        with pytest.raises(ValueError, match="early_stop_metric"):
            tr.train()


def test_early_stop_state_survives_resume(tmp_path):
    """The patience counter persists in ``early_stop.json`` beside the
    checkpoints, so a resumed run continues the window."""
    data = synthetic_mnist(512, 128)
    cfg = TrainConfig(model="mlp", train_steps=60, eval_every_steps=20,
                      early_stop_metric="accuracy", early_stop_patience=4,
                      data=DataConfig(batch_size=64),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.5),
                      checkpoint=CheckpointConfig(
                          directory=str(tmp_path / "ck"), save_steps=20))
    with _trainer(cfg, data) as tr:
        tr.train()
        misses1, best1 = tr._early_misses, tr._early_best
    assert json.load(open(tmp_path / "ck" / "early_stop.json")) \
        == {"best": best1, "misses": misses1}
    with _trainer(cfg.replace(train_steps=100), data) as tr2:
        tr2.initialize()
        assert tr2._early_best == best1
        assert tr2._early_misses == misses1


def test_early_stop_min_mode_and_nan_count_as_misses():
    data = synthetic_mnist(128, 64)
    cfg = TrainConfig(model="mlp", train_steps=4, eval_every_steps=2,
                      early_stop_metric="loss", early_stop_mode="min",
                      early_stop_patience=2,
                      data=DataConfig(batch_size=64))
    with _trainer(cfg, data) as tr:
        assert tr._early_stop_hit(2, {"loss": 1.0}) is False
        assert tr._early_stop_hit(4, {"loss": 0.5}) is False
        assert tr._early_stop_hit(6, {"loss": float("nan")}) is False
        assert tr._early_stop_hit(8, {"loss": 0.7}) is True
        assert tr._early_best == 0.5


def test_profiler_hook_writes_a_chrome_trace(tmp_path):
    """``profile_steps=(2, 4)``: the profiler runs from after step 2 to
    after step 4 and rank 0 writes its Chrome trace, which parses and
    holds the steps' CPU ops."""
    data = synthetic_mnist(256, 64)
    prof = str(tmp_path / "prof")
    cfg = TrainConfig(model="mlp", train_steps=6,
                      data=DataConfig(batch_size=64),
                      obs=ObservabilityConfig(profile_dir=prof,
                                              profile_steps=(2, 4)))
    with _trainer(cfg, data, evals=False) as tr:
        tr.train()
    path = os.path.join(prof, "trace-steps-2-4.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    # a window the run enters and never leaves is closed by end()
    h = hooks_lib.ProfilerHook(str(tmp_path / "p2"), 5, 50)
    with _trainer(cfg.replace(obs=ObservabilityConfig()), data,
                  evals=False) as tr2:
        tr2.hooks.append(h)
        tr2.train()
    assert os.path.exists(os.path.join(str(tmp_path / "p2"),
                                       "trace-steps-5-50.json"))


def test_trace_path_dumps_the_training_lanes(tmp_path):
    """``trace_path`` arms the span ring for the run and dumps the data,
    step, checkpoint (the save, and the write on the writer's lane) and
    rollback lanes as Chrome JSON (a rollback run, so all appear); a
    small ``trace_buffer_events`` drops the
    oldest spans and says how many."""
    data = synthetic_mnist(640, 64)
    path = str(tmp_path / "trace.json")
    cfg = TrainConfig(model="mlp", train_steps=12,
                      data=DataConfig(batch_size=64),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.1),
                      checkpoint=CheckpointConfig(
                          directory=str(tmp_path / "ck"), save_steps=4),
                      obs=ObservabilityConfig(log_every_steps=1,
                                              trace_path=path),
                      on_anomaly="rollback", fault_spec="step.nan:step=6")
    with _trainer(cfg, data, evals=False) as tr:
        tr.train()
    assert not obs_trace.recorder().enabled
    with open(path) as f:
        dump = json.load(f)
    lanes = {e["args"]["name"] for e in dump["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert lanes == {"data", "step", "checkpoint", "checkpoint_writer",
                     "rollback"}
    spans = [e for e in dump["traceEvents"] if e["ph"] == "X"]
    assert sum(e["name"] == "step_dispatch" for e in spans) == 12 + 2
    assert dump["metadata"]["events_dropped"] == 0
    small = str(tmp_path / "small.json")
    cfg2 = cfg.replace(obs=ObservabilityConfig(
        trace_path=small, trace_buffer_events=5),
        on_anomaly="halt", fault_spec="",
        checkpoint=CheckpointConfig())
    with _trainer(cfg2, data, evals=False) as tr2:
        tr2.train()
    with open(small) as f:
        dump2 = json.load(f)
    assert dump2["metadata"] == {"events_dropped": 24 - 5,
                                 "max_events": 5}
    assert obs_trace.ensure_capacity(65536).max_events == 65536


def test_cli_timing_profiler_and_trace_flags(tmp_path):
    """The CLI's ``--step_timing``, ``--profile_dir`` /
    ``--profile_steps``, ``--trace_path`` and ``--trace_buffer_events``
    (refused before this slice) run gpt_tiny and leave their records."""
    m, prof = str(tmp_path / "m.jsonl"), str(tmp_path / "prof")
    tr = str(tmp_path / "t.json")
    assert tcli.main(["--model", "gpt_tiny", "--device", "cpu",
                      "--seq_len", "32", "--batch_size", "4",
                      "--train_steps", "4", "--log_every_steps", "2",
                      "--metrics_path", m, "--step_timing",
                      "--profile_dir", prof, "--profile_steps", "1,2",
                      "--trace_path", tr, "--trace_buffer_events",
                      "1000"]) == 0
    recs = [json.loads(line) for line in open(m)]
    assert [r["step"] for r in recs if "step_timing_ms" in r] == [3, 4]
    assert recs[0]["config"]["obs"]["profile_steps"] == [1, 2]
    assert os.path.exists(os.path.join(prof, "trace-steps-1-2.json"))
    with open(tr) as f:
        assert json.load(f)["metadata"]["max_events"] == 1000
    np.testing.assert_array_equal(
        [r["step_timing_ms"]["n"] for r in recs if "step_timing_ms" in r],
        [2, 1])
