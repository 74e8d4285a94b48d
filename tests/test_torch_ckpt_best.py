"""The port's checkpoint writer against the JAX package's contracts, on
the CPU: async saves (restores equal to the sync ones, errors surfacing
at the next save or at close, the snapshot taken before ``save``
returns), the ``ckpt.*`` fault seams (no half-commit, a failed write
then a clean retry), the best record (improvement, ``min`` mode, a NaN
rejected, survival of ring rotation, the Trainer's cadence, fail-fast
validation), the best record crossing between the packages, and the
CLI's ``--keep_best_metric``, ``--async_save``, ``--eval_only``,
``--eval_step`` and ``--eval_best``.

The counterparts of ``tests/test_checkpoint.py:95-281`` and
``tests/test_checkpoint_corruption.py:180-224``, held to the port.
"""

import glob
import io
import json
import os
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, state_arrays)
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import (
    CheckpointConfig, DataConfig, OptimizerConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.runtime import faults
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer
from distributed_tensorflow_example_tpu_torch.train.state import TrainState
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _state(step: int, value: float) -> TrainState:
    return TrainState(step=step, params={"w": torch.full((2,), value)},
                      opt_state=(), extras={}, seed=0,
                      anomaly_count=torch.zeros((), dtype=torch.int32))


def _w(state) -> np.ndarray:
    return state.params["w"].numpy()


@pytest.fixture
def installed():
    """Install a fault spec for one test, uninstalled after it."""
    def install(spec):
        faults.install(faults.parse_spec(spec))
    yield install
    faults.install(None)


# ---------------------------------------------------------------------------
# async saves
# ---------------------------------------------------------------------------

def test_async_save_restores_identically(tmp_path):
    """Background writes land, the ring rotates, restore waits for the
    write in flight."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    for s in (1, 2, 3):
        assert mgr.save(_state(s, float(s))).endswith(f"ckpt-{s}.npz")
    out = mgr.restore(_state(0, 0.0))
    np.testing.assert_array_equal(_w(out), [3.0, 3.0])
    assert out.step == 3
    assert mgr.all_steps() == [2, 3]
    mgr.close()
    assert mgr._executor._shutdown


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The writer thread reads a copy: changing the state's tensors in
    place after ``save`` returns does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state(1, 1.0)
    mgr.save(state)
    state.params["w"].fill_(7.0)
    mgr.wait()
    np.testing.assert_array_equal(_w(mgr.restore(_state(0, 0.0))),
                                  [1.0, 1.0])
    mgr.close()


def test_async_save_error_surfaces_at_close(tmp_path, installed):
    installed("ckpt.write:step=1:raise=OSError")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_state(1, 1.0))                 # the write fails on the thread
    with pytest.raises(OSError, match="injected fault"):
        mgr.close()
    assert mgr._executor._shutdown           # released despite raising


def test_async_save_error_surfaces_at_next_save(tmp_path, installed):
    installed("ckpt.write:step=1:raise=OSError")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_state(1, 1.0))
    with pytest.raises(OSError, match="injected fault"):
        mgr.save(_state(2, 2.0))             # the drain surfaces it
    mgr.close()                              # surfaced once, not again


def test_commit_fault_leaves_no_half_commit(tmp_path, installed):
    """A failure between the data write and the state-file commit: the
    state file never names the new step."""
    installed("ckpt.commit:step=2:raise=OSError")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1, 1.0))
    with pytest.raises(OSError):
        mgr.save(_state(2, 2.0))
    assert mgr.latest_step() == 1
    np.testing.assert_array_equal(_w(mgr.restore(_state(0, 0.0))),
                                  [1.0, 1.0])


def test_injected_write_fault_then_clean_retry(tmp_path, installed):
    """A failed save leaves the ring usable (no temp file, no poisoned
    state file); a later save of the same step succeeds; a ``ckpt.read``
    fault raises on restore."""
    installed("ckpt.write:step=1:raise=OSError;ckpt.read:step=2")
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(OSError):
        mgr.save(_state(1, 1.0))
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp"))
    mgr.save(_state(1, 1.5))
    np.testing.assert_array_equal(_w(mgr.restore(_state(0, 0.0), step=1)),
                                  [1.5, 1.5])
    with pytest.raises(OSError, match="ckpt.read"):
        mgr.restore(_state(0, 0.0), step=1)


def test_async_save_end_to_end_resume(tmp_path):
    """The Trainer with ``async_save``: its checkpoints resume exactly as
    the synchronous ones do."""
    data = synthetic_mnist(512, 64)
    arrays = {"x": data["train_x"], "y": data["train_y"]}

    def run(d, steps, async_save):
        cfg = TrainConfig(model="mlp", train_steps=steps,
                          data=DataConfig(batch_size=64),
                          checkpoint=CheckpointConfig(
                              directory=d, save_steps=10,
                              async_save=async_save))
        with Trainer(get_model("mlp", cfg), cfg, arrays,
                     device="cpu") as tr:
            state, _ = tr.train()
        return state

    a, b = str(tmp_path / "async"), str(tmp_path / "sync")
    run(a, 10, True)
    sa = run(a, 20, True)
    sb = run(b, 20, False)
    assert CheckpointManager(a).latest_step() == 20
    for k, v in state_arrays(sa).items():
        np.testing.assert_array_equal(v, state_arrays(sb)[k], err_msg=k)


# ---------------------------------------------------------------------------
# the best record
# ---------------------------------------------------------------------------

def test_save_best_tracks_improvement(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save_best(_state(1, 1.0), 1, 0.5) is True
    assert mgr.best_step() == 1
    assert mgr.save_best(_state(2, 2.0), 2, 0.4) is False
    assert mgr.best_step() == 1 and 2 not in mgr.all_steps()
    assert mgr.save_best(_state(3, 3.0), 3, 0.9) is True
    assert mgr.best_step() == 3
    mgr2 = CheckpointManager(str(tmp_path / "min"), async_save=True)
    assert mgr2.save_best(_state(1, 1.0), 1, 0.5, mode="min")
    assert mgr2.save_best(_state(2, 2.0), 2, 0.8, mode="min") is False
    assert mgr2.save_best(_state(3, 3.0), 3, 0.1, mode="min")
    assert mgr2.best_step() == 3
    with pytest.raises(ValueError, match="max|min"):
        mgr2.save_best(_state(4, 4.0), 4, 0.1, mode="bigger")
    mgr2.close()


def test_best_survives_ring_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save_best(_state(1, 1.0), 1, 0.9)
    for s in range(2, 7):
        mgr.save(_state(s, float(s)))
    assert mgr.best_step() == 1
    np.testing.assert_array_equal(_w(mgr.restore(_state(0, 0.0), step=1)),
                                  [1.0, 1.0])
    mgr.save_best(_state(7, 7.0), 7, 0.95)
    assert not os.path.exists(mgr.checkpoint_path(1))
    assert mgr.best_step() == 7
    # rollback's truncation clears a best record past its target
    assert mgr.discard_steps_above(6) == [7]
    assert mgr.best_step() is None and mgr.latest_step() == 6


def test_save_best_rejects_nan(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save_best(_state(1, 1.0), 1, float("nan")) is False
    assert mgr.best_step() is None
    assert mgr.save_best(_state(2, 2.0), 2, 0.7) is True
    assert mgr.best_step() == 2


def test_best_record_crosses_between_the_packages(tmp_path):
    """The best record the port writes is the reference's: its manager
    reads the step, and the port reads the reference's."""
    tdir = str(tmp_path / "port")
    CheckpointManager(tdir).save_best(_state(4, 4.0), 4, 0.25, mode="min")
    assert jckpt.CheckpointManager(tdir).best_step() == 4
    jdir = str(tmp_path / "jax")
    import jax.numpy as jnp
    jmgr = jckpt.CheckpointManager(jdir)
    jmgr.save_best({"w": jnp.full((2,), 5.0)}, 5, 0.5)
    assert CheckpointManager(jdir).best_step() == 5
    with open(os.path.join(tdir, "checkpoint")) as f:
        assert json.load(f)["best"] == {"path": "ckpt-4.npz", "step": 4,
                                        "value": 0.25}


def _mlp_trainer(cfg, data, evals=True):
    return Trainer(get_model("mlp", cfg), cfg,
                   {"x": data["train_x"], "y": data["train_y"]},
                   eval_arrays=({"x": data["test_x"], "y": data["test_y"]}
                                if evals else None),
                   device="cpu", process_index=0, num_processes=1)


def test_trainer_keeps_best_checkpoint(tmp_path):
    """An eval cadence with keep_best_metric records the best step;
    without eval data it fails at construction; an unknown metric is an
    error, not a silent no-op."""
    data = synthetic_mnist(512, 128)
    cfg = TrainConfig(model="mlp", train_steps=30, eval_every_steps=10,
                      data=DataConfig(batch_size=64),
                      optimizer=OptimizerConfig(name="sgd",
                                                learning_rate=0.5),
                      checkpoint=CheckpointConfig(
                          directory=str(tmp_path / "ck"),
                          keep_best_metric="accuracy", async_save=True))
    with _mlp_trainer(cfg, data) as tr:
        tr.train()
        best = tr.ckpt_manager.best_step()
        assert best is not None and best in tr.ckpt_manager.all_steps()
    with pytest.raises(ValueError, match="keep_best"):
        _mlp_trainer(cfg, data, evals=False)
    cfg2 = cfg.replace(checkpoint=CheckpointConfig(
        directory=str(tmp_path / "ck2"), keep_best_metric="bogus"))
    with _mlp_trainer(cfg2, data) as tr2:
        with pytest.raises(ValueError, match="keep_best_metric"):
            tr2.train()


def test_keep_best_without_ckpt_dir_fails_fast():
    data = synthetic_mnist(128, 64)
    cfg = TrainConfig(model="mlp", train_steps=1,
                      data=DataConfig(batch_size=64),
                      checkpoint=CheckpointConfig(keep_best_metric="accuracy"))
    with pytest.raises(ValueError, match="checkpoint.directory"):
        _mlp_trainer(cfg, data)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _last_json(argv) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tcli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_eval_best(tmp_path):
    """``--eval_only --eval_best`` evaluates the tracked best step; the
    latest and ``--eval_step`` likewise; the flags are exclusive as in
    the reference."""
    ck = str(tmp_path / "ck")
    base = ["--model", "mlp", "--device", "cpu", "--batch_size", "64",
            "--ckpt_dir", ck]
    assert tcli.main(base + ["--train_steps", "20", "--eval_every_steps",
                             "10", "--keep_best_metric", "accuracy",
                             "--save_steps", "10", "--async_save"]) == 0
    best = CheckpointManager(ck).best_step()
    assert best is not None
    out = _last_json(base + ["--eval_only", "--eval_best"])
    assert out["step"] == best and 0.0 <= out["accuracy"] <= 1.0
    assert _last_json(base + ["--eval_only"])["step"] == 20
    assert _last_json(base + ["--eval_only", "--eval_step", "10"])[
        "step"] == 10
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit, match="exclusive"):
            main(["--model", "mlp", "--eval_only", "--eval_best",
                  "--eval_step", "3", "--ckpt_dir", ck]
                 + (["--device", "cpu"] if main is tcli.main else []))
    with pytest.raises(SystemExit, match="no best checkpoint"):
        tcli.main(["--model", "mlp", "--device", "cpu", "--eval_only",
                   "--eval_best", "--ckpt_dir", str(tmp_path / "empty")])
    with pytest.raises(SystemExit, match="no checkpoint"):
        tcli.main(["--model", "mlp", "--device", "cpu", "--eval_only",
                   "--ckpt_dir", str(tmp_path / "empty")])


def test_cli_eval_only_matches_the_logged_eval_and_exports(tmp_path):
    """gpt_tiny with ``--keep_best_metric loss --keep_best_mode min``:
    ``--eval_only --eval_best`` prints the metrics the training run
    logged at that step, and ``--export_generator`` exports that
    checkpoint, which ``PredictServer`` serves."""
    ck, gen = str(tmp_path / "ck"), str(tmp_path / "gen")
    metrics = str(tmp_path / "m.jsonl")
    base = ["--model", "gpt_tiny", "--device", "cpu", "--seq_len", "32",
            "--batch_size", "4", "--ckpt_dir", ck, "--optimizer", "adamw"]
    assert tcli.main(base + ["--train_steps", "6", "--eval_every_steps",
                             "3", "--keep_best_metric", "loss",
                             "--keep_best_mode", "min",
                             "--learning_rate", "1e-2",
                             "--metrics_path", metrics]) == 0
    best = CheckpointManager(ck).best_step()
    with open(metrics) as f:
        logged = {r["step"]: r["eval"] for r in map(json.loads, f)
                  if "eval" in r}
    out = _last_json(base + ["--eval_only", "--eval_best",
                             "--export_generator", gen,
                             "--gen_prompt_len", "8", "--gen_max_new", "2"])
    assert out["step"] == best
    for k, v in logged[best].items():
        assert out[k] == pytest.approx(v, rel=1e-5), k
    with PredictServer(gen, device="cpu") as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/{srv.name}:generate",
            data=json.dumps({"inputs": {"input_ids": [[5] * 8]}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            toks = np.asarray(json.loads(r.read())["generations"])
    assert toks.shape == (1, 2)
