"""The port's warm start (``ckpt/warm_start.py``) against the JAX
package's (the counterpart of ``tests/test_warm_start.py``), on the CPU.

The contract is ``tf.train.init_from_checkpoint``'s: the params the
assignment map selects come from the checkpoint, every other one keeps
its fresh init, the step and the optimizer state stay fresh, a shape
mismatch and a typoed map scope are hard errors, and resume (a
checkpoint in the run's own directory) beats warm start. Checkpoints
cross both ways: a reference checkpoint warm-starts the port, a port
checkpoint the reference, with the same values. MoE-BERT warm-starts
from a BERT checkpoint (dense leaves from the checkpoint, routers and
experts fresh).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.ckpt import warm_start as jws
from distributed_tensorflow_example_tpu.config import \
    OptimizerConfig as JOptimizerConfig
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.ckpt.warm_start import (
    load_checkpoint_arrays, parse_assignment_map, warm_start)
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train.optimizers import (
    find_ema_params, make_optimizer)
from distributed_tensorflow_example_tpu_torch.train.state import TrainState
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from distributed_tensorflow_example_tpu_torch.utils.pytree import flatten_dict

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _trained_mlp_ckpt(tmp_path, steps=3):
    """A port MLP state after ``steps`` SGD steps, saved under
    ``tmp_path/pretrained``; (state, directory, (model, sync))."""
    m = MLP()
    sync = SyncReplicas(m.loss, make_optimizer(tconfig.OptimizerConfig(
        name="sgd", learning_rate=0.1)), device="cpu")
    state = sync.init(m.init, seed=0)
    data = synthetic_mnist(64, 8)
    batch = {"x": data["train_x"][:16], "y": data["train_y"][:16]}
    for _ in range(steps):
        state, _ = sync.step(state, batch)
    d = str(tmp_path / "pretrained")
    tckpt.CheckpointManager(d).save(state)
    return state, d, (m, sync)


def _assert_equal_trees(a: dict, b: dict):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _state(params: dict) -> TrainState:
    return TrainState(step=0, params=params, opt_state=(), extras={},
                      seed=0, anomaly_count=torch.zeros((), dtype=torch.int32))


def test_identity_warm_start(tmp_path):
    """Every param of a fresh init (another seed) replaced by the
    checkpoint's, bitwise; the fresh state's step untouched."""
    src, d, (m, sync) = _trained_mlp_ckpt(tmp_path)
    fresh = sync.init(m.init, seed=123)
    warmed, report = warm_start(fresh.params, d)
    assert not report.fresh and len(report.restored) == 4
    _assert_equal_trees(warmed, src.params)
    assert fresh.step == 0


def test_missing_leaves_stay_fresh(tmp_path):
    """A model path the checkpoint lacks keeps its init (and is reported
    fresh), as the reference's does: its leaf is the caller's own."""
    _, d, _ = _trained_mlp_ckpt(tmp_path)
    arrays = load_checkpoint_arrays(d)
    key = sorted(k for k in arrays if k.startswith("params/"))[0]
    a, b = key[len("params/"):].split("/")
    params = {a: {b: torch.zeros(arrays[key].shape)},
              "new_head": {"kernel": torch.ones(4, 2)}}
    warmed, report = warm_start(params, d)
    assert report.fresh == ["new_head/kernel"]
    assert torch.equal(warmed["new_head"]["kernel"], torch.ones(4, 2))
    assert warmed["new_head"]["kernel"] is params["new_head"]["kernel"]
    np.testing.assert_array_equal(warmed[a][b].numpy(), arrays[key])
    _, jreport = jws.warm_start(
        {a: {b: jnp.zeros(arrays[key].shape)},
         "new_head": {"kernel": jnp.ones((4, 2))}}, d)
    assert jreport.fresh == report.fresh


def test_assignment_map_renames_scope(tmp_path):
    src, d, _ = _trained_mlp_ckpt(tmp_path)
    params = {"student": {k: {n: torch.zeros_like(t) for n, t in v.items()}
                          for k, v in src.params.items()}}
    warmed, report = warm_start(params, d, assignment_map={"": "student/"})
    assert sorted(p[len("student/"):] for p in report.restored) == sorted(
        flatten_dict(src.params))
    _assert_equal_trees(warmed["student"], src.params)


def test_shape_mismatch_raises(tmp_path):
    _, d, _ = _trained_mlp_ckpt(tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        warm_start({"fc1": {"kernel": torch.zeros(3, 3)}}, d)


def test_bf16_checkpoint_leaves(tmp_path):
    """A bf16 leaf (``__bf16__/`` uint16 in the npz) reads back as bf16
    and lands bitwise in a bf16 param, cast to f32 in an f32 one."""
    tckpt.CheckpointManager(str(tmp_path / "c")).save(
        _state({"w": torch.full((4,), 1.5, dtype=torch.bfloat16)}))
    arrays = load_checkpoint_arrays(str(tmp_path / "c"))
    assert arrays["params/w"].dtype == torch.bfloat16
    warmed, _ = warm_start({"w": torch.zeros(4, dtype=torch.bfloat16)},
                           str(tmp_path / "c"))
    assert warmed["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(warmed["w"].float().numpy(),
                                  np.full((4,), 1.5, np.float32))
    warmed, _ = warm_start({"w": torch.zeros(4)}, str(tmp_path / "c"))
    assert warmed["w"].dtype == torch.float32


def test_sharded_checkpoint_is_refused_naming_a6(tmp_path):
    """The reference's sharded save (a ``.shards.json`` anchor, which the
    directory's state file names latest, and per-process shard files),
    once refused naming slice A6, which brought sharded checkpoints,
    warm-starts the port: every param leaf is assembled from its pieces
    and lands bit for bit, as the reference reads the same directory."""
    jm = JMLP()
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(JOptimizerConfig()),
                          local_mesh(1))
    js = jsync.init(jm.init, seed=0)
    d = str(tmp_path / "sh")
    jckpt.CheckpointManager(d, sharded=True).save(js, step=5)
    want = jckpt._flatten(js.params)
    arrays = load_checkpoint_arrays(d)
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[f"params/{k}"], v, err_msg=k)
    warmed, treport = warm_start(MLP().init(0, device="cpu"), d)
    assert not treport.fresh and sorted(treport.restored) == sorted(want)
    for k, v in flatten_dict(warmed).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    _, report = jws.warm_start(jsync.init(jm.init, seed=9).params, d)
    assert not report.fresh


def test_trainer_warm_start_and_resume_priority(tmp_path):
    """A fresh run with ``warm_start`` starts at step 0 from the
    checkpoint's params; once the run's own directory holds a checkpoint,
    the next run resumes it (the trained params), not the warm start."""
    src, d, _ = _trained_mlp_ckpt(tmp_path)
    data = synthetic_mnist(512, 128)
    arrays = {"x": data["train_x"], "y": data["train_y"]}
    cfg = tconfig.TrainConfig(
        model="mlp", train_steps=2, seed=7,
        data=tconfig.DataConfig(batch_size=64),
        obs=tconfig.ObservabilityConfig(log_every_steps=0),
        checkpoint=tconfig.CheckpointConfig(directory=str(tmp_path / "run"),
                                            warm_start=d, save_steps=2))
    with Trainer(get_model("mlp", cfg), cfg, arrays, device="cpu",
                 process_index=0, num_processes=1) as tr:
        state0 = tr.initialize()
        assert state0.step == 0
        _assert_equal_trees(state0.params, src.params)
        state, _ = tr.train()
    with Trainer(get_model("mlp", cfg), cfg, arrays, device="cpu",
                 process_index=0, num_processes=1) as tr:
        state2 = tr.initialize()
        assert state2.step == 2
        _assert_equal_trees(state2.params, state.params)


def test_overlapping_map_entries_apply_independently(tmp_path):
    """tf semantics: {'a/': '', 'b/': ''} restores BOTH scopes even
    though every model path prefix-matches the first entry."""
    tckpt.CheckpointManager(str(tmp_path / "c")).save(_state(
        {"a": {"x": torch.full((2,), 1.0)}, "b": {"y": torch.full((2,),
                                                                2.0)}}))
    warmed, report = warm_start({"x": torch.zeros(2), "y": torch.zeros(2)},
                                str(tmp_path / "c"),
                                assignment_map={"a/": "", "b/": ""})
    assert not report.fresh
    assert warmed["x"].tolist() == [1.0, 1.0]
    assert warmed["y"].tolist() == [2.0, 2.0]


def test_typoed_map_scope_is_loud(tmp_path):
    """A map scope that resolves no checkpoint key is a hard error, in the
    reference's words; the reference only warns and leaves the mapped
    paths fresh. Through the Trainer (``--warm_start_map``) it stops the
    run before a step."""
    _, d, _ = _trained_mlp_ckpt(tmp_path)
    with pytest.raises(ValueError, match="matches no checkpoint key"):
        warm_start({"x": torch.zeros(2)}, d,
                   assignment_map={"encodre/": ""})
    records = []

    class _Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger("dtx.warm_start")
    h = _Grab()
    lg.addHandler(h)
    try:
        _, jreport = jws.warm_start({"x": jnp.zeros(2)}, d,
                                    assignment_map={"encodre/": ""})
    finally:
        lg.removeHandler(h)
    assert jreport.fresh == ["x"]
    assert any("matches no checkpoint key" in r for r in records)
    data = synthetic_mnist(128, 64)
    cfg = tconfig.TrainConfig(
        model="mlp", train_steps=1, data=tconfig.DataConfig(batch_size=64),
        checkpoint=tconfig.CheckpointConfig(directory=str(tmp_path / "r"),
                                            warm_start=d,
                                            warm_start_map="encodre/:"))
    with Trainer(get_model("mlp", cfg), cfg,
                 {"x": data["train_x"], "y": data["train_y"]},
                 device="cpu", process_index=0, num_processes=1) as tr:
        with pytest.raises(ValueError, match="'encodre/' matches no"):
            tr.initialize()


def test_missing_step_clean_error(tmp_path):
    """A checkpoint file that is not there, a directory with no state
    file, and a state file whose latest step was removed each give a
    FileNotFoundError naming what is missing."""
    _, d, _ = _trained_mlp_ckpt(tmp_path)
    with pytest.raises(FileNotFoundError, match="state file"):
        load_checkpoint_arrays(os.path.join(d, "ckpt-99.npz"))
    with pytest.raises(FileNotFoundError, match="state file"):
        load_checkpoint_arrays(str(tmp_path))
    (latest,) = [f for f in os.listdir(d) if f.endswith(".npz")]
    os.remove(os.path.join(d, latest))
    with pytest.raises(FileNotFoundError, match=latest):
        load_checkpoint_arrays(d)


def test_warm_start_reanchors_ema_shadow(tmp_path):
    """The EMA shadow snapshotted the fresh init at ``sync.init``: warm
    start re-anchors it at the warmed params (count 0), or eval on the
    shadow would read the discarded init for ~1/(1 - decay) steps."""
    src, d, _ = _trained_mlp_ckpt(tmp_path)
    data = synthetic_mnist(256, 64)
    cfg = tconfig.TrainConfig(
        model="mlp", train_steps=1, seed=11,
        data=tconfig.DataConfig(batch_size=64),
        optimizer=tconfig.OptimizerConfig(name="sgd", learning_rate=0.1,
                                          ema_decay=0.999),
        checkpoint=tconfig.CheckpointConfig(directory=str(tmp_path / "r"),
                                            warm_start=d))
    with Trainer(get_model("mlp", cfg), cfg,
                 {"x": data["train_x"], "y": data["train_y"]},
                 device="cpu", process_index=0, num_processes=1) as tr:
        state = tr.initialize()
    shadow = find_ema_params(state.opt_state, state.params)
    _assert_equal_trees(shadow, src.params)
    assert int(state.opt_state[-1]["count"]) == 0
    for e, p in zip(flatten_dict(shadow).values(),
                    flatten_dict(state.params).values()):
        assert e.data_ptr() != p.data_ptr()


@pytest.mark.parametrize("spec", ["", "a/:b/", "enc/:dec/,:", " bert/:enc/ "])
def test_parse_assignment_map_equals_reference(spec):
    assert parse_assignment_map(spec) == jws.parse_assignment_map(spec)


@pytest.mark.parametrize("spec", ["no-colon-here", "a b:c"])
def test_parse_assignment_map_refuses_as_the_reference(spec):
    for parse in (parse_assignment_map, jws.parse_assignment_map):
        with pytest.raises(ValueError, match="warm_start_map"):
            parse(spec)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_checkpoints_warm_start_across_both_packages(tmp_path):
    """A reference checkpoint (its MLP after 3 SGD steps, a bf16 leaf
    among its params) warm-starts the port's fresh MLP bitwise, and the
    port's checkpoint of that state warm-starts the reference's bitwise;
    the two packages' ``load_checkpoint_arrays`` read the same keys and
    values from either file (bf16 as bf16)."""
    jm = JMLP()
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(
        JOptimizerConfig(name="sgd", learning_rate=0.1)), local_mesh(1))
    js = jsync.init(jm.init, seed=0)
    data = synthetic_mnist(64, 8)
    for _ in range(3):
        js, _ = jsync.step(js, jsync.shard_batch(
            {"x": data["train_x"][:16], "y": data["train_y"][:16]}))
    js = js.replace(params=dict(js.params, extra={
        "w": jnp.full((3,), 0.375, jnp.bfloat16)}))
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.CheckpointManager(jd).save(js, step=3)
    want = jckpt._flatten(jax.device_get(js.params))
    fresh = dict(MLP().init(5, device="cpu"),
                 extra={"w": torch.zeros(3, dtype=torch.bfloat16)})
    warmed, report = warm_start(fresh, jd)
    assert not report.fresh
    got = tckpt.to_numpy(warmed)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    tckpt.CheckpointManager(td).save(_state(warmed))
    ref_fresh = dict(jm.init(jax.random.key(9)),
                     extra={"w": jnp.zeros((3,), jnp.bfloat16)})
    back, jreport = jws.warm_start(ref_fresh, td)
    assert not jreport.fresh
    for k, v in jckpt._flatten(jax.device_get(back)).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                      err_msg=k)
    for d in (jd, td):
        # the reference also returns the CRC record's member; the port
        # checks every member against it and drops it
        a, b = load_checkpoint_arrays(d), jws.load_checkpoint_arrays(d)
        b.pop("__crc32__")
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(
                np.asarray(a[k].float() if isinstance(a[k], torch.Tensor)
                           else a[k]),
                np.asarray(b[k], dtype=np.float32 if
                           isinstance(a[k], torch.Tensor) else None),
                err_msg=k)


def test_moe_bert_warm_starts_from_a_bert_checkpoint(tmp_path):
    """``cli.train --model moe_bert_tiny --warm_start`` from a bert_tiny
    run's directory, with the EMA on: every dense leaf (embeddings, each
    layer's attention, the dense layer's FFN, the MLM head) equals the
    BERT checkpoint's bytes at step 0, the MoE layer's router and experts
    keep their fresh init, the EMA is re-anchored at the warmed params;
    training goes on from there."""
    common = ["--device", "cpu", "--batch_size", "8", "--seq_len", "32",
              "--optimizer", "adamw", "--learning_rate", "1e-3",
              "--log_every_steps", "0"]
    bert_dir = str(tmp_path / "bert")
    assert tcli.main(["--model", "bert_tiny", *common, "--train_steps", "2",
                      "--ckpt_dir", bert_dir, "--save_steps", "2"]) == 0
    bert = tckpt.load_npz(os.path.join(bert_dir, "ckpt-2.npz"))
    args = tcli.build_parser().parse_args(
        ["--model", "moe_bert_tiny", *common, "--train_steps", "0",
         "--ema_decay", "0.99", "--warm_start", bert_dir,
         "--ckpt_dir", str(tmp_path / "moe")])
    cfg = tcli.config_from_args(args)
    model = get_model(cfg.model, cfg)
    train, _ = tcli.load_dataset(cfg, model)
    with Trainer(model, cfg, train, device="cpu", process_index=0,
                 num_processes=1) as tr:
        state = tr.initialize()
        fresh = tr.sync.init(model.init, seed=cfg.seed)
    assert state.step == 0
    flat = flatten_dict(state.params)
    moe = [k for k in flat if "/moe/" in k]
    assert len(moe) == 5
    for k, v in flat.items():
        if k in moe:
            assert torch.equal(v, flatten_dict(fresh.params)[k]), k
        else:
            np.testing.assert_array_equal(v.numpy(), bert[f"params/{k}"],
                                          err_msg=k)
    _assert_equal_trees(find_ema_params(state.opt_state, state.params),
                        state.params)
    assert tcli.main(["--model", "moe_bert_tiny", *common, "--train_steps",
                      "2", "--ema_decay", "0.99", "--warm_start", bert_dir,
                      "--ckpt_dir", str(tmp_path / "moe2"),
                      "--save_steps", "2"]) == 0
    assert tckpt.CheckpointManager(str(tmp_path / "moe2")).all_steps() == [2]
