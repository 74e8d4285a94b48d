"""The port's sharded checkpoints (per-rank shard files under a
``ckpt-N.shards.json`` anchor, the reference's format) on the CPU: the
counterparts of ``tests/test_sharded_checkpoint.py``, then the format
crossing the packages both ways, a resharding restore, and
``cli/train.py --mesh data=1,fsdp=2 --sharded_save`` resuming from its
anchor.

One spawn of 2 gloo ranks at (data=1, fsdp=2)
(``tests/_torch_fsdp_worker.py``, no JAX) trains the MLP 2 steps and
saves sharded, restores the reference's sharded checkpoint of a (data=2,
fsdp=4) ``cpu8`` state, and, at ``model=2``, the reference's of a
(data=2, model=2) gpt_tiny state, then runs the CLI three times at
``fsdp=2`` and three at ``model=2``. Every value is held bit for bit.
"""

import glob
import os
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import \
    OptimizerConfig as JOptimizerConfig
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, CorruptCheckpointError, latest_checkpoint,
    restore_or_init)
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import OptimizerConfig
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.state import TrainState
from _torch_fsdp_worker import GPT_TINY
from test_torch_fsdp import (OPT, assert_states_close, global_batches, load,
                             run_ranks, shared_once)

torch.set_num_threads(1)

CLI_ARGV = ["--model", "gpt_tiny", "--device", "cpu", "--seq_len", "16",
            "--batch_size", "4", "--optimizer", "adamw", "--learning_rate",
            "1e-3", "--mesh", "data=1,fsdp=2", "--sharded_save",
            "--save_steps", "2", "--log_every_steps", "2"]
#: the same run over the model axis (Megatron tensor parallelism)
CLI_TP = [x if x != "data=1,fsdp=2" else "data=1,model=2" for x in CLI_ARGV]


@pytest.fixture
def sync_and_state():
    model = MLP(in_dim=20, hidden=16, num_classes=4)
    tx = topt.make_optimizer(OptimizerConfig(name="adam", learning_rate=0.1))
    sync = SyncReplicas(model.loss, tx, device="cpu")
    return sync, sync.init(model.init, seed=0)


def leaves(state) -> dict:
    out = dict(tckpt._state_leaves(state))
    out["step"], out["seed"] = torch.tensor(state.step), torch.tensor(
        state.seed % 2**63)
    return out


def assert_states_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _reference_sharded(d: str):
    """The reference's MLP state on a (data=2, fsdp=4) cpu8 mesh (rules
    that shard every leaf of 16 elements or more), saved sharded at
    step 5 (one process: one shard file holding every piece)."""
    shape = JMesh(data=2, fsdp=4)
    jm = JMLP()
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")),
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=3)
    b = global_batches("mlp")[0]
    js, _ = jsync.step(js, jsync.shard_batch(
        {k: jnp.asarray(v) for k, v in b.items()}))
    jckpt.CheckpointManager(d, sharded=True).save(js, 5)
    return jckpt._flatten(js)


def _reference_tp_sharded(d: str):
    """The reference's gpt_tiny state on a (data=2, model=2) cpu8 mesh
    (its Megatron rules: column, row and vocab pieces), one step, saved
    sharded at step 5."""
    shape = JMesh(data=2, model=2)
    jm = JGPT(JGPTConfig(**GPT_TINY))
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:4]),
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=3)
    b = global_batches("gpt_tiny")[0]
    js, _ = jsync.step(js, jsync.shard_batch(
        {k: jnp.asarray(v) for k, v in b.items()}))
    jckpt.CheckpointManager(d, sharded=True).save(js, 5)
    return jckpt._flatten(js)


def _build_ranks(tmp):
    """The reference's sharded checkpoints, then the 2-rank spawn."""
    model = MLP()
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        OptimizerConfig(**OPT)), device="cpu")
    CheckpointManager(str(tmp / "bridge")).save(sync.init(model.init,
                                                          seed=0), 0)
    with open(tmp / "batches.npz", "wb") as f:
        np.savez(f, **{f"{i}/{k}": v for i, b in
                       enumerate(global_batches("mlp")) for k, v in
                       b.items()})
    ref = _reference_sharded(str(tmp / "ref"))
    ref_tp = _reference_tp_sharded(str(tmp / "ref_tp"))
    ports = _free_ports(6)
    cli = {}
    for tag, argv in (("", CLI_ARGV), ("_tp", CLI_TP)):
        cli[tag] = [argv + ["--ckpt_dir", str(tmp / f"cli{tag}"),
                            "--train_steps", "4"],
                    argv + ["--ckpt_dir", str(tmp / f"cli{tag}"),
                            "--train_steps", "6"],
                    argv + ["--ckpt_dir", str(tmp / f"cli{tag}_whole"),
                            "--train_steps", "6"]]
    mesh = dict(data=1, fsdp=2)
    (tmp / "tp_cli").mkdir()
    # the model=2 CLI runs in a spawn of their own: three process groups
    # brought up and left a worker process, as the fsdp runs
    spawns = [(2, [
        {"kind": "train", "name": "train", "model": "mlp", "mesh": mesh,
         "opt": OPT, "bridge": str(tmp / "bridge"),
         "batches": str(tmp / "batches.npz"), "steps": 2,
         "save": str(tmp / "port")},
        {"kind": "restore", "name": "restore", "model": "mlp",
         "mesh": mesh, "opt": OPT, "dir": str(tmp / "ref"), "step": 5},
        {"kind": "restore", "name": "restore_tp", "model": "gpt_tiny",
         "mesh": dict(model=2), "opt": OPT, "dir": str(tmp / "ref_tp"),
         "step": 5},
        {"kind": "cli", "argvs": cli[""], "ports": ports[:3]}], tmp),
        (2, [{"kind": "cli", "argvs": cli["_tp"], "ports": ports[3:]}],
         tmp / "tp_cli")]
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda a: run_ranks(*a), spawns))
    return {"tmp": tmp, "ref": ref, "ref_tp": ref_tp,
            "train": [load(tmp, "train", r) for r in range(2)],
            "restore": [load(tmp, "restore", r) for r in range(2)],
            "restore_tp": [load(tmp, "restore_tp", r) for r in range(2)]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_once(tmp_path_factory, "shck_ranks", _build_ranks)


def test_sharded_roundtrip_preserves_values(sync_and_state, tmp_path):
    sync, state = sync_and_state
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state, 5)
    files = sorted(os.path.basename(f) for f in glob.glob(
        str(tmp_path / "*")))
    assert "ckpt-5.shards.json" in files
    assert "ckpt-5.shard-0-of-1.npz" in files
    assert not any(f.endswith("ckpt-5.npz") for f in files)
    back = mgr.restore(sync.init(MLP(20, 16, 4).init, seed=9))
    assert_states_equal(state, back)


def test_sharded_pieces_are_actually_split(ranks):
    """Saved from 2 ranks at fsdp=2: the sharded leaves are stored as 2
    pieces, one in each rank's shard file, and each rank restores its
    own pieces back bit for bit (the exact-bounds read)."""
    files = sorted(glob.glob(str(ranks["tmp"] / "port" /
                                 "ckpt-2.shard-*.npz")))
    assert [os.path.basename(f) for f in files] == [
        "ckpt-2.shard-0-of-2.npz", "ckpt-2.shard-1-of-2.npz"]
    by_leaf: dict = {}
    for f in files:
        with np.load(f) as z:
            for k in z.files:
                if "::" in k:
                    by_leaf.setdefault(k.split("::")[0], []).append(f)
    split = [k for k, fs in by_leaf.items() if len(set(fs)) == 2]
    assert {"params/fc1/kernel", "opt_state/1/0/mu/fc1/kernel",
            "opt_state/1/0/nu/fc1/kernel",
            "opt_state/2/ema/fc1/kernel"} <= set(split), split
    assert "params/fc2/bias" not in split
    assert all(bool(out["roundtrip"]) for out in ranks["train"])


def test_ring_rotation_removes_all_shard_files(sync_and_state, tmp_path):
    _, state = sync_and_state
    mgr = CheckpointManager(str(tmp_path), sharded=True, max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    left = sorted(os.path.basename(f)
                  for f in glob.glob(str(tmp_path / "ckpt-*")))
    assert mgr.all_steps() == [3, 4]
    assert not any("ckpt-1" in f or "ckpt-2" in f for f in left), left


def test_restore_or_init_finds_sharded(sync_and_state, tmp_path):
    sync, state = sync_and_state
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state.replace(step=7))
    restored, was_restored = restore_or_init(
        mgr, lambda: sync.init(MLP(20, 16, 4).init, seed=0))
    assert was_restored and restored.step == 7


def test_format_autodetect_across_modes(sync_and_state, tmp_path):
    """A manager in either mode restores checkpoints written by the
    other (the format is detected from what is on disk, per step)."""
    sync, state = sync_and_state
    CheckpointManager(str(tmp_path), sharded=True).save(state, 1)
    CheckpointManager(str(tmp_path), sharded=False).save(state, 2)
    for mgr in (CheckpointManager(str(tmp_path)),
                CheckpointManager(str(tmp_path), sharded=True)):
        assert mgr.all_steps() == [1, 2]
        for s in (1, 2):
            assert_states_equal(state, mgr.restore(
                sync.init(MLP(20, 16, 4).init, seed=4), s))


def test_same_step_format_switch_supersedes(sync_and_state, tmp_path):
    """Re-saving step N in the other format evicts the old anchor: a
    stale ckpt-N.npz may not shadow a newer ckpt-N.shards.json."""
    sync, state = sync_and_state
    CheckpointManager(str(tmp_path)).save(state, 5)
    marked = state.replace(params={k: {n: t + 1 for n, t in v.items()}
                                   for k, v in state.params.items()})
    CheckpointManager(str(tmp_path), sharded=True).save(marked, 5)
    assert not os.path.exists(str(tmp_path / "ckpt-5.npz"))
    back = CheckpointManager(str(tmp_path)).restore(
        sync.init(MLP(20, 16, 4).init, seed=0), 5)
    assert_states_equal(marked, back)
    CheckpointManager(str(tmp_path)).save(state, 5)
    assert not os.path.exists(str(tmp_path / "ckpt-5.shards.json"))
    assert not glob.glob(str(tmp_path / "ckpt-5.shard-*.npz"))


def test_latest_checkpoint_points_at_sharded_anchor(sync_and_state,
                                                    tmp_path):
    _, state = sync_and_state
    CheckpointManager(str(tmp_path), sharded=True).save(state, 9)
    p = latest_checkpoint(str(tmp_path))
    assert p is not None and p.endswith("ckpt-9.shards.json")
    assert os.path.exists(p)


def test_sharded_bf16_roundtrip(tmp_path):
    model = MLP(in_dim=24, hidden=32, num_classes=4,
                param_dtype=torch.bfloat16)
    tx = topt.make_optimizer(OptimizerConfig(name="sgd", learning_rate=0.1))
    sync = SyncReplicas(model.loss, tx, device="cpu")
    state = sync.init(model.init, seed=1)
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state, 3)
    back = mgr.restore(sync.init(model.init, seed=2), 3)
    assert_states_equal(state, back)
    assert any(t.dtype == torch.bfloat16
               for t in tckpt._state_leaves(back).values())


def test_missing_shard_file_raises(sync_and_state, tmp_path):
    sync, state = sync_and_state
    mgr = CheckpointManager(str(tmp_path), sharded=True)
    mgr.save(state, 1)
    [shard] = glob.glob(str(tmp_path / "ckpt-1.shard-*.npz"))
    os.remove(shard)
    with pytest.raises(CorruptCheckpointError, match="shard"):
        mgr.restore(sync.init(MLP(20, 16, 4).init), 1)
    assert mgr.latest_valid_step() is None


def test_resharding_restore_onto_different_mesh(ranks):
    """Saved from 2 ranks at fsdp=2, restored onto one rank (world 1,
    nothing sharded): the pieces no longer match the template's layout,
    so each leaf is assembled from them, and every value survives."""
    model = MLP()
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        OptimizerConfig(**OPT)), device="cpu")
    back = CheckpointManager(str(ranks["tmp"] / "port")).restore(
        sync.init(model.init, seed=99))
    got = tckpt.state_arrays(back)
    want = ranks["train"][0]
    assert back.step == 2
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[f"state/{k}"], err_msg=k)


def test_sharded_async_single_process(sync_and_state, tmp_path):
    """sharded + async is allowed with one rank: save returns at once,
    wait() lands the write, restore sees it."""
    sync, state = sync_and_state
    mgr = CheckpointManager(str(tmp_path), sharded=True, async_save=True)
    mgr.save(state, 4)
    mgr.wait()
    assert os.path.exists(str(tmp_path / "ckpt-4.shards.json"))
    assert_states_equal(state, mgr.restore(
        sync.init(MLP(20, 16, 4).init, seed=1), 4))
    mgr.close()


def test_sharded_roundtrip_randomized_states(tmp_path):
    """Random states: nested params of f32, bf16 and int32 leaves,
    scalars and odd shapes, extras and the anomaly count — every leaf
    survives the piece-wise roundtrip bit for bit."""
    rs = np.random.RandomState(0)
    for trial in range(3):
        params = {
            "a": torch.from_numpy(rs.randn(16, 24).astype(np.float32)),
            "nested": {
                "b16": torch.from_numpy(rs.randn(8, 8).astype(
                    np.float32)).to(torch.bfloat16),
                "ints": torch.from_numpy(rs.randint(0, 9, (7,)).astype(
                    np.int32)),
                "scalar": torch.tensor(float(rs.randn())),
            },
            "odd": torch.from_numpy(rs.randn(30, 3).astype(np.float32)),
        }
        state = TrainState(
            step=trial, params=params, opt_state=(),
            extras={"stat": torch.from_numpy(rs.randn(5).astype(
                np.float32))},
            seed=int(rs.randint(0, 2**31)),
            anomaly_count=torch.tensor(trial, dtype=torch.int32))
        mgr = CheckpointManager(str(tmp_path / f"t{trial}"), sharded=True)
        mgr.save(state)
        template = state.replace(
            params={k: (v if not isinstance(v, torch.Tensor)
                        else torch.zeros_like(v))
                    for k, v in params.items()},
            seed=0)
        assert_states_equal(state, mgr.restore(template, trial))


def test_reference_sharded_checkpoint_restores_into_the_port(ranks):
    """A reference sharded checkpoint of a (data=2, fsdp=4) cpu8 state
    (its pieces 4-way) restores into the port exactly: on one rank, and
    on 2 ranks at fsdp=2, each rank assembling its 2-way pieces."""
    want = ranks["ref"]
    model = MLP()
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        OptimizerConfig(**OPT)), device="cpu")
    back = CheckpointManager(str(ranks["tmp"] / "ref")).restore(
        sync.init(model.init, seed=1), 5)
    got = tckpt.state_arrays(back)
    keys = [k for k in want if not k.startswith("__prng")]
    assert sorted(k for k in got if not k.startswith("__prng")) == \
        sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert back.step == int(want["step"]) == 1    # saved as ckpt-5
    for out in ranks["restore"]:
        assert int(out["step"]) == 1
        for k in keys:
            np.testing.assert_array_equal(out[f"state/{k}"], want[k],
                                          err_msg=k)


def test_port_sharded_checkpoint_restores_into_the_reference(ranks):
    """The port's checkpoint from 2 ranks at fsdp=2 restores into the
    reference's state on a (data=1, fsdp=2) cpu8 mesh exactly."""
    shape = JMesh(data=1, fsdp=2)
    jm = JMLP()
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:2]),
        rules=jm.sharding_rules(shape), donate=False)
    mgr = jckpt.CheckpointManager(str(ranks["tmp"] / "port"))
    back = mgr.restore(jsync.init(jm.init, seed=5))
    got = jckpt._flatten(back)
    want = ranks["train"][0]
    assert int(got["step"]) == 2
    for k, v in got.items():
        if k.startswith("__prng"):
            continue
        np.testing.assert_array_equal(np.asarray(v), want[f"state/{k}"],
                                      err_msg=k)


def test_cli_sharded_save_resumes_from_its_anchor(ranks):
    """``cli/train.py --mesh data=1,fsdp=2 --sharded_save`` over two gloo
    workers: 4 steps, then a second run resumes from the step-4 anchor
    to 6; its step-6 checkpoint equals an uninterrupted 6-step run's bit
    for bit, and the ring holds whole shard sets."""
    tmp = ranks["tmp"]
    names = sorted(os.listdir(tmp / "cli"))
    assert "ckpt-6.shards.json" in names and "ckpt-4.shards.json" in names
    assert {"ckpt-6.shard-0-of-2.npz", "ckpt-6.shard-1-of-2.npz"} <= set(
        names)
    resumed = CheckpointManager(str(tmp / "cli")).sharded_arrays(6)
    whole = CheckpointManager(str(tmp / "cli_whole")).sharded_arrays(6)
    assert sorted(resumed) == sorted(whole)
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)


def test_reference_tp_checkpoint_restores_into_the_port(ranks):
    """A reference sharded checkpoint of gpt_tiny on a (data=2, model=2)
    cpu8 mesh (its pieces: q/k/v and FFN-in columns, o and FFN-out rows,
    the word table's vocab rows) restores exactly into the port at
    ``model=2`` on 2 gloo ranks, each rank reading its own pieces."""
    want = ranks["ref_tp"]
    keys = [k for k in want if not k.startswith("__prng")]
    for out in ranks["restore_tp"]:
        assert int(out["step"]) == 1
        for k in keys:
            np.testing.assert_array_equal(out[f"state/{k}"], want[k],
                                          err_msg=k)


def test_cli_model_sharded_save_resumes_from_its_anchor(ranks, tmp_path):
    """``cli/train.py --model gpt_tiny --mesh data=1,model=2
    --sharded_save`` over two gloo workers: 4 steps, then a second run
    resumes from the step-4 anchor to 6; its step-6 checkpoint equals an
    uninterrupted 6-step run's bit for bit, and the word table's vocab
    pieces lie in both ranks' shard files. Both ``model`` ranks read the
    same rows: the run's params equal one worker's run of the same flags
    with whole params (``test_torch_fsdp.assert_states_close``'s params
    tolerance; after 6 steps with dropout a few near-zero Adam moments
    drift past its 3-step moment tolerance, so the moments are left to
    the 3-step tests of ``tests/test_torch_tp.py``)."""
    tmp = ranks["tmp"]
    names = sorted(os.listdir(tmp / "cli_tp"))
    assert "ckpt-6.shards.json" in names and "ckpt-4.shards.json" in names
    resumed = CheckpointManager(str(tmp / "cli_tp")).sharded_arrays(6)
    whole = CheckpointManager(str(tmp / "cli_tp_whole")).sharded_arrays(6)
    assert sorted(resumed) == sorted(whole)
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)
    for r in range(2):
        with np.load(tmp / "cli_tp" / f"ckpt-6.shard-{r}-of-2.npz") as z:
            assert any(k.startswith("params/wte/table::") for k in z.files)
    one = str(tmp_path / "one")
    argv = [x if x != "data=1,model=2" else "data=1" for x in CLI_TP]
    assert tcli.main(argv + ["--ckpt_dir", one, "--train_steps", "6"]) == 0
    alone = CheckpointManager(one).sharded_arrays(6)
    assert_states_close({f"state/{k}": v for k, v in whole.items()},
                        {k: v for k, v in alone.items()
                         if k.startswith("params/")})
