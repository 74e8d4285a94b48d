"""The port's N synchronous workers over ``torch.distributed``, on the CPU
(gloo): two ranks against one rank on the same global batches, against
the reference's ``SyncReplicas`` on a 2-device CPU mesh (``auto`` and
``shard_map``), the MLP and ResNet-20 with its batch norm across the
ranks (over the global batch under ``auto``, over each rank's under
``shard_map``), the CLI and the example script as two workers, and the
refusals of what later slices bring.

Every rank is a subprocess started with ``subprocess.run`` and a timeout
of its own (no fork inside a test worker); the ranks of a test meet
through a ``file://`` rendezvous in ``tmp_path``, or, for the entry
points that take worker addresses, at ports bound to 0 just before the
spawn. Tolerances are the reference's
``tests/test_sync_replicas.py::test_nchip_step_equals_single_chip``:
loss rtol 1e-5, params rtol 2e-5 and atol 1e-6.
"""

import os
import re
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.data import loader as jloader
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.models.resnet import \
    _make_resnet20 as jresnet20
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import loader as tloader
from distributed_tensorflow_example_tpu_torch.data.cifar import \
    synthetic_cifar10
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models import \
    resnet as tresnet
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import (
    SyncReplicas, make_sync_train_step)
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, tree_map)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_sync_worker.py")
EXAMPLE = "distributed_tensorflow_example_tpu_torch.examples.mnist_distributed"
RANK_TIMEOUT_S = 150
STEPS, GLOBAL_BATCH, NUM_TRAIN = 10, 256, 2048
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-5, 1e-6


def _env():
    # gloo on the loopback interface: the ranks share this host
    return dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=os.pathsep.join(
                    p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))


def _run_ranks(argvs: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Each argv as one rank, all at once, each under its own timeout."""
    def one(argv):
        return subprocess.run([sys.executable, *argv], cwd=ROOT, env=_env(),
                              capture_output=True, text=True,
                              timeout=RANK_TIMEOUT_S)
    with ThreadPoolExecutor(len(argvs)) as ex:
        out = list(ex.map(one, argvs))
    for r in out:
        assert r.returncode == 0, r.stdout + r.stderr
    return out


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _reference_state(bridge: str, mode: str = "auto", n_dev: int = 1,
                     model: str = "mlp"):
    """The reference's model and sync step over ``n_dev`` CPU devices (the
    MLP: SGD at lr 0.5; ResNet-20: momentum SGD at lr 0.01, as
    ``tests/_torch_sync_worker.py`` trains them), and its seed-0 state,
    written to ``bridge`` as step 0 (the weights the port's ranks
    restore)."""
    jm, opt = ((JMLP(), dict(name="sgd", learning_rate=0.5))
               if model == "mlp" else
               (jresnet20(jconfig.TrainConfig()),
                dict(name="momentum", learning_rate=0.01)))
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(jconfig.OptimizerConfig(**opt)),
        local_mesh(n_dev), sync=jconfig.SyncConfig(mode=mode))
    js = jsync.init(jm.init, seed=0)
    jckpt.CheckpointManager(bridge).save(js, 0)
    return jsync, js


def _spawn_sync_ranks(tmp_path, bridge: str, mode: str = "auto",
                      world: int = 2, model: str = "mlp",
                      steps: int = STEPS, accum: int = 1,
                      f64: bool = False) -> list[dict]:
    tmp_path.mkdir(parents=True, exist_ok=True)
    rdv = "file://" + str(tmp_path / "rdv")
    argvs = [[WORKER, "--rank", str(r), "--world", str(world), "--init",
              rdv, "--bridge", bridge, "--ckpt", str(tmp_path / "ck"),
              "--out", str(tmp_path / f"rank{r}.npz"), "--mode", mode,
              "--steps", str(steps), "--model", model, "--accum",
              str(accum)] + (["--f64"] if f64 else [])
             for r in range(world)]
    _run_ranks(argvs)
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def _params(out: dict, prefix: str = "params/") -> dict:
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _global_batches():
    data = synthetic_mnist(NUM_TRAIN, 64)
    return tloader.make_loader({"x": data["train_x"], "y": data["train_y"]},
                               GLOBAL_BATCH, seed=0)


def test_two_ranks_equal_one_rank_on_the_same_global_batch(tmp_path):
    """2 gloo ranks, each on its half of every global batch of 256, over
    10 SGD steps at lr 0.5, against 1 rank on the whole batch from the
    same bridged weights: the reference's n-chip tolerances; the two
    ranks' params equal bit for bit. Also on the ranks: rank 0's
    restore-or-init decision and state reach rank 1 (a fresh init from
    each rank's own seed ends equal), only rank 0 writes the
    checkpoint, and replicas_to_aggregate=1 over 2 ranks is refused."""
    bridge = str(tmp_path / "bridge")
    _reference_state(bridge)
    r0, r1 = _spawn_sync_ranks(tmp_path, bridge)

    model = MLP()
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(name="sgd", learning_rate=0.5)),
        device="cpu")
    state, restored = tckpt.restore_or_init(tckpt.CheckpointManager(bridge),
                                            sync.init, model.init)
    assert restored
    batches = _global_batches()
    losses = []
    for _ in range(STEPS):
        state, m = sync.step(state, next(batches))
        losses.append(float(m["loss"]))

    for r in (r0, r1):
        assert bool(r["restored"]) and int(r["step"]) == STEPS
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        assert "replicas_to_aggregate=1" in str(r["refused"])
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    one = {k: v.detach().numpy() for k, v in
           flatten_dict(state.params).items()}
    p0, p1 = _params(r0), _params(r1)
    assert sorted(p0) == sorted(one)
    for k in one:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_allclose(p0[k], one[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
    f0, f1 = _params(r0, "fresh/"), _params(r1, "fresh/")
    own1 = MLP().init(torch.Generator().manual_seed(8))     # rank 1's seed
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k], err_msg=k)
    assert not np.array_equal(f1["fc1/kernel"],
                              own1["fc1"]["kernel"].numpy())
    assert bool(r0["wrote"]) and not bool(r1["wrote"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["checkpoint",
                                                   f"ckpt-{STEPS}.npz"]


#: the language models' ranks against one rank: LAMB and AdamW divide
#: by each element's own RMS, so an element whose gradient is ~0 moves by
#: a fraction of an lr when summation order differs; params are held to
#: a tenth of the lr elementwise, the attention's key biases (a zero
#: gradient up to rounding, by the softmax's shift invariance) to 2 lr a
#: step
LM_STEPS = 4


@pytest.mark.parametrize("model,accum", [
    ("bert_tiny", 1), ("gpt_tiny", 1), ("bert_tiny", 2), ("gpt_tiny", 2)],
    ids=["bert_tiny", "gpt_tiny", "bert_tiny-accum2", "gpt_tiny-accum2"])
def test_two_ranks_equal_one_rank_language_models(tmp_path, model, accum):
    """2 gloo ranks against 1 rank on the same global batches of 8
    sequences with trailing PAD, so the ranks' shares hold different
    numbers of tokens (``tests/_torch_sync_worker.py``: BERT-tiny under
    LAMB, GPT-tiny under AdamW with the accuracy argmax every 2nd step;
    no dropout), 4 steps from one checkpoint: under ``auto`` the step
    weights each rank by its loss's token count, so the loss and
    accuracy are the global batch's (rtol 1e-5 / atol 1e-6), the -1.0
    sentinel of a skipped step passes through unchanged, GPT's
    ``extras/lm_step`` ticks once a step on both ranks, and the params
    match as ``LM_STEPS``' note says. With ``accum_steps=2`` each rank
    holds its share of each global microbatch of 4 (the loader's
    ``microbatches`` layout), the ranks' shares of a microbatch are
    weighted by their token counts and the two microbatches' means
    averaged, as the one rank's step (and the reference's ``auto``)
    does; GPT's accuracy then runs every step (the reference refuses
    the cadence with accumulation)."""
    import _torch_sync_worker as worker
    global_batch, make_data, opt, make_model, acc_key = worker.SETUPS[model]
    m = worker.gpt_tiny_model(accum) if model == "gpt_tiny" else make_model()
    sync = SyncReplicas(m.loss, topt.make_optimizer(opt), device="cpu",
                        sync=tconfig.SyncConfig(accum_steps=accum))
    bridge = str(tmp_path / "bridge")
    tckpt.CheckpointManager(bridge).save(sync.init(m.init, seed=0))
    r0, r1 = _spawn_sync_ranks(tmp_path / "ranks", bridge, model=model,
                               steps=LM_STEPS, accum=accum)
    state, restored = tckpt.restore_or_init(tckpt.CheckpointManager(bridge),
                                            sync.init, m.init, seed=1)
    assert restored
    batches = tloader.make_loader(make_data(), global_batch, seed=0)
    losses, accs = [], []
    for _ in range(LM_STEPS):
        state, met = sync.step(state, next(batches))
        losses.append(float(met["loss"]))
        accs.append(float(met[acc_key]))
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["accs"], accs, rtol=1e-5, atol=1e-6)
    if model == "gpt_tiny" and accum == 1:
        assert accs[1] == accs[3] == -1.0 and accs[0] >= 0.0
        assert r0["accs"][1] == r1["accs"][3] == -1.0
        for r in (r0, r1):
            assert float(r["extras/lm_step"]) == LM_STEPS
    one = {k: v.detach().numpy() for k, v in
           flatten_dict(state.params).items()}
    p0, p1 = _params(r0), _params(r1)
    assert sorted(p0) == sorted(one)
    lr = opt.learning_rate
    for k in one:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        atol = 2 * lr * LM_STEPS if k.endswith("attn/k/bias") else 0.1 * lr
        np.testing.assert_allclose(p0[k], one[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_two_ranks_match_reference_two_device_mesh(tmp_path, mode):
    """2 port ranks against the reference's ``SyncReplicas`` on a
    2-device CPU mesh in the same ``mode``, from the reference's own
    initial state bridged through its npz checkpoint, over 10 global
    batches of 256: each step's loss rtol 1e-5, accuracy equal, final
    params rtol 2e-5 and atol 1e-6."""
    bridge = str(tmp_path / "bridge")
    jsync, js = _reference_state(bridge, mode=mode, n_dev=2)
    r0, r1 = _spawn_sync_ranks(tmp_path, bridge, mode=mode)
    data = synthetic_mnist(NUM_TRAIN, 64)
    batches = jloader.make_loader({"x": data["train_x"],
                                   "y": data["train_y"]}, GLOBAL_BATCH,
                                  seed=0)
    losses, accs = [], []
    for _ in range(STEPS):
        js, m = jsync.step(js, jsync.shard_batch(next(batches)))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    want = jckpt._flatten(jax.device_get(js.params))
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        np.testing.assert_array_equal(r["accs"], accs)
        got = _params(r)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)


CNN_STEPS = 3


def _cifar_batches(loader_mod):
    d = synthetic_cifar10(160, 8)
    return loader_mod.make_loader({"x": d["train_x"], "y": d["train_y"]},
                                  16, seed=0)


def _resnet20_one_rank(bridge: str, mode: str = "auto", accum: int = 1,
                       f64: bool = False):
    """The port's ResNet-20 on one rank from the bridged state, over the
    same global batches as the ranks (``f64``: compute, batch statistics
    and state in f64, as the worker's ``--f64``): (losses, params and
    extras)."""
    model = (tresnet.ResNet("resnet20", tresnet._BasicBlock, [3, 3, 3],
                            [16, 32, 64], 10, 32, False,
                            dtype=torch.float64,
                            bn_stats_dtype=torch.float64)
             if f64 else get_model("resnet20"))
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(name="momentum", learning_rate=0.01)),
        device="cpu", sync=tconfig.SyncConfig(mode=mode, accum_steps=accum))
    state, restored = tckpt.restore_or_init(tckpt.CheckpointManager(bridge),
                                            sync.init, model.init)
    assert restored
    if f64:
        state = state.replace(**{part: tree_map(
            lambda t: t.double() if t.is_floating_point() else t,
            getattr(state, part)) for part in ("params", "extras",
                                               "opt_state")})
    batches = _cifar_batches(tloader)
    losses = []
    for _ in range(CNN_STEPS):
        b = next(batches)
        if f64:
            b = dict(b, x=b["x"].astype(np.float64))
        state, m = sync.step(state, b)
        losses.append(float(m["loss"]))
    return np.array(losses), tckpt.to_numpy({"params": state.params,
                                             "extras": state.extras})


@pytest.mark.parametrize("accum,f64,tol", [(1, False, 1e-4),
                                           (2, True, 1e-9)])
def test_two_ranks_sync_bn_equal_one_rank(tmp_path, accum, f64, tol):
    """ResNet-20 under ``auto`` as 2 gloo ranks, each on 8 of every global
    batch of 16, against 1 rank on the whole batch, 3 momentum steps
    from the same bridged weights: every batch norm averages its
    per-channel statistics over the ranks (a differentiable all-reduce
    forward, the same on the cotangent backward), so the ranks normalise
    over the global batch and the gradients' mean over the ranks is the
    one rank's gradient. Each loss within 1e-5 relative (the loss is f32
    in both dtypes), the params and running statistics within ``tol`` of
    the largest value of their leaf, the two ranks' equal bit for bit.

    With ``accum_steps=2`` each rank's batch holds its 4 of each global
    microbatch of 8 in turn (the loader's ``microbatches`` layout), so
    the ranks' microbatch i is the one rank's, as in the reference's
    ``auto``. That case runs in f64 (compute, statistics and state): in
    f32 the variance E[x^2] - mean^2 over 8 images loses digits, and the
    two summation orders part by up to 5.7e-2 of a leaf's largest value
    in 3 steps; in f64 they agree within 3e-15 (measured), where each
    rank's own contiguous 8 as its microbatches part by 0.97."""
    bridge = str(tmp_path / "bridge")
    _reference_state(bridge, model="resnet20")
    r0, r1 = _spawn_sync_ranks(tmp_path, bridge, model="resnet20",
                               steps=CNN_STEPS, accum=accum, f64=f64)
    losses, one = _resnet20_one_rank(bridge, accum=accum, f64=f64)
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    keys = [k for k in one if k.startswith(("params/", "extras/"))]
    assert any(k.startswith("extras/") for k in keys)
    assert sorted(keys) == sorted(k for k in r0 if k.startswith(
        ("params/", "extras/")))
    for k in keys:
        assert r0[k].dtype == (np.float64 if f64 else np.float32), k
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=0,
                                   atol=tol * np.abs(one[k]).max(),
                                   err_msg=k)


def test_loader_lays_out_each_ranks_share_of_every_microbatch():
    """The loader's ``microbatches=K`` layout: rank r's batch is its
    contiguous share of each of the K consecutive microbatches of the
    global batch, in order (K=1: its contiguous slice), so the ranks'
    microbatch i together is the global microbatch i. ``SyncReplicas``
    asks for K = accum_steps under ``auto`` and 1 under ``shard_map``
    (where each replica splits its own batch, as in the reference), and
    the Trainer's loader lays the batch out so."""
    arrays = {"x": np.zeros((64, 1), np.float32), "y": np.arange(64)}
    glob = next(iter(tloader.ShardedLoader(arrays, 16, seed=3)))["y"]
    for k in (1, 2, 4):
        for r in range(2):
            got = next(iter(tloader.ShardedLoader(
                arrays, 16, seed=3, process_index=r, num_processes=2,
                microbatches=k)))["y"]
            np.testing.assert_array_equal(got.reshape(k, -1),
                                          glob.reshape(k, 2, -1)[:, r])
    with pytest.raises(ValueError, match="4 microbatches"):
        tloader.ShardedLoader(arrays, 12, num_processes=2, microbatches=4)
    for mode, k in (("auto", 2), ("shard_map", 1)):
        cfg = tconfig.TrainConfig(
            model="mlp", mesh=tconfig.MeshShape(data=-1),
            sync=tconfig.SyncConfig(mode=mode, accum_steps=2),
            data=tconfig.DataConfig(batch_size=16, seed=3, prefetch=0))
        tr = Trainer(MLP(), cfg, arrays, device="cpu", process_index=1,
                     num_processes=2)
        assert tr.sync.loader_microbatches == k
        got = next(tr._loader(0))["y"]
        np.testing.assert_array_equal(got.reshape(k, -1),
                                      glob.reshape(k, 2, -1)[:, 1])


#: per leaf, over its own move from the bridged state (the f64 run's),
#: for the params and the running statistics: the port's f32 ranks
#: against their f64 run (measured 7.1e-2 and 1.7e-4), and the
#: reference's f32 mesh against the same f64 run, its own rounding
#: (measured 6.5e-2 and 2.7e-4)
SHARD_MAP_PORT_TOL = {"params/": 0.2, "extras/": 1e-2}
SHARD_MAP_REF_TOL = {"params/": 0.2, "extras/": 1e-2}


def test_two_ranks_shard_map_bn_match_reference_two_device_mesh(tmp_path):
    """ResNet-20 under ``shard_map`` as 2 gloo ranks against the
    reference's ``shard_map`` on a 2-device CPU mesh, 3 momentum steps on
    global batches of 16 from the reference's bridged state: each
    replica normalises over its own 8 images, and the new running
    statistics are averaged over the replicas after the step. The same
    2 ranks in f64 are the measure of f32 rounding. Each loss within
    2e-4 relative of the reference's. Each param and running statistic,
    against its own move over the 3 steps (the f64 run's): the port's
    within SHARD_MAP_PORT_TOL of the f64 run, the reference's within
    SHARD_MAP_REF_TOL of it (the variance E[x^2] - mean^2 over 8 images
    loses digits in f32 in both packages: the readings are beside the
    tolerances); and,
    as before, the port within 0.1 of the largest move of any leaf of
    its kind from the reference. The two ranks equal bit for bit. The
    one-rank losses differ by more than 1e-4 from the second step on:
    the per-rank statistics are not the global ones."""
    bridge = str(tmp_path / "bridge")
    jsync, js = _reference_state(bridge, mode="shard_map", n_dev=2,
                                 model="resnet20")
    init = tckpt.load_npz(os.path.join(bridge, "ckpt-0.npz"))
    r0, r1 = _spawn_sync_ranks(tmp_path / "f32", bridge, mode="shard_map",
                               model="resnet20", steps=CNN_STEPS)
    oracle, _ = _spawn_sync_ranks(tmp_path / "f64", bridge,
                                  mode="shard_map", model="resnet20",
                                  steps=CNN_STEPS, f64=True)
    batches = _cifar_batches(jloader)
    jl = []
    for _ in range(CNN_STEPS):
        js, m = jsync.step(js, jsync.shard_batch(next(batches)))
        jl.append(float(m["loss"]))
    want = jckpt._flatten(jax.device_get({"params": js.params,
                                          "extras": js.extras}))
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], jl, rtol=2e-4)
    one, _ = _resnet20_one_rank(bridge)
    assert np.abs(r0["losses"][1:] / one[1:] - 1).min() > 1e-4
    for part in ("params/", "extras/"):
        keys = [k for k in want if k.startswith(part)]
        move = {k: np.abs(oracle[k] - init[k]).max() for k in keys}
        top = max(move.values())
        for k in keys:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
            assert np.abs(r0[k] - oracle[k]).max() <= \
                SHARD_MAP_PORT_TOL[part] * move[k], k
            assert np.abs(want[k] - oracle[k]).max() <= \
                SHARD_MAP_REF_TOL[part] * move[k], k
            assert np.abs(r0[k] - want[k]).max() <= 0.1 * top, k


def test_cli_two_workers_equal_one_worker(tmp_path):
    """``cli.train --model mlp`` as two workers (``--worker_hosts`` of two
    local addresses, gloo) against one worker on the same argv: 40 steps
    with a checkpoint every 20 in a ring of 2, a resume to 60, and the
    final checkpoints agree to the n-chip tolerances. Rank 0 alone writes
    the ring and the metrics file."""
    def argv(ck, m, steps):
        return ["--model", "mlp", "--device", "cpu", "--batch_size", "256",
                "--ckpt_dir", ck, "--save_steps", "20", "--max_to_keep",
                "2", "--log_every_steps", "20", "--metrics_path", m,
                "--train_steps", str(steps)]
    one_ck, two_ck = str(tmp_path / "one"), str(tmp_path / "two")
    one_m, two_m = str(tmp_path / "one.jsonl"), str(tmp_path / "two.jsonl")
    for steps in (40, 60):
        assert tcli.main(argv(one_ck, one_m, steps)) == 0
        hosts = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
        _run_ranks([["-m", "distributed_tensorflow_example_tpu_torch.cli."
                     "train", *argv(two_ck, two_m, steps), "--worker_hosts",
                     hosts, "--task_index", str(i)] for i in range(2)])
    assert tckpt.CheckpointManager(two_ck).all_steps() == [40, 60]
    one = tckpt.load_npz(os.path.join(one_ck, "ckpt-60.npz"))
    two = tckpt.load_npz(os.path.join(two_ck, "ckpt-60.npz"))
    assert sorted(one) == sorted(two)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
    with open(two_m) as f:
        starts = [line for line in f if '"start_step"' in line]
    assert len(starts) == 2 and '"num_processes": 2' in starts[0]


def test_example_as_two_workers_trains(tmp_path):
    """The port's example with ``--worker_hosts`` naming two local
    workers: both train on their halves of each global batch and reach
    0.95 test accuracy; worker 0's output carries the reference's
    lines."""
    ckpt = str(tmp_path / "ckpt")
    hosts = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
    out = _run_ranks([["-m", EXAMPLE, "--device", "cpu", "--train_steps",
                       "120", "--log_every_steps", "60", "--ckpt_dir",
                       ckpt, "--worker_hosts", hosts, "--task_index",
                       str(i)] for i in range(2)])
    w0 = out[0].stdout
    assert re.search(r"^step 120: loss=[\d.]+ \([\d.]+ steps/s\)$", w0,
                     re.M), w0
    m = re.search(r"final test accuracy: ([\d.]+)", w0)
    assert m and float(m.group(1)) >= 0.95, w0
    assert "final test accuracy" in out[1].stdout
    assert sorted(os.listdir(ckpt)) == ["checkpoint", "ckpt-120.npz"]


def test_replicas_to_aggregate_must_equal_the_world_size():
    """One process is a world of one: 2 replicas to aggregate, or 2 total
    replicas, are refused with the reference's ValueError (the 2-rank
    case runs in the ranks of the test above)."""
    model = MLP(in_dim=20, hidden=16, num_classes=4)
    tx = topt.make_optimizer(tconfig.OptimizerConfig())
    for kw in (dict(replicas_to_aggregate=2), dict(total_num_replicas=2)):
        with pytest.raises(ValueError, match="replicas"):
            SyncReplicas(model.loss, tx, device="cpu",
                         sync=tconfig.SyncConfig(**kw))
    sync = SyncReplicas(model.loss, tx, device="cpu",
                        sync=tconfig.SyncConfig(replicas_to_aggregate=1,
                                                mode="shard_map"))
    assert sync.num_replicas == 1


def _cli_refusal(extra):
    def run():
        return tcli.main(["--model", "mlp", "--device", "cpu",
                          "--batch_size", "8", "--train_steps", "3"]
                         + extra)
    return run


def _trainer_refusal(**kw):
    def run():
        cfg = tconfig.TrainConfig(model="mlp", train_steps=3,
                                  data=tconfig.DataConfig(batch_size=8),
                                  **kw)
        data = synthetic_mnist(64, 8)
        with Trainer(MLP(), cfg, {"x": data["train_x"],
                                  "y": data["train_y"]},
                     device="cpu") as t:
            return t.train()[0].step
    return run


def _sync_refusal(mesh):
    def run():
        model = MLP(in_dim=20, hidden=16, num_classes=4)
        make_sync_train_step(model.loss, topt.make_optimizer(
            tconfig.OptimizerConfig()), mesh, device="cpu")
    return run


def _multi_step():
    model = MLP(in_dim=20, hidden=16, num_classes=4)
    sync = SyncReplicas(model.loss, topt.make_optimizer(
        tconfig.OptimizerConfig()), device="cpu")
    rs = np.random.RandomState(0)
    state, _ = sync.multi_step(sync.init(model.init), {
        "x": rs.rand(2, 8, 20).astype(np.float32),
        "y": rs.randint(0, 4, (2, 8)).astype(np.int32)})
    return state.step


#: name -> (run, what it does: an exception type and the fragment its
#: message holds, or None and the value the run returns)
REFUSALS = {
    # the K-step dispatch (slice A3c-2b) runs: multi_step takes 2 steps,
    # the CLI's and the Trainer's runs end at their 3 steps (2 a call
    # and a tail of 1)
    "multi_step": (_multi_step, None, 2),
    "cli-steps_per_loop": (_cli_refusal(["--steps_per_loop", "2"]),
                           None, 0),
    "cli-max_inflight_steps": (_cli_refusal(["--max_inflight_steps", "2"]),
                               None, 0),
    "trainer-steps_per_loop": (_trainer_refusal(steps_per_loop=2),
                               None, 3),
    # the fsdp (slice A6a), model (A6a-2), seq (A6b), pipe (A6c) and
    # expert (A6d) axes train: a row that named them meets the rule of one
    # rank a card (more mesh ranks than ranks)
    "cli-mesh-fsdp": (_cli_refusal(["--mesh", "fsdp=2,expert=2"]),
                      SystemExit, "one rank a card"),
    "cli-mesh-model": (_cli_refusal(["--mesh", "model=2"]), SystemExit,
                       "one rank a card"),
    "trainer-mesh-fsdp": (_trainer_refusal(
        mesh=tconfig.MeshShape(fsdp=2, model=2, expert=2)),
        NotImplementedError, "one rank a card"),
    "sync-mesh-model": (_sync_refusal(tconfig.MeshShape(model=2)),
                        NotImplementedError, "one rank a card"),
    # more replicas than ranks is no later slice's: it breaks the rule of
    # one rank a card, which the refusal states
    "sync-two-replicas-one-rank": (_sync_refusal(2), NotImplementedError,
                                   "one rank a card"),
    # paired with the K-step dispatch, which runs now, --native and
    # sharded saves meet the rule the expert axis breaks on one rank
    "cli-native": (_cli_refusal(["--native", "--sharded_save", "--mesh",
                                 "expert=2", "--steps_per_loop", "2"]),
                   SystemExit, "one rank a card"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_each_knob_runs_or_meets_the_rule_that_applies(name):
    """``multi_step``, ``--steps_per_loop 2`` and ``--max_inflight_steps``
    (slice A3c-2b) run to their end; more replicas (or ``model``,
    ``expert`` ranks) than ranks states the rule of one rank a card."""
    run, exc, want = REFUSALS[name]
    if exc is None:
        assert run() == want
        return
    with pytest.raises(exc, match=want):
        run()
