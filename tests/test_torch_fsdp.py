"""The port's fsdp step (ZeRO-3 over gloo ranks) against the JAX package's
``SyncReplicas`` on the same mesh shape, on the CPU.

One spawn of 2 ranks at (data=1, fsdp=2) and one of 4 at (data=2,
fsdp=2) (``tests/_torch_fsdp_worker.py``, no JAX) train the MLP and a
GPT of gpt_tiny's dims (dropout off) for 3 steps of AdamW with the
global-norm clip engaged and the parameter EMA, from the reference's
step-0 state bridged through its npz checkpoint, on numpy-seeded global
batches. Each rank's result is held to the reference's run on as many
devices of the ``cpu8`` mesh, to the port's replicated run of the same
global batches on one rank, and to the reference's per-device shard
sizes. Tolerances are stated per test; f32 differences come from
summation order only.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
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
from distributed_tensorflow_example_tpu.utils.pytree import path_str
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import OptimizerConfig
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from _torch_fsdp_worker import GPT_TINY, model_of

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_fsdp_worker.py")
RANK_TIMEOUT_S = 150
STEPS = 3
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
           grad_clip_norm=1e-3, ema_decay=0.9)
MESHES = {2: dict(data=1, fsdp=2), 4: dict(data=2, fsdp=2)}
MODELS = ("mlp", "gpt_tiny")


def run_ranks(world: int, tasks: list, tmp) -> None:
    """``world`` worker ranks over a ``file://`` rendezvous, all at once,
    each under its own timeout."""
    with open(tmp / "tasks.json", "w") as f:
        json.dump(tasks, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))

    def one(r):
        return subprocess.run(
            [sys.executable, WORKER, "--rank", str(r), "--world",
             str(world), "--init", "file://" + str(tmp / "rdv"), "--tasks",
             str(tmp / "tasks.json"), "--out", str(tmp)],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=RANK_TIMEOUT_S)
    with ThreadPoolExecutor(world) as ex:
        outs = list(ex.map(one, range(world)))
    for r in outs:
        assert r.returncode == 0, r.stdout + r.stderr


def load(tmp, name: str, rank: int) -> dict:
    with np.load(tmp / f"{name}.rank{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def global_batches(model: str) -> list[dict]:
    """3 numpy-seeded global batches: 16 MNIST-shaped rows, or 8 token
    rows of 32 whose second and fifth rows end in 6 pad tokens."""
    out = []
    for i in range(STEPS):
        rs = np.random.RandomState(100 + i)
        if model == "mlp":
            out.append({"x": rs.rand(16, 784).astype(np.float32),
                        "y": rs.randint(0, 10, (16,)).astype(np.int32)})
        else:
            ids = rs.randint(0, 1000, (8, 32)).astype(np.int32)
            mask = np.ones_like(ids)
            mask[[1, 4], 26:] = 0
            out.append({"input_ids": ids, "attention_mask": mask})
    return out


def jmodel_of(name: str):
    return JMLP() if name == "mlp" else JGPT(JGPTConfig(**GPT_TINY))


def reference_run(model: str, mesh: dict, bridge: str):
    """The reference's 3 steps on ``mesh`` over as many cpu8 devices:
    writes its step-0 state to ``bridge``; returns (losses, grad norms,
    the final state's flat arrays, each leaf's per-device shard numel)."""
    shape = JMesh(**mesh)
    n = shape.data * shape.fsdp
    jm = jmodel_of(model)
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:n]),
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=0)
    jckpt.CheckpointManager(bridge).save(js, 0)
    numel = {path_str(p): int(x.addressable_shards[0].data.size)
             for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
             if isinstance(x, jax.Array)
             and not jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)}
    losses, norms = [], []
    for b in global_batches(model):
        js, met = jsync.step(js, jsync.shard_batch(
            {k: jax.numpy.asarray(v) for k, v in b.items()}))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, jckpt._flatten(js), numel


def replicated_run(model: str, bridge: str):
    """The port's own replicated run (one rank) of the same global
    batches, from the same bridged state."""
    m = model_of(model)
    sync = SyncReplicas(m.loss, topt.make_optimizer(OptimizerConfig(**OPT)),
                        device="cpu")
    state, restored = tckpt.restore_or_init(
        tckpt.CheckpointManager(bridge), lambda: sync.init(m.init, seed=0))
    assert restored
    losses, norms = [], []
    for b in global_batches(model):
        state, met = sync.step(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, tckpt.state_arrays(state)


def _prepare(world: int, tmp):
    """The reference's and the replicated runs, and the ranks' tasks."""
    tasks, ref, rep = [], {}, {}
    for model in MODELS:
        bridge = str(tmp / f"bridge_{model}")
        ref[model] = reference_run(model, MESHES[world], bridge)
        rep[model] = replicated_run(model, bridge)
        with open(tmp / f"batches_{model}.npz", "wb") as f:
            np.savez(f, **{f"{i}/{k}": v for i, b in
                           enumerate(global_batches(model))
                           for k, v in b.items()})
        tasks.append({"kind": "train", "name": model, "model": model,
                      "mesh": MESHES[world], "opt": OPT, "bridge": bridge,
                      "batches": str(tmp / f"batches_{model}.npz"),
                      "steps": STEPS})
    return tasks, ref, rep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' ranks spawned at once, after the in-process
    runs they are held to."""
    tmps = {w: tmp_path_factory.mktemp(f"fsdp{w}") for w in MESHES}
    prep = {w: _prepare(w, tmps[w]) for w in MESHES}
    with ThreadPoolExecutor(len(MESHES)) as ex:
        list(ex.map(lambda w: run_ranks(w, prep[w][0], tmps[w]), MESHES))
    return {w: (prep[w][1], prep[w][2],
                {m: [load(tmps[w], m, r) for r in range(w)]
                 for m in MODELS})
            for w in MESHES}


CASES = [(w, m) for w in MESHES for m in MODELS]
IDS = [f"{w}ranks-{m}" for w, m in CASES]


# Adam divides each gradient element by its running RMS, so an f32
# rounding difference on an element whose gradient is near zero is not
# scaled down with it (tests/test_torch_train.py measures it): params and
# the EMA shadows are held to a tenth of the lr elementwise with at most
# 0.1% of a leaf's elements off by more than 2e-6; the attention's key
# biases (zero gradient up to rounding) to the three steps' largest move,
# 3 lr. The moments are held to 1e-4 relative, with an absolute floor of
# 1e-5 of the leaf's largest value (at least 1e-8).
def assert_states_close(got: dict, want: dict):
    lr = OPT["learning_rate"]
    keys = [k for k in want if k.startswith(("params/", "opt_state/"))
            and not k.endswith("/count")]
    assert keys
    for k in keys:
        g = got[f"state/{k}"]
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if "/mu/" in k or "/nu/" in k:
            floor = 1e-5 * max(1e-3, float(np.max(np.abs(w))))
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=floor,
                                       err_msg=k)
            continue
        if k.endswith("attn/k/bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=3 * lr,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=0.1 * lr, err_msg=k)
        assert float(np.mean(np.abs(g - w) > 2e-6)) <= 1e-3, k


@pytest.mark.parametrize("world,model", CASES, ids=IDS)
def test_fsdp_steps_match_the_reference_on_the_same_mesh(runs, world,
                                                         model):
    """Each rank's per-step loss (1e-5 relative) and grad norm (1e-4
    relative, before the clip, which engages at 1e-3) and the whole
    final state, gathered (see :func:`assert_states_close`), against
    the reference's step on the same mesh shape."""
    ref, _, ranks = runs[world]
    losses, norms, want, _ = ref[model]
    for out in ranks[model]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert min(norms) > OPT["grad_clip_norm"]
        assert_states_close(out, want)


@pytest.mark.parametrize("world,model", CASES, ids=IDS)
def test_fsdp_steps_match_the_replicated_run(runs, world, model):
    """The sharded ranks against the port's replicated run of the same
    global batches on one rank (the same tolerances), and the ranks'
    gathered states against each other, bit for bit."""
    _, rep, ranks = runs[world]
    losses, norms, want = rep[model]
    first = ranks[model][0]
    for out in ranks[model]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        for k, v in out.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("world,model", CASES, ids=IDS)
def test_each_rank_holds_its_shard_of_params_and_moments(runs, world,
                                                         model):
    """Each rank's resident numel of every param and optimizer leaf
    equals the reference's per-device shard; the sharded leaves (the
    largest param and its moments and EMA shadow among them) hold
    1/fsdp of the whole."""
    ref, _, ranks = runs[world]
    _, _, want, numel = ref[model]
    fsdp = MESHES[world]["fsdp"]
    for out in ranks[model]:
        got = {k[len("numel/"):]: int(v) for k, v in out.items()
               if k.startswith("numel/")}
        assert set(got) <= set(numel), sorted(set(got) - set(numel))
        for k, n in got.items():
            assert n == numel[k], (k, n, numel[k])
        big = max((k for k in got if k.startswith("params/")),
                  key=lambda k: np.asarray(want[k]).size)
        whole = np.asarray(want[big]).size
        pkey = big[len("params/"):]
        pieces = [k for k in got
                  if k == big or k.endswith("/" + pkey)]
        assert len(pieces) >= 4, pieces      # param, mu, nu, ema
        for k in pieces:
            assert got[k] * fsdp == whole, (k, got[k], whole)


@pytest.mark.parametrize("name", ["lars", "lamb", "adafactor"])
def test_whole_leaf_optimizers_are_refused_under_fsdp(name):
    """The optimizers whose update reduces over a whole leaf are refused
    under fsdp > 1 naming A6a-2, at construction and, for a transform
    built without that check, at the first update on pieces."""
    cfg = OptimizerConfig(name=name, learning_rate=1e-2, momentum=0.9)
    with pytest.raises(NotImplementedError, match="slice A6a-2"):
        topt.make_optimizer(cfg, fsdp=2)
    tx = topt.make_optimizer(cfg)
    p = [torch.ones(256, 256)]
    state = tx.init(p)
    with topt.shard_reduction([True], lambda t: t):
        with pytest.raises(NotImplementedError, match="slice A6a-2"):
            tx.update([torch.ones(256, 256)], state, p)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_elementwise_optimizers_train_on_pieces(name):
    """Under :func:`shard_reduction` the global norm sums the pieces'
    squares over the shard group (here: doubled, as for two equal
    pieces) and adds the whole leaves' once, and the optimizers that
    train sharded update a piece as they update a whole leaf."""
    cfg = OptimizerConfig(name=name, learning_rate=1e-2, momentum=0.9,
                          grad_clip_norm=1.0, ema_decay=0.5)
    tx = topt.make_optimizer(cfg, fsdp=2)
    rs = np.random.RandomState(0)
    p = [torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
         torch.from_numpy(rs.randn(4).astype(np.float32))]
    g = [torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
         torch.from_numpy(rs.randn(4).astype(np.float32))]
    whole = float(topt.global_norm(g))
    with topt.shard_reduction([True, False], lambda t: 2 * t):
        got = float(topt.global_norm(g))
        upd, _ = tx.update(g, tx.init(p), p)
    want = float(torch.sqrt(2 * (g[0] ** 2).sum() + (g[1] ** 2).sum()))
    assert got == pytest.approx(want, rel=1e-6) and got > whole
    # the clip scales by the reduced norm: an update of the clipped grads
    clipped = [x * (1.0 / got) for x in g]
    plain = topt.make_optimizer(OptimizerConfig(
        name=name, learning_rate=1e-2, momentum=0.9, ema_decay=0.5))
    ref, _ = plain.update(clipped, plain.init(p), p)
    for u, r in zip(upd, ref):
        np.testing.assert_allclose(u.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_cli_refuses_a_whole_leaf_optimizer_under_fsdp(tmp_path):
    """``--optimizer lamb`` over ``--mesh data=1,fsdp=2`` exits naming
    A6a-2 before any work (the worker hosts are never contacted)."""
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="slice A6a-2"):
        tcli.main(["--model", "gpt_tiny", "--device", "cpu",
                   "--optimizer", "lamb", "--mesh", "data=1,fsdp=2",
                   "--worker_hosts", "127.0.0.1:1,127.0.0.1:2",
                   "--ckpt_dir", ck])
    assert not os.path.exists(ck)
