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
sizes. The 2-rank spawn also trains gpt_tiny under LAMB, LARS and
adafactor, whose updates reduce over whole leaves. Tolerances are stated
per test; f32 differences come from summation order only.
"""

import fcntl
import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import \
    OptimizerConfig as JOptimizerConfig
from distributed_tensorflow_example_tpu.models.bert import Bert as JBert
from distributed_tensorflow_example_tpu.models.bert import \
    BertConfig as JBertConfig
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.models.moe import MoeBert as JMoeBert
from distributed_tensorflow_example_tpu.models.moe import \
    MoeBertConfig as JMoeBertConfig
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
from _torch_fsdp_worker import BERT_TINY, GPT_TINY, MOE_TINY, model_of

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_fsdp_worker.py")
RANK_TIMEOUT_S = 150
STEPS = 3
OPT = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
           grad_clip_norm=1e-3, ema_decay=0.9)
MESHES = {2: dict(data=1, fsdp=2), 4: dict(data=2, fsdp=2)}
MODELS = ("mlp", "gpt_tiny")
#: the optimizers whose update reduces over whole leaves, at settings
#: that engage each reduction (LAMB's global-norm clip, LARS's trust
#: ratio on the masked leaves, adafactor's factored RMS with its
#: block-RMS clip, parameter RMS and momentum average)
WHOLE_LEAF = {
    "lamb": dict(name="lamb", learning_rate=1e-3, weight_decay=0.01,
                 grad_clip_norm=1e-3),
    "lars": dict(name="lars", learning_rate=1e-3, weight_decay=0.01,
                 momentum=0.9),
    "adafactor": dict(name="adafactor", learning_rate=1e-3, momentum=0.9),
}


class _ArrayFilePickler(pickle.Pickler):
    """Pickles each large array's bytes into the one binary file
    ``blob`` (at a 64-byte boundary) and only its place into the
    stream."""

    def __init__(self, f, blob):
        super().__init__(f)
        self.blob = blob

    def persistent_id(self, obj):
        if type(obj) is not np.ndarray or obj.dtype.kind not in "biufc" \
                or obj.nbytes < 1 << 16:
            return None
        offset = self.blob.seek(0, os.SEEK_END)
        self.blob.write(b"\0" * (-offset % 64))
        offset += -offset % 64
        self.blob.write(np.ascontiguousarray(obj).tobytes())
        return offset, obj.dtype.str, obj.shape


class _ArrayFileUnpickler(pickle.Unpickler):
    """Maps the binary file copy-on-write and returns each large array as
    a view of it: the workers of a run share the pages they read, and
    none holds what its tests never read."""

    def __init__(self, f, blob_path: str):
        super().__init__(f)
        self.blob = (np.memmap(blob_path, dtype=np.uint8, mode="c")
                     if os.path.getsize(blob_path) else None)

    def persistent_load(self, pid):
        offset, dtype, shape = pid
        dt = np.dtype(dtype)
        size = int(np.prod(shape)) * dt.itemsize
        return self.blob[offset:offset + size].view(dt).reshape(shape)


def shared_once(tmp_path_factory, name: str, build):
    """``build(directory)``'s result, computed once for every pytest-xdist
    worker of a run (each worker would otherwise run a module fixture of
    its own): the first worker to take the lock builds it in a fresh
    directory under the run's shared temporary root and pickles it, the
    large arrays' bytes to one file beside it; the others wait on the
    lock and load it, the arrays mapped from that file. A build that raised
    leaves the next caller a fresh directory of its own to build in.
    Without xdist, the run's root."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    done = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            out = pathlib.Path(tempfile.mkdtemp(prefix=f"{name}-", dir=root))
            result = build(out)
            blob = out / "arrays.bin"
            part = f"{done}.{os.getpid()}.tmp"
            with open(part, "wb") as f, open(blob, "wb") as b:
                pickle.dump(str(blob), f)
                _ArrayFilePickler(f, b).dump(result)
            os.replace(part, done)
        with open(done, "rb") as f:
            return _ArrayFileUnpickler(f, pickle.load(f)).load()


def run_ranks(world: int, tasks: list, tmp,
              timeout: float = RANK_TIMEOUT_S) -> None:
    """``world`` worker ranks over a ``file://`` rendezvous, all at once,
    each under its own ``timeout`` (seconds)."""
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
            timeout=timeout)
    with ThreadPoolExecutor(world) as ex:
        outs = list(ex.map(one, range(world)))
    for r in outs:
        assert r.returncode == 0, r.stdout + r.stderr


def load(tmp, name: str, rank: int) -> dict:
    with np.load(tmp / f"{name}.rank{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def global_batches(model: str) -> list[dict]:
    """3 numpy-seeded global batches: 16 MNIST-shaped rows, or 8 token
    rows of 32 whose second and fifth rows end in 6 pad tokens; BERT's
    (``bert_tiny``, ``moe_bert_tiny``) also carry 8 masked positions a
    row, the last two of rows 0 and 3 at weight 0."""
    out = []
    for i in range(STEPS):
        rs = np.random.RandomState(100 + i)
        if model == "mlp":
            out.append({"x": rs.rand(16, 784).astype(np.float32),
                        "y": rs.randint(0, 10, (16,)).astype(np.int32)})
            continue
        ids = rs.randint(0, 1000, (8, 32)).astype(np.int32)
        mask = np.ones_like(ids)
        mask[[1, 4], 26:] = 0
        b = {"input_ids": ids, "attention_mask": mask}
        if model != "gpt_tiny":
            pos = np.stack([np.sort(rs.choice(26, 8, replace=False))
                            for _ in range(8)]).astype(np.int32)
            w = np.ones((8, 8), np.float32)
            w[[0, 3], 6:] = 0.0
            b.update(token_type_ids=np.zeros_like(ids),
                     masked_positions=pos,
                     masked_labels=rs.randint(0, 1000, (8, 8)).astype(
                         np.int32),
                     masked_weights=w)
        out.append(b)
    return out


def jmodel_of(name: str, dropout: float = 0.0):
    """The reference's counterpart of ``_torch_fsdp_worker.model_of``."""
    if name == "mlp":
        return JMLP()
    if name == "gpt_tiny":
        return JGPT(JGPTConfig(**{**GPT_TINY, "dropout": dropout}))
    if name == "bert_tiny":
        return JBert(JBertConfig(**{**BERT_TINY, "dropout": dropout}))
    return JMoeBert(JMoeBertConfig(**{**MOE_TINY, "dropout": dropout}))


def reference_run(model: str, mesh: dict, bridge: str | None,
                  opt: dict = OPT, steps: int = STEPS):
    """The reference's ``steps`` steps on ``mesh`` over as many cpu8
    devices, writing its step-0 state to ``bridge`` (unless None);
    returns (losses, grad norms, the final state's flat arrays, each
    leaf's per-device shard numel)."""
    shape = JMesh(**mesh)
    jm = jmodel_of(model)
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**opt)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:shape.total()]),
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=0)
    if bridge:
        jckpt.CheckpointManager(bridge).save(js, 0)
    numel = {path_str(p): int(x.addressable_shards[0].data.size)
             for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
             if isinstance(x, jax.Array)
             and not jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)}
    losses, norms = [], []
    for b in global_batches(model)[:steps]:
        js, met = jsync.step(js, jsync.shard_batch(
            {k: jax.numpy.asarray(v) for k, v in b.items()}))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, jckpt._flatten(js), numel


def replicated_run(model: str, bridge: str, dropout: float = 0.0):
    """The port's own replicated run (one rank) of the same global
    batches, from the same bridged state."""
    m = model_of(model, dropout)
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
    for name, opt in (WHOLE_LEAF.items() if world == 2 else ()):
        bridge = str(tmp / f"bridge_{name}")
        ref[name] = reference_run("gpt_tiny", MESHES[world], bridge, opt)
        tasks.append({"kind": "train", "name": name, "model": "gpt_tiny",
                      "mesh": MESHES[world], "opt": opt, "bridge": bridge,
                      "batches": str(tmp / "batches_gpt_tiny.npz"),
                      "steps": STEPS})
    return tasks, ref, rep


def _build_runs(root):
    """Both world sizes' ranks spawned at once, after the in-process
    runs they are held to."""
    tmps = {w: root / f"fsdp{w}" for w in MESHES}
    for t in tmps.values():
        t.mkdir()
    prep = {w: _prepare(w, tmps[w]) for w in MESHES}
    with ThreadPoolExecutor(len(MESHES)) as ex:
        list(ex.map(lambda w: run_ranks(w, prep[w][0], tmps[w]), MESHES))
    return {w: (prep[w][1], prep[w][2],
                {t["name"]: [load(tmps[w], t["name"], r) for r in range(w)]
                 for t in prep[w][0]})
            for w in MESHES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "fsdp_runs", _build_runs)


CASES = [(w, m) for w in MESHES for m in MODELS]
IDS = [f"{w}ranks-{m}" for w, m in CASES]


#: the optimizer-state fields held as moments (Adam's, the momentum
#: trace, adafactor's second moments)
MOMENTS = ("mu", "nu", "trace", "v_row", "v_col", "v")


def _field(key: str) -> str | None:
    """An optimizer-state key's field: its first part after
    ``opt_state`` that is not a chain index."""
    parts = key.split("/")
    if parts[0] != "opt_state":
        return None
    return next((p for p in parts[1:] if not p.isdigit()), None)


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
        if _field(k) in MOMENTS:
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
def test_whole_leaf_optimizers_are_refused_under_fsdp(runs, name):
    """Named for the refusal it replaced: the optimizers whose update
    reduces over a whole leaf now train under fsdp > 1. gpt_tiny on 2
    ranks at fsdp=2 under each (LAMB with the global-norm clip engaged,
    LARS's trust ratio on the masked leaves, adafactor factored with its
    block-RMS clip, parameter RMS and momentum) equals the reference's
    step on the same mesh: loss 1e-5, grad norm 1e-4 relative, states as
    :func:`assert_states_close`. adafactor's ``v_row``/``v_col`` stay
    whole on every rank, as the reference's relaxed shardings keep
    them."""
    ref, _, ranks = runs[2]
    losses, norms, want, numel = ref[name]
    for out in ranks[name]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        got = {k[len("numel/"):]: int(v) for k, v in out.items()
               if k.startswith("numel/")}
        for k, n in got.items():
            assert n == numel[k], (k, n, numel[k])
        fac = [k for k in got if _field(k) in ("v_row", "v_col")]
        assert (name != "adafactor") == (not fac), fac
        for k in fac:
            assert got[k] == np.asarray(want[k]).size, k


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_elementwise_optimizers_train_on_pieces(name):
    """Under :func:`shard_reduction` the global norm sums the pieces'
    squares over the shard group (here: doubled, as for two equal
    pieces) and adds the whole leaves' once, and the optimizers that
    train sharded update a piece as they update a whole leaf."""
    cfg = OptimizerConfig(name=name, learning_rate=1e-2, momentum=0.9,
                          grad_clip_norm=1.0, ema_decay=0.5)
    tx = topt.make_optimizer(cfg)
    rs = np.random.RandomState(0)
    p = [torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
         torch.from_numpy(rs.randn(4).astype(np.float32))]
    g = [torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
         torch.from_numpy(rs.randn(4).astype(np.float32))]
    whole = float(topt.global_norm(g))
    # leaf 0 is one of two equal pieces of a [16, 4] leaf
    piece = topt.LeafShard(dim=0, shape=(16, 4), start=0, stop=8,
                           axis="fsdp", sum=lambda t: 2 * t,
                           gather=lambda t, d: torch.cat([t, t], d))
    with topt.shard_reduction([piece, None]):
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
    """Named for the refusal it replaced: ``--optimizer lamb`` trains
    under fsdp now (and the expert axis since A6d), and so does the
    K-step dispatch (A3c-2b): over four worker hosts the argv passes the
    reference's validation and the port's refusals, with its mesh, its
    optimizer and its ``steps_per_loop`` in the TrainConfig (the run is
    not started: the worker hosts are never contacted). The same argv on
    one worker meets the rule of one rank a card before any work."""
    ck = str(tmp_path / "ck")
    argv = ["--model", "gpt_tiny", "--device", "cpu", "--optimizer",
            "lamb", "--mesh", "fsdp=2,expert=2", "--steps_per_loop", "2",
            "--ckpt_dir", ck]
    parser = tcli.build_parser()
    args = parser.parse_args(argv + [
        "--worker_hosts", "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3,"
        "127.0.0.1:4"])
    cfg = tcli._validate_like_the_reference(parser, args)
    tcli.refuse_by_design(args)
    assert (cfg.optimizer.name, cfg.mesh.fsdp, cfg.mesh.expert,
            cfg.steps_per_loop) == ("lamb", 2, 2, 2)
    with pytest.raises(SystemExit, match="one rank a card"):
        tcli.main(argv)
    assert not os.path.exists(ck)
