"""The port's GPipe pipeline over gloo ``pipe`` ranks against the JAX
package's ``make_pipeline`` and its pipe_mlp, on the CPU.

One spawn of 4 ranks (``tests/_torch_fsdp_worker.py``, no JAX) runs
``ppermute`` and the sequence-parallel pair forward and backward, the
schedule on stacked residual blocks at ``pipe=4`` with 3 microbatches
and at (data=2, pipe=2) with two blocks a stage and 4 microbatches
(outputs and the gradients of each stage's blocks), pipe_mlp bound to
``pipe=4`` on its stage against the unbound model, 3 AdamW steps of
pipe_mlp at (data=2, pipe=2) and at data=4 from the reference's step-0
state bridged through its npz checkpoint, and ``cli/train.py --model
pipe_mlp --mesh data=-1,pipe=2`` resuming the reference CLI's own step-2
checkpoint. The reference runs its pipeline and its pipe_mlp on as many
devices of the ``cpu8`` mesh, and its CLI on all 8 (data=4, pipe=2:
pipe_mlp's step does not depend on how the batch is split). Tolerances
are stated per test; f32 differences come from summation order only.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import \
    OptimizerConfig as JOptimizerConfig
from distributed_tensorflow_example_tpu.config import TrainConfig as JTrain
from distributed_tensorflow_example_tpu.models import get_model as jget
from distributed_tensorflow_example_tpu.parallel import pipeline as jpipe
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu.utils.pytree import path_str
from distributed_tensorflow_example_tpu_torch.config import (MeshShape,
                                                             TrainConfig)
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.pipe_mlp import (
    PipeMlp, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel import pipeline
from distributed_tensorflow_example_tpu_torch.parallel.mesh import (
    Mesh, mesh_sizes)
from test_torch_fsdp import (OPT, STEPS, assert_states_close,
                             global_batches, load, run_ranks, shared_once)
from test_torch_ring_attention import _free_ports

torch.set_num_threads(1)

WORLD = 4
#: the schedule's cases: (mesh, blocks, hidden, rows, microbatches)
PIPE_CASES = {"pipe4": (dict(pipe=4), 4, 16, 24, 3),
              "data2-pipe2": (dict(data=2, pipe=2), 4, 8, 8, 4)}
TRAIN_MESHES = {"data2-pipe2": dict(data=2, pipe=2), "data4": dict(data=4)}
CLI = ["--model", "pipe_mlp", "--batch_size", "64", "--learning_rate",
       "0.1", "--mesh", "data=-1,pipe=2", "--save_steps", "2",
       "--log_every_steps", "2"]


def _stage(stacked, x, mb_idx=0):
    """The reference test's residual blocks (``tests/test_pipeline.py``)."""
    def body(h, blk):
        return h + jax.nn.relu(h @ blk["kernel"] + blk["bias"]), None
    return jax.lax.scan(body, x, stacked)[0]


def _tstage(stacked, x, mb_idx=0):
    h = x
    for i in range(stacked["kernel"].shape[0]):
        h = h + torch.relu(h @ stacked["kernel"][i] + stacked["bias"][i])
    return h


def pipe_inputs() -> dict:
    out = {}
    for seed, (name, (_, L, H, B, _)) in enumerate(PIPE_CASES.items()):
        rs = np.random.RandomState(seed)
        out[f"{name}/kernel"] = (rs.randn(L, H, H) * 0.3).astype(np.float32)
        out[f"{name}/bias"] = (rs.randn(L, H) * 0.1).astype(np.float32)
        out[f"{name}/x"] = rs.randn(B, H).astype(np.float32)
    return out


def _reference_pipeline(x: dict) -> dict:
    out = {}
    for name, (mesh, _, _, _, m) in PIPE_CASES.items():
        shape = JMesh(**mesh)
        jm = jbuild_mesh(shape, devices=jax.devices("cpu")[:shape.total()])
        params = {k: jnp.asarray(x[f"{name}/{k}"]) for k in ("kernel",
                                                             "bias")}
        piped = jpipe.make_pipeline(jm, _stage, num_microbatches=m)

        def loss(p, piped=piped, name=name):
            y = piped(p, x[f"{name}/x"])
            return jnp.sum(jnp.square(y)), y

        grads, y = jax.jit(jax.grad(loss, has_aux=True))(params)
        out[f"{name}/out"] = np.asarray(y)
        for k, g in grads.items():
            out[f"{name}/d{k}"] = np.asarray(g)
    return out


def pipe_reference_run(name: str, mesh: dict, bridge: str | None,
                       steps: int = STEPS, batches=None):
    """The reference's ``steps`` AdamW steps (``OPT``) of a pipe model
    (bound to the mesh, dropout off) on as many cpu8 devices, writing its
    step-0 state to ``bridge`` (unless None): (losses, grad norms, the
    final state's flat arrays, each leaf's per-device shard numel)."""
    shape = JMesh(**mesh)
    jm = jget(name, JTrain(model=name))
    if hasattr(jm.cfg, "dropout"):
        jm.cfg.dropout = 0.0
    devmesh = jbuild_mesh(shape, devices=jax.devices("cpu")[:shape.total()])
    jm.bind_mesh(devmesh)
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)), devmesh,
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=0)
    if bridge:
        jckpt.CheckpointManager(bridge).save(js, 0)
    numel = {path_str(p): int(x.addressable_shards[0].data.size)
             for p, x in jax.tree_util.tree_flatten_with_path(js)[0]
             if isinstance(x, jax.Array)
             and not jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)}
    losses, norms = [], []
    kind = "mlp" if name == "pipe_mlp" else "bert_tiny"
    for b in (batches or global_batches(kind))[:steps]:
        js, met = jsync.step(js, jsync.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, jckpt._flatten(js), numel


#: the differentiable collectives over pipe=4: (fn, kwargs, each
#: member's input shape, its cotangent's shape); the reference's lax ops
#: are in :func:`_reference_vjp`
VJP_CASES = {
    "ppermute-chain": ("ppermute", {"perm": [[0, 1], [1, 2], [2, 3]]},
                       (2, 8, 3), (2, 8, 3)),
    "ppermute-partial": ("ppermute", {"perm": [[0, 2], [3, 1]]},
                         (2, 8, 3), (2, 8, 3)),
    "sp_all_gather": ("sp_all_gather", {"dim": 1}, (2, 8, 3), (2, 32, 3)),
    "sp_reduce_scatter": ("sp_reduce_scatter", {"dim": 1}, (2, 8, 3),
                          (2, 2, 3)),
}


def vjp_inputs() -> dict:
    rs = np.random.RandomState(5)
    out = {}
    for name, (_, _, x, c) in VJP_CASES.items():
        out[f"in/{name}"] = rs.randn(WORLD, *x).astype(np.float32)
        out[f"cot/{name}"] = rs.randn(WORLD, *c).astype(np.float32)
    return out


def _reference_vjp(x: dict) -> dict:
    """Each case's lax op under the reference's ``shard_map`` over a
    pipe=4 mesh, and its VJP (JAX's transpose of the op)."""
    from jax import lax
    from jax.sharding import PartitionSpec as JP
    from distributed_tensorflow_example_tpu.parallel.collectives import \
        shard_map
    mesh = jbuild_mesh(JMesh(pipe=4), devices=jax.devices("cpu")[:4])
    ops = {"ppermute": lambda a, kw: lax.ppermute(
               a, "pipe", [tuple(p) for p in kw["perm"]]),
           "sp_all_gather": lambda a, kw: lax.all_gather(
               a, "pipe", axis=kw["dim"], tiled=True),
           "sp_reduce_scatter": lambda a, kw: lax.psum_scatter(
               a, "pipe", scatter_dimension=kw["dim"], tiled=True)}
    out = {}
    for name, (fn, kw, _, _) in VJP_CASES.items():
        body = shard_map(
            lambda a, fn=fn, kw=kw: ops[fn](a[0], kw)[None], mesh=mesh,
            in_specs=JP("pipe"), out_specs=JP("pipe"), check_vma=False)
        y, back = jax.vjp(body, jnp.asarray(x[f"in/{name}"]))
        out[f"out/{name}"] = np.asarray(y)
        out[f"grad/{name}"] = np.asarray(back(jnp.asarray(
            x[f"cot/{name}"]))[0])
    return out


def _build(tmp):
    """The inputs, the reference's step-0 state and its CLI's step-2
    checkpoint, then the ranks in the background while the reference
    computes the rest."""
    x = pipe_inputs()
    np.savez(tmp / "pipe.npz", **x)
    v = vjp_inputs()
    np.savez(tmp / "vjp.npz", **v)
    bridge = str(tmp / "bridge")
    pipe_reference_run("pipe_mlp", TRAIN_MESHES["data4"], bridge, steps=0)
    with open(tmp / "batches.npz", "wb") as f:
        np.savez(f, **{f"{i}/{k}": v for i, b in
                       enumerate(global_batches("mlp")) for k, v in
                       b.items()})
    np.savez(tmp / "batch.npz", **global_batches("mlp")[0])
    ref_dir, port_dir = tmp / "ref_cli", tmp / "port_cli"
    assert jcli.main(CLI + ["--ckpt_dir", str(ref_dir), "--train_steps",
                            "2"]) == 0
    shutil.copytree(ref_dir, port_dir)
    tasks = [
        {"kind": "pipeline", "name": "pipeline", "inputs": str(tmp /
                                                             "pipe.npz"),
         "cases": [{"name": n, "mesh": c[0], "microbatches": c[4]}
                   for n, c in PIPE_CASES.items()]},
        {"kind": "pipe_loss", "name": "bound", "model": "pipe_mlp",
         "mesh": {"pipe": 4}, "batch": str(tmp / "batch.npz")},
        {"kind": "vjp", "name": "vjp", "mesh": {"pipe": 4},
         "inputs": str(tmp / "vjp.npz"),
         "cases": [{"name": n, "fn": c[0], "axes": "pipe", "kw": c[1]}
                   for n, c in VJP_CASES.items()]}]
    tasks += [{"kind": "train", "name": mname, "model": "pipe_mlp",
               "mesh": mesh, "opt": OPT, "bridge": bridge,
               "batches": str(tmp / "batches.npz"), "steps": STEPS}
              for mname, mesh in TRAIN_MESHES.items()]
    tasks.append({"kind": "cli", "ports": _free_ports(1),
                  "argvs": [CLI + ["--device", "cpu", "--ckpt_dir",
                                   str(port_dir), "--train_steps", "4"]]})
    with ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(run_ranks, WORLD, tasks, tmp)
        ref = {"pipeline": _reference_pipeline(x), "vjp": _reference_vjp(v),
               **{m: pipe_reference_run("pipe_mlp", mesh, None)
                  for m, mesh in TRAIN_MESHES.items()}}
        assert jcli.main(CLI + ["--ckpt_dir", str(ref_dir),
                                "--train_steps", "4"]) == 0
        spawned.result()
    return {"ref": ref, "tmp": tmp, "x": x,
            **{t["name"]: [load(tmp, t["name"], r) for r in range(WORLD)]
               for t in tasks if t["kind"] != "cli"}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "pipeline_runs", _build)


def _stage_index(case: str, rank: int) -> tuple[int, int]:
    """(pipe coordinate, pipe size) of ``rank`` in a case's mesh."""
    sizes = mesh_sizes(PIPE_CASES[case][0], WORLD)
    mesh = Mesh(sizes, rank, WORLD)
    return mesh.coords["pipe"], sizes["pipe"]


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_matches_sequential_and_the_reference(runs, case):
    """Every rank's pipelined output equals the port's sequential oracle
    and the reference's pipeline (1e-6 absolute, rtol 1e-5: the
    reference test's)."""
    x = runs["x"]
    params = {k: torch.from_numpy(x[f"{case}/{k}"]) for k in ("kernel",
                                                            "bias")}
    want = pipeline.sequential_blocks(_tstage, params,
                                      torch.from_numpy(x[f"{case}/x"]))
    for r in range(WORLD):
        got = runs["pipeline"][r][f"{case}/out"]
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, runs["ref"]["pipeline"][
            f"{case}/out"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_gradients_match_sequential_and_the_reference(runs, case):
    """The backward through the hops, the broadcast and the input's sum:
    each stage's block gradients equal its blocks' of the sequential
    oracle and of the reference (rtol 2e-4, atol 1e-5: the reference
    test's)."""
    x = runs["x"]
    params = {k: torch.from_numpy(x[f"{case}/{k}"]).requires_grad_(True)
              for k in ("kernel", "bias")}
    y = pipeline.sequential_blocks(_tstage, params,
                                   torch.from_numpy(x[f"{case}/x"]))
    (y ** 2).sum().backward()
    for r in range(WORLD):
        i, n = _stage_index(case, r)
        for k in ("kernel", "bias"):
            got = runs["pipeline"][r][f"{case}/d{k}"]
            for want in (params[k].grad.numpy(),
                         runs["ref"]["pipeline"][f"{case}/d{k}"]):
                np.testing.assert_allclose(
                    got, np.split(want, n)[i], rtol=2e-4, atol=1e-5,
                    err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("case", list(VJP_CASES))
def test_collectives_and_their_backward_match_jax(runs, case):
    """``ppermute`` (non-circular pairs: a member no pair sends to gets
    zeros; backward the inverse pairs) and the sequence-parallel pair
    (all-gather with a sum-reduce-scatter backward, and the reverse)
    over 4 gloo ranks: each rank's output and input gradient equal the
    reference's lax op and JAX's transpose of it under ``shard_map`` on
    4 devices (1e-6 absolute: sums of four f32 terms)."""
    for r in range(WORLD):
        out = runs["vjp"][r]
        for k in ("out", "grad"):
            np.testing.assert_allclose(out[f"{k}/{case}"],
                                       runs["ref"]["vjp"][f"{k}/{case}"][r],
                                       rtol=0, atol=1e-6, err_msg=k)
    if case == "ppermute-partial":
        # members 0 and 3 receive nothing; 1 gets 3's, 2 gets 0's
        x = runs["vjp"][0]
        assert not np.any(runs["vjp"][0]["out/ppermute-partial"])
        assert not np.any(runs["vjp"][3]["out/ppermute-partial"])
        assert np.any(x["grad/ppermute-partial"])


def test_shard_map_mode_refuses_a_pipelined_model(monkeypatch):
    """The reference's ``shard_map`` step cannot run the pipeline's own
    ``shard_map`` inside it (a ValueError at its first step); the port
    refuses the same pairing when the step is built, and takes a model
    without a pipeline on the same mesh."""
    from distributed_tensorflow_example_tpu_torch.config import (
        OptimizerConfig, SyncConfig)
    from distributed_tensorflow_example_tpu_torch.parallel import \
        sync_replicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    monkeypatch.setattr(sync_replicas.distributed, "process_count",
                        lambda: 2)
    m = PipeMlp()
    tx = make_optimizer(OptimizerConfig(name="sgd", learning_rate=0.1))
    with pytest.raises(ValueError, match="shard_map with pipe=2"):
        sync_replicas.SyncReplicas(m.loss, tx, MeshShape(pipe=2),
                                   sync=SyncConfig(mode="shard_map"),
                                   device="cpu")
    with pytest.raises(ValueError, match="mesh shape"):
        # auto takes the pairing (only the missing second rank stops it)
        sync_replicas.SyncReplicas(m.loss, tx, MeshShape(pipe=2),
                                   device="cpu")


def test_shutdown_forgets_the_meshes_built_over_the_group(tmp_path):
    """Leaving a process group drops the meshes built over it and their
    subgroups: a worker that brought up a group, built meshes, left it
    and ran the CLI (a group of its own) kept the first group's meshes
    alive to the interpreter's exit and aborted there 9 times in 48
    under load (``terminate called without an active exception``); with
    the meshes forgotten, 0 in 88. Checked in a subprocess (a process
    group of one over a ``file://`` rendezvous, twice in a row)."""
    import subprocess
    import sys
    code = f"""
import torch.distributed as dist
from distributed_tensorflow_example_tpu_torch.config import MeshShape
from distributed_tensorflow_example_tpu_torch.parallel import mesh
from distributed_tensorflow_example_tpu_torch.runtime import distributed
import torch
seen = []
for i in range(2):
    dist.init_process_group("gloo", init_method="file://{tmp_path}/rdv%d" % i,
                            rank=0, world_size=1)
    m = mesh.build_mesh(MeshShape())
    assert mesh.build_mesh(MeshShape()) is m and len(mesh._CACHE) == 1
    assert all(x is not m for x in seen)
    seen.append(m)
    distributed.shutdown()
    assert not mesh._CACHE and not mesh._CURRENT
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_pipeline_refuses_what_does_not_split():
    """The reference's errors: no microbatch, a batch or a block count
    that does not split, and a symbolic batch."""
    mesh = Mesh(mesh_sizes(dict(pipe=4), 4), 0, 4)
    with pytest.raises(ValueError, match="num_microbatches must be >= 1"):
        pipeline.make_pipeline(mesh, _tstage, num_microbatches=0)
    stack = {"kernel": torch.zeros(6, 8, 8), "bias": torch.zeros(6, 8)}
    with pytest.raises(ValueError, match="block count 6 not divisible"):
        pipeline.stage_params(stack, mesh)
    piped = pipeline.make_pipeline(mesh, _tstage, num_microbatches=3)
    with pytest.raises(ValueError, match="per-shard batch 10 not divisible"):
        piped(pipeline.stage_params({k: v[:4] for k, v in stack.items()},
                                    mesh), torch.zeros(10, 8))
    with pytest.raises(ValueError, match="batch 10 not divisible"):
        pipeline.sequential_blocks(_tstage, stack, torch.zeros(10, 8),
                                   num_microbatches=4)

    class Symbolic:
        shape = ("b", 8)

    with pytest.raises(TypeError, match="concrete batch size"):
        pipeline.sequential_blocks(_tstage, stack, Symbolic())


def test_pipe_mlp_is_registered_with_the_reference_layout():
    """``pipe_mlp`` builds from the registry; its stacked blocks cross to
    and from the reference's npz keys."""
    m = get_model("pipe_mlp", TrainConfig(model="pipe_mlp"))
    assert isinstance(m, PipeMlp)
    jm = jget("pipe_mlp", JTrain(model="pipe_mlp"))
    jp = jckpt._flatten({"params": jm.init(jax.random.key(0))})
    flat = {k[len("params/"):]: v for k, v in jp.items()}
    params = params_from_numpy(m, flat, device="cpu")
    assert tuple(params["blocks"]["kernel"].shape) == (4, 128, 128)
    back = params_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


def test_pipe_mlp_bound_matches_unbound(runs):
    """pipe_mlp bound to ``pipe=4`` on each rank's stage: its logits and
    loss equal the unbound model's on the whole params (1e-6 absolute),
    and each stage's block gradients equal the unbound model's blocks
    (2e-6), the projections' the whole model's."""
    for r in range(WORLD):
        out = runs["bound"][r]
        np.testing.assert_allclose(out["logits/piped"], out["logits/seq"],
                                   rtol=0, atol=1e-6)
        assert float(out["loss/piped"]) == pytest.approx(
            float(out["loss/seq"]), abs=1e-6)
        keys = [k[len("grad/piped/"):] for k in out
                if k.startswith("grad/piped/")]
        assert len(keys) == 6
        for k in keys:
            np.testing.assert_allclose(out[f"grad/piped/{k}"],
                                       out[f"grad/seq/{k}"], rtol=0,
                                       atol=2e-6, err_msg=k)


@pytest.mark.parametrize("mname", list(TRAIN_MESHES))
def test_pipe_mlp_steps_match_the_reference(runs, mname):
    """3 AdamW steps (the global-norm clip engaged, the EMA on) of
    pipe_mlp from the reference's step-0 state: every rank's losses and
    grad norms equal the reference's on the same mesh (2e-5 relative),
    and its whole final state the reference's
    (``test_torch_fsdp.assert_states_close``)."""
    losses, norms, state, _ = runs["ref"][mname]
    for r in range(WORLD):
        out = runs[mname][r]
        np.testing.assert_allclose(out["loss"], losses, rtol=2e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=2e-5)
        assert_states_close(out, state)


def test_pipelined_steps_equal_pure_data_parallel(runs):
    """(data=2, pipe=2) trains as data=4 does, as the reference's test
    holds for its meshes: losses to 2e-5 relative, and the two runs'
    final states to each other."""
    a, b = runs["data2-pipe2"][0], runs["data4"][0]
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-5)
    assert_states_close(a, {k[len("state/"):]: v for k, v in b.items()
                            if k.startswith("state/")})


def test_each_rank_holds_its_stage_of_the_blocks(runs):
    """At (data=2, pipe=2) a rank holds half of each stacked block leaf
    and of its Adam moments, the reference's per-device shard sizes, and
    the projections whole."""
    numel = runs["ref"]["data2-pipe2"][3]
    out = runs["data2-pipe2"][0]
    for k in ("params/blocks/kernel", "params/blocks/bias",
              "params/in_proj/kernel", "params/out_proj/kernel"):
        assert int(out[f"numel/{k}"]) == numel[k], k
    assert int(out["numel/params/blocks/kernel"]) == 2 * 128 * 128


def test_cli_on_a_data_pipe_mesh_matches_the_reference(runs):
    """``cli/train.py --model pipe_mlp --mesh data=-1,pipe=2`` over 4 gloo
    workers (data=2, pipe=2) resumes the reference CLI's step-2
    checkpoint and writes at step 4 the reference CLI's params (data=4,
    pipe=2 on 8 devices), to 1e-5 of each leaf's largest value."""
    tmp = runs["tmp"]
    with np.load(os.path.join(tmp / "port_cli", "ckpt-4.npz")) as z:
        got = {k: z[k] for k in z.files}
    with np.load(os.path.join(tmp / "ref_cli", "ckpt-4.npz")) as z:
        want = {k: z[k] for k in z.files}
    keys = [k for k in want if k.startswith("params/")]
    assert len(keys) == 6
    for k in keys:
        w = want[k]
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    assert int(got["step"]) == 4
