"""The port's pipe_moe_bert (every encoder layer a MoE layer, the stack in
GPipe stages over ``pipe``, the experts over ``expert``: EP x PP) over
gloo ranks against the JAX package's pipe_moe_bert, on the CPU.

Three spawns run at once (``tests/_torch_fsdp_worker.py``, no JAX). 4
ranks: pipe_moe_bert_tiny 3 AdamW steps at ``{pipe:2, expert:2}`` and at
``{data:2, pipe:2}`` from the reference's step-0 state bridged through
its npz checkpoint (dropout off); the bound model on its pieces against
the unbound one on the whole params with the routing losses off; and
the bound model's routing metrics against the unbound model's on the
batch reordered into the same microbatch groups (the reference's
grouping oracle). 2 ranks: the same 3 steps at ``{data:2}``, where the
model is unbound and each batch rank holds its microbatches of the
global batch. 4 ranks: ``cli/train.py --mesh pipe=2,expert=2
--sharded_save`` 4 steps, resumed to 6, and 6 steps uninterrupted. The
reference trains on as many devices of the ``cpu8`` mesh, evaluates the
port CLI's checkpoint through its own CLI, and its unbound model is the
one-rank oracle. The reference's 8-device mesh ``{data:2, pipe:2,
expert:2}`` is covered by the pairs ``{pipe:2, expert:2}`` and
``{data:2, pipe:2}`` here: the stage's explicit EP path with the
token-sharding statistics, and the batch axis in the pipeline with each
data shard's microbatches routed alone.
The two packages' dropout streams differ (a stated non-goal): runs
against the reference have dropout off. Tolerances are the reference's
own, stated per test.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import TrainConfig as JTrain
from distributed_tensorflow_example_tpu.models import get_model as jget
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
    CheckpointManager
from distributed_tensorflow_example_tpu_torch.config import (MeshShape,
                                                             TrainConfig)
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.pipe_moe import (
    PipeMoeBert, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.mesh import (
    Mesh, mesh_sizes)
from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
    ShardLayout
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, unflatten_dict)
from _torch_fsdp_worker import model_of
from test_torch_expert_parallel import build_moe_runs, reference_in_process
from test_torch_fsdp import (OPT, RANK_TIMEOUT_S, global_batches, load,
                             run_ranks, shared_once)
from test_torch_pipe_bert import assert_states_close
from test_torch_pipeline import pipe_reference_run
from test_torch_ring_attention import _free_ports

torch.set_num_threads(1)

MESH = dict(pipe=2, expert=2)
#: the meshes with a batch axis whose steps are held to the reference:
#: the pipeline over ``pipe`` with each data shard's microbatches, and
#: the unbound model with each batch rank's microbatches of the global
#: batch
BATCH_MESHES = {"data2-pipe2": dict(data=2, pipe=2), "data2": dict(data=2)}
NAME = "pipe_moe_bert_tiny"
#: the member-major order that forms the pipelined microbatch groups:
#: each ``expert`` member holds 4 of the 8 rows, microbatch g its g-th
ORDER = [0, 4, 1, 5, 2, 6, 3, 7]
CLI = ["--model", NAME, "--seq_len", "32", "--batch_size", "16",
       "--optimizer", "adamw", "--learning_rate", "1e-3",
       "--log_every_steps", "2", "--moe_capacity_factor", "8"]
PORT_CLI = CLI + ["--device", "cpu", "--mesh", "pipe=2,expert=2",
                  "--sharded_save", "--save_steps", "2"]


def build_pipe_moe_runs(root):
    """The spawns' and the reference's runs (built beside
    ``tests/test_torch_expert_parallel.py``'s, whose fixture starts
    both)."""
    tmp, tmp2, cli = root / "pm4", root / "pm2", root / "cli"
    batches = global_batches("bert_tiny")
    for d in (tmp, tmp2, cli):
        d.mkdir()
        with open(d / "batches.npz", "wb") as f:
            np.savez(f, **{f"{i}/{k}": v for i, b in enumerate(batches)
                           for k, v in b.items()})
    np.savez(tmp / "batch.npz", **batches[0])
    bridge = str(root / "bridge")

    def train(name, mesh, d):
        return {"kind": "train", "name": name, "model": NAME, "mesh": mesh,
                "opt": OPT, "bridge": bridge,
                "batches": str(d / "batches.npz"), "steps": 3}
    two = [train("data2", BATCH_MESHES["data2"], tmp2)]
    tasks = [train("steps", MESH, tmp),
             train("data2-pipe2", BATCH_MESHES["data2-pipe2"], tmp),
             {"kind": "pipe_loss", "name": "bound", "model": NAME,
              "mesh": MESH, "cfg": {"aux_weight": 0.0, "capacity_factor": 8.0},
              "batch": str(tmp / "batch.npz")},
             {"kind": "pipe_groups", "name": "groups", "model": NAME,
              "mesh": MESH, "order": ORDER, "cfg": {"capacity_factor": 8.0},
              "batch": str(tmp / "batch.npz")}]
    ports = _free_ports(3)
    cli_tasks = [{"kind": "cli", "ports": ports, "argvs": [
        PORT_CLI + ["--ckpt_dir", str(cli / "run"), "--train_steps", "4"],
        PORT_CLI + ["--ckpt_dir", str(cli / "run"), "--train_steps", "6"],
        PORT_CLI + ["--ckpt_dir", str(cli / "whole"), "--train_steps",
                    "6"]]}]
    with ThreadPoolExecutor(6) as ex:
        # the reference's runs first (they need no bridge), then the
        # bridge (its step-0 state), then the spawns
        ref = {mn: ex.submit(reference_in_process, root,
                             "test_torch_pipeline", "pipe_reference_run",
                             NAME, mesh, None)
               for mn, mesh in (("steps", MESH), *BATCH_MESHES.items())}
        pipe_reference_run(NAME, MESH, bridge, steps=0)
        spawned = ex.submit(run_ranks, 4, tasks, tmp)
        spawned2 = ex.submit(run_ranks, 2, two, tmp2)
        # three CLI runs one after another on each rank
        cli_run = ex.submit(run_ranks, 4, cli_tasks, cli,
                            3 * RANK_TIMEOUT_S)
        ref = {mn: f.result() for mn, f in ref.items()}
        cli_run.result()
        spawned.result()
        spawned2.result()
    outs = {t["name"]: [load(d, t["name"], r) for r in range(w)]
            for d, w, ts in ((tmp, 4, tasks), (tmp2, 2, two)) for t in ts}
    return {"ref": ref.pop("steps"), "refs": ref, "outs": outs,
            "root": root}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "moe_runs", build_moe_runs)["pipe"]


def test_registered_and_layers_stacked():
    """pipe_moe_bert_tiny holds its 4 MoE layers stacked under
    ``layers`` (``layers/moe/w_in`` [L, E, H, I], no dense FFN, no
    ``layer_i``), and the reference's npz keys cross both ways."""
    m = get_model(NAME, TrainConfig(model=NAME))
    assert isinstance(m, PipeMoeBert) and m.cfg.layers == 4
    assert m.cfg.microbatches == 4 and m.cfg.n_experts == 4
    params = m.init(0, device="cpu")
    assert "layers" in params and "layer_0" not in params
    assert "ffn" not in params["layers"]
    assert params["layers"]["moe"]["w_in"].shape == (4, 4, 128, 256)
    jm = jget(NAME, JTrain(model=NAME))
    flat = {k[len("params/"):]: np.asarray(v) for k, v in jckpt._flatten(
        {"params": jm.init(jax.random.key(0))}).items()}
    back = params_to_numpy(params_from_numpy(m, flat, device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert get_model("pipe_moe_bert", TrainConfig(model="pipe_moe_bert")
                     ).cfg.layers == 12


def test_unbound_model_matches_the_reference():
    """The unbound model (the sequential oracle: all layers in order,
    always 4 microbatches, routing per microbatch) on the reference's
    initial params, f32, the routing losses on: the loss and every
    metric (1e-5) and every gradient (rtol 2e-4, atol 1e-5) equal the
    reference's unbound model's."""
    jm = jget(NAME, JTrain(model=NAME))
    jm.cfg.dropout = 0.0
    jp = jm.init(jax.random.key(3))
    m = model_of(NAME)
    flat = {k[len("params/"):]: np.asarray(v) for k, v in jckpt._flatten(
        {"params": jp}).items()}
    params = params_from_numpy(m, flat, device="cpu")
    batch = global_batches("bert_tiny")[0]
    (jl, (jmet, _)), jg = jax.jit(
        lambda p, b: jax.value_and_grad(jm.loss, has_aux=True)(
            p, {}, b, None))(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten_dict(params).items()}
    loss, (met, _) = m.loss(unflatten_dict(leaves), {},
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(jmet["aux_loss"]) > 0
    jg = {k[len("params/"):]: np.asarray(v) for k, v in jckpt._flatten(
        {"params": jg}).items()}
    assert sorted(jg) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)


def test_bound_forward_loss_and_grads_equal_unbound(runs):
    """At ``{pipe:2, expert:2}`` with the routing losses off (aux weight
    0: what depends on the microbatch grouping drops out), each rank's
    bound model (its stage's layers and experts, its rows split over
    ``expert`` into the pipeline, two ``all_to_all``s a layer) equals the
    unbound model on the whole params: the eval logits and the loss
    (1e-5) and every gradient of its pieces (rtol 2e-4, atol 1e-5, the
    reference's)."""
    for out in runs["outs"]["bound"]:
        np.testing.assert_allclose(out["logits/piped"], out["logits/seq"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(out["loss/piped"]),
                                   float(out["loss/seq"]), rtol=1e-5)
        keys = [k[len("grad/piped/"):] for k in out
                if k.startswith("grad/piped/")]
        assert len(keys) == 27
        for k in keys:
            np.testing.assert_allclose(out[f"grad/piped/{k}"],
                                       out[f"grad/seq/{k}"], rtol=2e-4,
                                       atol=1e-5, err_msg=k)


def test_aux_metrics_match_the_grouping_oracle(runs):
    """The routing statistics are per microbatch group and the lb
    formula is nonlinear: with ``{expert:2}`` splitting the 8 rows 4 and
    4 and microbatch g taking each member's g-th row, the pipelined
    group g is rows {g, 4 + g}; the unbound model on the batch reordered
    member-major forms the same groups, and then lb, z, the dropped
    fraction and the MLM loss agree (rtol 1e-5, atol 1e-6), on every
    rank."""
    for out in runs["outs"]["groups"]:
        for k in ("aux_loss", "router_z_loss", "dropped_token_fraction",
                  "mlm_loss"):
            np.testing.assert_allclose(out[f"piped/{k}"], out[f"seq/{k}"],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert float(out["piped/aux_loss"]) > 0


def test_steps_match_the_reference_on_the_same_mesh(runs):
    """3 AdamW steps (the clip engaged, the EMA on; dropout off) of
    pipe_moe_bert_tiny at ``{pipe:2, expert:2}`` from the reference's
    step-0 state: every rank's losses (1e-5 relative) and grad norms
    (1e-4) equal the reference's on the same mesh, and its whole final
    state the reference's (``test_torch_pipe_bert.assert_states_close``)."""
    losses, norms, state, _ = runs["ref"]
    for out in runs["outs"]["steps"]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, state)


@pytest.mark.parametrize("mname", sorted(BATCH_MESHES))
def test_steps_with_a_batch_axis_match_the_reference(runs, mname):
    """3 AdamW steps of pipe_moe_bert_tiny (dropout off) with the batch
    split over ``data``, against the reference's on the same mesh shape:
    at ``{data:2, pipe:2}`` the pipeline's stage routes each data shard's
    microbatch alone, as the reference's ``shard_map`` body does; at
    ``{data:2}`` the model is unbound and each rank routes its 2 of the
    global batch's 4 microbatches alone, which are the reference's
    microbatches (blocks of the global batch). Every rank's losses (1e-5
    relative) and grad norms (1e-4) and its whole final state
    (``assert_states_close``), with the aux loss in the loss."""
    losses, norms, state, _ = runs["refs"][mname]
    for out in runs["outs"][mname]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, state)


def test_unbound_model_refuses_microbatches_the_batch_ranks_cannot_split(
        monkeypatch):
    """Unbound over 3 batch ranks, the 4 microbatches of the global batch
    do not split evenly over the ranks, and the loss refuses before any
    exchange."""
    from distributed_tensorflow_example_tpu_torch.runtime import distributed
    m = model_of(NAME)
    monkeypatch.setattr(distributed, "batch_ranks",
                        lambda: distributed.BatchRanks(0, 3))
    batch = {k: torch.from_numpy(v)
             for k, v in global_batches("bert_tiny")[0].items()}
    with pytest.raises(ValueError, match="4 microbatches .* split evenly"):
        m.loss(m.init(0, device="cpu"), {}, batch, None)


def test_each_rank_holds_the_reference_shard(runs):
    """Each leaf's piece here has the size of the reference's per-device
    shard on the same mesh: the stacked layers over ``pipe``, the stacked
    experts over ``pipe`` and ``expert``."""
    numel = runs["ref"][3]
    out = runs["outs"]["steps"][0]
    keys = [k for k in numel if k.startswith("params/")]
    assert keys
    for k in keys:
        assert int(out[f"numel/{k}"]) == numel[k], k
    assert int(out["numel/params/layers/moe/w_in"]) == 4 * 4 * 128 * 256 // 4
    assert int(out["numel/params/layers/moe/router/kernel"]) == \
        4 * 128 * 4 // 2


def _mesh(sizes: dict) -> Mesh:
    n = int(np.prod(list(sizes.values())))
    return Mesh(mesh_sizes(sizes, n), 0, n)


def test_refusals():
    """The reference's refusals: a ``model`` axis (no EP x TP x PP),
    experts that do not split over ``expert``, ``--moe_every`` and
    ``--moe_jitter``; and the placement rules: the stacked layers over
    ``pipe``, the stacked experts over ``pipe`` and ``expert``."""
    m = get_model(NAME, TrainConfig(model=NAME))
    with pytest.raises(ValueError, match="model axis"):
        m.bind_mesh(_mesh(dict(pipe=2, model=2)))
    m = get_model(NAME, TrainConfig(model=NAME, moe_experts=3))
    with pytest.raises(ValueError, match="n_experts=3 not divisible"):
        m.bind_mesh(_mesh(dict(pipe=2, expert=2)))
    with pytest.raises(ValueError, match="moe_every"):
        get_model(NAME, TrainConfig(model=NAME, moe_every=2))
    with pytest.raises(ValueError, match="jitter"):
        get_model(NAME, TrainConfig(model=NAME, moe_jitter=0.1))
    # the rules: layers over pipe, experts over pipe and expert
    m = get_model(NAME, TrainConfig(model=NAME))
    params = m.init(0, device="cpu")
    sizes = dict(pipe=2, expert=2)
    layout = ShardLayout.for_params(_mesh(sizes), params,
                                    m.sharding_rules(MeshShape(**sizes)))
    assert layout.splits["layers/moe/w_in"] == ((0, "pipe"), (1, "expert"))
    assert layout.splits["layers/moe/router/kernel"] == ((0, "pipe"),)
    assert layout.splits["embed/word/table"] == ()


def test_cli_sharded_save_resumes_and_restores_into_the_reference(runs):
    """``cli/train.py --mesh pipe=2,expert=2 --sharded_save`` over 4 gloo
    workers (dropout on): 4 steps, then a resumed run to 6, whose step-6
    checkpoint equals an uninterrupted 6-step run's bit for bit. Each
    expert piece lies in the file of its owner (each (pipe, expert)
    block once), and the reference restores the checkpoint onto its own
    ``{pipe:2, expert:2}`` mesh with every leaf equal."""
    cli = runs["root"] / "cli"
    names = sorted(os.listdir(cli / "run"))
    assert "ckpt-6.shards.json" in names and "ckpt-4.shards.json" in names
    resumed = CheckpointManager(str(cli / "run")).sharded_arrays(6)
    whole = CheckpointManager(str(cli / "whole")).sharded_arrays(6)
    assert sorted(resumed) == sorted(whole)
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)
    # rank r is (expert, pipe) = (r // 2, r % 2): its file holds the
    # (pipe, expert) block of the stacked experts
    for r in range(4):
        with np.load(cli / "run" / f"ckpt-6.shard-{r}-of-4.npz") as z:
            key = f"params/layers/moe/w_in::{2 * (r % 2)}_{2 * (r // 2)}_0_0"
            assert key in z.files, z.files
    args = jcli.build_parser().parse_args(CLI + ["--mesh", "pipe=2,expert=2"])
    cfg = jcli.config_from_args(args)
    jm = jget(NAME, cfg)
    shape = JMesh(pipe=2, expert=2)
    mesh = jbuild_mesh(shape, devices=jax.devices("cpu")[:4])
    jm.bind_mesh(mesh)
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(cfg.optimizer), mesh,
                          rules=jm.sharding_rules(shape), donate=False)
    back = jckpt.CheckpointManager(str(cli / "run"), sharded=True).restore(
        jsync.init(jm.init, seed=3), 6)
    flat = jckpt._flatten(back)
    assert int(flat["step"]) == 6
    for k, v in flat.items():
        if k in whole and not k.startswith("__"):
            np.testing.assert_array_equal(np.asarray(v), whole[k],
                                          err_msg=k)


def test_cli_eval_matches_the_references_cli(runs, capsys):
    """``--eval_only`` of the port's CLI (one rank) and of the reference's
    (its own 8-device mesh: ``data=2`` with the same ``pipe`` and
    ``expert``) on the port CLI's step-6 sharded checkpoint print the
    same eval loss and accuracy (1e-5): at capacity factor 8 nothing
    drops, so the two layouts' token groupings compute the same
    function."""
    from distributed_tensorflow_example_tpu_torch.cli import train as tcli
    ck = str(runs["root"] / "cli" / "run")

    def printed(main, extra):
        capsys.readouterr()
        assert main(CLI + ["--ckpt_dir", ck, "--sharded_save",
                           "--eval_only"] + extra) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        return json.loads(lines[-1])

    port = printed(tcli.main, ["--device", "cpu"])
    ref = printed(jcli.main, ["--mesh", "data=-1,pipe=2,expert=2"])
    assert port["step"] == ref["step"] == 6
    keys = [k for k in ref if k != "step"]
    assert "loss" in str(keys), ref
    for k in keys:
        assert k in port, (k, port)
        np.testing.assert_allclose(np.asarray(port[k]), np.asarray(ref[k]),
                                   rtol=1e-5, err_msg=k)


def test_cli_export_takes_the_static_batch_route(tmp_path):
    """After training, ``--export_dir`` writes pipe_moe_bert's forward as
    the reference's export does: static-batch, with the reference's
    input signature, name and parameter count; the artifact serves its
    batch with the logits of the model's own forward on the exported
    params."""
    from distributed_tensorflow_example_tpu import serving as jserving
    from distributed_tensorflow_example_tpu_torch.cli import train as tcli
    from distributed_tensorflow_example_tpu_torch.serving import (
        load_servable, read_meta, static_batch)
    d = str(tmp_path / "export")
    assert tcli.main(CLI + ["--device", "cpu", "--train_steps", "2",
                            "--export_dir", d]) == 0
    meta = read_meta(d)
    assert meta["batch_polymorphic"] is False and static_batch(meta) == 8
    jm = jget(NAME, JTrain(model=NAME))
    jd = str(tmp_path / "ref")
    jserving.export_model(jm, jm.init(jax.random.key(0)), {}, jd,
                          platforms=("cpu",))
    with open(os.path.join(jd, "export.json")) as f:
        jmeta = json.load(f)
    assert jmeta["batch_polymorphic"] is False
    for key in ("model", "input_signature", "param_count",
                "batch_polymorphic"):
        assert meta[key] == jmeta[key], key
    sv = load_servable(d, device="cpu")
    m = get_model(NAME, TrainConfig(model=NAME, moe_capacity_factor=8.0))
    with np.load(os.path.join(d, "params.npz")) as z:
        params = params_from_numpy(m, {k: z[k] for k in z.files
                                       if not k.startswith("__crc")},
                                   device="cpu")
    feats = {k: np.asarray(v) for k, v in m.dummy_batch(8).items()
             if k in meta["input_signature"]}
    want = m.apply(params, {}, {k: torch.as_tensor(v)
                                for k, v in feats.items()})[0].numpy()
    np.testing.assert_array_equal(sv(feats), want)
