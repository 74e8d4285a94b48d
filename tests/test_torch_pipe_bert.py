"""The port's pipe_bert (the encoder's layers stacked into GPipe stages
over ``pipe``, and PP x TP with ``model``) over gloo ranks against the
JAX package's pipe_bert on the same mesh shape, on the CPU.

Three spawns (``tests/_torch_fsdp_worker.py``, no JAX) run at once: 2
ranks train pipe_bert_tiny 3 AdamW steps at ``pipe=2`` and at
``model=2`` from the reference's step-0 state bridged through its npz
checkpoint (dropout off); 2 more run ``cli/train.py --mesh pipe=2
--sharded_save`` 4 steps, resumed to 6, and 6 steps uninterrupted; 4
ranks train at (data=2,
pipe=2) and (pipe=2, model=2), hold the bound model on their pieces to
the unbound one on the whole params with dropout on at (data=2, pipe=2)
and (pipe=2, model=2), and run the CLI at (pipe=2, model=2). The
reference trains pipe_bert_tiny on as many devices of the ``cpu8`` mesh.
The dropout streams of the two packages differ (a stated non-goal), so
runs with dropout on are held within the port (pipelined against
sequential) and runs against the reference have it off. Tolerances are
stated per test.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
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
from distributed_tensorflow_example_tpu_torch.models.pipe_bert import (
    PipeBert, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.mesh import (
    Mesh, mesh_sizes)
from distributed_tensorflow_example_tpu_torch.parallel.ring_attention \
    import make_ring_attention
from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
    ShardLayout
from test_torch_fsdp import (MOMENTS, OPT, _field, global_batches, load,
                             run_ranks, shared_once)
from test_torch_pipeline import pipe_reference_run
from test_torch_ring_attention import _free_ports

torch.set_num_threads(1)

#: the meshes trained against the reference, by world size
MESHES = {"pipe2": dict(pipe=2), "model2": dict(model=2),
          "data2-pipe2": dict(data=2, pipe=2),
          "pipe2-model2": dict(pipe=2, model=2)}
#: the meshes the bound model is held to the unbound one on (dropout on)
BOUND = {"data2-pipe2": dict(data=2, pipe=2),
         "pipe2-model2": dict(pipe=2, model=2)}
DROPOUT = 0.1
CLI = ["--model", "pipe_bert_tiny", "--seq_len", "32", "--batch_size", "8",
       "--optimizer", "adamw", "--learning_rate", "1e-3",
       "--log_every_steps", "2"]
PORT_CLI = CLI + ["--device", "cpu", "--mesh", "pipe=2", "--sharded_save",
                  "--save_steps", "2"]


def assert_states_close(got: dict, want: dict):
    """``test_torch_fsdp.assert_states_close`` with one element of a leaf
    allowed past 2e-6 where 0.1% of the leaf is less than one element
    (each element is still held to a tenth of the lr): the token-type
    table (256 elements) sums the gradients of all the batch's tokens
    into row 0, and a rounding difference in a sum that nearly cancels
    is not scaled down by Adam (the reason that function gives)."""
    lr = OPT["learning_rate"]
    keys = [k for k in want if k.startswith(("params/", "opt_state/"))
            and not k.endswith("/count")]
    assert keys
    for k in keys:
        g, w = got[f"state/{k}"], np.asarray(want[k])
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
        off = int(np.sum(np.abs(g - w) > 2e-6))
        assert off <= max(1, 1e-3 * g.size), (k, off)


def world_of(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def _build(root):
    tmp = {w: root / f"pb{w}" for w in (2, 4)}
    for t in tmp.values():
        t.mkdir()
    batches = global_batches("bert_tiny")
    for t in tmp.values():
        with open(t / "batches.npz", "wb") as f:
            np.savez(f, **{f"{i}/{k}": v for i, b in enumerate(batches)
                           for k, v in b.items()})
        np.savez(t / "batch.npz", **batches[0])
    bridge = str(root / "bridge")
    # the reference's step-0 state first (an init alone), then its runs
    # beside the ranks
    pipe_reference_run("pipe_bert_tiny", MESHES["pipe2"], bridge, steps=0)
    tasks = {2: [], 4: []}
    for mname, mesh in MESHES.items():
        w = world_of(mesh)
        tasks[w].append({"kind": "train", "name": mname,
                         "model": "pipe_bert_tiny", "mesh": mesh,
                         "opt": OPT, "bridge": bridge,
                         "batches": str(tmp[w] / "batches.npz"),
                         "steps": 3})
    for mname, mesh in BOUND.items():
        tasks[4].append({"kind": "pipe_loss", "name": f"bound-{mname}",
                         "model": "pipe_bert_tiny", "mesh": mesh,
                         "dropout": DROPOUT, "seed": 7,
                         "batch": str(tmp[4] / "batch.npz")})
    ports = _free_ports(4)
    cli = root / "cli"
    cli.mkdir()
    # the sharded CLI runs take a spawn of their own, beside the others
    cli_tasks = [{"kind": "cli", "ports": ports[:3], "argvs": [
        PORT_CLI + ["--ckpt_dir", str(cli / "run"), "--train_steps", "4"],
        PORT_CLI + ["--ckpt_dir", str(cli / "run"), "--train_steps", "6"],
        PORT_CLI + ["--ckpt_dir", str(cli / "whole"), "--train_steps",
                    "6"]]}]
    tasks[4].append({"kind": "cli", "ports": ports[3:], "argvs": [
        CLI + ["--device", "cpu", "--mesh", "pipe=2,model=2",
               "--train_steps", "2", "--summary_every_steps", "1",
               "--metrics_path",
               str(root / "pptp.jsonl")]]})
    with ThreadPoolExecutor(3 + len(MESHES)) as ex:
        spawned = ex.map(lambda a: run_ranks(*a),
                         [(2, tasks[2], tmp[2]), (4, tasks[4], tmp[4]),
                          (2, cli_tasks, cli)])
        runs = {m: ex.submit(pipe_reference_run, "pipe_bert_tiny", mesh,
                             None) for m, mesh in MESHES.items()}
        ref = {m: r.result() for m, r in runs.items()}
        list(spawned)
    outs = {t["name"]: [load(tmp[w], t["name"], r) for r in range(w)]
            for w in (2, 4) for t in tasks[w] if t["kind"] != "cli"}
    return {"ref": ref, "outs": outs, "root": root}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "pipe_bert_runs", _build)


def test_registered_and_layers_stacked():
    """pipe_bert_tiny holds its 4 layers stacked under ``layers`` (no
    ``layer_i``), and the reference's npz keys cross both ways."""
    m = get_model("pipe_bert_tiny", TrainConfig(model="pipe_bert_tiny"))
    assert isinstance(m, PipeBert) and m.cfg.layers == 4
    assert m.cfg.microbatches == 4
    params = m.init(0, device="cpu")
    assert "layers" in params and "layer_0" not in params
    assert params["layers"]["attn"]["q"]["kernel"].shape == (4, 128, 128)
    jm = jget("pipe_bert_tiny", JTrain(model="pipe_bert_tiny"))
    flat = {k[len("params/"):]: np.asarray(v) for k, v in jckpt._flatten(
        {"params": jm.init(jax.random.key(0))}).items()}
    back = params_to_numpy(params_from_numpy(m, flat, device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert get_model("pipe_bert", TrainConfig(model="pipe_bert")
                     ).cfg.layers == 12


@pytest.mark.parametrize("mname", list(BOUND))
def test_eval_forward_parity(runs, mname):
    """The bound model's eval forward on each rank's pieces equals the
    unbound model's on the whole params: bit for bit over ``pipe``
    alone, to 2e-5 under PP x TP (its products sum over split
    contractions)."""
    for out in runs["outs"][f"bound-{mname}"]:
        if mname == "data2-pipe2":
            np.testing.assert_array_equal(out["logits/piped"],
                                          out["logits/seq"])
        else:
            np.testing.assert_allclose(out["logits/piped"],
                                       out["logits/seq"], rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("mname", list(BOUND))
def test_loss_and_grads_pipelined_equal_sequential_with_dropout(runs,
                                                                mname):
    """Dropout on (0.1): both paths split the rows into 4 microbatches
    and fold (global layer, microbatch) into each layer's key, so the
    pipelined loss equals the sequential one bit for bit over ``pipe``
    (to 2e-6 relative under PP x TP) and every gradient of this rank's
    pieces equals the sequential model's piece to 1e-6 absolute (the
    backward sums a layer's microbatches and the stages' hops in
    another order than the sequential backward; gradients of order
    1e-2 to 1)."""
    for out in runs["outs"][f"bound-{mname}"]:
        if mname == "data2-pipe2":
            assert float(out["loss/piped"]) == float(out["loss/seq"])
        else:
            assert float(out["loss/piped"]) == pytest.approx(
                float(out["loss/seq"]), rel=2e-6)
        keys = [k[len("grad/piped/"):] for k in out
                if k.startswith("grad/piped/")]
        assert len(keys) == 26
        for k in keys:
            g = out[f"grad/piped/{k}"]
            np.testing.assert_allclose(g, out[f"grad/seq/{k}"], rtol=0,
                                       atol=1e-6 if mname == "data2-pipe2"
                                       else 2e-6, err_msg=k)


@pytest.mark.parametrize("mname", list(MESHES))
def test_steps_match_the_reference_on_the_same_mesh(runs, mname):
    """3 AdamW steps (the global-norm clip engaged, the EMA on; dropout
    off) of pipe_bert_tiny from the reference's step-0 state: every
    rank's losses and grad norms equal the reference's on the same mesh
    (2e-5 relative) and its whole final state the reference's
    (``test_torch_fsdp.assert_states_close``)."""
    losses, norms, state, _ = runs["ref"][mname]
    for out in runs["outs"][mname]:
        np.testing.assert_allclose(out["loss"], losses, rtol=2e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=2e-5)
        assert_states_close(out, state)


@pytest.mark.parametrize("mname", list(MESHES))
def test_each_rank_holds_the_reference_shard(runs, mname):
    """Each stacked leaf's piece here has the size of the reference's
    per-device shard on the same mesh: the stage dim over ``pipe``, the
    kernels over ``model`` too under PP x TP."""
    numel = runs["ref"][mname][3]
    out = runs["outs"][mname][0]
    keys = [k for k in numel if k.startswith("params/")]
    assert keys
    for k in keys:
        assert int(out[f"numel/{k}"]) == numel[k], k
    q = "params/layers/attn/q/kernel"
    full = 4 * 128 * 128
    want = {"pipe2": full // 2, "model2": full // 2,
            "data2-pipe2": full // 2, "pipe2-model2": full // 4}[mname]
    assert int(out[f"numel/{q}"]) == want


def _mesh(sizes: dict) -> Mesh:
    full = mesh_sizes(sizes, world_of(sizes))
    return Mesh(full, 0, world_of(sizes))


def test_bind_mesh_refusals():
    """The reference's ``bind_mesh`` refusals: layers that do not split
    over ``pipe``, and under PP x TP heads or FFN columns that do not
    split over ``model``, and an ``attention_fn``."""
    cfg = TrainConfig(model="pipe_bert_tiny")
    m = get_model("pipe_bert_tiny", cfg)        # 4 layers
    with pytest.raises(ValueError, match="layers=4 not divisible by pipe"):
        m.bind_mesh(_mesh(dict(pipe=8)))
    m.cfg.heads = 6
    with pytest.raises(ValueError, match="heads=6 not divisible by model"):
        m.bind_mesh(_mesh(dict(pipe=2, model=4)))
    m = get_model("pipe_bert_tiny", cfg)
    m.cfg.intermediate = 250
    with pytest.raises(ValueError, match="intermediate=250 not divisible"):
        m.bind_mesh(_mesh(dict(pipe=2, model=4)))
    m = get_model("pipe_bert_tiny", cfg)
    mesh = _mesh(dict(pipe=2, model=2))
    m.attention_fn = make_ring_attention(mesh)
    with pytest.raises(ValueError, match="does not compose with PP×TP"):
        m.bind_mesh(mesh)
    # over pipe alone an attention_fn composes, and None unbinds
    m.bind_mesh(_mesh(dict(pipe=2)))
    assert m._pipe_mesh is not None
    m.bind_mesh(None)
    assert m._pipe_mesh is None and m.tp is None


def test_sharding_rules_cover_all_four_mesh_kinds():
    """The stacked leaves' specs: over ``pipe`` on the stage dim, and
    with ``model`` column and row pieces (also on a pure-TP mesh); the
    embedding and MLM bias take BERT's vocab rules under TP."""
    m = get_model("pipe_bert_tiny", TrainConfig(model="pipe_bert_tiny"))
    params = m.init(0, device="cpu")
    q, o = "layers/attn/q/kernel", "layers/ffn/out/kernel"
    for sizes, want_q, want_o in (
            (dict(pipe=2), ((0, "pipe"),), ((0, "pipe"),)),
            (dict(model=2), ((2, "model"),), ((1, "model"),)),
            (dict(pipe=2, model=2), ((0, "pipe"), (2, "model")),
             ((0, "pipe"), (1, "model")))):
        mesh = _mesh(sizes)
        layout = ShardLayout.for_params(
            mesh, params, m.sharding_rules(MeshShape(**sizes)))
        assert layout.splits[q] == want_q, sizes
        assert layout.splits[o] == want_o, sizes
        assert layout.splits["layers/attn_ln/scale"] == (
            ((0, "pipe"),) if "pipe" in sizes else ())
        tp = "model" in sizes
        assert layout.splits["embed/word/table"] == (
            ((0, "model"),) if tp else ())
    # a piece of a leaf split over two axes is the block at both
    # coordinates; one axis may split one dim only; expert places
    # experts (A6d), seq no parameter
    from distributed_tensorflow_example_tpu_torch.parallel.sharding import P
    mesh = Mesh(mesh_sizes(dict(pipe=2, model=2), 4), 3, 4)
    w = torch.arange(64.0).reshape(4, 4, 4)
    layout = ShardLayout(mesh, {"w": P("pipe", None, "model")},
                         {"w": (4, 4, 4)})
    assert layout.bounds("w") == ((2, 4), (0, 4), (2, 4))
    assert torch.equal(layout.local("w", w), w[2:, :, 2:])
    # rank 3 holds the last block on both axes and writes it (every
    # other axis is of size 1)
    assert layout.size("w") == 4 and layout.owns("w")
    with pytest.raises(NotImplementedError, match="two dims over one"):
        ShardLayout(mesh, {"w": P("pipe", "pipe")}, {"w": (4, 4)})
    layout = ShardLayout(Mesh(mesh_sizes(dict(expert=2), 2), 1, 2),
                         {"w": P("expert")}, {"w": (4,)})
    assert layout.splits["w"] == ((0, "expert"),) and layout.bound
    assert layout.bounds("w") == ((2, 4),)
    with pytest.raises(NotImplementedError, match="only fsdp, model, expert"):
        ShardLayout(Mesh(mesh_sizes(dict(seq=2), 2), 0, 2),
                    {"w": P("seq")}, {"w": (4,)})


def test_cli_sharded_save_resumes_and_restores_into_the_reference(runs):
    """``cli/train.py --model pipe_bert_tiny --mesh pipe=2
    --sharded_save`` over two gloo workers (dropout on): 4 steps, then a
    second run resumes from the step-4 anchor to 6, and its step-6
    checkpoint equals an uninterrupted 6-step run's bit for bit. Each
    rank's shard file holds its stage's half of the stacked leaves, and
    the reference restores the checkpoint onto its own pipe=2 mesh with
    every leaf equal."""
    cli = runs["root"] / "cli"
    names = sorted(os.listdir(cli / "run"))
    assert "ckpt-6.shards.json" in names and "ckpt-4.shards.json" in names
    resumed = CheckpointManager(str(cli / "run")).sharded_arrays(6)
    whole = CheckpointManager(str(cli / "whole")).sharded_arrays(6)
    assert sorted(resumed) == sorted(whole)
    for k in whole:
        np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)
    for r in range(2):
        with np.load(cli / "run" / f"ckpt-6.shard-{r}-of-2.npz") as z:
            assert f"params/layers/attn/q/kernel::{2 * r}_0_0" in z.files
    # the reference's template for the same flags, on its pipe=2 mesh
    args = jcli.build_parser().parse_args(CLI + ["--mesh", "pipe=2"])
    cfg = jcli.config_from_args(args)
    jm = jget("pipe_bert_tiny", cfg)
    shape = JMesh(pipe=2)
    mesh = jbuild_mesh(shape, devices=jax.devices("cpu")[:2])
    jm.bind_mesh(mesh)
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(cfg.optimizer), mesh,
                          rules=jm.sharding_rules(shape), donate=False)
    template = jsync.init(jm.init, seed=3)
    back = jckpt.CheckpointManager(str(cli / "run"), sharded=True).restore(
        template, 6)
    flat = jckpt._flatten(back)
    assert int(flat["step"]) == 6
    for k, v in flat.items():
        if k in whole and not k.startswith("__"):
            np.testing.assert_array_equal(np.asarray(v), whole[k],
                                          err_msg=k)


def test_cli_export_takes_the_static_batch_route(tmp_path):
    """After training, ``--export_dir`` writes pipe_bert's forward as the
    reference's export does: static-batch (the unbound path splits the
    rows into microbatches, so the symbolic-batch trace fails there and
    the port marks it alike), with the reference's input signature, name
    and parameter count; the artifact serves its batch with the logits
    of the model's own forward on the exported params."""
    from distributed_tensorflow_example_tpu import serving as jserving
    from distributed_tensorflow_example_tpu_torch.cli import train as tcli
    from distributed_tensorflow_example_tpu_torch.serving import (
        load_servable, read_meta, static_batch)
    d = str(tmp_path / "export")
    assert tcli.main(CLI + ["--device", "cpu", "--train_steps", "2",
                            "--export_dir", d]) == 0
    meta = read_meta(d)
    assert meta["batch_polymorphic"] is False and static_batch(meta) == 8
    jm = jget("pipe_bert_tiny", JTrain(model="pipe_bert_tiny"))
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
    m = get_model("pipe_bert_tiny", TrainConfig(model="pipe_bert_tiny"))
    with np.load(os.path.join(d, "params.npz")) as z:
        params = params_from_numpy(m, {k: z[k] for k in z.files
                                       if not k.startswith("__crc")},
                                   device="cpu")
    feats = {k: np.asarray(v) for k, v in m.dummy_batch(8).items()
             if k in meta["input_signature"]}
    want = m.apply(params, {}, {k: torch.as_tensor(v)
                                for k, v in feats.items()})[0].numpy()
    np.testing.assert_array_equal(sv(feats), want)


def test_cli_trains_pipe_bert_under_pp_x_tp(runs):
    """``--mesh pipe=2,model=2`` over 4 gloo workers trains 2 steps to a
    finite loss (the metrics file rank 0 writes)."""
    with open(runs["root"] / "pptp.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses and all(np.isfinite(losses))
