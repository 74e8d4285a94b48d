"""The port's Megatron tensor parallelism over the ``model`` axis (gloo
ranks on the CPU) against the JAX package's ``SyncReplicas`` on the same
mesh shape, whose GSPMD partitions the same rules.

One spawn of 2 ranks (``tests/_torch_fsdp_worker.py``, no JAX) trains
gpt_tiny, bert_tiny and moe_bert_tiny at ``model=2`` (and with dropout
on), the three whole-leaf optimizers on bert_tiny at ``model=2``, and
runs the vocab-parallel head; one spawn of 4 ranks trains the three
models at (data=2, model=2) and (fsdp=2, model=2). Every run takes 3
steps of the task's optimizer (AdamW with the global-norm clip engaged
and the parameter EMA unless named) from the reference's step-0 state
bridged through its npz checkpoint, on numpy-seeded global batches, with
dropout off unless named. Tolerances are stated per test; f32
differences come from summation order only.

MoE-BERT on a mesh with two batch ranks routes the global batch, as
the reference does (``ops/moe.py``), so its runs there are held to the
reference like the other models'.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import \
    OptimizerConfig as JOptimizerConfig
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.config import (MeshShape,
                                                             OptimizerConfig)
from distributed_tensorflow_example_tpu_torch.ops import losses
from distributed_tensorflow_example_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
    ShardLayout
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from _torch_fsdp_worker import model_of
from test_torch_fsdp import (OPT, STEPS, WHOLE_LEAF, assert_states_close,
                             global_batches, jmodel_of, load, reference_run,
                             replicated_run, run_ranks, shared_once)

torch.set_num_threads(1)

MODELS = ("gpt_tiny", "bert_tiny", "moe_bert_tiny")
MESHES = {"model2": dict(model=2), "data2-model2": dict(data=2, model=2),
          "fsdp2-model2": dict(fsdp=2, model=2)}
DROPOUT = 0.1


def world_of(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def xent_inputs() -> dict:
    """h [2, 8, 32], a 64-row table and bias, labels and weights; two
    exact argmax ties across the two ranks' vocab ranges (rows 5 = 40
    and 10 = 50): token (0, 0)'s label is the lower row of its tie,
    token (0, 1)'s the higher one."""
    rs = np.random.RandomState(7)
    h = rs.randn(2, 8, 32).astype(np.float32)
    table = (0.1 * rs.randn(64, 32)).astype(np.float32)
    table[5] = table[40] = 2.0 * h[0, 0]
    table[10] = table[50] = 2.0 * h[0, 1]
    labels = rs.randint(0, 64, (2, 8)).astype(np.int32)
    labels[0, 0], labels[0, 1] = 5, 50
    w = np.ones((2, 8), np.float32)
    w[1, 5:] = 0.0
    return {"h": h, "table": table,
            "bias": (0.1 * rs.randn(64)).astype(np.float32),
            "labels": labels, "weights": w}


def _train_task(name, model, mesh, tmp, bridge, **kw):
    return {"kind": "train", "name": name, "model": model, "mesh": mesh,
            "opt": kw.pop("opt", OPT), "bridge": bridge,
            "batches": str(tmp / f"batches_{model}.npz"), "steps": STEPS,
            **kw}


def _build_runs(base):
    """The reference's and the port's in-process runs, then both spawns
    at once; each task's rank outputs by name."""
    tmp = {w: base / f"tp{w}" for w in (2, 4)}
    for t in tmp.values():
        t.mkdir()
    root = tmp[2]
    for t in tmp.values():
        for model in MODELS:
            with open(t / f"batches_{model}.npz", "wb") as f:
                np.savez(f, **{f"{i}/{k}": v for i, b in
                               enumerate(global_batches(model))
                               for k, v in b.items()})
    bridges = {m: str(root / f"bridge_{m}") for m in MODELS}
    ref, rep, numel, opt_ref = {}, {}, {}, {}
    # the runs that write the bridges first, then the ranks in the
    # background while the reference takes its other meshes
    for model in MODELS:
        ref[("model2", model)] = reference_run(model, MESHES["model2"],
                                               bridges[model])
    for oname, opt in WHOLE_LEAF.items():
        opt_ref[oname] = reference_run("gpt_tiny", MESHES["model2"],
                                       str(root / f"bridge_opt_{oname}"),
                                       opt)
    # the MLP's bridge is the port's own step-0 state
    bridges["mlp"] = str(root / "bridge_mlp")
    mlp = model_of("mlp")
    tckpt.CheckpointManager(bridges["mlp"]).save(SyncReplicas(
        mlp.loss, topt.make_optimizer(OptimizerConfig(**OPT)),
        device="cpu").init(mlp.init, seed=0), 0)
    with open(root / "batches_mlp.npz", "wb") as f:
        np.savez(f, **{f"{i}/{k}": v for i, b in
                       enumerate(global_batches("mlp")) for k, v in
                       b.items()})
    with open(root / "xent.npz", "wb") as f:
        np.savez(f, **xent_inputs())
    saves = {"model2": str(root / "save_model2"),
             "fsdp2-model2": str(tmp[4] / "save_fsdp2_model2")}
    two = [_train_task(f"model2-{m}", m, MESHES["model2"], root,
                       bridges[m], **({"save": saves["model2"]}
                                      if m == "gpt_tiny" else {}))
           for m in MODELS]
    two += [_train_task(f"dropout-{m}", m, MESHES["model2"], root,
                        bridges[m], dropout=DROPOUT)
            for m in ("gpt_tiny", "bert_tiny")]
    two += [_train_task("shard_map-gpt_tiny", "gpt_tiny", MESHES["model2"],
                        root, bridges["gpt_tiny"],
                        sync={"mode": "shard_map"}),
            _train_task("model2-mlp", "mlp", MESHES["model2"], root,
                        bridges["mlp"])]
    two += [_train_task(f"opt-{o}", "gpt_tiny", MESHES["model2"], root,
                        str(root / f"bridge_opt_{o}"), opt=opt)
            for o, opt in WHOLE_LEAF.items()]
    two += [{"kind": "xent", "name": "xent", "mesh": MESHES["model2"],
             "inputs": str(root / "xent.npz")}]
    four = [_train_task(f"{mn}-{m}", m, MESHES[mn], tmp[4], bridges[m],
                        **({"save": saves[mn]} if mn in saves
                           and m == "gpt_tiny" else {}))
            for mn in ("data2-model2", "fsdp2-model2") for m in MODELS]
    with ThreadPoolExecutor(2) as ex:
        spawned = ex.map(lambda a: run_ranks(*a),
                         [(2, two, tmp[2]), (4, four, tmp[4])])
        for model in MODELS:
            for mname in ("data2-model2", "fsdp2-model2"):
                ref[(mname, model)] = reference_run(model, MESHES[mname],
                                                    None)
            rep[model] = replicated_run(model, bridges[model])
        rep["mlp"] = replicated_run("mlp", bridges["mlp"])
        for model in ("gpt_tiny", "bert_tiny"):
            rep[("dropout", model)] = replicated_run(model, bridges[model],
                                                     DROPOUT)
        list(spawned)
    for key, run in ref.items():
        numel[key] = run[3]
    outs = {t["name"]: [load(tmp[w], t["name"], r) for r in range(w)]
            for w, tasks in ((2, two), (4, four)) for t in tasks
            if t["kind"] != "cli"}
    return {"ref": ref, "rep": rep, "numel": numel, "opt_ref": opt_ref,
            "outs": outs, "saves": saves}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = shared_once(tmp_path_factory, "tp_runs", _build_runs)
    return {**out, "ranks": lambda mname, name: out["outs"][name]}


CASES = [(mn, m) for mn in MESHES for m in MODELS]
IDS = [f"{mn}-{m}" for mn, m in CASES]
REF_CASES = CASES


@pytest.mark.parametrize("mname,model", REF_CASES,
                         ids=[f"{mn}-{m}" for mn, m in REF_CASES])
def test_tp_steps_match_the_reference_on_the_same_mesh(runs, mname, model):
    """Each rank's per-step loss (1e-5 relative) and grad norm (1e-4
    relative, before the clip, which engages at 1e-3) and the whole final
    state, gathered (``test_torch_fsdp.assert_states_close``), against
    the reference's step on the same mesh shape."""
    losses_, norms, want, _ = runs["ref"][(mname, model)]
    for out in runs["ranks"](mname, f"{mname}-{model}"):
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert min(norms) > OPT["grad_clip_norm"]
        assert_states_close(out, want)


@pytest.mark.parametrize("mname,model", CASES, ids=IDS)
def test_tp_steps_match_the_port_on_one_rank(runs, mname, model):
    """The TP ranks against the port's own run of the same global
    batches on one rank with whole params (the same tolerances; MoE-BERT
    routes the global batch on two batch ranks too); and the ranks'
    gathered states against each other, bit for bit."""
    ranks = runs["ranks"](mname, f"{mname}-{model}")
    losses_, norms, want = runs["rep"][model]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        for k, v in out.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


@pytest.mark.parametrize("mname,model", CASES, ids=IDS)
def test_each_rank_holds_the_reference_shard(runs, mname, model):
    """Each rank's resident numel of every param and optimizer leaf
    equals the reference's per-device shard on the same mesh; every
    ``model`` piece (q/k/v, FFN-in and their biases, o, FFN-out, the
    word table, BERT's ``mlm/bias``, the experts' columns) and its
    moments and EMA shadow hold half the whole."""
    numel = runs["numel"][(mname, model)]
    whole = runs["rep"][model][2]
    split = ("attn/q/kernel", "attn/v/bias", "attn/o/kernel",
             "ffn/in/kernel", "ffn/out/kernel")
    for out in runs["ranks"](mname, f"{mname}-{model}"):
        got = {k[len("numel/"):]: int(v) for k, v in out.items()
               if k.startswith("numel/")}
        assert set(got) <= set(numel), sorted(set(got) - set(numel))
        for k, n in got.items():
            assert n == numel[k], (k, n, numel[k])
        table = ("params/wte/table" if model == "gpt_tiny"
                 else "params/embed/word/table")
        pieces = [k for k in got if k.endswith(split) or
                  k.endswith(table[len("params/"):]) or "moe/w_" in k
                  or k.endswith("mlm/bias")]
        assert any("/mu/" in k for k in pieces), pieces
        for k in pieces:
            assert got[k] * 2 == whole[k].size, (k, got[k])


@pytest.mark.parametrize("mname,model", CASES, ids=IDS)
def test_replicated_leaves_stay_bitwise_equal_across_model_ranks(
        runs, mname, model):
    """The leaves each rank holds whole (layernorms, position and type
    tables, the router, biases after a row-parallel product, their
    moments) are bit for bit the same on every rank after 3 steps: the
    conjugate pair keeps their gradients equal across ``model``."""
    ranks = runs["ranks"](mname, f"{mname}-{model}")
    keys = [k for k in ranks[0] if k.startswith("whole/params/")]
    assert any("ln" in k for k in keys) and len(keys) > 8, keys
    for out in ranks[1:]:
        assert sorted(k for k in out if k.startswith("whole/")) == sorted(
            k for k in ranks[0] if k.startswith("whole/"))
        for k in ranks[0]:
            if k.startswith("whole/"):
                np.testing.assert_array_equal(out[k], ranks[0][k],
                                              err_msg=k)


@pytest.mark.parametrize("model", ["gpt_tiny", "bert_tiny"])
def test_tp_with_dropout_equals_the_whole_model(runs, model):
    """With dropout 0.1 the ``model=2`` run draws every mask on a
    full-width activation from the step's key, as the one-rank run
    does: losses, grad norms (1e-5 / 1e-4 relative) and states (the
    fsdp tests' tolerances) equal the port's one-rank run's."""
    losses_, norms, want = runs["rep"][("dropout", model)]
    nodrop = runs["rep"][model][0]
    assert abs(losses_[0] - nodrop[0]) > 1e-3      # dropout is on
    for out in runs["ranks"]("model2", f"dropout-{model}"):
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)


@pytest.mark.parametrize("name", sorted(WHOLE_LEAF))
def test_whole_leaf_optimizers_on_model_pieces_match_the_reference(
        runs, name):
    """LAMB, LARS and adafactor (factored, its block-RMS clip and
    parameter RMS) on gpt_tiny at ``model=2``: the trust ratio and the
    RMS statistics sum their partial sums over each piece's group, and
    adafactor's ``v_row``/``v_col`` stay whole, as the reference keeps
    them. Losses 1e-5, grad norms 1e-4 relative, states as
    ``assert_states_close``."""
    losses_, norms, want, _ = runs["opt_ref"][name]
    for out in runs["ranks"]("model2", f"opt-{name}"):
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        if name == "adafactor":
            numel = runs["opt_ref"][name][3]
            fac = [k[len("numel/"):] for k in out if k.startswith("numel/")
                   and ("/v_row/" in k or "/v_col/" in k)]
            assert any("attn/o/kernel" in k for k in fac), fac
            for k in fac:
                assert int(out[f"numel/{k}"]) == numel[k] == want[k].size, k


def _whole_head(impl: str, with_bias: bool) -> dict:
    x = {k: torch.from_numpy(v) for k, v in xent_inputs().items()}
    h = x["h"].clone().requires_grad_(True)
    table = x["table"].clone().requires_grad_(True)
    bias = x["bias"].clone().requires_grad_(True) if with_bias else None
    loss, acc = losses.lm_head_xent(
        h, table, x["labels"], x["weights"], bias=bias, impl=impl,
        seq_chunk=4 if impl == "chunked" else 0,
        vocab_block=12 if impl == "fused" else 0)
    loss.backward()
    return {"loss": loss.detach().numpy(), "acc": acc.detach().numpy(),
            "dh": h.grad.numpy(), "dtable": table.grad.numpy(),
            "dbias": None if bias is None else bias.grad.numpy()}


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("impl", ["full", "chunked", "fused"])
def test_vocab_parallel_head_equals_the_whole_vocab(runs, impl, with_bias):
    """The vocab-parallel ``lm_head_xent`` on 2 ranks (32 rows each;
    fused in 12-row blocks, so a rank's last block is padded and the
    other rank's labels fall in its padding, chunked in 4-token chunks):
    the loss (1e-6
    relative) and ``dh`` equal the whole-vocab call's on every rank, and
    each rank's table and bias gradients equal their slice of the
    whole's, to 1e-5 relative with an absolute floor of 4e-6 of the
    gradient's largest element: at the two tie tokens the tied rows'
    terms (~0.18 each) cancel, to exactly 0 on the pieces (each rank
    holds one of them) and to f32 noise of up to 5.1e-7 (1.4e-6 of the
    largest element) in the whole-vocab product; the accuracy is
    exact."""
    want = _whole_head(impl, with_bias)
    name = f"{impl}-{'bias' if with_bias else 'nobias'}"

    def close(got, ref, what):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=4e-6 * np.abs(ref).max(),
                                   err_msg=what)

    for r, out in enumerate(runs["ranks"]("model2", "xent")):
        rows = slice(32 * r, 32 * (r + 1))
        np.testing.assert_allclose(out[f"{name}/loss"], want["loss"],
                                   rtol=1e-6)
        assert float(out[f"{name}/acc"]) == float(want["acc"])
        close(out[f"{name}/dh"], want["dh"], "dh")
        close(out[f"{name}/dtable"], want["dtable"][rows], "dtable")
        if with_bias:
            close(out[f"{name}/dbias"], want["dbias"][rows], "dbias")


def test_vocab_parallel_argmax_breaks_a_cross_rank_tie_low(runs):
    """Token (0, 0) ties rows 5 (rank 0) and 40 (rank 1) and is labelled
    5; token (0, 1) ties rows 10 and 50 and is labelled 50. The whole
    vocab's argmax takes the lower row, so the first is a hit and the
    second a miss; every impl on the pieces agrees exactly (the
    accuracy equals the whole call's, and removing the second token's
    weight raises both by the same step)."""
    x = xent_inputs()
    logits = np.einsum("bth,vh->btv", x["h"], x["table"])
    assert logits[0, 0, 5] == logits[0, 0, 40] == logits[0, 0].max()
    assert logits[0, 1, 10] == logits[0, 1, 50] == logits[0, 1].max()
    pred = torch.argmax(torch.from_numpy(logits), dim=-1)
    assert int(pred[0, 0]) == 5 and int(pred[0, 1]) == 10
    hits = (pred.numpy() == x["labels"]).astype(np.float32)
    acc = float((hits * x["weights"]).sum() / x["weights"].sum())
    for out in runs["ranks"]("model2", "xent"):
        for impl in ("full", "chunked", "fused"):
            got = float(out[f"{impl}-nobias/acc"])
            assert abs(got - acc) < 1e-7, (impl, got, acc)


def _half_mesh() -> Mesh:
    return Mesh({"data": 1, "fsdp": 1, "model": 2, "seq": 1, "expert": 1,
                 "pipe": 1}, rank=0, world=2)


def test_split_heads_and_vocab_are_refused_naming_the_leaf():
    """heads % model != 0 (3 heads of 32 over 2 ranks: no kernel takes a
    split head) and vocab % model != 0 (999 words) raise ValueErrors
    naming the leaf, before any step."""
    mesh = _half_mesh()
    m = model_of("gpt_tiny", hidden=96, heads=3)
    with pytest.raises(ValueError, match=r"layer_0/attn/q/kernel.*heads=3"):
        m.bind_mesh(mesh)
    m = model_of("gpt_tiny", vocab_size=999)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"params/wte/table"):
        ShardLayout.for_params(mesh, params,
                               m.sharding_rules(MeshShape(model=2)))
    m = model_of("bert_tiny", vocab_size=999)
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"params/(embed/word/table|"
                                         r"mlm/bias)"):
        ShardLayout.for_params(mesh, params,
                               m.sharding_rules(MeshShape(model=2)))


def test_layers_compute_on_model_pieces(runs):
    """No step gathers a ``model`` piece before the loss: during the
    ``model=2`` steps the attention saw heads / 2 (2 of 4) heads a rank
    and the tied head a vocab piece of 500 rows, and a bound model is
    unbound again after each step (eval sees whole params)."""
    for model in MODELS:
        for out in runs["ranks"]("model2", f"model2-{model}"):
            assert out["seen/heads"].tolist() == [2], model
            assert out["seen/vocab"].tolist() == [500], model
            assert not bool(out["seen/bound_after"]), model


@pytest.mark.parametrize("mname", ["model2", "fsdp2-model2"])
def test_sharded_save_writes_each_piece_once(runs, mname):
    """A sharded save of gpt_tiny after its 3 steps: every leaf's pieces,
    over all shard files, cover it exactly once (the owner of a piece
    sits at coordinate 0 on every axis that does not split it: a
    ``model`` piece is written by the ``fsdp`` 0 ranks only, an ``fsdp``
    piece by the ``model`` 0 ranks only); ``model`` pieces lie in as many
    files as there are ``model`` ranks; each rank restores its pieces
    back bit for bit."""
    d = runs["saves"][mname]
    world = world_of(MESHES[mname])
    metas = {}
    for p in range(world):
        with np.load(os.path.join(d, f"ckpt-3.shard-{p}-of-{world}.npz")) \
                as z:
            metas[p] = json.loads(bytes(z["__shardmeta__"]).decode())
    leaves = {}
    for p, meta in metas.items():
        for key, entry in meta.items():
            for pc in entry["pieces"]:
                leaves.setdefault(key, (entry["shape"], []))[1].append(
                    (p, tuple(pc["start"]), tuple(pc["shape"])))
    assert "params/wte/table" in leaves and "params/wpe/table" in leaves
    for key, (shape, pieces) in leaves.items():
        starts = [st for _, st, _ in pieces]
        assert len(set(starts)) == len(starts), (key, pieces)
        assert sum(int(np.prod(sh)) for _, _, sh in pieces) == int(
            np.prod(shape)), (key, pieces)
    files = {p for p, _, _ in leaves["params/wte/table"][1]}
    assert len(files) == 2, files
    if mname == "fsdp2-model2":
        # (fsdp, model) of rank r: (r // 2, r % 2)
        assert files == {0, 1}                        # fsdp coordinate 0
        assert {p for p, _, _ in leaves["params/wpe/table"][1]} == {0, 2}
    for out in runs["ranks"](mname, f"{mname}-gpt_tiny"):
        assert bool(out["roundtrip"])


@pytest.mark.parametrize("mname", ["model2", "fsdp2-model2"])
def test_tp_checkpoint_restores_onto_one_rank_and_into_the_reference(
        runs, mname):
    """The ranks' sharded checkpoint restores exactly onto world 1 (whole
    params, each leaf assembled from its pieces) and into the
    reference's state on the same mesh shape over as many cpu8
    devices."""
    d = runs["saves"][mname]
    want = runs["ranks"](mname, f"{mname}-gpt_tiny")[0]
    m = model_of("gpt_tiny")
    sync = SyncReplicas(m.loss, topt.make_optimizer(OptimizerConfig(**OPT)),
                        device="cpu")
    back = tckpt.CheckpointManager(d).restore(sync.init(m.init, seed=9))
    assert back.step == STEPS and back.layout is None
    for k, v in tckpt.state_arrays(back).items():
        np.testing.assert_array_equal(v, want[f"state/{k}"], err_msg=k)
    shape = JMesh(**MESHES[mname])
    jm = jmodel_of("gpt_tiny")
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[
            :world_of(MESHES[mname])]),
        rules=jm.sharding_rules(shape), donate=False)
    jback = jckpt.CheckpointManager(d).restore(jsync.init(jm.init, seed=5))
    got = jckpt._flatten(jback)
    assert int(got["step"]) == STEPS
    for k, v in got.items():
        if not k.startswith("__prng"):
            np.testing.assert_array_equal(np.asarray(v), want[f"state/{k}"],
                                          err_msg=k)


def test_shard_map_mode_repeats_the_whole_step_on_model_ranks(runs):
    """``mode="shard_map"`` keeps the params whole and splits the batch
    over (data, fsdp) only, as the reference's ``_shard_map_step`` does:
    at ``model=2`` both ranks run the one-rank step on the whole batch
    (the fsdp tests' tolerances against the port's one-rank run), hold
    every leaf whole, and compute on all heads and the whole vocab."""
    losses_, norms, want = runs["rep"]["gpt_tiny"]
    for out in runs["ranks"]("model2", "shard_map-gpt_tiny"):
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        assert out["seen/heads"].tolist() == [4]
        assert out["seen/vocab"].tolist() == [1000]
        for k, v in out.items():
            if k.startswith("numel/params/"):
                assert int(v) == want[k[len("numel/"):]].size, k


@pytest.mark.parametrize("model", MODELS)
def test_bound_forward_equals_the_whole_model(runs, model):
    """After the ``model=2`` steps each rank's forward bound to the mesh
    (``apply``: TP layers on its pieces, the vocab piece's logits
    gathered whole) equals the unbound forward on the gathered params,
    to 1e-5 of the logits' largest value."""
    for out in runs["ranks"]("model2", f"model2-{model}"):
        want = out["logits/whole"]
        assert out["logits/tp"].shape == want.shape
        np.testing.assert_allclose(out["logits/tp"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_models_without_model_rules_replicate_along_model(runs):
    """The MLP's rules name no ``model`` entry, as in the reference: at
    ``model=2`` both ranks hold it whole and run the one-rank step on
    the whole batch (the fsdp tests' tolerances against the port's
    one-rank run, and bit for bit each other)."""
    losses_, norms, want = runs["rep"]["mlp"]
    ranks = runs["ranks"]("model2", "model2-mlp")
    for out in ranks:
        np.testing.assert_allclose(out["loss"], losses_, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        assert all(k.startswith("whole/") or not k.startswith("numel/")
                   or int(v) == want[k[len("numel/"):]].size
                   for k, v in out.items())
        for k in out:
            if k.startswith("whole/"):
                np.testing.assert_array_equal(out[k], ranks[0][k])


@pytest.mark.parametrize("mname", ["model2", "fsdp2-model2"])
def test_warm_start_reads_a_model_sharded_anchor(runs, mname):
    """A fresh whole gpt_tiny warm-started from the ranks'
    ``ckpt-3.shards.json`` anchor takes every param, each assembled from
    its ``model`` (and ``fsdp``) pieces, bit for bit."""
    from distributed_tensorflow_example_tpu_torch.ckpt.warm_start import \
        warm_start
    want = runs["ranks"](mname, f"{mname}-gpt_tiny")[0]
    m = model_of("gpt_tiny")
    params, report = warm_start(m.init(torch.Generator().manual_seed(4)),
                                os.path.join(runs["saves"][mname],
                                             "ckpt-3.shards.json"))
    flat = tckpt.to_numpy(params)
    assert flat and not report.fresh
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want[f"state/params/{k}"],
                                      err_msg=k)
