"""The port's expert parallelism over the ``expert`` axis and its global
MoE routing (gloo ranks on the CPU) against the JAX package's
``moe_ffn``, ``moe_ffn_shard_map`` and ``SyncReplicas`` on the same mesh
shape.

Two spawns run at once (``tests/_torch_fsdp_worker.py``, no JAX). 2
ranks: ``moe_ffn`` at ``data=2`` routing the global batch at a tight
capacity (top-1 and top-2), and moe_bert_tiny 3 steps at ``expert=2``,
at ``data=2`` with capacity factor 1.0, bert_tiny at ``expert=2`` (a
model without expert rules repeats the step) and moe_bert_tiny under
``sync_mode shard_map`` at ``expert=2``. 4 ranks: the differentiable
``all_to_all`` over ``expert=4``, ``moe_ffn_shard_map`` at
``{data:2, expert:2}`` (top-1, top-2, gradients) and at
``{expert:2, model:2}`` (EP x TP, gradients), and moe_bert_tiny 3 steps
at ``{data:2, expert:2}`` (with a sharded save), ``{fsdp:2, expert:2}``
and ``{expert:2, model:2}``. The reference's 8-device compositions
(``{data:2, expert:4}``, ``{data:2, fsdp:2, expert:2}``,
``{data:2, expert:2, model:2}``) are covered by these 4-rank pairs: each
pairs ``expert`` with one other axis on the same code paths. Every train
run starts from the reference's step-0 state bridged through its npz
checkpoint (AdamW with the global-norm clip engaged and the parameter
EMA, dropout off). Tolerances are the reference's own, stated per test.
"""

import json
import os
import pickle
import subprocess
import sys
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
from distributed_tensorflow_example_tpu.models.moe import MoeBert as JMoeBert
from distributed_tensorflow_example_tpu.models.moe import \
    MoeBertConfig as JMoeBertConfig
from distributed_tensorflow_example_tpu.ops import moe as jmoe
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu.utils.pytree import path_str
from distributed_tensorflow_example_tpu_torch.config import MeshShape
from distributed_tensorflow_example_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_example_tpu_torch.parallel.mesh import (
    Mesh, mesh_sizes)
from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
    ShardLayout
from _torch_fsdp_worker import MOE_TINY, model_of
from test_torch_fsdp import (OPT, RANK_TIMEOUT_S, STEPS,
                             assert_states_close, global_batches,
                             jmodel_of, load, reference_run, replicated_run,
                             run_ranks, shared_once)

torch.set_num_threads(1)

#: the moe_bert_tiny step meshes held to the reference, by name
MESHES = {"expert2": dict(expert=2), "data2-expert2": dict(data=2, expert=2),
          "fsdp2-expert2": dict(fsdp=2, expert=2),
          "expert2-model2": dict(expert=2, model=2)}
#: a capacity factor at which moe_bert_tiny drops tokens, so that
#: routing each batch rank's tokens on their own shows
TIGHT = 1.0
#: the MoE FFN cases: (mode, mesh, top_k, capacity factor, batch axes,
#: model axis, x's shape); the params are the reference's init of 4
#: experts at hidden 16, intermediate 32
FFN_CASES = {
    "global-top1": ("global", dict(data=2), 1, TIGHT, (), None, (4, 16, 16)),
    "global-top2": ("global", dict(data=2), 2, TIGHT, (), None, (4, 16, 16)),
    "ep-top1": ("shard_map", dict(data=2, expert=2), 1, 8.0, ("data",),
                None, (4, 16, 16)),
    "ep-top2": ("shard_map", dict(data=2, expert=2), 2, 8.0, ("data",),
                None, (4, 16, 16)),
    "ep-tp": ("shard_map", dict(expert=2, model=2), 1, 8.0, (), "model",
              (2, 16, 16)),
}
#: the differentiable all_to_all over expert=4: (kwargs, each member's
#: input shape)
A2A_CASES = {
    "tiled-0-0": (dict(split_axis=0, concat_axis=0, tiled=True), (8, 3, 2)),
    "tiled-2-1": (dict(split_axis=2, concat_axis=1, tiled=True), (2, 3, 8)),
    "untiled-0-0": (dict(split_axis=0, concat_axis=0, tiled=False),
                    (4, 3, 2)),
}


#: a reference run's time limit in its own interpreter: about 16 s alone,
#: several times that beside the others of the shared build on a loaded
#: host
REFERENCE_TIMEOUT_S = 4 * RANK_TIMEOUT_S

#: runs one reference function in a fresh interpreter (its JAX tracing
#: then holds no GIL the other runs wait on) and pickles its result,
#: arrays as numpy
_REFERENCE_CALL = """
import importlib, json, pickle, sys
spec = json.loads(sys.argv[1])
sys.path[:0] = spec["path"]
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")

def host(v):
    if isinstance(v, dict):
        return {k: host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(host(x) for x in v)
    return np.asarray(v) if isinstance(v, jax.Array) else v

out = getattr(importlib.import_module(spec["module"]), spec["fn"])(
    *spec["args"])
with open(spec["out"], "wb") as f:
    pickle.dump(host(out), f)
"""


def reference_in_process(tmp, module: str, fn: str, *args):
    """``module.fn(*args)`` (JSON arguments) in a subprocess of its own:
    several reference runs then trace and compile side by side."""
    out = tmp / f"ref-{fn}-{abs(hash(json.dumps(args)))}.pkl"
    spec = {"path": [os.path.dirname(os.path.abspath(__file__))],
            "module": module, "fn": fn, "args": list(args),
            "out": str(out)}
    r = subprocess.run([sys.executable, "-c", _REFERENCE_CALL,
                        json.dumps(spec)], capture_output=True, text=True,
                       timeout=REFERENCE_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def world_of(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def ffn_inputs() -> dict:
    rs = np.random.RandomState(11)
    out = {}
    for i, (name, case) in enumerate(FFN_CASES.items()):
        p = jmoe.moe_ffn_init(jax.random.key(i), 4, 16, 32)
        for k, v in jckpt._flatten(p).items():
            out[f"{name}/p/{k}"] = np.asarray(v)
        out[f"{name}/x"] = rs.randn(*case[6]).astype(np.float32)
        out[f"{name}/cot"] = rs.randn(*case[6]).astype(np.float32)
    for name, (_, shape) in A2A_CASES.items():
        out[f"in/{name}"] = rs.randn(4, *shape).astype(np.float32)
    return out


def _jparams(x: dict, name: str):
    return jax.tree_util.tree_map(jnp.asarray, {
        "router": {"kernel": x[f"{name}/p/router/kernel"]},
        **{k: x[f"{name}/p/{k}"] for k in ("w_in", "b_in", "w_out",
                                           "b_out")}})


def _reference_ffn(x: dict) -> dict:
    """Each case's dense ``moe_ffn`` on the whole batch (the function the
    port's ranks compute together), its aux and its gradients."""
    out = {}
    for name, (mode, _, k, cf, _, _, _) in FFN_CASES.items():
        p, xx = _jparams(x, name), jnp.asarray(x[f"{name}/x"])
        cot = jnp.asarray(x[f"{name}/cot"])

        def f(q):
            return jmoe.moe_ffn(q, xx, n_experts=4, top_k=k,
                                capacity_factor=cf)

        def loss(q):
            y, aux = f(q)
            if mode == "global":
                return (jnp.sum(y * cot) + aux["lb_loss"]
                        + aux["z_loss"])
            return jnp.sum(y ** 2) + aux["lb_loss"]

        y, aux = jax.jit(f)(p)
        out[f"{name}/y"] = np.asarray(y)
        for a, v in aux.items():
            out[f"{name}/aux/{a}"] = np.asarray(v)
        for kk, g in jckpt._flatten(jax.jit(jax.grad(loss))(p)).items():
            out[f"{name}/grad/{kk}"] = np.asarray(g)
    return out


def _reference_a2a(x: dict) -> dict:
    """Each case's ``lax.all_to_all`` under the reference's
    ``shard_map`` over expert=4 and its VJP, with the output itself as
    the cotangent's seed (``cot = 2 * y + 1``)."""
    from jax import lax
    from jax.sharding import PartitionSpec as JP
    from distributed_tensorflow_example_tpu.parallel.collectives import \
        shard_map
    mesh = jbuild_mesh(JMesh(expert=4), devices=jax.devices("cpu")[:4])
    out = {}
    for name, (kw, _) in A2A_CASES.items():
        body = shard_map(
            lambda a, kw=kw: lax.all_to_all(a[0], "expert", **kw)[None],
            mesh=mesh, in_specs=JP("expert"), out_specs=JP("expert"),
            check_vma=False)
        y, back = jax.vjp(body, jnp.asarray(x[f"in/{name}"]))
        out[f"out/{name}"] = np.asarray(y)
        out[f"grad/{name}"] = np.asarray(back(2 * y + 1)[0])
    return out


def _reference_tight(bridge_steps_mesh: dict):
    """The reference's moe_bert_tiny at capacity factor ``TIGHT`` on
    ``mesh``, 3 steps (``reference_run`` with that factor)."""
    shape = JMesh(**bridge_steps_mesh)
    jm = JMoeBert(JMoeBertConfig(**{**MOE_TINY, "capacity_factor": TIGHT}))
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:shape.total()]),
        rules=jm.sharding_rules(shape), donate=False)
    js = jsync.init(jm.init, seed=0)
    losses, norms, drops = [], [], []
    for b in global_batches("moe_bert_tiny"):
        js, met = jsync.step(js, jsync.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        drops.append(float(met["dropped_token_fraction"]))
    return losses, norms, jckpt._flatten(js), drops


def _train(name, model, mesh, tmp, bridge, **kw):
    return {"kind": "train", "name": name, "model": model, "mesh": mesh,
            "opt": OPT, "bridge": bridge,
            "batches": str(tmp / f"batches_{model}.npz"), "steps": STEPS,
            **kw}


def _build(root):
    """The reference's runs in subprocesses of their own (started first),
    its step-0 states, the inputs, then both spawns."""
    tmp = {w: root / f"ep{w}" for w in (2, 4)}
    with ThreadPoolExecutor(8) as ex:
        ref = {mn: ex.submit(reference_in_process, root, "test_torch_fsdp",
                             "reference_run", "moe_bert_tiny", mesh, None)
               for mn, mesh in MESHES.items()}
        ref["tight-data2"] = ex.submit(
            reference_in_process, root, "test_torch_expert_parallel",
            "_reference_tight", dict(data=2))
        for t in tmp.values():
            t.mkdir()
            for model in ("moe_bert_tiny", "bert_tiny"):
                with open(t / f"batches_{model}.npz", "wb") as f:
                    np.savez(f, **{f"{i}/{k}": v for i, b in
                                   enumerate(global_batches(model))
                                   for k, v in b.items()})
        x = ffn_inputs()
        for t in tmp.values():
            np.savez(t / "ffn.npz", **x)
        bridge = {m: str(root / f"bridge_{m}") for m in ("moe_bert_tiny",
                                                         "bert_tiny")}
        # the reference's step-0 states (an init alone)
        for m, b in bridge.items():
            reference_run(m, MESHES["expert2"], b, steps=0)
        save = str(tmp[4] / "save")
        two = [{"kind": "moe_ep", "name": "ffn2",
                "inputs": str(tmp[2] / "ffn.npz"),
                "cases": [_ffn_task(n) for n, c in FFN_CASES.items()
                          if world_of(c[1]) == 2]},
               _train("expert2", "moe_bert_tiny", MESHES["expert2"],
                      tmp[2], bridge["moe_bert_tiny"]),
               _train("tight-data2", "moe_bert_tiny", dict(data=2), tmp[2],
                      bridge["moe_bert_tiny"],
                      cfg={"capacity_factor": TIGHT}),
               _train("bert-expert2", "bert_tiny", MESHES["expert2"],
                      tmp[2], bridge["bert_tiny"]),
               _train("shard_map-expert2", "moe_bert_tiny",
                      MESHES["expert2"], tmp[2], bridge["moe_bert_tiny"],
                      sync={"mode": "shard_map"})]
        spawn2 = ex.submit(run_ranks, 2, two, tmp[2])
        four = [{"kind": "vjp", "name": "a2a",
                 "inputs": str(tmp[4] / "a2a.npz"), "mesh": dict(expert=4),
                 "cases": [{"name": n, "fn": "all_to_all", "axes": "expert",
                            "kw": kw} for n, (kw, _) in A2A_CASES.items()]},
                {"kind": "moe_ep", "name": "ffn4",
                 "inputs": str(tmp[4] / "ffn.npz"),
                 "cases": [_ffn_task(n) for n, c in FFN_CASES.items()
                           if world_of(c[1]) == 4]}]
        four += [_train(mn, "moe_bert_tiny", MESHES[mn], tmp[4],
                        bridge["moe_bert_tiny"],
                        **({"save": save} if mn == "data2-expert2" else {}))
                 for mn in ("data2-expert2", "fsdp2-expert2",
                            "expert2-model2")]
        # the all_to_all's inputs with their cotangents, 2 * y + 1 of each
        # member's output, which the worker's vjp task reads as ``cot/``
        a2a = {k: v for k, v in x.items() if k.startswith("in/")}
        ref_a2a = _reference_a2a(a2a)
        for name in A2A_CASES:
            a2a[f"cot/{name}"] = 2 * ref_a2a[f"out/{name}"] + 1
        np.savez(tmp[4] / "a2a.npz", **a2a)
        spawn4 = ex.submit(run_ranks, 4, four, tmp[4])
        ffn = _reference_ffn(x)
        rep = {m: replicated_run(m, b) for m, b in bridge.items()}
        ref = {k: v.result() for k, v in ref.items()}
        spawn2.result()
        spawn4.result()
    outs = {t["name"]: [load(tmp[w], t["name"], r) for r in range(w)]
            for w, tasks in ((2, two), (4, four)) for t in tasks}
    return {"ref": ref, "ffn": ffn, "a2a": ref_a2a, "x": x, "rep": rep,
            "outs": outs, "save": save}


def build_moe_runs(root):
    """This file's runs and ``tests/test_torch_pipe_moe.py``'s, built side
    by side (their spawns and the reference's compiles overlap), keyed
    ``ep`` and ``pipe``."""
    from test_torch_pipe_moe import build_pipe_moe_runs  # imports this file
    for d in ("ep", "pipe"):
        (root / d).mkdir()
    with ThreadPoolExecutor(2) as ex:
        pipe = ex.submit(build_pipe_moe_runs, root / "pipe")
        return {"ep": _build(root / "ep"), "pipe": pipe.result()}


def _ffn_task(name: str) -> dict:
    mode, mesh, k, cf, batch_axes, model_axis, _ = FFN_CASES[name]
    return {"name": name, "mode": mode, "mesh": mesh, "experts": 4,
            "top_k": k, "capacity_factor": cf,
            "batch_axes": list(batch_axes), "model_axis": model_axis}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "moe_runs", build_moe_runs)["ep"]


def _ffn_out(runs, name: str) -> list:
    w = world_of(FFN_CASES[name][1])
    return runs["outs"]["ffn2" if w == 2 else "ffn4"]


@pytest.mark.parametrize("name", ["global-top1", "global-top2"])
def test_global_routing_matches_the_reference_at_data2(runs, name):
    """``moe_ffn`` on each of 2 batch ranks' rows inside the step's
    ``cross_rank_batch_stats`` routes the global batch, as the
    reference's GSPMD ``moe_ffn`` does, at a capacity factor of 1.0 at
    which tokens drop: the ranks' outputs joined equal the reference's
    (rtol 1e-5, atol 1e-6), every aux value (1e-5), and the ranks' summed
    gradients of sum(y * cot) + (lb + z) / 2 the reference's of
    sum(y * cot) + lb + z (rtol 2e-4, atol 1e-5). Routing each rank's
    rows on their own (the port before global routing) misses the
    reference's output by more than that here."""
    ref, ranks = runs["ffn"], _ffn_out(runs, name)
    y = np.concatenate([r[f"{name}/y"] for r in ranks])
    np.testing.assert_allclose(y, ref[f"{name}/y"], rtol=1e-5, atol=1e-6)
    assert float(ref[f"{name}/aux/dropped_fraction"]) > 0.02
    for r in ranks:
        for k in ("lb_loss", "z_loss", "dropped_fraction", "expert_load"):
            np.testing.assert_allclose(r[f"{name}/aux/{k}"],
                                       ref[f"{name}/aux/{k}"], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        keys = [k for k in ref if k.startswith(f"{name}/grad/")]
        assert len(keys) == 5
        for k in keys:
            np.testing.assert_allclose(r[k], ref[k], rtol=2e-4, atol=1e-5,
                                       err_msg=k)
    # the same rows routed rank by rank
    x, k = runs["x"], FFN_CASES[name][2]
    params = {"router": {"kernel": torch.from_numpy(
        x[f"{name}/p/router/kernel"])}, **{
        n: torch.from_numpy(x[f"{name}/p/{n}"])
        for n in ("w_in", "b_in", "w_out", "b_out")}}
    halves = np.split(x[f"{name}/x"], 2)
    local = np.concatenate([tmoe.moe_ffn(
        params, torch.from_numpy(h), n_experts=4, top_k=k,
        capacity_factor=TIGHT)[0].numpy() for h in halves])
    assert np.abs(local - ref[f"{name}/y"]).max() > 1e-3


@pytest.mark.parametrize("name", sorted(A2A_CASES))
def test_all_to_all_and_its_transpose_match_jax(runs, name):
    """The differentiable ``all_to_all`` over ``expert=4`` (tiled on the
    same and on different axes, and untiled on one axis: JAX's own
transpose of an untiled exchange between two axes is shape-inconsistent,
so it has no oracle): each member's output equals
    ``lax.all_to_all``'s under the reference's ``shard_map`` and its
    gradient ``jax.vjp``'s (the exchange with the axes swapped), exactly
    (it moves values)."""
    for r, out in enumerate(runs["outs"]["a2a"]):
        np.testing.assert_array_equal(out[f"out/{name}"],
                                      runs["a2a"][f"out/{name}"][r])
        np.testing.assert_array_equal(out[f"grad/{name}"],
                                      runs["a2a"][f"grad/{name}"][r])


@pytest.mark.parametrize("name", ["ep-top1", "ep-top2", "ep-tp"])
def test_explicit_ep_equals_dense(runs, name):
    """``moe_ffn_shard_map`` (tokens split over ``data`` and ``expert``,
    or over ``expert`` with each expert's columns over ``model``, two
    ``all_to_all``s) returns on every rank the dense ``moe_ffn``'s whole
    output (rtol 1e-5, atol 1e-6) and aux (lb, z and dropped 1e-5,
    ``expert_load`` too where the per-shard capacity divides evenly) at a
    capacity where nothing drops."""
    ref = runs["ffn"]
    for out in _ffn_out(runs, name):
        np.testing.assert_allclose(out[f"{name}/y"], ref[f"{name}/y"],
                                   rtol=1e-5, atol=1e-6)
        for k in ("lb_loss", "z_loss", "dropped_fraction", "expert_load"):
            np.testing.assert_allclose(out[f"{name}/aux/{k}"],
                                       ref[f"{name}/aux/{k}"], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert float(out[f"{name}/aux/dropped_fraction"]) == 0.0


@pytest.mark.parametrize("name", ["ep-top1", "ep-top2", "ep-tp"])
def test_explicit_ep_gradients_equal_dense(runs, name):
    """The gradients of sum(y²) + lb through ``moe_ffn_shard_map`` (both
    ``all_to_all``s, the ``model`` sum and the stats' mean on the
    backward path) equal the dense path's on every rank, every leaf
    whole (rtol 2e-4, atol 1e-5, the reference's)."""
    ref = runs["ffn"]
    keys = [k for k in ref if k.startswith(f"{name}/grad/")]
    assert len(keys) == 5
    for out in _ffn_out(runs, name):
        for k in keys:
            np.testing.assert_allclose(out[k], ref[k], rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def _mesh(sizes: dict, rank: int = 0) -> Mesh:
    n = world_of(sizes)
    return Mesh(mesh_sizes(sizes, n), rank, n)


def test_explicit_ep_refusals():
    """The reference's refusals before any exchange: experts that do not
    split over ``expert``, FFN columns that do not split over
    ``model``; and a ``model_axis`` other than ``model``; MoE-BERT's
    ``bind_mesh`` refuses experts that do not split."""
    params = tmoe.moe_ffn_init(torch.Generator().manual_seed(0), 4, 16, 31)
    x = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.moe_ffn_shard_map(params, x, _mesh(dict(expert=2, model=2)),
                               n_experts=4, batch_axes=(),
                               model_axis="model")
    with pytest.raises(ValueError, match="4 experts not divisible over 3"):
        tmoe.moe_ffn_shard_map(params, x, _mesh(dict(expert=3)),
                               n_experts=4, batch_axes=())
    with pytest.raises(ValueError, match="model_axis"):
        tmoe.moe_ffn_shard_map(params, x, _mesh(dict(expert=2, seq=2)),
                               n_experts=4, batch_axes=(), model_axis="seq")
    m = model_of("moe_bert_tiny", n_experts=3)
    with pytest.raises(ValueError, match="n_experts=3 not divisible"):
        m.bind_mesh(_mesh(dict(expert=2)))


TRAIN_CASES = list(MESHES) + ["tight-data2"]


@pytest.mark.parametrize("mname", TRAIN_CASES)
def test_moe_bert_steps_match_the_reference_on_the_same_mesh(runs, mname):
    """3 AdamW steps of moe_bert_tiny (the clip engaged, the EMA on,
    dropout off): each rank's per-step loss (1e-5 relative) and grad norm
    (1e-4) and its whole final state (``assert_states_close``) against
    the reference's on the same mesh shape: experts over ``expert``, with
    ``data`` or ``fsdp`` (EP x fsdp: the dense leaves over ``fsdp``) or
    ``model`` (EP x TP: ``w_in`` [E/2, H, I/2]); and at ``data=2`` with
    capacity factor 1.0, where tokens drop and only global routing
    meets the reference."""
    losses, norms, want = runs["ref"][mname][:3]
    for out in runs["outs"][mname]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert min(norms) > OPT["grad_clip_norm"]
        assert_states_close(out, want)
    if mname == "tight-data2":
        assert min(runs["ref"][mname][3]) > 0.05


@pytest.mark.parametrize("mname", list(MESHES))
def test_each_rank_holds_the_reference_shard(runs, mname):
    """Each rank's resident numel of every param and optimizer leaf
    equals the reference's per-device shard on the same mesh; the
    experts' kernels and their moments hold half of the whole (a
    quarter under EP x TP)."""
    numel = runs["ref"][mname][3]
    mesh = MESHES[mname]
    whole = 4 * 128 * 256
    for out in runs["outs"][mname]:
        got = {k[len("numel/"):]: int(v) for k, v in out.items()
               if k.startswith("numel/")}
        assert set(got) <= set(numel), sorted(set(got) - set(numel))
        for k, n in got.items():
            assert n == numel[k], (k, n, numel[k])
        div = 4 if "model" in mesh else 2
        for k in ("params/layer_1/moe/w_in", "params/layer_1/moe/w_out"):
            assert got[k] * div == whole, k
        assert any("/mu/" in k and "moe/w_in" in k for k in got)


def test_sharded_save_writes_each_expert_piece_once_and_restores(runs):
    """After the ``{data:2, expert:2}`` steps a sharded save writes each
    expert piece once, by the ``data`` 0 rank of its ``expert``
    coordinate, in the reference's shard files; each rank restores its
    pieces bit for bit, and the reference restores the checkpoint onto
    its own mesh of the same shape with every leaf equal to the ranks'
    gathered state."""
    import json
    d = runs["save"]
    files = {}
    for p in range(4):
        with np.load(os.path.join(d, f"ckpt-{STEPS}.shard-{p}-of-4.npz")) \
                as z:
            files[p] = json.loads(bytes(z["__shardmeta__"]).decode())
    w_in = "params/layer_1/moe/w_in"
    owners = {p for p, meta in files.items() if w_in in meta}
    # (data, expert) of rank r: (r // 2, r % 2)
    assert owners == {0, 1}
    starts = [tuple(pc["start"]) for p in owners
              for pc in files[p][w_in]["pieces"]]
    assert sorted(starts) == [(0, 0, 0), (2, 0, 0)]
    want = runs["outs"]["data2-expert2"][0]
    for out in runs["outs"]["data2-expert2"]:
        assert bool(out["roundtrip"])
    shape = JMesh(data=2, expert=2)
    jm = jmodel_of("moe_bert_tiny")
    jsync = JSyncReplicas(
        jm.loss, jopt.make_optimizer(JOptimizerConfig(**OPT)),
        jbuild_mesh(shape, devices=jax.devices("cpu")[:4]),
        rules=jm.sharding_rules(shape), donate=False)
    back = jckpt.CheckpointManager(d).restore(jsync.init(jm.init, seed=5))
    got = jckpt._flatten(back)
    assert int(got["step"]) == STEPS
    assert "expert" in str(back.params["layer_1"]["moe"]["w_in"].sharding
                           .spec)
    for k, v in got.items():
        if not k.startswith("__prng"):
            np.testing.assert_array_equal(np.asarray(v), want[f"state/{k}"],
                                          err_msg=k)


def test_a_model_without_expert_rules_repeats_the_step(runs):
    """bert_tiny on ``expert=2``: its rules place nothing over
    ``expert``, so both ranks hold every leaf whole and run the one-rank
    step on the same rows, as the reference's does: losses (1e-5), grad
    norms (1e-4) and states against the port's one-rank run from the
    same bridged state, and bit for bit each other."""
    losses, norms, want = runs["rep"]["bert_tiny"]
    ranks = runs["outs"]["bert-expert2"]
    for out in ranks:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        for k, v in out.items():
            if k.startswith("state/"):
                np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


def test_shard_map_mode_keeps_experts_whole_on_expert_ranks(runs):
    """``sync_mode shard_map`` keeps the params whole (the reference's
    ``_shard_map_step``) and splits the batch over (data, fsdp) only: at
    ``expert=2`` both ranks run the one-rank step of moe_bert_tiny on
    the whole batch (losses 1e-5, grad norms 1e-4, states as
    ``assert_states_close``, against the port's one-rank run) and hold
    every expert."""
    losses, norms, want = runs["rep"]["moe_bert_tiny"]
    for out in runs["outs"]["shard_map-expert2"]:
        np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-4)
        assert_states_close(out, want)
        assert int(out["numel/params/layer_1/moe/w_in"]) == 4 * 128 * 256


def test_expert_rules_place_two_axes_on_one_leaf():
    """MoE-BERT's rules under EP x TP split ``w_in`` over ``expert`` (its
    expert dim) and ``model`` (its columns), ``w_out`` over ``expert``
    and its rows; the router and the biases' hidden dims stay whole."""
    m = model_of("moe_bert_tiny")
    params = m.init(0, device="cpu")
    sizes = dict(expert=2, model=2)
    layout = ShardLayout.for_params(_mesh(sizes, 3), params,
                                    m.sharding_rules(MeshShape(**sizes)))
    p = "layer_1/moe/"
    assert layout.splits[p + "w_in"] == ((0, "expert"), (2, "model"))
    assert layout.splits[p + "w_out"] == ((0, "expert"), (1, "model"))
    assert layout.splits[p + "b_out"] == ((0, "expert"),)
    assert layout.splits[p + "router/kernel"] == ()
    assert layout.bounds(p + "w_in") == ((2, 4), (0, 128), (128, 256))
    assert layout.bound and layout.owns(p + "w_in")
