"""One rank of the port's sharded (fsdp) tests (imports no JAX).

    python tests/_torch_fsdp_worker.py --rank R --world W \\
        --init file:///tmp/rdv --tasks TASKS.json --out DIR

Joins a gloo group through ``--init`` and runs the tasks of
``TASKS.json`` in order, each writing ``DIR/<name>.rank<R>.npz``:

- ``collectives``: the eight named collectives over the task's mesh, one
  case each (inputs ``in/<case>`` stacked a rank on dim 0, outputs
  ``out/<case>``);
- ``train``: a model (``mlp``, or ``gpt_tiny``, ``bert_tiny``,
  ``moe_bert_tiny`` or ``pipe_moe_bert_tiny`` dims with dropout off
  unless the task sets ``dropout``, and the task's ``cfg`` overrides) under the task's optimizer on the task's mesh (and its
  ``sync`` settings), restored
  from the monolithic checkpoint in ``bridge`` (the reference's step 0),
  for ``steps`` global batches from ``batches`` (each rank takes its
  share over the batch axes), writing the per-step loss and grad norm,
  the whole final state (gathered), each leaf's resident numel here,
  the leaves this rank holds whole (``whole/``, not gathered), the
  head counts and table rows the layers saw (``seen/``), on a ``model``
  mesh the last batch's logits bound and whole (``logits/``), and, with
  ``save``, a sharded checkpoint, restored again into a fresh template
  (``roundtrip``);
- ``xent``: the vocab-parallel ``lm_head_xent`` on this rank's vocab
  piece of ``inputs`` (h, table, bias, labels, weights), for each impl
  with and without the bias: the loss, the accuracy, ``dh`` and the
  table's and bias's gradients (of the piece);
- ``restore``: the sharded checkpoint at ``dir`` step ``step`` restored
  into this mesh's template of the task's model and optimizer, written
  whole;
- ``vjp``: the differentiable collectives (``ppermute``, the
  sequence-parallel pair) on this rank's ``in/<case>`` of ``inputs``,
  each output and the gradient of its product with ``cot/<case>``;
- ``ring``: ring attention over the task's ``seq`` mesh on the whole
  q, k, v and masks of ``inputs``, each case's output and the gradients
  of q, k and v of a fixed weighting of it;
- ``pipeline``: the task's ``cases`` of the GPipe schedule on the
  stacked residual blocks of ``inputs`` against the sequential oracle,
  outputs and gradients (of this rank's stage);
- ``pipe_loss``: a pipe model's loss and gradients bound to the mesh on
  this rank's pieces against the unbound model on the whole params, on
  this rank's rows of ``batch``, with dropout as the task sets it;
- ``bert_ring``: bert_tiny's (and gpt_tiny's, causal) loss and
  gradients on this rank's rows of ``batch`` with ring attention over
  ``seq`` and without, from the flat params in ``params`` (and
  ``gpt_params``);
- ``moe_ep``: the task's ``cases`` of a MoE FFN on the params, ``x`` and
  ``cot`` of ``inputs``: ``shard_map`` runs ``moe_ffn_shard_map`` over
  the case's mesh on the whole params and ``x`` (the output, the aux and
  the gradients of sum(y²) + lb); ``global`` runs ``moe_ffn`` on this
  batch rank's rows routed over the batch ranks that
  ``cross_rank_batch_stats`` names (``batch_ranks``; its output, the
  aux and the ranks' sum of the gradients of sum(y * cot) + (lb + z)/n,
  which is the one-rank loss's gradient);
- ``pipe_groups``: pipe_moe_bert_tiny's loss metrics bound to the mesh
  on this rank's pieces and rows of ``batch``, and the unbound model's on
  the whole params and the rows reordered by ``order``;
- ``multi``: the task's model (dropout as the task sets it) from the
  seed-0 init on the task's mesh, trained on this rank's rows of the K
  global batches stacked in ``batches`` (``[K, B, ...]``) twice: K
  ``step`` calls, and one ``multi_step`` call on the stack; each run's
  whole final state (gathered), step and last metrics;
- ``cli``: after the other tasks the group is left and ``cli/train.py``
  runs once per argv (each brings its own group up at worker 0's
  address), with ``--worker_hosts`` and ``--task_index`` added.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from distributed_tensorflow_example_tpu_torch.ckpt import \
    checkpoint as tckpt  # noqa: E402
from distributed_tensorflow_example_tpu_torch.config import (  # noqa: E402
    MeshShape, OptimizerConfig, SyncConfig)
from distributed_tensorflow_example_tpu_torch.models.bert import (  # noqa: E402,E501
    Bert, BertConfig)
from distributed_tensorflow_example_tpu_torch.models.gpt import (  # noqa: E402,E501
    GPT, GPTConfig)
from distributed_tensorflow_example_tpu_torch.models.moe import (  # noqa: E402,E501
    MoeBert, MoeBertConfig)
from distributed_tensorflow_example_tpu_torch.models.mlp import \
    MLP  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models.pipe_bert import (  # noqa: E402,E501
    PipeBert, PipeBertConfig)
from distributed_tensorflow_example_tpu_torch.models.pipe_mlp import \
    PipeMlp  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models.pipe_moe import (  # noqa: E402,E501
    PipeMoeBert, PipeMoeBertConfig)
from distributed_tensorflow_example_tpu_torch.parallel import \
    collectives as C  # noqa: E402
from distributed_tensorflow_example_tpu_torch.parallel.mesh import \
    build_mesh  # noqa: E402
from distributed_tensorflow_example_tpu_torch.ops import \
    losses  # noqa: E402
from distributed_tensorflow_example_tpu_torch.parallel import \
    tensor_parallel  # noqa: E402
from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
    shard_batch  # noqa: E402
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime import \
    distributed  # noqa: E402
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer  # noqa: E402
from distributed_tensorflow_example_tpu_torch.utils.pytree import (  # noqa: E402,E501
    flatten_dict, unflatten_dict)

torch.set_num_threads(1)

#: gpt_tiny's dims (``GPTConfig.tiny``) with dropout off
GPT_TINY = dict(vocab_size=1000, hidden=128, layers=2, heads=4,
                intermediate=256, max_len=128, dropout=0.0)


#: bert_tiny's and moe_bert_tiny's dims (``BertConfig.tiny``,
#: ``MoeBertConfig.tiny``) with dropout off
BERT_TINY = dict(vocab_size=1000, hidden=128, layers=2, heads=4,
                 intermediate=256, max_len=128, max_predictions=8,
                 dropout=0.0)
MOE_TINY = dict(BERT_TINY, n_experts=4, capacity_factor=2.0)


def model_of(name: str, dropout: float = 0.0, **cfg):
    """The test models by name; ``cfg`` overrides their config."""
    if name == "mlp":
        return MLP()
    if name == "pipe_mlp":
        return PipeMlp()
    if name == "pipe_bert_tiny":
        return PipeBert(PipeBertConfig(**{**BERT_TINY, "layers": 4,
                                          "dropout": dropout, **cfg}))
    if name == "pipe_moe_bert_tiny":
        return PipeMoeBert(PipeMoeBertConfig(**{
            **MOE_TINY, "layers": 4, "dropout": dropout, **cfg}))
    if name == "gpt_tiny":
        return GPT(GPTConfig(**{**GPT_TINY, "dropout": dropout, **cfg}))
    if name == "bert_tiny":
        return Bert(BertConfig(**{**BERT_TINY, "dropout": dropout, **cfg}))
    return MoeBert(MoeBertConfig(**{**MOE_TINY, "dropout": dropout, **cfg}))


def _collectives(task, rank):
    mesh = build_mesh(MeshShape(**task["mesh"]))
    with np.load(task["inputs"]) as z:
        ins = {k: torch.from_numpy(z[k][rank]) for k in z.files}
    out = {}
    for case in task["cases"]:
        name, fn, axes = case["name"], case["fn"], case["axes"]
        axes = tuple(axes) if isinstance(axes, list) else axes
        x = ins[case["input"]]
        if fn == "axis_size":
            y = torch.tensor(C.axis_size(axes, mesh=mesh), dtype=x.dtype)
        else:
            y = getattr(C, fn)(x, axes, mesh=mesh, **case["kw"])
        out[f"out/{name}"] = y.numpy()
    return out


def _sync(task, mesh):
    model = model_of(task["model"], task.get("dropout", 0.0),
                     **task.get("cfg", {}))
    tx = make_optimizer(OptimizerConfig(**task["opt"]))
    return model, SyncReplicas(model.loss, tx, mesh, device="cpu",
                               sync=SyncConfig(**task.get("sync", {})),
                               rules=model.sharding_rules(mesh))


def _whole(state) -> dict:
    """The state's whole arrays (gathered; every rank calls it)."""
    return {f"state/{k}": v for k, v in tckpt.state_arrays(state).items()}


def _spy(seen: dict):
    """Record the head count each attention call sees and the table rows
    each LM head gets (the pieces the layers compute on)."""
    from distributed_tensorflow_example_tpu_torch.models import bert, gpt
    attn, head = gpt.multi_head_attention, losses.lm_head_xent

    def attention(q, *a, **kw):
        seen.setdefault("heads", set()).add(q.shape[2])
        return attn(q, *a, **kw)

    def lm_head(h, table, *a, **kw):
        seen.setdefault("vocab", set()).add(table.shape[0])
        return head(h, table, *a, **kw)

    gpt.multi_head_attention = bert.multi_head_attention = attention
    losses.lm_head_xent = lm_head
    return lambda: (setattr(gpt, "multi_head_attention", attn),
                    setattr(bert, "multi_head_attention", attn),
                    setattr(losses, "lm_head_xent", head))


def _bound_logits(model, sync, state, batch) -> dict:
    """The forward's logits (``apply``) of the model bound to the mesh on
    this rank's pieces (the vocab-parallel head's, gathered) and of the
    unbound model on the gathered whole params."""
    whole = sync.full_params(state)
    pieces = state.layout.step_params(state.params)
    with torch.no_grad():
        want = model.apply(whole, state.extras, batch)[0]
        model.bind_mesh(sync.mesh)
        try:
            got = model.apply(pieces, state.extras, batch)[0]
        finally:
            model.bind_mesh(None)
    return {"logits/tp": got.numpy(), "logits/whole": want.numpy()}


def _train(task, rank):
    mesh = MeshShape(**task["mesh"])
    model, sync = _sync(task, mesh)
    seen: dict = {}
    undo = _spy(seen)
    state, restored = tckpt.restore_or_init(
        tckpt.CheckpointManager(task["bridge"]),
        lambda: sync.init(model.init, seed=0))
    assert restored, "the bridged step-0 checkpoint must restore"
    losses_, norms = [], []
    with np.load(task["batches"]) as z:
        keys = sorted({k.split("/", 1)[1] for k in z.files})
        for i in range(task["steps"]):
            batch = {k: z[f"{i}/{k}"] for k in keys}
            state, met = sync.step(state, shard_batch(sync.mesh, batch))
            losses_.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    undo()
    out = {"loss": np.asarray(losses_), "grad_norm": np.asarray(norms),
           "seen/heads": np.asarray(sorted(seen.get("heads", ()))),
           "seen/vocab": np.asarray(sorted(seen.get("vocab", ()))),
           "seen/bound_after": np.asarray(getattr(model, "tp", None)
                                          is not None),
           **_whole(state)}
    if state.layout is not None and state.layout.bound:
        out.update(_bound_logits(model, sync, state, shard_batch(
            sync.mesh, batch)))
    pieces = tckpt._pieces(state)
    for k, v in tckpt._state_leaves(state).items():
        out[f"numel/{k}"] = np.asarray(v.numel(), np.int64)
        if k not in pieces:
            out[f"whole/{k}"] = v.detach().numpy()
    if task.get("save"):
        mgr = tckpt.CheckpointManager(task["save"], sharded=True)
        mgr.save(state)
        back = mgr.restore(sync.init(model.init, seed=9))
        same = [torch.equal(a, b) for a, b in zip(
            tckpt._state_leaves(state).values(),
            tckpt._state_leaves(back).values())]
        out["roundtrip"] = np.asarray(all(same) and back.step == state.step
                                      and back.seed == state.seed)
    return out


def _xent(task, rank):
    """The vocab-parallel head on this rank's piece, every impl."""
    mesh = build_mesh(MeshShape(**task["mesh"]))
    tp = tensor_parallel.model_axis(mesh)
    with np.load(task["inputs"]) as z:
        x = {k: torch.from_numpy(z[k]) for k in z.files}
    v = x["table"].shape[0] // tp.size
    rows = slice(tp.index * v, (tp.index + 1) * v)
    out = {}
    for impl in ("full", "chunked", "fused"):
        for with_bias in (False, True):
            h = x["h"].clone().requires_grad_(True)
            table = x["table"][rows].clone().requires_grad_(True)
            bias = (x["bias"][rows].clone().requires_grad_(True)
                    if with_bias else None)
            loss, acc = losses.lm_head_xent(
                h, table, x["labels"], x["weights"], bias=bias, impl=impl,
                seq_chunk=4 if impl == "chunked" else 0,
                vocab_block=12 if impl == "fused" else 0, tp=tp)
            loss.backward()
            name = f"{impl}-{'bias' if with_bias else 'nobias'}"
            out[f"{name}/loss"] = loss.detach().numpy()
            out[f"{name}/acc"] = acc.detach().numpy()
            out[f"{name}/dh"] = h.grad.numpy()
            out[f"{name}/dtable"] = table.grad.numpy()
            if with_bias:
                out[f"{name}/dbias"] = bias.grad.numpy()
    return out


def _vjp(task, rank):
    """Each case's differentiable collective on this rank's ``in/<case>``:
    its output and the gradient of sum(out * ``cot/<case>``)."""
    mesh = build_mesh(MeshShape(**task["mesh"]))
    with np.load(task["inputs"]) as z:
        ins = {k: torch.from_numpy(z[k][rank]) for k in z.files}
    out = {}
    for case in task["cases"]:
        name = case["name"]
        x = ins[f"in/{name}"].clone().requires_grad_(True)
        y = getattr(C, case["fn"])(x, case["axes"], mesh=mesh, **case["kw"])
        (y * ins[f"cot/{name}"]).sum().backward()
        out[f"out/{name}"] = y.detach().numpy()
        out[f"grad/{name}"] = x.grad.numpy()
    return out


def _ring(task, rank):
    from distributed_tensorflow_example_tpu_torch.parallel.ring_attention \
        import make_ring_attention
    mesh = build_mesh(MeshShape(**task["mesh"]))
    with np.load(task["inputs"]) as z:
        x = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    for case in task["cases"]:
        q, k, v = (x[n].clone().requires_grad_(True) for n in "qkv")
        attn = make_ring_attention(mesh, causal=case["causal"])
        o = attn(q, k, v, mask=x[case["mask"]] if case["mask"] else None)
        (o * x["w"]).sum().backward()
        name = case["name"]
        out[f"{name}/out"] = o.detach().numpy()
        for n, t in zip("qkv", (q, k, v)):
            out[f"{name}/d{n}"] = t.grad.numpy()
    return out


def _pipeline(task, rank):
    from distributed_tensorflow_example_tpu_torch.parallel import pipeline

    def stage_fn(stacked, x, mb_idx=0):
        h = x
        for i in range(stacked["kernel"].shape[0]):
            h = h + torch.relu(h @ stacked["kernel"][i] + stacked["bias"][i])
        return h

    out = {}
    with np.load(task["inputs"]) as z:
        arrays = {k: torch.from_numpy(z[k]) for k in z.files}
    for case in task["cases"]:
        mesh = build_mesh(MeshShape(**case["mesh"]))
        name = case["name"]
        whole = {k: arrays[f"{name}/{k}"] for k in ("kernel", "bias")}
        x = arrays[f"{name}/x"]
        piece = {k: v.clone().requires_grad_(True) for k, v in
                 pipeline.stage_params(whole, mesh).items()}
        piped = pipeline.make_pipeline(
            mesh, stage_fn, num_microbatches=case["microbatches"])
        got = piped(piece, x)
        (got ** 2).sum().backward()
        out[f"{name}/out"] = got.detach().numpy()
        for k, v in piece.items():
            out[f"{name}/d{k}"] = v.grad.numpy()
    return out


def _pipe_loss(task, rank):
    """A pipe model bound on this rank's pieces against the unbound model
    on the whole params, on this rank's rows (``pipe_bert_tiny`` with the
    task's dropout and generator seed, or ``pipe_mlp``)."""
    from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
        ShardLayout
    shape = MeshShape(**task["mesh"])
    mesh = build_mesh(shape)
    model = model_of(task["model"], task.get("dropout", 0.0),
                     **task.get("cfg", {}))
    whole = model.init(0, device="cpu")
    layout = ShardLayout.for_params(mesh, whole, model.sharding_rules(shape))
    with np.load(task["batch"]) as z:
        batch = shard_batch(mesh, {k: torch.from_numpy(z[k])
                                   for k in z.files})
    out = {}

    def run(params, bound):
        flat = {k: v.detach().clone().requires_grad_(True)
                for k, v in flatten_dict(params).items()}
        gen = torch.Generator()
        gen.manual_seed(task.get("seed", 7))
        model.bind_mesh(mesh if bound else None)
        try:
            loss = model.loss(unflatten_dict(flat), {}, batch, gen)[0]
            grads = torch.autograd.grad(loss, list(flat.values()))
            with torch.no_grad():
                logits = model.apply(unflatten_dict(flat), {}, batch)[0]
        finally:
            model.bind_mesh(None)
        return loss, dict(zip(flat, grads)), logits

    l_p, g_p, o_p = run(layout.shard_params(whole), True)
    l_s, g_s, o_s = run(whole, False)
    out["loss/piped"], out["loss/seq"] = l_p.detach().numpy(), \
        l_s.detach().numpy()
    out["logits/piped"], out["logits/seq"] = o_p.numpy(), o_s.numpy()
    for k in g_p:
        out[f"grad/piped/{k}"] = g_p[k].numpy()
        out[f"grad/seq/{k}"] = layout.local(k, g_s[k]).numpy()
    return out


def _bert_ring(task, rank):
    """bert_tiny's (and, with ``gpt_params``, gpt_tiny's causal) loss and
    gradients on this rank's rows with ring attention over ``seq`` and
    without it, from the given params."""
    from distributed_tensorflow_example_tpu_torch.parallel.ring_attention \
        import make_ring_attention
    mesh = build_mesh(MeshShape(**task["mesh"]))
    with np.load(task["params"]) as z:
        params = tckpt.from_numpy({k: z[k] for k in z.files}, "cpu")
    with np.load(task["batch"]) as z:
        batch = shard_batch(mesh, {k: torch.from_numpy(z[k])
                                   for k in z.files})
    out = {}
    for tag, fn in (("ring", make_ring_attention(mesh)), ("plain", None)):
        model = Bert(BertConfig(**BERT_TINY), attention_fn=fn)
        out.update(_loss_grads(model, params, batch, tag))
    if task.get("gpt_params"):
        with np.load(task["gpt_params"]) as z:
            gparams = tckpt.from_numpy({k: z[k] for k in z.files}, "cpu")
        gbatch = {k: batch[k] for k in ("input_ids", "attention_mask")}
        for tag, fn in (("ring", make_ring_attention(mesh, causal=True)),
                        ("plain", None)):
            model = GPT(GPTConfig(**GPT_TINY), attention_fn=fn)
            out.update(_loss_grads(model, gparams, gbatch, f"gpt/{tag}"))
    return out


def _loss_grads(model, params, batch, tag: str) -> dict:
    """``model``'s loss on ``batch`` (no dropout), its token weight and
    every parameter's gradient, keyed under ``tag``."""
    flat = {k: v.clone().requires_grad_(True)
            for k, v in flatten_dict(params).items()}
    loss, (aux, _) = model.loss(unflatten_dict(flat), {}, batch, None)
    grads = torch.autograd.grad(loss, list(flat.values()))
    out = {f"{tag}/loss": loss.detach().numpy(),
           f"{tag}/weight": aux[losses.LOSS_WEIGHT].numpy()}
    for k, g in zip(flat, grads):
        out[f"{tag}/grad/{k}"] = g.numpy()
    return out


def _moe_ep(task, rank):
    """Each case's MoE FFN (see the module docstring)."""
    from distributed_tensorflow_example_tpu_torch.ops import moe
    with np.load(task["inputs"]) as z:
        x = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    for case in task["cases"]:
        mesh = build_mesh(MeshShape(**case["mesh"]))
        name = case["name"]
        params = unflatten_dict({k[len(f"{name}/p/"):]: v.clone()
                                 .requires_grad_(True) for k, v in x.items()
                                 if k.startswith(f"{name}/p/")})
        flat = flatten_dict(params)
        kw = dict(n_experts=case["experts"], top_k=case.get("top_k", 1),
                  capacity_factor=case["capacity_factor"])
        if case["mode"] == "shard_map":
            y, aux = moe.moe_ffn_shard_map(
                params, x[f"{name}/x"], mesh,
                batch_axes=tuple(case["batch_axes"]),
                model_axis=case.get("model_axis"), **kw)
            loss = (y ** 2).sum() + aux["lb_loss"]
        else:
            n = mesh.size("data")
            with distributed.cross_rank_batch_stats():
                rows = shard_batch(mesh, {"x": x[f"{name}/x"],
                                          "cot": x[f"{name}/cot"]})
                y, aux = moe.moe_ffn(params, rows["x"],
                                     ranks=distributed.batch_ranks(), **kw)
                loss = ((y * rows["cot"]).sum()
                        + (aux["lb_loss"] + aux["z_loss"]) / n)
        grads = torch.autograd.grad(loss, list(flat.values()))
        if case["mode"] != "shard_map":
            grads = distributed.all_reduce_mean(list(grads))
            grads = [g * mesh.size("data") for g in grads]
        out[f"{name}/y"] = y.detach().numpy()
        for k, v in aux.items():
            out[f"{name}/aux/{k}"] = v.detach().numpy()
        for k, g in zip(flat, grads):
            out[f"{name}/grad/{k}"] = g.numpy()
    return out


def _pipe_groups(task, rank):
    """pipe_moe_bert_tiny's metrics bound on this rank's pieces and rows,
    and unbound on the whole params and the reordered rows."""
    from distributed_tensorflow_example_tpu_torch.parallel.sharding import \
        ShardLayout
    shape = MeshShape(**task["mesh"])
    mesh = build_mesh(shape)
    model = model_of(task["model"], **task.get("cfg", {}))
    whole = model.init(1, device="cpu")
    layout = ShardLayout.for_params(mesh, whole, model.sharding_rules(shape))
    with np.load(task["batch"]) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    order = np.asarray(task["order"])
    out = {}
    with torch.no_grad():
        model.bind_mesh(mesh)
        try:
            met = model.loss(layout.shard_params(whole), {},
                             shard_batch(mesh, batch), None)[1][0]
        finally:
            model.bind_mesh(None)
        seq = model.loss(whole, {}, {k: v[order] for k, v in batch.items()},
                         None)[1][0]
    for k in ("aux_loss", "router_z_loss", "dropped_token_fraction",
              "mlm_loss"):
        out[f"piped/{k}"] = met[k].numpy()
        out[f"seq/{k}"] = seq[k].numpy()
    return out


def _multi(task, rank):
    """K single steps against one ``multi_step`` call on the same
    stack, each from the seed-0 init."""
    mesh = MeshShape(**task["mesh"])
    with np.load(task["batches"]) as z:
        stacked = {k: z[k] for k in z.files}
    out = {}
    for run in ("single", "multi"):
        model, sync = _sync(task, mesh)
        state = sync.init(model.init, seed=0)
        batch_axes = ("data", "fsdp")
        n, i = sync.mesh.size(batch_axes), sync.mesh.index(batch_axes)
        mine = {k: v[:, i * v.shape[1] // n:(i + 1) * v.shape[1] // n]
                for k, v in stacked.items()}
        if run == "single":
            for j in range(len(next(iter(mine.values())))):
                state, met = sync.step(state,
                                       {k: v[j] for k, v in mine.items()})
        else:
            state, met = sync.multi_step(state, mine)
        out[f"{run}/step"] = np.asarray(state.step)
        out.update({f"{run}/{k}": v for k, v in _whole(state).items()})
        out.update({f"{run}/metric/{k}": v.numpy() for k, v in met.items()})
    return out


def _restore(task, rank):
    mesh = MeshShape(**task["mesh"])
    model, sync = _sync(task, mesh)
    mgr = tckpt.CheckpointManager(task["dir"])
    state = mgr.restore(sync.init(model.init, seed=7), task["step"])
    return {"step": np.asarray(state.step), **_whole(state)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--tasks", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    with open(a.tasks) as f:
        tasks = json.load(f)
    dist.init_process_group("gloo", init_method=a.init, rank=a.rank,
                            world_size=a.world)
    runners = {"collectives": _collectives, "train": _train,
               "restore": _restore, "xent": _xent, "ring": _ring,
               "pipeline": _pipeline, "pipe_loss": _pipe_loss,
               "bert_ring": _bert_ring, "vjp": _vjp, "moe_ep": _moe_ep,
               "pipe_groups": _pipe_groups, "multi": _multi}
    for task in tasks:
        if task["kind"] == "cli":
            continue
        out = runners[task["kind"]](task, a.rank)
        np.savez(os.path.join(a.out, f"{task['name']}.rank{a.rank}.npz"),
                 **out)
    distributed.shutdown()
    from distributed_tensorflow_example_tpu_torch.cli import train as cli
    for task in tasks:
        if task["kind"] != "cli":
            continue
        for argv, port in zip(task["argvs"], task["ports"]):
            # worker 0's address is the rendezvous; the others' ports
            # are never bound
            hosts = ",".join(f"127.0.0.1:{port + r}"
                             for r in range(a.world))
            rc = cli.main(argv + ["--worker_hosts", hosts,
                                  "--task_index", str(a.rank)])
            assert rc == 0, (argv, rc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
