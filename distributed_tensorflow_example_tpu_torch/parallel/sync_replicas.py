"""Sync data-parallel training step (port of ``distributed_tensorflow_
example_tpu/parallel/sync_replicas.py``): one replica per rank.

The reference compiles accumulate -> average -> apply into one program
over a mesh; the port runs the same step eagerly on each rank's card (or
the CPU when asked): gradients of the loss on the rank's share of the
global batch by autograd, optional microbatch accumulation
(``SyncConfig.accum_steps``), then, over N ranks of a
``torch.distributed`` group, one all-reduce that takes the gradients,
the loss and the aux metrics to their mean over the ranks (the
reference's ``pmean`` in ``_shard_map_step``), then
:meth:`SyncReplicas._update`, the reference's update with its on-device
anomaly guard. A step whose reduced loss or global grad-norm is not
finite applies the identity update on every rank alike: params,
optimizer state and extras keep their values (``torch.where`` on the
device, no host sync) while ``step`` and ``anomaly_count`` advance.
Under ``anomaly_policy`` skip or rollback that step's metrics read -1.0;
under halt the raw values are published (what a halting caller
reports).

``mode="auto"`` and ``mode="shard_map"`` take the same gradients here:
with one replica per rank the placement-driven and the explicit forms
both come down to per-rank gradients and their mean. They part for a
model whose loss takes statistics across examples (batch norm), as in
the reference. ``auto`` normalizes over the global batch: over several
ranks the step runs the forward and backward inside
:func:`~..runtime.distributed.cross_rank_batch_stats`, so each batch
norm averages its per-channel statistics over the ranks with a
differentiable all-reduce (sync-BN), and the new running statistics come
out the same on every rank. ``shard_map`` normalizes over each rank's
batch and takes the new running statistics to their mean over the ranks
in the step's one all-reduce (the reference's ``pmean`` of
``new_extras``; under ``auto`` that mean is of equal values). With
``accum_steps > 1`` the statistics are those of each microbatch,
threaded through the microbatches in order. The reference's microbatch
i is the i-th block of consecutive rows of the global batch under
``auto`` and of each replica's batch under ``shard_map``; each rank here
splits its batch into consecutive blocks, so under ``auto`` its batch
must hold its share of each global microbatch in turn: the loader's
``microbatches=`` layout, whose count :attr:`SyncReplicas.
loader_microbatches` gives (the Trainer passes it).
A loss that is a weighted token mean (GPT's next-token loss, BERT's MLM
loss) reports its total weight in its aux metrics under
:data:`~..ops.losses.LOSS_WEIGHT`. Under ``auto`` over N ranks the step
then scales each rank's gradients, loss and aux metrics of each
(micro)batch by the rank's share of the weight, W_r over the ranks'
mean weight (one small all-reduce a microbatch), so the ranks' mean is
the weighted mean over the global (micro)batch (the reference's
``auto``, a loss over the whole sharded batch) even where the ranks'
shares hold different numbers of tokens; the microbatches' means are
then averaged as they are, as the reference's scan does. The part of
such a loss that the loss reports under
:data:`~..ops.losses.LOSS_GLOBAL` (the MoE models' routing losses,
whose plain mean over the ranks is the global batch's) is left out of
that scaling, so its gradient is averaged as it is. The scale is taken
before the backward (one small all-reduce after each forward). ``shard_map``
takes the plain mean of the ranks' means, as the reference's ``pmean``
does.
``debug_checks=True`` is the counterpart of the reference's
``checkify.float_checks``: before the anomaly guard and the optimizer,
the step checks its loss, its aux metrics and every gradient leaf (one
host sync a step, for debugging) and raises ``FloatingPointError`` naming
the global step and the first non-finite leaf. :meth:`counted_step` runs
a step under ``torch.utils.flop_counter.FlopCounterMode`` and keeps its
FLOP count in ``last_cost_analysis``, the counterpart of the reference's
``precompile`` cost analysis (``--step_timing``'s
``step_cost_analysis``).
:meth:`SyncReplicas.multi_step` runs K steps in one call on a stack of K
batches, ``[K, B, ...]`` with the loop axis first: the state after K
steps and the last step's metrics (the reference's ``_multi_step``, a
``lax.scan`` compiled into one dispatch). Eager, it is K runs of the
same step in order, each on a view of its slice of the stack, which
crosses to the card in one pinned, non-blocking copy a leaf; nothing
syncs the host between the K steps. What it saves is the caller's host
work between steps (the Trainer's loader, hooks and bookkeeping run once
a call) and K - 1 copies to the card; it saves no launch, since each of
its steps launches what one step does. Each step draws its dropout from
its own generator (the seed's, the step's and the microbatch's), so K
steps a call equal K single calls bit for bit. The reference donates the
state's buffers to the step (its ``tests/test_donation.py``); eager torch
has no donation: the old state's tensors are freed once nothing holds
them, so a caller that keeps the old state holds both.

The mesh is one rank a card (or a gloo CPU process): its axes multiply
to the number of ranks, and a mesh that asks for more (several cards to
a process) is refused. Any of its axes may be wider than 1. The replicas
are ``data`` × ``fsdp``, as the reference's batch split (``mesh.py``'s
``BATCH``): ``model``, ``seq``, ``expert`` and ``pipe`` ranks see the
same batch rows. Under ``auto`` the state is placed by the
model's :class:`~.sharding.ShardingRules` (:class:`~.sharding.
ShardLayout`): :meth:`SyncReplicas.init` builds the whole state from the
seed on every rank and keeps this rank's pieces of each sharded
parameter and of its per-parameter optimizer leaves, over ``fsdp``
(ZeRO-3), ``model`` (Megatron tensor parallelism), ``expert`` (a MoE
layer's experts) or ``pipe`` (a pipe model's stage of its stacked
blocks; a leaf may be split over two of them). A step gathers the
``fsdp`` pieces before the loss and leaves the ``model``, ``expert``
and ``pipe`` pieces as they are: it binds its mesh on the loss's model
(``bind_mesh``), whose layers compute on them
(``parallel/tensor_parallel.py``, ``ops/moe.py``,
``parallel/pipeline.py``). After the backward each ``fsdp`` piece's
gradient is reduce-scattered to its mean over ``fsdp`` and averaged over
``data``; the other pieces' and the whole leaves' gradients, the loss,
the aux metrics, the token weights and the new extras are averaged over
(``data``, ``fsdp``), never over ``model``, ``seq``, ``expert`` or
``pipe``. That is right for
the leaves repeated along those axes because the model makes their
gradients whole and equal on every member before the step sees them: a
conjugate pair of collectives sits at each edge of a split region (the
rule of ``parallel/tensor_parallel.py`` for ``model``; along ``expert``
the MoE layer's, ``ops/moe.py``). Along ``pipe``
the pipeline's input sums its gradient over ``pipe`` (only stage 0 reads
it: an input projection or the embeddings get their gradient there
alone) and its output passes the gradient through (every stage computes
the head and the loss alike, so a head's gradient is the same on each),
so no leaf needs a sum on one axis and a mean on another. Along ``seq``
the model runs replicated (each ``seq`` rank computes the same step)
unless ring attention is bound (``parallel/ring_attention.py``), whose
cut and join of the sequence are such a pair.
Every reduction over a whole leaf in the update (the global norm of the
clip, ``grad_norm`` and the anomaly guard; the trust ratio; adafactor's
factored RMS, block-RMS clip and parameter RMS) sums its partial sums
over each piece's own shard group (``optimizers.shard_reduction``). This
is the program the reference's XLA compiles from its ``NamedSharding``.
``shard_map`` keeps the parameters whole on every rank, as the
reference's ``_shard_map_step`` (whose state is replicated, ``P()``)
does: ``fsdp`` is then one more batch axis, and ``model``, ``seq``,
``expert`` and ``pipe`` ranks repeat the same step (MoE-BERT routes each
rank's tokens there). A pipelined model (``pipe_mlp``,
``pipe_bert``) over a ``pipe`` axis is refused there, as the
reference's step refuses the pipeline's own ``shard_map`` inside its
own.

The loss signature is the framework's::

    loss_fn(params, extras, batch, gen) -> (loss, (aux_metrics, new_extras))

with ``gen`` the step's ``torch.Generator`` (dropout), on the device.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch

from ..config import MeshShape, SyncConfig
from ..ops.losses import LOSS_GLOBAL, LOSS_WEIGHT
from ..runtime import distributed
from ..runtime.device import resolve_device
from ..train.optimizers import (LeafShard, Transform, apply_updates,
                                global_norm, shard_reduction)
from ..train.state import TrainState
from ..utils.pytree import flatten_dict, tree_map, unflatten_dict
from . import collectives
from .mesh import AxisNames, Mesh, build_mesh, mesh_sizes
from .sharding import ShardingRules, ShardLayout

LossFn = Callable[..., tuple[torch.Tensor, tuple[dict, Any]]]

_MIX = 0x9E3779B97F4A7C15


def _generator(device: torch.device, seed: int, step: int,
               micro: int) -> torch.Generator:
    """The dropout generator of one (microbatch of a) step: a function of
    the state's seed, the step and the microbatch alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * _MIX + step * 1_000_003 + micro) % 2**63)
    return gen


def _split_microbatches(batch: dict, accum_steps: int) -> list[dict]:
    """[B, ...] leaves -> ``accum_steps`` batches of [B / accum, ...]."""
    for k, x in batch.items():
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch dim {x.shape[0]} of {k!r} not "
                             f"divisible by accum_steps={accum_steps}")
    return [{k: x.chunk(accum_steps)[i] for k, x in batch.items()}
            for i in range(accum_steps)]


def _value_and_grad(loss_fn: LossFn, params: dict, extras, batch, gen,
                    weigh: Callable | None = None):
    """(grads in ``flatten_dict`` order, loss, aux, new_extras). ``weigh``
    (the mean over the batch ranks, or None): a loss that reports its
    :data:`LOSS_WEIGHT` is scaled by the rank's :func:`_token_share` of
    it before the backward, its :data:`LOSS_GLOBAL` part excepted, and
    so are its aux metrics; both keys leave the metrics."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten_dict(params).items()}
    loss, (aux, new_extras) = loss_fn(unflatten_dict(flat), extras, batch,
                                      gen)
    weight = aux.pop(LOSS_WEIGHT, None)
    fixed = aux.pop(LOSS_GLOBAL, None)
    aux = {k: v.detach() for k, v in aux.items()}
    if weigh is not None and weight is not None:
        c = _token_share(weight, weigh)
        loss = (c * loss if fixed is None
                else c * (loss - fixed) + fixed)
        aux = {k: v * c for k, v in aux.items()}
    leaves = list(flat.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return grads, loss.detach(), aux, new_extras


def _token_share(weight: torch.Tensor, mean: Callable) -> torch.Tensor:
    """This rank's share of a weighted token mean over the batch ranks:
    its weight W_r over the ranks' mean weight (``mean``, over the batch
    ranks; a rank's mean is S_r / max(W_r, 1), so the ranks' mean of the
    scaled means is sum_r S_r / sum_r W_r); 1 where no rank has a token,
    so the plain mean stands and a skipped metric's -1.0 stays -1.0."""
    w = weight.detach().float()
    mean_w = mean([w])[0]
    some = mean_w > 0
    return torch.where(some, w / torch.where(some, mean_w, 1.0), 1.0)


def _grads_and_metrics(loss_fn: LossFn, params, extras, batch, gens,
                       accum_steps: int, weigh: Callable | None = None):
    """Gradients (+ loss/aux/extras) with optional microbatch
    accumulation: the microbatches' gradients summed in order, then
    divided, and their loss and aux metrics averaged, as the reference's
    scan does. ``gens``: one generator per microbatch. ``weigh``: see
    :func:`_value_and_grad`."""
    gsum, lsum, auxes, ex = None, 0.0, [], extras
    for mb, gen in zip(_split_microbatches(batch, accum_steps), gens):
        g, loss, aux, ex = _value_and_grad(loss_fn, params, ex, mb, gen,
                                           weigh)
        if accum_steps <= 1:
            return g, loss, aux, ex
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        lsum = lsum + loss
        auxes.append(aux)
    grads = [g / accum_steps for g in gsum]
    aux = {k: torch.stack([a[k] for a in auxes]).mean(dim=0)
           for k in auxes[0]}
    return grads, lsum / accum_steps, aux, ex


#: the rule a mesh's size must keep
ONE_RANK_A_CARD = ("the port runs one rank a card (one process a card, or "
                   "a gloo CPU process): the mesh's axes must multiply to "
                   "the number of ranks")


def resolve_mesh(mesh, world: int) -> dict[str, int]:
    """The axis sizes a ``mesh`` asks for over ``world`` ranks: None or
    -1 puts every rank on ``data``, an int is the data axis, a
    ``MeshShape`` its axes (one -1 wildcard allowed), a :class:`Mesh`
    its own sizes. Refuses a mesh that is not one rank a card."""
    if isinstance(mesh, Mesh):
        sizes = dict(mesh.shape)
        if mesh.world != world:
            raise NotImplementedError(
                f"mesh over {mesh.world} rank(s) in a world of {world}: "
                f"{ONE_RANK_A_CARD}")
        return sizes
    if not isinstance(mesh, MeshShape):
        data = world if mesh is None or mesh == -1 else int(mesh)
        mesh = MeshShape(data=data)
    axes = mesh.as_dict()
    if -1 not in axes.values() and mesh.total() != world:
        raise NotImplementedError(
            f"mesh {axes} asks for {mesh.total()} replica rank(s) over "
            f"{world} rank(s): {ONE_RANK_A_CARD}")
    return mesh_sizes(mesh, world)


class SyncReplicas:
    """The sync train step for a (loss_fn, optimizer), one replica per
    rank.

    Usage::

        sync = SyncReplicas(model.loss, make_optimizer(cfg), device="cuda")
        state = sync.init(model.init, seed=0)
        state, metrics = sync.step(state, batch)

    ``batch`` is this rank's share of the global batch (the loader's
    ``process_index``/``num_processes`` slice, laid out in
    ``loader_microbatches`` microbatches). ``metrics`` are device
    tensors (``loss``, ``grad_norm`` — the global norm before clipping —,
    the loss's aux metrics and ``anomaly_count``), the same on every
    rank; reading them is the caller's host sync. An aux metric may be a
    vector (MoE-BERT's per-expert load): the microbatch mean, the mean
    over the ranks, the skipped step's -1.0 fill and ``debug_checks``
    take it element by element.
    """

    def __init__(self, loss_fn: LossFn, tx: Transform, mesh=None, *,
                 sync: SyncConfig | None = None,
                 rules: ShardingRules | None = None,
                 anomaly_policy: str = "halt",
                 device: str | torch.device | None = None,
                 debug_checks: bool = False):
        self.loss_fn = loss_fn
        #: check every step's loss, aux metrics and gradients for a
        #: non-finite value and raise (one host sync a step)
        self.debug_checks = bool(debug_checks)
        #: ``{"flops": F}`` of one call, set by :meth:`counted_step`
        self.last_cost_analysis: dict | None = None
        self.tx = tx
        self.sync = sync or SyncConfig()
        if anomaly_policy not in ("halt", "skip", "rollback"):
            raise ValueError(
                f"anomaly_policy must be halt|skip|rollback, got "
                f"{anomaly_policy!r}")
        self.anomaly_policy = anomaly_policy
        if self.sync.mode not in ("auto", "shard_map"):
            raise ValueError(f"unknown sync mode {self.sync.mode!r}")
        sizes = resolve_mesh(mesh, distributed.process_count())
        model = getattr(loss_fn, "__self__", None)
        if (self.sync.mode == "shard_map" and sizes["pipe"] > 1
                and getattr(model, "pipelined", False)):
            raise ValueError(
                f"sync mode shard_map with pipe={sizes['pipe']}: the "
                f"{type(model).__name__} pipeline is its own SPMD program "
                "over pipe and does not run inside the step's per-replica "
                "one (the reference's shard_map step refuses it too); use "
                "mode auto")
        #: this rank's place in the mesh (its groups: the collectives')
        self.mesh = build_mesh(MeshShape(**sizes))
        self.num_replicas = sizes["data"] * sizes["fsdp"]
        #: the model whose loss this is (a bound method's owner): the
        #: step binds its mesh on it when the layers compute on
        #: ``model``, ``expert`` or ``pipe`` pieces
        self.model = model
        #: the placement rules (``shard_map`` keeps the params whole)
        self.rules = (rules or ShardingRules(fsdp_axis_size=sizes["fsdp"])
                      if self.sync.mode == "auto" else ShardingRules())
        if (self.sync.replicas_to_aggregate is not None
                and self.sync.replicas_to_aggregate != self.num_replicas):
            raise ValueError(
                f"replicas_to_aggregate={self.sync.replicas_to_aggregate} "
                f"must equal the replica count ({self.num_replicas}, the "
                "batch ranks): partial aggregation has no synchronous "
                "analogue, as in the reference")
        if (self.sync.total_num_replicas is not None
                and self.sync.total_num_replicas != self.num_replicas):
            raise ValueError(
                f"total_num_replicas={self.sync.total_num_replicas} != "
                f"replicas_to_aggregate (backup replicas) is not supported, "
                f"as in the reference")
        if self.sync.accum_steps < 1:
            raise ValueError(f"accum_steps={self.sync.accum_steps} must be "
                             f">= 1")
        #: the loader's ``microbatches``: under ``auto`` each rank's batch
        #: holds its share of every global microbatch in turn
        self.loader_microbatches = (self.sync.accum_steps
                                    if self.sync.mode == "auto" else 1)
        self.device = resolve_device(device)

    def init(self, init_fn: Callable[[torch.Generator], Any], *,
             seed: int = 0) -> TrainState:
        """A TrainState from ``init_fn(gen)`` (params, or (params,
        extras)), ``gen`` a generator on the device seeded with ``seed``.
        On a sharded mesh every rank builds the whole state alike and
        keeps its pieces (the state's ``layout``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        out = init_fn(gen)
        params, extras = out if isinstance(out, tuple) else (out, {})
        params = tree_map(lambda x: x.to(self.device), params)
        state = TrainState.create(params=params, tx=self.tx, extras=extras,
                                  seed=seed)
        if self.sync.mode != "auto":
            return state
        layout = ShardLayout.for_params(self.mesh, params, self.rules)
        if not layout.sharded:
            return state
        with self._bound(layout):       # the model refuses split heads
            pass
        return state.replace(
            params=layout.shard_params(params),
            opt_state=layout.map_per_param(
                state.opt_state,
                lambda k, v: (layout.local(k, v) if layout.leaf_shards(k, v)
                              else v)),
            layout=layout)

    @staticmethod
    def full_params(state: TrainState) -> dict:
        """The state's params as whole tensors: gathered over ``fsdp``
        and ``model`` from every rank's pieces on a sharded state (every
        rank must call it then), the params themselves otherwise."""
        if state.layout is None:
            return state.params
        return state.layout.full_params(state.params)

    def _to_device(self, batch: dict) -> dict:
        """Host arrays -> tensors on the device. On the card a host array
        goes through pinned memory with a non-blocking copy: a copy from
        pageable memory would wait for the stream to drain, so the host
        could not queue the next step while the card runs this one."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in batch.items()}
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    def step(self, state: TrainState, batch: dict):
        """One sync step: ``(new_state, metrics)``."""
        return self._step(state, self._to_device(batch))

    def multi_step(self, state: TrainState, stacked_batches: dict):
        """K sync steps in one call: ``(state after K steps, the last
        step's metrics)``. ``stacked_batches`` holds this rank's K
        batches stacked on a leading loop axis, ``[K, B_rank, ...]``
        (each batch in the ``loader_microbatches`` layout). Step i runs
        on ``stacked_batches[...][i]`` exactly as :meth:`step` would,
        its own dropout generator and ``debug_checks`` (which name the
        global step) included."""
        stack = self._to_device(stacked_batches)
        loops = {k: int(x.shape[0]) if x.dim() else 0
                 for k, x in stack.items()}
        if not loops or len(set(loops.values())) != 1 \
                or min(loops.values()) < 1:
            raise ValueError(f"multi_step takes K >= 1 batches stacked on "
                             f"a leading loop axis, got leading dims "
                             f"{loops}")
        metrics = None
        for i in range(next(iter(loops.values()))):
            state, metrics = self._step(
                state, {k: x[i] for k, x in stack.items()})
        return state, metrics

    def _step(self, state: TrainState, batch: dict):
        """:meth:`step` on a batch already on the device."""
        gens = [_generator(self.device, state.seed, state.step, i)
                for i in range(max(1, self.sync.accum_steps))]
        stats = (distributed.cross_rank_batch_stats(*self._batch_group())
                 if self.sync.mode == "auto" else contextlib.nullcontext())
        layout = state.layout
        params = (state.params if layout is None
                  else layout.step_params(state.params))
        weigh = (self._batch_mean if self.sync.mode == "auto"
                 and self.num_replicas > 1 else None)
        with stats, self._bound(layout):
            grads, loss, aux, new_extras = _grads_and_metrics(
                self.loss_fn, params, state.extras, batch, gens,
                self.sync.accum_steps, weigh=weigh)
        if layout is not None:
            grads, loss, aux, new_extras = self._reduce_sharded(
                layout, grads, loss, aux, new_extras)
        elif self.num_replicas > 1:
            grads, loss, aux, new_extras = self._mean_over_ranks(
                grads, loss, aux, new_extras)
        with shard_reduction(self._leaf_shards(layout)):
            if self.debug_checks:
                self._check_finite(state, grads, loss, aux)
            return self._update(state, grads, loss, aux, new_extras)

    @contextlib.contextmanager
    def _bound(self, layout):
        """The loss's model bound to this mesh while the step computes on
        ``model``, ``expert`` or ``pipe`` pieces (unbound again after, so
        eval and export see whole params); inert for a state with
        none."""
        if layout is None or not layout.bound:
            yield
            return
        if not hasattr(self.model, "bind_mesh"):
            raise ValueError(
                "the placement rules split parameters over model, expert "
                "or pipe, "
                f"but the loss's model ({type(self.model).__name__}) cannot "
                "compute on such pieces (no bind_mesh)")
        self.model.bind_mesh(self.mesh)
        try:
            yield
        finally:
            self.model.bind_mesh(None)

    def _batch_group(self) -> tuple:
        """``all_reduce_mean``'s (group, size) for the batch ranks: the
        world's (None, None) when they are the world, else their group
        (a mesh with a ``model``, ``seq``, ``expert`` or ``pipe``
        axis)."""
        if self.num_replicas == self.mesh.world:
            return None, None
        return self.mesh.group(AxisNames.BATCH), self.num_replicas

    def _batch_mean(self, tensors: list) -> list:
        """Each tensor's mean over the batch ranks (``data`` x ``fsdp``),
        one all-reduce a dtype."""
        return distributed.all_reduce_mean(tensors, *self._batch_group())

    def _leaf_shards(self, layout) -> list:
        """The ``shard_reduction`` of a state: a ``LeafShard`` for each
        parameter that is a piece here (its collectives over its own
        axis), None for a whole one."""
        if layout is None:
            return []
        def one(key, d, axis):
            start, stop = layout.bounds(key)[d]
            return LeafShard(
                dim=d, shape=layout.shapes[key], start=start, stop=stop,
                axis=axis,
                sum=functools.partial(collectives.all_reduce_sum,
                                      axis_name=axis, mesh=self.mesh),
                gather=functools.partial(_gather_along, axis=axis,
                                         mesh=self.mesh))

        out = []
        for key, splits in layout.splits.items():
            if not splits:
                out.append(None)
                continue
            first, *rest = (one(key, d, a) for d, a in splits)
            out.append(first._replace(extra=tuple(rest)))
        return out

    def _reduce_sharded(self, layout, grads, loss, aux, extras):
        """The gradient exchange of a sharded state: each ``fsdp`` piece's
        gradient reduce-scattered to its mean over ``fsdp`` (this rank
        keeps its piece), then averaged over ``data`` (ZeRO); the
        other pieces' and the whole leaves' gradients, the loss, the aux metrics and the new extras averaged
        over the batch ranks."""
        out = list(grads)
        rest = []
        for i, (g, key) in enumerate(zip(grads, layout.splits)):
            dim = dict((a, d) for d, a in layout.splits[key]).get(
                AxisNames.FSDP)
            if dim is None:
                rest.append(i)
                continue
            g = collectives.reduce_scatter_mean(
                g, AxisNames.FSDP, scatter_axis=dim, mesh=self.mesh)
            if self.mesh.shape[AxisNames.DATA] > 1:
                g = collectives.all_reduce_mean(g, AxisNames.DATA,
                                                mesh=self.mesh)
            out[i] = g
        got, loss, aux, extras = self._mean_over_ranks(
            [grads[i] for i in rest], loss, aux, extras)
        for i, g in zip(rest, got):
            out[i] = g
        return out, loss, aux, extras

    def counted_step(self, state: TrainState, batch: dict, *,
                     multi: bool = False):
        """:meth:`step` (:meth:`multi_step` with ``multi``, on a stack)
        under ``torch.utils.flop_counter.FlopCounterMode``: the call's
        FLOPs go to ``last_cost_analysis`` as ``{"flops": F}`` (the
        reference's ``precompile`` records XLA's cost analysis of the
        compiled step, or of the K-step program). The counter sees the
        aten ops the step dispatches, forward, backward and update:
        matmuls, convolutions and attention products, not elementwise
        ops. Like XLA's count,
        which cannot see inside a Pallas call, it cannot see a kernel
        launched through ``ctypes``: on the card the flash kernels' work
        is missing from it. The reference's ``bytes accessed`` and
        ``optimal_seconds`` have no counterpart here and are left out."""
        from torch.utils.flop_counter import FlopCounterMode
        with FlopCounterMode(display=False) as counter:
            out = (self.multi_step if multi else self.step)(state, batch)
        self.last_cost_analysis = {"flops": float(counter.get_total_flops())}
        return out

    @staticmethod
    def _check_finite(state: TrainState, grads, loss, aux) -> None:
        """``debug_checks``: raise ``FloatingPointError`` when the step's
        loss, an aux metric or a gradient leaf holds a NaN or an inf,
        naming the global step and the first such leaf (in that order;
        gradients in the params' pytree order). One host sync."""
        names = (["loss"] + [f"aux/{k}" for k in aux]
                 + [f"grads/{k}" for k in flatten_dict(state.params)])
        values = [loss, *aux.values(), *grads]
        bad = torch.stack([~torch.isfinite(v).all() for v in values])
        if state.layout is not None:
            # a piece's NaN is every rank's: they raise together
            bad = distributed.all_reduce_mean([bad.float()])[0] > 0
        if not bool(bad.any()):
            return
        hits = [n for n, b in zip(names, bad.tolist()) if b]
        n_grads = sum(n.startswith("grads/") for n in hits)
        raise FloatingPointError(
            f"debug_checks: non-finite value at step "
            f"{int(state.step) + 1} in {hits[0]} ({len(hits)} of "
            f"{len(names)} leaves non-finite, {n_grads} of {len(grads)} "
            f"gradients: {', '.join(hits[:4])}"
            f"{', ...' if len(hits) > 4 else ''})")

    def _mean_over_ranks(self, grads, loss, aux, extras):
        """The reference's ``pmean`` over the batch ranks of the
        gradients, the loss, the aux metrics and the new extras, in one
        all-reduce a dtype (under ``auto`` the extras are already equal
        across the ranks, and stay so)."""
        keys = list(aux)
        flat = flatten_dict(extras)
        out = self._batch_mean(
            list(grads) + [loss] + [aux[k] for k in keys]
            + list(flat.values()))
        n, m = len(grads), len(grads) + 1 + len(keys)
        return (out[:n], out[n], dict(zip(keys, out[n + 1:m])),
                unflatten_dict(dict(zip(flat, out[m:]))))

    def _update(self, state: TrainState, grads, loss, aux, new_extras):
        flat = flatten_dict(state.params)
        params = list(flat.values())
        updates, opt_state = self.tx.update(grads, state.opt_state, params)
        new_params = apply_updates(params, updates)
        grad_norm = global_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)

        def keep(new, old):
            return torch.where(finite, new, old)

        new_params = [keep(n, o) for n, o in zip(new_params, params)]
        opt_state = tree_map(keep, opt_state, state.opt_state)
        extras = tree_map(keep, new_extras, state.extras)
        anomaly_count = state.anomaly_count + (~finite).to(torch.int32)
        metrics = {"loss": loss, "grad_norm": grad_norm, **aux}
        if self.anomaly_policy in ("skip", "rollback"):
            metrics = {k: torch.where(finite, v, -torch.ones_like(v))
                       for k, v in metrics.items()}
        metrics["anomaly_count"] = anomaly_count
        new_state = state.replace(
            step=state.step + 1,
            params=unflatten_dict(dict(zip(flat, new_params))),
            opt_state=opt_state, extras=extras, anomaly_count=anomaly_count)
        return new_state, metrics


def _gather_along(t: torch.Tensor, dim: int, *, axis: str,
                  mesh: Mesh) -> torch.Tensor:
    """The members' ``t`` along ``axis`` concatenated on ``dim``."""
    return collectives.all_gather(t, axis, axis=dim, tiled=True, mesh=mesh)


def make_sync_train_step(loss_fn: LossFn, tx: Transform, mesh=None,
                         **kwargs) -> SyncReplicas:
    """Functional alias for ``SyncReplicas(...)``, as in the reference."""
    return SyncReplicas(loss_fn, tx, mesh, **kwargs)
