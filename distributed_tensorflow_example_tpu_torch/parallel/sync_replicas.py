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
then averaged as they are, as the reference's scan does. ``shard_map``
takes the plain mean of the ranks' means, as the reference's ``pmean``
does.
``multi_step`` arrives with slice A3c-2b and raises; a data axis wider
than the ranks (several cards to a process) or a sharded axis with slice
A6.

The loss signature is the framework's::

    loss_fn(params, extras, batch, gen) -> (loss, (aux_metrics, new_extras))

with ``gen`` the step's ``torch.Generator`` (dropout), on the device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from ..config import MeshShape, SyncConfig
from ..ops.losses import LOSS_WEIGHT
from ..runtime import distributed
from ..runtime.device import resolve_device
from ..train.optimizers import Transform, apply_updates, global_norm
from ..train.state import TrainState
from ..utils.pytree import flatten_dict, tree_map, unflatten_dict

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


def _value_and_grad(loss_fn: LossFn, params: dict, extras, batch, gen):
    """(grads in ``flatten_dict`` order, loss, aux, new_extras); ``aux``
    may hold the loss's :data:`LOSS_WEIGHT`."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten_dict(params).items()}
    loss, (aux, new_extras) = loss_fn(unflatten_dict(flat), extras, batch,
                                      gen)
    leaves = list(flat.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    aux = {k: v.detach() for k, v in aux.items()}
    return grads, loss.detach(), aux, new_extras


def _token_share(weight: torch.Tensor) -> torch.Tensor:
    """This rank's share of a weighted token mean over the ranks: its
    weight W_r over the ranks' mean weight (a rank's mean is
    S_r / max(W_r, 1), so the ranks' mean of the scaled means is
    sum_r S_r / sum_r W_r); 1 where no rank has a token, so the plain
    mean stands and a skipped metric's -1.0 stays -1.0."""
    w = weight.detach().float()
    mean_w = distributed.all_reduce_mean([w])[0]
    some = mean_w > 0
    return torch.where(some, w / torch.where(some, mean_w, 1.0), 1.0)


def _grads_and_metrics(loss_fn: LossFn, params, extras, batch, gens,
                       accum_steps: int, weigh: bool = False):
    """Gradients (+ loss/aux/extras) with optional microbatch
    accumulation: the microbatches' gradients summed in order, then
    divided, and their loss and aux metrics averaged, as the reference's
    scan does. ``gens``: one generator per microbatch. ``weigh``: scale
    each microbatch's gradients, loss and aux metrics by the rank's
    :func:`_token_share` of its loss's :data:`LOSS_WEIGHT` (a loss
    without one is left as it is)."""
    gsum, lsum, auxes, ex = None, 0.0, [], extras
    for mb, gen in zip(_split_microbatches(batch, accum_steps), gens):
        g, loss, aux, ex = _value_and_grad(loss_fn, params, ex, mb, gen)
        weight = aux.pop(LOSS_WEIGHT, None)
        if weigh and weight is not None:
            c = _token_share(weight)
            g = [x * c.to(x.dtype) for x in g]
            loss = loss * c
            aux = {k: v * c for k, v in aux.items()}
        if accum_steps <= 1:
            return g, loss, aux, ex
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        lsum = lsum + loss
        auxes.append(aux)
    grads = [g / accum_steps for g in gsum]
    aux = {k: torch.stack([a[k] for a in auxes]).mean(dim=0)
           for k in auxes[0]}
    return grads, lsum / accum_steps, aux, ex


def _replica_count(mesh, world: int) -> int:
    """The replicas a ``mesh`` asks for (None or -1: one per rank; an int
    or a ``MeshShape``'s data axis), refusing what one replica per rank
    cannot give."""
    if isinstance(mesh, MeshShape):
        sharded = {k: v for k, v in mesh.as_dict().items()
                   if k != "data" and v != 1}
        if sharded:
            raise NotImplementedError(
                f"mesh axes {sharded} (sharded parameters or activations) "
                "arrive with slice A6; the port's sync step replicates the "
                "parameters, one replica per rank")
        mesh = mesh.data
    n = world if mesh is None or mesh == -1 else int(mesh)
    if n != world:
        raise NotImplementedError(
            f"{n} replicas over {world} rank(s): the port runs one replica "
            "per rank (one card each); more cards to a process arrive "
            "with slice A6")
    return n


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
    rank; reading them is the caller's host sync.
    """

    def __init__(self, loss_fn: LossFn, tx: Transform, mesh=None, *,
                 sync: SyncConfig | None = None,
                 anomaly_policy: str = "halt",
                 device: str | torch.device | None = None):
        self.loss_fn = loss_fn
        self.tx = tx
        self.sync = sync or SyncConfig()
        if anomaly_policy not in ("halt", "skip", "rollback"):
            raise ValueError(
                f"anomaly_policy must be halt|skip|rollback, got "
                f"{anomaly_policy!r}")
        self.anomaly_policy = anomaly_policy
        if self.sync.mode not in ("auto", "shard_map"):
            raise ValueError(f"unknown sync mode {self.sync.mode!r}")
        self.num_replicas = _replica_count(mesh, distributed.process_count())
        if (self.sync.replicas_to_aggregate is not None
                and self.sync.replicas_to_aggregate != self.num_replicas):
            raise ValueError(
                f"replicas_to_aggregate={self.sync.replicas_to_aggregate} "
                f"must equal the replica count ({self.num_replicas}, one "
                "per rank): partial aggregation has no synchronous "
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
        extras)), ``gen`` a generator on the device seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        out = init_fn(gen)
        params, extras = out if isinstance(out, tuple) else (out, {})
        params = tree_map(lambda x: x.to(self.device), params)
        return TrainState.create(params=params, tx=self.tx, extras=extras,
                                 seed=seed)

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
        batch = self._to_device(batch)
        gens = [_generator(self.device, state.seed, state.step, i)
                for i in range(max(1, self.sync.accum_steps))]
        stats = (distributed.cross_rank_batch_stats()
                 if self.sync.mode == "auto" else contextlib.nullcontext())
        with stats:
            grads, loss, aux, new_extras = _grads_and_metrics(
                self.loss_fn, state.params, state.extras, batch, gens,
                self.sync.accum_steps,
                weigh=self.sync.mode == "auto" and self.num_replicas > 1)
        if self.num_replicas > 1:
            grads, loss, aux, new_extras = self._mean_over_ranks(
                grads, loss, aux, new_extras)
        return self._update(state, grads, loss, aux, new_extras)

    @staticmethod
    def _mean_over_ranks(grads, loss, aux, extras):
        """The reference's ``pmean`` of the gradients, the loss, the aux
        metrics and the new extras, in one all-reduce a dtype (under
        ``auto`` the extras are already equal across the ranks, and
        stay so)."""
        keys = list(aux)
        flat = flatten_dict(extras)
        out = distributed.all_reduce_mean(
            list(grads) + [loss] + [aux[k] for k in keys]
            + list(flat.values()))
        n, m = len(grads), len(grads) + 1 + len(keys)
        return (out[:n], out[n], dict(zip(keys, out[n + 1:m])),
                unflatten_dict(dict(zip(flat, out[m:]))))

    def multi_step(self, state: TrainState, stacked_batches):
        raise NotImplementedError("multi_step (K steps per dispatch) "
                                  "arrives with slice A3c-2b")

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


def make_sync_train_step(loss_fn: LossFn, tx: Transform, mesh=None,
                         **kwargs) -> SyncReplicas:
    """Functional alias for ``SyncReplicas(...)``, as in the reference."""
    return SyncReplicas(loss_fn, tx, mesh, **kwargs)
