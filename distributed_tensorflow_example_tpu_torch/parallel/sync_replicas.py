"""Sync data-parallel training step (port of ``distributed_tensorflow_
example_tpu/parallel/sync_replicas.py``), on one device.

The reference compiles accumulate -> average -> apply into one program
over a mesh; the port runs the same step eagerly on one card (or the CPU
when asked): gradients of the loss by autograd, optional microbatch
accumulation (``SyncConfig.accum_steps``), then :meth:`SyncReplicas.
_update`, the reference's update with its on-device anomaly guard. A step
whose loss or global grad-norm is not finite applies the identity update:
params, optimizer state and extras keep their values (``torch.where`` on
the device, no host sync) while ``step`` and ``anomaly_count`` advance.
Under ``anomaly_policy`` skip or rollback that step's metrics read -1.0;
under halt the raw values are published (what a halting caller reports).

More than one replica (``mode="shard_map"``, a mesh or
``replicas_to_aggregate`` above one, gradients all-reduced over
``torch.distributed``) and ``multi_step`` arrive with slice A3c and raise.

The loss signature is the framework's::

    loss_fn(params, extras, batch, gen) -> (loss, (aux_metrics, new_extras))

with ``gen`` the step's ``torch.Generator`` (dropout), on the device.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..config import SyncConfig
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
    """(grads in ``flatten_dict`` order, loss, aux, new_extras)."""
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


def _grads_and_metrics(loss_fn: LossFn, params, extras, batch, gens,
                       accum_steps: int):
    """Gradients (+ loss/aux/extras) with optional microbatch
    accumulation: the microbatches' gradients summed in order, then
    divided, and their loss and aux metrics averaged, as the reference's
    scan does. ``gens``: one generator per microbatch."""
    if accum_steps <= 1:
        return _value_and_grad(loss_fn, params, extras, batch, gens[0])
    gsum, lsum, auxes, ex = None, 0.0, [], extras
    for mb, gen in zip(_split_microbatches(batch, accum_steps), gens):
        g, loss, aux, ex = _value_and_grad(loss_fn, params, ex, mb, gen)
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        lsum = lsum + loss
        auxes.append(aux)
    grads = [g / accum_steps for g in gsum]
    aux = {k: torch.stack([a[k] for a in auxes]).mean(dim=0)
           for k in auxes[0]}
    return grads, lsum / accum_steps, aux, ex


def _replica_count(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return int(mesh.size())


class SyncReplicas:
    """The sync train step for a (loss_fn, optimizer) on one device.

    Usage::

        sync = SyncReplicas(model.loss, make_optimizer(cfg), device="cuda")
        state = sync.init(model.init, seed=0)
        state, metrics = sync.step(state, batch)

    ``metrics`` are device tensors (``loss``, ``grad_norm`` — the global
    norm before clipping —, the loss's aux metrics and ``anomaly_count``);
    reading them is the caller's host sync.
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
        if self.sync.mode == "shard_map":
            raise NotImplementedError(
                "sync mode 'shard_map' (per-replica gradients and an "
                "explicit all-reduce) arrives with slice A3c")
        if _replica_count(mesh) != 1 or self.sync.replicas_to_aggregate \
                not in (None, 1):
            raise NotImplementedError(
                "more than one replica (gradients all-reduced over "
                "torch.distributed) arrives with slice A3c; the port's "
                "sync step runs one replica")
        if self.sync.total_num_replicas not in (None, 1):
            raise ValueError(
                f"total_num_replicas={self.sync.total_num_replicas} != "
                f"replicas_to_aggregate (backup replicas) is not supported, "
                f"as in the reference")
        if self.sync.accum_steps < 1:
            raise ValueError(f"accum_steps={self.sync.accum_steps} must be "
                             f">= 1")
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
        grads, loss, aux, new_extras = _grads_and_metrics(
            self.loss_fn, state.params, state.extras, batch, gens,
            self.sync.accum_steps)
        return self._update(state, grads, loss, aux, new_extras)

    def multi_step(self, state: TrainState, stacked_batches):
        raise NotImplementedError("multi_step (K steps per dispatch) "
                                  "arrives with slice A3c")

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
