"""Multi-process bring-up over ``torch.distributed`` (port of
``distributed_tensorflow_example_tpu/runtime/distributed.py``).

The reference starts JAX's coordination service with worker 0 as the
coordinator; here worker 0's address from the ``ClusterSpec`` is the
``tcp://`` rendezvous of a process group, ``--task_index`` is the rank and
the number of worker hosts the world size. A CUDA device takes NCCL
(rank ``r`` drives card ``r`` modulo the cards of its host), the CPU
gloo. An explicit ``init_method`` (``file://...``) replaces the
rendezvous address, so tests meet without fixed ports.

One process (no cluster, or one worker) initializes nothing, and every
helper here is then a no-op, so the same trainer runs on one card or on
many. The collectives the sync step and the checkpoint ring need live
here too: the mean all-reduce, the broadcast from rank 0, the barrier,
and the differentiable mean of batch statistics over the ranks (batch
norm's, sync-BN, and, through :class:`BatchRanks`, MoE routing's, with
the gather of the routing counts), switched on by
:func:`cross_rank_batch_stats`.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime

import torch
import torch.distributed as dist

from ..cluster import ClusterSpec, resolve_legacy_role
from ..utils.logging import get_logger
from .device import resolve_device

log = get_logger("distributed")

#: how long a rank waits for the others at the rendezvous and in a
#: collective before it raises
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What a process knows about its place in the cluster after init."""

    process_index: int
    num_processes: int
    is_chief: bool                 # rank 0, worker task 0
    coordinator_address: str | None
    multihost: bool

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def initialize(cluster: ClusterSpec | None = None,
               job_name: str = "worker",
               task_index: int = 0,
               *,
               device: str | torch.device | None = None,
               init_method: str | None = None) -> DistributedContext:
    """Bring up the process group for this process.

    One worker: returns at once. Several: ``init_process_group`` with
    worker 0 as the rendezvous (or ``init_method``), NCCL for a CUDA
    ``device`` (``cuda`` by default) and gloo for the CPU. A ps task
    returns the no-PS context (the caller logs the notice and exits 0).
    Safe to call more than once: a live group is reused."""
    role = resolve_legacy_role(cluster, job_name, task_index)
    if not role.should_run:
        return DistributedContext(
            process_index=0, num_processes=role.num_processes,
            is_chief=False, coordinator_address=None, multihost=False)
    coord = cluster.coordinator_address() if cluster else None
    multihost = role.num_processes > 1
    if not multihost:
        return DistributedContext(
            process_index=role.process_index, num_processes=1,
            is_chief=role.is_chief, coordinator_address=coord,
            multihost=False)
    if not dist.is_initialized():
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(role.process_index
                                  % torch.cuda.device_count())
        method = init_method or f"tcp://{coord}"
        dist.init_process_group(
            backend, init_method=method, world_size=role.num_processes,
            rank=role.process_index, timeout=TIMEOUT)
        log.info("torch.distributed initialized (%s): rank %d/%d, "
                 "rendezvous %s", backend, role.process_index,
                 role.num_processes, method)
    if dist.get_world_size() != role.num_processes \
            or dist.get_rank() != role.process_index:
        raise RuntimeError(
            f"a live process group has rank {dist.get_rank()}/"
            f"{dist.get_world_size()}, this task wants "
            f"{role.process_index}/{role.num_processes}")
    return DistributedContext(
        process_index=dist.get_rank(), num_processes=dist.get_world_size(),
        is_chief=role.is_chief, coordinator_address=coord, multihost=True)


def shutdown() -> None:
    """Leave the process group (no-op without one), with the meshes and
    subgroups built over it."""
    if dist.is_initialized():
        from ..parallel.mesh import forget_meshes
        forget_meshes()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_ids() -> list[int] | None:
    return ([torch.cuda.current_device()]
            if dist.get_backend() == "nccl" else None)


def barrier() -> None:
    """Every rank waits here for the others (the checkpoint fence and the
    shutdown); the per-step barrier is the sync step's all-reduce."""
    if process_count() == 1:
        return
    dist.barrier(device_ids=_device_ids())


def all_reduce_mean(tensors: list[torch.Tensor], group=None,
                    size: int | None = None) -> list[torch.Tensor]:
    """Each tensor's mean over the ranks (the reference's ``pmean``): one
    summing all-reduce for every dtype among them, over a flat buffer,
    then a division by the rank count. Every rank gets the same bits.
    ``group``/``size``: a process group of ``size`` ranks instead of the
    world. Returns new tensors; the inputs are unchanged."""
    world = process_count() if size is None else size
    if world == 1:
        return list(tensors)
    out: list[torch.Tensor | None] = [None] * len(tensors)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / world
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def broadcast_(tensors: list[torch.Tensor]) -> None:
    """Overwrite every rank's tensors with rank 0's, in place."""
    if process_count() == 1:
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def _broadcast_scalar(value, dtype: torch.dtype):
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=dtype, device=device)
    dist.broadcast(t, src=0)
    return t.item()


def broadcast_int(value: int | None) -> int | None:
    """Rank 0's ``value`` (an int >= 0 or None) on every rank."""
    if process_count() == 1:
        return value
    got = int(_broadcast_scalar(-1 if value is None else int(value),
                                torch.int64))
    return None if got < 0 else got


def broadcast_float(value: float) -> float:
    """Rank 0's ``value`` (NaN included) on every rank, as f64."""
    if process_count() == 1:
        return float(value)
    return float(_broadcast_scalar(float(value), torch.float64))


class _MeanOverRanks(torch.autograd.Function):
    """The mean over the ranks, whose backward is the same mean of the
    cotangent. Rank r's loss reads the mean through every rank's input,
    and the sync step later averages the ranks' gradients: so each rank
    hands its input the ranks' mean cotangent, and the averaged gradient
    is that of the mean loss over the global batch."""

    @staticmethod
    def forward(ctx, x, over):
        ctx.over = over
        return all_reduce_mean([x], *over)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean([g], *ctx.over)[0], None


#: the ranks batch statistics are averaged over here: None (no
#: averaging), or ``all_reduce_mean``'s (group, size)
_CROSS_RANK_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "cross_rank_batch_stats", default=None)


@contextlib.contextmanager
def cross_rank_batch_stats(group=None, size: int | None = None):
    """Inside, :func:`batch_stats_mean` averages over every rank (or the
    ``size`` ranks of ``group``, the batch ranks of a mesh with a
    ``model``, ``expert``, ``seq`` or ``pipe`` axis), and
    :func:`batch_ranks` names those ranks for the layers that route over
    them (``models/moe.py``): the reference's ``auto`` mode, which
    normalises (and routes) over the global batch. The sync step enters it
    around the forward and backward of a step; with one rank it is
    inert."""
    n = process_count() if size is None else size
    token = _CROSS_RANK_STATS.set((group, size) if n > 1 else None)
    try:
        yield
    finally:
        _CROSS_RANK_STATS.reset(token)


def batch_stats_mean(stats: torch.Tensor) -> torch.Tensor:
    """Per-channel batch statistics of this rank -> their mean over the
    ranks inside :func:`cross_rank_batch_stats` (one all-reduce forward,
    one backward), or ``stats`` unchanged outside it."""
    over = _CROSS_RANK_STATS.get()
    if over is None:
        return stats
    return _MeanOverRanks.apply(stats, over)


@dataclasses.dataclass(frozen=True)
class BatchRanks:
    """The batch ranks of an ``auto`` step over several of them: this
    rank's ``index`` among the ``size`` ranks of ``group`` (None: every
    rank), in member order, the order of their rows in the global batch.
    A layer that computes over the global batch (MoE routing,
    ``ops/moe.py``) takes it as an argument."""

    index: int
    size: int
    group: object = None

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, differentiable (the backward
        is the same mean of the cotangent)."""
        return _MeanOverRanks.apply(x, (self.group, self.size))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading dim in member
        order (no gradient; one all-gather)."""
        x = x.detach().contiguous()
        got = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(got, x, group=self.group)
        return torch.stack(got)


def batch_ranks() -> BatchRanks | None:
    """The ranks :func:`cross_rank_batch_stats` averages over, seen from
    this rank; None outside it (one rank, a ``shard_map`` step, eval)."""
    over = _CROSS_RANK_STATS.get()
    if over is None:
        return None
    group, size = over
    return BatchRanks(dist.get_rank(group),
                      process_count() if size is None else size, group)
