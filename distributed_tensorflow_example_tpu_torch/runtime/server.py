"""``tf.train.Server`` parity handle (an adapted copy of
``distributed_tensorflow_example_tpu/runtime/server.py``).

Constructed from ``(cluster, job_name, task_index)`` as the reference's.
A worker's constructor brings up the ``torch.distributed`` process group through :mod:`.distributed`: rank
``task_index`` of as many ranks as worker hosts, worker 0 the
rendezvous; one worker initializes nothing. A ``ps`` task's ``join()``
logs the no-PS notice and returns, so the reference's ``if job_name ==
"ps": server.join()`` pattern exits 0; a worker has nothing to join. The
profiler service (``profiler_port``) arrives with slice A3c-4b.
"""

from __future__ import annotations

import torch

from ..cluster import ClusterSpec, resolve_legacy_role
from ..utils.logging import get_logger
from . import distributed

log = get_logger("server")


class Server:
    """In-process runtime handle with the reference Server's surface.
    ``device`` picks the process group's backend (NCCL for ``cuda``, the
    default; gloo for ``cpu``) and ``init_method`` overrides worker 0's
    address as the rendezvous."""

    def __init__(self,
                 cluster: ClusterSpec | dict | None = None,
                 job_name: str = "worker",
                 task_index: int = 0,
                 profiler_port: int | None = None,
                 *,
                 device: str | torch.device | None = None,
                 init_method: str | None = None):
        self.cluster = (ClusterSpec(cluster) if cluster
                        and not isinstance(cluster, ClusterSpec)
                        else cluster)
        if profiler_port:
            raise NotImplementedError("the profiler service "
                                      "(--profiler_port) arrives with "
                                      "slice A3c-4b")
        self.role = resolve_legacy_role(self.cluster, job_name, task_index)
        self._context: distributed.DistributedContext | None = None
        if self.role.should_run:
            self._context = distributed.initialize(
                self.cluster, job_name, task_index, device=device,
                init_method=init_method)

    @property
    def context(self) -> distributed.DistributedContext | None:
        return self._context

    @property
    def target(self) -> str:
        """Session-target parity string: this process's coordinates."""
        idx = (self._context.process_index if self._context
               else self.role.process_index)
        return f"cuda://process/{idx}"

    def join(self) -> None:
        """A ps task logs the notice and returns; a worker has no service
        thread to wait on."""
        if not self.role.should_run:
            log.warning(self.role.notice)
