"""``tf.train.Server`` parity handle for one process on one card (an
adapted copy of ``distributed_tensorflow_example_tpu/runtime/server.py``).

Constructed from ``(cluster, job_name, task_index)`` as the reference's:
a ``ps`` task's ``join()`` logs the no-PS notice and returns, so the
reference's ``if job_name == "ps": server.join()`` pattern exits 0; a
worker has nothing to join. A worker in a cluster of more than one
worker host, and the profiler service, arrive with slice A3c.
"""

from __future__ import annotations

from ..cluster import ClusterSpec, resolve_legacy_role
from ..utils.logging import get_logger

log = get_logger("server")


class Server:
    """In-process runtime handle with the reference Server's surface."""

    def __init__(self,
                 cluster: ClusterSpec | dict | None = None,
                 job_name: str = "worker",
                 task_index: int = 0,
                 profiler_port: int | None = None):
        self.cluster = (ClusterSpec(cluster) if cluster
                        and not isinstance(cluster, ClusterSpec)
                        else cluster)
        if profiler_port:
            raise NotImplementedError("the profiler service "
                                      "(--profiler_port) arrives with "
                                      "slice A3c")
        self.role = resolve_legacy_role(self.cluster, job_name, task_index)
        if self.role.should_run and self.role.num_processes > 1:
            raise NotImplementedError(
                f"a worker in a cluster of {self.role.num_processes} "
                "worker hosts (gradients all-reduced over "
                "torch.distributed) arrives with slice A3c; the port "
                "trains in one process on one card")

    @property
    def target(self) -> str:
        """Session-target parity string: this process's coordinates."""
        return f"cuda://process/{self.role.process_index}"

    def join(self) -> None:
        """A ps task logs the notice and returns; a worker has no service
        thread to wait on."""
        if not self.role.should_run:
            log.warning(self.role.notice)
