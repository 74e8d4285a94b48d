"""Cluster topology: ``tf.train.ClusterSpec`` parity (an adapted copy of
``distributed_tensorflow_example_tpu/cluster.py``).

The reference CLI's ``--ps_hosts --worker_hosts --job_name --task_index``
still parse: ``worker`` task ``i`` is rank ``i`` of a ``torch.distributed``
group of as many ranks as worker hosts, with worker 0's address as the
rendezvous (:meth:`ClusterSpec.coordinator_address`), and a ``ps`` task
has no work (every worker keeps the parameters on its own card and the
gradients are all-reduced), so it exits 0 with a notice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

PS_JOB = "ps"
WORKER_JOB = "worker"


class ClusterSpec:
    """A jobs -> tasks -> address map with ``tf.train.ClusterSpec``'s
    access surface. Accepts ``{"job": ["host:port", ...]}`` or
    ``{"job": {index: addr}}``."""

    def __init__(self, cluster: "Mapping[str, Sequence[str] | Mapping[int, str]] | ClusterSpec"):
        if isinstance(cluster, ClusterSpec):
            self._jobs = {j: dict(t) for j, t in cluster._jobs.items()}
            return
        self._jobs: dict[str, dict[int, str]] = {}
        for job, tasks in dict(cluster).items():
            if isinstance(tasks, Mapping):
                self._jobs[job] = {int(i): str(a) for i, a in tasks.items()}
            else:
                self._jobs[job] = {i: str(a) for i, a in enumerate(tasks)}

    @property
    def jobs(self) -> list[str]:
        return sorted(self._jobs)

    def num_tasks(self, job_name: str) -> int:
        return len(self._jobs[job_name])

    def task_indices(self, job_name: str) -> list[int]:
        return sorted(self._jobs[job_name])

    def task_address(self, job_name: str, task_index: int) -> str:
        return self._jobs[job_name][task_index]

    def job_tasks(self, job_name: str) -> list[str]:
        tasks = self._jobs.get(job_name, {})
        return [tasks[i] for i in sorted(tasks)]

    def as_dict(self) -> dict[str, list[str]]:
        return {j: self.job_tasks(j) for j in self.jobs}

    def __bool__(self) -> bool:
        return bool(self._jobs)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ClusterSpec) and self.as_dict() == other.as_dict()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ClusterSpec({self.as_dict()!r})"

    @property
    def num_workers(self) -> int:
        return self.num_tasks(WORKER_JOB) if WORKER_JOB in self._jobs else 1

    @property
    def num_ps(self) -> int:
        return self.num_tasks(PS_JOB) if PS_JOB in self._jobs else 0

    def coordinator_address(self) -> str | None:
        """The rendezvous of the ``torch.distributed`` group: worker task
        0, the chief."""
        workers = self.job_tasks(WORKER_JOB) if WORKER_JOB in self._jobs \
            else []
        return workers[0] if workers else None


@dataclasses.dataclass(frozen=True)
class LegacyRole:
    """Resolution of a legacy ``--job_name/--task_index`` pair."""

    job_name: str
    task_index: int
    is_chief: bool          # worker task 0
    should_run: bool        # False for ps: exit 0 with the notice
    process_index: int
    num_processes: int
    notice: str | None = None


def resolve_legacy_role(cluster: ClusterSpec | None,
                        job_name: str = WORKER_JOB,
                        task_index: int = 0) -> LegacyRole:
    """Map the reference CLI onto process coordinates. ``ps`` tasks get
    ``should_run=False``; a worker index past the worker list raises."""
    if job_name == PS_JOB:
        return LegacyRole(
            job_name=job_name, task_index=task_index, is_chief=False,
            should_run=False, process_index=0,
            num_processes=(cluster.num_workers if cluster else 1),
            notice=(
                "No PS role on the card: every worker keeps the "
                "parameters and the optimizer state in its own card's "
                "memory and the workers all-reduce their gradients, so a "
                f"parameter server has nothing to hold. ps task "
                f"{task_index} exiting 0 (parity behavior)."))
    num = cluster.num_workers if cluster else 1
    if task_index >= num:
        raise ValueError(
            f"task_index {task_index} out of range for {num} worker tasks")
    return LegacyRole(
        job_name=job_name, task_index=task_index,
        is_chief=(task_index == 0), should_run=True,
        process_index=task_index, num_processes=num)
