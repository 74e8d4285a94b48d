"""TrainState: the training state the sync step threads through (port of
``distributed_tensorflow_example_tpu/train/state.py``).

``params``, ``opt_state``, ``extras`` and ``anomaly_count`` are tensors on
the device. ``step`` is a host int: it advances by one every step, the
anomalous ones included, so the host knows it without a sync. The
reference carries a JAX PRNG key; the port carries ``seed``, from which
the sync step draws each step's dropout generator (the random streams
are not the reference's). Under a sharded mesh ``layout`` (a
``parallel.sharding.ShardLayout``) says which leaves are this rank's
pieces of the whole: its params and the per-parameter optimizer leaves
of a sharded parameter. It is None when every leaf is whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils.pytree import flatten_dict, tree_leaves


@dataclasses.dataclass
class TrainState:
    """Training state. ``anomaly_count`` (int32 scalar on the device)
    counts the steps whose loss or global grad-norm was not finite."""

    step: int
    params: dict
    opt_state: Any
    extras: Any                # non-trained model state ({} when unused)
    seed: int
    anomaly_count: torch.Tensor
    layout: Any = None         # ShardLayout of a sharded state, else None

    @classmethod
    def create(cls, *, params: dict, tx, extras: Any = None,
               seed: int = 0) -> "TrainState":
        """``tx.init`` over the flattened params (in ``flatten_dict``
        order, the order the sync step hands the optimizer)."""
        leaves = list(flatten_dict(params).values())
        dev = leaves[0].device if leaves else None
        return cls(step=0, params=params, opt_state=tx.init(leaves),
                   extras=extras or {}, seed=int(seed),
                   anomaly_count=torch.zeros((), dtype=torch.int32,
                                             device=dev))

    def replace(self, **kw: Any) -> "TrainState":
        return dataclasses.replace(self, **kw)


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def param_bytes(params) -> int:
    return sum(int(x.numel() * x.element_size())
               for x in tree_leaves(params))
