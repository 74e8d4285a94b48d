"""Parameter and batch placement (port of ``distributed_tensorflow_
example_tpu/parallel/sharding.py``): the ``replica_device_setter``
replacement.

The reference gives each parameter a ``PartitionSpec`` over the mesh by
path-pattern rules and lets XLA place it. The port keeps the rules as
data, the same first-match-wins order and the same fsdp fallback (the
largest evenly divisible dim of a leaf of at least ``fsdp_min_size``
elements, over ``fsdp``), and places explicitly: each rank keeps its own
contiguous piece of a sharded leaf (:func:`shard_params`,
:class:`ShardLayout`). A piece over ``fsdp`` is ZeRO-3's: the sync step
gathers the full leaf before the loss and reduce-scatters its gradient
after. A piece over ``model`` is Megatron's: the layers compute on it
(``parallel/tensor_parallel.py``) and it is never gathered in a step;
nor is a MoE layer's block of experts over ``expert`` (``ops/moe.py``)
or a stage's block of a pipe model's stack over ``pipe``
(``parallel/pipeline.py``).

Built-in policies:

- **replicated** (default): every rank holds the full params;
- **fsdp**: large params sharded over the ``fsdp`` axis;
- **rules**: explicit per-path specs (models attach these: GPT's and
  BERT's Megatron rules over ``model``, MoE-BERT's over ``expert``),
  carried as data. A spec splits a dim over one of ``fsdp``, ``model``,
  ``expert`` and ``pipe`` (the pipe models' stacked blocks over ``pipe``
  on their stage dim, and under PP x TP also over ``model`` on a kernel
  dim; MoE experts over ``expert`` on their expert dim, and under EP x
  TP also over ``model`` on a column dim). No rule places a parameter
  over ``seq`` (ring attention shards activations only, as in the
  reference).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..utils.pytree import flatten_dict, unflatten_dict
from . import collectives
from .mesh import AxisNames, Mesh

PyTree = Any


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a dim, an
    axis name, a tuple of axis names or None (not split)."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def batch_pspec(leading_extra: int = 0) -> P:
    """PartitionSpec for batch-leading arrays: batch dim split over the
    combined (data, fsdp) axes — the sync-replica data split."""
    return P(*([None] * leading_extra), AxisNames.BATCH)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> dict:
    """This rank's share of a global batch: the consecutive block of
    rows at its member index along the batch axes (the reference's
    sharded ``device_put`` of the global batch, seen from one rank)."""
    n = mesh.size(AxisNames.BATCH)
    i = mesh.index(AxisNames.BATCH)
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} of {k!r} does not "
                             f"split over {n} batch ranks")
        b = x.shape[0] // n
        out[k] = x[i * b:(i + 1) * b]
    return out


@dataclasses.dataclass
class ShardingRules:
    """Ordered (regex → PartitionSpec) placement rules with an fsdp fallback.

    ``rules`` are tried in order against the parameter's ``/``-joined path;
    first match wins. Unmatched params follow the fallback policy:
    replicated, or — when ``fsdp_axis_size > 1`` — sharded over ``fsdp``
    along the largest evenly-divisible dimension not already taken.
    """

    rules: Sequence[tuple[str, P]] = ()
    fsdp_axis_size: int = 1
    fsdp_min_size: int = 2 ** 12   # don't shard tiny params (biases, norms)

    def spec_for(self, path: str, shape: tuple[int, ...]) -> P:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        if self.fsdp_axis_size > 1 and int(np.prod(shape)) >= \
                self.fsdp_min_size:
            # numpy's stable argsort of the negated dims: the reference's
            # sorted(key=-shape[i]) order, ties to the lower dim
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % self.fsdp_axis_size == 0:
                    spec = [None] * len(shape)
                    spec[i] = AxisNames.FSDP
                    return P(*spec)
        return P()

    def tree_pspecs(self, params: PyTree) -> PyTree:
        """A spec for every leaf of a nested dict of tensors (or of
        arrays), keyed as the params are."""
        flat = flatten_dict(params)
        return unflatten_dict({k: self.spec_for(k, tuple(np.shape(v)))
                               for k, v in flat.items()})


def _axes_size(mesh: Mesh, axes) -> int:
    if isinstance(axes, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axes)
    return mesh.shape[axes]


def _fits(mesh: Mesh, spec: P, shape) -> bool:
    return len(spec) <= len(shape) and all(
        s is None or shape[i] % _axes_size(mesh, s) == 0
        for i, s in enumerate(spec))


def state_shardings(mesh: Mesh, state: Mapping[str, Any],
                    rules: ShardingRules | None = None) -> dict:
    """A spec for every leaf of a state, given as a nested dict (``params``,
    ``opt_state``, ...) of tensors, arrays or shapes: the rules apply to
    every non-scalar leaf's path. A spec that does not fit its leaf (an
    axis that does not divide the dim) is a loud error for a leaf under
    ``params`` and replication for derived state (adafactor's factored
    vectors), as the reference's ``state_shardings`` does."""
    rules = rules or ShardingRules(fsdp_axis_size=mesh.shape[AxisNames.FSDP])
    out = {}
    for pstr, x in flatten_dict(state).items():
        shape = tuple(x) if isinstance(x, (tuple, list)) else \
            tuple(np.shape(x))
        if len(shape) == 0:
            out[pstr] = P()
            continue
        s = rules.spec_for(pstr, shape)
        if not _fits(mesh, s, shape):
            if "params/" in pstr or pstr.startswith("params"):
                raise ValueError(
                    f"sharding rule spec {s} does not fit param "
                    f"{pstr!r} with shape {shape} (axis size must "
                    "divide the dim); fix the rule or the mesh shape")
            s = P()
        out[pstr] = s
    return unflatten_dict(out)


#: the axes a parameter piece may lie over
PLACEMENT_AXES = (AxisNames.FSDP, AxisNames.MODEL, AxisNames.EXPERT,
                  AxisNames.PIPE)
#: the axes whose pieces the layers compute on (the step binds its mesh
#: on the model): Megatron's over ``model``, a MoE layer's experts over
#: ``expert``, a stage's blocks over ``pipe``
BOUND_AXES = (AxisNames.MODEL, AxisNames.EXPERT, AxisNames.PIPE)


def _split(mesh: Mesh, spec: P) -> tuple[tuple[int, str], ...]:
    """The (dim, axis) of each dim a spec splits (empty: replicated). An
    axis of size 1 splits nothing. A dim split over two wide axes, an
    axis used twice, or a split over an axis that places no parameter
    here is refused, naming the cut."""
    found = []
    for i, s in enumerate(spec):
        axes = s if isinstance(s, tuple) else (s,)
        wide = [a for a in axes if a is not None and mesh.shape[a] > 1]
        if not wide:
            continue
        for a in wide:
            if a not in PLACEMENT_AXES:
                raise NotImplementedError(
                    f"spec {spec} splits over {a}: only fsdp, model, "
                    "expert and pipe place parameters")
        if len(wide) > 1:
            raise NotImplementedError(
                f"spec {spec} splits dim {i} over {wide}: one axis a dim")
        found.append((i, wide[0]))
    if len({a for _, a in found}) < len(found):
        raise NotImplementedError(f"spec {spec} splits two dims over one "
                                  "axis")
    return tuple(found)


class ShardLayout:
    """Where each parameter lives on this rank of a mesh: for each flat
    param key its global shape and the (dim, axis) of each dim it is
    split along (``splits``; empty: whole here), over ``fsdp``,
    ``model``, ``expert`` or ``pipe``: a pipe model's stacked block under
    PP x TP is split on its stage dim over ``pipe`` and on a kernel dim
    over ``model``, a MoE layer's experts under EP x TP over ``expert``
    and ``model``. A piece is the contiguous block at this rank's coordinate
    on each splitting axis. The per-parameter optimizer leaves of a
    parameter's shape (moments, traces, EMA shadows) follow it."""

    def __init__(self, mesh: Mesh, specs: Mapping[str, P],
                 shapes: Mapping[str, tuple]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        #: the (dim, axis) splits of each param, in dim order
        self.splits = {k: _split(mesh, s) for k, s in self.specs.items()}
        for k, sp in self.splits.items():
            for d, a in sp:
                if self.shapes[k][d] % mesh.shape[a]:
                    raise ValueError(f"param {k!r} shape {self.shapes[k]}: "
                                     f"dim {d} does not split over "
                                     f"{a}={mesh.shape[a]}")

    @classmethod
    def for_params(cls, mesh: Mesh, params: Mapping,
                   rules: ShardingRules) -> "ShardLayout":
        flat = flatten_dict(params)
        shapes = {k: tuple(v.shape) for k, v in flat.items()}
        specs = state_shardings(mesh, {"params": {k: s for k, s in
                                                  shapes.items()}},
                                rules)["params"]
        return cls(mesh, flatten_dict(specs), shapes)

    @property
    def sharded(self) -> bool:
        return any(self.splits.values())

    def split_over(self, axis: str) -> bool:
        """Whether some param is split over ``axis``."""
        return any(a == axis for sp in self.splits.values() for _, a in sp)

    @property
    def bound(self) -> bool:
        """Whether the layers compute on pieces (a split over ``model``,
        ``expert`` or ``pipe``): the step binds its mesh on the
        model."""
        return any(self.split_over(a) for a in BOUND_AXES)

    def size(self, key: str) -> int:
        """The number of pieces of param ``key`` (1: whole)."""
        return math.prod(self.mesh.shape[a] for _, a in self.splits[key])

    def bounds(self, key: str) -> tuple[tuple[int, int], ...]:
        """(start, stop) a dim of this rank's piece of param ``key``."""
        shape = self.shapes[key]
        out = [(0, s) for s in shape]
        for d, a in self.splits[key]:
            step = shape[d] // self.mesh.shape[a]
            c = self.mesh.coords[a]
            out[d] = (c * step, (c + 1) * step)
        return tuple(out)

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full leaf shaped as param ``key`` (a
        contiguous copy, so it owns its storage)."""
        if not self.splits[key]:
            return full
        for d, a in self.splits[key]:
            full = full.chunk(self.mesh.shape[a], dim=d)[self.mesh.coords[a]]
        return full.contiguous()

    def gather(self, key: str, piece: torch.Tensor, *,
               axes=None) -> torch.Tensor:
        """The full leaf of param ``key`` from every piece (an all-gather
        over each splitting axis, or over those of them in ``axes``;
        every rank must call it)."""
        for d, a in reversed(self.splits[key]):
            if axes is None or a in axes:
                piece = collectives.all_gather(piece, a, axis=d, tiled=True,
                                               mesh=self.mesh)
        return piece

    def owns(self, key: str) -> bool:
        """Whether this rank writes its piece of param ``key``: it sits
        at coordinate 0 on every axis that does not split the leaf (the
        reference's ``replica_id == 0``)."""
        split = {a for _, a in self.splits[key]}
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a not in split)

    def replica_axes(self, key: str) -> tuple[str, ...]:
        """The wide axes along which param ``key``'s piece is repeated
        (every wide axis but those that split it)."""
        split = {a for _, a in self.splits[key]}
        return tuple(a for a in AxisNames.ALL if self.mesh.shape[a] > 1
                     and a not in split)

    def shard_params(self, params: Mapping) -> dict:
        return unflatten_dict({k: self.local(k, v) for k, v in
                               flatten_dict(params).items()})

    def full_params(self, params: Mapping) -> dict:
        """The whole params from this rank's pieces, gathered over every
        axis (eval, export, monolithic saves, warm start)."""
        return unflatten_dict({k: self.gather(k, v) for k, v in
                               flatten_dict(params).items()})

    def step_params(self, params: Mapping) -> dict:
        """The params a step computes on: the ``fsdp`` pieces gathered
        whole, the ``model``, ``expert`` and ``pipe`` pieces left as they
        are (the layers compute on them)."""
        return unflatten_dict({
            k: self.gather(k, v, axes=(AxisNames.FSDP,))
            for k, v in flatten_dict(params).items()})

    def map_per_param(self, tree, fn: Callable[[str, torch.Tensor],
                                               torch.Tensor]):
        """``tree`` (an optimizer state) with ``fn(key, leaf)`` applied to
        every per-parameter leaf (the entries of its lists, one a param
        in ``flatten_dict`` order); other leaves unchanged."""
        keys = list(self.specs)
        if isinstance(tree, list):
            if len(tree) != len(keys):
                raise ValueError(f"{len(tree)} per-parameter leaves for "
                                 f"{len(keys)} parameters")
            return [fn(k, v) for k, v in zip(keys, tree)]
        if isinstance(tree, Mapping):
            out = {k: self.map_per_param(v, fn) for k, v in tree.items()}
            return out if type(tree) is dict else type(tree)(out)
        if isinstance(tree, tuple):
            return tuple(self.map_per_param(v, fn) for v in tree)
        return tree

    def leaf_shards(self, key: str, leaf: torch.Tensor) -> bool:
        """Whether a per-parameter optimizer leaf of param ``key`` is
        split with it: the param is sharded and the leaf has its shape
        (the full shape before sharding, the piece's after)."""
        if not self.splits[key]:
            return False
        full = self.shapes[key]
        piece = tuple(b - a for a, b in self.bounds(key))
        return tuple(leaf.shape) in (full, piece)


def shard_params(mesh: Mesh, params: PyTree,
                 rules: ShardingRules | None = None) -> PyTree:
    """This rank's pieces of ``params`` under the rules."""
    return replica_device_setter(mesh, rules)(params)


def replica_device_setter(mesh: Mesh,
                          rules: ShardingRules | None = None
                          ) -> Callable[[PyTree], PyTree]:
    """API-parity wrapper named after the reference's device function:
    ``place(params) -> params`` keeps this rank's piece of every leaf."""
    rules = rules or ShardingRules(fsdp_axis_size=mesh.shape[AxisNames.FSDP])

    def place(params: PyTree) -> PyTree:
        return ShardLayout.for_params(mesh, params, rules).shard_params(
            params)

    return place
