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
(``parallel/tensor_parallel.py``) and it is never gathered in a step.

Built-in policies:

- **replicated** (default): every rank holds the full params;
- **fsdp**: large params sharded over the ``fsdp`` axis;
- **rules**: explicit per-path specs (models attach these: GPT's and
  BERT's Megatron rules over ``model``, MoE-BERT's over ``expert``),
  carried as data. A spec splits at most one dim, over ``fsdp`` or
  ``model``; one that splits over ``seq``, ``expert`` or ``pipe`` is
  refused naming its slice (A6b, A6d, A6c).
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


#: the axes that do not place parameters in the port yet, and their
#: slices
LATER_PLACEMENT = {AxisNames.SEQ: "A6b", AxisNames.EXPERT: "A6d",
                   AxisNames.PIPE: "A6c"}
#: the axes a parameter piece may lie over
PLACEMENT_AXES = (AxisNames.FSDP, AxisNames.MODEL)


def _split(mesh: Mesh, spec: P) -> tuple[int | None, str | None]:
    """(dim, axis) a spec splits (``(None, None)``: replicated). An axis
    of size 1 splits nothing. A dim split over two wide axes, two split
    dims, or a split over an axis that places no parameter here is
    refused, naming the cut."""
    found = []
    for i, s in enumerate(spec):
        axes = s if isinstance(s, tuple) else (s,)
        wide = [a for a in axes if a is not None and mesh.shape[a] > 1]
        if not wide:
            continue
        for a in wide:
            if a in LATER_PLACEMENT:
                raise NotImplementedError(
                    f"spec {spec} splits over {a}: parameters placed over "
                    f"{a} arrive with slice {LATER_PLACEMENT[a]}")
            if a not in PLACEMENT_AXES:
                raise NotImplementedError(
                    f"spec {spec} splits over {a}: only fsdp and model "
                    "place parameters")
        if len(wide) > 1:
            raise NotImplementedError(
                f"spec {spec} splits dim {i} over {wide}: one axis a dim")
        found.append((i, wide[0]))
    if len(found) > 1:
        raise NotImplementedError(f"spec {spec} splits two dims")
    return found[0] if found else (None, None)


class ShardLayout:
    """Where each parameter lives on this rank of a mesh: for each flat
    param key its global shape, the dim it is split along and the axis
    it is split over, ``fsdp`` or ``model`` (None: whole here). A piece
    is the contiguous block at this rank's coordinate on its axis. The
    per-parameter optimizer leaves of a parameter's shape (moments,
    traces, EMA shadows) follow it."""

    def __init__(self, mesh: Mesh, specs: Mapping[str, P],
                 shapes: Mapping[str, tuple]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        split = {k: _split(mesh, s) for k, s in self.specs.items()}
        #: the split dim of each param (None: whole)
        self.dims = {k: d for k, (d, _) in split.items()}
        #: the axis each param is split over (None: whole)
        self.axes = {k: a for k, (_, a) in split.items()}
        for k, d in self.dims.items():
            if d is not None and self.shapes[k][d] % self.size(k):
                raise ValueError(f"param {k!r} shape {self.shapes[k]}: "
                                 f"dim {d} does not split over "
                                 f"{self.axes[k]}={self.size(k)}")

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
        return any(d is not None for d in self.dims.values())

    @property
    def model_sharded(self) -> bool:
        """Whether a param is split over ``model`` (the layers then
        compute on pieces: tensor parallelism)."""
        return AxisNames.MODEL in self.axes.values()

    def size(self, key: str) -> int:
        """The number of pieces of param ``key`` (1: whole)."""
        a = self.axes[key]
        return 1 if a is None else self.mesh.shape[a]

    def bounds(self, key: str) -> tuple[tuple[int, int], ...]:
        """(start, stop) a dim of this rank's piece of param ``key``."""
        shape, d = self.shapes[key], self.dims[key]
        out = [(0, s) for s in shape]
        if d is not None:
            step = shape[d] // self.size(key)
            c = self.mesh.coords[self.axes[key]]
            out[d] = (c * step, (c + 1) * step)
        return tuple(out)

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full leaf shaped as param ``key`` (a
        contiguous copy, so it owns its storage)."""
        d = self.dims[key]
        if d is None:
            return full
        return full.chunk(self.size(key), dim=d)[
            self.mesh.coords[self.axes[key]]].contiguous()

    def gather(self, key: str, piece: torch.Tensor) -> torch.Tensor:
        """The full leaf of param ``key`` from every piece (an all-gather
        over its axis; every rank must call it)."""
        d = self.dims[key]
        if d is None:
            return piece
        return collectives.all_gather(piece, self.axes[key], axis=d,
                                      tiled=True, mesh=self.mesh)

    def owns(self, key: str) -> bool:
        """Whether this rank writes its piece of param ``key``: it sits
        at coordinate 0 on every axis that does not split the leaf (the
        reference's ``replica_id == 0``)."""
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a != self.axes[key])

    def replica_axes(self, key: str) -> tuple[str, ...]:
        """The wide axes along which param ``key``'s piece is repeated
        (every wide axis but the one that splits it)."""
        return tuple(a for a in AxisNames.ALL if self.mesh.shape[a] > 1
                     and a != self.axes[key])

    def shard_params(self, params: Mapping) -> dict:
        return unflatten_dict({k: self.local(k, v) for k, v in
                               flatten_dict(params).items()})

    def full_params(self, params: Mapping) -> dict:
        """The whole params from this rank's pieces, gathered over both
        axes (eval, export, monolithic saves, warm start)."""
        return unflatten_dict({k: self.gather(k, v) for k, v in
                               flatten_dict(params).items()})

    def step_params(self, params: Mapping) -> dict:
        """The params a step computes on: the ``fsdp`` pieces gathered
        whole, the ``model`` pieces left as they are (the layers compute
        on them)."""
        return unflatten_dict({
            k: (self.gather(k, v) if self.axes[k] == AxisNames.FSDP else v)
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
        d = self.dims[key]
        if d is None:
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
