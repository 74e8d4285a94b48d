"""Parameter and batch placement (port of ``distributed_tensorflow_
example_tpu/parallel/sharding.py``): the ``replica_device_setter``
replacement.

The reference gives each parameter a ``PartitionSpec`` over the mesh by
path-pattern rules and lets XLA place it. The port keeps the rules as
data, the same first-match-wins order and the same fsdp fallback (the
largest evenly divisible dim of a leaf of at least ``fsdp_min_size``
elements, over ``fsdp``), and places explicitly, as ZeRO-3 does: each
rank keeps its own contiguous piece of a sharded leaf
(:func:`shard_params`, :class:`ShardLayout`), and the sync step gathers
the full leaf before the loss and reduce-scatters its gradient after.

Built-in policies:

- **replicated** (default): every rank holds the full params;
- **fsdp**: large params sharded over the ``fsdp`` axis;
- **rules**: explicit per-path specs (models attach these: GPT's and
  BERT's Megatron rules over ``model``, MoE-BERT's over ``expert``),
  carried as data; the port's step refuses a ``model`` or ``expert``
  axis wider than 1, so with both at 1 the rules come down to the fsdp
  fallback, as the reference's do.
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


def _sharded_dim(mesh: Mesh, spec: P) -> int | None:
    """The dim a spec splits over ``fsdp`` (None: replicated). An axis
    of size 1 splits nothing; only the fsdp axis places parameters in
    the port, and any other wide axis in a spec is refused."""
    dims = []
    for i, s in enumerate(spec):
        axes = s if isinstance(s, tuple) else (s,)
        wide = [a for a in axes if a is not None and mesh.shape[a] > 1]
        if not wide:
            continue
        if wide != [AxisNames.FSDP]:
            raise NotImplementedError(
                f"spec {spec} splits over {wide}: only the fsdp axis "
                "places parameters in the port (Megatron TP is slice "
                "A6a-2, expert parallelism A6d)")
        dims.append(i)
    if len(dims) > 1:
        raise NotImplementedError(f"spec {spec} splits two dims")
    return dims[0] if dims else None


class ShardLayout:
    """Where each parameter lives on this rank of a mesh: for each flat
    param key its global shape and the dim split over ``fsdp`` (None:
    replicated). A sharded leaf's piece here is the contiguous block at
    this rank's fsdp coordinate. The per-parameter optimizer leaves of
    a parameter's shape (moments, traces, EMA shadows) follow it."""

    def __init__(self, mesh: Mesh, specs: Mapping[str, P],
                 shapes: Mapping[str, tuple]):
        self.mesh = mesh
        self.n = mesh.shape[AxisNames.FSDP]
        self.specs = dict(specs)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.dims = {k: _sharded_dim(mesh, s)
                     for k, s in self.specs.items()}
        for k, d in self.dims.items():
            if d is not None and self.shapes[k][d] % self.n:
                raise ValueError(f"param {k!r} shape {self.shapes[k]}: "
                                 f"dim {d} does not split over fsdp="
                                 f"{self.n}")

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

    def flags(self) -> list[bool]:
        """One flag a param, in ``flatten_dict`` order: sharded or not."""
        return [d is not None for d in self.dims.values()]

    def bounds(self, key: str) -> tuple[tuple[int, int], ...]:
        """(start, stop) a dim of this rank's piece of param ``key``."""
        shape, d = self.shapes[key], self.dims[key]
        out = [(0, s) for s in shape]
        if d is not None:
            step = shape[d] // self.n
            f = self.mesh.coords[AxisNames.FSDP]
            out[d] = (f * step, (f + 1) * step)
        return tuple(out)

    def local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full leaf shaped as param ``key`` (a
        contiguous copy, so it owns its storage)."""
        d = self.dims[key]
        if d is None:
            return full
        return full.chunk(self.n, dim=d)[
            self.mesh.coords[AxisNames.FSDP]].contiguous()

    def gather(self, key: str, piece: torch.Tensor) -> torch.Tensor:
        """The full leaf of param ``key`` from every fsdp member's piece
        (an all-gather over ``fsdp``; every rank must call it)."""
        d = self.dims[key]
        if d is None:
            return piece
        return collectives.all_gather(piece, AxisNames.FSDP, axis=d,
                                      tiled=True, mesh=self.mesh)

    def shard_params(self, params: Mapping) -> dict:
        return unflatten_dict({k: self.local(k, v) for k, v in
                               flatten_dict(params).items()})

    def full_params(self, params: Mapping) -> dict:
        return unflatten_dict({k: self.gather(k, v) for k, v in
                               flatten_dict(params).items()})

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
