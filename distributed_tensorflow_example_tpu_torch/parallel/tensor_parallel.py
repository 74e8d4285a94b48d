"""Megatron tensor parallelism over the ``model`` axis: the port's
counterpart of what GSPMD inserts in the reference.

The reference places each leaf by its ``NamedSharding`` (the models'
rules: q/k/v and FFN-in kernels split by column, o and FFN-out by row,
the tied word table by vocab row) and lets XLA partition the program.
The port runs eagerly, so the models write the partitioned program by
hand with what this module holds:

- the conjugate pair that keeps replicated activations and their
  gradients equal on every ``model`` rank: :func:`copy_to_model`
  (identity forward, all-reduce-sum backward) at the input of each
  column-parallel block, :func:`reduce_from_model` (all-reduce-sum
  forward, identity backward) at the output of each row-parallel one;
- :func:`row_parallel_dense`: a row-parallel product's partial sums in
  f32, reduced over ``model``, rounded once to the compute dtype, then
  the replicated bias added once;
- :func:`vocab_parallel_embedding`: the lookup on a vocab piece (ids
  outside the rank's range give zeros, then the sum over ``model``);
- :class:`ModelAxis`: the rank's coordinate and the axis size, its head
  block and vocab range, and the collectives the vocab-parallel loss
  (``ops/losses.py``) combines its partial statistics with.

A model is bound to a mesh (``bind_mesh``, the reference's name) by the
step that computes on its pieces; :func:`model_axis` gives None over a
``model`` axis of size 1, and every function here is then the identity
and makes no collective call. Dropout stays on the full-width
(replicated) activations, where every ``model`` rank draws the same
masks from the step's key.
"""

from __future__ import annotations

import torch

from . import collectives
from .mesh import AxisNames, Mesh


class ModelAxis:
    """This rank's place on the ``model`` axis of ``mesh``: ``size``
    ranks, this one at ``index``; it holds the ``index``-th contiguous
    block of every split dim (a head block, a vocab range, an FFN
    column block)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.shape[AxisNames.MODEL]
        self.index = mesh.coords[AxisNames.MODEL]

    def local_heads(self, heads: int, leaf: str) -> int:
        """The head count of this rank's head block (``heads / size``;
        a ValueError naming ``leaf`` when the heads do not split: no
        kernel takes a split head)."""
        if heads % self.size:
            raise ValueError(
                f"{leaf}: heads={heads} do not split over model="
                f"{self.size} (a rank computes whole heads)")
        return heads // self.size

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.copy_to(x, AxisNames.MODEL, mesh=self.mesh)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.reduce_from(x, AxisNames.MODEL, mesh=self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading dim, in rank order
        along the axis (no gradient)."""
        return collectives.all_gather(x.detach(), AxisNames.MODEL, axis=0,
                                      tiled=False, mesh=self.mesh)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along its last dim (a vocab
        piece's logits into the whole vocab's; no gradient)."""
        return collectives.all_gather(x.detach(), AxisNames.MODEL,
                                      axis=x.ndim - 1, tiled=True,
                                      mesh=self.mesh)


def model_axis(mesh: Mesh | None) -> ModelAxis | None:
    """The ``model`` axis of ``mesh`` when it is wider than 1, else None
    (every function here is then the identity)."""
    if mesh is None or mesh.shape[AxisNames.MODEL] <= 1:
        return None
    return ModelAxis(mesh)


def copy_to_model(x: torch.Tensor, tp: ModelAxis | None) -> torch.Tensor:
    """The input of a column-parallel block: identity forward; backward,
    each rank's partial gradient of ``x`` summed over ``model``."""
    return x if tp is None else tp.copy_to_model(x)


def reduce_from_model(x: torch.Tensor,
                      tp: ModelAxis | None) -> torch.Tensor:
    """The output of a row-parallel block: each rank's partial sum summed
    over ``model``; backward, the gradient passed to every rank."""
    return x if tp is None else tp.reduce_from_model(x)


def row_parallel_partial(params, x: torch.Tensor, *,
                         dtype) -> torch.Tensor:
    """This rank's partial sum of a row-parallel product: ``x`` [..., K/M]
    against its rows ``W`` [K/M, N], operands in the compute ``dtype``,
    the result in f32."""
    kernel = params["kernel"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    return torch.matmul(x.float(), kernel.float())


def row_parallel_finish(params, total: torch.Tensor, *,
                        dtype) -> torch.Tensor:
    """The summed product rounded once to the compute ``dtype`` (f32
    when None) and the replicated bias added once."""
    y = total if dtype is None else total.to(dtype)
    return y + params["bias"].to(y.dtype)


def row_parallel_dense(params, x: torch.Tensor, *, dtype,
                       tp: ModelAxis) -> torch.Tensor:
    """``x @ W + b`` with ``x`` [..., K/M] and ``W`` [K/M, N] this rank's
    rows, ``b`` [N] replicated: the partial product in f32, summed over
    ``model`` in f32, rounded once to ``dtype`` and the bias added once
    (``ops/nn.dense``'s contract, the sum split over ranks)."""
    part = row_parallel_partial(params, x, dtype=dtype)
    return row_parallel_finish(params, reduce_from_model(part, tp),
                               dtype=dtype)


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor,
                             tp: ModelAxis | None) -> torch.Tensor:
    """Rows of a vocab-sharded table: this rank's ``table`` piece holds
    rows [start, start + V/M) of the whole; each rank looks up the ids in
    its range and puts zeros elsewhere, and the sum over ``model`` is the
    whole table's lookup (exact: one rank adds a row, the others zeros).
    Unsharded (``tp`` None), the plain lookup."""
    if tp is None:
        return table[ids]
    n = table.shape[0]
    start = tp.index * n
    local = ids - start
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = rows * inside[..., None].to(rows.dtype)
    return tp.reduce_from_model(rows)
