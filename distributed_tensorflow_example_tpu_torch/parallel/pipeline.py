"""Pipeline parallelism: GPipe microbatches over the ``pipe`` mesh axis
(port of ``distributed_tensorflow_example_tpu/parallel/pipeline.py``).

A stack of identical blocks (leaves ``[L, ...]``) is split over ``pipe``:
the rank at pipe coordinate ``p`` holds blocks ``[p L/P, (p + 1) L/P)``,
one stage. The rank's rows are split into M microbatches and all stages
run in lockstep for ``M + P - 1`` ticks: at tick ``t`` each stage applies
its blocks to its current input (stage 0 takes microbatch ``t``, the
others what their predecessor sent) and hands the result to the next
stage with one :func:`~.collectives.ppermute` hop. During the fill and
the drain a stage computes on zeros or on a clamped microbatch, the
GPipe bubble, as in the reference. The last stage's outputs are then
summed over ``pipe`` with the other stages' masked to zeros, so every
member holds them.

The reference gets the backward schedule from ``jax.grad`` through its
``scan``, ``ppermute`` and masked ``psum``. Here each of these is an
autograd Function whose backward is that transpose, and every rank runs
the same ticks on tensors of the same shapes, so the ranks meet in the
same collectives in the backward too:

- the hop (:func:`~.collectives.ppermute`): the gradient goes one stage
  back;
- the broadcast of the last stage's outputs
  (:func:`~.collectives.reduce_from`): summed forward, the gradient
  passed through backward (the last stage keeps it, the others' masked
  copies get zeros);
- the pipeline's input (:func:`~.collectives.copy_to`): only stage 0
  reads it, so its gradient is summed over ``pipe`` backward and every
  member gets the whole of it.

With that pair at both ends, a leaf that every stage holds whole (an
input or output projection, the embeddings, a head) gets the same
gradient on every ``pipe`` member, the gradient of the unsplit model: the
sync step averages such leaves over the batch ranks alone, and a block
piece's gradient over the batch ranks of its stage.

A rank holds its stage's pieces of the stacked params, as the sync step's
placement cut them (:func:`stage_params` cuts a whole stack the same
way), and its own rows of the batch, whole along every other dim unless
``x_specs`` splits one (PipeBert's PP x TP layout splits the sequence
over ``model``, the pipelined MoE-BERT's EP x PP layout the rows over
``expert``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..utils.pytree import tree_map
from . import collectives
from .mesh import AxisNames, Mesh
from .sharding import P

# stage_fn(stage_params, x, mb_idx) -> y with the same structure and
# shapes as x; the leading dim of every stage_params leaf is the stage's
# block count L/P. ``x`` is a tensor or a dict of them (a transformer
# stage threads activations and the attention mask together; passthrough
# leaves come back unchanged). ``mb_idx`` is the microbatch this tick
# computes (clamped in the fill and the drain): stages fold it into their
# dropout keys.
StageFn = Callable[[Any, Any, int], Any]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _zip_map(fn, *trees):
    """``fn`` over the leaves of trees of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def pipeline_spmd(stage_fn: StageFn, stage_params, microbatches, *,
                  axis_name: str = AxisNames.PIPE,
                  mesh: Mesh | None = None):
    """The GPipe schedule on this rank, every ``pipe`` member at once.

    Args:
      stage_fn: applies this stage's blocks to one microbatch.
      stage_params: this stage's pieces (leading dim ``L/P``).
      microbatches: tensors ``[M, mb, ...]`` (or a dict of them), the
        rank's rows split into M microbatches, the same on every member.

    Returns the same structure with the last stage's outputs, the same on
    every member.
    """
    mesh = mesh or collectives.current_mesh()
    n = collectives.axis_size(axis_name, mesh=mesh)
    me = mesh.index(axis_name)
    m = _leaves(microbatches)[0].shape[0]
    dev = _leaves(microbatches)[0].device
    first = torch.tensor(me == 0, device=dev)
    last = torch.tensor(me == n - 1, device=dev)
    # non-circular: stage i -> i + 1; stage 0 receives zeros (unused: it
    # always reads the microbatch queue)
    perm = [(r, r + 1) for r in range(n - 1)]

    def hop(y):
        return collectives.ppermute(y, axis_name, perm, mesh=mesh)

    recv = tree_map(lambda q: torch.zeros_like(q[0]), microbatches)
    outputs = []
    ticks = m + n - 1
    for t in range(ticks):
        # stage 0 takes microbatch t (clamped in the drain); the others
        # what their predecessor sent. torch.where keeps ``recv`` in
        # every rank's graph, so every rank runs the hop's backward
        x = _zip_map(lambda q, r: torch.where(first, q[min(t, m - 1)], r),
                     microbatches, recv)
        # stage ``me`` computes microbatch t - me at tick t
        y = stage_fn(stage_params, x, min(max(t - me, 0), m - 1))
        if t >= n - 1:                  # the last stage finished t-(n-1)
            outputs.append(y)
        if t < ticks - 1:               # the last tick's hop goes unused
            recv = tree_map(hop, y)
    stacked = _zip_map(lambda *ys: torch.stack(ys), *outputs)

    def broadcast(o):
        o = torch.where(last, o, torch.zeros_like(o))
        return collectives.reduce_from(o, axis_name, mesh=mesh)

    return tree_map(broadcast, stacked)


def stage_params(stacked, mesh: Mesh, *, pipe_axis: str = AxisNames.PIPE):
    """This rank's stage of a whole stack: the ``[L/P, ...]`` block of
    every leaf at its ``pipe`` coordinate (the placement the sync step
    gives ``P(pipe)``). Raises ValueError when L does not split."""
    n = mesh.shape[pipe_axis]
    L = _leaves(stacked)[0].shape[0]
    if L % n:
        raise ValueError(
            f"block count {L} not divisible by pipe axis size {n}")
    i = mesh.coords[pipe_axis]
    return tree_map(lambda a: a.chunk(n, dim=0)[i], stacked)


def make_pipeline(mesh: Mesh, stage_fn: StageFn, *,
                  num_microbatches: int,
                  pipe_axis: str = AxisNames.PIPE,
                  batch_axes=AxisNames.BATCH,
                  param_specs=None, x_specs=None):
    """Bind a mesh -> ``apply(stage_params, x) -> y`` pipelined over
    ``pipe``.

    ``stage_params`` are this rank's pieces of the stacked params (leading
    dim ``L/P``); ``param_specs`` (the reference's per-leaf specs, which
    must keep ``pipe`` on the leading dim) are checked against that. ``x``
    is the rank's rows; ``x_specs`` (a spec a leaf of ``x``, default
    ``P(batch_axes)``) may split a dim of a leaf over another axis (the
    rows too, over an axis beyond ``batch_axes``): the pipeline then runs
    on this rank's block of it (:func:`~.collectives.split_along`) and
    joins the output blocks (:func:`~.collectives.gather_along`), the
    Megatron sequence-parallel layout of PipeBert under PP x TP, and the
    rows over ``expert`` of the pipelined MoE-BERT under EP x PP.
    """
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    batch = (batch_axes,) if isinstance(batch_axes, str) \
        else tuple(batch_axes)

    def splits(spec) -> list[tuple[int, str]]:
        """(dim, axis) of each split a spec makes beyond the batch."""
        out = []
        for i, s in enumerate(spec or ()):
            if s is None:
                continue
            axes = s if isinstance(s, tuple) else (s,)
            for a in axes:
                if a not in batch and mesh.shape[a] > 1:
                    out.append((i, a))
        return out

    def apply(stage_params_, x):
        if param_specs is not None:
            for spec in _leaves(param_specs):
                if not spec or spec[0] != pipe_axis:
                    raise ValueError(f"param spec {spec} must keep "
                                     f"{pipe_axis} on the leading dim")
        specs = (x_specs if x_specs is not None
                 else tree_map(lambda _: P(batch_axes), x))
        b = _leaves(x)[0].shape[0]
        for d, ax in splits(_leaves(specs)[0]):
            if d == 0:
                b //= mesh.shape[ax]
        if b % num_microbatches:
            raise ValueError(
                f"per-shard batch {b} not divisible by "
                f"num_microbatches={num_microbatches}")

        def enter(a, spec):
            a = collectives.copy_to(a, pipe_axis, mesh=mesh)
            for d, ax in splits(spec):
                a = collectives.split_along(a, ax, dim=d, mesh=mesh)
            return a.reshape((num_microbatches, b // num_microbatches)
                             + tuple(a.shape[1:]))

        def leave(a, spec):
            a = a.reshape((b,) + tuple(a.shape[2:]))
            for d, ax in reversed(splits(spec)):
                a = collectives.gather_along(a, ax, dim=d, mesh=mesh)
            return a

        mb = _zip_map(enter, x, specs)
        out = pipeline_spmd(stage_fn, stage_params_, mb,
                            axis_name=pipe_axis, mesh=mesh)
        return _zip_map(leave, out, specs)

    return apply


def sequential_blocks(stage_fn: StageFn, stacked_params, x, *,
                      num_microbatches: int = 1, first_microbatch: int = 0):
    """The unsplit oracle: ALL stacked blocks in order on one rank (what
    the pipeline computes, minus the pipelining), with the same
    microbatch split, so microbatch-keyed dropout draws alike. The
    unbound pipe models' path and the tests' parity target. The
    microbatches are numbered from ``first_microbatch`` (a rank that
    holds later microbatches of a global batch)."""
    b = _leaves(x)[0].shape[0]
    if not isinstance(b, int):
        # a symbolic batch (an export's dynamic dim): the split needs a
        # concrete size; the exporter takes its static-batch route
        raise TypeError(
            f"microbatch split needs a concrete batch size, got "
            f"symbolic {b!r}")
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches={num_microbatches}")
    if num_microbatches == 1:
        return stage_fn(stacked_params, x, first_microbatch)
    parts = [stage_fn(stacked_params,
                      tree_map(lambda a, i=i: a.chunk(num_microbatches)[i],
                               x), first_microbatch + i)
             for i in range(num_microbatches)]
    return _zip_map(lambda *ys: torch.cat(ys), *parts)
