"""Named collectives over the axes of a :class:`~.mesh.Mesh` (port of
``distributed_tensorflow_example_tpu/parallel/collectives.py``).

The reference's veneer over ``jax.lax`` runs inside ``shard_map``, where
an axis name stands for the devices along it. Here each rank calls the
same function eagerly and the axis name picks the rank's process group
along that axis (one name or a tuple of names), over
``torch.distributed``: NCCL for CUDA tensors and gloo for the CPU, the
backend :func:`~..runtime.distributed.initialize` chose. Each function
has the reference's semantics for the member order of its axes (the
row-major order of the tuple, ``lax.axis_index``'s). Along an axis that
holds this rank alone each is the identity (a copy); a one-rank world
with a process group still runs the backend's call.

All functions take ``axis_name`` (one of
:class:`~.mesh.AxisNames` or a tuple of them) and an optional ``mesh``
(default: the last one :func:`~.mesh.build_mesh` built).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .mesh import AxisNames, Mesh, current_mesh

AxisName = Any  # str | tuple[str, ...]


def _ctx(axis_name: AxisName, mesh: Mesh | None):
    """(group, members in member order, this rank's member index)."""
    mesh = mesh or current_mesh()
    members = mesh.members(axis_name)
    return mesh.group(axis_name), members, members.index(mesh.rank)


def _by_group_rank(members: list[int]) -> list[int]:
    """Member indices in the order of their group ranks (a torch group
    ranks its members by their global rank)."""
    return sorted(range(len(members)), key=lambda m: members[m])


def axis_size(axis_name: AxisName, *, mesh: Mesh | None = None) -> int:
    return len((mesh or current_mesh()).members(axis_name))


def all_reduce_sum(x: torch.Tensor, axis_name: AxisName, *,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the axis (``lax.psum``)."""
    group, _, _ = _ctx(axis_name, mesh)
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, axis_name: AxisName, *,
                    mesh: Mesh | None = None) -> torch.Tensor:
    """Mean over the axis (``lax.pmean``): the sync-DP gradient
    exchange."""
    return all_reduce_sum(x, axis_name, mesh=mesh) / axis_size(
        axis_name, mesh=mesh)


def _gather(x: torch.Tensor, group, members: list[int]) -> list:
    """Every member's ``x``, in member order."""
    if group is None:
        return [x.clone()]
    got = [torch.empty_like(x) for _ in members]
    dist.all_gather(got, x.contiguous(), group=group)
    order = _by_group_rank(members)
    out: list = [None] * len(members)
    for g, m in enumerate(order):
        out[m] = got[g]
    return out


def all_gather(x: torch.Tensor, axis_name: AxisName, *, axis: int = 0,
               tiled: bool = True,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Every member's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new axis there (``lax.all_gather``). The fsdp
    parameter gather."""
    group, members, _ = _ctx(axis_name, mesh)
    parts = _gather(x, group, members)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def _exchange(chunks: list[torch.Tensor], group,
              members: list[int]) -> list[torch.Tensor]:
    """Send ``chunks[m]`` to member ``m``; return what each member sent
    here, in member order (one ``all_to_all_single``)."""
    if group is None:
        return [chunks[0].clone()]
    order = _by_group_rank(members)
    send = torch.cat([chunks[m].contiguous().reshape(-1) for m in order])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out: list = [None] * len(members)
    for g, piece in enumerate(recv.chunk(len(members))):
        out[order[g]] = piece.view(chunks[order[g]].shape)
    return out


def reduce_scatter_sum(x: torch.Tensor, axis_name: AxisName, *,
                       dim: int = 0,
                       mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.psum_scatter(x, axis_name, scatter_dimension=dim,
    tiled=True)``: the members' ``x`` summed, each keeping its block
    along ``dim`` (no autograd)."""
    group, members, _ = _ctx(axis_name, mesh)
    n = len(members)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split over {n} members")
    if group is None:
        return x.clone()
    chunks = [c.movedim(dim, 0).contiguous() for c in x.chunk(n, dim=dim)]
    order = _by_group_rank(members)
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter_tensor(out, torch.cat([chunks[m] for m in order]),
                               op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def reduce_scatter_mean(x: torch.Tensor, axis_name: AxisName, *,
                        scatter_axis: int = 0,
                        mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the axis, each member keeping its 1/N of it along
    ``scatter_axis``, over N (``lax.psum_scatter(tiled=True)`` / N): the
    fsdp gradient exchange (ZeRO)."""
    return reduce_scatter_sum(x, axis_name, dim=scatter_axis,
                              mesh=mesh) / axis_size(axis_name, mesh=mesh)


def ppermute_ring_shift(x: torch.Tensor, axis_name: AxisName, *,
                        shift: int = 1,
                        mesh: Mesh | None = None) -> torch.Tensor:
    """Rotate values around the axis ring: member ``i``'s ``x`` goes to
    member ``i + shift`` (``lax.ppermute``), by one send and one receive
    a rank. Over a tuple of axes the ring runs in the mesh's axis order
    whatever the tuple's order, as the reference's does."""
    if not isinstance(axis_name, str):
        axis_name = tuple(a for a in AxisNames.ALL if a in axis_name)
    _, members, i = _ctx(axis_name, mesh)
    n = len(members)
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), members[(i + shift) % n]),
           dist.P2POp(dist.irecv, out, members[(i - shift) % n])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, axis_name: AxisName, split_axis: int,
                concat_axis: int, tiled: bool, mesh) -> torch.Tensor:
    group, members, _ = _ctx(axis_name, mesh)
    n = len(members)
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"dim {split_axis} of shape {tuple(x.shape)} "
                             f"does not split over {n} members")
        chunks = list(x.chunk(n, dim=split_axis))
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"untiled all_to_all needs dim {split_axis} "
                             f"of size {n}, got {tuple(x.shape)}")
        chunks = list(x.unbind(split_axis))
    got = _exchange(chunks, group, members)
    return (torch.cat(got, dim=concat_axis) if tiled
            else torch.stack(got, dim=concat_axis))


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` forward; backward, the same exchange with the split
    and concat axes swapped (JAX's transpose of ``lax.all_to_all``)."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, tiled, mesh):
        ctx.args = (axis_name, split_axis, concat_axis, tiled, mesh)
        return _all_to_all(x, axis_name, split_axis, concat_axis, tiled,
                           mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, tiled, mesh = ctx.args
        return (_all_to_all(g.contiguous(), axis_name, concat_axis,
                            split_axis, tiled, mesh),
                None, None, None, None, None)


def all_to_all(x: torch.Tensor, axis_name: AxisName, *, split_axis: int,
               concat_axis: int, tiled: bool = True,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.all_to_all``: ``x`` split along ``split_axis`` into one
    chunk a member, chunk ``j`` sent to member ``j``, the received
    chunks joined along ``concat_axis`` in member order. ``tiled``
    keeps the rank of ``x``; otherwise ``split_axis`` must equal the
    member count, is removed, and the members' slices stack on a new
    ``concat_axis``. Differentiable: the gradient goes back through the
    exchange with the two axes swapped (the expert-parallel token
    exchange and its return). Every member of the axis must call it
    (and its backward) alike."""
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled,
                           mesh or current_mesh())


def broadcast_one_to_all(x: torch.Tensor, axis_name: AxisName, *,
                         src: int = 0,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """Member ``src``'s value on every member of the axis."""
    group, members, _ = _ctx(axis_name, mesh)
    out = x.clone().contiguous()
    if group is not None:
        dist.broadcast(out, src=members[src], group=group)
    return out


# ---------------------------------------------------------------------------
# the collectives the reference calls inside its shard_map bodies, each an
# autograd Function whose backward is the collective JAX transposes it to
# ---------------------------------------------------------------------------

def _ppermute(x: torch.Tensor, axis_name: AxisName, perm,
              mesh) -> torch.Tensor:
    """``lax.ppermute`` with a pair list, no autograd: member ``src``'s
    ``x`` goes to member ``dst`` for each ``(src, dst)`` in ``perm``; a
    member that no pair sends to receives zeros. One
    ``batch_isend_irecv`` a rank, so a member with nothing to send or to
    receive issues nothing and waits on nothing."""
    _, members, i = _ctx(axis_name, mesh)
    n = len(members)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= a < n for a in srcs + dsts):
        raise ValueError(f"ppermute pairs {perm} are not a partial "
                         f"permutation of {n} members")
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in perm:
        if s == i and d == i:
            out.copy_(x)
        elif s == i:
            ops.append(dist.P2POp(dist.isend, x, members[d]))
        elif d == i:
            ops.append(dist.P2POp(dist.irecv, out, members[s]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """``ppermute`` forward; the inverse permutation backward."""

    @staticmethod
    def forward(ctx, x, axis_name, perm, mesh):
        ctx.args = (axis_name, tuple(perm), mesh)
        return _ppermute(x, axis_name, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, perm, mesh = ctx.args
        back = [(d, s) for s, d in perm]
        return _ppermute(g, axis_name, back, mesh), None, None, None


def ppermute(x: torch.Tensor, axis_name: AxisName, perm, *,
             mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, perm)``: ``perm`` a list of (source,
    destination) member pairs, not necessarily circular; a member that
    no pair sends to receives zeros. Differentiable: the gradient goes
    back along the inverse pairs. Every member of the axis must call it
    (and its backward) with the same pairs."""
    return _PPermute.apply(x, axis_name, [tuple(p) for p in perm],
                           mesh or current_mesh())


def _block(x: torch.Tensor, axis_name: AxisName, dim: int, mesh):
    """This member's block of ``x`` along ``dim``."""
    _, members, i = _ctx(axis_name, mesh)
    n = len(members)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not "
                         f"split over {n} members of {axis_name}")
    return x.chunk(n, dim=dim)[i]


class _GatherScatter(torch.autograd.Function):
    """``kind`` "sp_gather": all-gather forward, sum-reduce-scatter
    backward; "sp_scatter": the reverse (Megatron's sequence-parallel
    pair). "split": this member's block forward, all-gather backward;
    "join": all-gather forward, this member's block backward (the pair
    at the edge of a region that every member computes alike)."""

    @staticmethod
    def forward(ctx, x, kind, axis_name, dim, mesh):
        ctx.args = (kind, axis_name, dim, mesh)
        if kind in ("sp_gather", "join"):
            return all_gather(x, axis_name, axis=dim, tiled=True,
                              mesh=mesh)
        if kind == "sp_scatter":
            return reduce_scatter_sum(x, axis_name, dim=dim, mesh=mesh)
        return _block(x, axis_name, dim, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        kind, axis_name, dim, mesh = ctx.args
        g = g.contiguous()
        if kind == "sp_gather":
            out = reduce_scatter_sum(g, axis_name, dim=dim, mesh=mesh)
        elif kind in ("sp_scatter", "split"):
            out = all_gather(g, axis_name, axis=dim, tiled=True, mesh=mesh)
        else:
            out = _block(g, axis_name, dim, mesh).contiguous()
        return out, None, None, None, None


def sp_all_gather(x: torch.Tensor, axis_name: AxisName, *, dim: int,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.all_gather(x, axis_name, axis=dim, tiled=True)`` inside a
    block whose members each use the whole result on their own weight
    piece: the backward sums the members' partial gradients and gives
    each its block (``psum_scatter``, JAX's transpose)."""
    return _GatherScatter.apply(x, "sp_gather", axis_name, dim,
                                mesh or current_mesh())


def sp_reduce_scatter(x: torch.Tensor, axis_name: AxisName, *, dim: int,
                      mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.psum_scatter(x, axis_name, scatter_dimension=dim,
    tiled=True)``: the members' partial sums summed, each keeping its
    block along ``dim``; the backward all-gathers the gradient."""
    return _GatherScatter.apply(x, "sp_scatter", axis_name, dim,
                                mesh or current_mesh())


def split_along(x: torch.Tensor, axis_name: AxisName, *, dim: int,
                mesh: Mesh | None = None) -> torch.Tensor:
    """This member's block of ``x`` along ``dim``, where every member
    holds the same ``x`` (a replicated activation entering a region
    sharded over the axis); the backward all-gathers the members'
    gradient blocks, so the replicated producer sees the whole gradient
    on every member."""
    return _GatherScatter.apply(x, "split", axis_name, dim,
                                mesh or current_mesh())


def gather_along(x: torch.Tensor, axis_name: AxisName, *, dim: int,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """The members' blocks joined along ``dim`` (a sharded region's
    output entering code every member runs alike); the backward keeps
    this member's block of the gradient, which is the same on every
    member."""
    return _GatherScatter.apply(x, "join", axis_name, dim,
                                mesh or current_mesh())


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.args = (axis_name, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis_name, mesh = ctx.args
        return (all_reduce_sum(g.contiguous(), axis_name, mesh=mesh), None,
                None)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        return all_reduce_sum(x.contiguous(), axis_name, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, axis_name: AxisName, *,
            mesh: Mesh | None = None) -> torch.Tensor:
    """Identity forward; backward, the members' gradients summed: a value
    every member holds alike, of which each member uses a part (the
    pipeline's input, which only the first stage reads)."""
    return _CopyTo.apply(x, axis_name, mesh or current_mesh())


def reduce_from(x: torch.Tensor, axis_name: AxisName, *,
                mesh: Mesh | None = None) -> torch.Tensor:
    """The members' ``x`` summed forward (``lax.psum``); backward, the
    gradient passed to every member as it is (the pipeline's output,
    which the last stage alone contributes and every member then uses
    alike)."""
    return _ReduceFrom.apply(x, axis_name, mesh or current_mesh())


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.args = (axis_name, mesh)
        return all_reduce_mean(x.contiguous(), axis_name, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, mesh = ctx.args
        return (all_reduce_mean(g.contiguous(), axis_name, mesh=mesh), None,
                None)


def pmean(x: torch.Tensor, axis_name: AxisName, *,
          mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.pmean`` inside a ``shard_map`` body: the members' mean
    forward; backward, the members' mean of the cotangent (JAX's
    transpose of it). Statistics every member then reads alike (the
    expert-parallel routing statistics) get their gradient this way."""
    return _PMean.apply(x, axis_name, mesh or current_mesh())
