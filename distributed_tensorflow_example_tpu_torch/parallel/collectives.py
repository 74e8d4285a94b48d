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


def reduce_scatter_mean(x: torch.Tensor, axis_name: AxisName, *,
                        scatter_axis: int = 0,
                        mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the axis, each member keeping its 1/N of it along
    ``scatter_axis``, over N (``lax.psum_scatter(tiled=True)`` / N): the
    fsdp gradient exchange (ZeRO)."""
    group, members, _ = _ctx(axis_name, mesh)
    n = len(members)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of shape {tuple(x.shape)} "
                         f"does not split over {n} members")
    if group is None:
        return x.clone() / n
    chunks = [c.movedim(scatter_axis, 0).contiguous()
              for c in x.chunk(n, dim=scatter_axis)]
    order = _by_group_rank(members)
    flat = torch.cat([chunks[m] for m in order])
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, scatter_axis) / n


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


def all_to_all(x: torch.Tensor, axis_name: AxisName, *, split_axis: int,
               concat_axis: int, tiled: bool = True,
               mesh: Mesh | None = None) -> torch.Tensor:
    """``lax.all_to_all``: ``x`` split along ``split_axis`` into one
    chunk a member, chunk ``j`` sent to member ``j``, the received
    chunks joined along ``concat_axis`` in member order. ``tiled``
    keeps the rank of ``x``; otherwise ``split_axis`` must equal the
    member count, is removed, and the members' slices stack on a new
    ``concat_axis``."""
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


def broadcast_one_to_all(x: torch.Tensor, axis_name: AxisName, *,
                         src: int = 0,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """Member ``src``'s value on every member of the axis."""
    group, members, _ = _ctx(axis_name, mesh)
    out = x.clone().contiguous()
    if group is not None:
        dist.broadcast(out, src=members[src], group=group)
    return out
