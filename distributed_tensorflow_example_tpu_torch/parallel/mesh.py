"""The logical mesh over the ranks of a ``torch.distributed`` group (port
of ``distributed_tensorflow_example_tpu/parallel/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` whose axes
name the parallelism dimensions. The port keeps the same axis vocabulary
and the same size rules, over ranks: one rank drives one card (or is one
gloo CPU process), and rank ``r`` sits at the row-major coordinates of
``r`` in the axis sizes, the order the reference's ``np.reshape`` of its
device list gives device ``r``.

========  =======================================================
axis      meaning
========  =======================================================
data      pure data parallelism (sync replicas)
fsdp      data parallelism with sharded params/optimizer state
model     tensor parallelism (activations/weights split)
seq       sequence/context parallelism (ring attention)
expert    MoE expert parallelism
pipe      pipeline-parallel stages
========  =======================================================

:func:`mesh_sizes` is the size logic alone (all ranks on ``data`` by
default, one ``-1`` wildcard, the reference's errors), a plain function
of the shape and the rank count. :func:`build_mesh` turns it into a
:class:`Mesh`: this rank's coordinates and, over an initialized process
group, one group for each set of axes wider than 1, which the named
collectives (:mod:`.collectives`) and the sharded step use. With one
rank and no process group it is a mesh of ones.
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from ..config import MeshShape


class AxisNames:
    DATA = "data"
    FSDP = "fsdp"
    MODEL = "model"
    SEQ = "seq"
    EXPERT = "expert"
    PIPE = "pipe"

    ALL: tuple[str, ...] = ("data", "fsdp", "model", "seq", "expert", "pipe")
    # Axes over which gradients are averaged (batch is split over these).
    BATCH: tuple[str, ...] = ("data", "fsdp")


# MeshConfig is the user-facing alias for the axis-size dataclass.
MeshConfig = MeshShape


def mesh_sizes(shape: MeshShape | dict | None, n: int) -> dict[str, int]:
    """The axis sizes ``shape`` asks for over ``n`` ranks: ``None`` puts
    every rank on ``data``; one axis of ``-1`` takes the ranks the others
    leave. Raises ValueError, as the reference's ``build_mesh`` does, for
    two wildcards, a count the known axes do not divide, or a total that
    is not ``n``."""
    if shape is None:
        shape = MeshShape(data=n)
    elif isinstance(shape, dict):
        shape = MeshShape(**shape)
    sizes = {a: int(getattr(shape, a)) for a in AxisNames.ALL}
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one -1 axis allowed, got {wild}")
    if wild:
        known = math.prod(s for s in sizes.values() if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[wild[0]] = n // known
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(
            f"mesh shape {sizes} wants {total} devices but {n} available")
    return sizes


def _canonical(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in AxisNames.ALL:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are "
                             f"{AxisNames.ALL}")
    return axes


class Mesh:
    """This rank's place in a mesh of ``world`` ranks.

    ``shape`` maps each axis (in :attr:`AxisNames.ALL` order) to its
    size; ``coords`` gives this rank's coordinate on each. For a set of
    axes, :meth:`members` lists the global ranks that share this rank's
    coordinates on every other axis, in the row-major order of the given
    axes (the order of ``lax.axis_index`` over that tuple), and
    :meth:`group` is their process group (None where the set holds this
    rank alone: the collectives are then the identity)."""

    def __init__(self, sizes: dict[str, int], rank: int = 0,
                 world: int = 1):
        self.shape = {a: int(sizes[a]) for a in AxisNames.ALL}
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not cover {world} "
                             "rank(s)")
        self.rank = int(rank)
        self.world = int(world)
        self.axis_names = AxisNames.ALL
        self.coords = self.coords_of(self.rank)
        self._groups: dict[frozenset, object] = {}

    def coords_of(self, rank: int) -> dict[str, int]:
        out, rest = {}, rank
        for a in reversed(AxisNames.ALL):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in AxisNames.ALL}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for a in AxisNames.ALL:
            r = r * self.shape[a] + coords[a]
        return r

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _canonical(axes))

    def members(self, axes, rank: int | None = None) -> list[int]:
        """Global ranks of the members of ``axes`` around ``rank`` (this
        rank by default), in member-index order."""
        axes = _canonical(axes)
        base = self.coords_of(self.rank if rank is None else rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def index(self, axes) -> int:
        """This rank's member index along ``axes`` (``lax.axis_index``)."""
        return self.members(axes).index(self.rank)

    def _enumerate(self, axes) -> list[list[int]]:
        """Every group of ``axes``: the sorted member lists of all ranks."""
        seen, out = set(), []
        for r in range(self.world):
            m = tuple(sorted(self.members(axes, r)))
            if m not in seen:
                seen.add(m)
                out.append(list(m))
        return out

    def create_groups(self) -> None:
        """One process group for each set of axes wider than 1 (every
        rank calls this in the same order: group creation is itself a
        collective); a set that spans every rank takes the world group."""
        if not dist.is_initialized():
            return
        wide = [a for a in AxisNames.ALL if self.shape[a] > 1]
        for k in range(1, len(wide) + 1):
            for axes in itertools.combinations(wide, k):
                key = frozenset(axes)
                if self.size(axes) == self.world:
                    self._groups[key] = dist.group.WORLD
                    continue
                mine, _ = dist.new_subgroups_by_enumeration(
                    self._enumerate(axes))
                self._groups[key] = mine

    def group(self, axes):
        """The process group of ``axes`` (None: this rank alone and no
        group to run on). A one-rank world with a process group runs
        every collective on the world group, so the backend is still
        exercised."""
        wide = frozenset(a for a in _canonical(axes) if self.shape[a] > 1)
        if not wide:
            return (dist.group.WORLD
                    if dist.is_initialized() and self.world == 1 else None)
        if wide not in self._groups:
            raise RuntimeError(f"no process group for axes {sorted(wide)}: "
                               "build the mesh with build_mesh over an "
                               "initialized process group")
        return self._groups[wide]

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({sizes}; rank {self.rank} of {self.world})"


#: the mesh the named collectives use when none is passed: the last one
#: :func:`build_mesh` built
_CURRENT: list[Mesh] = []
#: meshes by (sizes, world): every rank builds the same meshes in the
#: same order, so reusing one keeps the group creation in step
_CACHE: dict[tuple, Mesh] = {}


def build_mesh(shape: MeshShape | dict | None = None,
               n: int | None = None, *, rank: int | None = None) -> Mesh:
    """A :class:`Mesh` over ``n`` ranks (default: the process group's
    world, or 1 without one), this rank at ``rank`` (default: its rank
    in the group). Over an initialized group every set of wide axes gets
    its process group, so every rank must build the same meshes in the
    same order. The result becomes the collectives' current mesh."""
    live = dist.is_initialized()
    world = dist.get_world_size() if live else 1
    n = world if n is None else int(n)
    rank = (dist.get_rank() if live else 0) if rank is None else int(rank)
    sizes = mesh_sizes(shape, n)
    if live and n == world and rank == dist.get_rank():
        key = (tuple(sizes.items()), world, id(dist.group.WORLD))
        mesh = _CACHE.get(key)
        if mesh is None:
            mesh = Mesh(sizes, rank, n)
            mesh.create_groups()
            _CACHE[key] = mesh
    else:
        mesh = Mesh(sizes, rank, n)
    _CURRENT[:] = [mesh]
    return mesh


def forget_meshes() -> None:
    """Drop the built meshes and their process groups (the process group
    they were built over is being destroyed: a mesh built over a later
    one must create its groups anew)."""
    _CACHE.clear()
    _CURRENT.clear()


def current_mesh() -> Mesh:
    """The last mesh :func:`build_mesh` built (a mesh of ones over the
    process group's world when there is none yet)."""
    if not _CURRENT:
        return build_mesh()
    return _CURRENT[0]


def local_mesh(n: int | None = None,
               shape: MeshShape | dict | None = None) -> Mesh:
    """The reference's test helper: a mesh over this process's ranks."""
    return build_mesh(shape, n)


def mesh_axis_size(mesh: Mesh, *axes: str) -> int:
    """Product of the given axis sizes (e.g. the sync-replica count =
    size of the batch axes)."""
    return math.prod(mesh.shape[a] for a in axes)


def batch_axis_size(mesh: Mesh) -> int:
    return mesh_axis_size(mesh, *AxisNames.BATCH)
