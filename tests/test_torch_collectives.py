"""The port's eight named collectives over gloo ranks against the JAX
package's under ``shard_map`` on the ``cpu8`` mesh.

One spawn of 2 ranks at (data=1, fsdp=2) and one of 4 at (data=2,
fsdp=2) (``tests/_torch_fsdp_worker.py``, no JAX) run every case: each
collective over every wide axis of the mesh and over the tuple of both
axes (at 4 ranks in both orders, so the member order of a tuple is the
reference's). Rank ``r`` takes the ``r``-th block of each input, as the
reference's device ``r`` does under ``P(AxisNames.ALL)``. The inputs are
small integers in f32, so sums and means over 2 or 4 members are exact
in both packages and every output is held bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.parallel import collectives as jc
from distributed_tensorflow_example_tpu.parallel.mesh import AxisNames
from distributed_tensorflow_example_tpu.parallel.mesh import \
    build_mesh as jbuild_mesh
from distributed_tensorflow_example_tpu_torch.parallel import \
    collectives as tc
from distributed_tensorflow_example_tpu_torch.parallel.mesh import \
    build_mesh
from test_torch_fsdp import load, run_ranks

torch.set_num_threads(1)

MESHES = {2: dict(data=1, fsdp=2), 4: dict(data=2, fsdp=2)}
AXES = {2: ["fsdp", ["data", "fsdp"]],
        4: ["data", "fsdp", ["data", "fsdp"], ["fsdp", "data"]]}
FNS = ("axis_size", "all_reduce_sum", "all_reduce_mean", "all_gather",
       "reduce_scatter_mean", "ppermute_ring_shift", "all_to_all",
       "broadcast_one_to_all")


def _size(mesh: dict, axes) -> int:
    axes = [axes] if isinstance(axes, str) else axes
    return int(np.prod([mesh.get(a, 1) for a in axes]))


def cases(world: int) -> list[dict]:
    out = []
    for axes in AXES[world]:
        n = _size(MESHES[world], axes)
        tag = axes if isinstance(axes, str) else "+".join(axes)

        def add(fn, kw=None, inp="x", suffix=""):
            out.append({"name": f"{fn}{suffix}@{tag}", "fn": fn,
                        "axes": axes, "kw": kw or {}, "input": inp})
        add("axis_size")
        add("all_reduce_sum")
        add("all_reduce_mean")
        add("all_gather", {"axis": 0, "tiled": True})
        add("all_gather", {"axis": 1, "tiled": False}, suffix="_stacked")
        add("reduce_scatter_mean", {"scatter_axis": 1})
        add("ppermute_ring_shift", {"shift": 1})
        add("ppermute_ring_shift", {"shift": -1}, suffix="_back")
        add("all_to_all", {"split_axis": 0, "concat_axis": 1,
                           "tiled": True})
        add("all_to_all", {"split_axis": 0, "concat_axis": 1,
                           "tiled": False}, inp=f"y{n}", suffix="_untiled")
        add("broadcast_one_to_all", {"src": n - 1})
    return out


def inputs(world: int) -> dict:
    rs = np.random.RandomState(world)
    return {"x": rs.randint(-8, 8, (world, 4, 8)).astype(np.float32),
            "y2": rs.randint(-8, 8, (world, 2, 3)).astype(np.float32),
            "y4": rs.randint(-8, 8, (world, 4, 3)).astype(np.float32)}


def reference(world: int, ins: dict) -> dict:
    """Each case under the reference's ``shard_map`` on ``world`` cpu8
    devices: {case name: [world, ...] outputs, device ``r`` at ``r``}."""
    mesh = jbuild_mesh(JMesh(**MESHES[world]),
                       devices=jax.devices("cpu")[:world])
    spec = JP(AxisNames.ALL)
    names = sorted(ins)
    todo = cases(world)

    def f(*blocks):          # every case in one program: one compile
        local = {k: b[0] for k, b in zip(names, blocks)}
        outs = []
        for case in todo:
            axes = case["axes"]
            axes = tuple(axes) if isinstance(axes, list) else axes
            x = local[case["input"]]
            if case["fn"] == "axis_size":
                y = jnp.asarray(jc.axis_size(axes), x.dtype)
            else:
                y = getattr(jc, case["fn"])(x, axes, **case["kw"])
            outs.append(y[None])
        return tuple(outs)
    ys = jc.shard_map(f, mesh=mesh, in_specs=(spec,) * len(names),
                      out_specs=(spec,) * len(todo), check_vma=False)(
        *(jnp.asarray(ins[k]) for k in names))
    return {c["name"]: np.asarray(y) for c, y in zip(todo, ys)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both world sizes' ranks spawned at once."""
    tmps = {w: tmp_path_factory.mktemp(f"coll{w}") for w in MESHES}

    def spawn(world):
        np.savez(tmps[world] / "inputs.npz", **inputs(world))
        run_ranks(world, [{"kind": "collectives", "name": "coll",
                           "mesh": MESHES[world],
                           "inputs": str(tmps[world] / "inputs.npz"),
                           "cases": cases(world)}], tmps[world])
    with ThreadPoolExecutor(len(MESHES)) as ex:
        list(ex.map(spawn, MESHES))
    return {w: (reference(w, inputs(w)),
                [load(tmps[w], "coll", r) for r in range(w)])
            for w in MESHES}


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("fn", FNS)
def test_collective_equals_the_reference_under_shard_map(runs, world, fn):
    want, ranks = runs[world]
    names = [c["name"] for c in cases(world) if c["fn"] == fn]
    assert names
    for name in names:
        for r, out in enumerate(ranks):
            got = out[f"out/{name}"]
            assert got.shape == want[name][r].shape, (name, r)
            np.testing.assert_array_equal(got, want[name][r],
                                          err_msg=f"{name} rank {r}")


def test_collectives_on_one_rank_are_the_identity():
    """Without a process group (one rank) every axis holds this rank
    alone: each collective returns its input's values (a copy) and the
    axis sizes are 1, as the reference's are on one device."""
    mesh = build_mesh(None, 1)
    x = torch.arange(12.0).reshape(3, 4)
    assert tc.axis_size(("data", "fsdp"), mesh=mesh) == 1
    for fn, kw in [("all_reduce_sum", {}), ("all_reduce_mean", {}),
                   ("all_gather", {"axis": 1}),
                   ("reduce_scatter_mean", {"scatter_axis": 0}),
                   ("ppermute_ring_shift", {"shift": 1}),
                   ("all_to_all", {"split_axis": 0, "concat_axis": 1}),
                   ("broadcast_one_to_all", {})]:
        y = getattr(tc, fn)(x, "data", mesh=mesh, **kw)
        assert torch.equal(y, x), fn
        assert y.data_ptr() != x.data_ptr(), fn
    stacked = tc.all_gather(x, "fsdp", axis=0, tiled=False, mesh=mesh)
    assert torch.equal(stacked, x[None])
