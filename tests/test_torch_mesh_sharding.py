"""The port's mesh and sharding rules against the JAX package's
(``tests/test_mesh_sharding.py``'s cases, then every registered
transformer's param specs), on the CPU and without a process group: the
port's mesh is a function of the axis sizes and a rank, so each rank of
an 8-rank mesh is built here and held to the reference's device of the
same index on ``cpu8``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributed_tensorflow_example_tpu.config import MeshShape as JMesh
from distributed_tensorflow_example_tpu.config import \
    TrainConfig as JTrainConfig
from distributed_tensorflow_example_tpu.models import get_model as jget_model
from distributed_tensorflow_example_tpu.parallel import mesh as jmesh
from distributed_tensorflow_example_tpu.parallel import sharding as jsharding
from distributed_tensorflow_example_tpu.utils.pytree import path_str
from distributed_tensorflow_example_tpu_torch.config import (MeshShape,
                                                             TrainConfig)
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.parallel.mesh import (
    AxisNames, Mesh, batch_axis_size, build_mesh, local_mesh, mesh_sizes)
from distributed_tensorflow_example_tpu_torch.parallel.sharding import (
    P, ShardingRules, ShardLayout, batch_pspec, shard_batch, shard_params,
    state_shardings)
from distributed_tensorflow_example_tpu_torch.utils.pytree import \
    flatten_dict

torch.set_num_threads(1)


def ranks(shape, n=8) -> list[Mesh]:
    """Every rank's view of a mesh of ``n`` ranks."""
    sizes = mesh_sizes(shape, n)
    return [Mesh(sizes, r, n) for r in range(n)]


def test_default_mesh_all_data(cpu8):
    mesh = build_mesh(None, 8)
    ref = jmesh.build_mesh(devices=cpu8)
    assert mesh.shape[AxisNames.DATA] == 8 == ref.shape["data"]
    assert batch_axis_size(mesh) == 8 == jmesh.batch_axis_size(ref)
    assert mesh.axis_names == AxisNames.ALL == ref.axis_names
    assert dict(mesh.shape) == dict(ref.shape)


def test_mesh_wildcard_axis(cpu8):
    sizes = mesh_sizes({"data": -1, "model": 2}, 8)
    ref = jmesh.build_mesh({"data": -1, "model": 2}, devices=cpu8)
    assert sizes["data"] == 4 and sizes["model"] == 2
    assert sizes == dict(ref.shape)


def test_mesh_shape_mismatch_raises(cpu8):
    for shape in ({"data": 3}, {"data": -1, "model": -1},
                  {"data": -1, "fsdp": 3}):
        with pytest.raises(ValueError) as port:
            mesh_sizes(shape, 8)
        with pytest.raises(ValueError) as ref:
            jmesh.build_mesh(shape, devices=cpu8)
        assert str(port.value) == str(ref.value)


def test_local_mesh_subset():
    mesh = local_mesh(4)
    assert batch_axis_size(mesh) == 4 == jmesh.batch_axis_size(
        jmesh.local_mesh(4))
    assert mesh.world == 4 and mesh.rank == 0


def test_rank_coordinates_are_the_reference_device_order(cpu8):
    """Rank r sits where the reference's reshape puts device r: its
    member lists along each axis are the reference's device groups."""
    shape = {"data": 2, "fsdp": 2, "model": 2}
    ref = jmesh.build_mesh(shape, devices=cpu8)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    base = cpu8[0].id
    for mesh in ranks(shape):
        where = tuple(int(i[0]) for i in np.nonzero(ids - base == mesh.rank))
        assert tuple(mesh.coords[a] for a in AxisNames.ALL) == where
        assert mesh.members("fsdp") == [
            int(x) - base for x in ids[where[0], :, where[2]].reshape(-1)]


def test_batch_sharding_splits_leading_dim(cpu8):
    batch = {"x": np.arange(64, dtype=np.float32).reshape(16, 4)}
    ref = jsharding.shard_batch(jmesh.build_mesh(devices=cpu8), batch)
    by_dev = {s.device.id - cpu8[0].id: np.asarray(s.data)
              for s in ref["x"].addressable_shards}
    for mesh in ranks(None):
        got = shard_batch(mesh, batch)["x"]
        assert got.shape == (2, 4)
        np.testing.assert_array_equal(got, by_dev[mesh.rank])
    assert batch_pspec() == P(("data", "fsdp")) == tuple(
        jsharding.batch_pspec())


def test_sharding_rules_first_match_wins():
    rules = ShardingRules(rules=[
        (r"attn/.*kernel", P(None, "model")),
        (r"kernel", P()),
    ])
    assert rules.spec_for("layer0/attn/q/kernel", (64, 64)) == P(None,
                                                                 "model")
    assert rules.spec_for("layer0/mlp/kernel", (64, 64)) == P()


def test_fsdp_fallback_shards_largest_divisible_dim():
    rules = ShardingRules(fsdp_axis_size=4, fsdp_min_size=16)
    ref = jsharding.ShardingRules(fsdp_axis_size=4, fsdp_min_size=16)
    for path, shape in [("fc/kernel", (8, 12)), ("fc/bias", (10,)),
                        ("odd/kernel", (7, 9)), ("sq/kernel", (8, 8)),
                        ("cube", (4, 6, 8))]:
        assert tuple(rules.spec_for(path, shape)) == tuple(
            ref.spec_for(path, shape)), path
    assert rules.spec_for("fc/kernel", (8, 12)) == P(None, AxisNames.FSDP)
    assert rules.spec_for("fc/bias", (10,)) == P()
    assert rules.spec_for("odd/kernel", (7, 9)) == P()


def test_shard_params_fsdp_layout(cpu8):
    params = {"w": np.arange(512, dtype=np.float32).reshape(16, 32),
              "b": np.zeros((32,), np.float32)}
    rules = ShardingRules(fsdp_axis_size=8, fsdp_min_size=64)
    ref = jsharding.shard_params(
        jmesh.build_mesh({"fsdp": 8}, devices=cpu8), params,
        jsharding.ShardingRules(fsdp_axis_size=8, fsdp_min_size=64))
    by_dev = {s.device.id - cpu8[0].id: np.asarray(s.data)
              for s in ref["w"].addressable_shards}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for mesh in ranks({"fsdp": 8}):
        placed = shard_params(mesh, tparams, rules)
        assert tuple(placed["w"].shape) == (16, 4)
        assert tuple(placed["b"].shape) == (32,)
        np.testing.assert_array_equal(placed["w"].numpy(),
                                      by_dev[mesh.rank])


def test_state_shardings_strict_for_params_relaxed_for_derived(cpu8):
    """A rule-matched PARAM whose dim does not divide the axis is a loud
    placement error; the same mismatch on a DERIVED opt-state leaf
    relaxes to replicated; a divisible param places normally — as in the
    reference."""
    mesh = ranks({"data": 2, "model": 4})[0]
    jm = jmesh.local_mesh(8, {"data": 2, "model": 4})
    rules = ShardingRules(rules=[(r"kernel", P(None, "model"))])
    jrules = jsharding.ShardingRules(rules=[(r"kernel", JP(None, "model"))])
    bad = {"params": {"layer": {"kernel": (4, 6)}}}
    with pytest.raises(ValueError, match="does not fit param"):
        state_shardings(mesh, bad, rules)
    with pytest.raises(ValueError, match="does not fit param"):
        jsharding.state_shardings(
            jm, {"params": {"layer": {"kernel": jnp.zeros((4, 6))}}},
            jrules)
    derived = {"opt_state": {"mu": {"layer": {"kernel": (4, 6)}}}}
    sh = state_shardings(mesh, derived, rules)
    assert sh["opt_state"]["mu"]["layer"]["kernel"] == P()
    assert jsharding.state_shardings(
        jm, {"opt_state": {"mu": {"layer": {"kernel": jnp.zeros((4, 6))}}}},
        jrules)["opt_state"]["mu"]["layer"]["kernel"].spec == JP()
    ok = state_shardings(mesh, {"params": {"layer": {"kernel": (4, 8)}}},
                         rules)
    assert ok["params"]["layer"]["kernel"] == P(None, "model")


def _port_params(name: str):
    m = get_model(name, TrainConfig(model=name))
    out = m.init(torch.Generator().manual_seed(0))
    return m, out[0] if isinstance(out, tuple) else out


def _ref_shapes(name: str):
    jm = jget_model(name, JTrainConfig(model=name))
    out = jax.eval_shape(jm.init, jax.random.key(0))
    return jm, out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("mesh", [dict(fsdp=2), dict(data=2, fsdp=4)],
                         ids=["fsdp2", "data2-fsdp4"])
@pytest.mark.parametrize("name", ["mlp", "gpt_tiny", "bert_tiny",
                                  "moe_bert_tiny"])
def test_model_tree_pspecs_equal_the_reference(name, mesh):
    """Each model's ``sharding_rules`` (the Megatron and expert rules
    carried as data, the fsdp fallback where ``model`` and ``expert``
    are 1) give every param the reference's spec."""
    tm, tparams = _port_params(name)
    jm, jparams = _ref_shapes(name)
    got = {k: tuple(v) for k, v in flatten_dict(
        tm.sharding_rules(MeshShape(**mesh)).tree_pspecs(tparams)).items()}
    want = {path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.sharding_rules(JMesh(**mesh)).tree_pspecs(jparams),
                is_leaf=lambda x: isinstance(x, JP))[0]}
    assert got == want
    assert any(s for s in got.values()), "nothing sharded"


TP_MESHES = [dict(model=2), dict(data=2, fsdp=2, model=2)]
TP_IDS = ["model2", "data2-fsdp2-model2"]


@pytest.mark.parametrize("mesh", TP_MESHES, ids=TP_IDS)
@pytest.mark.parametrize("name", ["gpt_tiny", "bert_tiny", "moe_bert_tiny"])
def test_tp_tree_pspecs_equal_the_reference(name, mesh):
    """With a ``model`` axis the transformers' Megatron rules (column q/k/v
    and FFN-in, row o and FFN-out, the vocab-split word table, BERT's
    ``mlm/bias``, the experts' columns) give every param the reference's
    spec, the fsdp fallback taking the unmatched leaves."""
    tm, tparams = _port_params(name)
    jm, jparams = _ref_shapes(name)
    got = {k: tuple(v) for k, v in flatten_dict(
        tm.sharding_rules(MeshShape(**mesh)).tree_pspecs(tparams)).items()}
    want = {path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.sharding_rules(JMesh(**mesh)).tree_pspecs(jparams),
                is_leaf=lambda x: isinstance(x, JP))[0]}
    assert got == want
    assert any(AxisNames.MODEL in s for s in got.values())


@pytest.mark.parametrize("name", ["gpt_tiny", "bert_tiny", "moe_bert_tiny"])
def test_shard_layout_bounds_equal_the_reference_shards(name, cpu8):
    """On (data=2, fsdp=2, model=2) each rank's ``ShardLayout`` piece of
    every param (its bounds, over ``fsdp`` or ``model``) is the block
    the reference places on the device of the same index, and the rank
    writes it in a sharded save exactly where the reference's
    ``replica_id`` is 0."""
    shape = dict(data=2, fsdp=2, model=2)
    tm, tparams = _port_params(name)
    jm, _ = _ref_shapes(name)
    arrays = {k: v.numpy() for k, v in flatten_dict(tparams).items()}
    placed = jsharding.shard_params(
        jmesh.build_mesh(shape, devices=cpu8),
        jax.tree_util.tree_map(np.asarray, _nest(arrays)),
        jm.sharding_rules(JMesh(**shape)))
    ref = {path_str(p): x for p, x in
           jax.tree_util.tree_flatten_with_path(placed)[0]}
    rules = tm.sharding_rules(MeshShape(**shape))
    for mesh in ranks(shape):
        layout = ShardLayout.for_params(mesh, tparams, rules)
        for k, x in ref.items():
            [s] = [s for s in x.addressable_shards
                   if s.device.id - cpu8[0].id == mesh.rank]
            want = tuple((sl.start or 0, x.shape[i] if sl.stop is None
                          else sl.stop) for i, sl in enumerate(s.index))
            assert layout.bounds(k) == want, (k, mesh.rank)
            assert layout.owns(k) == (s.replica_id == 0), (k, mesh.rank)
    assert layout.split_over(AxisNames.MODEL) and any(
        a == AxisNames.FSDP for sp in layout.splits.values() for _, a in sp)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out
