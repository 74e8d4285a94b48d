"""Parallelism layer of the port: the mesh over ranks, the named
collectives, the sharding rules, the tensor-parallel operators, the GPipe
pipeline over ``pipe``, ring attention over ``seq`` and the sync-replica
step (the reference's ``NamedSharding`` helpers, which need JAX's device
arrays, have no counterpart: a rank holds its pieces as plain tensors,
and ``tensor_parallel`` writes by hand what GSPMD inserts)."""

from .mesh import AxisNames, MeshConfig, build_mesh, local_mesh
from .collectives import (
    all_gather,
    all_reduce_mean,
    all_reduce_sum,
    all_to_all,
    copy_to,
    gather_along,
    ppermute,
    ppermute_ring_shift,
    reduce_from,
    reduce_scatter_mean,
    reduce_scatter_sum,
    sp_all_gather,
    sp_reduce_scatter,
    split_along,
)
from .pipeline import (make_pipeline, pipeline_spmd, sequential_blocks,
                       stage_params)
from .ring_attention import make_ring_attention, ring_attention_local
from .sharding import (
    ShardingRules,
    batch_pspec,
    replica_device_setter,
    shard_batch,
    shard_params,
    state_shardings,
)
from .sync_replicas import SyncReplicas, make_sync_train_step
from .tensor_parallel import (ModelAxis, copy_to_model, model_axis,
                              reduce_from_model, row_parallel_dense,
                              vocab_parallel_embedding)

__all__ = [
    "AxisNames", "MeshConfig", "build_mesh", "local_mesh",
    "all_gather", "all_reduce_mean", "all_reduce_sum", "all_to_all",
    "ppermute_ring_shift", "reduce_scatter_mean", "ppermute",
    "reduce_scatter_sum", "sp_all_gather", "sp_reduce_scatter",
    "split_along", "gather_along", "copy_to", "reduce_from",
    "make_pipeline", "pipeline_spmd", "sequential_blocks", "stage_params",
    "make_ring_attention", "ring_attention_local",
    "ShardingRules", "batch_pspec", "replica_device_setter", "shard_batch",
    "shard_params", "state_shardings",
    "SyncReplicas", "make_sync_train_step",
    "ModelAxis", "copy_to_model", "model_axis", "reduce_from_model",
    "row_parallel_dense", "vocab_parallel_embedding",
]
