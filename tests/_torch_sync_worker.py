"""One rank of the port's N-rank sync step, for ``tests/test_torch_
distributed.py`` (imports no JAX).

    python tests/_torch_sync_worker.py --rank R --world W \\
        --init file:///tmp/rdv --bridge DIR --out OUT.npz [--mode auto] \\
        [--model mlp|resnet20] [--accum K] [--f64]

Joins a gloo group through ``--init``, restores the model's state from
the checkpoint in ``--bridge`` (``restore_or_init``: rank 0 decides and
broadcasts; before that a fresh init from a seed of each rank's own,
which rank 0's broadcast makes one), takes ``--steps`` steps on its
slice of each global batch (the MLP: SGD at lr 0.5, batches of 256
synthetic MNIST examples; ResNet-20: momentum SGD at lr 0.01, batches of
16 synthetic CIFAR images, batch norm over the global batch under
``auto`` and over the rank's under ``shard_map``), with ``--accum``
microbatches a step (the loader lays each rank's batch out in the sync
step's ``loader_microbatches``), and with ``--f64`` in f64 from the same
state (ResNet-20 only: compute and batch statistics in f64, the oracle
of f32 rounding); saves the final state into ``--ckpt`` (rank 0 writes)
and writes its per-step losses, accuracies and final params and extras
to ``--out``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (  # noqa: E402,E501
    CheckpointManager, restore_or_init, to_numpy)
from distributed_tensorflow_example_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, SyncConfig)
from distributed_tensorflow_example_tpu_torch.data.loader import \
    make_loader  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data.cifar import \
    synthetic_cifar10  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models import \
    get_model  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models import \
    resnet  # noqa: E402
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime import \
    distributed  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime.server import \
    Server  # noqa: E402
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer  # noqa: E402
from distributed_tensorflow_example_tpu_torch.utils.pytree import \
    tree_map  # noqa: E402

torch.set_num_threads(1)

#: model -> (global batch, the synthetic set, the optimizer)
SETUPS = {
    "mlp": (256, lambda: synthetic_mnist(2048, 64),
            OptimizerConfig(name="sgd", learning_rate=0.5)),
    "resnet20": (16, lambda: synthetic_cifar10(160, 8),
                 OptimizerConfig(name="momentum", learning_rate=0.01)),
}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--bridge", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", default="auto")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--model", default="mlp", choices=sorted(SETUPS))
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--f64", action="store_true")
    a = p.parse_args()
    global_batch, make_data, opt = SETUPS[a.model]

    server = Server({"worker": ["localhost:0"] * a.world}, "worker",
                    a.rank, device="cpu", init_method=a.init)
    ctx = server.context
    model = get_model(a.model)
    if a.f64:
        assert a.model == "resnet20", "--f64 is ResNet-20's"
        model = resnet.ResNet(
            "resnet20", resnet._BasicBlock, [3, 3, 3], [16, 32, 64], 10,
            32, False, dtype=torch.float64, bn_stats_dtype=torch.float64)
    tx = make_optimizer(opt)
    try:
        SyncReplicas(model.loss, tx, device="cpu",
                     sync=SyncConfig(replicas_to_aggregate=1))
        refused = ""
    except ValueError as e:
        refused = str(e)
    sync = SyncReplicas(model.loss, tx, device="cpu",
                        sync=SyncConfig(mode=a.mode, accum_steps=a.accum,
                                        replicas_to_aggregate=a.world))
    # a fresh init from a seed of each rank's own: rank 0's is broadcast
    fresh, _ = restore_or_init(CheckpointManager(a.ckpt + "_fresh"),
                               sync.init, model.init,
                               seed=7 + ctx.process_index)
    state, restored = restore_or_init(CheckpointManager(a.bridge),
                                      sync.init, model.init, seed=1)
    if a.f64:
        state = state.replace(**{part: tree_map(
            lambda t: t.double() if t.is_floating_point() else t,
            getattr(state, part)) for part in ("params", "extras",
                                               "opt_state")})
    data = make_data()
    batches = make_loader({"x": data["train_x"], "y": data["train_y"]},
                          global_batch, process_index=ctx.process_index,
                          num_processes=ctx.num_processes, seed=0,
                          microbatches=sync.loader_microbatches)
    losses, accs, norms = [], [], []
    for _ in range(a.steps):
        batch = next(batches)
        assert len(batch["y"]) == global_batch // a.world
        if a.f64:
            batch = dict(batch, x=batch["x"].astype(np.float64))
        state, m = sync.step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        norms.append(float(m["grad_norm"]))
    written = CheckpointManager(a.ckpt).save(state)
    out = to_numpy({"params": state.params, "extras": state.extras,
                    "fresh": fresh.params})
    np.savez(a.out, losses=np.asarray(losses), accs=np.asarray(accs),
             norms=np.asarray(norms), restored=np.asarray(restored),
             step=np.asarray(state.step),
             wrote=np.asarray(written is not None),
             refused=np.asarray(refused), rank=np.asarray(ctx.process_index),
             world=np.asarray(ctx.num_processes), **out)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
