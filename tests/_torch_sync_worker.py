"""One rank of the port's N-rank sync step, for ``tests/test_torch_
distributed.py`` (imports no JAX).

    python tests/_torch_sync_worker.py --rank R --world W \\
        --init file:///tmp/rdv --bridge DIR --out OUT.npz [--mode auto]

Joins a gloo group through ``--init``, restores the MLP's state from the
checkpoint in ``--bridge`` (``restore_or_init``: rank 0 decides and
broadcasts; before that a fresh init from a seed of each rank's own,
which rank 0's broadcast makes one), takes ``--steps`` SGD steps at lr 0.5 on its slice of each
global batch of 256 synthetic MNIST examples, saves the final state into
``--ckpt`` (rank 0 writes) and writes its per-step losses, accuracies and
final params to ``--out``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (  # noqa: E402,E501
    CheckpointManager, restore_or_init)
from distributed_tensorflow_example_tpu_torch.config import (  # noqa: E402
    OptimizerConfig, SyncConfig)
from distributed_tensorflow_example_tpu_torch.data.loader import \
    make_loader  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models.mlp import (  # noqa: E402,E501
    MLP, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime import \
    distributed  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime.server import \
    Server  # noqa: E402
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer  # noqa: E402

torch.set_num_threads(1)

GLOBAL_BATCH = 256
NUM_TRAIN = 2048


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
    a = p.parse_args()

    server = Server({"worker": ["localhost:0"] * a.world}, "worker",
                    a.rank, device="cpu", init_method=a.init)
    ctx = server.context
    model = MLP()
    tx = make_optimizer(OptimizerConfig(name="sgd", learning_rate=0.5))
    try:
        SyncReplicas(model.loss, tx, device="cpu",
                     sync=SyncConfig(replicas_to_aggregate=1))
        refused = ""
    except ValueError as e:
        refused = str(e)
    sync = SyncReplicas(model.loss, tx, device="cpu",
                        sync=SyncConfig(mode=a.mode,
                                        replicas_to_aggregate=a.world))
    # a fresh init from a seed of each rank's own: rank 0's is broadcast
    fresh, _ = restore_or_init(CheckpointManager(a.ckpt + "_fresh"),
                               sync.init, model.init,
                               seed=7 + ctx.process_index)
    state, restored = restore_or_init(CheckpointManager(a.bridge),
                                      sync.init, model.init, seed=1)
    data = synthetic_mnist(NUM_TRAIN, 64)
    batches = make_loader({"x": data["train_x"], "y": data["train_y"]},
                          GLOBAL_BATCH, process_index=ctx.process_index,
                          num_processes=ctx.num_processes, seed=0)
    losses, accs, norms = [], [], []
    for _ in range(a.steps):
        batch = next(batches)
        assert len(batch["y"]) == GLOBAL_BATCH // a.world
        state, m = sync.step(state, batch)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
        norms.append(float(m["grad_norm"]))
    written = CheckpointManager(a.ckpt).save(state)
    out = {f"params/{k}": v for k, v in params_to_numpy(state.params).items()}
    out.update({f"fresh/{k}": v
                for k, v in params_to_numpy(fresh.params).items()})
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
