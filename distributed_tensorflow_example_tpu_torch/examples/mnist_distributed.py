"""Distributed MNIST training — the reference example script, on the
PyTorch port (a port copy of ``examples/mnist_distributed.py``).

This file is shaped like the canonical distributed-tensorflow-example
trainer: the same flags, the same ClusterSpec/Server bring-up, the same
``if job_name == "ps": server.join()`` branch, the same
variables→placement / model / sync-optimizer / supervised-loop order, so
a user of the reference can read it top to bottom and see where each
familiar block landed. Block comments name the reference construct
being replaced.

Run it as one worker on the card::

    python -m distributed_tensorflow_example_tpu_torch.examples.mnist_distributed \\
        --train_steps 500

as worker ``i`` of two (one process each, worker 0's address the
rendezvous)::

    python -m distributed_tensorflow_example_tpu_torch.examples.mnist_distributed \\
        --worker_hosts localhost:2222,localhost:2223 --task_index i

or with the legacy launch-script surface::

    python -m distributed_tensorflow_example_tpu_torch.examples.mnist_distributed \\
        --job_name ps --task_index 0 \\
        --ps_hosts ps0:2222 --worker_hosts w0:2222,w1:2222   # exits 0

``--device cpu`` runs it on the CPU (ranks over gloo); without it, it
runs on ``cuda`` (ranks over NCCL) and raises where there is none.
"""

import argparse
import sys
import time

import torch

from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, restore_or_init)
from distributed_tensorflow_example_tpu_torch.cli.train import parse_hosts
from distributed_tensorflow_example_tpu_torch.cluster import ClusterSpec
from distributed_tensorflow_example_tpu_torch.config import OptimizerConfig
from distributed_tensorflow_example_tpu_torch.data.loader import make_loader
from distributed_tensorflow_example_tpu_torch.data.mnist import get_mnist
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import (
    SyncReplicas)
from distributed_tensorflow_example_tpu_torch.runtime import distributed
from distributed_tensorflow_example_tpu_torch.runtime.device import \
    resolve_device
from distributed_tensorflow_example_tpu_torch.runtime.server import Server
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer


def parse_flags(argv=None):
    # -- tf.app.flags parity: the reference's exact distributed flag
    #    surface plus its hyperparameter knobs, and the port's --device
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ps_hosts", default="",
                   help="comma-separated host:port list (no PS role on "
                        "the card; accepted for launch-script "
                        "compatibility)")
    p.add_argument("--worker_hosts", default="",
                   help="comma-separated host:port list; worker 0's is "
                        "the rendezvous of the process group")
    p.add_argument("--job_name", default="worker", choices=["ps", "worker"])
    p.add_argument("--task_index", type=int, default=0)
    p.add_argument("--data_dir", default=None,
                   help="IDX files directory; omit for synthetic MNIST")
    p.add_argument("--hidden_units", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256,
                   help="GLOBAL batch size (the reference's per-worker "
                        "batch times worker count)")
    p.add_argument("--learning_rate", type=float, default=0.5)
    p.add_argument("--train_steps", type=int, default=1000)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--log_every_steps", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda unless the caller asks for the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    flags = parse_flags(argv)

    # -- ClusterSpec({"ps": [...], "worker": [...]}). Empty host lists ->
    #    one process; the spec drives the torch.distributed bring-up when
    #    worker_hosts names several hosts.
    cluster = None
    if flags.ps_hosts or flags.worker_hosts:
        cluster = ClusterSpec({"ps": parse_hosts(flags.ps_hosts),
                               "worker": parse_hosts(flags.worker_hosts)})

    # -- tf.train.Server(cluster, job_name, task_index): one runtime
    #    handle per process; a worker joins the process group (rank
    #    task_index, NCCL on the card, gloo on the CPU). The PS role hosts
    #    nothing, so the reference's `if job_name == "ps": server.join()`
    #    branch logs the no-PS notice and exits 0: old launch scripts
    #    keep working.
    server = Server(cluster, job_name=flags.job_name,
                    task_index=flags.task_index, device=flags.device)
    if flags.job_name == "ps":
        server.join()
        return 0
    ctx = server.context
    device = resolve_device(flags.device)

    # -- tf.device(replica_device_setter(...)): no placement to set. Each
    #    rank keeps a full replica of the parameters on its own card
    #    (pure sync-DP, the reference's topology); the fsdp placement is
    #    cli/train.py's --mesh data=..,fsdp=.. (parallel/sharding.py).

    # -- model + loss: 784 -> hidden -> 10 softmax xent
    model = MLP(in_dim=784, hidden=flags.hidden_units, num_classes=10)

    # -- SyncReplicasOptimizer(base_opt, replicas_to_aggregate=W): each
    #    rank's gradients, one all-reduce to their mean over the ranks
    #    (the accumulate-average step), the same update on every rank,
    #    step += 1. The base optimizer is plain SGD, like the reference's
    #    GradientDescentOptimizer underneath the wrapper.
    tx = make_optimizer(OptimizerConfig(name="sgd",
                                        learning_rate=flags.learning_rate))
    sync = SyncReplicas(model.loss, tx, device=device)

    # -- Supervisor.prepare_or_wait_for_session: restore-or-init, rank 0's
    #    decision on every rank and rank 0's state broadcast.
    mgr = (CheckpointManager(flags.ckpt_dir)
           if flags.ckpt_dir else None)
    state, restored = restore_or_init(mgr, sync.init, model.init, seed=0)
    start_step = int(state.step)
    if restored:
        print(f"restored checkpoint at step {start_step}", flush=True)

    # -- input pipeline: in-memory MNIST, deterministic per-rank sharding
    #    (each rank's contiguous slice of every global batch) replaces
    #    the feed_dict next_batch loop
    data = get_mnist(flags.data_dir, synthetic=flags.data_dir is None)
    # start_step fast-forwards the deterministic batch sequence on resume
    # (exact resume: the restored run consumes exactly the batches an
    # uninterrupted run would have)
    batches = make_loader(
        {"x": data["train_x"], "y": data["train_y"]},
        flags.batch_size,
        process_index=ctx.process_index,
        num_processes=ctx.num_processes,
        shuffle=True, seed=0, start_step=start_step)

    # -- the training loop: sess.run([train_op, loss]) becomes one eager
    #    step on the card; the chief's aggregator thread, token queue and
    #    PS transfers do not exist — the all-reduce is the barrier.
    t0, last_log = time.time(), start_step
    for step in range(start_step, flags.train_steps):
        state, metrics = sync.step(state, next(batches))
        if (step + 1) % flags.log_every_steps == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            sps = (step + 1 - last_log) / dt if dt > 0 else float("inf")
            print(f"step {step + 1}: loss={loss:.4f} ({sps:.1f} steps/s)",
                  flush=True)
            t0, last_log = time.time(), step + 1

    # -- chief checkpoint thread: rank 0 writes (max_to_keep ring), every
    #    rank meets at the barrier; here a single end-of-run save
    if mgr is not None:
        mgr.save(state)
        mgr.close()

    # -- final eval
    test = {"x": data["test_x"], "y": data["test_y"]}
    metrics = model.eval_metrics(state.params, state.extras,
                                 {k: torch.as_tensor(v, device=device)
                                  for k, v in test.items()})
    acc = float(metrics["accuracy"])
    print(f"final test accuracy: {acc:.4f}", flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
