"""Fine-tune from a checkpoint and ship a servable — the model lifecycle,
on the PyTorch port (a port copy of ``examples/finetune_export.py``).

The reference era's workflow after training was: warm-start a new run
from a pretrained checkpoint (``tf.train.init_from_checkpoint``), keep
an exponential moving average of the weights
(``tf.train.ExponentialMovingAverage``), and export a SavedModel for
serving. This example runs that whole lifecycle on the port, end to
end, on synthetic data::

    python -m distributed_tensorflow_example_tpu_torch.examples.finetune_export \\
        --workdir /tmp/lifecycle [--device cpu]

Steps (each maps to one framework feature):

1. pretrain  — a short MNIST run, checkpointed (``CheckpointManager``).
2. fine-tune — a FRESH run whose params warm-start from step 1's
   checkpoint (``checkpoint.warm_start``; the optimizer state and global
   step start over, which is what distinguishes fine-tuning from
   resuming), with an EMA shadow (``ema_decay``).
3. export    — the fine-tuned forward (EMA weights) written as the
   port's artifact: ``params.npz`` and the ``export.json`` metadata that
   rebuilds the model (``serving.export_model``; the reference writes
   StableHLO).
4. serve     — the artifact loaded back WITHOUT the model object and
   queried (``serving.load_servable``).

It runs on the card unless ``--device cpu`` asks for the CPU; the MLP
runs no hand-written kernel.
"""

import argparse
import os
import sys

import numpy as np

from distributed_tensorflow_example_tpu_torch.config import (
    CheckpointConfig, DataConfig, MeshShape, OptimizerConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.serving import (
    export_model, load_servable, serving_signature)
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    find_ema_params
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer


def run(workdir: str, pretrain_steps: int = 60, finetune_steps: int = 40,
        *, device: str = "cuda") -> dict:
    data = synthetic_mnist(2048, 512)
    train = {"x": data["train_x"], "y": data["train_y"]}
    evals = {"x": data["test_x"], "y": data["test_y"]}

    # -- 1. pretrain ----------------------------------------------------
    # data=-1: every rank on the data axis (the CLI default)
    pre_cfg = TrainConfig(
        model="mlp", train_steps=pretrain_steps,
        mesh=MeshShape(data=-1),
        data=DataConfig(batch_size=256),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.3),
        checkpoint=CheckpointConfig(directory=os.path.join(workdir, "pre"),
                                    save_steps=pretrain_steps))
    with Trainer(get_model("mlp", pre_cfg), pre_cfg, train,
                 eval_arrays=evals, device=device) as tr:
        _, pre_summary = tr.train()

    # -- 2. fine-tune (warm start + EMA) --------------------------------
    ft_cfg = TrainConfig(
        model="mlp", train_steps=finetune_steps,
        mesh=MeshShape(data=-1),
        data=DataConfig(batch_size=256),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  ema_decay=0.95),
        checkpoint=CheckpointConfig(
            directory=os.path.join(workdir, "ft"),
            warm_start=os.path.join(workdir, "pre"),
            save_steps=finetune_steps))
    model = get_model("mlp", ft_cfg)
    with Trainer(model, ft_cfg, train, eval_arrays=evals,
                 device=device) as tr:
        state, ft_summary = tr.train()

    # -- 3. export the EMA weights --------------------------------------
    export_dir = os.path.join(workdir, "servable")
    ema = find_ema_params(state.opt_state, state.params)
    artifact = export_model(model, ema, state.extras, export_dir)

    # -- 4. serve from the artifact alone -------------------------------
    servable = load_servable(export_dir, device=device)
    feats = serving_signature({k: v[:16] for k, v in evals.items()})
    logits = np.asarray(servable(feats))
    acc = float((logits.argmax(-1) == evals["y"][:16]).mean())
    return {
        "pretrain_eval": pre_summary["eval"],
        "finetune_eval": ft_summary["eval"],
        "servable_accuracy_16": acc,
        "export_dir": export_dir,
        "artifact": artifact,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    out = run(args.workdir, device=args.device)
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in out.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
