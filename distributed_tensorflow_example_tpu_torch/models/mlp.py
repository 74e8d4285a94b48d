"""MNIST 2-layer MLP, the reference's parity model (port of
``distributed_tensorflow_example_tpu/models/mlp.py``).

784 -> hidden -> 10 with the truncated-normal init, softmax
cross-entropy, plain SGD under the sync step (the reference's
``SyncReplicasOptimizer`` example: hidden 100, lr 0.5). Both dense layers
are ``torch.matmul`` (the reference computes them outside any Pallas
kernel, so no hand-written kernel runs on this path). The logits leave
in f32 whatever the compute ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..config import TrainConfig
from ..ops import losses, nn
from .base import (cast_floating, checked_params,
                   classification_eval_metrics, generator, register_model,
                   resolve_dtype)


class MLP:
    name = "mlp"

    def __init__(self, in_dim: int = 784, hidden: int = 100,
                 num_classes: int = 10, dtype=torch.float32,
                 param_dtype=torch.float32):
        self.in_dim, self.hidden, self.num_classes = in_dim, hidden, \
            num_classes
        self.dtype = dtype
        self.param_dtype = param_dtype

    def param_shapes(self) -> dict[str, tuple]:
        """Every flat parameter key, as the reference's checkpoint names
        it, with its shape."""
        return {"fc1/kernel": (self.in_dim, self.hidden),
                "fc1/bias": (self.hidden,),
                "fc2/kernel": (self.hidden, self.num_classes),
                "fc2/bias": (self.num_classes,)}

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """Seeded random parameters on ``device`` (``cuda`` by default;
        a generator brings its own device)."""
        gen = generator(seed, device)
        return cast_floating({
            "fc1": nn.dense_init(gen, self.in_dim, self.hidden),
            "fc2": nn.dense_init(gen, self.hidden, self.num_classes),
        }, self.param_dtype)

    def apply(self, params, extras, batch, gen=None, train: bool = False):
        """(logits [B, num_classes] f32, extras)."""
        x = batch["x"].reshape(batch["x"].shape[0], -1)
        h = torch.relu(nn.dense(params["fc1"], x, dtype=self.dtype))
        logits = nn.dense(params["fc2"], h, dtype=self.dtype)
        return logits.float(), extras

    def loss(self, params, extras, batch, gen=None):
        logits, new_extras = self.apply(params, extras, batch, gen,
                                        train=True)
        loss = losses.softmax_xent_int_labels(logits, batch["y"])
        aux = {"accuracy": losses.accuracy(logits, batch["y"])}
        return loss, (aux, new_extras)

    @torch.no_grad()
    def eval_metrics(self, params, extras, batch) -> dict:
        logits, _ = self.apply(params, extras, batch, train=False)
        return classification_eval_metrics(logits, batch)

    def dummy_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState(0)
        return {
            "x": rs.rand(batch_size, self.in_dim).astype(np.float32),
            "y": rs.randint(0, self.num_classes, size=(batch_size,),
                            dtype=np.int32),
        }


def params_from_numpy(model: MLP, tree, device=None) -> dict:
    """The reference's MLP params as numpy arrays, keyed as its checkpoint
    ``_flatten`` keys them (``fc1/kernel``; bf16 leaves as numpy bfloat16
    or as uint16 under ``__bf16__/``) -> the port's params on ``device``
    (``cuda`` by default). Raises on a missing, unknown or mis-shaped
    key."""
    return checked_params("MLP", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge: the port's params -> flat numpy arrays in the
    reference's checkpoint layout."""
    return ckpt.to_numpy(params)


@register_model("mlp")
def _make_mlp(config: TrainConfig) -> MLP:
    return MLP(dtype=resolve_dtype(config.dtype),
               param_dtype=resolve_dtype(config.param_dtype))
