"""MNIST LeNet CNN, the reference's second workload (port of
``distributed_tensorflow_example_tpu/models/lenet.py``).

conv5x5/32 -> maxpool -> conv5x5/64 -> maxpool -> fc512 -> fc10, NHWC,
relu. A flat 784 input is reshaped to 28x28x1. The flatten before fc1
runs in H, W, C order, as the reference's: fc1's 3136x512 kernel
depends on it, so the reference's checkpoints load unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import losses, nn
from .base import (DefaultRulesMixin, cast_floating,
                   classification_eval_metrics, generator, register_model,
                   resolve_dtype)


class LeNet(DefaultRulesMixin):
    name = "lenet"

    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.0,
                 dtype=torch.float32, param_dtype=torch.float32,
                 label_smoothing: float = 0.0):
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.label_smoothing = label_smoothing

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """Seeded random parameters on ``device`` (``cuda`` by default;
        a generator brings its own device)."""
        gen = generator(seed, device)
        return cast_floating({
            "conv1": nn.conv2d_init(gen, 5, 5, 1, 32),
            "conv2": nn.conv2d_init(gen, 5, 5, 32, 64),
            "fc1": nn.dense_init(gen, 7 * 7 * 64, 512, init="he"),
            "fc2": nn.dense_init(gen, 512, self.num_classes),
        }, self.param_dtype)

    def apply(self, params, extras, batch, gen=None, train: bool = False):
        """(logits [B, num_classes] f32, extras)."""
        x = batch["x"]
        if x.ndim == 2:                       # flat 784 -> NHWC
            x = x.reshape(-1, 28, 28, 1)
        h = torch.relu(nn.conv2d(params["conv1"], x, dtype=self.dtype))
        h = nn.max_pool(h, 2, 2)
        h = torch.relu(nn.conv2d(params["conv2"], h, dtype=self.dtype))
        h = nn.max_pool(h, 2, 2)
        h = h.reshape(h.shape[0], -1)         # H, W, C order
        h = torch.relu(nn.dense(params["fc1"], h, dtype=self.dtype))
        h = nn.dropout(gen, h, self.dropout_rate,
                       train=train and gen is not None)
        logits = nn.dense(params["fc2"], h, dtype=self.dtype)
        return logits.float(), extras

    def loss(self, params, extras, batch, gen=None):
        logits, new_extras = self.apply(params, extras, batch, gen,
                                        train=True)
        loss = losses.softmax_xent_int_labels(
            logits, batch["y"], label_smoothing=self.label_smoothing)
        aux = {"accuracy": losses.accuracy(logits, batch["y"])}
        return loss, (aux, new_extras)

    @torch.no_grad()
    def eval_metrics(self, params, extras, batch) -> dict:
        logits, _ = self.apply(params, extras, batch, train=False)
        return classification_eval_metrics(logits, batch)

    def dummy_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState(0)
        return {
            "x": rs.rand(batch_size, 28, 28, 1).astype(np.float32),
            "y": rs.randint(0, self.num_classes, size=(batch_size,),
                            dtype=np.int32),
        }


@register_model("lenet")
def _make_lenet(config: TrainConfig) -> LeNet:
    return LeNet(dtype=resolve_dtype(config.dtype),
                 param_dtype=resolve_dtype(config.param_dtype),
                 label_smoothing=config.label_smoothing)
