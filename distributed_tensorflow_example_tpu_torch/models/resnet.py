"""ResNet family: ResNet-20 (CIFAR-10) and ResNet-50 (ImageNet) (port of
``distributed_tensorflow_example_tpu/models/resnet.py``).

NHWC activations and HWIO kernels as in the reference, so its
checkpoints load unchanged; bf16 compute with f32 batch statistics; the
batch norm running statistics in ``TrainState.extras``, always f32.
Across ranks, the sync step's ``auto`` mode normalises over the global
batch (sync-BN, ``runtime/distributed.py``) and ``shard_map`` over each
rank's batch, averaging the running statistics after the step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..ops import losses, nn
from .base import (DefaultRulesMixin, cast_floating,
                   classification_eval_metrics, generator, register_model,
                   resolve_dtype)


class _BasicBlock:
    """3x3 + 3x3 with identity/projection shortcut (ResNet-20)."""

    expansion = 1

    @staticmethod
    def init(gen, in_ch: int, width: int, stride: int):
        out_ch, dev = width, gen.device
        params = {
            "conv1": nn.conv2d_init(gen, 3, 3, in_ch, width, use_bias=False),
            "conv2": nn.conv2d_init(gen, 3, 3, width, out_ch,
                                    use_bias=False),
        }
        extras = {}
        params["bn1"], extras["bn1"] = nn.batchnorm_init(width, device=dev)
        params["bn2"], extras["bn2"] = nn.batchnorm_init(out_ch, device=dev)
        if stride != 1 or in_ch != out_ch:
            params["proj"] = nn.conv2d_init(gen, 1, 1, in_ch, out_ch,
                                            use_bias=False)
            params["proj_bn"], extras["proj_bn"] = nn.batchnorm_init(
                out_ch, device=dev)
        return params, extras, out_ch

    @staticmethod
    def apply(params, extras, x, *, stride, train, dtype,
              bn_stats_dtype=torch.float32):
        new = {}

        def bn(name, h):
            h, new[name] = nn.batchnorm(params[name], extras[name], h,
                                        train=train,
                                        stats_dtype=bn_stats_dtype)
            return h

        h = nn.conv2d(params["conv1"], x, stride=stride, dtype=dtype)
        h = torch.relu(bn("bn1", h))
        h = bn("bn2", nn.conv2d(params["conv2"], h, dtype=dtype))
        if "proj" in params:
            s = bn("proj_bn", nn.conv2d(params["proj"], x, stride=stride,
                                        dtype=dtype))
        else:
            s = x.to(h.dtype)
        return torch.relu(h + s), new


class _BottleneckBlock:
    """1x1 -> 3x3 -> 1x1(x4) with projection shortcut (ResNet-50)."""

    expansion = 4

    @staticmethod
    def init(gen, in_ch: int, width: int, stride: int):
        out_ch, dev = width * 4, gen.device
        params = {
            "conv1": nn.conv2d_init(gen, 1, 1, in_ch, width, use_bias=False),
            "conv2": nn.conv2d_init(gen, 3, 3, width, width, use_bias=False),
            "conv3": nn.conv2d_init(gen, 1, 1, width, out_ch,
                                    use_bias=False),
        }
        extras = {}
        params["bn1"], extras["bn1"] = nn.batchnorm_init(width, device=dev)
        params["bn2"], extras["bn2"] = nn.batchnorm_init(width, device=dev)
        params["bn3"], extras["bn3"] = nn.batchnorm_init(out_ch, device=dev)
        if stride != 1 or in_ch != out_ch:
            params["proj"] = nn.conv2d_init(gen, 1, 1, in_ch, out_ch,
                                            use_bias=False)
            params["proj_bn"], extras["proj_bn"] = nn.batchnorm_init(
                out_ch, device=dev)
        return params, extras, out_ch

    @staticmethod
    def apply(params, extras, x, *, stride, train, dtype,
              bn_stats_dtype=torch.float32):
        new = {}

        def bn(name, h):
            h, new[name] = nn.batchnorm(params[name], extras[name], h,
                                        train=train,
                                        stats_dtype=bn_stats_dtype)
            return h

        h = torch.relu(bn("bn1", nn.conv2d(params["conv1"], x,
                                           dtype=dtype)))
        h = torch.relu(bn("bn2", nn.conv2d(params["conv2"], h,
                                           stride=stride, dtype=dtype)))
        h = bn("bn3", nn.conv2d(params["conv3"], h, dtype=dtype))
        if "proj" in params:
            s = bn("proj_bn", nn.conv2d(params["proj"], x, stride=stride,
                                        dtype=dtype))
        else:
            s = x.to(h.dtype)
        return torch.relu(h + s), new


class ResNet(DefaultRulesMixin):
    """Configurable ResNet. Two presets are registered below:

    - ``resnet20``: CIFAR stem (3x3/16, no maxpool), basic blocks [3,3,3],
      widths [16,32,64].
    - ``resnet50``: ImageNet stem (7x7/64 s2 + 3x3/2 maxpool), bottlenecks
      [3,4,6,3], widths [64,128,256,512].
    """

    def __init__(self, name: str, block, stage_sizes: Sequence[int],
                 widths: Sequence[int], num_classes: int,
                 input_hw: int, imagenet_stem: bool, dtype=torch.float32,
                 param_dtype=torch.float32, label_smoothing: float = 0.0,
                 bn_stats_dtype=torch.float32):
        self.name = name
        self.block = block
        self.stage_sizes = list(stage_sizes)
        self.widths = list(widths)
        self.num_classes = num_classes
        self.input_hw = input_hw
        self.imagenet_stem = imagenet_stem
        self.dtype = dtype
        self.param_dtype = param_dtype
        # smooths the training targets only; eval metrics stay unsmoothed
        self.label_smoothing = label_smoothing
        # the batch-statistic reduction dtype; running stats stay f32
        self.bn_stats_dtype = bn_stats_dtype

    def _strides(self):
        for si, n in enumerate(self.stage_sizes):
            for bi in range(n):
                yield f"s{si}b{bi}", si, 2 if (bi == 0 and si > 0) else 1

    def init(self, seed: int | torch.Generator = 0, device=None):
        """(params, extras), seeded, on ``device`` (``cuda`` by default; a
        generator brings its own device)."""
        gen = generator(seed, device)
        params: dict = {}
        extras: dict = {}
        if self.imagenet_stem:
            params["stem"] = nn.conv2d_init(gen, 7, 7, 3, 64, use_bias=False)
            ch = 64
        else:
            params["stem"] = nn.conv2d_init(gen, 3, 3, 3, 16, use_bias=False)
            ch = 16
        params["stem_bn"], extras["stem_bn"] = nn.batchnorm_init(
            ch, device=gen.device)
        for key, si, stride in self._strides():
            params[key], extras[key], ch = self.block.init(
                gen, ch, self.widths[si], stride)
        params["fc"] = nn.dense_init(gen, ch, self.num_classes)
        return cast_floating(params, self.param_dtype), extras

    def apply(self, params, extras, batch, gen=None, train: bool = False):
        """(logits [B, num_classes] f32, the new extras in training, else
        ``extras``)."""
        new: dict = {}
        h = nn.conv2d(params["stem"], batch["x"],
                      stride=2 if self.imagenet_stem else 1,
                      dtype=self.dtype)
        h, new["stem_bn"] = nn.batchnorm(
            params["stem_bn"], extras["stem_bn"], h, train=train,
            stats_dtype=self.bn_stats_dtype)
        h = torch.relu(h)
        if self.imagenet_stem:
            h = nn.max_pool(h, 3, 2, padding="SAME")
        for key, _, stride in self._strides():
            h, new[key] = self.block.apply(
                params[key], extras[key], h, stride=stride, train=train,
                dtype=self.dtype, bn_stats_dtype=self.bn_stats_dtype)
        h = h.float().mean(dim=(1, 2))               # global average pool
        logits = nn.dense(params["fc"], h, dtype=self.dtype)
        return logits.float(), (new if train else extras)

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
        # top-5 only means something with more than 5 classes
        return classification_eval_metrics(
            logits, batch, top5=self.num_classes > 5)

    def dummy_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState(0)
        hw = self.input_hw
        return {
            "x": rs.rand(batch_size, hw, hw, 3).astype(np.float32),
            "y": rs.randint(0, self.num_classes, size=(batch_size,),
                            dtype=np.int32),
        }


def _bn_stats_dtype(config: TrainConfig) -> torch.dtype:
    if config.bn_stats_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"bn_stats_dtype={config.bn_stats_dtype!r} must be float32 "
            "or bfloat16")
    return resolve_dtype(config.bn_stats_dtype)


@register_model("resnet20")
def _make_resnet20(config: TrainConfig) -> ResNet:
    return ResNet("resnet20", _BasicBlock, [3, 3, 3], [16, 32, 64],
                  num_classes=10, input_hw=32, imagenet_stem=False,
                  dtype=resolve_dtype(config.dtype),
                  param_dtype=resolve_dtype(config.param_dtype),
                  label_smoothing=config.label_smoothing,
                  bn_stats_dtype=_bn_stats_dtype(config))


@register_model("resnet50")
def _make_resnet50(config: TrainConfig) -> ResNet:
    return ResNet("resnet50", _BottleneckBlock, [3, 4, 6, 3],
                  [64, 128, 256, 512], num_classes=1000, input_hw=224,
                  imagenet_stem=True, dtype=resolve_dtype(config.dtype),
                  param_dtype=resolve_dtype(config.param_dtype),
                  label_smoothing=config.label_smoothing,
                  bn_stats_dtype=_bn_stats_dtype(config))
