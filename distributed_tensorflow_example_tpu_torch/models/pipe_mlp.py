"""Pipeline-parallel MNIST MLP, the ``pipe`` axis's demonstration model
(port of ``distributed_tensorflow_example_tpu/models/pipe_mlp.py``).

The parity MLP's input and output projections (784 -> H, H -> 10) around
a stack of L identical residual blocks ``h + relu(h W + b)``: identical
blocks are what a GPipe stage of :mod:`..parallel.pipeline` takes. The
stack's leaves are stacked, ``blocks/kernel`` [L, H, H] and
``blocks/bias`` [L, H], as the reference's checkpoint keys them.

Unbound (no mesh, or ``pipe`` 1) the stack runs in order on the rank;
bound to a mesh with ``pipe`` P > 1 (``bind_mesh``: the sync step binds
its mesh while it computes on the stage's pieces) the rank holds blocks
``[p L/P, (p + 1) L/P)`` and the microbatches flow through the stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..config import TrainConfig
from ..ops import losses, nn
from ..parallel.mesh import AxisNames
from ..parallel.pipeline import make_pipeline
from .base import (cast_floating, checked_params,
                   classification_eval_metrics, generator, register_model,
                   resolve_dtype)


@dataclasses.dataclass
class PipeMlpConfig:
    in_dim: int = 784
    hidden: int = 128
    blocks: int = 4            # total residual blocks, split over pipe
    num_classes: int = 10
    microbatches: int = 4      # GPipe M (per data shard)


def _block_scan(stacked, x, dtype):
    """The stacked residual blocks in order: the pipeline's stage (on a
    [L/P] piece) and the unbound path (on the whole [L] stack). Each
    block's product takes ``dtype`` operands and accumulates in f32; the
    residual stays in ``x``'s dtype."""
    h = x
    for i in range(stacked["kernel"].shape[0]):
        y = torch.matmul(h.to(dtype).float(),
                         stacked["kernel"][i].to(dtype).float())
        r = torch.relu(y + stacked["bias"][i].float()).to(h.dtype)
        h = h + r
    return h


class PipeMlp:
    name = "pipe_mlp"
    #: a GPipe model: its ``bind_mesh`` pipelines over ``pipe``
    pipelined = True

    def __init__(self, cfg: PipeMlpConfig | None = None,
                 dtype=torch.float32, param_dtype=torch.float32):
        self.cfg = cfg or PipeMlpConfig()
        self.dtype = dtype
        self.param_dtype = param_dtype
        self._pipelined = None     # bound by bind_mesh when pipe > 1

    # ------------------------------------------------------------------
    def bind_mesh(self, mesh) -> None:
        """Compute on ``mesh``'s stage of the blocks when its ``pipe``
        axis is wider than 1 (None: the whole stack in order). Raises
        ValueError when the blocks do not split over ``pipe``."""
        if mesh is not None and mesh.shape[AxisNames.PIPE] > 1:
            if self.cfg.blocks % mesh.shape[AxisNames.PIPE]:
                raise ValueError(
                    f"blocks={self.cfg.blocks} not divisible by pipe axis "
                    f"size {mesh.shape[AxisNames.PIPE]}")
            self._pipelined = make_pipeline(
                mesh, lambda p, x, mb_idx: _block_scan(p, x, self.dtype),
                num_microbatches=self.cfg.microbatches)
        else:
            self._pipelined = None

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Every flat parameter key, as the reference's checkpoint names
        it, with its shape."""
        c = self.cfg
        return {"in_proj/kernel": (c.in_dim, c.hidden),
                "in_proj/bias": (c.hidden,),
                "blocks/kernel": (c.blocks, c.hidden, c.hidden),
                "blocks/bias": (c.blocks, c.hidden),
                "out_proj/kernel": (c.hidden, c.num_classes),
                "out_proj/bias": (c.num_classes,)}

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """Seeded random parameters on ``device`` (``cuda`` by default;
        a generator brings its own device): the reference's inits
        (truncated normal projections, glorot blocks, zero biases)."""
        c = self.cfg
        gen = generator(seed, device)
        in_proj = nn.dense_init(gen, c.in_dim, c.hidden)
        kernels = torch.stack([
            nn.glorot_uniform(gen, (c.hidden, c.hidden), torch.float32,
                              c.hidden, c.hidden) for _ in range(c.blocks)])
        return cast_floating({
            "in_proj": in_proj,
            "blocks": {"kernel": kernels,
                       "bias": torch.zeros((c.blocks, c.hidden),
                                           device=gen.device)},
            "out_proj": nn.dense_init(gen, c.hidden, c.num_classes),
        }, self.param_dtype)

    def apply(self, params, extras, batch, gen=None, train: bool = False):
        """(logits [B, num_classes] f32, extras)."""
        x = torch.as_tensor(batch["x"],
                            device=params["in_proj"]["kernel"].device)
        x = x.reshape(x.shape[0], -1)
        h = torch.relu(nn.dense(params["in_proj"], x, dtype=self.dtype))
        if self._pipelined is not None:
            h = self._pipelined(params["blocks"], h)
        else:
            h = _block_scan(params["blocks"], h, self.dtype)
        logits = nn.dense(params["out_proj"], h, dtype=self.dtype)
        return logits.float(), extras

    def loss(self, params, extras, batch, gen=None):
        logits, new_extras = self.apply(params, extras, batch, gen,
                                        train=True)
        y = torch.as_tensor(batch["y"], device=logits.device)
        loss = losses.softmax_xent_int_labels(logits, y)
        aux = {"accuracy": losses.accuracy(logits, y)}
        return loss, (aux, new_extras)

    @torch.no_grad()
    def eval_metrics(self, params, extras, batch) -> dict:
        logits, _ = self.apply(params, extras, batch, train=False)
        return classification_eval_metrics(logits, batch)

    # ------------------------------------------------------------------
    def sharding_rules(self, mesh_shape):
        """The block stack over ``pipe`` (its stage dim); everything else
        replicated or fsdp by the default policy."""
        from ..parallel.sharding import P, ShardingRules
        fsdp = getattr(mesh_shape, "fsdp", 1) if mesh_shape else 1
        pipe = getattr(mesh_shape, "pipe", 1) if mesh_shape else 1
        if pipe <= 1:
            return ShardingRules(fsdp_axis_size=fsdp)
        return ShardingRules(rules=[
            (r"blocks/(kernel|bias)", P(AxisNames.PIPE)),
        ], fsdp_axis_size=fsdp)

    def dummy_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        rs = np.random.RandomState(0)
        return {
            "x": rs.rand(batch_size, self.cfg.in_dim).astype(np.float32),
            "y": rs.randint(0, self.cfg.num_classes, size=(batch_size,),
                            dtype=np.int32),
        }


def params_from_numpy(model: PipeMlp, tree, device=None) -> dict:
    """The reference's pipe_mlp params, keyed as its checkpoint keys them
    (``blocks/kernel`` stacked [L, H, H]) -> the port's params on
    ``device`` (``cuda`` by default). Raises on a missing, unknown or
    mis-shaped key."""
    return checked_params("PipeMlp", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge, in the reference's checkpoint layout."""
    return ckpt.to_numpy(params)


@register_model("pipe_mlp")
def _make_pipe_mlp(config: TrainConfig) -> PipeMlp:
    return PipeMlp(dtype=resolve_dtype(config.dtype),
                   param_dtype=resolve_dtype(config.param_dtype))
