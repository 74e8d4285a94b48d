"""Pipeline-parallel BERT: GPipe over the encoder stack (port of
``distributed_tensorflow_example_tpu/models/pipe_bert.py``).

The L encoder layers live stacked (``layers/...`` leaves with leading dim
L, the reference's checkpoint keys) and split over the ``pipe`` axis:
each stage holds ``L/P`` consecutive layers, while the embedding front
end and the MLM head stay whole on every rank, outside the pipeline. The
microbatches flow through the stages by :mod:`..parallel.pipeline`.

Bound to a ``pipe > 1`` mesh (``bind_mesh``; the sync step binds it while
it computes on the stage's pieces), the outputs, the loss and the
gradients equal the unbound model's, dropout included: both paths split
the rows into ``microbatches`` and fold each layer's key from (global
layer, microbatch) (:func:`~..ops.nn.fold_in`). Without dropout the
unbound path runs one microbatch. Every layer runs the flash kernels
under ``attention_impl="flash"``, as BERT's do.

With a ``model`` axis M > 1 as well (PP x TP) the layers take the Megatron
sequence-parallel layout: between blocks the residual stream is
``[b, s/M, h]``, this ``model`` rank's block of the sequence (layernorm
is per token, so it runs on the block); each block all-gathers the
sequence (:func:`~..parallel.collectives.sp_all_gather`), runs its
column-parallel q/k/v and FFN-in and its heads over the whole sequence,
and its row-parallel o and FFN-out sum their partial products and keep
the rank's block in one reduce-scatter
(:func:`~..parallel.collectives.sp_reduce_scatter`); the stage hop carries
the block. The stacked leaves that every ``model`` rank holds whole (the
layernorms, the row-parallel biases) see only the rank's block of the
sequence, so their gradient is summed over ``model``
(:func:`~..parallel.collectives.copy_to`). On a ``model`` axis with
``pipe`` at 1 the stacked kernels are still split over ``model`` and the
unbound path runs BERT's tensor-parallel layers (``models/base.py``) on
the pieces.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..ckpt.checkpoint import to_numpy
from ..config import TrainConfig
from ..ops import nn
from ..ops.attention import multi_head_attention
from ..parallel import collectives
from ..parallel.mesh import AxisNames
from ..parallel.pipeline import make_pipeline, sequential_blocks
from ..parallel.sharding import P, ShardingRules
from ..parallel.tensor_parallel import row_parallel_partial
from ..utils.pytree import flatten_dict, tree_map, unflatten_dict
from .base import checked_params, register_model, remat_call
from .bert import Bert, BertConfig, _make


@dataclasses.dataclass
class PipeBertConfig(BertConfig):
    microbatches: int = 4       # GPipe M (per data shard)


class PipeBert(Bert):
    """BERT with the encoder stack stacked and pipelined over ``pipe``."""

    name = "pipe_bert"
    #: a GPipe model: its ``bind_mesh`` pipelines over ``pipe``
    pipelined = True
    #: export: the unbound path splits the rows into microbatches, so the
    #: forward needs a concrete batch (the reference's export falls back
    #: to a static batch for it)
    batch_dependent_forward = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._pipe_mesh = None

    # ------------------------------------------------------------------
    def bind_mesh(self, mesh) -> None:
        """Compute on ``mesh``'s pieces: over ``pipe`` > 1 the stage's
        layers through the pipeline, over ``model`` > 1 the Megatron
        pieces (None: the whole model). Raises ValueError, as the
        reference's does, when the layers, heads or FFN columns do not
        split, or for an ``attention_fn`` under PP x TP."""
        pipe = mesh.shape[AxisNames.PIPE] if mesh is not None else 1
        if pipe > 1:
            if self.cfg.layers % pipe:
                raise ValueError(
                    f"layers={self.cfg.layers} not divisible by pipe "
                    f"axis size {pipe}")
            tp = mesh.shape[AxisNames.MODEL]
            if tp > 1:
                if self.cfg.heads % tp:
                    raise ValueError(
                        f"heads={self.cfg.heads} not divisible by model "
                        f"axis size {tp} (PP×TP shards attention by head)")
                if self.cfg.intermediate % tp:
                    raise ValueError(
                        f"intermediate={self.cfg.intermediate} not "
                        f"divisible by model axis size {tp}")
                if self.attention_fn is not None:
                    raise ValueError(
                        "attention_fn (ring attention / seq parallelism) "
                        "does not compose with PP×TP: the TP layer body "
                        "computes attention over its local heads with the "
                        "full sequence")
        super().bind_mesh(mesh)
        self._pipe_mesh = mesh if pipe > 1 else None

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Every flat parameter key, as the reference's checkpoint names
        it (the layers stacked under ``layers/``), with its shape."""
        c = self.cfg
        out = {}
        for k, shape in super().param_shapes().items():
            if k.startswith("layer_0/"):
                out["layers/" + k[len("layer_0/"):]] = (c.layers,) + shape
            elif not k.startswith("layer_"):
                out[k] = shape
        return out

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """BERT's parameters with the ``layer_i`` trees stacked into
        ``layers``."""
        flat = super().init(seed, device)
        layers = [flat.pop(f"layer_{i}") for i in range(self.cfg.layers)]
        flat["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
        return flat

    # ------------------------------------------------------------------
    def _dropout_tp(self, key, salt: int, x_local: torch.Tensor,
                    tp_index: int, tp_size: int) -> torch.Tensor:
        """Dropout on a sequence block ``[b, s/t, h]`` that is positionally
        the full ``[b, s, h]`` tensor's (``nn.keyed_dropout``): every
        ``model`` rank draws the whole mask from the shared key and keeps
        its block."""
        if key is None:
            return x_local
        b, sl, hd = x_local.shape
        keep = 1.0 - self.cfg.dropout
        gen = nn.keyed_generator(nn.fold_in(key, salt), x_local.device)
        u = torch.rand((b, sl * tp_size, hd), generator=gen,
                       device=x_local.device)
        u = u[:, tp_index * sl:(tp_index + 1) * sl]
        return torch.where(u < keep, x_local / keep,
                           torch.zeros((), dtype=x_local.dtype,
                                       device=x_local.device))

    def _row_dense_scatter(self, p, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel dense and reduce-scatter: ``x`` [b, s, in/t]
        against this rank's rows [in/t, out], the partial products summed
        over ``model`` and scattered along the sequence in one collective
        (f32), rounded once to the compute dtype, then the bias added on
        the block."""
        y = row_parallel_partial(p, x, dtype=self.dtype)
        y = collectives.sp_reduce_scatter(y, AxisNames.MODEL, dim=1,
                                          mesh=self._pipe_mesh)
        y = y.to(self.dtype)
        return y + p["bias"].to(y.dtype)

    def _layer_tp(self, lp, x, mask, key):
        """One encoder layer in the Megatron sequence-parallel layout:
        ``x`` is this rank's sequence block ``[b, s/t, hidden]``, ``lp``
        this rank's pieces (q/k/v and FFN-in by column, o and FFN-out by
        row; layernorms and row biases whole). Equal to :meth:`_layer` up
        to the order of the split sums."""
        mesh = self._pipe_mesh
        t, m = mesh.shape[AxisNames.MODEL], mesh.coords[AxisNames.MODEL]
        ap = lp["attn"]
        heads = ap["q"]["kernel"].shape[-1] // self.head_dim
        h_full = collectives.sp_all_gather(x, AxisNames.MODEL, dim=1,
                                           mesh=mesh)
        b, s, _ = h_full.shape

        def split(y):
            return y.reshape(b, s, heads, self.head_dim)

        q = split(nn.dense(ap["q"], h_full, dtype=self.dtype))
        k = split(nn.dense(ap["k"], h_full, dtype=self.dtype))
        v = split(nn.dense(ap["v"], h_full, dtype=self.dtype))
        ctx = multi_head_attention(q, k, v, mask=mask[:, None, None, :],
                                   impl=self.attention_impl,
                                   flash_kwargs=self.attention_kwargs
                                   or None)
        a = self._row_dense_scatter(ap["o"], ctx.reshape(b, s, -1))
        a = self._dropout_tp(key, 1, a, m, t)
        h1 = nn.layernorm(lp["attn_ln"], x + a.to(x.dtype))
        g = collectives.sp_all_gather(h1, AxisNames.MODEL, dim=1, mesh=mesh)
        f = nn.dense(lp["ffn"]["in"], g, dtype=self.dtype)
        f = nn.gelu(f.float()).to(self.dtype)
        f = self._row_dense_scatter(lp["ffn"]["out"], f)
        f = self._dropout_tp(key, 2, f, m, t)
        return nn.layernorm(lp["ffn_ln"], h1 + f.to(h1.dtype))

    def _stage_fn(self, *, offset: int, key, tp: bool = False):
        """(stage stack, {h, mask}, mb_idx) -> the same structure: this
        stage's layers in order. Layer ``j``'s dropout key folds the
        global layer ``offset + j`` and then the microbatch, so the
        pipelined and the unbound paths draw alike. With ``tp`` the
        layer body is the sequence-parallel one."""
        body = self._layer_tp if tp else self._layer

        def stage(stack, x, mb_idx):
            h = x["h"]
            for j in range(next(iter(flatten_dict(stack).values())).shape[0]):
                lp = tree_map(lambda a, j=j: a[j], stack)
                lkey = (None if key is None else
                        nn.fold_in(nn.fold_in(key, offset + j), mb_idx))
                h = remat_call(self.remat, body, lp, h, x["mask"], lkey)
            return {"h": h, "mask": x["mask"]}

        return stage

    def encode(self, params, batch, gen=None, train: bool = False):
        """[B, S] ids -> [B, S, hidden] sequence output. ``gen`` (with
        ``train``) gives the dropout key."""
        c = self.cfg
        key = nn.dropout_key(gen, c.dropout, train)
        h, mask = self._embed(params, batch, key)
        x = {"h": h, "mask": mask}
        layers = params["layers"]
        mesh = self._pipe_mesh
        if mesh is not None:
            tp = mesh.shape[AxisNames.MODEL]
            if tp > 1 and h.shape[1] % tp:
                raise ValueError(
                    f"sequence length {h.shape[1]} not divisible by model "
                    f"axis size {tp} (activations are seq-sharded over TP)")
            n_local = layers["attn"]["q"]["kernel"].shape[0]
            stage = self._stage_fn(
                offset=mesh.coords[AxisNames.PIPE] * n_local, key=key,
                tp=tp > 1)
            x_specs = None
            if tp > 1:
                layers = self._sum_over_model(layers)
                # the residual stream split over model along the sequence
                # between blocks (Megatron-SP); the mask stays whole, the
                # attention masks keys over the whole sequence
                x_specs = {"h": P(AxisNames.BATCH, AxisNames.MODEL),
                           "mask": P(AxisNames.BATCH)}
            piped = make_pipeline(mesh, stage,
                                  num_microbatches=c.microbatches,
                                  param_specs=(self._stacked_specs(layers)
                                               if tp > 1 else None),
                                  x_specs=x_specs)
            out = piped(layers, x)
        else:
            stage = self._stage_fn(offset=0, key=key)
            # dropout keys are per microbatch: the oracle splits the same
            # way; without dropout one microbatch is exact and cheapest
            m = c.microbatches if key is not None else 1
            out = sequential_blocks(stage, layers, x, num_microbatches=m)
        return out["h"]

    # ------------------------------------------------------------------
    #: (pattern, trailing spec) for the stacked encoder's TP layout: one
    #: source for the placement rules (:meth:`sharding_rules`) and the
    #: pipeline's param specs (:meth:`_stacked_specs`). Patterns match
    #: the path below ``layers/``; the leading (stage) dim carries
    #: ``pipe``.
    _TP_STACK = (
        (r"attn/(q|k|v)/kernel|ffn/in/kernel",
         (None, AxisNames.MODEL)),               # column-parallel
        (r"attn/(q|k|v)/bias|ffn/in/bias", (AxisNames.MODEL,)),
        (r"(attn/o|ffn/out)/kernel",
         (AxisNames.MODEL, None)),               # row-parallel
    )

    def _model_tail(self, path: str):
        for pattern, tail in self._TP_STACK:
            if re.search(pattern, path):
                return tail
        return None

    def _stacked_specs(self, stacked):
        """The specs of the stacked leaves under PP x TP: the leading dim
        over ``pipe``, the kernel dims per ``_TP_STACK`` (layernorms and
        row-parallel biases whole over ``model``)."""
        return unflatten_dict({
            k: P(AxisNames.PIPE, *(self._model_tail(k) or ()))
            for k in flatten_dict(stacked)})

    def _sum_over_model(self, stacked):
        """The stacked leaves every ``model`` rank holds whole, wrapped so
        that their gradient (each rank's from its sequence block) is
        summed over ``model``."""
        return unflatten_dict({
            k: (v if self._model_tail(k) else
                collectives.copy_to(v, AxisNames.MODEL,
                                    mesh=self._pipe_mesh))
            for k, v in flatten_dict(stacked).items()})

    def sharding_rules(self, mesh_shape):
        """The stacked encoder over ``pipe`` (its stage dim); with a
        ``model`` axis > 1 the stacked kernels split Megatron-style too and
        the embedding and MLM head take BERT's vocab rules. On a pure-TP
        mesh (``pipe`` 1) the stacked kernels still split over
        ``model``."""
        fsdp = getattr(mesh_shape, "fsdp", 1) if mesh_shape else 1
        pipe = getattr(mesh_shape, "pipe", 1) if mesh_shape else 1
        tp = getattr(mesh_shape, "model", 1) if mesh_shape else 1
        if pipe <= 1 and tp <= 1:
            return ShardingRules(fsdp_axis_size=fsdp)
        # \b, not ^: rule paths come prefixed (params/layers/... in a
        # state); each _TP_STACK pattern is wrapped (?:...) so its
        # alternation stays under the \blayers/ anchor
        lead = AxisNames.PIPE if pipe > 1 else None
        rules = []
        if tp > 1:
            rules += [(r"\blayers/(?:" + pattern + ")", P(lead, *tail))
                      for pattern, tail in self._TP_STACK]
            rules += [(pat, P(*spec)) for pat, spec in self.TP_EMBED_RULES]
        if pipe > 1:
            rules.append((r"\blayers/", P(AxisNames.PIPE)))
        return ShardingRules(rules=rules, fsdp_axis_size=fsdp)


def params_from_numpy(model: PipeBert, tree, device=None) -> dict:
    """The reference's pipe_bert params, keyed as its checkpoint keys them
    (``layers/attn/q/kernel`` stacked [L, H, H]) -> the port's params on
    ``device`` (``cuda`` by default). Raises on a missing, unknown or
    mis-shaped key."""
    return checked_params("PipeBert", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge, in the reference's checkpoint layout."""
    return to_numpy(params)


@register_model("pipe_bert")
def _make_pipe_bert(config: TrainConfig) -> PipeBert:
    return _make(config, PipeBertConfig(), cls=PipeBert)


@register_model("pipe_bert_tiny")
def _make_pipe_bert_tiny(config: TrainConfig) -> PipeBert:
    cfg = PipeBertConfig(**dataclasses.asdict(BertConfig.tiny()))
    cfg.layers = 4              # 2 stages x 2 layers on a pipe=2 mesh
    return _make(config, cfg, config_vocab=False, cls=PipeBert)
