"""EP x PP: Mixture-of-Experts encoder layers inside GPipe stages (port of
``distributed_tensorflow_example_tpu/models/pipe_moe.py``).

Every encoder layer is a MoE layer (homogeneous blocks are what stack:
``layers/...`` leaves with leading dim L, the reference's checkpoint
keys, ``layers/moe/w_in`` [L, E, H, I]), the stack is split over
``pipe`` as :class:`~.pipe_bert.PipeBert`'s is, and inside each stage
tick the FFN runs the explicit expert-parallel dataflow of
:func:`~..ops.moe.moe_ffn_ep_body` over ``expert`` when that axis is
wider than 1 (the dense :func:`~..ops.moe.moe_ffn` otherwise). Every
layer runs the flash kernels under ``attention_impl="flash"``, as
BERT's do.

Bound to a mesh with ``pipe`` or ``expert`` > 1 (``bind_mesh``; the sync
step binds it while it computes on the pieces) the pipeline splits each
batch rank's rows over ``expert`` at its entry and joins them at its
exit (``make_pipeline``'s ``x_specs``), as the reference's pipeline
shards the batch over (``data``, ``fsdp``, ``expert``): attention runs on
each member's own rows and the router routes them at a per-shard
capacity, the ``all_to_all`` sends each expert's slots to its rank and
back. Each rank holds ``E/ep`` experts of its stage's layers; the other
stacked leaves (attention, layernorms, the router) are whole on every
``expert`` rank, which uses them on its rows only, so they enter the
pipeline through ``copy_to`` over ``expert`` and their gradients are
summed there. The embeddings before and the head after run on the whole
rows on every rank alike.

The routing losses ride the activation dict as per-row accumulators:
each stage adds its layers' lb, z and dropped fraction for the
microbatch it processes (stats averaged over every token-sharding axis,
so each value is its microbatch group's global one), and the model takes
their row means. Two consequences, as in the reference: routing
decisions are per token, so where nothing drops the outputs, the MLM
loss and the gradients without the aux terms equal the sequential
model's; the aux values depend on which rows share a group (member-major
across the ``expert`` shards), which the sequential model reproduces on
the batch reordered to form the same groups. Dropout masks are drawn per
token shard (each ``expert`` member draws its rows' masks from the same
key), so the bound path equals the sequential one under dropout only
over ``pipe``. Without ``expert`` the stage's dense MoE routes each
batch rank's microbatch alone, as the reference's pipeline body does.

The unbound path (the sequential oracle; one rank, or a mesh of batch
ranks alone) always splits the microbatches: routing is per microbatch.
Over N batch ranks of an ``auto`` step the reference's microbatches are
blocks of the global batch, so each rank holds ``microbatches / N`` of
them whole and routes each alone; a microbatch count that N does not
divide is refused.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from ..ckpt.checkpoint import to_numpy
from ..config import TrainConfig
from ..ops import moe, nn
from ..parallel import collectives
from ..parallel.mesh import AxisNames
from ..parallel.pipeline import make_pipeline, sequential_blocks
from ..parallel.sharding import P, ShardingRules
from ..runtime import distributed
from ..utils.pytree import flatten_dict, tree_map, unflatten_dict
from .base import checked_params, generator, register_model, remat_call
from .bert import Bert, BertConfig, _make
from .moe import MoeFields, moe_mlm_loss
from .pipe_bert import PipeBert, PipeBertConfig


@dataclasses.dataclass
class PipeMoeBertConfig(MoeFields, PipeBertConfig):
    @classmethod
    def tiny(cls) -> "PipeMoeBertConfig":
        cfg = cls(**dataclasses.asdict(BertConfig.tiny()))
        cfg.layers = 4            # 2 stages x 2 layers on a pipe=2 mesh
        cfg.n_experts = 4
        cfg.capacity_factor = 2.0
        return cfg


class PipeMoeBert(PipeBert):
    """Pipelined BERT whose every encoder FFN is an expert-parallel MoE."""

    name = "pipe_moe_bert"
    #: (pattern, trailing spec) of the stacked expert leaves: the expert
    #: dim over ``expert`` (the leading, stage dim carries ``pipe``)
    _EP_STACK = (
        (r"moe/w_(in|out)", (AxisNames.EXPERT, None, None)),
        (r"moe/b_(in|out)", (AxisNames.EXPERT, None)),
    )

    # ------------------------------------------------------------------
    def bind_mesh(self, mesh) -> None:
        """Compute on ``mesh``'s pieces: the stage's layers over ``pipe``,
        its experts over ``expert`` (None: the whole model). Raises
        ValueError, as the reference's does, for a ``model`` axis > 1 or
        experts that do not split over ``expert``."""
        if mesh is not None and mesh.shape[AxisNames.MODEL] > 1:
            raise ValueError(
                "pipe_moe_bert composes pipe x expert; a model axis > 1 "
                "(EP x TP x PP) is not supported: use moe_bert for "
                "EP x TP or pipe_bert for PP x TP")
        ep = mesh.shape[AxisNames.EXPERT] if mesh is not None else 1
        if ep > 1 and self.cfg.n_experts % ep:
            raise ValueError(f"n_experts={self.cfg.n_experts} not divisible "
                             f"by expert axis size {ep}")
        super().bind_mesh(mesh)
        # the EP dataflow needs the mesh with pipe at 1 too
        if mesh is not None and self._pipe_mesh is None and ep > 1:
            self._pipe_mesh = mesh

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        c = self.cfg
        out = {k: v for k, v in super().param_shapes().items()
               if not k.startswith("layers/ffn/")}
        L, E, H, I = c.layers, c.n_experts, c.hidden, c.intermediate
        out.update({"layers/moe/router/kernel": (L, H, E),
                    "layers/moe/w_in": (L, E, H, I),
                    "layers/moe/b_in": (L, E, I),
                    "layers/moe/w_out": (L, E, I, H),
                    "layers/moe/b_out": (L, E, H)})
        return out

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """BERT's layers with each FFN replaced by a router and stacked
        experts drawn from the same generator, then stacked into
        ``layers``."""
        c = self.cfg
        gen = generator(seed, device)
        flat = Bert.init(self, gen)
        for i in range(c.layers):
            lp = flat[f"layer_{i}"]
            del lp["ffn"]
            lp["moe"] = moe.moe_ffn_init(gen, c.n_experts, c.hidden,
                                         c.intermediate,
                                         param_dtype=self.param_dtype)
        layers = [flat.pop(f"layer_{i}") for i in range(c.layers)]
        flat["layers"] = tree_map(lambda *xs: torch.stack(xs), *layers)
        return flat

    # ------------------------------------------------------------------
    def _moe_ffn_in_stage(self, lp_moe, h, ep: bool, stat_axes):
        """One layer's FFN body inside a stage: the explicit EP dataflow
        when ``expert`` is wider than 1, the dense dispatch of this
        call's rows alone otherwise."""
        c = self.cfg
        if ep:
            mesh = self._pipe_mesh
            return moe.moe_ffn_ep_body(
                lp_moe, h, n_experts=c.n_experts,
                n_ranks=mesh.shape[AxisNames.EXPERT], top_k=c.top_k,
                capacity_factor=c.capacity_factor, dtype=self.dtype,
                axis_name=AxisNames.EXPERT, stat_axes=stat_axes, mesh=mesh)
        return moe.moe_ffn(lp_moe, h, n_experts=c.n_experts, top_k=c.top_k,
                           capacity_factor=c.capacity_factor,
                           dtype=self.dtype)

    def _moe_stage_fn(self, *, offset: int, key, ep: bool = False,
                      stat_axes=()):
        """(stage stack, {h, mask, lb, z, dropped}, mb_idx) -> the same
        structure: this stage's MoE layers in order, their routing losses
        added to the per-row accumulators. Layer ``j``'s dropout key
        folds the global layer ``offset + j``, then the microbatch."""
        def one_layer(lp, h, mask, lkey):
            h = self._attn_block(lp, h, mask, lkey)
            f, aux = self._moe_ffn_in_stage(lp["moe"], h, ep, stat_axes)
            return self._ffn_block(lp, h, f, lkey), aux

        def stage(stack, x, mb_idx):
            h = x["h"]
            lb = z = dropped = torch.zeros((), device=h.device)
            for j in range(next(iter(flatten_dict(stack).values())).shape[0]):
                lp = tree_map(lambda a, j=j: a[j], stack)
                lkey = (None if key is None else
                        nn.fold_in(nn.fold_in(key, offset + j), mb_idx))
                h, aux = remat_call(self.remat, one_layer, lp, h, x["mask"],
                                    lkey)
                lb = lb + aux["lb_loss"]
                z = z + aux["z_loss"]
                dropped = dropped + aux["dropped_fraction"]
            # every row of the microbatch carries the stage's values, so
            # the row means are the microbatches' means
            return {"h": h, "mask": x["mask"], "lb": x["lb"] + lb,
                    "z": x["z"] + z, "dropped": x["dropped"] + dropped}

        return stage

    def _sum_over_expert(self, stacked):
        """The stacked leaves every ``expert`` rank holds whole, wrapped so
        that their gradient (each rank's from its rows) is summed over
        ``expert``."""
        return unflatten_dict({
            k: (v if self._expert_tail(k) else
                collectives.copy_to(v, AxisNames.EXPERT,
                                    mesh=self._pipe_mesh))
            for k, v in flatten_dict(stacked).items()})

    def encode_with_aux(self, params, batch, gen=None, train: bool = False):
        """[B, S] ids -> ([B, S, hidden] sequence output, {lb_loss,
        z_loss, dropped_fraction}): the losses are the microbatches'
        means of their layers' sums, the dropped fraction also a mean
        over the layers. ``gen`` (with ``train``) gives the dropout
        key."""
        c = self.cfg
        key = nn.dropout_key(gen, c.dropout, train)
        h, mask = self._embed(params, batch, key)
        zero = torch.zeros((h.shape[0],), device=h.device)
        x = {"h": h, "mask": mask, "lb": zero, "z": zero, "dropped": zero}
        layers = params["layers"]
        mesh = self._pipe_mesh
        if mesh is not None:
            ep = mesh.shape[AxisNames.EXPERT] > 1
            rows = AxisNames.BATCH + ((AxisNames.EXPERT,) if ep else ())
            if ep:
                layers = self._sum_over_expert(layers)
            n_local = next(iter(flatten_dict(layers).values())).shape[0]
            stage = self._moe_stage_fn(
                offset=mesh.coords[AxisNames.PIPE] * n_local, key=key, ep=ep,
                stat_axes=rows)
            piped = make_pipeline(
                mesh, stage, num_microbatches=c.microbatches,
                x_specs=tree_map(lambda _: P(rows), x))
            out = piped(layers, x)
        else:
            # always the pipeline's microbatch split: routing (capacity,
            # statistics) is per microbatch of the global batch
            m, first = c.microbatches, 0
            ranks = distributed.batch_ranks()
            if ranks is not None:
                if m % ranks.size:
                    raise ValueError(
                        f"pipe_moe_bert over {ranks.size} batch ranks with "
                        f"no pipe or expert axis: its {m} microbatches of "
                        "the global batch, routed each alone, must split "
                        "evenly over the ranks")
                m //= ranks.size
                first = ranks.index * m
            stage = self._moe_stage_fn(offset=0, key=key)
            out = sequential_blocks(stage, layers, x, num_microbatches=m,
                                    first_microbatch=first)
        return out["h"], {
            "lb_loss": torch.mean(out["lb"]),
            "z_loss": torch.mean(out["z"]),
            # visibility: also a mean over the layers (the losses stay
            # sums: each router is its own target)
            "dropped_fraction": torch.mean(out["dropped"]) / c.layers,
        }

    def encode(self, params, batch, gen=None, train: bool = False):
        return self.encode_with_aux(params, batch, gen, train)[0]

    loss = moe_mlm_loss

    # ------------------------------------------------------------------
    def _expert_tail(self, path: str):
        for pattern, tail in self._EP_STACK:
            if re.search(pattern, path):
                return tail
        return None

    def sharding_rules(self, mesh_shape):
        """The stacked layers over ``pipe`` (their stage dim) and the
        stacked experts over ``expert`` (their expert dim), the
        reference's rules; the fsdp fallback for the rest."""
        fsdp = getattr(mesh_shape, "fsdp", 1) if mesh_shape else 1
        pipe = getattr(mesh_shape, "pipe", 1) if mesh_shape else 1
        ep = getattr(mesh_shape, "expert", 1) if mesh_shape else 1
        if pipe <= 1 and ep <= 1:
            return ShardingRules(fsdp_axis_size=fsdp)
        lead = AxisNames.PIPE if pipe > 1 else None
        rules = [(r"\blayers/(?:" + pattern + ")", P(lead, *tail))
                 for pattern, tail in self._EP_STACK]
        if pipe > 1:
            rules.append((r"\blayers/", P(AxisNames.PIPE)))
        return ShardingRules(rules=rules, fsdp_axis_size=fsdp)


def params_from_numpy(model: PipeMoeBert, tree, device=None) -> dict:
    """The reference's pipe_moe_bert params, keyed as its checkpoint keys
    them (``layers/moe/w_in`` stacked [L, E, H, I]) -> the port's params
    on ``device`` (``cuda`` by default). Raises on a missing, unknown or
    mis-shaped key."""
    return checked_params("PipeMoeBert", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge, in the reference's checkpoint layout."""
    return to_numpy(params)


def _apply_overrides(cfg: PipeMoeBertConfig,
                     config: TrainConfig) -> PipeMoeBertConfig:
    """The shared ``--moe_*`` knobs with the reference's checks, minus the
    two that do not apply here, which raise: every pipelined layer is
    MoE (``--moe_every``), and router jitter is not wired into the
    pipelined path (``--moe_jitter``)."""
    if config.moe_experts is not None:
        if config.moe_experts < 1:
            raise ValueError(
                f"moe_experts={config.moe_experts} must be >= 1")
        cfg.n_experts = config.moe_experts
    if config.moe_top_k is not None:
        cfg.top_k = config.moe_top_k
    if not 1 <= cfg.top_k <= cfg.n_experts:
        raise ValueError(f"moe_top_k={cfg.top_k} must be in "
                         f"[1, n_experts={cfg.n_experts}]")
    if config.moe_capacity_factor is not None:
        if config.moe_capacity_factor <= 0:
            raise ValueError("moe_capacity_factor must be > 0")
        cfg.capacity_factor = config.moe_capacity_factor
    if config.moe_aux_weight is not None:
        cfg.aux_weight = config.moe_aux_weight
    if config.moe_router_z_weight is not None:
        cfg.router_z_weight = config.moe_router_z_weight
    if config.moe_every is not None:
        raise ValueError(
            "moe_every does not apply to pipe_moe_bert: every pipelined "
            "layer is MoE (homogeneous blocks stack over pipe)")
    if config.moe_jitter is not None:
        raise ValueError(
            "moe_jitter is not wired into the pipelined MoE path; use "
            "moe_bert for jittered routing")
    return cfg


@register_model("pipe_moe_bert")
def _make_pipe_moe_bert(config: TrainConfig) -> PipeMoeBert:
    cfg = _apply_overrides(PipeMoeBertConfig(), config)
    return _make(config, cfg, cls=PipeMoeBert)


@register_model("pipe_moe_bert_tiny")
def _make_pipe_moe_bert_tiny(config: TrainConfig) -> PipeMoeBert:
    cfg = _apply_overrides(PipeMoeBertConfig.tiny(), config)
    return _make(config, cfg, config_vocab=False, cls=PipeMoeBert)
