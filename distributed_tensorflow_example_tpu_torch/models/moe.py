"""MoE-BERT: the BERT MLM encoder with Mixture-of-Experts FFN layers (port
of ``distributed_tensorflow_example_tpu/models/moe.py``, the dense
dispatch/combine path; ``bench.py``'s ``moe_bert`` row).

Every ``moe_every``-th layer (offset ``moe_every - 1``) swaps its FFN for
a Switch-style MoE block (``ops/moe.py``); the attention half and the
dropout-add-LN tail are BERT's (:meth:`Bert._attn_block`,
:meth:`Bert._ffn_block`), so the flash kernels run as in BERT: B1 once a
layer a forward, B2a and B2b (or B3) once a layer a backward. The loss is
the MLM loss plus ``aux_weight`` times the summed load-balancing losses
plus ``router_z_weight`` times the summed router z-losses; the metrics
are the reference's, the per-expert ``expert_load`` [E] vector among
them (the Trainer writes vectors to the JSONL, its scalar hooks skip
them).

The forward depends on the batch: the experts' capacity is a function of
the token count. :attr:`MoeBert.batch_dependent_forward` says so, and
``serving.export_model`` then writes a static-batch artifact, as the
reference's export falls back to one.

Under an ``auto`` step over N batch ranks the MoE layers route the
global batch: the model passes the step's batch ranks
(``runtime/distributed.batch_ranks``) to ``ops/moe.moe_ffn``, whose slot
positions continue the earlier ranks' counts, whose capacity is the
global one and whose routing statistics are averaged over the ranks
before the aux losses, as the reference's GSPMD program does. The loss
(:func:`moe_mlm_loss`, also ``pipe_moe_bert``'s) reports its token
weight, so the step weighs each rank's MLM mean by its share, and its
routing losses, the same on every rank here, under ``LOSS_GLOBAL``,
which the step averages unweighted. A ``shard_map`` step routes each
rank's tokens, as the reference's. :meth:`MoeBert.sharding_rules` carries the reference's
expert and TP rules as data. Bound to a mesh (``bind_mesh``) with
``expert`` > 1 each MoE layer runs this rank's E/ep experts on the
whole batch's slots (every ``expert`` rank holds the same rows and
routes alike) and joins their outputs over ``expert`` before the
combine; with ``model`` > 1 the attention halves and dense FFNs are
BERT's tensor-parallel ones and each expert runs on this rank's hidden
columns (EP x TP: ``w_in`` [E/ep, H, I/tp]).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import TrainConfig
from ..ops import losses, moe, nn
from ..parallel.mesh import AxisNames
from ..runtime import distributed
from .base import checked_params, generator, register_model, remat_call
from .bert import Bert, BertConfig, _make
from .bert import params_to_numpy as _bert_params_to_numpy


@dataclasses.dataclass
class MoeFields:
    """The MoE knobs of both MoE-BERTs (``moe_bert``, ``pipe_moe_bert``),
    mixed into their configs."""
    n_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 1.25
    aux_weight: float = 0.01      # load-balancing loss weight
    router_z_weight: float = 0.0  # ST-MoE router z-loss weight


@dataclasses.dataclass
class MoeBertConfig(MoeFields, BertConfig):
    moe_every: int = 2            # a MoE FFN every k-th layer (offset k-1)
    jitter: float = 0.0           # router input noise U[1-j, 1+j], train

    @classmethod
    def tiny(cls) -> "MoeBertConfig":
        return cls(vocab_size=1000, hidden=128, layers=2, heads=4,
                   intermediate=256, max_len=128, max_predictions=8,
                   n_experts=4, capacity_factor=2.0)


def moe_mlm_loss(model, params, extras, batch, gen=None):
    """A MoE-BERT's loss (``MoeBert``'s and ``PipeMoeBert``'s ``loss``):
    ``(mlm + aux_weight * lb + router_z_weight * z, (metrics, extras))``
    with the reference's metrics: ``mlm_accuracy``, ``mlm_loss``,
    ``aux_loss``, ``router_z_loss``, ``dropped_token_fraction`` and, where
    the model reports it, ``expert_load`` [E] with its min and max; and,
    for the sync step, the prediction weight (``LOSS_WEIGHT``) and the
    routing losses' part (``LOSS_GLOBAL``)."""
    seq_out, aux = model.encode_with_aux(params, batch, gen, train=True)
    w = model._weights(batch, seq_out.device)
    mlm, acc = model._mlm_loss_and_acc(params, seq_out, batch, w)
    routing = (model.cfg.aux_weight * aux["lb_loss"]
               + model.cfg.router_z_weight * aux["z_loss"])
    metrics = {"mlm_accuracy": acc, "mlm_loss": mlm,
               "aux_loss": aux["lb_loss"], "router_z_loss": aux["z_loss"],
               "dropped_token_fraction": aux["dropped_fraction"]}
    if "expert_load" in aux:
        load = aux["expert_load"]
        metrics.update(expert_load=load, expert_load_min=torch.min(load),
                       expert_load_max=torch.max(load))
    metrics.update({losses.LOSS_WEIGHT: w.sum(),
                    losses.LOSS_GLOBAL: routing})
    return mlm + routing, (metrics, extras)


class MoeBert(Bert):
    def sharding_rules(self, mesh_shape):
        """Bert's Megatron TP rules + expert-sharded MoE weights (the
        reference's: with ``expert`` and ``model`` at 1 they are Bert's,
        the fsdp fallback)."""
        from ..parallel.mesh import AxisNames
        from ..parallel.sharding import P, ShardingRules
        E = AxisNames.EXPERT
        M = AxisNames.MODEL
        base = super().sharding_rules(mesh_shape)
        ep = getattr(mesh_shape, "expert", 1) if mesh_shape else 1
        tp = getattr(mesh_shape, "model", 1) if mesh_shape else 1
        e = E if ep > 1 else None
        m = M if tp > 1 else None
        if e is None and m is None:
            return base
        rules = [
            (r"moe/w_in", P(e, None, m)),
            (r"moe/b_in", P(e, m)),
            (r"moe/w_out", P(e, m, None)),
            (r"moe/b_out", P(e, None)),
        ] + list(base.rules)
        return ShardingRules(rules=rules,
                             fsdp_axis_size=base.fsdp_axis_size)

    name = "moe_bert"
    #: the forward's arithmetic depends on the batch size (expert
    #: capacity = f(token count)): its export is static-batch
    batch_dependent_forward = True

    def __init__(self, cfg: MoeBertConfig, dtype=torch.float32,
                 attention_impl: str = "xla", param_dtype=torch.float32,
                 remat: str = "none", attention_kwargs: dict | None = None,
                 attention_fn=None):
        super().__init__(cfg, dtype=dtype, attention_impl=attention_impl,
                         param_dtype=param_dtype, remat=remat,
                         attention_kwargs=attention_kwargs,
                         attention_fn=attention_fn)
        self.cfg: MoeBertConfig = cfg
        #: the bound mesh when its ``expert`` axis splits the experts
        self.ep = None

    def bind_mesh(self, mesh) -> None:
        """BERT's ``model`` binding, and with ``expert`` > 1 the MoE
        layers on this rank's experts (None: the whole model). Raises
        ValueError when the experts do not split over ``expert``."""
        ep = mesh.shape[AxisNames.EXPERT] if mesh is not None else 1
        if ep > 1 and self.cfg.n_experts % ep:
            raise ValueError(f"n_experts={self.cfg.n_experts} not "
                             f"divisible by expert axis size {ep}")
        super().bind_mesh(mesh)
        self.ep = mesh if ep > 1 else None

    def _is_moe_layer(self, i: int) -> bool:
        return (i % self.cfg.moe_every) == (self.cfg.moe_every - 1)

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        c = self.cfg
        out = super().param_shapes()
        for i in range(c.layers):
            if not self._is_moe_layer(i):
                continue
            p = f"layer_{i}"
            for n in ("in/kernel", "in/bias", "out/kernel", "out/bias"):
                del out[f"{p}/ffn/{n}"]
            out[f"{p}/moe/router/kernel"] = (c.hidden, c.n_experts)
            out[f"{p}/moe/w_in"] = (c.n_experts, c.hidden, c.intermediate)
            out[f"{p}/moe/b_in"] = (c.n_experts, c.intermediate)
            out[f"{p}/moe/w_out"] = (c.n_experts, c.intermediate, c.hidden)
            out[f"{p}/moe/b_out"] = (c.n_experts, c.hidden)
        return out

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """BERT's init, then each MoE layer's FFN replaced by a router and
        stacked experts drawn from the same generator."""
        c = self.cfg
        gen = generator(seed, device)
        params = super().init(gen)
        for i in range(c.layers):
            if self._is_moe_layer(i):
                lp = params[f"layer_{i}"]
                del lp["ffn"]
                lp["moe"] = moe.moe_ffn_init(gen, c.n_experts, c.hidden,
                                             c.intermediate,
                                             param_dtype=self.param_dtype)
        return params

    # ------------------------------------------------------------------
    def _moe_layer(self, lp, h, mask, key, jitter_key, ranks=None):
        """One MoE encoder layer: MHA -> add & LN -> MoE FFN -> add & LN;
        ``(h, aux)``. Its randomness is its keys' (dropout, router
        jitter), so :func:`remat_call` can recompute it. ``ranks``: the
        batch ranks it routes over (None: its rows alone)."""
        c = self.cfg
        h = self._attn_block(lp, h, mask, key)
        f, aux = moe.moe_ffn(lp["moe"], h, n_experts=c.n_experts,
                             top_k=c.top_k,
                             capacity_factor=c.capacity_factor,
                             dtype=self.dtype, key=jitter_key,
                             jitter=c.jitter, tp=self.tp, ep=self.ep,
                             ranks=ranks)
        return self._ffn_block(lp, h, f, key), aux

    def encode_with_aux(self, params, batch, gen=None, train: bool = False):
        """BERT's encoder with the MoE FFNs swapped in -> (sequence output,
        aux): the load-balancing and z-losses summed over the MoE layers,
        ``dropped_fraction`` and ``expert_load`` their mean. Router
        jitter runs only in training with a generator: its key is the
        layer's (the step generator's seed folded with the layer index)
        folded with 3, as the reference folds its layer key. Inside an
        ``auto`` step over several batch ranks the layers route the
        global batch."""
        c = self.cfg
        ranks = distributed.batch_ranks()
        key = nn.dropout_key(gen, c.dropout, train)
        jkey = (gen.initial_seed()
                if train and c.jitter > 0 and gen is not None else None)
        h, mask = self._embed(params, batch, key)
        dev = h.device
        total = {
            "lb_loss": torch.zeros((), device=dev),
            "z_loss": torch.zeros((), device=dev),
            "dropped_fraction": torch.zeros((), device=dev),
            "expert_load": torch.zeros((c.n_experts,), device=dev),
        }
        n_moe = 0
        for i in range(c.layers):
            lp = params[f"layer_{i}"]
            lkey = None if key is None else nn.fold_in(key, i)
            if self._is_moe_layer(i):
                jk = (None if jkey is None
                      else nn.fold_in(nn.fold_in(jkey, i), 3))
                h, aux = remat_call(self.remat, self._moe_layer, lp, h, mask,
                                    lkey, jk, ranks)
                total = {k: v + aux[k] for k, v in total.items()}
                n_moe += 1
            else:
                h = remat_call(self.remat, self._layer, lp, h, mask, lkey)
        # the losses stay sums (each router is its own target); the
        # visibility statistics become means
        for k in ("dropped_fraction", "expert_load"):
            total[k] = total[k] / max(1, n_moe)
        return h, total

    def encode(self, params, batch, gen=None, train: bool = False):
        return self.encode_with_aux(params, batch, gen, train)[0]

    loss = moe_mlm_loss


# ---------------------------------------------------------------------------
# weight bridge: the reference's flat npz keys <-> the port's params
# ---------------------------------------------------------------------------

def params_from_numpy(model: MoeBert, tree, device=None) -> dict:
    """The reference's MoE-BERT params as numpy arrays keyed as its
    checkpoint ``_flatten`` keys them (``layer_{i}/moe/{router/kernel,
    w_in,b_in,w_out,b_out}`` on the MoE layers) -> the port's params on
    ``device`` (``cuda`` by default). Raises on a missing, unknown or
    mis-shaped key."""
    return checked_params("MoE-BERT", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict:
    """The inverse bridge, in the reference's checkpoint layout."""
    return _bert_params_to_numpy(params)


def _apply_moe_overrides(cfg: MoeBertConfig,
                         config: TrainConfig) -> MoeBertConfig:
    """The ``--moe_*`` knobs, with the reference's checks and messages;
    None keeps the model's default."""
    if config.moe_experts is not None:
        if config.moe_experts < 1:
            raise ValueError(
                f"moe_experts={config.moe_experts} must be >= 1")
        cfg.n_experts = config.moe_experts
    if config.moe_top_k is not None:
        cfg.top_k = config.moe_top_k
    if not 1 <= cfg.top_k <= cfg.n_experts:
        # the combined result: --moe_experts alone can push n_experts
        # below the model's default top_k
        raise ValueError(
            f"moe_top_k={cfg.top_k} must be in "
            f"[1, n_experts={cfg.n_experts}]")
    if config.moe_capacity_factor is not None:
        if config.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor={config.moe_capacity_factor} "
                "must be > 0 (capacity would clamp to 1 slot and drop "
                "nearly every token)")
        cfg.capacity_factor = config.moe_capacity_factor
    if config.moe_every is not None:
        if not 1 <= config.moe_every <= cfg.layers:
            raise ValueError(
                f"moe_every={config.moe_every} must be in [1, layers="
                f"{cfg.layers}] (larger would yield zero MoE layers)")
        cfg.moe_every = config.moe_every
    if config.moe_aux_weight is not None:
        if config.moe_aux_weight < 0:
            raise ValueError(
                f"moe_aux_weight={config.moe_aux_weight} must be >= 0")
        cfg.aux_weight = config.moe_aux_weight
    if config.moe_router_z_weight is not None:
        if config.moe_router_z_weight < 0:
            raise ValueError(f"moe_router_z_weight="
                             f"{config.moe_router_z_weight} must be >= 0")
        cfg.router_z_weight = config.moe_router_z_weight
    if config.moe_jitter is not None:
        if not 0 <= config.moe_jitter < 1:
            raise ValueError(
                f"moe_jitter={config.moe_jitter} must be in [0, 1) "
                "(multiplicative noise amplitude)")
        cfg.jitter = config.moe_jitter
    return cfg


@register_model("moe_bert")
def _make_moe_bert(config: TrainConfig) -> MoeBert:
    return _make(config, _apply_moe_overrides(MoeBertConfig(), config),
                 cls=MoeBert)


@register_model("moe_bert_tiny")
def _make_moe_bert_tiny(config: TrainConfig) -> MoeBert:
    # tiny keeps its own small vocab
    return _make(config, _apply_moe_overrides(MoeBertConfig.tiny(), config),
                 config_vocab=False, cls=MoeBert)
