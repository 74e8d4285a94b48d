"""BERT masked LM (port of ``distributed_tensorflow_example_tpu/models/
bert.py``; the reference's workload 5, ``BASELINE.json`` "BERT-base MLM
fine-tune").

Architecture (post-LN BERT): word + position + type embeddings ->
layernorm; N layers of MHA -> add & LN -> FFN (tanh GELU) -> add & LN;
the MLM head (dense -> GELU -> LN -> the word table, tied, plus a bias)
at the ``max_predictions`` masked positions only, so the [B, S, V]
logits never exist. Parameters are the reference's nested dict, same
keys and layouts, so checkpoints cross between the packages with no
transposes (:func:`params_from_numpy` / :func:`params_to_numpy`).

Attention is non-causal under the batch's ``attention_mask`` (a padded
key gets no weight; a padded query still attends to the valid keys; a
row with no valid key gives zeros). With ``attention_impl="flash"``
every layer runs the flash kernels: B1 forward, B2a and B2b (or B3 with
``attention_bwd="fused"``) backward.

Numerics follow the reference: matmuls in the compute dtype with f32
accumulation, layernorm statistics in f32 (eps 1e-6), the tanh
approximation of GELU (``jax.nn.gelu``'s default; torch's default is the
exact erf), the residual stream in the compute dtype after the embedding
layernorm, f32 MLM logits.

Dropout (rate 0.1 while training) draws from keys, not from a running
generator: the step's generator gives a key (its seed), each layer folds
its index into it and each dropout site its own number
(:func:`~..ops.nn.fold_in`), as the reference folds its PRNG key. So a
layer draws the same masks when ``remat`` recomputes it in the backward.

``remat`` recomputes each encoder layer in the backward
(``torch.utils.checkpoint``, non-reentrant): ``"full"`` keeps only the
layer's input; ``"dots"`` also keeps the dense layers' matmul outputs
(``aten.mm``/``aten.addmm``, selective checkpointing) and recomputes the
rest, the attention included, as JAX's
``dots_with_no_batch_dims_saveable`` does. Under remat the flash
forward runs twice a layer.

The encoder layer is an attention half and an FFN tail
(:meth:`Bert._attn_block`, :meth:`Bert._ffn_block`), which MoE-BERT
(``models/moe.py``) shares. :meth:`Bert.sharding_rules` carries the
reference's tensor-parallel rules as data. Bound to a mesh with a
``model`` axis of M > 1 (``bind_mesh``, :class:`~.base.
TensorParallelMixin`), the layers compute on this rank's pieces:
heads / M heads a rank through the attention, FFN columns, the
vocab-parallel word embedding, and the tied MLM decoder with its
``mlm/bias`` on the rank's vocab range; with ``model`` at 1 the rules
are the fsdp fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ckpt.checkpoint import to_numpy
from ..config import TrainConfig, flash_attention_kwargs, lm_loss_settings
from ..ops import losses, nn
from ..ops.attention import multi_head_attention
from .base import (TensorParallelMixin, cast_floating, check_remat,
                   checked_params, generator, key_mask, register_model,
                   remat_call, resolve_dtype)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    max_predictions: int = 20     # masked positions per sequence (static)
    #: MLM-head loss (ops/losses.py lm_head_xent): "full" materializes the
    #: [B, M, V] logits (M = max_predictions, small), "fused" goes
    #: blockwise over the vocab; "chunked" is the causal LM's and refused
    lm_loss_impl: str = "full"
    lm_loss_vocab_block: int = 0  # fused: vocab tile (0 = default)

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def large(cls) -> "BertConfig":
        return cls(hidden=1024, layers=24, heads=16, intermediate=4096)

    @classmethod
    def tiny(cls) -> "BertConfig":
        """2-layer test-size config."""
        return cls(vocab_size=1000, hidden=128, layers=2, heads=4,
                   intermediate=256, max_len=128, max_predictions=8)


class Bert(TensorParallelMixin):
    #: TP rules for the (non-stacked) embedding/MLM head — shared with
    #: PipeBert's PP×TP rules in the reference
    TP_EMBED_RULES: tuple = (
        (r"embed/word/table", ("model", None)),   # vocab-sharded
        (r"mlm/bias", ("model",)),
    )

    def sharding_rules(self, mesh_shape):
        """Megatron-style TP + vocab-sharded embeddings; fsdp fallback."""
        from ..parallel.mesh import AxisNames
        from ..parallel.sharding import P, ShardingRules
        M = AxisNames.MODEL
        fsdp = getattr(mesh_shape, "fsdp", 1) if mesh_shape else 1
        tp = getattr(mesh_shape, "model", 1) if mesh_shape else 1
        if tp <= 1:
            return ShardingRules(fsdp_axis_size=fsdp)
        return ShardingRules(rules=[
            (r"attn/(q|k|v)/kernel", P(None, M)),
            (r"attn/(q|k|v)/bias", P(M)),
            (r"attn/o/kernel", P(M, None)),
            (r"ffn/in/kernel", P(None, M)),
            (r"ffn/in/bias", P(M)),
            (r"ffn/out/kernel", P(M, None)),
            *((pat, P(*spec)) for pat, spec in self.TP_EMBED_RULES),
        ], fsdp_axis_size=fsdp)

    name = "bert"

    def __init__(self, cfg: BertConfig, dtype=torch.float32,
                 attention_impl: str = "xla", param_dtype=torch.float32,
                 remat: str = "none", attention_kwargs: dict | None = None,
                 attention_fn=None):
        if cfg.hidden % cfg.heads:
            raise ValueError(f"hidden {cfg.hidden} is not a multiple of "
                             f"heads {cfg.heads}")
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be xla/flash, got "
                             f"{attention_impl!r}")
        check_remat(remat)
        if cfg.lm_loss_impl not in ("full", "fused"):
            raise ValueError(
                "bert lm_loss_impl must be 'full' or 'fused' "
                f"(got {cfg.lm_loss_impl!r}; 'chunked' chunks a causal "
                "LM's sequence axis — the MLM head already touches only "
                "max_predictions positions)")
        if cfg.lm_loss_vocab_block < 0:
            raise ValueError(f"lm_loss_vocab_block="
                             f"{cfg.lm_loss_vocab_block} must be >= 0")
        if cfg.lm_loss_vocab_block and cfg.lm_loss_impl != "fused":
            raise ValueError(
                f"lm_loss_vocab_block={cfg.lm_loss_vocab_block} tunes "
                "the fused vocab scan and requires lm_loss_impl='fused'")
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.attention_impl = attention_impl
        self.attention_kwargs = dict(attention_kwargs or {})
        #: an attention in place of ``multi_head_attention`` (q, k, v,
        #: ``mask=`` [B, S] key validity), e.g. ``parallel.ring_attention.
        #: make_ring_attention(mesh)`` for sequence parallelism; None:
        #: the ``attention_impl`` path
        self.attention_fn = attention_fn
        self.remat = remat
        self.head_dim = cfg.hidden // cfg.heads

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Every flat parameter key, in the reference's naming, with its
        shape."""
        c = self.cfg
        out = {"embed/word/table": (c.vocab_size, c.hidden),
               "embed/pos/table": (c.max_len, c.hidden),
               "embed/type/table": (c.type_vocab, c.hidden)}
        ln = ("scale", "bias")
        out.update({f"embed_ln/{n}": (c.hidden,) for n in ln})
        for i in range(c.layers):
            p = f"layer_{i}"
            for n in ("q", "k", "v", "o"):
                out[f"{p}/attn/{n}/kernel"] = (c.hidden, c.hidden)
                out[f"{p}/attn/{n}/bias"] = (c.hidden,)
            for n in ("attn_ln", "ffn_ln"):
                out.update({f"{p}/{n}/{x}": (c.hidden,) for x in ln})
            out[f"{p}/ffn/in/kernel"] = (c.hidden, c.intermediate)
            out[f"{p}/ffn/in/bias"] = (c.intermediate,)
            out[f"{p}/ffn/out/kernel"] = (c.intermediate, c.hidden)
            out[f"{p}/ffn/out/bias"] = (c.hidden,)
        out["mlm/transform/kernel"] = (c.hidden, c.hidden)
        out["mlm/transform/bias"] = (c.hidden,)
        out.update({f"mlm/ln/{n}": (c.hidden,) for n in ln})
        out["mlm/bias"] = (c.vocab_size,)
        return out

    def init(self, seed: int | torch.Generator = 0, device=None) -> dict:
        """Seeded random parameters on ``device`` (``cuda`` by default;
        a generator brings its own device)."""
        c = self.cfg
        gen = generator(seed, device)
        dev = gen.device
        params: dict = {
            "embed": {
                "word": nn.embedding_init(gen, c.vocab_size, c.hidden),
                "pos": nn.embedding_init(gen, c.max_len, c.hidden),
                "type": nn.embedding_init(gen, c.type_vocab, c.hidden),
            },
            "embed_ln": nn.layernorm_init(c.hidden, device=dev),
        }
        for i in range(c.layers):
            params[f"layer_{i}"] = {
                "attn": {n: nn.dense_init(gen, c.hidden, c.hidden,
                                         init="glorot")
                         for n in ("q", "k", "v", "o")},
                "attn_ln": nn.layernorm_init(c.hidden, device=dev),
                "ffn": {
                    "in": nn.dense_init(gen, c.hidden, c.intermediate,
                                        init="glorot"),
                    "out": nn.dense_init(gen, c.intermediate, c.hidden,
                                         init="glorot"),
                },
                "ffn_ln": nn.layernorm_init(c.hidden, device=dev),
            }
        params["mlm"] = {
            "transform": nn.dense_init(gen, c.hidden, c.hidden,
                                       init="glorot"),
            "ln": nn.layernorm_init(c.hidden, device=dev),
            # the decoder's kernel is the word table (tied): a bias only
            "bias": torch.zeros(c.vocab_size, device=dev),
        }
        return cast_floating(params, self.param_dtype)

    # ------------------------------------------------------------------
    def _attend(self, p, h, mask):
        """Column-parallel q/k/v on the rank's head block, the attention
        over those heads, the row-parallel o (whole heads unbound)."""
        b, s, _ = h.shape
        q, k, v = self._qkv(p, h)
        if self.attention_fn is not None:
            ctx = self.attention_fn(q, k, v, mask=mask)
        else:
            ctx = multi_head_attention(
                q, k, v, mask=mask[:, None, None, :],
                impl=self.attention_impl,
                flash_kwargs=self.attention_kwargs or None)
        return self._row_dense(p["o"], ctx.reshape(b, s, -1))

    def _embed(self, params, batch, key):
        """The embedding front end -> (h [B, S, hidden] in the compute
        dtype, the int32 key mask)."""
        c = self.cfg
        word = params["embed"]["word"]
        ids = torch.as_tensor(batch["input_ids"],
                              device=word["table"].device)
        s = ids.shape[1]
        types = batch.get("token_type_ids")
        types = (torch.zeros_like(ids) if types is None
                 else torch.as_tensor(types, device=ids.device))
        mask = key_mask(batch.get("attention_mask"), ids)
        h = (self._embed_rows(word["table"], ids)
             + nn.embedding(params["embed"]["pos"],
                            torch.arange(s, device=ids.device))[None]
             + nn.embedding(params["embed"]["type"], types))
        # the residual stream rides in the compute dtype from here on
        h = nn.layernorm(params["embed_ln"], h).to(self.dtype)
        return nn.keyed_dropout(key, 1000, h, c.dropout), mask

    def _attn_block(self, lp, h, mask, key):
        """MHA -> dropout -> add & LN: the attention half every encoder
        layer shares (MoE-BERT swaps only the FFN half)."""
        a = self._attend(lp["attn"], h, mask)
        a = nn.keyed_dropout(key, 1, a, self.cfg.dropout)
        return nn.layernorm(lp["attn_ln"], h + a.to(h.dtype))

    def _ffn_block(self, lp, h, f, key):
        """dropout -> add & LN, the tail applied to an FFN output ``f``."""
        f = nn.keyed_dropout(key, 2, f, self.cfg.dropout)
        return nn.layernorm(lp["ffn_ln"], h + f.to(h.dtype))

    def _layer(self, lp, h, mask, key):
        """One encoder layer: MHA -> dropout -> add & LN -> FFN (GELU) ->
        dropout -> add & LN. Its masks are those of ``key`` (None: no
        dropout), so :func:`remat_call` can recompute it."""
        h = self._attn_block(lp, h, mask, key)
        f = nn.dense(lp["ffn"]["in"], self._column_in(h), dtype=self.dtype)
        f = nn.gelu(f.float()).to(self.dtype)
        f = self._row_dense(lp["ffn"]["out"], f)
        return self._ffn_block(lp, h, f, key)

    def encode(self, params, batch, gen=None, train: bool = False):
        """[B, S] ids -> [B, S, hidden] sequence output. ``gen`` (with
        ``train``) gives the dropout key."""
        key = nn.dropout_key(gen, self.cfg.dropout, train)
        h, mask = self._embed(params, batch, key)
        for i in range(self.cfg.layers):
            lkey = None if key is None else nn.fold_in(key, i)
            h = remat_call(self.remat, self._layer, params[f"layer_{i}"], h,
                           mask, lkey)
        return h

    def mlm_hidden(self, params, seq_out, masked_positions):
        """The masked positions through the MLM transform: [B, S, hidden]
        + [B, M] -> [B, M, hidden] f32, the stream the tied decoder (full
        or fused) reads."""
        pos = torch.as_tensor(masked_positions, device=seq_out.device).long()
        h = torch.gather(seq_out, 1,
                         pos[..., None].expand(-1, -1, seq_out.shape[-1]))
        h = nn.dense(params["mlm"]["transform"], h.to(self.dtype),
                     dtype=self.dtype)
        h = nn.gelu(h.float())
        return nn.layernorm(params["mlm"]["ln"], h)

    def mlm_logits(self, params, seq_out, masked_positions):
        """The masked positions decoded against the tied word table plus
        the MLM bias: [B, M, V] f32 logits (under TP the rank's vocab
        piece's, gathered into the whole vocab's)."""
        h = self.mlm_hidden(params, seq_out, masked_positions)
        return self._whole_logits(losses._head_logits(
            h, params["embed"]["word"]["table"], params["mlm"]["bias"],
            self.dtype))

    def _mlm_loss_and_acc(self, params, seq_out, batch, w):
        """(masked-LM xent, accuracy) by ``cfg.lm_loss_impl`` (``full``
        or ``fused``; on the rank's vocab piece under TP); ``w`` is the
        per-prediction weight."""
        labels = torch.as_tensor(batch["masked_labels"],
                                 device=seq_out.device)
        h = self.mlm_hidden(params, seq_out, batch["masked_positions"])
        return losses.lm_head_xent(
            h, params["embed"]["word"]["table"], labels, w,
            bias=params["mlm"]["bias"], impl=self.cfg.lm_loss_impl,
            vocab_block=self.cfg.lm_loss_vocab_block, dtype=self.dtype,
            tp=self.tp)

    def _weights(self, batch, device) -> torch.Tensor:
        return torch.as_tensor(batch["masked_weights"], device=device).float()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def apply(self, params, extras, batch):
        """(MLM logits [B, M, V] f32, extras) with no dropout."""
        seq_out = self.encode(params, batch)
        return (self.mlm_logits(params, seq_out, batch["masked_positions"]),
                extras)

    def loss(self, params, extras, batch, gen=None):
        """The training loss: ``(loss, ({"mlm_accuracy": acc,
        LOSS_WEIGHT: predictions}, extras))`` (the sync step drops the
        weight from the metrics). Dropout keys come from ``gen`` (none
        when it is None)."""
        seq_out = self.encode(params, batch, gen, train=True)
        w = self._weights(batch, seq_out.device)
        loss, acc = self._mlm_loss_and_acc(params, seq_out, batch, w)
        return loss, ({"mlm_accuracy": acc, losses.LOSS_WEIGHT: w.sum()},
                      extras)

    @torch.no_grad()
    def eval_metrics(self, params, extras, batch) -> dict:
        """Loss and MLM accuracy with no dropout; an optional
        ``__valid__`` [B] zeroes the padding rows of an eval tail."""
        seq_out = self.encode(params, batch)
        w = self._weights(batch, seq_out.device)
        valid = batch.get("__valid__")
        if valid is not None:
            w = w * torch.as_tensor(valid, device=w.device).float()[:, None]
        loss, acc = self._mlm_loss_and_acc(params, seq_out, batch, w)
        return {"loss": loss, "mlm_accuracy": acc}

    def dummy_batch(self, batch_size: int) -> dict:
        c = self.cfg
        rs = np.random.RandomState(0)
        s = min(128, c.max_len)
        m = c.max_predictions
        return {
            "input_ids": rs.randint(0, c.vocab_size, (batch_size, s),
                                    dtype=np.int32),
            "token_type_ids": np.zeros((batch_size, s), np.int32),
            "attention_mask": np.ones((batch_size, s), np.int32),
            "masked_positions": np.tile(np.arange(m, dtype=np.int32),
                                        (batch_size, 1)),
            "masked_labels": rs.randint(0, c.vocab_size, (batch_size, m),
                                        dtype=np.int32),
            "masked_weights": np.ones((batch_size, m), np.float32),
        }


# ---------------------------------------------------------------------------
# weight bridge: the reference's flat npz keys <-> the port's params
# ---------------------------------------------------------------------------

def params_from_numpy(model: Bert, tree, device=None) -> dict:
    """The reference's BERT params as numpy arrays keyed as its checkpoint
    ``_flatten`` keys them -> the port's params on ``device`` (``cuda``
    by default). Raises on a missing, unknown or mis-shaped key."""
    return checked_params("BERT", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge, in the reference's checkpoint layout."""
    return to_numpy(params)


def _make(config: TrainConfig, cfg: BertConfig, *,
          config_vocab: bool = True, cls: type | None = None) -> Bert:
    """One factory for every size and family (MoE-BERT passes ``cls``),
    so the knobs reach each registered variant the same way."""
    if config_vocab:
        cfg.vocab_size = config.data.vocab_size
    # a long --seq_len grows the position table
    cfg.max_len = max(cfg.max_len, config.data.seq_len)
    ls = lm_loss_settings(config)
    cfg.lm_loss_impl = ls["impl"]
    cfg.lm_loss_vocab_block = ls["vocab_block"]
    return (cls or Bert)(cfg, dtype=resolve_dtype(config.dtype),
                         attention_impl=config.attention_impl,
                         param_dtype=resolve_dtype(config.param_dtype),
                         remat=config.remat,
                         attention_kwargs=flash_attention_kwargs(config))


@register_model("bert")
def _make_bert(config: TrainConfig) -> Bert:
    return _make(config, BertConfig.base())


@register_model("bert_large")
def _make_bert_large(config: TrainConfig) -> Bert:
    return _make(config, BertConfig.large())


@register_model("bert_tiny")
def _make_bert_tiny(config: TrainConfig) -> Bert:
    # tiny keeps its own small vocab
    return _make(config, BertConfig.tiny(), config_vocab=False)
