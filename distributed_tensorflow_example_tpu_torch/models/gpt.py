"""GPT-style causal language model + KV-cache generation (port of
``distributed_tensorflow_example_tpu/models/gpt.py``: training loss,
evaluation and generation).

Architecture (GPT-2 layout): learned token + position embeddings, pre-LN
blocks (``h += attn(ln1(h)); h += ffn(ln2(h))``), final layernorm, LM
head weight-tied to the token embedding. Parameters are the reference's
nested dict with the same keys and layouts (dense kernels [in, out]), so
the weight bridge (:func:`params_from_numpy` / :func:`params_to_numpy`)
moves them across with no transposes.

Generation: one full causal prefill over the prompt (the flash-attention
kernel per layer with ``attention_impl="flash"``), then a Python decode
loop over a static [B, T, H, D] per-layer KV-cache slab, one token per
step, each layer's attention the single-query decode kernel. Where the
reference threads immutable caches through ``lax.scan``, the port writes
each step's K/V into the slab IN PLACE (the returned caches are the same
tensors): one slab per generation, no per-step copies.

Serving engine steps: :meth:`GPT.decode_step_batched` (per-row depths
over a slab pool, the slab decode kernel), :meth:`GPT.paged_prefill`
(a left-aligned prompt written in whole blocks through a block-table row),
:meth:`GPT.paged_prefill_chunk` (one block-aligned chunk of it, the prior
chunks read back through the table), :meth:`GPT.decode_step_batched_paged`
(per-row depths read and written through block tables, the paged decode
kernel) and :meth:`GPT.decode_verify_batched_paged` (speculative decoding's
K-token verify: K lanes of a row as K rows of the paged kernel sharing one
block-table row). They too write their pools in place. The paged ones
take int8 pools with per-token-slot f32 scales: each K/V row is quantized
on write (:func:`quantize_kv_rows`) and the decode steps attend through
the int8 kernel. ``weight_quant="int8"`` stores the decode layers' four
matmul kernels as per-output-channel int8 and dequantizes one layer at a
time inside the step.

Training: :meth:`GPT.loss` is the next-token loss the sync step
differentiates (``(loss, ({"token_accuracy"}, extras))``, padding carries
no loss), with dropout after the embeddings, the attention output and the
FFN output when ``train`` and a ``torch.Generator`` are given (its seed
is the key each layer folds its index into, as in ``models/bert.py``);
with ``attention_impl="flash"`` every layer's attention is the
differentiable flash kernel pair (B1 forward, B2a/B2b backward). The LM
head is ``ops/losses.py`` ``lm_head_xent``: ``full``, ``chunked`` or
``fused``. ``remat`` recomputes each layer in the backward as BERT's
does. ``accuracy_every_n`` > 1 computes the token-accuracy argmax on
every n-th step only (the others publish -1.0), counted by
``extras["lm_step"]``, an f32 counter that ticks once a step and is part
of the checkpoint.

Numerics follow the reference: bf16 matmuls with f32 accumulation, f32
layernorm statistics (eps 1e-6), f32 softmax, tanh-approximated GELU,
and f32 logits from the bf16-rounded hidden state and table (the logits
are never rounded to bf16, so greedy argmax does not flip on bf16 ties).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ckpt import checkpoint as ckpt
from ..config import TrainConfig, flash_attention_kwargs, lm_loss_settings
from ..ops import losses, nn
from ..ops.attention import NEG_INF, multi_head_attention
from ..ops.cuda.decode_attention import decode_attention as decode_attn
from ..ops.cuda.paged_decode_attention import \
    paged_decode_attention as paged_decode_attn
from ..runtime.device import resolve_device
from .base import (cast_floating, check_remat, checked_params, key_mask,
                   register_model, remat_call, resolve_dtype)


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of K/V entries: ``x`` [..., H, D]
    -> ``(q int8 [..., H, D], scale f32 [...])`` with ``scale = max|row| /
    127`` over each trailing [H, D] plane (an eps floor of 1e-8 makes an
    all-zero row dequantize to exact zeros). The reference's order of
    operations, ``round(xf / scale)`` rounding half to even in both
    packages, so the int8 bytes are the reference's bit for bit, and a
    function of the row values alone: the same token prefix always writes
    the same block bytes, which the prefix cache's block sharing needs."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=(-2, -1)), 1e-8) / 127.0
    q = torch.round(xf / scale[..., None, None]).to(torch.int8)
    return q, scale


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 30522       # framework default vocab (BERT wordpiece)
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_len: int = 1024
    dropout: float = 0.1
    #: LM-loss strategy (ops/losses.py lm_head_xent): "full" materializes
    #: the [B, S, vocab] f32 logits, "chunked" a sequence chunk at a time,
    #: "fused" a vocab block at a time
    loss_impl: str = "full"
    #: seq chunk for loss_impl="chunked" (> 0 with "full" is the legacy
    #: spelling of "chunked", as in the reference)
    loss_chunk: int = 0
    #: vocab tile for loss_impl="fused" (0 = the default)
    loss_vocab_block: int = 0

    @classmethod
    def small(cls) -> "GPTConfig":
        """GPT-2-small shape (124M at its native 50k vocab)."""
        return cls()

    @classmethod
    def tiny(cls) -> "GPTConfig":
        return cls(vocab_size=1000, hidden=128, layers=2, heads=4,
                   intermediate=256, max_len=128)


def _check_loss_levers(cfg: GPTConfig) -> None:
    """The reference's LM-loss lever validation (``GPT.__init__``), loud
    at model build; resolves the legacy ``loss_chunk`` spelling of
    ``"chunked"`` in place, as the reference does."""
    if cfg.loss_impl not in losses.LM_LOSS_IMPLS:
        raise ValueError(f"lm_loss_impl must be one of "
                         f"{losses.LM_LOSS_IMPLS}, got {cfg.loss_impl!r}")
    if cfg.loss_chunk < 0:
        raise ValueError(f"lm_loss_chunk={cfg.loss_chunk} must be >= 0")
    if cfg.loss_vocab_block < 0:
        raise ValueError(f"lm_loss_vocab_block={cfg.loss_vocab_block} "
                         "must be >= 0")
    if cfg.loss_chunk and cfg.loss_impl == "full":
        cfg.loss_impl = "chunked"
    if cfg.loss_impl == "chunked" and not cfg.loss_chunk:
        raise ValueError("lm_loss_impl='chunked' needs lm_loss_chunk > 0 "
                         "(the chunk size)")
    if cfg.loss_impl == "fused" and cfg.loss_chunk:
        raise ValueError("lm_loss_chunk conflicts with lm_loss_impl="
                         "'fused': the fused vocab scan never materializes "
                         "full logits")
    if cfg.loss_vocab_block and cfg.loss_impl != "fused":
        raise ValueError(
            f"lm_loss_vocab_block={cfg.loss_vocab_block} tunes the fused "
            f"vocab scan and requires lm_loss_impl='fused', got "
            f"{cfg.loss_impl!r}")


class GPT:
    name = "gpt"

    def __init__(self, cfg: GPTConfig, dtype=torch.float32,
                 attention_impl: str = "xla",
                 param_dtype=torch.float32,
                 attention_kwargs: dict | None = None,
                 accuracy_every_n: int = 1, remat: str = "none"):
        if cfg.hidden % cfg.heads:
            raise ValueError(f"hidden {cfg.hidden} is not a multiple of "
                             f"heads {cfg.heads}")
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be xla/flash, got "
                             f"{attention_impl!r}")
        check_remat(remat)
        _check_loss_levers(cfg)
        if accuracy_every_n < 1:
            raise ValueError(f"token_accuracy_every_n={accuracy_every_n} "
                             "must be >= 1")
        if accuracy_every_n != 1 and cfg.loss_impl == "fused":
            raise ValueError(
                f"token_accuracy_every_n={accuracy_every_n} skips the "
                "full/chunked paths' per-step argmax; lm_loss_impl="
                "'fused' computes accuracy inside the same vocab scan "
                "at no extra cost — drop the knob")
        self.accuracy_every_n = accuracy_every_n
        self.remat = remat
        self.cfg = cfg
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.attention_impl = attention_impl
        self.attention_kwargs = dict(attention_kwargs or {})
        self.head_dim = cfg.hidden // cfg.heads

    # ------------------------------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Every flat parameter key, in the reference's naming (the keys
        its checkpoint ``_flatten`` writes), with its shape."""
        c = self.cfg
        out = {"wte/table": (c.vocab_size, c.hidden),
               "wpe/table": (c.max_len, c.hidden)}
        for i in range(c.layers):
            p = f"layer_{i}"
            for ln in ("ln1", "ln2"):
                out[f"{p}/{ln}/scale"] = out[f"{p}/{ln}/bias"] = (c.hidden,)
            for n in ("q", "k", "v", "o"):
                out[f"{p}/attn/{n}/kernel"] = (c.hidden, c.hidden)
                out[f"{p}/attn/{n}/bias"] = (c.hidden,)
            out[f"{p}/ffn/in/kernel"] = (c.hidden, c.intermediate)
            out[f"{p}/ffn/in/bias"] = (c.intermediate,)
            out[f"{p}/ffn/out/kernel"] = (c.intermediate, c.hidden)
            out[f"{p}/ffn/out/bias"] = (c.hidden,)
        out["ln_f/scale"] = out["ln_f/bias"] = (c.hidden,)
        return out

    def init(self, seed: int | torch.Generator = 0, device=None):
        """Seeded random parameters on ``device`` (``cuda`` by default);
        with ``accuracy_every_n`` > 1, ``(params, {"lm_step": 0.0})``:
        the cadence counter is state, so it is checkpointed, and a run
        that turns the knob on over an older checkpoint fails at restore
        ("checkpoint missing leaf 'extras/lm_step'"), as in the
        reference."""
        c = self.cfg
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(seed))
        dev = gen.device
        params: dict = {
            "wte": nn.embedding_init(gen, c.vocab_size, c.hidden),
            "wpe": nn.embedding_init(gen, c.max_len, c.hidden),
        }
        for i in range(c.layers):
            params[f"layer_{i}"] = {
                "ln1": nn.layernorm_init(c.hidden, device=dev),
                "attn": {n: nn.dense_init(gen, c.hidden, c.hidden,
                                         init="glorot")
                         for n in ("q", "k", "v", "o")},
                "ln2": nn.layernorm_init(c.hidden, device=dev),
                "ffn": {
                    "in": nn.dense_init(gen, c.hidden, c.intermediate,
                                        init="glorot"),
                    "out": nn.dense_init(gen, c.intermediate, c.hidden,
                                         init="glorot"),
                },
            }
        params["ln_f"] = nn.layernorm_init(c.hidden, device=dev)
        params = cast_floating(params, self.param_dtype)
        if self.accuracy_every_n != 1:
            return params, {"lm_step": torch.zeros((), device=dev)}
        return params

    # ------------------------------------------------------------------
    def _qkv(self, ap, h):
        b, s, _ = h.shape

        def split(x):
            return x.reshape(b, s, self.cfg.heads, self.head_dim)

        return (split(nn.dense(ap["q"], h, dtype=self.dtype)),
                split(nn.dense(ap["k"], h, dtype=self.dtype)),
                split(nn.dense(ap["v"], h, dtype=self.dtype)))

    def _ffn(self, lp, x):
        f = nn.dense(lp["ffn"]["in"], x, dtype=self.dtype)
        f = nn.gelu(f.float()).to(self.dtype)
        return nn.dense(lp["ffn"]["out"], f, dtype=self.dtype)

    def _layer(self, lp, h, mask, key=None, *, return_kv: bool = False):
        """Pre-LN decoder block over the full (causal) sequence: ONE body
        for training, the forward and the prefill, which also yields this
        layer's (k, v) for the decode cache. Dropout on the attention and
        FFN outputs with the masks of ``key`` (None: no dropout)."""
        c = self.cfg
        b, s, _ = h.shape
        q, k, v = self._qkv(lp["attn"], nn.layernorm(lp["ln1"], h))
        ctx = multi_head_attention(
            q, k, v, mask=mask[:, None, None, :], causal=True,
            impl=self.attention_impl,
            flash_kwargs=self.attention_kwargs or None)
        a = nn.dense(lp["attn"]["o"], ctx.reshape(b, s, c.hidden),
                     dtype=self.dtype)
        h = h + nn.keyed_dropout(key, 1, a, c.dropout).to(h.dtype)
        f = self._ffn(lp, nn.layernorm(lp["ln2"], h))
        h = h + nn.keyed_dropout(key, 2, f, c.dropout).to(h.dtype)
        return (h, (k, v)) if return_kv else h

    def _embed(self, params, ids, pos_ids, key=None):
        h = (nn.embedding(params["wte"], ids)
             + nn.embedding(params["wpe"], pos_ids))
        return nn.keyed_dropout(key, 1000, h.to(self.dtype), self.cfg.dropout)

    def encode(self, params, batch, gen=None, train: bool = False):
        """[B, S] token ids (``batch["input_ids"]``, optional
        ``attention_mask``) -> [B, S, hidden] after the final layernorm.
        ``gen`` gives the dropout key when ``train``."""
        ids = torch.as_tensor(batch["input_ids"],
                              device=params["wte"]["table"].device)
        b, s = ids.shape
        mask = key_mask(batch.get("attention_mask"), ids)
        key = nn.dropout_key(gen, self.cfg.dropout, train)
        h = self._embed(params, ids,
                        torch.arange(s, device=ids.device)[None], key)
        for i in range(self.cfg.layers):
            lkey = None if key is None else nn.fold_in(key, i)
            h = remat_call(self.remat, self._layer, params[f"layer_{i}"], h,
                           mask, lkey)
        return nn.layernorm(params["ln_f"], h)

    def lm_logits(self, params, h):
        """Weight-tied LM head: [B,S,hid] -> [B,S,V] f32 logits from
        operands rounded to the compute dtype, accumulated in f32 (the
        reference's ``preferred_element_type=f32`` einsum)."""
        table = params["wte"]["table"]
        return torch.matmul(h.to(self.dtype).float(),
                            table.to(self.dtype).float().t())

    @torch.no_grad()
    def apply(self, params, extras, batch):
        """(logits [B, S, V] f32, extras): the forward of the reference's
        ``apply`` with ``train=False``."""
        return self.lm_logits(params, self.encode(params, batch)), extras

    def dummy_batch(self, batch_size: int) -> dict[str, np.ndarray]:
        """The reference's sample batch: the export's input signature."""
        c = self.cfg
        rs = np.random.RandomState(0)
        s = min(128, c.max_len)
        return {
            "input_ids": rs.randint(0, c.vocab_size, (batch_size, s),
                                    dtype=np.int32),
            "attention_mask": np.ones((batch_size, s), np.int32),
        }

    # ------------------------------------------------------------------
    def _lm_loss(self, params, h, targets, w, *, accuracy: bool = True):
        """Next-token loss + accuracy over encoded ``h`` [B, S, hid].
        ``targets``/``w`` are the S-1 shifted labels/weights, padded with
        a weight-0 dummy at position S-1 as the reference pads them.
        Returns (loss, accuracy) as weighted token means."""
        c = self.cfg
        targets = torch.cat([targets, torch.zeros_like(targets[:, :1])], 1)
        w = torch.cat([w, torch.zeros_like(w[:, :1])], 1)
        return losses.lm_head_xent(
            h, params["wte"]["table"], targets, w, impl=c.loss_impl,
            seq_chunk=c.loss_chunk, vocab_block=c.loss_vocab_block,
            dtype=self.dtype, accuracy=accuracy)

    def _targets(self, params, batch):
        ids = torch.as_tensor(batch["input_ids"],
                              device=params["wte"]["table"].device)
        mask = batch.get("attention_mask")
        mask = (torch.ones_like(ids) if mask is None
                else torch.as_tensor(mask, device=ids.device))
        return ids[:, 1:], mask[:, 1:].float()

    def loss(self, params, extras, batch, gen=None):
        """The training loss: next-token prediction, position t predicts
        token t+1, padding (``attention_mask == 0``) carries no loss.
        Returns ``(loss, ({"token_accuracy": acc, LOSS_WEIGHT: tokens},
        extras))``, the framework's loss signature (the sync step drops
        the weight from the metrics). Dropout keys come from ``gen`` (none
        when it is None). With ``accuracy_every_n`` > 1 and the counter
        in ``extras``, the argmax runs only when ``lm_step`` is a
        multiple of n (else the accuracy is -1.0), and the new extras
        carry ``lm_step + 1``."""
        targets, w = self._targets(params, batch)
        h = self.encode(params, batch, gen, train=True)
        every = self.accuracy_every_n
        step = (extras.get("lm_step")
                if every != 1 and isinstance(extras, dict) else None)
        weight = {losses.LOSS_WEIGHT: w.sum()}
        if every == 1 or self.cfg.loss_impl == "fused" or step is None:
            loss, acc = self._lm_loss(params, h, targets, w)
            return loss, ({"token_accuracy": acc, **weight}, extras)
        # the branch is taken on the host: the counter is read after the
        # forward is queued, so the card keeps working while the host
        # waits for the previous step's update
        on = bool(torch.remainder(step, float(every)) == 0)
        loss, acc = self._lm_loss(params, h, targets, w, accuracy=on)
        return loss, ({"token_accuracy": acc, **weight},
                      {**extras, "lm_step": step + 1.0})

    @torch.no_grad()
    def eval_metrics(self, params, extras, batch) -> dict:
        """Loss, perplexity and token accuracy with no dropout; an optional
        ``__valid__`` [B] marks the real rows of a padded eval batch."""
        targets, w = self._targets(params, batch)
        valid = batch.get("__valid__")
        if valid is not None:
            w = w * torch.as_tensor(valid, device=w.device).float()[:, None]
        h = self.encode(params, batch, train=False)
        loss, acc = self._lm_loss(params, h, targets, w)
        return {"loss": loss, "perplexity": torch.exp(loss),
                "token_accuracy": acc}

    # ------------------------------------------------------------------
    # autoregressive decoding (static-shape KV-cache slab)
    # ------------------------------------------------------------------
    def _prefill_full(self, params, ids, total_len: int, *, mask=None,
                      pos_ids=None):
        """Full causal forward over the (possibly padded) prompt, also
        returning per-layer K/V padded to ``total_len`` slots. Returns
        (hidden [B,S,hid] post-ln_f, caches {layer_i: {k, v}: [B,T,H,D]})."""
        _, s = ids.shape
        mask = key_mask(mask, ids)
        if pos_ids is None:
            pos_ids = torch.arange(s, device=ids.device)[None]
        h = self._embed(params, ids, pos_ids)
        caches = {}
        for i in range(self.cfg.layers):
            h, (k, v) = self._layer(params[f"layer_{i}"], h, mask,
                                    return_kv=True)
            caches[f"layer_{i}"] = {
                n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, total_len - s))
                for n, x in (("k", k), ("v", v))}
        return nn.layernorm(params["ln_f"], h), caches

    def _prefill(self, params, ids, total_len: int, *, mask=None,
                 pos_ids=None):
        """:meth:`_prefill_full` sliced to the LAST slot's hidden state
        (every row's prompt ends at slot S0-1)."""
        h, caches = self._prefill_full(params, ids, total_len, mask=mask,
                                       pos_ids=pos_ids)
        return h[:, -1], caches

    def _decode_step(self, params, caches, tok, pos: int, pad=None):
        """One-token forward against the per-layer caches: the reference
        loop path (plain attention), the parity oracle of the stacked
        step. ``tok`` [B], ``pos`` the cache slot tok sits at, ``pad`` [B]
        left-pad counts. Writes slot ``pos`` of each layer's caches in
        place. Returns (logits [B,V], caches)."""
        c = self.cfg
        b = tok.shape[0]
        dev = tok.device
        total = caches["layer_0"]["k"].shape[1]
        if pad is None:
            pad = torch.zeros(b, dtype=torch.int32, device=dev)
        h = self._embed(params, tok[:, None], (pos - pad)[:, None])
        slots = torch.arange(total, device=dev)
        kmask = (slots[None, :] <= pos) & (slots[None, :] >= pad[:, None])
        for i in range(c.layers):
            lp = params[f"layer_{i}"]
            cache = caches[f"layer_{i}"]
            q, k, v = self._qkv(lp["attn"], nn.layernorm(lp["ln1"], h))
            cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
            ctx = multi_head_attention(q, cache["k"], cache["v"],
                                       mask=kmask[:, None, None, :],
                                       impl="xla")
            a = nn.dense(lp["attn"]["o"], ctx.reshape(b, 1, c.hidden),
                         dtype=self.dtype)
            h = h + a.to(h.dtype)
            f = self._ffn(lp, nn.layernorm(lp["ln2"], h))
            h = h + f.to(h.dtype)
        h = nn.layernorm(params["ln_f"], h)
        return self.lm_logits(params, h)[:, 0], caches

    def stack_decode_params(self, params, *, weight_quant: str | None = None):
        """Restack the per-layer params along a leading layer axis, with
        Q/K/V fused into one [hid, 3*hid] kernel per layer. The dense
        kernels and biases are cast to the compute dtype here, once per
        generation (``dense`` would cast them on every step; the values
        are identical); layernorm params keep ``param_dtype``.

        ``weight_quant="int8"`` stores the four matmul kernels instead as
        symmetric per-output-channel int8 ``kernel_q`` plus an f32
        ``scale`` [L, 1, out] (the f32 kernel's column max / 127, rounded
        as the reference rounds), which :meth:`_dequant` expands one layer
        at a time inside the step. Lossy: greedy parity with the float
        path is not promised. Embeddings, the LM head and the layernorms
        stay in ``param_dtype``."""
        if weight_quant not in (None, "int8"):
            raise ValueError(f"weight_quant must be None or 'int8', got "
                             f"{weight_quant!r}")
        lps = [params[f"layer_{i}"] for i in range(self.cfg.layers)]

        def stk(fn, dtype=None):
            x = torch.stack([fn(lp) for lp in lps])
            return x if dtype is None else x.to(dtype)

        def dense_stack(fn):
            bias = stk(lambda lp: fn(lp)["bias"], self.dtype)
            if weight_quant is None:
                return {"kernel": stk(lambda lp: fn(lp)["kernel"], self.dtype),
                        "bias": bias}
            w = stk(lambda lp: fn(lp)["kernel"]).float()
            scale = torch.clamp_min(w.abs().amax(dim=1, keepdim=True),
                                    1e-8) / 127.0
            return {"kernel_q": torch.round(w / scale).to(torch.int8),
                    "scale": scale, "bias": bias}

        return {
            "ln1": {"scale": stk(lambda lp: lp["ln1"]["scale"]),
                    "bias": stk(lambda lp: lp["ln1"]["bias"])},
            "qkv": dense_stack(lambda lp: {
                "kernel": torch.cat([lp["attn"][n]["kernel"]
                                     for n in ("q", "k", "v")], dim=1),
                "bias": torch.cat([lp["attn"][n]["bias"]
                                   for n in ("q", "k", "v")])}),
            "o": dense_stack(lambda lp: lp["attn"]["o"]),
            "ln2": {"scale": stk(lambda lp: lp["ln2"]["scale"]),
                    "bias": stk(lambda lp: lp["ln2"]["bias"])},
            "ffn_in": dense_stack(lambda lp: lp["ffn"]["in"]),
            "ffn_out": dense_stack(lambda lp: lp["ffn"]["out"]),
        }

    def _dequant(self, dp):
        """int8-stacked dense params of one layer -> plain {kernel, bias}
        (unchanged for a float stack). Runs inside the layer loop, so the
        int8 tensors are what the step reads from device memory; the
        product itself stays ``torch.matmul`` in :func:`nn.dense`, as the
        reference leaves it to XLA."""
        if "kernel_q" not in dp:
            return dp
        w = dp["kernel_q"].float() * dp["scale"]
        return {"kernel": w.to(self.dtype), "bias": dp["bias"]}

    def _stacked_layers(self, params, stacked, h, attend):
        """The decode fast path's layer loop over the stacked layer axis:
        fused QKV, a 2-D [B, hid] residual stream, and
        ``attend(i, q, k, v) -> ctx`` (each [B, H, D]) for layer i's cache
        write and attention. Returns the [B, V] f32 logits."""
        c = self.cfg
        b = h.shape[0]
        for i in range(c.layers):
            lp = {g: {n: t[i] for n, t in d.items()}
                  for g, d in stacked.items()}
            qkv = nn.dense(self._dequant(lp["qkv"]),
                           nn.layernorm(lp["ln1"], h), dtype=self.dtype)
            q, k, v = [x.reshape(b, c.heads, self.head_dim)
                       for x in torch.split(qkv, c.hidden, dim=-1)]
            ctx = attend(i, q.contiguous(), k, v)
            a = nn.dense(self._dequant(lp["o"]), ctx.reshape(b, c.hidden),
                         dtype=self.dtype)
            h = h + a.to(h.dtype)
            f = nn.dense(self._dequant(lp["ffn_in"]),
                         nn.layernorm(lp["ln2"], h), dtype=self.dtype)
            f = nn.gelu(f.float()).to(self.dtype)
            f = nn.dense(self._dequant(lp["ffn_out"]), f, dtype=self.dtype)
            h = h + f.to(h.dtype)
        h = nn.layernorm(params["ln_f"], h)
        return self.lm_logits(params, h[:, None])[:, 0]

    def _decode_step_stacked(self, params, stacked, caches, tok, pos: int,
                             pad=None, decode_attention: str | None = None):
        """One-token forward over the stacked layer axis: fused QKV, a 2-D
        [B, hid] residual stream, and the cache-slab attention as the
        decode kernel (``"auto"``) or the plain reference (``"xla"``).
        ``caches``: ``{"k": [L,B,T,H,D], "v": [L,B,T,H,D]}``, slot ``pos``
        written in place. Same contract as :meth:`_decode_step`."""
        b = tok.shape[0]
        impl = decode_attention or "auto"
        if pad is None:
            pad = torch.zeros(b, dtype=torch.int32, device=tok.device)
        h = self._embed(params, tok[:, None], (pos - pad)[:, None])[:, 0]
        pos_b = torch.full((b,), pos, dtype=torch.int32, device=tok.device)

        def attend(i, q, k, v):
            ck, cv = caches["k"][i], caches["v"][i]
            ck[:, pos] = k.to(ck.dtype)
            cv[:, pos] = v.to(cv.dtype)
            return decode_attn(q, ck, cv, pos=pos_b, pad=pad, impl=impl)

        return self._stacked_layers(params, stacked, h, attend), caches

    def _row_inputs(self, tok, pos, pad, alive, pos_max: int):
        """The batched steps' per-row operands on the params' device:
        ``pos`` clipped to the cache (a dead row may carry a stale one),
        ``pad``, ``alive`` as bool, and the position ids
        ``clip(pos - pad)``, kept in range for the position table."""
        dev = tok.device
        pos = torch.as_tensor(pos, device=dev).to(torch.int32).clamp(
            0, pos_max)
        pad = torch.as_tensor(pad, device=dev).to(torch.int32)
        alive = (torch.ones(tok.shape[0], dtype=torch.bool, device=dev)
                 if alive is None
                 else torch.as_tensor(alive, device=dev) != 0)
        pos_ids = (pos - pad).clamp(0, self.cfg.max_len - 1)
        return pos, pad, alive, pos_ids

    @torch.no_grad()
    def decode_step_batched(self, params, stacked, caches, tok, pos, pad,
                            alive=None, decode_attention: str | None = None):
        """One-token forward with PER-ROW cache depths: the decode step of
        the continuous-batching engine over the slab pool. Row b's token
        writes cache slot ``pos[b]`` and carries position id ``pos[b] -
        pad[b]``; ``alive`` [B] gates the write (a dead row rewrites the
        bytes it read, so the pool stays as it was). Rows are independent.
        ``caches``: ``{"k"/"v": [L, B, T, H, D]}``, written in place.
        Returns (logits [B, V] f32, caches)."""
        tok = torch.as_tensor(tok, device=params["wte"]["table"].device)
        total = caches["k"].shape[2]
        impl = decode_attention or "auto"
        pos, pad, alive, pos_ids = self._row_inputs(tok, pos, pad, alive,
                                                    total - 1)
        h = self._embed(params, tok[:, None], pos_ids[:, None])[:, 0]
        rows = torch.arange(tok.shape[0], device=tok.device)
        live = alive[:, None, None]

        def attend(i, q, k, v):
            ck, cv = caches["k"][i], caches["v"][i]
            ck[rows, pos] = torch.where(live, k.to(ck.dtype), ck[rows, pos])
            cv[rows, pos] = torch.where(live, v.to(cv.dtype), cv[rows, pos])
            return decode_attn(q, ck, cv, pos=pos, pad=pad, impl=impl)

        return self._stacked_layers(params, stacked, h, attend), caches

    # ------------------------------------------------------------------
    # block-paged serving path: the KV pool is shared [L, N, Bs, H, D]
    # physical blocks + per-slot block tables
    # ------------------------------------------------------------------
    @torch.no_grad()
    def paged_prefill(self, params, input_ids, prompt_mask, k_pool, v_pool,
                      table_row, *, k_scale=None, v_scale=None):
        """LEFT-ALIGNED prompt prefill writing WHOLE blocks through a
        block-table row: the paged engine's admission. Token i sits at
        logical slot i (no right-packing), so a shared token prefix fills
        the same leading blocks for every request, which is what makes
        block-granularity prefix reuse possible.

        ``input_ids``/``prompt_mask``: [1, S0] (mask 1 = real token,
        left-aligned); ``k_pool``/``v_pool``: [L, N, Bs, H, D], written in
        place; ``table_row``: [ceil(S0 / Bs)] int32 physical block ids
        (unused trailing entries point at the null block 0, where their
        whole-block writes land and are never read). Returns ``(logits
        [1, V] of the last real token, k_pool, v_pool)``.

        ``k_scale``/``v_scale`` ([L, N, Bs] f32 pools beside int8 K/V
        pools) switch on quantize-on-write: each token's [H, D] row is
        stored as :func:`quantize_kv_rows` gives it, its scale in the same
        slot of the scale pool, and the return grows to ``(logits, k_pool,
        v_pool, k_scale, v_scale)``, all written in place."""
        dev = params["wte"]["table"].device
        ids = torch.as_tensor(input_ids, device=dev)
        _, s0 = ids.shape
        l, _, bs = k_pool.shape[:3]
        table_row = torch.as_tensor(table_row, device=dev).long()
        nb_p = table_row.shape[0]
        pm = torch.as_tensor(prompt_mask, device=dev) != 0
        ids = torch.where(pm, ids, torch.zeros_like(ids))
        h_full, caches = self._prefill_full(
            params, ids, nb_p * bs, mask=pm.to(torch.int32),
            pos_ids=torch.arange(s0, device=dev)[None])
        last = (pm.sum() - 1).clamp(min=0)
        last_h = h_full[:, last]                             # [1, hid]
        kv = self._stack_caches(caches)             # {"k"/"v": [L,1,T,H,D]}
        logits = self.lm_logits(params, last_h[:, None])[:, 0]
        if k_scale is None:
            for pool, x in ((k_pool, kv["k"]), (v_pool, kv["v"])):
                pool[:, table_row] = x[:, 0].reshape(
                    l, nb_p, bs, *x.shape[3:]).to(pool.dtype)
            return logits, k_pool, v_pool
        for pool, spool, x in ((k_pool, k_scale, kv["k"]),
                               (v_pool, v_scale, kv["v"])):
            q, s = quantize_kv_rows(x[:, 0])              # [L,T,H,D] / [L,T]
            pool[:, table_row] = q.reshape(l, nb_p, bs, *q.shape[2:])
            spool[:, table_row] = s.reshape(l, nb_p, bs)
        return logits, k_pool, v_pool, k_scale, v_scale

    @torch.no_grad()
    def paged_prefill_chunk(self, params, input_ids, chunk_mask, start,
                            k_pool, v_pool, table_row, chunk_blocks, *,
                            k_scale=None, v_scale=None):
        """ONE ``C``-token slice of a left-aligned paged prefill: the SLO
        scheduler's bounded-stall admission. Only the tokens at logical
        slots ``start .. start+C-1`` run; the prior chunks' K/V are read
        back from the pool through ``table_row``, so the engine can run
        shared decode steps between a long prompt's chunks.

        ``input_ids``/``chunk_mask``: [1, C] (mask 1 = real token,
        left-aligned: only a prompt's last chunk is ragged); ``start``:
        the chunk's first logical slot (block-aligned); ``table_row``:
        [NB_p] int32, the slot's whole prompt-capacity block run (the
        context window); ``chunk_blocks``: [C / Bs] int32, the physical
        blocks this chunk writes (entries past the prompt's run name the
        null block 0, never read). The chunk's K/V are written into whole
        blocks first (quantized on write with ``k_scale``/``v_scale``, as
        :meth:`paged_prefill` writes), then the window is gathered back
        and attended with the reference's causal and validity mask by the
        plain attention (the reference's ``impl="xla"``). Returns
        ``(logits [1, V] of the chunk's last real token, k_pool,
        v_pool)``, plus ``k_scale, v_scale`` for int8 pools, all written
        in place. Only the last chunk's logits matter: they are the
        request's first sample point.

        With a float pool the chunks compose to :meth:`paged_prefill`'s
        function (the softmax over the gathered window differs from the
        monolithic one only by exactly-zero masked terms); the bits agree
        where both take the same attention, so on the card, where the
        monolithic prefill runs the flash kernel, they agree to its
        tolerance. An int8 pool re-reads prior chunks dequantized, which
        the monolithic prefill never does: it rides the drift gate."""
        c = self.cfg
        dev = params["wte"]["table"].device
        ids = torch.as_tensor(input_ids, device=dev)
        cw = ids.shape[1]
        bs = k_pool.shape[2]
        table_row = torch.as_tensor(table_row, device=dev).long()
        chunk_blocks = torch.as_tensor(chunk_blocks, device=dev).long()
        nb_c = chunk_blocks.shape[0]
        total = table_row.shape[0] * bs
        start = int(start)
        cm = torch.as_tensor(chunk_mask, device=dev) != 0
        ids = torch.where(cm, ids, torch.zeros_like(ids))
        # masked lanes clip, so the position table is read in range
        lanes = torch.arange(cw, device=dev)
        h = self._embed(params, ids,
                        (start + lanes).clamp(0, c.max_len - 1)[None])
        # key validity over the window: slots before the chunk hold prior
        # chunks' real tokens, slots inside it follow its mask, later
        # slots were never written; query lane j sees slots <= start + j
        slots = torch.arange(total, device=dev)
        in_chunk = (slots >= start) & (slots < start + cw)
        kv_valid = (slots < start) | (
            in_chunk & cm[0][(slots - start).clamp(0, cw - 1)])
        mask4 = (kv_valid[None, :]
                 & (slots[None, :] <= (start + lanes)[:, None]))[None, None]
        hd = self.head_dim
        for i in range(c.layers):
            lp = params[f"layer_{i}"]
            q, k, v = self._qkv(lp["attn"], nn.layernorm(lp["ln1"], h))
            ctx_kv = []
            for pool, spool, x in ((k_pool[i], None if k_scale is None
                                    else k_scale[i], k),
                                   (v_pool[i], None if v_scale is None
                                    else v_scale[i], v)):
                # this chunk's K/V first: the gather below must already
                # see lanes 0..j-1's keys
                if spool is None:
                    pool[chunk_blocks] = x[0].reshape(
                        nb_c, bs, c.heads, hd).to(pool.dtype)
                    g = pool[table_row]
                else:
                    xq, xs = quantize_kv_rows(x[0])        # [C,H,D] / [C]
                    pool[chunk_blocks] = xq.reshape(nb_c, bs, c.heads, hd)
                    spool[chunk_blocks] = xs.reshape(nb_c, bs)
                    g = (pool[table_row].float()
                         * spool[table_row][..., None, None])
                ctx_kv.append(g.reshape(1, total, c.heads, hd)
                              .to(self.dtype))
            ctx = multi_head_attention(q, *ctx_kv, mask=mask4, impl="xla")
            a = nn.dense(lp["attn"]["o"], ctx.reshape(1, cw, c.hidden),
                         dtype=self.dtype)
            h = h + a.to(h.dtype)
            f = self._ffn(lp, nn.layernorm(lp["ln2"], h))
            h = h + f.to(h.dtype)
        h = nn.layernorm(params["ln_f"], h)
        last = (cm.sum() - 1).clamp(min=0)
        logits = self.lm_logits(params, h[:, last][:, None])[:, 0]
        if k_scale is None:
            return logits, k_pool, v_pool
        return logits, k_pool, v_pool, k_scale, v_scale

    @torch.no_grad()
    def decode_step_batched_paged(self, params, stacked, pools, block_tables,
                                  tok, pos, pad, alive=None,
                                  decode_attention: str | None = None):
        """:meth:`decode_step_batched` with the cache read and written
        THROUGH per-slot block tables: row b's token writes physical block
        ``block_tables[b, pos_b // Bs]`` at offset ``pos_b % Bs``, and
        attention reads through the same table (the paged decode kernel,
        or its plain version). ``pools``: ``{"k"/"v": [L, N, Bs, H, D]}``,
        written in place; ``block_tables``: [B, NB] int32. The engine
        makes every written block uniquely owned (copy-on-write happens on
        the host before the step). A dead row, and a row whose ``pos`` lies
        past its table's ``NB * Bs`` slots (attention clips it to the last
        one), writes nothing of its own: its gated write rewrites the
        bytes it reads in the null block 0, so no slot is named twice with
        two values in one write (the reference writes such a row through
        its table, where a verify step's lanes at the end of a row land on
        their live lane's slot). Returns (logits [B, V] f32, pools).

        int8 pools: ``pools`` also carries ``"k_scale"``/``"v_scale"``
        ([L, N, Bs] f32). The new row is quantized on write
        (:func:`quantize_kv_rows`, as :meth:`paged_prefill` writes), its
        int8 bytes AND its scales gated by ``alive``, and attention reads
        through the int8 kernel (or its plain version)."""
        tok = torch.as_tensor(tok, device=params["wte"]["table"].device)
        bs = pools["k"].shape[2]
        bt = torch.as_tensor(block_tables, device=tok.device).to(torch.int32)
        nb = bt.shape[1]
        impl = decode_attention or "auto"
        pos_raw = torch.as_tensor(pos, device=tok.device).to(torch.int32)
        pos, pad, alive, pos_ids = self._row_inputs(tok, pos_raw, pad, alive,
                                                    nb * bs - 1)
        h = self._embed(params, tok[:, None], pos_ids[:, None])[:, 0]
        rows = torch.arange(tok.shape[0], device=tok.device)
        # only a live row inside its capacity writes its own slot; any
        # other row (a dead row, a verify step's gated lane, a lane that
        # the clip would put on a live lane's slot) rewrites the bytes it
        # reads in the null block 0, so the one index_put never holds two
        # different values for one slot (CUDA orders no duplicate write)
        write = alive & (pos_raw >= 0) & (pos_raw <= nb * bs - 1)
        pbid = torch.where(write, bt[rows, pos // bs], 0).long()  # physical
        off = (pos % bs).long()
        live = write[:, None, None]

        def attend(i, q, k, v):
            ck, cv = pools["k"][i], pools["v"][i]
            if "k_scale" not in pools:
                ck[pbid, off] = torch.where(live, k.to(ck.dtype),
                                            ck[pbid, off])
                cv[pbid, off] = torch.where(live, v.to(cv.dtype),
                                            cv[pbid, off])
                return paged_decode_attn(q, ck, cv, block_tables=bt, pos=pos,
                                         pad=pad, impl=impl)
            cks, cvs = pools["k_scale"][i], pools["v_scale"][i]
            for pool, spool, x in ((ck, cks, k), (cv, cvs, v)):
                xq, xs = quantize_kv_rows(x)
                pool[pbid, off] = torch.where(live, xq, pool[pbid, off])
                spool[pbid, off] = torch.where(write, xs, spool[pbid, off])
            return paged_decode_attn(q, ck, cv, block_tables=bt, pos=pos,
                                     pad=pad, k_scale=cks, v_scale=cvs,
                                     impl=impl)

        return self._stacked_layers(params, stacked, h, attend), pools

    @torch.no_grad()
    def decode_verify_batched_paged(self, params, stacked, pools,
                                    block_tables, tok, pos, pad, alive,
                                    n_tok, decode_attention: str | None = None):
        """K-token VERIFY step of speculative decoding: row b carries
        ``tok[b] = [anchor, draft_1, ..., draft_{K-1}]``, the anchor being
        the token a plain step would dispatch. Lane j writes its K/V at
        logical slot ``pos[b] + j`` through row b's table, and its logits
        predict the token at ``pos[b] + j + 1``; the host accepts the
        longest draft prefix that matches the greedy chain and rewinds
        ``pos`` past the rest.

        It is :meth:`decode_step_batched_paged` over ROW-EXPANDED inputs:
        lane (b, j) becomes a row at ``pos[b] + j`` that shares row b's
        block table, so attention runs B·K rows through the paged kernel
        (B5, or B6 over int8 pools). Each layer writes every row's K/V
        before attending, so lane j's window already holds lanes
        0..j-1's keys, the state a sequential dispatch of the same tokens
        leaves. ``tok``: [B, K] int32; ``pos``/``pad``/``alive``: [B];
        ``n_tok``: [B] in [1, K]: lanes ``j >= n_tok[b]`` are write-gated
        like dead rows (their logits are computed and ignored), which is
        how draftless and sampled rows ride the dispatch at width 1.
        Returns (logits [B, K, V] f32, pools written in place)."""
        dev = params["wte"]["table"].device
        tok = torch.as_tensor(tok, device=dev)
        b, kk = tok.shape
        lanes = torch.arange(kk, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        n_tok = torch.as_tensor(n_tok, device=dev).to(torch.int32)
        alive = torch.as_tensor(alive, device=dev) != 0
        pad_e = torch.as_tensor(pad, device=dev).to(torch.int32) \
            .repeat_interleave(kk)
        alive_e = (alive[:, None] & (lanes[None, :] < n_tok[:, None]))
        bt_e = torch.as_tensor(block_tables, device=dev).to(torch.int32) \
            .repeat_interleave(kk, dim=0)
        logits, pools = self.decode_step_batched_paged(
            params, stacked, pools, bt_e, tok.reshape(-1),
            (pos[:, None] + lanes[None, :]).reshape(-1), pad_e,
            alive_e.reshape(-1), decode_attention=decode_attention)
        return logits.reshape(b, kk, -1), pools

    def ragged_prefill(self, params, input_ids, prompt_mask, total_len: int):
        """Ragged-prompt prefill: right-pack every row's real tokens
        against slot S0-1 (stable argsort — order preserving), build
        per-row positions/attention from the pad count, and run
        :meth:`_prefill`. Returns ``(last_hidden [B, hid], caches,
        pad [B])``."""
        b, s0 = input_ids.shape
        dev = input_ids.device
        pm = (torch.as_tensor(prompt_mask, device=dev) != 0).to(torch.int32)
        order = torch.argsort(pm, dim=1, stable=True)
        ids = torch.gather(input_ids, 1, order)
        pad = (s0 - pm.sum(dim=1)).to(torch.int32)
        ar = torch.arange(s0, dtype=torch.int32, device=dev)[None, :]
        valid = ar >= pad[:, None]
        ids = torch.where(valid, ids, torch.zeros_like(ids))
        pos_ids = torch.clamp(ar - pad[:, None], min=0)
        last_h, caches = self._prefill(params, ids, total_len,
                                       mask=valid.to(torch.int32),
                                       pos_ids=pos_ids)
        return last_h, caches, pad

    def _stack_caches(self, caches):
        """Per-layer {layer_i: {k, v}} caches -> stacked {"k": [L, ...],
        "v": [L, ...]} slabs."""
        return {n: torch.stack([caches[f"layer_{i}"][n]
                                for i in range(self.cfg.layers)])
                for n in ("k", "v")}

    def _filter_logits(self, logits, top_k: int, top_p: float):
        """Nucleus/top-k filtering of [B, V] logits with the reference's
        ``>=``-threshold semantics: only logits STRICTLY below the k-th
        largest / nucleus threshold drop to NEG_INF, so exact ties with
        the boundary survive. top-p keeps the smallest prefix of the
        descending order whose EXCLUSIVE cumulative mass is < top_p."""
        neg = torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device)
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, neg, logits)
        if top_p > 0.0:
            sl = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sl, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
            thresh = torch.where(keep, sl, torch.full_like(sl, float("inf"))
                                 ).min(dim=-1, keepdim=True).values
            logits = torch.where(logits < thresh, neg, logits)
        return logits

    @torch.no_grad()
    def generate(self, params, input_ids, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int | None = None,
                 pad_id: int = 0, prompt_mask=None,
                 rng: torch.Generator | None = None,
                 decode_impl: str = "stacked",
                 decode_attention: str | None = None,
                 weight_quant: str | None = None) -> torch.Tensor:
        """Autoregressive generation: prefill + KV-cache decode loop,
        greedy (``temperature=0``) or sampled with optional
        ``top_k``/``top_p`` filtering.

        ``decode_impl``: ``"stacked"`` (fused-QKV step over the stacked
        layer axis, the decode kernel's path) or ``"loop"`` (the per-layer
        reference step). ``decode_attention`` picks the stacked path's
        cache-slab attention: ``"auto"`` (the default: the decode kernel
        on CUDA tensors) or ``"xla"`` (the plain version on any device,
        the card's reference path). ``prompt_mask`` [B, S0] (nonzero = real token) admits
        ragged prompts, right-packed internally; each row needs at least
        one real token. ``eos_id`` stops once every row has emitted EOS
        (later slots hold ``pad_id``). Sampling draws from ``rng``, a
        ``torch.Generator`` on the params' device (Gumbel-max over the
        filtered logits): deterministic per seed, not the reference's
        threefry stream. The reference's ``tokens_per_dispatch`` (an XLA
        loop-unroll lever) has no meaning in an eager loop and is not
        taken. ``weight_quant="int8"`` decodes against int8-quantized
        stacked layer weights (:meth:`stack_decode_params`); the prefill,
        and so the first token, uses the float weights.

        Returns [B, max_new_tokens] int32 on the params' device."""
        c = self.cfg
        dev = params["wte"]["table"].device
        input_ids = torch.as_tensor(input_ids, device=dev)
        b, s0 = input_ids.shape
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{max_new_tokens}")
        if max_new_tokens == 0:
            return torch.zeros((b, 0), dtype=torch.int32, device=dev)
        total = s0 + max_new_tokens
        if total > c.max_len:
            raise ValueError(
                f"prompt {s0} + max_new_tokens {max_new_tokens} exceeds "
                f"max_len {c.max_len}")
        if temperature > 0.0 and rng is None:
            raise ValueError("sampling (temperature > 0) needs rng")
        if (top_k or top_p) and temperature <= 0.0:
            raise ValueError("top_k/top_p shape the SAMPLING "
                             "distribution; greedy decoding "
                             "(temperature=0) would silently ignore "
                             "them — set temperature > 0")
        if not 0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if top_k < 0 or top_k > c.vocab_size:
            raise ValueError(f"top_k must be in [0, vocab_size="
                             f"{c.vocab_size}], got {top_k}")
        if decode_impl not in ("stacked", "loop"):
            raise ValueError(f"decode_impl must be 'stacked' or 'loop', "
                             f"got {decode_impl!r}")
        if weight_quant is not None and decode_impl != "stacked":
            raise ValueError("weight_quant needs decode_impl='stacked' "
                             "(only the stacked step consumes the "
                             "quantized layer stack)")
        if decode_attention is not None and decode_impl != "stacked":
            raise ValueError(
                "decode_attention picks the stacked path's cache-slab "
                "attention; decode_impl='loop' always uses the plain "
                "reference — silently ignoring the override would "
                "mislabel a benchmark")

        if prompt_mask is not None:
            prompt_mask = torch.as_tensor(prompt_mask, device=dev)
            if tuple(prompt_mask.shape) != (b, s0):
                raise ValueError(
                    f"prompt_mask shape {tuple(prompt_mask.shape)} != "
                    f"input_ids shape {(b, s0)}")
            last_h, caches, pad = self.ragged_prefill(
                params, input_ids, prompt_mask, total)
        else:
            pad = torch.zeros(b, dtype=torch.int32, device=dev)
            last_h, caches = self._prefill(params, input_ids, total)
        first_logits = self.lm_logits(params, last_h[:, None])[:, 0]

        if decode_impl == "stacked":
            stacked = self.stack_decode_params(params,
                                               weight_quant=weight_quant)
            caches = self._stack_caches(caches)

            def step(tok, pos):
                return self._decode_step_stacked(
                    params, stacked, caches, tok, pos, pad,
                    decode_attention=decode_attention)[0]
        else:
            def step(tok, pos):
                return self._decode_step(params, caches, tok, pos, pad)[0]

        def pick(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            scaled = self._filter_logits(logits / temperature, top_k, top_p)
            u = torch.rand(scaled.shape, generator=rng, device=dev)
            gumbel = -torch.log(-torch.log(
                u.clamp_(min=torch.finfo(torch.float32).tiny)))
            return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)

        tok = pick(first_logits)
        if eos_id is None:
            out = [tok]
            for t in range(1, max_new_tokens):
                tok = pick(step(tok, s0 + t - 1))
                out.append(tok)
            return torch.stack(out, dim=1)

        # EOS early stop: emit into a pad-filled buffer, stop once every
        # row is done (a batch whose rows all finish by step k pays k
        # decode steps, not max_new)
        out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32,
                         device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(max_new_tokens):
            out[:, t] = torch.where(done, torch.full_like(tok, pad_id), tok)
            done |= tok == eos_id
            if t + 1 == max_new_tokens or bool(done.all()):
                break
            tok = pick(step(tok, s0 + t))
        return out


# ---------------------------------------------------------------------------
# weight bridge: the reference's flat npz keys <-> the port's params
# ---------------------------------------------------------------------------

def params_from_numpy(model: GPT, tree, device=None) -> dict:
    """The reference's GPT params as numpy arrays, keyed as its checkpoint
    ``_flatten`` keys them (``layer_0/attn/q/kernel``; bf16 leaves either
    as numpy bfloat16 arrays or as uint16 under ``__bf16__/``) -> the
    port's params on ``device`` (``cuda`` by default). Same layouts on
    both sides, so nothing is transposed. Raises on a missing, unknown
    or mis-shaped key."""
    return checked_params("GPT", model.param_shapes(), tree, device)


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The inverse bridge: the port's params -> flat numpy arrays in the
    reference's checkpoint layout (bf16 as uint16 under ``__bf16__/``)."""
    return ckpt.to_numpy(params)


def _make(config: TrainConfig, cfg: GPTConfig, *,
          config_vocab: bool = True) -> GPT:
    if config_vocab:
        cfg.vocab_size = config.data.vocab_size
    cfg.max_len = max(cfg.max_len, config.data.seq_len)
    ls = lm_loss_settings(config)
    cfg.loss_impl = ls["impl"]
    cfg.loss_chunk = ls["chunk"]
    cfg.loss_vocab_block = ls["vocab_block"]
    return GPT(cfg, dtype=resolve_dtype(config.dtype),
               attention_impl=config.attention_impl,
               param_dtype=resolve_dtype(config.param_dtype),
               attention_kwargs=flash_attention_kwargs(config),
               accuracy_every_n=ls["accuracy_every_n"], remat=config.remat)


@register_model("gpt")
def _make_gpt(config: TrainConfig) -> GPT:
    return _make(config, GPTConfig.small())


@register_model("gpt_tiny")
def _make_gpt_tiny(config: TrainConfig) -> GPT:
    return _make(config, GPTConfig.tiny(), config_vocab=False)
