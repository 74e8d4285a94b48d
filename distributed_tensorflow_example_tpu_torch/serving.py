"""Generator export + loading (port of the generator half of
``distributed_tensorflow_example_tpu/serving.py``).

The reference bakes ``model.generate`` into a StableHLO artifact. The
port's artifact is weights plus metadata, and the server runs the port's
own model code, kernels included::

    <dir>/params.npz    the parameters in the reference's npz format
                        (flat keys, per-array CRC32, bf16 as uint16)
    <dir>/export.json   the reference's generator metadata keys (kind,
                        input signature, shapes, sampling knobs) plus
                        the model config needed to rebuild the model

``stepwise=True`` adds the reference's ``stepwise`` metadata block, and
:class:`StepwiseGenerator` serves it to the continuous-batching engine
(``serving_batch.GenerationEngine``) with the reference's dict interface
(``make_pool`` / ``prefill`` / ``decode``) over a slab pool or, with
``paged=True``, a block-paged pool. Speculative verify, chunked prefill
and the quantized paths arrive with a later slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from .ckpt import checkpoint as ckpt
from .models.base import resolve_dtype
from .models.gpt import GPT, GPTConfig, params_from_numpy, params_to_numpy
from .runtime.device import resolve_device

_PARAMS = "params.npz"
_META = "export.json"

#: quant metadata schema version recorded in every generator export (the
#: reference's value; no quantized path exists in the port yet)
QUANT_SCHEMA = 1

_LATER = "arrives with a later slice of the port"


def _dtype_name(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def export_generator(model: GPT, params, out_dir: str, *,
                     prompt_len: int, max_new_tokens: int,
                     batch_size: int = 1, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0,
                     eos_id: int | None = None, pad_id: int = 0,
                     ragged: bool = False, stepwise: bool = False,
                     slots: int = 8, paged: bool = False,
                     block_size: int = 16, num_blocks: int | None = None,
                     pool_bytes: int | None = None, spec_tokens: int = 0,
                     prefill_chunk: int = 0,
                     weight_quant: str | None = None,
                     kv_cache_dtype: str | None = None) -> str:
    """Write a generator artifact: ``model.generate`` over
    ``{"input_ids": [batch_size, prompt_len]}`` (plus ``prompt_mask``
    when ``ragged``) -> ``[batch_size, max_new_tokens]`` token ids, with
    the sampling knobs fixed at export. Returns the metadata path.

    ``stepwise=True`` also records the ``stepwise`` block the
    continuous-batching engine reads: ``slots`` cache rows of
    ``prompt_len + max_new_tokens`` slots, a slab pool ``[L, slots, T, H,
    D]`` or, with ``paged=True``, a pool of ``num_blocks`` blocks of
    ``block_size`` slots ``[L, N, Bs, H, D]`` whose block 0 is the
    reserved null block. ``num_blocks`` defaults to the slab pool's
    capacity plus the null block; ``pool_bytes`` instead sizes it in K/V
    bytes. The artifact's sampling knobs become the engine's per-request
    defaults."""
    for name, on in (("spec_tokens", spec_tokens),
                     ("prefill_chunk", prefill_chunk),
                     ("weight_quant", weight_quant not in (None, "off")),
                     ("kv_cache_dtype",
                      kv_cache_dtype not in (None, "auto"))):
        if on:
            raise NotImplementedError(f"export_generator {name}: {_LATER}")
    if prompt_len < 1 or max_new_tokens < 0 or batch_size < 1:
        raise ValueError(f"bad export shape: prompt_len={prompt_len} "
                         f"max_new_tokens={max_new_tokens} "
                         f"batch_size={batch_size}")
    if prompt_len + max_new_tokens > model.cfg.max_len:
        raise ValueError(f"prompt_len {prompt_len} + max_new_tokens "
                         f"{max_new_tokens} exceeds max_len "
                         f"{model.cfg.max_len}")
    if paged and not stepwise:
        raise ValueError("paged=True exports the block-paged stepwise "
                         "programs and requires stepwise=True")
    if pool_bytes is not None:
        if not paged:
            raise ValueError("pool_bytes sizes the paged block pool "
                             "and requires paged=True")
        if num_blocks is not None:
            raise ValueError("pass pool_bytes OR num_blocks, not both "
                             "(pool_bytes derives num_blocks from the "
                             "byte budget)")
        if pool_bytes < 1:
            raise ValueError(f"pool_bytes must be >= 1, got {pool_bytes}")
    step_meta = (_stepwise_meta(model, prompt_len=prompt_len,
                                max_new_tokens=max_new_tokens, slots=slots,
                                paged=paged, block_size=block_size,
                                num_blocks=num_blocks, pool_bytes=pool_bytes)
                 if stepwise else None)
    arrays = params_to_numpy(params)
    os.makedirs(out_dir, exist_ok=True)
    ckpt.save_npz(os.path.join(out_dir, _PARAMS), arrays)
    signature = {"input_ids": {"shape": [batch_size, prompt_len],
                               "dtype": "int32"}}
    if ragged:
        signature["prompt_mask"] = {"shape": [batch_size, prompt_len],
                                    "dtype": "int32"}
    meta: dict[str, Any] = {
        "model": model.name,
        "kind": "generator",
        "input_signature": signature,
        "platforms": ["cuda", "cpu"],
        "param_count": int(sum(np.size(a) for a in arrays.values())),
        "torch_version": torch.__version__,
        "batch_polymorphic": False,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "temperature": temperature, "top_k": top_k, "top_p": top_p,
        "eos_id": eos_id, "pad_id": pad_id, "ragged": ragged,
        "decode_impl": "stacked",
        "quant_schema": QUANT_SCHEMA,
        "weight_quant": None,
        "gpt_config": dataclasses.asdict(model.cfg),
        "dtype": _dtype_name(model.dtype),
        "param_dtype": _dtype_name(model.param_dtype),
        "attention_impl": model.attention_impl,
        "attention_kwargs": model.attention_kwargs,
    }
    if temperature > 0.0:
        # the serve-time rng contract: the server seeds a torch.Generator
        # on the serving device from the request's integer seed
        meta["prng_impl"] = "torch.Generator"
    if step_meta is not None:
        meta["stepwise"] = step_meta
    path = os.path.join(out_dir, _META)
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    return path


def _stepwise_meta(model: GPT, *, prompt_len: int, max_new_tokens: int,
                   slots: int, paged: bool, block_size: int,
                   num_blocks: int | None, pool_bytes: int | None) -> dict:
    """The reference's ``stepwise`` metadata block (``serving.py``
    ``_export_stepwise`` / ``_export_stepwise_paged``): the pool the
    engine allocates once, and the block geometry of a paged pool."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    c = model.cfg
    total = prompt_len + max_new_tokens
    head_dim = c.hidden // c.heads
    cache_dtype = _dtype_name(model.dtype)
    meta = {"slots": slots, "prompt_len": prompt_len,
            "max_new_tokens": max_new_tokens, "max_context": total,
            "cache_dtype": cache_dtype, "kv_cache_dtype": cache_dtype,
            "vocab_size": c.vocab_size, "paged": paged,
            "spec_tokens": 0, "prefill_chunk": 0}
    if not paged:
        meta["pool_shape"] = [c.layers, slots, total, c.heads, head_dim]
        return meta
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    blocks_per_slot = -(-total // block_size)
    prompt_blocks = -(-prompt_len // block_size)
    block_bytes = (2 * c.layers * block_size * c.heads * head_dim
                   * model.dtype.itemsize)
    if pool_bytes is not None:
        num_blocks = 1 + pool_bytes // block_bytes
    if num_blocks is None:
        # the slab pool's token capacity, block-granular, plus the
        # reserved null block: equal bytes, equal worst case
        num_blocks = 1 + slots * blocks_per_slot
    if num_blocks - 1 < blocks_per_slot:
        raise ValueError(
            f"num_blocks {num_blocks} leaves {num_blocks - 1} usable "
            f"blocks (block 0 is the reserved null block) but one "
            f"full-depth request needs {blocks_per_slot} blocks of "
            f"{block_size} tokens — raise num_blocks or block_size")
    meta.update(pool_shape=[c.layers, num_blocks, block_size, c.heads,
                            head_dim],
                block_size=block_size, num_blocks=num_blocks,
                blocks_per_slot=blocks_per_slot,
                prompt_blocks=prompt_blocks, layout="left_aligned",
                block_bytes=block_bytes)
    return meta


def _load_model(directory: str, device) -> tuple[dict, GPT, dict]:
    """(metadata, model, params on ``device``) of a generator export."""
    with open(os.path.join(directory, _META)) as f:
        meta = json.load(f)
    if meta.get("kind") != "generator":
        raise ValueError(f"{directory!r} holds no generator artifact "
                         f"(kind {meta.get('kind')!r})")
    model = GPT(GPTConfig(**meta["gpt_config"]),
                dtype=resolve_dtype(meta["dtype"]),
                attention_impl=meta["attention_impl"],
                param_dtype=resolve_dtype(meta["param_dtype"]),
                attention_kwargs=meta["attention_kwargs"])
    params = params_from_numpy(
        model, ckpt.load_npz(os.path.join(directory, _PARAMS)), device)
    return meta, model, params


class ServableModel:
    """A loaded generator export: ``servable(features, seed) -> tokens``.
    The model is rebuilt from the metadata and its parameters are placed
    on ``device`` (``cuda`` by default)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = resolve_device(device)
        self.meta, self.model, self.params = _load_model(directory,
                                                         self.device)

    @property
    def input_signature(self) -> dict:
        return self.meta["input_signature"]

    def __call__(self, features: dict[str, np.ndarray],
                 seed: int | None = None) -> np.ndarray:
        m = self.meta
        rng = None
        if m["temperature"] > 0.0:
            if seed is None:
                raise ValueError("this artifact samples: pass a seed")
            rng = torch.Generator(device=self.device)
            rng.manual_seed(seed)
        ids = torch.as_tensor(features["input_ids"], dtype=torch.int64,
                              device=self.device)
        mask = features.get("prompt_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        toks = self.model.generate(
            self.params, ids, m["max_new_tokens"],
            temperature=m["temperature"], top_k=m["top_k"], top_p=m["top_p"],
            eos_id=m["eos_id"], pad_id=m["pad_id"], prompt_mask=mask,
            rng=rng)
        return toks.cpu().numpy()


def load_servable(directory: str, device=None) -> ServableModel:
    return ServableModel(directory, device=device)


def has_stepwise(directory: str) -> bool:
    """True when ``directory`` holds a generator export with the
    ``stepwise`` block a continuous-batching engine can drive."""
    try:
        with open(os.path.join(directory, _META)) as f:
            return bool(json.load(f).get("stepwise"))
    except FileNotFoundError:
        return False


class StepwiseGenerator:
    """A loaded stepwise generator export for the continuous-batching
    engine (``serving_batch.GenerationEngine``), with the reference's dict
    interface: :meth:`make_pool` once, then :meth:`prefill` per admission
    and :meth:`decode` per shared step. Inputs are host arrays plus the
    pool's ``cache_*`` tensors; each call writes the pool IN PLACE on the
    device (where the reference donates it to a new buffer) and returns
    it beside the logits as a host f32 array (the engine samples on the
    host). A call that fails midway may have written some layers' slots
    of the rows it was given; those rows are retried or failed by the
    engine, and nothing outside them is touched. The model is the port's
    own, rebuilt from the export (its kernels included)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = resolve_device(device)
        self.meta, self.model, self.params = _load_model(directory,
                                                         self.device)
        step_meta = self.meta.get("stepwise")
        if not step_meta:
            raise ValueError(
                f"{directory!r} holds no stepwise generator artifacts — "
                "re-export with export_generator(..., stepwise=True) "
                "(or serve it with the scheduler off)")
        self.step_meta = step_meta
        self.paged: bool = bool(step_meta.get("paged", False))
        self.kv_cache_dtype: str = str(step_meta["kv_cache_dtype"])
        #: the port exports neither a verify nor a chunked-prefill program
        self.spec_tokens: int = 0
        self.prefill_chunk_tokens: int = 0
        self._total = int(step_meta["max_context"])
        self._stacked = self.model.stack_decode_params(self.params)

    def make_pool(self) -> dict:
        """A zeroed cache pool of the exported shape on the device (the
        engine's one-time allocation)."""
        shape = tuple(self.step_meta["pool_shape"])
        dtype = resolve_dtype(self.step_meta["cache_dtype"])
        return {n: torch.zeros(shape, dtype=dtype, device=self.device)
                for n in ("cache_k", "cache_v")}

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def prefill(self, feats: dict) -> dict:
        """One admission: ``input_ids``/``prompt_mask`` [1, prompt_len]
        plus ``slot`` (slab: the prompt is right-packed into that row's
        slab, whole slab written) or ``table_row`` (paged: left-aligned,
        whole blocks written through the row). Returns ``logits`` [1, V]
        (and ``pad`` [1] on a slab pool) as host arrays plus the pool."""
        m = self.model
        ck, cv = feats["cache_k"], feats["cache_v"]
        ids, mask = self._t(feats["input_ids"]), self._t(feats["prompt_mask"])
        if self.paged:
            logits, ck, cv = m.paged_prefill(self.params, ids, mask, ck, cv,
                                             self._t(feats["table_row"]))
            return {"logits": logits.cpu().numpy(), "cache_k": ck,
                    "cache_v": cv}
        with torch.no_grad():
            last_h, caches, pad = m.ragged_prefill(self.params, ids, mask,
                                                   self._total)
            kv = m._stack_caches(caches)           # {"k"/"v": [L,1,T,H,D]}
            slot = int(feats["slot"])
            ck[:, slot] = kv["k"][:, 0].to(ck.dtype)
            cv[:, slot] = kv["v"][:, 0].to(cv.dtype)
            logits = m.lm_logits(self.params, last_h[:, None])[:, 0]
        return {"logits": logits.cpu().numpy(), "pad": pad.cpu().numpy(),
                "cache_k": ck, "cache_v": cv}

    def decode(self, feats: dict) -> dict:
        """One shared decode step for every slot: ``tok``/``pos``/``pad``/
        ``alive`` [slots] (plus ``block_tables`` [slots, NB] on a paged
        pool). Returns ``logits`` [slots, V] (host f32) plus the pool."""
        m = self.model
        pools = {"k": feats["cache_k"], "v": feats["cache_v"]}
        args = (self._t(feats["tok"]), self._t(feats["pos"]),
                self._t(feats["pad"]), self._t(feats["alive"]))
        if self.paged:
            logits, pools = m.decode_step_batched_paged(
                self.params, self._stacked, pools,
                self._t(feats["block_tables"]), *args)
        else:
            logits, pools = m.decode_step_batched(self.params, self._stacked,
                                                  pools, *args)
        return {"logits": logits.cpu().numpy(), "cache_k": pools["k"],
                "cache_v": pools["v"]}


def load_stepwise(directory: str, device=None) -> StepwiseGenerator:
    return StepwiseGenerator(directory, device=device)
