"""Model export + loading (port of
``distributed_tensorflow_example_tpu/serving.py``).

The reference bakes the forward (``export_model``) or ``model.generate``
(``export_generator``) into a StableHLO artifact. The port's artifact is
weights plus metadata, and the server runs the port's own model code,
kernels included::

    <dir>/params.npz    the parameters in the reference's npz format
                        (flat keys, per-array CRC32, bf16 as uint16)
    <dir>/extras.npz    a forward's non-trained state (batch norm
                        statistics), when it has any
    <dir>/export.json   the reference's metadata keys (kind, input
                        signature, param count, and the generator's
                        shapes and sampling knobs) plus the model config
                        needed to rebuild the model

:func:`export_model` writes ``kind: "forward"``: the servable runs
``model.apply(params, extras, features)`` with dropout off and returns
the logits. :func:`export_generator` writes ``kind: "generator"``.

``stepwise=True`` adds the reference's ``stepwise`` metadata block, and
:class:`StepwiseGenerator` serves it to the continuous-batching engine
(``serving_batch.GenerationEngine``) with the reference's dict interface
(``make_pool`` / ``prefill`` / ``decode``) over a slab pool or, with
``paged=True``, a block-paged pool. ``weight_quant="int8"`` serves the
decode steps (monolithic and stepwise) from int8 layer weights;
``kv_cache_dtype="int8"`` gives a paged export int8 K/V pools with f32
per-token-slot scale pools beside them (``cache_k_scale``/
``cache_v_scale``). Every loader validates the quant metadata first
(:func:`validate_quant_meta`). A paged export also takes
``spec_tokens=K`` (the K-token speculative-verify step,
:meth:`StepwiseGenerator.verify`) and ``prefill_chunk=C`` (the chunked
prefill, :meth:`StepwiseGenerator.prefill_chunk`): the port's artifact
holds no programs, so both are recorded in the ``stepwise`` block and run
the model's own ``decode_verify_batched_paged`` and
``paged_prefill_chunk``.
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
_EXTRAS = "extras.npz"
_META = "export.json"

# label-side batch keys never consumed by ``apply`` (loss/eval only):
# pruned from the serving signature so a servable takes features only
_LABEL_KEYS = ("y", "masked_labels", "masked_weights", "__valid__")

#: the TrainConfig fields the model factories read (``models/*.py``
#: ``register_model``): with the registry name and the data's vocab and
#: sequence length they rebuild an exported forward's model
_MODEL_CONFIG_FIELDS = (
    "dtype", "param_dtype", "attention_impl", "attention_bwd",
    "attention_block_q", "attention_block_k", "attention_bwd_block",
    "remat", "label_smoothing", "bn_stats_dtype", "lm_loss_impl",
    "lm_loss_chunk", "lm_loss_vocab_block", "token_accuracy_every_n")

#: quant metadata schema version recorded in every generator export; the
#: loaders refuse an artifact that claims a newer one (the reference's value)
QUANT_SCHEMA = 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def storage_dtype(name: str) -> torch.dtype:
    """The torch dtype of a pool dtype named in ``export.json``
    (``"float32"``, ``"bfloat16"``, ``"int8"``; ``bfloat16`` is a name
    numpy does not know). Raises ValueError on a name that is no dtype."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a dtype")
    return dtype


def _normalize_weight_quant(weight_quant) -> str | None:
    """The weight-quant knob: ``None``/``"off"`` -> None, ``"int8"`` ->
    ``"int8"``; anything else raises."""
    if weight_quant in (None, "off"):
        return None
    if weight_quant == "int8":
        return "int8"
    raise ValueError(f"weight_quant must be 'off' or 'int8', got "
                     f"{weight_quant!r}")


def _normalize_kv_cache_dtype(kv_cache_dtype, model_dtype: torch.dtype
                              ) -> tuple[torch.dtype, bool]:
    """The KV-cache storage knob: ``None``/``"auto"`` keeps the model's
    compute dtype (the default export, unchanged), ``"bf16"`` stores
    bfloat16, ``"int8"`` the quantized pool (paged exports only). Returns
    ``(pool dtype, quantized)``."""
    if kv_cache_dtype in (None, "auto"):
        return model_dtype, False
    if kv_cache_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16, False
    if kv_cache_dtype == "int8":
        return torch.int8, True
    raise ValueError(f"kv_cache_dtype must be 'auto', 'bf16' or 'int8', "
                     f"got {kv_cache_dtype!r}")


def serving_signature(batch: dict[str, Any]) -> dict[str, Any]:
    """The feature-only view of a training batch."""
    return {k: v for k, v in batch.items() if k not in _LABEL_KEYS}


def _model_config(model) -> dict:
    """The config ``models.get_model`` rebuilds ``model`` from. Only a
    model built by ``get_model`` carries it, and only a model the port
    has ported can be rebuilt: anything else raises naming its slice."""
    from .models import list_models
    name = getattr(model, "registry_name", None)
    cfg = getattr(model, "train_config", None)
    if name is None or cfg is None:
        what = getattr(model, "name", type(model).__name__)
        slice_ = "A6" if str(what).startswith("pipe_") else "A5b"
        raise ValueError(
            f"export_model: {what!r} was not built by models.get_model, "
            f"so its config cannot be recorded (the port serves "
            f"{', '.join(list_models())}; other models arrive with slice "
            f"{slice_})")
    return {"name": name,
            **{f: getattr(cfg, f) for f in _MODEL_CONFIG_FIELDS},
            "data": {"vocab_size": cfg.data.vocab_size,
                     "seq_len": cfg.data.seq_len}}


def _rebuild_model(model_config: dict):
    """The model an export's ``model_config`` describes."""
    from .config import DataConfig, TrainConfig
    from .models import get_model
    kw = dict(model_config)
    name, data = kw.pop("name"), kw.pop("data")
    return get_model(name, TrainConfig(model=name, data=DataConfig(**data),
                                       **kw))


def export_model(model, params, extras, out_dir: str, *,
                 sample_batch: dict[str, Any] | None = None,
                 batch_size: int = 8) -> str:
    """Write a forward artifact of ``model.apply(params, extras, features,
    train=False)``: the logits of any number of rows (batch-polymorphic,
    as the reference's default export). ``sample_batch`` (default
    ``model.dummy_batch(batch_size)``) fixes the input signature, labels
    pruned. ``model`` must come from ``models.get_model``, whose name and
    config the metadata records. Every rank may call it; rank 0 writes.
    Returns the metadata path."""
    from .runtime import distributed
    model_config = _model_config(model)
    batch = sample_batch or model.dummy_batch(batch_size)
    features = serving_signature(batch)
    path = os.path.join(out_dir, _META)
    if distributed.process_index() != 0:
        return path
    arrays = ckpt.to_numpy(params)
    os.makedirs(out_dir, exist_ok=True)
    ckpt.save_npz(os.path.join(out_dir, _PARAMS), arrays)
    if extras:
        ckpt.save_npz(os.path.join(out_dir, _EXTRAS),
                      ckpt.to_numpy(extras))
    signature = {
        k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype)}
        for k, v in features.items()}
    meta = {
        "model": getattr(model, "name", type(model).__name__),
        "kind": "forward",
        "input_signature": signature,
        "platforms": ["cuda", "cpu"],
        "param_count": int(sum(np.size(a) for a in arrays.values())),
        "torch_version": torch.__version__,
        "batch_polymorphic": True,
        "model_config": model_config,
    }
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    return path


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
    defaults.

    ``weight_quant="int8"`` (or ``"off"``) is recorded in the metadata,
    and every decode step of the artifact (``generate`` and the stepwise
    step) runs on int8 layer weights. ``kv_cache_dtype``: ``"auto"`` (the
    compute dtype), ``"bf16"``, or ``"int8"`` (paged only: int8 K/V pools
    plus [L, N, Bs] f32 scale pools, quantized on write); ``pool_bytes``
    counts only the K/V payload, so int8 holds twice the bf16 blocks at
    equal bytes.

    ``spec_tokens=K`` (K >= 2, paged only) records the speculative-verify
    step of K lanes a row; ``prefill_chunk=C`` (a positive multiple of
    ``block_size``, paged only) the chunked prefill of C tokens a chunk,
    clamped to the prompt's whole blocks. Both land in the ``stepwise``
    block, where the engine reads them."""
    weight_quant = _normalize_weight_quant(weight_quant)
    cache_dtype, kv_quant = _normalize_kv_cache_dtype(kv_cache_dtype,
                                                      model.dtype)
    if kv_quant and not paged:
        raise ValueError("kv_cache_dtype='int8' quantizes the block-paged "
                         "pool (its per-slot scales follow the block "
                         "layout): export with paged=True, or drop the "
                         "knob")
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
    if spec_tokens:
        if spec_tokens < 2:
            raise ValueError(
                f"spec_tokens must be 0 (off) or >= 2 (one anchor token + "
                f"at least one draft lane per verify dispatch), got "
                f"{spec_tokens}")
        if not paged:
            raise ValueError(
                "spec_tokens exports the K-token verify step over the "
                "block-paged pool (draft rejection rewinds per-row pos "
                "through the block tables) — export with paged=True, or "
                "drop the knob")
    if prefill_chunk:
        if not paged:
            raise ValueError(
                "prefill_chunk exports the chunked prefill over the "
                "block-paged pool (chunks fill whole blocks through the "
                "table) — export with paged=True, or drop the knob")
        if prefill_chunk < 1 or prefill_chunk % block_size:
            raise ValueError(
                f"prefill_chunk must be a positive multiple of "
                f"block_size={block_size} (chunks tile the left-aligned "
                f"layout block-granularly), got {prefill_chunk}")
    step_meta = (_stepwise_meta(model, prompt_len=prompt_len,
                                max_new_tokens=max_new_tokens, slots=slots,
                                paged=paged, block_size=block_size,
                                num_blocks=num_blocks, pool_bytes=pool_bytes,
                                cache_dtype=cache_dtype, kv_quant=kv_quant,
                                spec_tokens=spec_tokens,
                                prefill_chunk=prefill_chunk)
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
        "weight_quant": weight_quant,
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
                   num_blocks: int | None, pool_bytes: int | None,
                   cache_dtype: torch.dtype, kv_quant: bool,
                   spec_tokens: int = 0, prefill_chunk: int = 0) -> dict:
    """The reference's ``stepwise`` metadata block (``serving.py``
    ``_export_stepwise`` / ``_export_stepwise_paged``): the pool the
    engine allocates once, and the block geometry of a paged pool. An
    int8 pool adds the scale pools' shape and dtype, and its
    ``block_bytes`` counts their rows. A paged pool records the verify
    width and the chunk width (clamped to the prompt's whole blocks, as
    the reference clamps the exported chunk)."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    c = model.cfg
    total = prompt_len + max_new_tokens
    head_dim = c.hidden // c.heads
    name = _dtype_name(cache_dtype)
    meta = {"slots": slots, "prompt_len": prompt_len,
            "max_new_tokens": max_new_tokens, "max_context": total,
            "cache_dtype": name, "kv_cache_dtype": name,
            "vocab_size": c.vocab_size, "paged": paged,
            "spec_tokens": 0, "prefill_chunk": 0}
    if not paged:
        meta["pool_shape"] = [c.layers, slots, total, c.heads, head_dim]
        return meta
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    blocks_per_slot = -(-total // block_size)
    prompt_blocks = -(-prompt_len // block_size)
    # one block's K+V payload at the storage dtype (int8: half of bf16,
    # which is what doubles the blocks at equal pool_bytes) ...
    kv_block_bytes = (2 * c.layers * block_size * c.heads * head_dim
                      * cache_dtype.itemsize)
    # ... and its whole residency, the f32 scale rows included
    block_bytes = kv_block_bytes + (2 * c.layers * block_size * 4
                                    if kv_quant else 0)
    if pool_bytes is not None:
        num_blocks = 1 + pool_bytes // kv_block_bytes
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
                block_bytes=block_bytes, spec_tokens=int(spec_tokens),
                prefill_chunk=min(int(prefill_chunk),
                                  prompt_blocks * block_size))
    if kv_quant:
        meta.update(kv_scale_shape=[c.layers, num_blocks, block_size],
                    kv_scale_dtype="float32")
    return meta


def validate_quant_meta(meta: dict, *, where: str = "artifact") -> None:
    """Load-time validation of an artifact's quant metadata (the
    reference's rules): every mismatch raises naming its ``export.json``
    field, before any tensor is shaped from it. An artifact without a
    ``quant_schema`` key predates the schema and passes."""
    schema = meta.get("quant_schema")
    if schema is None:
        return
    if not isinstance(schema, int) or schema < 1 or schema > QUANT_SCHEMA:
        raise ValueError(
            f"{where}: metadata field 'quant_schema'={schema!r} is not "
            f"supported by this loader (understands 1..{QUANT_SCHEMA}): "
            "re-export the artifact or upgrade the server")
    wq = meta.get("weight_quant")
    if wq not in (None, "int8"):
        raise ValueError(
            f"{where}: metadata field 'weight_quant'={wq!r} names an "
            "unknown weight quantization (known: null, 'int8')")
    sm = meta.get("stepwise")
    if not sm:
        return
    kd = sm.get("kv_cache_dtype", sm.get("cache_dtype"))
    if kd == "int8":
        if not sm.get("paged"):
            raise ValueError(
                f"{where}: metadata field 'stepwise.kv_cache_dtype'='int8' "
                "requires a paged artifact ('stepwise.paged' is false): "
                "the int8 pool's scales follow the block layout")
        want = [sm["pool_shape"][i] for i in (0, 1, 2)]   # [L, N, Bs]
        got = sm.get("kv_scale_shape")
        if got != want:
            raise ValueError(
                f"{where}: metadata field 'stepwise.kv_scale_shape'="
                f"{got!r} does not match the per-slot layout {want} of "
                f"'stepwise.pool_shape'={sm['pool_shape']}")
        field, name = "kv_scale_dtype", sm.get("kv_scale_dtype", "float32")
    elif kd is None:
        return
    else:
        field, name = "kv_cache_dtype", kd
    try:
        storage_dtype(name)
    except ValueError as e:
        raise ValueError(f"{where}: metadata field 'stepwise.{field}'="
                         f"{name!r}: {e}") from e


def read_meta(directory: str) -> dict:
    """An export's ``export.json``."""
    with open(os.path.join(directory, _META)) as f:
        return json.load(f)


def _load_forward(directory: str, device) -> tuple[dict, Any, dict, dict]:
    """(metadata, model, params, extras on ``device``) of a forward
    export."""
    meta = read_meta(directory)
    model = _rebuild_model(meta["model_config"])
    params = ckpt.from_numpy(ckpt.load_npz(os.path.join(directory,
                                                        _PARAMS)), device)
    extras_path = os.path.join(directory, _EXTRAS)
    extras = (ckpt.from_numpy(ckpt.load_npz(extras_path), device)
              if os.path.exists(extras_path) else {})
    return meta, model, params, extras


def _load_model(directory: str, device) -> tuple[dict, GPT, dict]:
    """(metadata, model, params on ``device``) of a generator export."""
    meta = read_meta(directory)
    if meta.get("kind") != "generator":
        raise ValueError(f"{directory!r} holds no generator artifact "
                         f"(kind {meta.get('kind')!r})")
    validate_quant_meta(meta, where=directory)
    model = GPT(GPTConfig(**meta["gpt_config"]),
                dtype=resolve_dtype(meta["dtype"]),
                attention_impl=meta["attention_impl"],
                param_dtype=resolve_dtype(meta["param_dtype"]),
                attention_kwargs=meta["attention_kwargs"])
    params = params_from_numpy(
        model, ckpt.load_npz(os.path.join(directory, _PARAMS)), device)
    return meta, model, params


class ServableModel:
    """A loaded export. A forward export: ``servable(features) -> logits``
    (host numpy, f32). A generator export: ``servable(features, seed) ->
    tokens``. The model is rebuilt from the metadata and its parameters
    are placed on ``device`` (``cuda`` by default)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = resolve_device(device)
        self.extras: dict = {}
        if read_meta(directory).get("kind") == "forward":
            self.meta, self.model, self.params, self.extras = \
                _load_forward(directory, self.device)
        else:
            self.meta, self.model, self.params = _load_model(directory,
                                                             self.device)

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    @property
    def input_signature(self) -> dict:
        return self.meta["input_signature"]

    def _forward(self, features: dict[str, np.ndarray]) -> np.ndarray:
        feats = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in features.items()}
        with torch.no_grad():
            logits, _ = self.model.apply(self.params, self.extras, feats)
        return logits.float().cpu().numpy()

    def __call__(self, features: dict[str, np.ndarray],
                 seed: int | None = None) -> np.ndarray:
        if self.kind == "forward":
            return self._forward(features)
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
            rng=rng, weight_quant=m.get("weight_quant"))
        return toks.cpu().numpy()


def load_servable(directory: str, device=None) -> ServableModel:
    return ServableModel(directory, device=device)


def has_stepwise(directory: str) -> bool:
    """True when ``directory`` holds a generator export with the
    ``stepwise`` block a continuous-batching engine can drive."""
    try:
        return bool(read_meta(directory).get("stepwise"))
    except FileNotFoundError:
        return False


class StepwiseGenerator:
    """A loaded stepwise generator export for the continuous-batching
    engine (``serving_batch.GenerationEngine``), with the reference's dict
    interface: :meth:`make_pool` once, then :meth:`prefill` per admission
    (or :meth:`prefill_chunk` per chunk, with chunked prefill) and
    :meth:`decode` per shared step (or :meth:`verify`, when a slot
    drafted under speculation). Inputs are host arrays plus the
    pool's ``cache_*`` tensors (``cache_k``/``cache_v``, and
    ``cache_k_scale``/``cache_v_scale`` beside an int8 pool); each call
    writes the pool IN PLACE on the device (where the reference donates
    it to a new buffer) and returns it beside the logits as a host f32
    array (the engine samples on the host). A call that fails midway may have written some layers' slots
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
        #: "int8" for the quantized pool (with its scale pools), else the
        #: pool's float dtype
        self.kv_cache_dtype: str = str(
            step_meta.get("kv_cache_dtype", step_meta["cache_dtype"]))
        #: K of the speculative-verify step (0: the export has none, and
        #: the engine runs spec-off)
        self.spec_tokens: int = int(step_meta.get("spec_tokens", 0))
        #: C of the chunked prefill (0: none, the engine runs unchunked)
        self.prefill_chunk_tokens: int = int(
            step_meta.get("prefill_chunk", 0))
        self._total = int(step_meta["max_context"])
        self._stacked = self.model.stack_decode_params(
            self.params, weight_quant=self.meta.get("weight_quant"))

    @property
    def _quant(self) -> bool:
        return self.kv_cache_dtype == "int8"

    def make_pool(self) -> dict:
        """A zeroed cache pool of the exported shape on the device (the
        engine's one-time allocation); an int8 pool comes with its zeroed
        f32 scale pools."""
        m = self.step_meta
        pool = {n: torch.zeros(tuple(m["pool_shape"]),
                               dtype=storage_dtype(m["cache_dtype"]),
                               device=self.device)
                for n in ("cache_k", "cache_v")}
        if self._quant:
            for n in ("cache_k_scale", "cache_v_scale"):
                pool[n] = torch.zeros(
                    tuple(m["kv_scale_shape"]),
                    dtype=storage_dtype(m.get("kv_scale_dtype", "float32")),
                    device=self.device)
        return pool

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
            table_row = self._t(feats["table_row"])
            if self._quant:
                logits, ck, cv, cks, cvs = m.paged_prefill(
                    self.params, ids, mask, ck, cv, table_row,
                    k_scale=feats["cache_k_scale"],
                    v_scale=feats["cache_v_scale"])
                return {"logits": logits.cpu().numpy(), "cache_k": ck,
                        "cache_v": cv, "cache_k_scale": cks,
                        "cache_v_scale": cvs}
            logits, ck, cv = m.paged_prefill(self.params, ids, mask, ck, cv,
                                             table_row)
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

    def _pools(self, feats: dict) -> dict:
        """The model's pool dict out of the feature dict's ``cache_*``."""
        pools = {"k": feats["cache_k"], "v": feats["cache_v"]}
        if self._quant:
            pools.update(k_scale=feats["cache_k_scale"],
                         v_scale=feats["cache_v_scale"])
        return pools

    def _result(self, logits: torch.Tensor, pools: dict) -> dict:
        """Host f32 logits beside the pool under its ``cache_*`` names."""
        out = {"logits": logits.cpu().numpy(), "cache_k": pools["k"],
               "cache_v": pools["v"]}
        if self._quant:
            out.update(cache_k_scale=pools["k_scale"],
                       cache_v_scale=pools["v_scale"])
        return out

    def _check_shape(self, feats: dict, name: str, want: tuple) -> None:
        got = tuple(np.shape(feats[name]))
        if got != want:
            raise ValueError(f"{name} shape {got} != {want}, the shape "
                             f"this artifact's stepwise block gives it")

    def decode(self, feats: dict) -> dict:
        """One shared decode step for every slot: ``tok``/``pos``/``pad``/
        ``alive`` [slots] (plus ``block_tables`` [slots, NB] on a paged
        pool). Returns ``logits`` [slots, V] (host f32) plus the pool."""
        m = self.model
        pools = self._pools(feats)
        args = (self._t(feats["tok"]), self._t(feats["pos"]),
                self._t(feats["pad"]), self._t(feats["alive"]))
        if self.paged:
            logits, pools = m.decode_step_batched_paged(
                self.params, self._stacked, pools,
                self._t(feats["block_tables"]), *args)
        else:
            logits, pools = m.decode_step_batched(self.params, self._stacked,
                                                  pools, *args)
        return self._result(logits, pools)

    def verify(self, feats: dict) -> dict:
        """The K-token speculative-verify dispatch: ``tok`` [slots,
        spec_tokens], ``pos``/``pad``/``alive``/``n_tok`` [slots] and
        ``block_tables`` [slots, NB]. Returns ``logits`` [slots, K, V]
        (host f32) plus the pool. Only on artifacts exported with
        ``spec_tokens >= 2``."""
        if not self.spec_tokens:
            raise ValueError(
                "this artifact was exported without a verify step "
                "(spec_tokens=0) — re-export with export_generator("
                "..., spec_tokens=K) to enable speculative decoding")
        m = self.step_meta
        slots = int(m["slots"])
        self._check_shape(feats, "tok", (slots, self.spec_tokens))
        self._check_shape(feats, "n_tok", (slots,))
        self._check_shape(feats, "block_tables",
                          (slots, int(m["blocks_per_slot"])))
        logits, pools = self.model.decode_verify_batched_paged(
            self.params, self._stacked, self._pools(feats),
            self._t(feats["block_tables"]), self._t(feats["tok"]),
            self._t(feats["pos"]), self._t(feats["pad"]),
            self._t(feats["alive"]), self._t(feats["n_tok"]))
        return self._result(logits, pools)

    def prefill_chunk(self, feats: dict) -> dict:
        """One C-token chunked-prefill dispatch: ``input_ids``/
        ``chunk_mask`` [1, C], ``start`` (scalar), ``table_row``
        [prompt_blocks] and ``chunk_blocks`` [C / block_size]. Returns
        ``logits`` [1, V] (host f32) plus the pool. Only on artifacts
        exported with ``prefill_chunk=C``."""
        if not self.prefill_chunk_tokens:
            raise ValueError(
                "this artifact was exported without a chunked prefill "
                "(prefill_chunk=0) — re-export with export_generator("
                "..., prefill_chunk=C) to enable chunked prefill")
        m = self.step_meta
        cw = self.prefill_chunk_tokens
        for name, want in (("input_ids", (1, cw)), ("chunk_mask", (1, cw)),
                           ("table_row", (int(m["prompt_blocks"]),)),
                           ("chunk_blocks", (cw // int(m["block_size"]),))):
            self._check_shape(feats, name, want)
        pools = self._pools(feats)
        scales = ({"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}
                  if self._quant else {})
        out = self.model.paged_prefill_chunk(
            self.params, self._t(feats["input_ids"]),
            self._t(feats["chunk_mask"]), int(feats["start"]),
            pools["k"], pools["v"], self._t(feats["table_row"]),
            self._t(feats["chunk_blocks"]), **scales)
        return self._result(out[0], pools)


def load_stepwise(directory: str, device=None) -> StepwiseGenerator:
    return StepwiseGenerator(directory, device=device)
