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

Only the monolithic (``stepwise=False``) generator is exported in this
slice; the stepwise/paged programs, speculative verify, chunked prefill
and the quantized paths arrive with the paged-engine slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from .ckpt import checkpoint as ckpt
from .models.gpt import GPT, GPTConfig, params_from_numpy, params_to_numpy
from .runtime.device import resolve_device

_PARAMS = "params.npz"
_META = "export.json"

#: quant metadata schema version recorded in every generator export (the
#: reference's value; no quantized path exists in the port yet)
QUANT_SCHEMA = 1

_LATER = "arrives with the paged continuous-batching engine slice"


def _dtype_name(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def export_generator(model: GPT, params, out_dir: str, *,
                     prompt_len: int, max_new_tokens: int,
                     batch_size: int = 1, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 0.0,
                     eos_id: int | None = None, pad_id: int = 0,
                     ragged: bool = False, stepwise: bool = False,
                     paged: bool = False, spec_tokens: int = 0,
                     prefill_chunk: int = 0,
                     weight_quant: str | None = None,
                     kv_cache_dtype: str | None = None) -> str:
    """Write a generator artifact: ``model.generate`` over
    ``{"input_ids": [batch_size, prompt_len]}`` (plus ``prompt_mask``
    when ``ragged``) -> ``[batch_size, max_new_tokens]`` token ids, with
    the sampling knobs fixed at export. Returns the metadata path."""
    for name, on in (("stepwise", stepwise), ("paged", paged),
                     ("spec_tokens", spec_tokens),
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
    path = os.path.join(out_dir, _META)
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
    return path


class ServableModel:
    """A loaded generator export: ``servable(features, seed) -> tokens``.
    The model is rebuilt from the metadata and its parameters are placed
    on ``device`` (``cuda`` by default)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        with open(os.path.join(directory, _META)) as f:
            self.meta = json.load(f)
        if self.meta.get("kind") != "generator":
            raise ValueError(f"{directory!r} holds no generator artifact "
                             f"(kind {self.meta.get('kind')!r})")
        self.device = resolve_device(device)
        from .models.base import resolve_dtype
        self.model = GPT(GPTConfig(**self.meta["gpt_config"]),
                         dtype=resolve_dtype(self.meta["dtype"]),
                         attention_impl=self.meta["attention_impl"],
                         param_dtype=resolve_dtype(self.meta["param_dtype"]),
                         attention_kwargs=self.meta["attention_kwargs"])
        self.params = params_from_numpy(
            self.model, ckpt.load_npz(os.path.join(directory, _PARAMS)),
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
