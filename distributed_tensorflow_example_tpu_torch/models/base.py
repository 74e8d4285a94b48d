"""Model registry + dtype helpers (port of the reference's
``models/base.py``)."""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..config import TrainConfig


def resolve_dtype(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype (bf16 for the tensor cores, f32
    everywhere precision matters)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def generator(seed: int | torch.Generator, device=None) -> torch.Generator:
    """An init's generator: ``seed`` itself when it is one, else a new
    generator on ``device`` (``cuda`` by default) seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    from ..runtime.device import resolve_device
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def cast_floating(tree, dtype: torch.dtype):
    """Cast floating-point leaves of a nested dict to ``dtype`` (integer
    and bool leaves untouched)."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def classification_eval_metrics(logits: torch.Tensor, batch, *,
                                top5: bool = False) -> dict:
    """The eval_metrics body of the integer-label classifiers: loss and
    accuracy (and, with ``top5``, top-5 accuracy), each restricted by the
    optional ``batch["__valid__"]`` example mask (1.0 a real example, 0.0
    the padding of the eval tail)."""
    from ..ops import losses
    w = batch.get("__valid__")
    out = {
        "loss": losses.softmax_xent_int_labels(logits, batch["y"], where=w),
        "accuracy": losses.accuracy(logits, batch["y"], where=w),
    }
    if top5:
        out["top5_accuracy"] = losses.topk_accuracy(logits, batch["y"], 5,
                                                    where=w)
    return out


_REGISTRY: dict[str, Callable[[TrainConfig], Any]] = {}


def register_model(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_model(name: str, config: TrainConfig | None = None):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](config or TrainConfig(model=name))


def list_models() -> list[str]:
    return sorted(_REGISTRY)
