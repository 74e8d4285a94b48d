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


def cast_floating(tree, dtype: torch.dtype):
    """Cast floating-point leaves of a nested dict to ``dtype`` (integer
    and bool leaves untouched)."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


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
