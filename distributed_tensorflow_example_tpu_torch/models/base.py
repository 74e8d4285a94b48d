"""Model registry + dtype helpers (port of the reference's
``models/base.py``), and the transformers' shared machinery: the flash
kernels' key mask and ``--remat``."""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

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


def checked_params(name: str, want: dict[str, tuple], tree,
                   device=None) -> dict:
    """The reference's params as flat numpy arrays (its checkpoint
    ``_flatten`` keys; bf16 leaves as numpy bfloat16 or as uint16 under
    ``__bf16__/``) -> nested tensors on ``device`` (``cuda`` by default),
    checked against ``want`` {key: shape}: raises on a missing, unknown
    or mis-shaped key."""
    from ..ckpt import checkpoint as ckpt
    from ..runtime.device import resolve_device
    from ..utils.pytree import flatten_dict
    params = ckpt.from_numpy(tree, resolve_device(device))
    flat = flatten_dict(params)
    missing = sorted(set(want) - set(flat))
    unknown = sorted(set(flat) - set(want))
    if missing or unknown:
        raise ValueError(f"{name} params mismatch: missing {missing[:8]}, "
                         f"unknown {unknown[:8]}")
    for k, shape in want.items():
        if tuple(flat[k].shape) != shape:
            raise ValueError(f"param {k!r} has shape {tuple(flat[k].shape)}"
                             f", the model wants {shape}")
    return params


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


_aten = torch.ops.aten
#: the matmuls "dots" keeps: the dense layers' (a 3-D activation against
#: a 2-D kernel folds to ``mm``); the attention's batched products
#: (``bmm``) and every elementwise op are recomputed
_DENSE_OPS = (_aten.mm.default, _aten.addmm.default)


def _save_dense_outputs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DENSE_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


#: remat knob -> selective-checkpoint policy (None: keep nothing)
REMAT_POLICIES = {"full": None, "dots": _save_dense_outputs}


def check_remat(remat: str) -> None:
    if remat != "none" and remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of "
                         f"{['none', *REMAT_POLICIES]}, got {remat!r}")


def remat_call(remat: str, fn, *args):
    """``fn(*args)``, recomputed in the backward under ``remat`` "full"
    or "dots". ``fn`` must draw its randomness from its arguments (a
    dropout key), not from a generator that outlives the call."""
    if remat == "none":
        return fn(*args)
    policy = REMAT_POLICIES[remat]
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def key_mask(mask, ids: torch.Tensor) -> torch.Tensor:
    """[B, S] key validity (nonzero = attend; None = all valid) as the
    contiguous int32 tensor on ``ids``' device the flash kernels read,
    converted once a forward."""
    if mask is None:
        return torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    mask = torch.as_tensor(mask, device=ids.device)
    if mask.dtype != torch.int32:
        mask = (mask != 0).to(torch.int32)
    return mask.contiguous()


_REGISTRY: dict[str, Callable[[TrainConfig], Any]] = {}


def register_model(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_model(name: str, config: TrainConfig | None = None):
    """The model ``name`` built from ``config``. The instance carries both
    (``registry_name``, ``train_config``): ``serving.export_model``
    records them so that a servable rebuilds the same model."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    config = config or TrainConfig(model=name)
    model = _REGISTRY[name](config)
    model.registry_name, model.train_config = name, config
    return model


def list_models() -> list[str]:
    return sorted(_REGISTRY)
