"""Functional NN primitives with explicit parameter dicts (port of
``distributed_tensorflow_example_tpu/ops/nn.py``, the parts GPT
inference reads).

Same conventions as the reference: parameters are plain dicts of tensors
kept in ``param_dtype`` (f32 by default), matmul-bearing ops take a
compute ``dtype``, dense kernels are laid out [in, out]. Initialisers
draw from an explicit ``torch.Generator`` (the tests bridge weights from
the reference instead of matching its random streams).
"""

from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


def glorot_uniform(gen: torch.Generator, shape, dtype, fan_in: int,
                   fan_out: int) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (u * (2 * limit) - limit).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               param_dtype=torch.float32) -> Params:
    """Glorot-uniform [in, out] kernel (the init GPT uses) + zero bias."""
    return {"kernel": glorot_uniform(gen, (in_dim, out_dim), param_dtype,
                                     in_dim, out_dim),
            "bias": torch.zeros(out_dim, dtype=param_dtype,
                                device=gen.device)}


def dense(params: Params, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """y = x @ W + b. With ``dtype=bfloat16`` the reference's contract:
    bf16 operands, f32 accumulation, the product rounded once to bf16,
    then the bias added in bf16 (``torch.matmul`` on bf16 tensors
    accumulates in f32 and rounds its output to bf16)."""
    kernel, bias = params["kernel"], params["bias"]
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    y = torch.matmul(x, kernel)
    return y + bias.to(y.dtype)


def layernorm_init(dim: int, *, param_dtype=torch.float32,
                   device=None) -> Params:
    return {"scale": torch.ones(dim, dtype=param_dtype, device=device),
            "bias": torch.zeros(dim, dtype=param_dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, *,
              eps: float = 1e-6) -> torch.Tensor:
    """Per-token statistics in f32 with the reference's eps of 1e-6
    (PyTorch's own default is 1e-5); output in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, dim: int, *,
                   param_dtype=torch.float32) -> Params:
    table = torch.randn((vocab, dim), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02
    return {"table": table.to(param_dtype)}


def embedding(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")
