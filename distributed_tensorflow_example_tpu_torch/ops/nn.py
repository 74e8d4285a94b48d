"""Functional NN primitives with explicit parameter dicts (port of
``distributed_tensorflow_example_tpu/ops/nn.py``, the parts GPT and the
MNIST MLP read).

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


def truncated_normal(gen: torch.Generator, shape, dtype,
                     stddev: float) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn as
    ``jax.random.truncated_normal(-2, 2)`` draws it: the inverse CDF of a
    uniform draw between erf(-2/sqrt 2) and erf(2/sqrt 2), in f32 (the
    classic ``tf.truncated_normal`` init of the reference MLP)."""
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    z = z.clamp(-2.0, 2.0)
    return (z * stddev).to(dtype)


def he_normal(gen: torch.Generator, shape, dtype,
              fan_in: int) -> torch.Tensor:
    std = math.sqrt(2.0 / fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               init: str = "truncated_normal",
               param_dtype=torch.float32) -> Params:
    """[in, out] kernel + zero bias. ``init`` is the reference's:
    ``truncated_normal`` (stddev 1/sqrt(fan_in), the MLP's), ``glorot``
    (GPT's) or ``he``."""
    shape = (in_dim, out_dim)
    if init == "truncated_normal":
        kernel = truncated_normal(gen, shape, param_dtype,
                                  1.0 / math.sqrt(in_dim))
    elif init == "glorot":
        kernel = glorot_uniform(gen, shape, param_dtype, in_dim, out_dim)
    elif init == "he":
        kernel = he_normal(gen, shape, param_dtype, in_dim)
    else:
        raise ValueError(f"unknown init {init!r}")
    return {"kernel": kernel,
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


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout, the reference's rule: in training each element is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    else 0; identity when not ``train`` or ``rate <= 0``. The keep mask
    draws from ``gen`` (on ``x``'s device), so a seeded generator gives
    the same mask again; it is not the reference's stream (JAX threefry
    and torch Philox differ)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
