"""Mixture-of-Experts FFN, the dense dispatch/combine path (port of
``distributed_tensorflow_example_tpu/ops/moe.py`` ``moe_ffn`` and its
helpers).

The Switch-Transformer layout, as the reference builds it: routing turns
each token's choice into one-hot ``dispatch`` and ``combine`` tensors
[T, E, C] (T tokens, E experts, C slots an expert), and the layer is
products against them. Top-k is a repeated masked argmax (``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does); a token's slot in its
expert is a cumsum of the one-hots in token order (row-major over B x S);
an assignment past ``C = ceil(T / E * capacity_factor)`` is dropped, and
the token's residual passes through untouched. Routing runs in f32, the
tokens enter the experts in the compute dtype, the combine runs in f32.

The products are ``torch.matmul`` calls shaped so that the ``--remat
dots`` policy (``models/base.py``: ``mm``/``addmm`` saved, the rest
recomputed) saves what the reference's ``dots_with_no_batch_dims_saveable``
saves: the router, dispatch and combine products are 2-D (``mm``, no
batch dimension: saved), the experts' GEMMs are batched over E (``bmm``:
recomputed). Under a bf16 compute dtype the expert GEMMs take bf16
operands and return their f32 accumulation unrounded, as the reference's
``preferred_element_type=jnp.float32`` does. No TPU kernel is on this
path: the reference computes it with XLA einsums, and the port with
library GEMMs.

Router jitter multiplies the router's input (not the experts') by noise
U[1-j, 1+j) in training. Its draws come from a key (``ops/nn.py``
``fold_in``/``keyed_generator``), never from a running generator, so a
layer that ``--remat`` recomputes draws the same noise again. The stream
is torch's, not JAX's.

Under tensor parallelism (``tp``, a ``parallel/tensor_parallel.
ModelAxis``) each expert's FFN is split by its hidden columns, as the
reference's rules place ``w_in`` ``P(None, None, model)``, ``b_in``
``P(None, model)`` and ``w_out`` ``P(None, model, None)``: every
``model`` rank routes alike (the router is replicated, its jitter key the
same), runs the experts on its columns, and the partial outputs are
summed over ``model`` before the replicated ``b_out`` is added once and
the combine runs; the aux metrics are the whole routing's. The
expert-parallel form (``moe_ffn_shard_map``, the ``all_to_all`` of tokens
over an ``expert`` axis) is slice A6d.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from . import nn

Params = dict[str, Any]


def moe_ffn_init(gen: torch.Generator, n_experts: int, hidden: int,
                 intermediate: int, *, param_dtype=torch.float32) -> Params:
    """Router + per-expert FFN weights, stacked on a leading E dim: the
    router kernel N(0, 0.02), the experts' kernels uniform in
    +-sqrt(6 / (hidden + intermediate)), zero biases (the reference's
    init; its random stream is JAX's)."""
    dev = gen.device
    lim = math.sqrt(6.0 / (hidden + intermediate))

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return (u * (2 * lim) - lim).to(param_dtype)

    router = torch.randn((hidden, n_experts), generator=gen, device=dev,
                         dtype=torch.float32) * 0.02
    return {
        "router": {"kernel": router.to(param_dtype)},
        "w_in": uniform((n_experts, hidden, intermediate)),
        "b_in": torch.zeros((n_experts, intermediate), dtype=param_dtype,
                            device=dev),
        "w_out": uniform((n_experts, intermediate, hidden)),
        "b_out": torch.zeros((n_experts, hidden), dtype=param_dtype,
                             device=dev),
    }


def aux_loss(frac_tokens: torch.Tensor, mean_probs: torch.Tensor,
             n_experts: int, k: int) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e frac_e / k * p_e``."""
    return n_experts * torch.sum(frac_tokens / k * mean_probs)


def jitter_noise(key: int, shape, jitter: float, device) -> torch.Tensor:
    """The router's multiplicative noise U[1-jitter, 1+jitter) of ``shape``
    (f32), a function of ``key`` alone."""
    gen = nn.keyed_generator(key, device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2.0 * jitter) + (1.0 - jitter)


def router_logits(router_params: Params, x2: torch.Tensor, *,
                  key: int | None = None,
                  jitter: float = 0.0) -> torch.Tensor:
    """[T, D] -> [T, E] f32 router logits; with ``jitter`` and a ``key``
    the router's input is multiplied by :func:`jitter_noise` first (the
    experts see the clean input)."""
    xr = x2.float()
    if jitter > 0.0 and key is not None:
        xr = xr * jitter_noise(key, x2.shape, jitter, x2.device)
    return torch.matmul(xr, router_params["kernel"].float())


def _route(router_params: Params, x2: torch.Tensor, n_experts: int, k: int,
           capacity: int, *, key: int | None = None, jitter: float = 0.0):
    """x2 [T, D] -> (dispatch [T, E, C], combine [T, E, C], stats), stats
    {frac [E], mp [E], z scalar, kept [E]}: the share of the T x k
    assignments each expert got, its mean router probability, the
    ST-MoE z-loss term ``mean(logsumexp(logits)^2)``, and the assignments
    that fit under capacity. ``jitter`` (with ``key``) multiplies the
    router's input by U[1-jitter, 1+jitter)."""
    logits = router_logits(router_params, x2, key=key, jitter=jitter)
    probs = torch.softmax(logits, dim=-1)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    t = x2.shape[0]
    dev = x2.device
    slots = torch.arange(capacity, device=dev)
    remaining = probs
    counts = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    total_assigned = torch.zeros((t, n_experts), dtype=torch.float32,
                                 device=dev)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)                 # [T]
        onehot = torch.nn.functional.one_hot(
            choice, n_experts).to(torch.float32)                 # [T, E]
        # a token's slot within its chosen expert, in token order
        pos = (torch.cumsum(onehot, dim=0) - 1 + counts) * onehot
        keep = (pos < capacity).to(torch.float32) * onehot
        # one_hot of a slot past capacity is all zeros (jax.nn.one_hot's
        # rule; torch's one_hot would raise)
        slot = (pos.to(torch.int64)[..., None] == slots).to(torch.float32)
        d = keep[..., None] * slot
        gate = (probs * onehot).sum(-1, keepdim=True)            # chosen p
        dispatch = dispatch + d
        combine = combine + d * gate[..., None]
        counts = counts + keep.sum(0)
        total_assigned = total_assigned + onehot
        remaining = remaining * (1.0 - onehot)                   # mask it
    stats = {"frac": total_assigned.mean(0), "mp": probs.mean(0), "z": z,
             "kept": counts}
    return dispatch, combine, stats


class _BmmF32(torch.autograd.Function):
    """``a @ b`` over a batch of low-precision operands, accumulated and
    returned in f32 (on the card one bf16 GEMM with an f32 output; on
    the CPU the same products in f32, where bf16 products are exact).
    The backward rounds the f32 cotangent to the operands' dtype and runs
    each gradient as one GEMM in it, as ``bmm(a, b).float()`` would."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2),
                                                          g)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def _expert_compute(params: Params, inp: torch.Tensor, dtype,
                    tp=None) -> torch.Tensor:
    """[E, C, D] -> [E, C, D] f32: each expert's FFN (tanh GELU), one
    batched GEMM over E a projection, operands in the compute ``dtype``
    and accumulations kept in f32 (the reference's
    ``preferred_element_type``); the biases and GELU run in f32, and the
    GELU's output is rounded to ``dtype`` for the second GEMM. Under
    ``tp`` the weights are this rank's column pieces: ``inp`` enters
    through ``copy_to_model`` and the second GEMM's partial sums are
    summed over ``model`` (in f32) before ``b_out`` is added."""
    if tp is not None:
        inp = tp.copy_to_model(inp)
    h = _bmm_f32(inp.to(dtype), params["w_in"].to(dtype))
    h = h + params["b_in"].float()[:, None, :]
    h = nn.gelu(h).to(dtype)
    out = _bmm_f32(h, params["w_out"].to(dtype))
    if tp is not None:
        out = tp.reduce_from_model(out)
    return out + params["b_out"].float()[:, None, :]


def capacity_for(tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    return max(1, math.ceil(tokens / n_experts * capacity_factor))


def _aux_pack(stats: dict, n_experts: int, k: int, tokens: int,
              capacity: int) -> dict:
    """Routing stats -> ``lb_loss`` (Switch load balance), ``z_loss``
    (router z-loss), ``dropped_fraction`` (the share of the T x k
    assignments lost to capacity) and ``expert_load`` [E] (slots used
    over capacity)."""
    kept = stats["kept"]
    return {
        "lb_loss": aux_loss(stats["frac"], stats["mp"], n_experts, k),
        "z_loss": stats["z"],
        "dropped_fraction": 1.0 - torch.sum(kept) / float(tokens * k),
        "expert_load": kept / float(capacity),
    }


def moe_ffn(params: Params, x: torch.Tensor, *, n_experts: int,
            top_k: int = 1, capacity_factor: float = 1.25,
            dtype=torch.float32, key: int | None = None,
            jitter: float = 0.0, tp=None) -> tuple[torch.Tensor, dict]:
    """[B, S, D] -> ([B, S, D] in ``x.dtype``, the aux dict of
    :func:`_aux_pack`). ``key`` + ``jitter`` turn on router noise
    (training only: an eval passes no key). ``tp``: the experts' column
    pieces on this ``model`` rank (see the module docstring)."""
    b, s, d = x.shape
    t = b * s
    cap = capacity_for(t, n_experts, capacity_factor)
    x2 = x.reshape(t, d)
    dispatch, combine, stats = _route(params["router"], x2, n_experts,
                                      top_k, cap, key=key, jitter=jitter)
    aux = _aux_pack(stats, n_experts, top_k, t, cap)
    # "tec,td->ecd": [E*C, T] @ [T, D] (a one-hot gather, exact in bf16)
    expert_in = torch.matmul(dispatch.reshape(t, n_experts * cap).t()
                             .to(dtype), x2.to(dtype))
    expert_out = _expert_compute(params,
                                 expert_in.reshape(n_experts, cap, d), dtype,
                                 tp)
    # "tec,ecd->td" in f32: [T, E*C] @ [E*C, D]
    out = torch.matmul(combine.reshape(t, n_experts * cap),
                       expert_out.reshape(n_experts * cap, d))
    return out.reshape(b, s, d).to(x.dtype), aux
