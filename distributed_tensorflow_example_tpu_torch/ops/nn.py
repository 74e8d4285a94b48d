"""Functional NN primitives with explicit parameter dicts (port of
``distributed_tensorflow_example_tpu/ops/nn.py``: the parts GPT, the
MNIST MLP, LeNet and the ResNets read).

Same conventions as the reference: parameters are plain dicts of tensors
kept in ``param_dtype`` (f32 by default), matmul-bearing ops take a
compute ``dtype``, dense kernels are laid out [in, out], activations of
the conv ops are NHWC and conv kernels HWIO, so checkpoints cross
between the packages unchanged. Initialisers draw from an explicit
``torch.Generator`` (the tests bridge weights from the reference instead
of matching its random streams).

The convolutions, pools and batch norm are library and plain-tensor
calls (cuDNN on the card), as the reference's are plain XLA: no
hand-written kernel. On the card an f32 convolution runs in f32,
forward and backward, whatever ``torch.backends.cudnn.allow_tf32`` (True
by default) says: float32 compute means float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..runtime import distributed

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


def conv2d_init(gen: torch.Generator, kh: int, kw: int, in_ch: int,
                out_ch: int, *, use_bias: bool = True,
                param_dtype=torch.float32) -> Params:
    """He-normal HWIO kernel (fan-in kh*kw*in_ch) and, with ``use_bias``,
    a zero bias."""
    p: Params = {"kernel": he_normal(gen, (kh, kw, in_ch, out_ch),
                                     param_dtype, kh * kw * in_ch)}
    if use_bias:
        p["bias"] = torch.zeros(out_ch, dtype=param_dtype,
                                device=gen.device)
    return p


def _same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output has
    ceil(size / stride) positions, and of the ``total`` padding this
    needs, ``total // 2`` goes low and the rest high. At stride 2 the
    split is uneven (a 3x3/2 conv on an even size pads (0, 1), a 7x7/2
    on 224 pads (2, 3)), where torch's symmetric ``padding`` would shift
    every window by one pixel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, window: tuple[int, int], stride: int,
              padding: str, value: float = 0.0) -> torch.Tensor:
    """``x`` [N, H, W, C] padded as XLA pads it for a (height, width)
    ``window`` and ``padding`` ("SAME" or "VALID")."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    top, bottom = _same_pads(x.shape[1], window[0], stride)
    left, right = _same_pads(x.shape[2], window[1], stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> the [N, C, H, W] view torch's conv and pool ops
    take: channels-last memory, no copy."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


@contextlib.contextmanager
def _no_cudnn_tf32():
    """cuDNN's TF32 off inside (a process-wide flag, restored after)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv2d_grads(g, x, w, stride: int, mask: list[bool]):
    """(dx, dw) of the unpadded, unbiased ``F.conv2d(x, w, stride)``."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, [stride, stride], [0, 0], [1, 1], False, [0, 0], 1,
        mask + [False])
    return dx, dw


class _F32Conv2d(torch.autograd.Function):
    """``F.conv2d(x, w, stride=stride)`` with cuDNN's TF32 off in the
    forward and in the backward. cuDNN reads the flag when each
    convolution runs, and autograd runs the backward after the caller's
    scope has closed, so the flag is set around both here."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _no_cudnn_tf32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _no_cudnn_tf32():
            dx, dw = _conv2d_grads(g, x, w, ctx.stride,
                                   list(ctx.needs_input_grad[:2]))
        return dx, dw, None


def conv2d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME", dtype=None) -> torch.Tensor:
    """NHWC conv with an HWIO kernel, the reference's ``"SAME"`` /
    ``"VALID"`` padding (padded here, the conv itself unpadded). With a
    compute ``dtype`` x and the kernel are cast to it and the output
    stays in it (bf16 operands, f32 accumulation in cuDNN); the bias is
    added in the output's dtype. An f32 conv on the card runs in f32,
    not TF32 (:class:`_F32Conv2d`)."""
    kernel = params["kernel"]
    if dtype is not None:
        x = x.to(dtype)
    # HWIO -> OHWI in one copy (with the cast), viewed as OIHW: the
    # channels-last weight layout that matches the activations'
    w = kernel.permute(3, 0, 1, 2).to(
        dtype=dtype or kernel.dtype,
        memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
    x = _pad_nhwc(x, kernel.shape[:2], stride, padding)
    if x.is_cuda and x.dtype == torch.float32:
        y = _nhwc(_F32Conv2d.apply(_nchw(x), w, stride))
    else:
        y = _nhwc(F.conv2d(_nchw(x), w, stride=stride))
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool; ``"SAME"`` pads with -inf, as the reference's
    ``reduce_window`` does."""
    x = _pad_nhwc(x, (window, window), stride, padding,
                  value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC average pool: the window's sum over window*window, the zero
    padding of ``"SAME"`` included, as the reference divides."""
    x = _pad_nhwc(x, (window, window), stride, padding)
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride))


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


def batchnorm_init(dim: int, *, param_dtype=torch.float32,
                   device=None) -> tuple[Params, Params]:
    """(params, extras): the trained scale and bias, and the running mean
    and variance, which live in ``TrainState.extras`` and are always
    f32."""
    params = {"scale": torch.ones(dim, dtype=param_dtype, device=device),
              "bias": torch.zeros(dim, dtype=param_dtype, device=device)}
    extras = {"mean": torch.zeros(dim, dtype=torch.float32, device=device),
              "var": torch.ones(dim, dtype=torch.float32, device=device)}
    return params, extras


def batchnorm(params: Params, extras: Params, x: torch.Tensor, *,
              train: bool, momentum: float = 0.9, eps: float = 1e-5,
              stats_dtype=torch.float32) -> tuple[torch.Tensor, Params]:
    """Batch norm over every dim but the last, the reference's rules
    (not ``F.batch_norm``'s): in training the batch mean and
    ``max(E[x^2] - mean^2, 0)`` (biased) taken in ``stats_dtype`` (a
    bf16 mean accumulates in f32 and is rounded once; f64, which the
    reference does not offer, is a test oracle), and running
    statistics that keep ``momentum`` of their old value, updated with
    that biased variance; in eval the running statistics. The
    normalisation is folded into ``x * inv + off`` in f32 and applied in
    ``x.dtype``. Returns (y, new_extras).

    Inside :func:`~..runtime.distributed.cross_rank_batch_stats` (the
    sync step's ``auto`` mode over several ranks) the batch statistics
    are those of the global batch: the per-channel means are averaged
    over the ranks by a differentiable all-reduce."""
    if train:
        dims = tuple(range(x.ndim - 1))
        xf = x.to(stats_dtype)
        # the statistics leave in f32 at least (f64 stays f64)
        acc = torch.promote_types(stats_dtype, torch.float32)
        stats = torch.stack([xf.mean(dim=dims), xf.square().mean(dim=dims)])
        stats = distributed.batch_stats_mean(stats.to(acc))
        if stats_dtype != acc:               # the global mean, rounded
            stats = stats.to(stats_dtype).to(acc)
        mean, meansq = stats[0], stats[1]
        var = torch.clamp(meansq - mean.square(), min=0.0)
        new_extras = {
            "mean": momentum * extras["mean"] + (1 - momentum) * mean,
            "var": momentum * extras["var"] + (1 - momentum) * var,
        }
    else:
        mean, var = extras["mean"], extras["var"]
        new_extras = extras
    inv = torch.rsqrt(var + eps) * params["scale"].to(mean.dtype)
    off = params["bias"].to(mean.dtype) - mean * inv
    return x * inv.to(x.dtype) + off.to(x.dtype), new_extras


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
