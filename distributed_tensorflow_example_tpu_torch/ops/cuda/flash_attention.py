"""Flash-attention forward: the Hopper kernel ``csrc/flash_attention_fwd.cu``
and its plain PyTorch version (port of the forward of
``distributed_tensorflow_example_tpu/ops/pallas/flash_attention.py``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
the call raises (no silent fallback). The kernel takes any sequence
length (the ragged last tile is masked in the kernel, unlike the TPU
kernel's ``S % block`` gate), head dims 64 and 128, bf16 q/k/v laid
out contiguous [B, S, H, D], and a contiguous int32 [B, S] key mask
(nonzero = attend; the model converts it once per forward). Its tiles are fixed (64 query rows x 64
keys); the reference's ``block_q``/``block_k``/``bwd_*`` levers tune the
TPU grid and the backward, which arrives with the training slice, so they
are refused here instead of silently ignored.
"""

from __future__ import annotations

import math

import torch

from ..attention import (NEG_INF, apply_mask, attention_scores,
                         multi_head_attention)
from . import _build

KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_fwd_plain(q, k, v, mask=None, causal: bool = False):
    """The plain version: ``multi_head_attention``'s einsum chain plus
    the row logsumexp ``lse`` [B, H, S] (f32) the kernel also writes.
    ``mask``: [B, S] key validity (nonzero = attend) or None."""
    m4 = None if mask is None else mask[:, None, None, :]
    scores = apply_mask(attention_scores(q, k), m4, causal=causal)
    lse = torch.logsumexp(scores, dim=-1)
    # a fully masked row keeps the kernel's value m + log(1e-20) == NEG_INF
    lse = torch.where(lse > NEG_INF / 2, lse,
                      torch.full_like(lse, NEG_INF))
    o = multi_head_attention(q, k, v, mask=m4, causal=causal, impl="xla")
    return o, lse


def _launch(q, k, v, mask, causal: bool):
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, got {name} "
                            f"{t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs contiguous, "
                             f"16-byte aligned [B,S,H,D] {name}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash_attention kernel grid takes B*H <= 65535, "
                         f"got {b * h}")
    if mask is not None:
        if tuple(mask.shape) != (b, s):
            raise ValueError(f"mask shape {tuple(mask.shape)} != {(b, s)}")
        if mask.dtype != torch.int32:
            raise TypeError(f"flash_attention kernel takes an int32 key mask "
                            f"(nonzero = attend), got {mask.dtype}")
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError(f"flash_attention kernel needs a contiguous key "
                             f"mask on {q.device}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(),
                  mask.data_ptr() if mask is not None else None,
                  o.data_ptr(), lse.data_ptr(), b, s, h, d, int(causal),
                  1.0 / math.sqrt(d))
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        causal: bool = False):
    """[B,S,H,D] q/k/v (+ [B,S] key mask) -> (o [B,S,H,D], lse [B,H,S]).
    CUDA tensors launch the kernel (``flash_attention_fwd.launches``
    counts each launch); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return _launch(q, k, v, mask, causal)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: torch.Tensor | None = None, causal: bool = False,
                    block_q: int = 0, block_k: int = 0, bwd_block: int = 0,
                    bwd_variant: str = "split") -> torch.Tensor:
    """Drop-in for ``multi_head_attention(impl="xla")``: [B,S,H,D] in/out.
    ``mask``: [B,S] key validity or broadcastable [B,1,1,S]. The tile and
    backward levers are accepted only at their defaults (see the module
    docstring)."""
    if block_q or block_k or bwd_block or bwd_variant != "split":
        raise NotImplementedError(
            "the Hopper flash-attention forward has fixed 64x64 tiles and "
            "the backward arrives with the training slice: block_q/block_k/"
            "bwd_block/bwd_variant are not taken yet")
    if mask is not None and mask.ndim == 4:
        mask = mask[:, 0, 0, :]
    return flash_attention_fwd(q, k, v, mask, causal)[0]
