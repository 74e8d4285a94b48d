"""Single-query decode attention over the KV-cache slab: the Hopper kernel
``csrc/decode_attention.cu`` and its plain PyTorch version (port of the
slab path of ``distributed_tensorflow_example_tpu/ops/pallas/
decode_attention.py``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
the call raises (no silent fallback). The kernel takes any cache length
T up to 8192 (no ``T % 128`` gate), head dims 64 and 128, bf16 q
[B, H, D] and contiguous bf16 slabs [B, T, H, D]. The block-paged
kernels (bf16 and int8 pools) are in :mod:`.paged_decode_attention`.
"""

from __future__ import annotations

import math

import torch

from ..attention import multi_head_attention
from . import _build

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_T = 8192


def _rows(x, b: int, device) -> torch.Tensor:
    """A scalar or [B] int -> [B] int32 on ``device``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
    if t.numel() == 1:
        return t.expand(b)
    if t.numel() != b:
        raise ValueError(f"expected a scalar or [{b}] vector, got "
                         f"{t.numel()} values")
    return t


def xla_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, pos, pad) -> torch.Tensor:
    """The plain version: the exact ``multi_head_attention(impl="xla")``
    call the loop decode step makes, over the live window
    ``pad_b <= j <= pos_b``."""
    b, t = k.shape[:2]
    slots = torch.arange(t, device=k.device)
    pos_b = _rows(pos, b, k.device)[:, None]
    pad_b = _rows(pad, b, k.device)[:, None]
    live = (slots[None, :] <= pos_b) & (slots[None, :] >= pad_b)
    ctx = multi_head_attention(q[:, None], k, v,
                               mask=live[:, None, None, :], impl="xla")
    return ctx[:, 0]


def _launch(q, k, v, pos, pad):
    b, t, h, d = k.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bf16, got {name} "
                            f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"decode_attention kernel needs contiguous "
                             f"{name}")
    if v.shape != k.shape:
        raise ValueError(f"v shape {tuple(v.shape)} != k shape "
                         f"{tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head dim "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if t > KERNEL_MAX_T:
        raise ValueError(f"decode_attention kernel keeps the live scores "
                         f"in shared memory: T <= {KERNEL_MAX_T}, got {t}")
    if b > 65535:
        raise ValueError(f"decode_attention kernel grid takes B <= 65535, "
                         f"got {b}")
    pos_b = _rows(pos, b, q.device).contiguous()
    pad_b = _rows(pad, b, q.device).contiguous()
    o = torch.empty((b, h, d), dtype=v.dtype, device=q.device)
    _build.launch("decode_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), pos_b.data_ptr(), pad_b.data_ptr(),
                  o.data_ptr(), b, t, h, d, 1.0 / math.sqrt(d))
    decode_attention.launches += 1
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos, pad, impl: str = "auto") -> torch.Tensor:
    """One-query attention against the cache slab.

    ``q``: [B, H, D]; ``k``/``v``: [B, T, H, D] slabs (slot ``pos``
    already written); ``pos``: the current token's cache slot, a scalar
    (the ``generate`` loop) or [B] (per-row depths); ``pad``: [B] per-row
    dead-slot count. Returns [B, H, D].

    ``impl="auto"``: the kernel for CUDA tensors (counted in
    ``decode_attention.launches``), the plain version for CPU tensors;
    ``"xla"``: the plain version on any device (the reference path)."""
    b, t, h, d = k.shape
    if tuple(q.shape) != (b, h, d):
        raise ValueError(f"q shape {tuple(q.shape)} != {(b, h, d)} from "
                         f"cache {tuple(k.shape)}")
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown decode attention impl {impl!r}")
    if impl == "xla" or q.device.type == "cpu":
        return xla_decode_attention(q, k, v, pos=pos, pad=pad)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, pos, pad)


decode_attention.launches = 0
