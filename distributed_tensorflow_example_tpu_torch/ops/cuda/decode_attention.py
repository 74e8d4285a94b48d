"""Single-query decode attention over the KV-cache slab: the Hopper kernel
``csrc/decode_attention.cu`` and its plain PyTorch version (port of the
slab path of ``distributed_tensorflow_example_tpu/ops/pallas/
decode_attention.py``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
the call raises (no silent fallback). The kernel takes any cache length
T that int32 indexes (no ``T % 128`` gate), head dims 64 and 128, bf16 q
[B, H, D] and contiguous, 16-byte aligned bf16 slabs [B, T, H, D]. It is
split-K: :func:`split_plan` cuts each row into splits, one CTA each, from
the shapes and the card's SM count alone (never from ``pos``/``pad``, so
no call waits on the card); the wrapper allocates the scores and the
splits' partials. The block-paged kernels (bf16 and int8 pools) are in
:mod:`.paged_decode_attention` and share the plan.
"""

from __future__ import annotations

import functools
import math

import torch

from ..attention import multi_head_attention
from . import _build

KERNEL_HEAD_DIMS = (64, 128)
#: the decode kernels index slots, pos and pad, and number their CTAs, in
#: int32
INT32_MAX = 2**31 - 1
#: slots a CTA of the decode kernels takes at once
TILE = 64
#: the plan gives each CTA one tile until the grid would pass this many CTAs
#: per SM, then as many tiles as keep it there
CTAS_PER_SM = 16
#: the caches are read in 16-byte vectors
CACHE_ALIGN = 16


def split_plan(b: int, h: int, slots: int, sms: int) -> tuple[int, int]:
    """(per, splits) for a [B, H] query over rows of ``slots`` slots on a
    card of ``sms`` SMs: each row is cut into ``splits`` runs of ``per``
    consecutive :data:`TILE`-slot tiles, one CTA each, so CTA (b, h, i)
    takes slots ``[i * per * TILE, (i + 1) * per * TILE)`` of its row (the
    last run may be cut by the row's end). ``per`` is 1 while the
    ``b * h * tiles`` CTAs stay within ``CTAS_PER_SM * sms``, and grows to
    keep them there beyond. Raises where the grid would pass int32 (the
    wrappers have checked ``slots`` against it)."""
    tiles = -(-slots // TILE)
    per = max(1, -(-b * h * tiles // (CTAS_PER_SM * sms)))
    splits = -(-tiles // per)
    if b * h * splits > INT32_MAX:
        raise ValueError(f"the split-K decode kernels number their CTAs in "
                         f"int32: B x H x splits <= {INT32_MAX}, got {b} x "
                         f"{h} x {splits}")
    return per, splits


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if k.data_ptr() % CACHE_ALIGN or v.data_ptr() % CACHE_ALIGN:
        raise ValueError(f"decode_attention kernel reads {CACHE_ALIGN}-byte "
                         f"vectors: the caches must be {CACHE_ALIGN}-byte "
                         f"aligned")
    if t > INT32_MAX:
        raise ValueError(f"decode_attention kernel indexes slots in int32: "
                         f"T <= {INT32_MAX}, got {t}")
    per, splits = split_plan(b, h, t, _sm_count(q.device))
    pos_b = _rows(pos, b, q.device).contiguous()
    pad_b = _rows(pad, b, q.device).contiguous()
    # the scores [B*H, T], each split's (m, l) and its [D] PV partial
    scratch = torch.empty(b * h * (t + splits * (d + 2)),
                          dtype=torch.float32, device=q.device)
    o = torch.empty((b, h, d), dtype=v.dtype, device=q.device)
    _build.launch("decode_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), pos_b.data_ptr(), pad_b.data_ptr(),
                  scratch.data_ptr(), o.data_ptr(), b, t, h, d, per, splits,
                  1.0 / math.sqrt(d))
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
