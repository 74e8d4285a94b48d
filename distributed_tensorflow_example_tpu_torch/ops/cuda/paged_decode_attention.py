"""Single-query decode attention through block tables over a shared paged
KV pool: the Hopper kernel ``csrc/paged_decode_attention.cu`` and its plain
PyTorch version (port of the float-pool paged path of
``distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py``).

Row b's logical cache slot j lives in ``pool[block_tables[b, j // Bs],
j % Bs]``; the row attends to the slots ``pad_b <= j <= pos_b``. A CPU
tensor takes the plain version; a CUDA tensor takes the kernel or the call
raises (no silent fallback). The kernel takes bf16 q [B, H, D] and
contiguous bf16 pools [N, Bs, H, D], an int32 [B, NB] table and int32
pos/pad, head dims 64 and 128, any block size, and up to 8192 logical
slots per row (``NB * Bs``). The int8 pools with their row scales (the
reference's ``quant=True`` kernel) arrive with a later slice.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .decode_attention import _rows, xla_decode_attention

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_SLOTS = 8192


def xla_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, *, block_tables, pos,
                               pad) -> torch.Tensor:
    """The plain version: gather each row's block run out of the pool into
    its [NB * Bs, H, D] logical cache and run the plain slab path
    (:func:`xla_decode_attention`), so it is bitwise the slab path on equal
    logical contents."""
    n, bs, h, d = k_pool.shape
    bt = torch.as_tensor(block_tables, device=k_pool.device).long()
    b, nb = bt.shape

    def gather(pool):
        return pool[bt].reshape(b, nb * bs, h, d)

    return xla_decode_attention(q, gather(k_pool), gather(v_pool), pos=pos,
                                pad=pad)


def _launch(q, k_pool, v_pool, bt, pos, pad):
    n, bs, h, d = k_pool.shape
    b, nb = bt.shape
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"paged_decode_attention kernel takes bf16, got "
                            f"{name} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention kernel needs "
                             f"contiguous {name}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool shape {tuple(v_pool.shape)} != k_pool "
                         f"shape {tuple(k_pool.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes head dim "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if nb * bs > KERNEL_MAX_SLOTS:
        raise ValueError(
            f"paged_decode_attention kernel keeps a row's scores in shared "
            f"memory: blocks per row x block_size <= {KERNEL_MAX_SLOTS}, "
            f"got {nb} x {bs}")
    if bt.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention kernel takes int32 "
                        f"block_tables, got {bt.dtype}")
    if bt.device != q.device or not bt.is_contiguous():
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "block_tables on q's device")
    if b > 65535 or h > 65535:
        raise ValueError(f"paged_decode_attention kernel grid takes B and H "
                         f"<= 65535, got B={b} H={h}")
    pos_b = _rows(pos, b, q.device).contiguous()
    pad_b = _rows(pad, b, q.device).contiguous()
    o = torch.empty((b, h, d), dtype=v_pool.dtype, device=q.device)
    _build.launch("paged_decode_attention", q.device, q.data_ptr(),
                  k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
                  pos_b.data_ptr(), pad_b.data_ptr(), o.data_ptr(), b, n, bs,
                  nb, h, d, 1.0 / math.sqrt(d))
    paged_decode_attention.launches += 1
    return o


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, *, block_tables, pos, pad,
                           k_scale=None, v_scale=None,
                           impl: str = "auto") -> torch.Tensor:
    """One-query attention against the block-paged cache pool.

    ``q``: [B, H, D]; ``k_pool``/``v_pool``: [N, block_size, H, D] shared
    physical blocks; ``block_tables``: [B, NB] int32; ``pos``/``pad``: [B]
    (or scalar) int32 live window per row. Returns [B, H, D] in V's dtype.

    ``impl="auto"``: the kernel for CUDA tensors (counted in
    ``paged_decode_attention.launches``), the plain version for CPU
    tensors; ``"xla"``: the plain version on any device."""
    n, bs, h, d = k_pool.shape
    b = q.shape[0]
    if tuple(q.shape) != (b, h, d):
        raise ValueError(f"q shape {tuple(q.shape)} != {(b, h, d)} from pool "
                         f"{tuple(k_pool.shape)}")
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown decode attention impl {impl!r}")
    if k_scale is not None or v_scale is not None \
            or k_pool.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV pools (k_scale/v_scale, the reference's quant=True "
            "kernel) arrive with a later slice")
    bt = torch.as_tensor(block_tables, device=q.device)
    if bt.ndim != 2 or bt.shape[0] != b:
        raise ValueError(f"block_tables shape {tuple(bt.shape)} != ({b}, NB)")
    if impl == "xla" or q.device.type == "cpu":
        return xla_paged_decode_attention(q, k_pool, v_pool,
                                          block_tables=bt, pos=pos, pad=pad)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, k_pool, v_pool, bt, pos, pad)


paged_decode_attention.launches = 0
