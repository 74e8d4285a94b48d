"""Single-query decode attention through block tables over a shared paged
KV pool: the Hopper kernel ``csrc/paged_decode_attention.cu`` and its plain
PyTorch version (port of the float-pool paged path of
``distributed_tensorflow_example_tpu/ops/pallas/decode_attention.py``).

Row b's logical cache slot j lives in ``pool[block_tables[b, j // Bs],
j % Bs]``; the row attends to the slots ``pad_b <= j <= pos_b``. A CPU
tensor takes the plain version; a CUDA tensor takes the kernel or the call
raises (no silent fallback). The kernel takes bf16 q [B, H, D] and
contiguous, 16-byte aligned bf16 pools [N, Bs, H, D], an int32 [B, NB]
table and int32 pos/pad, head dims 64 and 128, any block size, and any
number of logical slots per row (``NB * Bs``) that int32 indexes. It is
split-K: :func:`split_plan` cuts each row into splits, one CTA each, from
the shapes and the card's SM count alone (never from ``pos``/``pad``, so
no call waits on the card), and a second kernel merges each row's split
partials, which the wrapper allocates.

int8 pools carry one f32 scale per token slot (``k_scale``/``v_scale``
[N, Bs], the reference's ``quant=True`` kernel): on CUDA tensors they
take the second kernel, ``csrc/paged_decode_attention_int8.cu``, which
folds the scales into the scores and probabilities; the plain version
dequantizes the gathered rows to q's dtype first. The output is then in
q's dtype. Scales and int8 pools travel together: one without the other
raises.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .decode_attention import _rows, xla_decode_attention

KERNEL_HEAD_DIMS = (64, 128)
#: the kernels index slots, pos and pad, and number their CTAs, in int32
INT32_MAX = 2**31 - 1
#: logical slots a CTA of the kernels takes at once
TILE = 64
#: the plan gives each CTA one tile until the grid would pass this many CTAs
#: per SM, then as many tiles as keep it there
CTAS_PER_SM = 16
#: the pools are read in 16-byte vectors
POOL_ALIGN = 16


def split_plan(b: int, h: int, slots: int, sms: int) -> tuple[int, int]:
    """(per, splits) for a [B, H] query over rows of ``slots`` logical
    slots on a card of ``sms`` SMs: each row is cut into ``splits`` runs of
    ``per`` consecutive :data:`TILE`-slot tiles, one CTA each, so CTA
    (b, h, i) takes slots ``[i * per * TILE, (i + 1) * per * TILE)`` of its
    row (the last run may be cut by the row's end). ``per`` is 1 while the
    ``b * h * tiles`` CTAs stay within ``CTAS_PER_SM * sms``, and grows to
    keep them there beyond. Raises where the grid would pass int32 (the
    wrapper has checked ``slots`` against it)."""
    tiles = -(-slots // TILE)
    per = max(1, -(-b * h * tiles // (CTAS_PER_SM * sms)))
    splits = -(-tiles // per)
    if b * h * splits > INT32_MAX:
        raise ValueError(f"paged_decode_attention kernel numbers its CTAs "
                         f"in int32: B x H x splits <= {INT32_MAX}, got "
                         f"{b} x {h} x {splits}")
    return per, splits


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def xla_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, *, block_tables, pos,
                               pad, k_scale=None, v_scale=None
                               ) -> torch.Tensor:
    """The plain version: gather each row's block run out of the pool into
    its [NB * Bs, H, D] logical cache and run the plain slab path
    (:func:`xla_decode_attention`), so it is bitwise the slab path on equal
    logical contents. With int8 pools the gather also dequantizes each
    row: an f32 multiply by its ``k_scale``/``v_scale`` entry, cast to q's
    dtype (the reference's XLA path)."""
    n, bs, h, d = k_pool.shape
    bt = torch.as_tensor(block_tables, device=k_pool.device).long()
    b, nb = bt.shape

    def gather(pool, scale):
        g = pool[bt]                                    # [B, NB, Bs, H, D]
        if scale is not None:
            g = (g.float() * scale[bt][..., None, None]).to(q.dtype)
        return g.reshape(b, nb * bs, h, d)

    return xla_decode_attention(q, gather(k_pool, k_scale),
                                gather(v_pool, v_scale), pos=pos, pad=pad)


def _check_scales(k_pool, v_pool, k_scale, v_scale) -> None:
    """The reference's rules for int8 pools and their scales (both
    packages raise on the same inputs), plus f32 scales."""
    n, bs = k_pool.shape[:2]
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together (int8 "
                         "pools carry one scale per cached token for BOTH "
                         "k and v)")
    if k_scale is None:
        if k_pool.dtype == torch.int8 or v_pool.dtype == torch.int8:
            raise ValueError("int8 pools need k_scale/v_scale: attending "
                             "over raw int8 bytes would give garbage")
        return
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise ValueError(f"k_scale/v_scale describe int8 pools, got pool "
                         f"dtype {k_pool.dtype}/{v_pool.dtype}")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != (n, bs):
            raise ValueError(f"{name} scale shape {tuple(s.shape)} != "
                             f"per-slot ({n}, {bs}) from pool "
                             f"{tuple(k_pool.shape)}")
        if s.dtype != torch.float32:
            raise TypeError(f"{name} must be f32 scales, got {s.dtype}")


def _launch(q, k_pool, v_pool, bt, pos, pad, k_scale=None, v_scale=None):
    """Check the inputs against what the kernel takes and launch it: the
    bf16 kernel, or with scales the int8 kernel (each with its own launch
    count: one per call, for the split kernel and the combine kernel it
    runs). Raises instead of falling back."""
    n, bs, h, d = k_pool.shape
    b, nb = bt.shape
    quant = k_scale is not None
    pool = ("int8", torch.int8) if quant else ("bf16", torch.bfloat16)
    tensors = [("q", q, ("bf16", torch.bfloat16)), ("k_pool", k_pool, pool),
               ("v_pool", v_pool, pool)]
    if quant:       # the wrapper has checked the scales' shape and f32 dtype
        tensors += [("k_scale", k_scale, None), ("v_scale", v_scale, None)]
    for name, x, want in tensors:
        if want is not None and x.dtype != want[1]:
            raise TypeError(f"paged_decode_attention kernel takes {want[0]} "
                            f"{name}, got {x.dtype}")
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
    if k_pool.data_ptr() % POOL_ALIGN or v_pool.data_ptr() % POOL_ALIGN:
        raise ValueError(f"paged_decode_attention kernel reads "
                         f"{POOL_ALIGN}-byte vectors: the pools must be "
                         f"{POOL_ALIGN}-byte aligned")
    if nb * bs > INT32_MAX:
        raise ValueError(f"paged_decode_attention kernel indexes slots in "
                         f"int32: blocks per row x block_size <= "
                         f"{INT32_MAX}, got {nb} x {bs}")
    if bt.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention kernel takes int32 "
                        f"block_tables, got {bt.dtype}")
    if bt.device != q.device or not bt.is_contiguous():
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "block_tables on q's device")
    per, splits = split_plan(b, h, nb * bs, _sm_count(q.device))
    pos_b = _rows(pos, b, q.device).contiguous()
    pad_b = _rows(pad, b, q.device).contiguous()
    part = torch.empty((b * h, splits, d + 2), dtype=torch.float32,
                       device=q.device)              # each split's acc, m, l
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    tail = (bt.data_ptr(), pos_b.data_ptr(), pad_b.data_ptr(),
            part.data_ptr(), o.data_ptr(), b, n, bs, nb, h, d, per, splits,
            1.0 / math.sqrt(d))
    if quant:
        _build.launch("paged_decode_attention_int8", q.device, q.data_ptr(),
                      k_pool.data_ptr(), v_pool.data_ptr(),
                      k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        paged_decode_attention.launches_int8 += 1
    else:
        _build.launch("paged_decode_attention", q.device, q.data_ptr(),
                      k_pool.data_ptr(), v_pool.data_ptr(), *tail)
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
    int8 pools come with ``k_scale``/``v_scale`` ([N, block_size] f32, one
    scale per token slot) and return q's dtype.

    ``impl="auto"``: the kernel for CUDA tensors (counted in
    ``paged_decode_attention.launches``, or ``.launches_int8`` for int8
    pools), the plain version for CPU tensors; ``"xla"``: the plain
    version on any device."""
    n, bs, h, d = k_pool.shape
    b = q.shape[0]
    if tuple(q.shape) != (b, h, d):
        raise ValueError(f"q shape {tuple(q.shape)} != {(b, h, d)} from pool "
                         f"{tuple(k_pool.shape)}")
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown decode attention impl {impl!r}")
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    bt = torch.as_tensor(block_tables, device=q.device)
    if bt.ndim != 2 or bt.shape[0] != b:
        raise ValueError(f"block_tables shape {tuple(bt.shape)} != ({b}, NB)")
    if impl == "xla" or q.device.type == "cpu":
        return xla_paged_decode_attention(q, k_pool, v_pool,
                                          block_tables=bt, pos=pos, pad=pad,
                                          k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, k_pool, v_pool, bt, pos, pad, k_scale, v_scale)


paged_decode_attention.launches = 0       # float pools: the bf16 kernel
paged_decode_attention.launches_int8 = 0  # int8 pools: the int8 kernel
