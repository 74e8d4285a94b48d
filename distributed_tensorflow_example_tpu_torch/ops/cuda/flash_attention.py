"""Flash attention, forward and backward: the Hopper kernels
``csrc/flash_attention_fwd.cu`` (B1), ``csrc/flash_attention_bwd_dq.cu``
(B2a) and ``csrc/flash_attention_bwd_dkv.cu`` (B2b), the split backward,
and ``csrc/flash_attention_bwd_fused.cu`` (B3), the fused backward, each
beside its plain PyTorch version (port of ``distributed_tensorflow_example_
tpu/ops/pallas/flash_attention.py``).

A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
the call raises (no silent fallback). The kernels take any sequence
length (the ragged last tile is masked in the kernel, unlike the TPU
kernels' ``S % block`` gate), head dims 64 and 128, bf16 q/k/v (and dO)
laid out contiguous [B, S, H, D], f32 logsumexp and ``Dsum`` [B, H, S],
and a contiguous int32 [B, S] key mask (nonzero = attend; the model
converts it once per forward). Their tiles are fixed at 64 query rows x
64 keys by design, so the reference's ``block_q``/``block_k``/
``bwd_block`` levers, which tune the TPU grid, are refused instead of
silently ignored.

:func:`flash_attention` is differentiable: with grad mode on and q, k or
v requiring grad it runs :class:`FlashAttention`, the counterpart of the
reference's ``custom_vjp`` (``_make_flash``): the forward saves q, k, v,
o, the logsumexp and the mask, and the backward computes
``Dsum = rowsum(dO * O)`` in f32 with plain ops (plain XLA in the
reference's ``_bwd``) and then, by ``bwd_variant``, dq (B2a) and dk, dv
(B2b), or all three in one pass (B3). Otherwise (serving,
``torch.no_grad``) it runs the forward alone and saves nothing.
"""

from __future__ import annotations

import math

import torch

from ..attention import (NEG_INF, apply_mask, attention_scores,
                         multi_head_attention)
from . import _build

KERNEL_HEAD_DIMS = (64, 128)
BLOCK = 64          # the kernels' query and key tile
MAX_CTAS = 2**31 - 1  # a 1-D grid's CTAs: one per (64-row tile, b*h)

#: the reference's dq slab budget (``_FUSED_SLAB_LIMIT``): its fused TPU
#: kernel keeps a [S, D] f32 dq slab in VMEM and runs the split backward
#: past this size. The Hopper kernel has no such limit (its dq accumulator
#: lies in device memory); the limit is kept only so that both packages
#: pick the same variant for the same (S, D), and the launch counters say
#: which kernels ran. At D=64 it starts above S=32,768, past every shipped
#: ``max_len``.
_FUSED_SLAB_LIMIT = 8 * 2**20

BWD_VARIANTS = ("split", "fused")


def effective_bwd_variant(seq: int, head_dim: int,
                          bwd_variant: str = "split") -> str:
    """The backward variant that runs for these shapes, the reference's
    rule: "fused" becomes "split" when the reference's dq slab would pass
    :data:`_FUSED_SLAB_LIMIT`."""
    if bwd_variant == "fused" and seq * head_dim * 4 > _FUSED_SLAB_LIMIT:
        return "split"
    return bwd_variant


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


def _bwd_probs(q, k, v, do, lse, dsum, mask, causal: bool):
    """The reference's backward recompute, in f32 over the whole [S, S]
    block: ``s = q k^T scale`` masked with NEG_INF, ``p = exp(s - L) *
    (s > NEG_INF/2)``, ``dp = dO v^T`` and ``ds = p (dp - D) scale``.
    Returns (p, ds), both [B, H, S, S]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = apply_mask(s, None if mask is None else mask[:, None, None, :],
                   causal=causal)
    p = torch.exp(s - lse[..., None]) * (s > NEG_INF / 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - dsum[..., None]) * scale
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, dsum, mask=None,
                                 causal: bool = False) -> torch.Tensor:
    """B2a's plain version: ``dq = ds k`` (f32, cast to q's dtype)."""
    _, ds = _bwd_probs(q, k, v, do, lse, dsum, mask, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, dsum, mask=None,
                                  causal: bool = False):
    """B2b's plain version: ``dk = ds^T q`` and ``dv = p^T dO`` (f32, cast
    to k's and v's dtypes)."""
    p, ds = _bwd_probs(q, k, v, do, lse, dsum, mask, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_fused_plain(q, k, v, do, lse, dsum, mask=None,
                                    causal: bool = False):
    """B3's plain version: p and ds formed once, then ``dq = ds k``,
    ``dk = ds^T q`` and ``dv = p^T dO`` (f32, cast to the inputs' dtypes),
    the same ops as the split plain versions, so equal to them bitwise."""
    p, ds = _bwd_probs(q, k, v, do, lse, dsum, mask, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dsum(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``Dsum = rowsum(dO * O)`` in f32, [B, S, H, D] -> contiguous
    [B, H, S]: the per-row term of the softmax backward, a plain op as in
    the reference's ``_bwd``."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, mask=None,
                              causal: bool = False):
    """The backward's oracle, following the reference's algebra (it does
    not differentiate the plain forward): (dq, dk, dv) from the saved
    forward (o, lse) and the output cotangent ``do``."""
    dsum = flash_attention_dsum(do, o)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, dsum, mask, causal)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, dsum, mask,
                                           causal)
    return dq, dk, dv


def _check(kernel: str, q, tensors: dict, mask, rows: dict):
    """Raise on anything the kernels do not take: bf16 [B,S,H,D] ``tensors``
    shaped as q, contiguous and 16-byte aligned on q's device, at most
    :data:`MAX_CTAS` tiles of 64 rows; f32 [B,H,S] ``rows``; a contiguous
    int32 [B,S] mask or None."""
    b, s, h, d = q.shape
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16, got {name} "
                            f"{t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel needs contiguous, 16-byte "
                             f"aligned [B,S,H,D] {name}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dim "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    ctas = -(-s // BLOCK) * b * h
    if ctas > MAX_CTAS:
        raise ValueError(f"{kernel} kernel launches ceil(S/64)*B*H = {ctas} "
                         f"CTAs, past the 1-D grid's limit of 2**31 - 1")
    for name, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, s)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{kernel} kernel takes a contiguous f32 "
                             f"[B,H,S] {name} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if mask is not None:
        if tuple(mask.shape) != (b, s):
            raise ValueError(f"mask shape {tuple(mask.shape)} != {(b, s)}")
        if mask.dtype != torch.int32:
            raise TypeError(f"{kernel} kernel takes an int32 key mask "
                            f"(nonzero = attend), got {mask.dtype}")
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError(f"{kernel} kernel needs a contiguous key mask "
                             f"on {q.device}")


def _on_card(kernel: str, q) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); anything else raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return True


def _ptr(mask):
    return mask.data_ptr() if mask is not None else None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        causal: bool = False):
    """[B,S,H,D] q/k/v (+ [B,S] key mask) -> (o [B,S,H,D], lse [B,H,S]).
    CUDA tensors launch the kernel (``flash_attention_fwd.launches``
    counts each launch); CPU tensors take the plain version."""
    if not _on_card("flash_attention", q):
        return flash_attention_fwd_plain(q, k, v, mask, causal)
    _check("flash_attention", q, {"q": q, "k": k, "v": v}, mask, {})
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), _ptr(mask), o.data_ptr(),
                  lse.data_ptr(), b, s, h, d, int(causal),
                  1.0 / math.sqrt(d))
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, dsum, mask=None,
                           causal: bool = False) -> torch.Tensor:
    """dq [B,S,H,D] from q/k/v/dO [B,S,H,D] and the f32 [B,H,S] logsumexp
    and ``Dsum``. CUDA tensors launch B2a (``flash_attention_bwd_dq.
    launches`` counts each launch); CPU tensors take the plain version."""
    if not _on_card("flash_attention_bwd_dq", q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, dsum, mask,
                                            causal)
    _check("flash_attention_bwd_dq", q, {"q": q, "k": k, "v": v, "do": do},
           mask, {"lse": lse, "dsum": dsum})
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    _build.launch("flash_attention_bwd_dq", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dsum.data_ptr(), _ptr(mask), dq.data_ptr(), b, s, h, d,
                  int(causal), 1.0 / math.sqrt(d))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum, mask=None,
                            causal: bool = False):
    """(dk, dv) [B,S,H,D] from the same inputs as
    :func:`flash_attention_bwd_dq`. CUDA tensors launch B2b
    (``flash_attention_bwd_dkv.launches``); CPU tensors take the plain
    version."""
    if not _on_card("flash_attention_bwd_dkv", q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, dsum, mask,
                                             causal)
    _check("flash_attention_bwd_dkv", q, {"q": q, "k": k, "v": v, "do": do},
           mask, {"lse": lse, "dsum": dsum})
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch("flash_attention_bwd_dkv", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dsum.data_ptr(), _ptr(mask), dk.data_ptr(), dv.data_ptr(),
                  b, s, h, d, int(causal), 1.0 / math.sqrt(d))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_fused(q, k, v, do, lse, dsum, mask=None,
                              causal: bool = False):
    """(dq, dk, dv) [B,S,H,D] from the same inputs as
    :func:`flash_attention_bwd_dq`, in one pass. CUDA tensors launch B3
    (``flash_attention_bwd_fused.launches``); CPU tensors take the plain
    version. Besides the outputs the wrapper allocates B3's scratch: an
    f32 [B,H,S,D] dq accumulator (no zero fill needed) and one int32 zero
    per (b*h, query tile) plus a ticket counter."""
    if not _on_card("flash_attention_bwd_fused", q):
        return flash_attention_bwd_fused_plain(q, k, v, do, lse, dsum, mask,
                                               causal)
    _check("flash_attention_bwd_fused", q,
           {"q": q, "k": k, "v": v, "do": do}, mask,
           {"lse": lse, "dsum": dsum})
    b, s, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    sync = torch.zeros(1 + b * h * -(-s // BLOCK), dtype=torch.int32,
                       device=q.device)
    _build.launch("flash_attention_bwd_fused", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dsum.data_ptr(), _ptr(mask), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), dq_acc.data_ptr(), sync.data_ptr(), b, s, h,
                  d, int(causal), 1.0 / math.sqrt(d))
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_bwd_fused.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention: B1 forward; the split backward (B2a and B2b) or
    the fused one (B3) on the card, the plain versions on the CPU.
    ``apply(q, k, v, mask, causal, bwd_variant)``; the mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal: bool, bwd_variant: str):
        o, lse = flash_attention_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.causal = causal
        ctx.bwd_variant = bwd_variant
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        do = do.contiguous()
        dsum = flash_attention_dsum(do, o)
        args = (q, k, v, do, lse, dsum, mask, ctx.causal)
        if ctx.bwd_variant == "fused":
            dq, dk, dv = flash_attention_bwd_fused(*args)
        else:
            dq = flash_attention_bwd_dq(*args)
            dk, dv = flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask: torch.Tensor | None = None, causal: bool = False,
                    block_q: int = 0, block_k: int = 0, bwd_block: int = 0,
                    bwd_variant: str = "split") -> torch.Tensor:
    """Drop-in for ``multi_head_attention(impl="xla")``: [B,S,H,D] in/out,
    differentiable (see the module docstring). ``mask``: [B,S] key
    validity or broadcastable [B,1,1,S]. ``bwd_variant`` picks the split
    or the fused backward, through :func:`effective_bwd_variant` as in
    the reference. The tile levers are refused: the tiles are fixed at
    64x64."""
    if block_q or block_k or bwd_block:
        raise NotImplementedError(
            "the Hopper flash-attention kernels have fixed 64x64 tiles by "
            "design: block_q/block_k/bwd_block are not taken")
    if bwd_variant not in BWD_VARIANTS:
        raise ValueError(f"bwd_variant must be one of {BWD_VARIANTS}, got "
                         f"{bwd_variant!r}")
    bwd_variant = effective_bwd_variant(q.shape[1], q.shape[-1], bwd_variant)
    if mask is not None and mask.ndim == 4:
        mask = mask[:, 0, 0, :]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, mask, causal, bwd_variant)
    return flash_attention_fwd(q, k, v, mask, causal)[0]
