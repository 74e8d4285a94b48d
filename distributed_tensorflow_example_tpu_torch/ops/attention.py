"""Multi-head attention with pluggable implementations (port of
``distributed_tensorflow_example_tpu/ops/attention.py``).

- ``impl="xla"``: the plain PyTorch einsum chain, named after the
  reference's XLA path it mirrors: scores in f32, NEG_INF masking,
  softmax in f32, probabilities cast to V's dtype before the context
  product with f32 accumulation.
- ``impl="flash"``: the hand-written Hopper flash-attention forward
  (:mod:`.cuda.flash_attention`); on CPU tensors its plain version.

Shape convention: [batch, seq, heads, head_dim] (BSHD) throughout.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

# mask fill value: large negative but finite, so online-softmax recurrences
# can compute exp(NEG_INF - NEG_INF) paths without inf-inf=nan; far enough
# below any real score that exp underflows to exactly 0
NEG_INF = -1e30


def attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B,Sq,H,D] x [B,Sk,H,D] -> [B,H,Sq,Sk] scaled scores (f32)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s / math.sqrt(d)


def apply_mask(scores: torch.Tensor, mask: torch.Tensor | None, *,
               causal: bool = False, q_offset: int = 0,
               k_offset: int = 0) -> torch.Tensor:
    """mask: broadcastable to [B,1,1,Sk] (nonzero = attend). Causal uses
    global position offsets, as the reference's sequence-sharded blocks
    need."""
    neg = torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask.to(scores.device) != 0, scores, neg)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(sq, device=scores.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=scores.device)[None, :] + k_offset
        scores = torch.where(qpos >= kpos, scores, neg)
    return scores


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mask: torch.Tensor | None = None,
                         causal: bool = False, impl: str = "xla",
                         flash_kwargs: Mapping[str, Any] | None = None,
                         ) -> torch.Tensor:
    """[B,S,H,D] qkv -> [B,S,H,D] context. Softmax in f32.

    Fully-masked query rows (no valid key) return ZEROS under every impl
    (plain softmax over an all-NEG_INF row would return the uniform
    average of V instead), so ``impl`` is a drop-in swap at padded rows.
    ``flash_kwargs`` are the flash kernel's levers, rejected unless
    ``impl="flash"``."""
    if impl == "flash":
        from .cuda.flash_attention import flash_attention
        return flash_attention(q, k, v, mask=mask, causal=causal,
                               **(flash_kwargs or {}))
    if flash_kwargs:
        raise ValueError(
            f"flash_kwargs {sorted(flash_kwargs)} tune the flash kernel "
            f"and require impl='flash', got impl={impl!r}")
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    scores = apply_mask(attention_scores(q, k), mask, causal=causal)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None or causal:
        any_valid = torch.any(scores > NEG_INF / 2, dim=-1, keepdim=True)
        probs = torch.where(any_valid, probs, torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)
