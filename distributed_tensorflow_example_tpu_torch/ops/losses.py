"""LM-head losses (port of the language-model part of
``distributed_tensorflow_example_tpu/ops/losses.py``).

:func:`lm_head_xent` is the weight-tied LM head's softmax cross-entropy
plus token accuracy, as weighted token means. The port has the
reference's ``impl="full"``, which materializes the [..., T, V] f32
logits; the sequence-chunked and the fused vocab-blockwise impls arrive
with slice A3c and raise until then. The post-logits numerics
(:func:`token_nll`, :func:`lm_nll_hits`, :func:`weighted_token_mean`)
are the reference's.
"""

from __future__ import annotations

import torch

LM_LOSS_IMPLS = ("full", "chunked", "fused")


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood (gather form, no one-hots)."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - picked


def lm_nll_hits(logits: torch.Tensor, labels: torch.Tensor, *,
                accuracy: bool = True):
    """Per-token ``(nll, hit)`` from materialized logits; ``accuracy=False``
    drops the argmax (``hit`` is None)."""
    nll = token_nll(logits, labels)
    if not accuracy:
        return nll, None
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    return nll, hit


def weighted_token_mean(nll: torch.Tensor, hit, w: torch.Tensor):
    """Weighted token means -> ``(loss, accuracy)``; ``hit=None`` (the
    argmax was skipped) gives the -1.0 sentinel as the accuracy."""
    denom = torch.clamp_min(w.sum(), 1.0)
    loss = (nll * w).sum() / denom
    if hit is None:
        return loss, torch.full((), -1.0, device=loss.device)
    return loss, (hit * w).sum() / denom


def _head_logits(h: torch.Tensor, table: torch.Tensor, dtype):
    """[..., H] @ [V, H]^T -> [..., V] f32 logits: operands rounded to the
    compute ``dtype``, products accumulated in f32 (the reference's
    ``preferred_element_type=f32`` einsum)."""
    if dtype is not None:
        h = h.to(dtype)
        table = table.to(dtype)
    return torch.matmul(h.float(), table.float().t())


def lm_head_xent(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, *, impl: str = "full",
                 seq_chunk: int = 0, vocab_block: int = 0, dtype=None,
                 accuracy: bool = True):
    """Weighted-mean softmax cross-entropy and token accuracy of ``h``
    [..., T, H] decoded against the tied embedding ``table`` [V, H] (no
    bias: the reference's ``bias`` serves BERT's head, slice A3c):
    ``(loss, accuracy)`` scalars. The knob checks are the reference's;
    ``impl="chunked"`` and ``"fused"`` raise until slice A3c."""
    if impl not in LM_LOSS_IMPLS:
        raise ValueError(f"lm_loss_impl must be one of {LM_LOSS_IMPLS}, "
                         f"got {impl!r}")
    if vocab_block and impl != "fused":
        raise ValueError(
            f"lm_loss_vocab_block={vocab_block} tunes the fused vocab "
            f"scan and requires impl='fused', got {impl!r}")
    if seq_chunk and impl != "chunked":
        raise ValueError(
            f"seq_chunk={seq_chunk} is the chunked impl's lever; got "
            f"impl={impl!r}")
    if impl != "full":
        raise NotImplementedError(
            f"lm_loss_impl={impl!r} arrives with slice A3c; the port has "
            f"impl='full'")
    nll, hit = lm_nll_hits(_head_logits(h, table, dtype), labels,
                           accuracy=accuracy)
    return weighted_token_mean(nll, hit, weights.float())
