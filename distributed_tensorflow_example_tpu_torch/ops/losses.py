"""Loss functions (port of ``distributed_tensorflow_example_tpu/
ops/losses.py``): the classification losses and metrics of the MNIST MLP
and the language-model part.

Every loss and metric reduces with a *mean* over the examples, so under
N synchronous ranks the all-reduced mean of the ranks' gradients is the
gradient of the global batch's mean, as in the reference.
:func:`_masked_mean` is the one masked mean they share (the padded eval
tail's ``where``).

:func:`lm_head_xent` is the weight-tied LM head's softmax cross-entropy
plus token accuracy, as weighted token means. The port has the
reference's ``impl="full"``, which materializes the [..., T, V] f32
logits; the sequence-chunked and the fused vocab-blockwise impls arrive
with slice A3c-3 and raise until then. The post-logits numerics
(:func:`token_nll`, :func:`lm_nll_hits`, :func:`weighted_token_mean`)
are the reference's.
"""

from __future__ import annotations

import torch

from ..utils.pytree import tree_leaves

LM_LOSS_IMPLS = ("full", "chunked", "fused")


def _masked_mean(values: torch.Tensor, where) -> torch.Tensor:
    """Mean over examples, restricted by optional example weights
    ``where`` (the padded eval tail's mask)."""
    if where is None:
        return values.mean()
    where = torch.as_tensor(where, device=values.device,
                            dtype=values.dtype)
    return (values * where).sum() / torch.clamp_min(where.sum(), 1.0)


def softmax_xent(logits: torch.Tensor, onehot: torch.Tensor, *,
                 where=None) -> torch.Tensor:
    """Mean softmax cross-entropy against one-hot (or soft) targets."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    ll = (onehot * (logits - logz)).sum(dim=-1)
    return -_masked_mean(ll, where)


def token_nll(logits: torch.Tensor, labels: torch.Tensor, *,
              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token negative log-likelihood (gather form, no one-hots);
    ``label_smoothing=eps`` takes ``(1-eps) logit_y + eps mean(logits)``
    as the target's logit."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if label_smoothing:
        eps = label_smoothing
        picked = (1.0 - eps) * picked + eps * logits.mean(dim=-1)
    return logz - picked


def softmax_xent_int_labels(logits: torch.Tensor, labels: torch.Tensor, *,
                            where=None,
                            label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy against integer labels, optionally
    label-smoothed (algebraically xent against the smoothed
    distribution, without one-hots)."""
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}")
    return _masked_mean(
        token_nll(logits, labels, label_smoothing=label_smoothing), where)


def l2_regularization(params, scale: float) -> torch.Tensor:
    return scale * sum(x.square().sum() for x in tree_leaves(params))


def accuracy(logits: torch.Tensor, labels: torch.Tensor, *,
             where=None) -> torch.Tensor:
    """Mean top-1 accuracy over integer labels (f32 scalar); ``where``
    restricts the mean."""
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    return _masked_mean(hit, where)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int, *,
                  where=None) -> torch.Tensor:
    """A hit when fewer than ``k`` logits exceed the true class's
    (``tf.nn.in_top_k``'s rule)."""
    true_logit = torch.gather(logits, -1, labels.long()[..., None])
    rank = (logits > true_logit).sum(dim=-1)
    return _masked_mean((rank < k).float(), where)


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
    bias: the reference's ``bias`` serves BERT's head, slice A3c-3):
    ``(loss, accuracy)`` scalars. The knob checks are the reference's;
    ``impl="chunked"`` and ``"fused"`` raise until slice A3c-3."""
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
            f"lm_loss_impl={impl!r} arrives with slice A3c-3; the port has "
            f"impl='full'")
    nll, hit = lm_nll_hits(_head_logits(h, table, dtype), labels,
                           accuracy=accuracy)
    return weighted_token_mean(nll, hit, weights.float())
