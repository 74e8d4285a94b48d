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
reference's three impls: ``full`` materializes the [..., T, V] f32
logits, ``chunked`` takes sequence chunks under
``torch.utils.checkpoint``, and ``fused`` goes blockwise over the vocab
with a backward of its own (:class:`FusedLinearXent`), so the [..., V]
logits never exist in the forward or the backward. The post-logits
numerics (:func:`token_nll`, :func:`lm_nll_hits`,
:func:`weighted_token_mean`) are the reference's, and the fused pass
computes the same quantities online. Every product is ``torch.matmul``
with f32 accumulation: the reference computes them outside any Pallas
kernel too.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..utils.pytree import tree_leaves

LM_LOSS_IMPLS = ("full", "chunked", "fused")
#: the fused impl's vocab tile when the caller leaves it at 0 (the
#: reference's)
DEFAULT_VOCAB_BLOCK = 2048
#: the aux-metric key under which a loss that is a weighted token mean
#: reports its total weight (the sum before the clamp at 1): the sync
#: step weights N ranks' means by it and drops it from the metrics
LOSS_WEIGHT = "__loss_weight__"


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




def _head_logits(h: torch.Tensor, table: torch.Tensor, bias, dtype):
    """[..., H] @ [V, H]^T (+ bias) -> [..., V] f32 logits: operands
    rounded to the compute ``dtype``, products accumulated in f32 (the
    reference's ``preferred_element_type=f32`` einsum), the bias added
    in f32 after the accumulation. The one LM-head product, whether the
    caller takes the whole vocab or a block of it."""
    if dtype is not None:
        h = h.to(dtype)
        table = table.to(dtype)
    logits = torch.matmul(h.float(), table.float().t())
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _vocab_blocks(table: torch.Tensor, bias, block: int):
    """[V, H] table (+ optional [V] bias) -> ([nb, block, H], [nb, block]
    or None, nb), zero-padded to whole blocks. The padded columns are set
    to -inf inside the passes: a zero row would add exp(h . 0) = 1 to the
    softmax sum."""
    v, hd = table.shape
    nb = -(-v // block)
    pad = nb * block - v
    if pad:
        table = torch.nn.functional.pad(table, (0, 0, 0, pad))
        bias = None if bias is None else torch.nn.functional.pad(bias,
                                                                 (0, pad))
    return (table.reshape(nb, block, hd),
            None if bias is None else bias.reshape(nb, block), nb)


def _block_logits(h, blocks, biases, i: int, block: int, v: int):
    """Block ``i``'s [N, block] f32 logits, the padded columns -inf."""
    logits = _head_logits(h, blocks[i], None if biases is None
                          else biases[i], None)
    if (i + 1) * block > v:
        cols = i * block + torch.arange(block, device=h.device)
        logits = logits.masked_fill(cols[None, :] >= v, float("-inf"))
    return logits


def _fused_fwd_pass(h, table, bias, labels, block: int):
    """One pass over the vocab blocks: the block's logits h E[v0:v1]^T,
    an online logsumexp (running max and rescaled sum of exps), the
    label's logit picked in the block that holds it, and a running
    argmax. Returns per-token (nll, argmax, logz); at most one [N, block]
    logits tile is alive. ``h`` and ``table`` are already in the compute
    dtype."""
    v = table.shape[0]
    blocks, biases, nb = _vocab_blocks(table, bias, block)
    n = h.shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    m = torch.full((n,), float("-inf"), **f32)      # running max
    s = torch.zeros((n,), **f32)                    # sum of exp(. - m)
    picked = torch.zeros((n,), **f32)               # the label's logit
    best = torch.full((n,), float("-inf"), **f32)   # best logit
    best_idx = torch.zeros((n,), dtype=torch.int32, device=h.device)
    for i in range(nb):
        off = i * block
        logits = _block_logits(h, blocks, biases, i, block, v)
        bm = logits.max(dim=-1).values     # finite: every block holds a
        m_new = torch.maximum(m, bm)       # real column (nb = ceil(V/B))
        s = (s * torch.exp(m - m_new)
             + torch.exp(logits - m_new[:, None]).sum(dim=-1))
        m = m_new
        rel = labels - off
        in_blk = (rel >= 0) & (rel < block)
        pick = torch.gather(logits, 1,
                            rel.clamp(0, block - 1).long()[:, None])[:, 0]
        picked = torch.where(in_blk, pick, picked)
        # a strict > keeps the EARLIEST tied block, and torch.argmax the
        # earliest tied column in a block: argmax's first-occurrence rule
        # over the whole vocab
        better = bm > best
        best = torch.where(better, bm, best)
        best_idx = torch.where(
            better, off + logits.argmax(dim=-1).to(torch.int32), best_idx)
    logz = m + torch.log(s)
    return logz - picked, best_idx, logz


class FusedLinearXent(torch.autograd.Function):
    """The fused LM-head cross-entropy (the reference's ``custom_vjp``
    ``_fused_nll_argmax``): per-token (nll f32, argmax int32) with no
    [N, V] logits tensor in the forward or the backward.
    ``apply(h [N, H], table [V, H], bias [V] or None, labels [N] int32,
    block, dtype)``."""

    @staticmethod
    def forward(ctx, h, table, bias, labels, block: int, dtype):
        hc = h if dtype is None else h.to(dtype)
        tc = table if dtype is None else table.to(dtype)
        nll, best_idx, logz = _fused_fwd_pass(hc, tc, bias, labels, block)
        ctx.save_for_backward(h, table, bias, labels, logz)
        ctx.block, ctx.dtype = block, dtype
        ctx.mark_non_differentiable(best_idx)
        return nll, best_idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        """Per vocab block: the [N, block] logits once more, d_logits =
        (softmax - onehot) g, then dh (carried) and the block's rows of
        the table and bias gradients, every product and sum in f32 as the
        reference's backward takes them."""
        h, table, bias, labels, logz = ctx.saved_tensors
        block, dtype = ctx.block, ctx.dtype
        v, hd = table.shape
        hc = h if dtype is None else h.to(dtype)
        tc = table if dtype is None else table.to(dtype)
        blocks, biases, nb = _vocab_blocks(tc, bias, block)
        gf = g.float()
        hf = hc.float()
        dh = torch.zeros(hc.shape, dtype=torch.float32, device=h.device)
        dtabs, dbs = [], []
        for i in range(nb):
            logits = _block_logits(hc, blocks, biases, i, block, v)
            p = torch.exp(logits - logz[:, None])   # exp(-inf) = 0 on pads
            cols = i * block + torch.arange(block, device=h.device)
            d = (p - (cols[None, :] == labels[:, None]).float()) * gf[:, None]
            dh = dh + torch.matmul(d, blocks[i].float())
            dtabs.append(torch.matmul(d.t(), hf))
            if bias is not None:
                dbs.append(d.sum(dim=0))
        dtable = torch.cat(dtabs)[:v].to(table.dtype)
        dbias = None if bias is None else torch.cat(dbs)[:v].to(bias.dtype)
        return dh.to(h.dtype), dtable, dbias, None, None, None


def fused_linear_xent(h: torch.Tensor, table: torch.Tensor,
                      labels: torch.Tensor, *, bias=None,
                      vocab_block: int = 0, dtype=None):
    """Fused blockwise LM-head cross-entropy: ``h`` [..., H] against the
    tied ``table`` [V, H] -> per-token ``(nll f32, argmax int32)`` without
    the [..., V] logits in either direction. ``vocab_block`` is the vocab
    tile (0 = :data:`DEFAULT_VOCAB_BLOCK`); V need not be a multiple of
    it. ``dtype`` rounds the operands; the products accumulate in f32."""
    block = int(vocab_block) if vocab_block else DEFAULT_VOCAB_BLOCK
    if block < 1:
        raise ValueError(
            f"lm_loss_vocab_block={vocab_block} invalid: must be >= 1 "
            "(or 0 for the default)")
    v = table.shape[0]
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])
    lab = labels.reshape(-1).to(torch.int32)
    nll, idx = FusedLinearXent.apply(h2, table, bias, lab,
                                     min(block, max(v, 1)), dtype)
    return nll.reshape(lead), idx.reshape(lead)


def _chunked_lm_xent(h, table, labels, w, *, bias, seq_chunk: int, dtype,
                     accuracy: bool):
    """Sequence-chunked LM-head xent: per chunk of ``seq_chunk``
    positions, the [B, chunk, V] logits, their nll and hits, summed and
    dropped; ``torch.utils.checkpoint`` recomputes them in the backward,
    so one chunk's logits at most are alive (no dropout inside, so no
    random state to restore)."""
    b, s, _ = h.shape
    if s % seq_chunk:
        raise ValueError(
            f"loss_chunk={seq_chunk} must divide seq_len={s} (a silent "
            "full-logits fallback would OOM exactly the configs the "
            "knob exists for)")

    def body(hh, tt, ww):
        nll, hit = lm_nll_hits(_head_logits(hh, table, bias, dtype), tt,
                               accuracy=accuracy)
        hsum = (hit * ww).sum() if accuracy else torch.zeros_like(ww[0, 0])
        return (nll * ww).sum(), hsum, ww.sum()

    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    lsum = hsum = wsum = zero
    for i in range(0, s, seq_chunk):
        sl = slice(i, i + seq_chunk)
        ls, hs, ws = torch.utils.checkpoint.checkpoint(
            body, h[:, sl], labels[:, sl], w[:, sl], use_reentrant=False,
            preserve_rng_state=False)
        lsum, hsum, wsum = lsum + ls, hsum + hs, wsum + ws
    denom = torch.clamp_min(wsum, 1.0)
    if not accuracy:
        return lsum / denom, torch.full((), -1.0, device=h.device)
    return lsum / denom, hsum / denom


def lm_head_xent(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor, *, bias=None, impl: str = "full",
                 seq_chunk: int = 0, vocab_block: int = 0, dtype=None,
                 accuracy: bool = True):
    """Weighted-mean softmax cross-entropy and token accuracy of ``h``
    [..., T, H] decoded against the tied embedding ``table`` [V, H] (plus
    ``bias`` [V], BERT's MLM head): ``(loss, accuracy)`` scalars.

    ``impl`` picks how, with the same numbers: ``"full"`` materializes
    the [..., T, V] f32 logits; ``"chunked"`` takes sequence chunks of
    ``seq_chunk`` under ``torch.utils.checkpoint`` (3-D ``h``);
    ``"fused"`` goes blockwise over ``vocab_block`` columns with its own
    backward (:class:`FusedLinearXent`), its accuracy argmax riding the
    same pass. ``accuracy=False`` drops the argmax of the full and
    chunked impls and gives the -1.0 sentinel."""
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
    w = weights.float()
    if impl == "fused":
        nll, pred = fused_linear_xent(h, table, labels, bias=bias,
                                      vocab_block=vocab_block, dtype=dtype)
        hit = (pred == labels).float()
        return weighted_token_mean(nll, hit, w)
    if impl == "chunked":
        if seq_chunk < 1:
            raise ValueError(
                "impl='chunked' needs seq_chunk >= 1 (lm_loss_chunk)")
        if h.ndim != 3:
            raise ValueError(
                f"chunked LM loss chunks the sequence axis of a "
                f"[B, S, H] hidden stream; got ndim={h.ndim}")
        return _chunked_lm_xent(h, table, labels, w, bias=bias,
                                seq_chunk=seq_chunk, dtype=dtype,
                                accuracy=accuracy)
    nll, hit = lm_nll_hits(_head_logits(h, table, bias, dtype), labels,
                           accuracy=accuracy)
    return weighted_token_mean(nll, hit, w)
