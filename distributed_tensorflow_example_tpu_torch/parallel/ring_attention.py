"""Ring attention: sequence (context) parallelism over the ``seq`` mesh
axis (port of ``distributed_tensorflow_example_tpu/parallel/
ring_attention.py``).

The sequence is split over the ``seq`` ranks. Each rank keeps its query
block and the key/value blocks travel round the ring, one hop a step
(:func:`~.collectives.ppermute`), while the rank folds the block it holds
into an online softmax (running max and normaliser, the flash-attention
recurrence), so no rank ever holds the whole [S, S] score matrix. The
block update is plain torch, as the reference's is plain ``jnp``: it is
not a kernel.

The reference's :func:`make_ring_attention` returns a drop-in for
``multi_head_attention`` whose ``shard_map`` hands each member its
sequence block. Here each rank runs the model on its rows whole (the
model is replicated along ``seq``), so the function returned takes and
returns the whole ``[B, S, H, D]``: it cuts the rank's block of q, k and v
(:func:`~.collectives.split_along`: the backward all-gathers the
blocks' gradients), runs the ring, and joins the output blocks along the
sequence (:func:`~.collectives.gather_along`: the backward keeps the
rank's block). Every ``seq`` rank then holds the same output and, after
the backward, the same gradient of every parameter, the reference's.
"""

from __future__ import annotations

import torch

from ..ops.attention import NEG_INF as _NEG
from ..ops.attention import apply_mask, attention_scores
from . import collectives
from .mesh import AxisNames, Mesh


def _block_update(q, k, v, o, m, l, *, q_off, k_off, causal, kv_mask):
    """One online-softmax accumulation step against a K/V block.

    q: [B,Sq,H,D]; k,v: [B,Sk,H,D]; o: [B,H,Sq,D] f32; m,l: [B,H,Sq,1] f32.
    kv_mask: [B,Sk] (nonzero = valid key) or None; ``q_off``/``k_off``
    are the blocks' first global positions (the causal mask's).
    """
    s = attention_scores(q, k)
    s = apply_mask(
        s, kv_mask[:, None, None, :] if kv_mask is not None else None,
        causal=causal, q_offset=q_off, k_offset=k_off)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # zero the masked probabilities: a fully masked block would otherwise
    # give exp(_NEG - _NEG) = 1 and corrupt the normaliser
    p = torch.exp(s - m_new) * (s > _NEG / 2).to(s.dtype)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o * corr + pv, m_new, l_new


def ring_attention_local(q, k, v, *, axis_name: str = AxisNames.SEQ,
                         causal: bool = False, kv_mask=None,
                         mesh: Mesh | None = None) -> torch.Tensor:
    """The ring over this rank's blocks: q, k, v [B, S/n, H, D] (and the
    key mask [B, S/n]) -> this rank's context block [B, S/n, H, D]. Every
    member of ``axis_name`` calls it at once."""
    n = collectives.axis_size(axis_name, mesh=mesh)
    me = (mesh or collectives.current_mesh()).index(axis_name)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    perm = [(r, (r + 1) % n) for r in range(n)]
    k_cur, v_cur, mask_cur = k, v, kv_mask
    for i in range(n):
        src = (me - i) % n                  # the block's home rank
        o, m, l = _block_update(q, k_cur, v_cur, o, m, l, q_off=me * sq,
                                k_off=src * sk, causal=causal,
                                kv_mask=mask_cur)
        if i == n - 1:
            break                           # the last hop would go unused
        k_cur = collectives.ppermute(k_cur, axis_name, perm, mesh=mesh)
        v_cur = collectives.ppermute(v_cur, axis_name, perm, mesh=mesh)
        if mask_cur is not None:
            mask_cur = collectives.ppermute(mask_cur, axis_name, perm,
                                            mesh=mesh)
    out = o / torch.clamp_min(l, 1e-20)     # rows with no valid key: zeros
    return out.permute(0, 2, 1, 3).to(q.dtype)


def make_ring_attention(mesh: Mesh, *, causal: bool = False,
                        batch_axes=AxisNames.BATCH,
                        seq_axis: str = AxisNames.SEQ):
    """Bind a mesh -> a ``[B, S, H, D]`` attention sharded over
    ``seq_axis``: a drop-in for ``multi_head_attention`` (``mask`` = key
    validity [B, S]). ``batch_axes`` is the reference's: a rank here
    already holds its rows of the batch."""
    bound_causal = causal
    del batch_axes

    def attn(q, k, v, *, mask=None, causal=None, **unexpected):
        if unexpected:
            raise TypeError(f"unexpected kwargs {sorted(unexpected)}; "
                            "bind options at make_ring_attention() time")
        if causal is not None and causal != bound_causal:
            # a call-site causal flag silently ignored would run
            # bidirectional attention in a decoder
            raise ValueError(
                f"causal={causal} at call time conflicts with "
                f"make_ring_attention(causal={bound_causal}); causality is "
                "baked into the ring schedule and must be bound at "
                "construction")
        ql, kl, vl = (collectives.split_along(t, seq_axis, dim=1, mesh=mesh)
                      for t in (q, k, v))
        ml = None
        if mask is not None:
            ml = collectives.split_along(torch.as_tensor(mask,
                                                         device=q.device),
                                         seq_axis, dim=1, mesh=mesh)
        out = ring_attention_local(ql, kl, vl, axis_name=seq_axis,
                                   causal=bound_causal, kv_mask=ml,
                                   mesh=mesh)
        return collectives.gather_along(out, seq_axis, dim=1, mesh=mesh)

    return attn
