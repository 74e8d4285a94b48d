"""Mixture-of-Experts FFN (port of ``distributed_tensorflow_example_tpu/
ops/moe.py``): the dense dispatch/combine path, ``moe_ffn``, and the
explicit expert-parallel one, ``moe_ffn_ep_body`` / ``moe_ffn_shard_map``.

The Switch-Transformer layout, as the reference builds it: routing turns
each token's choice into one-hot ``dispatch`` and ``combine`` tensors
[T, E, C] (T tokens, E experts, C slots an expert), and the layer is
products against them. Top-k is a repeated masked argmax (``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does); a token's slot in its
expert is a cumsum of the one-hots in token order (row-major over B x S);
an assignment past ``C = ceil(T / E * capacity_factor)`` is dropped, and
the token's residual passes through untouched. Routing runs in f32, the
tokens enter the experts in the compute dtype, the combine runs in f32.

The products are ``torch.matmul`` calls shaped so that the ``--remat
dots`` policy (``models/base.py``: ``mm``/``addmm`` saved, the rest
recomputed) saves what the reference's ``dots_with_no_batch_dims_saveable``
saves: the router, dispatch and combine products are 2-D (``mm``, no
batch dimension: saved), the experts' GEMMs are batched over E (``bmm``:
recomputed). Under a bf16 compute dtype the expert GEMMs take bf16
operands and return their f32 accumulation unrounded, as the reference's
``preferred_element_type=jnp.float32`` does. No TPU kernel is on this
path: the reference computes it with XLA einsums, and the port with
library GEMMs.

Router jitter multiplies the router's input (not the experts') by noise
U[1-j, 1+j) in training. Its draws come from a key (``ops/nn.py``
``fold_in``/``keyed_generator``), never from a running generator, so a
layer that ``--remat`` recomputes draws the same noise again. The stream
is torch's, not JAX's.

Under tensor parallelism (``tp``, a ``parallel/tensor_parallel.
ModelAxis``) each expert's FFN is split by its hidden columns, as the
reference's rules place ``w_in`` ``P(None, None, model)``, ``b_in``
``P(None, model)`` and ``w_out`` ``P(None, model, None)``: every
``model`` rank routes alike (the router is replicated, its jitter key the
same), runs the experts on its columns, and the partial outputs are
summed over ``model`` before the replicated ``b_out`` is added once and
the combine runs; the aux metrics are the whole routing's.

Global routing. Given ``ranks`` (a ``runtime/distributed.BatchRanks``:
MoE-BERT passes its ``auto`` step's N batch ranks) ``moe_ffn`` routes as
one run of the global batch does, which is what the reference's GSPMD
program computes: each top-k round adds to a token's slot the number of
tokens the earlier batch ranks sent to its expert in that round (one
all-gather of an [E] count vector a round; the ranks' order is their
rows' order in the global batch, microbatch by microbatch), the capacity
comes from the global token count, and ``frac``, ``mp`` and ``z`` are
averaged over the ranks (differentiably) and ``kept`` summed before the
aux losses are formed. A rank then fills only its own tokens' slots of
the global [E, C] buffers and combines them; no tokens move. Router
jitter draws the global batch's noise and takes the rank's rows, so N
ranks draw the one-rank run's noise. Without ``ranks`` (one rank, a
``shard_map`` step, eval, a pipeline stage) each call routes its own
tokens.

Expert parallelism under ``auto`` (``ep``, the mesh of a bound model with
an ``expert`` axis of size ep): every ``expert`` rank holds the same rows
and ``E/ep`` experts, routes the whole batch alike (the router, gates,
combine and aux run whole), fills the slots of its own experts, runs
them, and the experts' outputs are joined over ``expert`` before the
combine. The tokens enter the dispatch product through ``copy_to`` over
``expert`` (each rank's gradient of them covers its experts only), and
the join's backward keeps each rank's block: that conjugate pair makes
every leaf's gradient whole, so the step averages over the batch ranks
alone.

The explicit path (:func:`moe_ffn_ep_body`, the reference's) shards the
tokens over ``expert`` too: each member routes its own tokens at a
per-shard capacity, sends each expert's slots to the expert's rank with
a differentiable ``all_to_all``, runs its local experts on every
member's slots and sends the results back; the routing statistics are
averaged over the token-sharding axes (``collectives.pmean``) before the
aux losses. :func:`moe_ffn_shard_map` wraps it with the reference's
signature: whole params and ``x`` in, whole ``y`` and aux out, on every
rank; the pipelined MoE model (``models/pipe_moe.py``) calls the body in
each stage.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..parallel import collectives
from ..parallel.mesh import AxisNames
from . import nn

Params = dict[str, Any]


def moe_ffn_init(gen: torch.Generator, n_experts: int, hidden: int,
                 intermediate: int, *, param_dtype=torch.float32) -> Params:
    """Router + per-expert FFN weights, stacked on a leading E dim: the
    router kernel N(0, 0.02), the experts' kernels uniform in
    +-sqrt(6 / (hidden + intermediate)), zero biases (the reference's
    init; its random stream is JAX's)."""
    dev = gen.device
    lim = math.sqrt(6.0 / (hidden + intermediate))

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return (u * (2 * lim) - lim).to(param_dtype)

    router = torch.randn((hidden, n_experts), generator=gen, device=dev,
                         dtype=torch.float32) * 0.02
    return {
        "router": {"kernel": router.to(param_dtype)},
        "w_in": uniform((n_experts, hidden, intermediate)),
        "b_in": torch.zeros((n_experts, intermediate), dtype=param_dtype,
                            device=dev),
        "w_out": uniform((n_experts, intermediate, hidden)),
        "b_out": torch.zeros((n_experts, hidden), dtype=param_dtype,
                             device=dev),
    }


def aux_loss(frac_tokens: torch.Tensor, mean_probs: torch.Tensor,
             n_experts: int, k: int) -> torch.Tensor:
    """The Switch load-balancing loss ``E * sum_e frac_e / k * p_e``."""
    return n_experts * torch.sum(frac_tokens / k * mean_probs)


def jitter_noise(key: int, shape, jitter: float, device) -> torch.Tensor:
    """The router's multiplicative noise U[1-jitter, 1+jitter) of ``shape``
    (f32), a function of ``key`` alone."""
    gen = nn.keyed_generator(key, device)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2.0 * jitter) + (1.0 - jitter)


def router_logits(router_params: Params, x2: torch.Tensor, *,
                  key: int | None = None, jitter: float = 0.0,
                  ranks=None) -> torch.Tensor:
    """[T, D] -> [T, E] f32 router logits; with ``jitter`` and a ``key``
    the router's input is multiplied by :func:`jitter_noise` first (the
    experts see the clean input). ``ranks`` (a ``BatchRanks``): ``x2``
    is rank i's block of n equal blocks of the global batch's rows,
    whose noise it takes from the global batch's draw."""
    xr = x2.float()
    if jitter > 0.0 and key is not None:
        i, n = (0, 1) if ranks is None else (ranks.index, ranks.size)
        t = x2.shape[0]
        noise = jitter_noise(key, (n * t, x2.shape[1]), jitter, x2.device)
        xr = xr * noise[i * t:(i + 1) * t]
    return torch.matmul(xr, router_params["kernel"].float())


def _route(router_params: Params, x2: torch.Tensor, n_experts: int, k: int,
           capacity: int, *, key: int | None = None, jitter: float = 0.0,
           ranks=None):
    """x2 [T, D] -> (dispatch [T, E, C], combine [T, E, C], stats), stats
    {frac [E], mp [E], z scalar, kept [E]}: the share of the T x k
    assignments each expert got, its mean router probability, the
    ST-MoE z-loss term ``mean(logsumexp(logits)^2)``, and the assignments
    that fit under capacity. ``jitter`` (with ``key``) multiplies the
    router's input by U[1-jitter, 1+jitter). ``ranks`` (a
    ``BatchRanks``): ``x2`` is one batch rank's rows and the routing is
    the global batch's (module docstring): ``capacity`` must be the
    global one, and the stats come out global, ``kept`` summed over the
    ranks."""
    logits = router_logits(router_params, x2, key=key, jitter=jitter,
                           ranks=ranks)
    probs = torch.softmax(logits, dim=-1)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    t = x2.shape[0]
    dev = x2.device
    slots = torch.arange(capacity, device=dev)
    remaining = probs
    counts = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    total_assigned = torch.zeros((t, n_experts), dtype=torch.float32,
                                 device=dev)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)                 # [T]
        onehot = torch.nn.functional.one_hot(
            choice, n_experts).to(torch.float32)                 # [T, E]
        # a token's slot within its chosen expert, in token order
        pos = torch.cumsum(onehot, dim=0) - 1 + counts
        chosen = onehot.sum(0)
        if ranks is not None:
            # after the earlier ranks' tokens of this round
            seen = ranks.gather(chosen)                          # [n, E]
            pos = pos + seen[:ranks.index].sum(0)
            chosen = seen.sum(0)
        pos = pos * onehot
        keep = (pos < capacity).to(torch.float32) * onehot
        # one_hot of a slot past capacity is all zeros (jax.nn.one_hot's
        # rule; torch's one_hot would raise)
        slot = (pos.to(torch.int64)[..., None] == slots).to(torch.float32)
        d = keep[..., None] * slot
        gate = (probs * onehot).sum(-1, keepdim=True)            # chosen p
        dispatch = dispatch + d
        combine = combine + d * gate[..., None]
        # the round's assignments that fit: positions counts .. counts +
        # chosen - 1, over every rank
        counts = counts + torch.minimum(chosen,
                                        (capacity - counts).clamp(min=0))
        total_assigned = total_assigned + onehot
        remaining = remaining * (1.0 - onehot)                   # mask it
    frac, mp = total_assigned.mean(0), probs.mean(0)
    if ranks is not None:
        packed = ranks.mean(torch.cat([frac, mp, z.reshape(1)]))
        frac, mp, z = (packed[:n_experts], packed[n_experts:2 * n_experts],
                       packed[-1])
    stats = {"frac": frac, "mp": mp, "z": z, "kept": counts}
    return dispatch, combine, stats


class _BmmF32(torch.autograd.Function):
    """``a @ b`` over a batch of low-precision operands, accumulated and
    returned in f32 (on the card one bf16 GEMM with an f32 output; on
    the CPU the same products in f32, where bf16 products are exact).
    The backward rounds the f32 cotangent to the operands' dtype and runs
    each gradient as one GEMM in it, as ``bmm(a, b).float()`` would."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2),
                                                          g)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def _expert_compute(params: Params, inp: torch.Tensor, dtype,
                    tp=None) -> torch.Tensor:
    """[E, C, D] -> [E, C, D] f32: each expert's FFN (tanh GELU), one
    batched GEMM over E a projection, operands in the compute ``dtype``
    and accumulations kept in f32 (the reference's
    ``preferred_element_type``); the biases and GELU run in f32, and the
    GELU's output is rounded to ``dtype`` for the second GEMM. Under
    ``tp`` the weights are this rank's column pieces: ``inp`` enters
    through ``copy_to_model`` and the second GEMM's partial sums are
    summed over ``model`` (in f32) before ``b_out`` is added."""
    if tp is not None:
        inp = tp.copy_to_model(inp)
    h = _bmm_f32(inp.to(dtype), params["w_in"].to(dtype))
    h = h + params["b_in"].float()[:, None, :]
    h = nn.gelu(h).to(dtype)
    out = _bmm_f32(h, params["w_out"].to(dtype))
    if tp is not None:
        out = tp.reduce_from_model(out)
    return out + params["b_out"].float()[:, None, :]


def capacity_for(tokens: int, n_experts: int,
                 capacity_factor: float) -> int:
    return max(1, math.ceil(tokens / n_experts * capacity_factor))


def _aux_pack(stats: dict, n_experts: int, k: int, tokens: int,
              capacity: int) -> dict:
    """Routing stats -> ``lb_loss`` (Switch load balance), ``z_loss``
    (router z-loss), ``dropped_fraction`` (the share of the T x k
    assignments lost to capacity) and ``expert_load`` [E] (slots used
    over capacity)."""
    kept = stats["kept"]
    return {
        "lb_loss": aux_loss(stats["frac"], stats["mp"], n_experts, k),
        "z_loss": stats["z"],
        "dropped_fraction": 1.0 - torch.sum(kept) / float(tokens * k),
        "expert_load": kept / float(capacity),
    }


def moe_ffn(params: Params, x: torch.Tensor, *, n_experts: int,
            top_k: int = 1, capacity_factor: float = 1.25,
            dtype=torch.float32, key: int | None = None,
            jitter: float = 0.0, tp=None, ep=None,
            ranks=None) -> tuple[torch.Tensor, dict]:
    """[B, S, D] -> ([B, S, D] in ``x.dtype``, the aux dict of
    :func:`_aux_pack`). ``key`` + ``jitter`` turn on router noise
    (training only: an eval passes no key). ``tp``: the experts' column
    pieces on this ``model`` rank; ``ep``: the mesh whose ``expert`` axis
    splits the experts, ``params``' expert leaves this rank's E/ep;
    ``ranks``: the batch ranks whose rows are routed together, this
    call's rows one rank's block (None: route this call's rows alone).
    See the module docstring."""
    b, s, d = x.shape
    t = b * s
    n = 1 if ranks is None else ranks.size
    cap = capacity_for(t * n, n_experts, capacity_factor)
    x2 = x.reshape(t, d)
    dispatch, combine, stats = _route(params["router"], x2, n_experts,
                                      top_k, cap, key=key, jitter=jitter,
                                      ranks=ranks)
    aux = _aux_pack(stats, n_experts, top_k, t * n, cap)
    xin, e = x2, n_experts
    if ep is not None:
        # this rank's experts' slots; the tokens' gradient from them is
        # summed over expert (each rank's covers its experts)
        e = n_experts // ep.shape[AxisNames.EXPERT]
        lo = ep.coords[AxisNames.EXPERT] * e
        dispatch = dispatch[:, lo:lo + e]
        xin = collectives.copy_to(x2, AxisNames.EXPERT, mesh=ep)
    # "tec,td->ecd": [E*C, T] @ [T, D] (a one-hot gather, exact in bf16)
    expert_in = torch.matmul(dispatch.reshape(t, e * cap).t().to(dtype),
                             xin.to(dtype))
    expert_out = _expert_compute(params, expert_in.reshape(e, cap, d), dtype,
                                 tp)
    if ep is not None:
        expert_out = collectives.gather_along(expert_out, AxisNames.EXPERT,
                                              dim=0, mesh=ep)
    # "tec,ecd->td" in f32: [T, E*C] @ [E*C, D]
    out = torch.matmul(combine.reshape(t, n_experts * cap),
                       expert_out.reshape(n_experts * cap, d))
    return out.reshape(b, s, d).to(x.dtype), aux


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def moe_ffn_ep_body(p_local: Params, x_local: torch.Tensor, *,
                    n_experts: int, n_ranks: int, top_k: int,
                    capacity_factor: float, dtype,
                    axis_name: str, stat_axes, mesh,
                    model_axis: str | None = None,
                    key: int | None = None,
                    jitter: float = 0.0) -> tuple[torch.Tensor, dict]:
    """The explicit expert-parallel dataflow of one member of ``mesh``
    (the reference's ``moe_ffn_ep_body``): ``x_local`` [B, S, D] is this
    member's token shard, ``p_local``'s expert leaves its ``E/n_ranks``
    experts (under ``model_axis`` also its columns of each), its router
    whole. The capacity is per shard; every expert's slots go to its
    rank in one ``all_to_all`` over ``axis_name`` and come back in a
    second; the routing statistics are averaged over ``stat_axes``
    (every axis the tokens are sharded over) before the aux losses, and
    the jitter key folds in this member's index on each of them.
    Returns (y_local, aux). The caller makes the leaves' gradients whole
    (the conjugate pairs of :func:`moe_ffn_shard_map` and
    ``models/pipe_moe.py``)."""
    e_local = n_experts // n_ranks
    bl, sl, dl = x_local.shape
    tl = bl * sl
    x2 = x_local.reshape(tl, dl)
    cap = capacity_for(tl, n_experts, capacity_factor)
    lkey = key
    if lkey is not None:
        # independent noise per token shard: every token axis's index
        for ax in stat_axes:
            lkey = nn.fold_in(lkey, mesh.index(ax))
    dispatch, combine, stats = _route(p_local["router"], x2, n_experts,
                                      top_k, cap, key=lkey, jitter=jitter)
    send = torch.matmul(dispatch.reshape(tl, n_experts * cap).t().to(dtype),
                        x2.to(dtype)).reshape(n_experts, cap, dl)
    # chunk j of the expert dim goes to rank j; each rank then holds,
    # source-rank-major, every rank's slots of its own experts
    recv = collectives.all_to_all(send, axis_name, split_axis=0,
                                  concat_axis=0, mesh=mesh)
    recv = recv.reshape(n_ranks, e_local, cap, dl).transpose(0, 1)
    recv = recv.reshape(e_local, n_ranks * cap, dl)
    tp = None
    if model_axis is not None and mesh.shape[model_axis] > 1:
        from ..parallel.tensor_parallel import ModelAxis
        tp = ModelAxis(mesh)
    out = _expert_compute({k: v for k, v in p_local.items()
                           if k != "router"}, recv, dtype, tp)
    # the results back: the regrouping inverted, then the exchange again
    back = out.reshape(e_local, n_ranks, cap, dl).transpose(0, 1)
    back = back.reshape(n_ranks * e_local, cap, dl)
    got = collectives.all_to_all(back.float(), axis_name, split_axis=0,
                                 concat_axis=0, mesh=mesh)
    y = torch.matmul(combine.reshape(tl, n_experts * cap),
                     got.reshape(n_experts * cap, dl))
    axes = tuple(stat_axes)
    packed = collectives.pmean(
        torch.cat([stats["frac"], stats["mp"], stats["z"].reshape(1),
                   stats["kept"]]), axes, mesh=mesh)
    e = n_experts
    gstats = {"frac": packed[:e], "mp": packed[e:2 * e], "z": packed[2 * e],
              "kept": packed[2 * e + 1:]}
    aux = _aux_pack(gstats, n_experts, top_k, tl, cap)
    return y.reshape(bl, sl, dl).to(x_local.dtype), aux


def _expert_splits(axis_name: str, model_axis: str | None) -> dict:
    """The expert leaves' (dim, axis) splits under EP (x TP over
    ``model_axis``)."""
    m = () if model_axis is None else ((2, model_axis),)
    mb = () if model_axis is None else ((1, model_axis),)
    return {"w_in": ((0, axis_name),) + m, "b_in": ((0, axis_name),) + mb,
            "w_out": ((0, axis_name),) + mb, "b_out": ((0, axis_name),)}


def moe_ffn_shard_map(params: Params, x: torch.Tensor, mesh, *,
                      n_experts: int, top_k: int = 1,
                      capacity_factor: float = 1.25, dtype=torch.float32,
                      axis_name: str = AxisNames.EXPERT,
                      batch_axes=AxisNames.BATCH,
                      model_axis: str | None = None,
                      key: int | None = None,
                      jitter: float = 0.0) -> tuple[torch.Tensor, dict]:
    """The explicit expert-parallel MoE over ``mesh`` (the reference's
    ``moe_ffn_shard_map``): every rank passes the whole ``params`` and
    ``x`` [B, S, D] and gets the whole ``y`` and aux back. Inside, the
    rows are split over ``batch_axes`` and the sequence over
    ``axis_name``; each member keeps its experts (and, under
    ``model_axis``, its columns of each) and runs
    :func:`moe_ffn_ep_body`.

    For gradients the caller's loss is the same on every rank: the
    router's gradient and the experts' are summed over the members whose
    tokens reached them (``copy_to``), the splits' backward gathers each
    leaf's blocks whole, ``y``'s join keeps each member's block of its
    cotangent and the aux's takes 1/n of it (n token shards). Outputs
    equal :func:`moe_ffn`'s where nothing drops (the capacity is per
    token shard: use a generous ``capacity_factor`` to compare), and so
    do the aux values (the stats are averaged before the formula).
    Router jitter folds each member's token-shard index into ``key``,
    so it does not draw the dense path's noise. Raises ValueError when
    the experts or the columns do not divide over their axes."""
    n_ranks = mesh.shape[axis_name]
    if n_experts % n_ranks:
        raise ValueError(f"{n_experts} experts not divisible over "
                         f"{n_ranks} '{axis_name}' ranks")
    if model_axis is not None:
        if model_axis != AxisNames.MODEL:
            raise ValueError(f"model_axis must be {AxisNames.MODEL!r}, got "
                             f"{model_axis!r}")
        inter = params["w_in"].shape[2]
        if inter % mesh.shape[model_axis]:
            raise ValueError(
                f"intermediate dim {inter} not divisible over "
                f"{mesh.shape[model_axis]} '{model_axis}' ranks")
    batch_axes = ((batch_axes,) if isinstance(batch_axes, str)
                  else tuple(batch_axes))
    stat_axes = batch_axes + (axis_name,)
    # the router sees every member's tokens: its gradient sums over them
    p_local = {"router": {k: collectives.copy_to(v, stat_axes, mesh=mesh)
                          for k, v in params["router"].items()}}
    for name, splits in _expert_splits(axis_name, model_axis).items():
        v = params[name]
        for d, ax in splits:
            v = collectives.split_along(v, ax, dim=d, mesh=mesh)
        # each batch member's tokens reach every expert: summed over them
        p_local[name] = (collectives.copy_to(v, batch_axes, mesh=mesh)
                         if batch_axes else v)
    x_local = collectives.split_along(x, batch_axes, dim=0, mesh=mesh) \
        if batch_axes else x
    x_local = collectives.split_along(x_local, axis_name, dim=1, mesh=mesh)
    y, aux = moe_ffn_ep_body(
        p_local, x_local, n_experts=n_experts, n_ranks=n_ranks,
        top_k=top_k, capacity_factor=capacity_factor, dtype=dtype,
        axis_name=axis_name, stat_axes=stat_axes, mesh=mesh,
        model_axis=model_axis, key=key, jitter=jitter)
    y = collectives.gather_along(y, axis_name, dim=1, mesh=mesh)
    if batch_axes:
        y = collectives.gather_along(y, batch_axes, dim=0, mesh=mesh)
    n = collectives.axis_size(stat_axes, mesh=mesh)
    return y, {k: _ScaleGrad.apply(v, 1.0 / n) for k, v in aux.items()}
