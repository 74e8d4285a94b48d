"""Optimizer construction (port of ``distributed_tensorflow_example_tpu/
train/optimizers.py``): schedule -> clip -> optimizer -> weight decay.

The reference builds optax transformations; here each is a
:class:`Transform`, a pair of plain functions over a list of tensors (the
flattened parameters, gradients or updates), written in optax's order of
operations so the port's updates match the reference's at f32 rounding:

- ``clip_by_global_norm``: optax's rule (scale by ``max_norm / norm``
  only when ``norm >= max_norm``; no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``);
- ``scale_by_adam``: moments ``(1 - b) g^k + b m``, bias correction by
  ``1 - b^count`` at the incremented count, ``m / (sqrt(v + eps_root) +
  eps)`` with ``eps = 1e-8`` and ``eps_root = 0``;
- ``add_decayed_weights``: ``u + wd p`` on the masked leaves;
- ``scale_by_learning_rate``: ``-lr(count) u``, ``count`` being the number
  of updates applied before this one;
- ``scale_by_trust_ratio``: ``u * coeff ||p|| / (||u|| + eps)`` a leaf,
  1 where either norm is 0 (LARS and LAMB);
- ``masked``: the inner transform on the masked leaves only, the others
  passed through unchanged (optax's ``wrappers.masked``);
- ``moment_dtype``: the first moment (Adam's ``mu``, the momentum trace,
  adafactor's momentum average) is stored in that dtype, and, as in
  optax, only the stored copy is rounded: the step's update reads the
  f32 moment it just computed. ``nu`` and the factored moments stay
  f32 (their parameters' dtype);
- ``params_ema``: the parameter EMA as the chain's last link (f32
  shadows started at the initial params, ``tf.train.
  ExponentialMovingAverage``'s ``num_updates`` ramp under ``debias``).

Every state is a tuple, dict or list of tensors on the parameters'
device, counts included, so a step runs with no host sync and a caller
can keep a state unchanged with ``torch.where`` (the sync step's
anomaly guard). Schedules are functions of a step count (an int32
tensor, or anything ``torch.as_tensor`` takes) returning an f32 tensor.

Ported: sgd, momentum, adam, adamw, lars, lamb and adafactor (optax's
chain: factored second moments, block-RMS clip, parameter-RMS scaling,
an optional momentum average), the eight decay schedules with linear
warmup, the global-norm and elementwise clips, the weight-decay mask,
bf16 first moments and the parameter EMA.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import OptimizerConfig

Tensors = list[torch.Tensor]
Schedule = Callable[[Any], torch.Tensor]

_INT32_MAX = 2**31 - 1


class Transform(NamedTuple):
    """optax's ``GradientTransformation`` over tensor lists:
    ``init(params) -> state``, ``update(updates, state, params) ->
    (updates, state)``."""

    init: Callable[[Tensors], Any]
    update: Callable[..., tuple[Tensors, Any]]


def _count(params: Tensors) -> torch.Tensor:
    dev = params[0].device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class LeafShard(NamedTuple):
    """One parameter's piece on this rank during a sharded step: the dim
    it is split along, the whole leaf's shape, the piece's (start, stop)
    along that dim, the axis it is split over (its shard group) and two
    collectives over that group: ``sum(t)`` (every member's ``t``
    summed) and ``gather(t, dim)`` (the members' ``t`` concatenated along
    ``dim`` in member order). ``extra`` holds the leaf's further splits,
    one ``LeafShard`` each (a pipe model's stacked block under PP x TP
    is split over ``pipe`` on its stage dim and over ``model`` on a
    kernel dim)."""

    dim: int
    shape: tuple
    start: int
    stop: int
    axis: str
    sum: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor, int], torch.Tensor]
    extra: tuple = ()


#: the pieces of the step being updated, one entry a parameter (None:
#: every leaf whole here)
_SHARDS: contextvars.ContextVar = contextvars.ContextVar("shards",
                                                        default=None)


@contextlib.contextmanager
def shard_reduction(shards: list):
    """Inside, every reduction over a whole leaf (:func:`global_norm`,
    the trust ratio, adafactor's factored RMS, block-RMS clip and
    parameter RMS) computes the whole leaf's number from this rank's
    pieces: ``shards`` holds a :class:`LeafShard` for each parameter
    that is a piece here, None for a whole one. The sharded sync step
    enters it around its update."""
    token = _SHARDS.set(list(shards) if any(x is not None for x in shards)
                        else None)
    try:
        yield
    finally:
        _SHARDS.reset(token)


@contextlib.contextmanager
def _select_shards(sel: list[int]):
    """The shard context narrowed to the leaves ``sel`` (an inner
    transform that sees only those, :func:`masked`'s)."""
    shards = _SHARDS.get()
    token = _SHARDS.set(None if shards is None
                        else [shards[i] for i in sel])
    try:
        yield
    finally:
        _SHARDS.reset(token)


def _leaf_shards(n: int) -> list:
    """The current :class:`LeafShard` (or None) of each of ``n``
    leaves."""
    shards = _SHARDS.get()
    if shards is None:
        return [None] * n
    if len(shards) != n:
        raise ValueError(f"a whole-leaf reduction over {n} leaves of "
                         f"{len(shards)} sharded parameters")
    return shards


def _whole_sums(parts: list, shards: list) -> list:
    """Each piece's partial sum (``parts[i]``, a scalar) summed over its
    shard group, one collective a group (the pieces of one axis stacked);
    entries whose shard is None pass through."""
    out = list(parts)
    groups: dict[tuple, list[int]] = {}
    for i, sh in enumerate(shards):
        if sh is not None:
            groups.setdefault((sh.axis,) + tuple(e.axis for e in sh.extra),
                              []).append(i)
    for idx in groups.values():
        tot = torch.stack([parts[i] for i in idx])
        for sh in (shards[idx[0]],) + shards[idx[0]].extra:
            tot = sh.sum(tot)
        for j, i in enumerate(idx):
            out[i] = tot[j]
    return out


def _whole_sq(xs: Tensors, shards: list) -> list:
    """The whole leaf's sum of squares (f32) of each piece in ``xs``
    (None for a whole leaf, which its caller reduces itself)."""
    parts = [None if sh is None else torch.sum(x.float() * x.float())
             for x, sh in zip(xs, shards)]
    return _whole_sums(parts, shards)


def _whole_mean(x: torch.Tensor, dim: int, sh) -> torch.Tensor:
    """``x``'s mean over ``dim`` as the whole leaf's: a piece split along
    ``dim`` sums over its group, one split elsewhere gathers its part of
    the result (every rank ends with the whole vector)."""
    if sh is None:
        return x.mean(dim=dim)
    splits = (sh,) + sh.extra
    out = x.sum(dim=dim)
    for s in splits:
        if s.dim == dim:
            out = s.sum(out)
    out = out / sh.shape[dim]
    for s in splits:
        if s.dim != dim:
            out = s.gather(out, s.dim - (1 if s.dim > dim else 0))
    return out


def _on_piece(t: torch.Tensor, sh) -> torch.Tensor:
    """A statistic broadcast against the whole leaf, cut to the piece."""
    if sh is None:
        return t
    for s in (sh,) + sh.extra:
        if t.shape[s.dim] != 1:
            t = t.narrow(s.dim, s.start, s.stop - s.start)
    return t


def global_norm(xs: Tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm).
    Inside :func:`shard_reduction`, over the whole leaves: each piece's
    squares summed over its shard group, then every leaf's added."""
    shards = _SHARDS.get()
    if shards is None:
        return torch.sqrt(sum(torch.sum(x * x) for x in xs))
    shards = _leaf_shards(len(xs))
    sq = _whole_sq(xs, shards)
    return torch.sqrt(sum(torch.sum(x * x) if sh is None else q.to(x.dtype)
                          for x, q, sh in zip(xs, sq, shards)))


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]


def chain(*parts: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in parts)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(parts, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def _stateless(fn) -> Transform:
    return Transform(lambda params: (),
                     lambda updates, state, params=None: (fn(updates, params),
                                                          state))


def clip_by_global_norm(max_norm: float) -> Transform:
    def fn(updates, params):
        g = global_norm(updates)
        trigger = g < max_norm
        return [torch.where(trigger, t, (t / g.to(t.dtype)) * max_norm)
                for t in updates]
    return _stateless(fn)


def clip(max_delta: float) -> Transform:
    return _stateless(lambda updates, params: [
        torch.clamp(t, -max_delta, max_delta) for t in updates])


def add_decayed_weights(weight_decay: float, mask=None) -> Transform:
    """``u + wd p``; ``mask(params)`` -> one bool per leaf (None: all)."""
    def fn(updates, params):
        if params is None:
            raise ValueError("add_decayed_weights needs params in update")
        keep = mask(params) if mask is not None else [True] * len(params)
        return [g + weight_decay * p if m else g
                for g, p, m in zip(updates, params, keep)]
    return _stateless(fn)


def masked(inner: Transform, mask) -> Transform:
    """``inner`` on the leaves ``mask(params)`` selects (None: all), the
    others passed through; ``inner`` must be stateless (the trust ratio
    is), so the state is empty as optax's ``MaskedState`` of an empty
    inner state is in a checkpoint."""
    if mask is None:
        return inner

    def fn(updates, params):
        keep = mask(params)
        sel = [i for i, m in enumerate(keep) if m]
        with _select_shards(sel):
            out, _ = inner.update([updates[i] for i in sel], (),
                                  [params[i] for i in sel])
        new = list(updates)
        for i, u in zip(sel, out):
            new[i] = u
        return new
    return _stateless(fn)


def scale_by_trust_ratio(trust_coefficient: float = 1.0,
                         eps: float = 0.0) -> Transform:
    """optax's rule, a leaf: ``u * coeff ||p|| / (||u|| + eps)``, the
    ratio 1 where ``||p||`` or ``||u||`` is 0; a piece's norms are the
    whole leaf's (:func:`shard_reduction`)."""
    def fn(updates, params):
        if params is None:
            raise ValueError("scale_by_trust_ratio needs params in update")
        shards = _leaf_shards(len(params))
        sq = _whole_sq(list(params) + list(updates), shards + shards)
        out = []
        for i, (u, p, sh) in enumerate(zip(updates, params, shards)):
            if sh is None:
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(u)
            else:
                pn = torch.sqrt(sq[i]).to(p.dtype)
                un = torch.sqrt(sq[len(params) + i]).to(u.dtype)
            ratio = trust_coefficient * pn / (un + eps)
            ratio = torch.where((pn == 0) | (un == 0),
                                torch.ones((), dtype=p.dtype,
                                           device=p.device), ratio)
            out.append(u * ratio)
        return out
    return _stateless(fn)


def _scale(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c * x`` with ``c`` first rounded to ``x``'s dtype, as JAX treats
    a weak-typed Python scalar (torch would multiply a bf16 ``x`` by the
    f32 value of ``c``): a bf16 moment decays by the bf16 decay, as
    optax's does."""
    if x.dtype != torch.float32:
        c = float(torch.tensor(c, dtype=x.dtype))
    return c * x


def _zeros(params: Tensors, dtype) -> Tensors:
    """A zero moment a parameter, in ``dtype`` (None: the parameter's)."""
    return [torch.zeros_like(p, dtype=dtype) for p in params]


def _stored(moments: Tensors, dtype) -> Tensors:
    """The moments as the state keeps them (``optax.tree.cast``: None
    keeps their dtype)."""
    return moments if dtype is None else [m.to(dtype) for m in moments]


def scale_by_adam(eps: float = 1e-8,
                  mu_dtype: torch.dtype | None = None) -> Transform:
    """optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0. ``mu``
    is stored in ``mu_dtype`` (None: the parameter's dtype); the update
    reads the unrounded ``mu``."""
    b1, b2 = 0.9, 0.999

    def init(params):
        return {"count": _count(params), "mu": _zeros(params, mu_dtype),
                "nu": _zeros(params, None)}

    def update(updates, state, params=None):
        # b1 * m in m's dtype (a bf16 mu), promoted by the f32 term
        mu = [_scale(1 - b1, g) + _scale(b1, m)
              for g, m in zip(updates, state["mu"])]
        nu = [_scale(1 - b2, g * g) + _scale(b2, n)
              for g, n in zip(updates, state["nu"])]
        count = _safe_increment(state["count"])
        c = count.float()
        bc1 = 1 - torch.pow(_f32(b1).to(c.device), c)
        bc2 = 1 - torch.pow(_f32(b2).to(c.device), c)
        out = [(m / bc1) / (torch.sqrt(n / bc2) + eps)
               for m, n in zip(mu, nu)]
        return out, {"count": count, "mu": _stored(mu, mu_dtype), "nu": nu}

    return Transform(init, update)


def trace(decay: float,
          accumulator_dtype: torch.dtype | None = None) -> Transform:
    """Momentum: ``t = g + decay t``, the update is the new trace (stored
    in ``accumulator_dtype``; None: the parameter's dtype)."""
    def init(params):
        return {"trace": _zeros(params, accumulator_dtype)}

    def update(updates, state, params=None):
        new = [g + _scale(decay, t) for g, t in zip(updates, state["trace"])]
        return new, {"trace": _stored(new, accumulator_dtype)}

    return Transform(init, update)


def scale_by_learning_rate(schedule: Schedule,
                           flip_sign: bool = True) -> Transform:
    """``-lr(count) u`` (``lr(count) u`` without ``flip_sign``); the count
    is the updates applied before."""
    m = -1 if flip_sign else 1

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = m * schedule(state["count"])
        out = [step_size.to(g.dtype) * g for g in updates]
        return out, {"count": _safe_increment(state["count"])}

    return Transform(init, update)


def sgd(schedule: Schedule, momentum: float | None = None,
        accumulator_dtype: torch.dtype | None = None) -> Transform:
    """optax's sgd: (trace or identity) then the learning rate, so the
    state has optax's layout (the checkpoint keys name its positions)."""
    first = (trace(momentum, accumulator_dtype) if momentum is not None
             else _stateless(lambda updates, params: updates))
    return chain(first, scale_by_learning_rate(schedule))


def adam(schedule: Schedule, mu_dtype: torch.dtype | None = None
         ) -> Transform:
    return chain(scale_by_adam(mu_dtype=mu_dtype),
                 scale_by_learning_rate(schedule))


def adamw(schedule: Schedule, weight_decay: float, mask=None,
          mu_dtype: torch.dtype | None = None) -> Transform:
    return chain(scale_by_adam(mu_dtype=mu_dtype),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(schedule))


def lamb(schedule: Schedule, weight_decay: float = 0.0,
         mask=None) -> Transform:
    """optax's lamb: Adam moments with eps 1e-6 -> decayed weights on the
    masked leaves -> the trust ratio on every leaf -> the learning
    rate."""
    return chain(scale_by_adam(eps=1e-6),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_trust_ratio(), scale_by_learning_rate(schedule))


def lars(schedule: Schedule, weight_decay: float = 0.0, mask=None,
         momentum: float = 0.9, trust_coefficient: float = 0.001
         ) -> Transform:
    """optax's lars: decayed weights -> the trust ratio (coefficient
    0.001) on the masked leaves -> the learning rate -> the momentum
    trace, so the trace accumulates steps already scaled by -lr. One
    mask serves the decay and the trust ratio (None: every leaf)."""
    return chain(add_decayed_weights(weight_decay, mask),
                 masked(scale_by_trust_ratio(trust_coefficient), mask),
                 scale_by_learning_rate(schedule), trace(momentum))


#: optax adafactor's defaults: a leaf factors when its second-largest
#: axis is at least this long
MIN_DIM_SIZE_TO_FACTOR = 128
#: the factored moments' decay is ``1 - (count + 1)^-FACTORED_DECAY_RATE``
FACTORED_DECAY_RATE = 0.8
#: added to ``g^2`` (not to the RMS)
FACTORED_EPSILON = 1e-30
#: the floor of each parameter's RMS in ``scale_by_param_block_rms``
PARAM_SCALE_FLOOR = 1e-3


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's rule: the two largest axes (numpy's argsort order), when
    the second largest is at least ``MIN_DIM_SIZE_TO_FACTOR``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _ema_f32(old: torch.Tensor, new: torch.Tensor,
             decay: torch.Tensor) -> torch.Tensor:
    """``decay old + (1 - decay) new`` with an f32 decay, cast back to
    ``old``'s dtype (optax's promotion)."""
    return (decay * old.float() + (1.0 - decay) * new.float()).to(old.dtype)


def scale_by_factored_rms() -> Transform:
    """optax's ``scale_by_factored_rms``: a leaf whose two largest axes
    ``d1 <= d0`` factor keeps a row statistic (``g^2 + eps`` averaged over
    ``d0``) and a column statistic (over ``d1``), each a decaying mean
    with rate ``1 - (count + 1)^-FACTORED_DECAY_RATE``; the update is ``g`` over
    their rank-1 estimate of the RMS. Other leaves keep the full ``v``.
    Each leaf holds all three slots, the unused ones as ``[1]`` zeros,
    so the state's keys are the reference's. A piece factors by its
    whole leaf's shape and keeps the whole ``v_row`` and ``v_col`` (the
    reference replicates them), from its partial means summed or
    gathered over its shard group; its ``v`` is a piece."""

    def init(params):
        st = {"count": _count(params), "v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = _factored_dims(tuple(p.shape))
            one = p.new_zeros((1,))
            if dims is None:
                st["v_row"].append(one)
                st["v_col"].append(one.clone())
                st["v"].append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                st["v_row"].append(p.new_zeros(
                    shape[:d0] + shape[d0 + 1:]))
                st["v_col"].append(p.new_zeros(
                    shape[:d1] + shape[d1 + 1:]))
                st["v"].append(one)
        return st

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("scale_by_factored_rms needs params in update")
        t = (state["count"] + 1).float()
        decay = 1.0 - t ** (-FACTORED_DECAY_RATE)
        out, v_row, v_col, v = [], [], [], []
        for g, vr, vc, vf, p, sh in zip(updates, state["v_row"],
                                        state["v_col"], state["v"], params,
                                        _leaf_shards(len(params))):
            dims = _factored_dims(tuple(p.shape) if sh is None else sh.shape)
            grad_sqr = g * g + FACTORED_EPSILON
            if dims is None:
                new_v = _ema_f32(vf, grad_sqr, decay)
                out.append(g * new_v ** -0.5)
                v_row.append(vr)
                v_col.append(vc)
                v.append(new_v)
                continue
            d1, d0 = dims
            new_vr = _ema_f32(vr, _whole_mean(grad_sqr, d0, sh), decay)
            new_vc = _ema_f32(vc, _whole_mean(grad_sqr, d1, sh), decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = new_vr.mean(dim=reduced_d1, keepdim=True)
            row_factor = (new_vr / row_col_mean) ** -0.5
            col_factor = new_vc ** -0.5
            out.append(g * _on_piece(row_factor.unsqueeze(d0), sh)
                       * _on_piece(col_factor.unsqueeze(d1), sh))
            v_row.append(new_vr)
            v_col.append(new_vc)
            v.append(vf)
        return out, {"count": _safe_increment(state["count"]),
                     "v_row": v_row, "v_col": v_col, "v": v}

    return Transform(init, update)


def clip_by_block_rms(threshold: float) -> Transform:
    """Each leaf over ``max(1, rms(u) / threshold)`` (a piece's RMS is
    the whole leaf's)."""
    def fn(updates, params):
        return [u / torch.clamp_min(rms / threshold, 1.0)
                for u, rms in zip(updates, _block_rms(updates))]
    return _stateless(fn)


def _block_rms(xs: Tensors) -> list:
    """Each leaf's RMS over the whole leaf (a piece's from its partial
    squares summed over its shard group)."""
    shards = _leaf_shards(len(xs))
    sq = _whole_sq(xs, shards)
    return [torch.sqrt(torch.mean(x * x)) if sh is None
            else torch.sqrt(q / math.prod(sh.shape)).to(x.dtype)
            for x, q, sh in zip(xs, sq, shards)]


def scale_by_param_block_rms() -> Transform:
    """Each leaf times its parameter's RMS, floored at
    ``PARAM_SCALE_FLOOR``."""
    def fn(updates, params):
        if params is None:
            raise ValueError("scale_by_param_block_rms needs params")
        out = []
        for u, rms in zip(updates, _block_rms(params)):
            out.append(u * torch.where(
                rms <= PARAM_SCALE_FLOOR,
                torch.full_like(rms, PARAM_SCALE_FLOOR), rms))
        return out
    return _stateless(fn)


def ema(decay: float,
        accumulator_dtype: torch.dtype = torch.float32) -> Transform:
    """optax's ``ema`` without debiasing: ``(1 - decay) u + decay e``, the
    update is the new average, stored in ``accumulator_dtype``."""
    def init(params):
        return {"count": _count(params),
                "ema": _zeros(params, accumulator_dtype)}

    def update(updates, state, params=None):
        new = [_scale(1 - decay, g) + _scale(decay, e)
               for g, e in zip(updates, state["ema"])]
        return new, {"count": _safe_increment(state["count"]),
                     "ema": _stored(new, accumulator_dtype)}

    return Transform(init, update)


def scale(step_size: float) -> Transform:
    return _stateless(lambda updates, params: [step_size * u
                                               for u in updates])


def adafactor(schedule: Schedule, momentum: float | None = None,
              weight_decay_rate: float | None = None, mask=None,
              dtype_momentum: torch.dtype = torch.float32) -> Transform:
    """optax's adafactor at its defaults: factored RMS scaling -> block
    RMS clip at 1 -> the learning rate (no sign flip) -> times each
    parameter's RMS -> the momentum average (when ``momentum``, stored in
    ``dtype_momentum``) -> the decayed weights (a constant per-step rate,
    not scaled by the schedule) -> ``scale(-1)``."""
    parts = [scale_by_factored_rms(),
             clip_by_block_rms(1.0),
             scale_by_learning_rate(schedule, flip_sign=False),
             scale_by_param_block_rms()]
    if momentum is not None:
        parts.append(ema(momentum, dtype_momentum))
    if weight_decay_rate is not None:
        parts.append(add_decayed_weights(weight_decay_rate, mask))
    parts.append(scale(-1))
    return chain(*parts)


class EmaState(dict):
    """:func:`params_ema`'s state, ``{"count", "ema"}`` (the reference's
    ``EmaState`` fields, so its checkpoint keys): a dict of its own type,
    which :func:`find_ema_params` tells from adafactor's momentum
    average (optax's ``EmaState`` has the same fields)."""


def params_ema(decay: float, debias: bool = False) -> Transform:
    """``tf.train.ExponentialMovingAverage`` as the chain's LAST link (it
    reads the final updates to see the post-step params): f32 shadows of
    every parameter, started at the initial params, updated as ``e d +
    p' (1 - d)`` with ``p'`` the step's new params; ``debias`` ramps
    ``d = min(decay, (1 + n) / (10 + n))`` over the applied updates
    ``n``. The updates pass through unchanged. The shadows ride in the
    optimizer state: the anomaly guard keeps them on a skipped step, and
    the checkpoint writes them."""

    def init(params):
        return EmaState(count=_count(params),
                        ema=[p.detach().float().clone() for p in params])

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("params_ema needs params in update")
        new_params = apply_updates(params, updates)
        count = state["count"] + 1
        if debias:
            n = count.float()
            d = torch.clamp_max((1.0 + n) / (10.0 + n), decay)
        else:
            d = torch.full((), decay, dtype=torch.float32,
                           device=count.device)
        shadows = [e * d + p.float() * (1.0 - d)
                   for e, p in zip(state["ema"], new_params)]
        return updates, EmaState(count=count, ema=shadows)

    return Transform(init, update)


def _ema_states(opt_state) -> list[EmaState]:
    """Every :class:`EmaState` in an optimizer state, in order."""
    if isinstance(opt_state, EmaState):
        return [opt_state]
    if isinstance(opt_state, dict):
        kids = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        kids = opt_state
    else:
        return []
    return [s for kid in kids for s in _ema_states(kid)]


def reset_ema(opt_state, params: dict):
    """``opt_state`` with every EMA shadow re-anchored at ``params`` and
    its count at 0: for params replaced outside the optimizer (warm
    start), since the shadows snapshotted the discarded init. The
    shadows are new f32 copies, never views of the params."""
    from ..utils.pytree import flatten_dict
    leaves = list(flatten_dict(params).values())

    def fix(tree):
        if isinstance(tree, EmaState):
            return EmaState(
                count=torch.zeros_like(tree["count"]),
                ema=[p.detach().float().clone() for p in leaves])
        if isinstance(tree, dict):
            return {k: fix(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fix(v) for v in tree)
        return tree

    return fix(opt_state)


def find_ema_params(opt_state, params: dict) -> dict | None:
    """The shadow params of an optimizer state, nested as ``params`` (f32
    whatever the params' dtype), or None when the EMA is off."""
    from ..utils.pytree import flatten_dict, unflatten_dict
    found = _ema_states(opt_state)
    if not found:
        return None
    return unflatten_dict(dict(zip(flatten_dict(params), found[0]["ema"])))


# ---------------------------------------------------------------------------
# schedules: optax's, over torch tensors
# ---------------------------------------------------------------------------

def _count_of(count) -> torch.Tensor:
    count = torch.as_tensor(count)
    return count if count.is_floating_point() else count.to(torch.int32)


def _constant(value: float) -> Schedule:
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=_count_of(count).device)


def _polynomial(init: float, end: float, power: float,
                steps: int) -> Schedule:
    if steps <= 0:
        return _constant(init)

    def sched(count):
        c = torch.clamp(_count_of(count), 0, steps)
        frac = 1 - c / steps
        return (init - end) * (frac ** power) + end
    return sched


def _piecewise(init: float, boundaries_and_scales: dict) -> Schedule:
    """optax's rule; ``boundaries_and_scales`` is not empty."""
    if any(scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError("piecewise schedule expects non-negative scales")

    def sched(count):
        count = _count_of(count)
        v = init
        for threshold, scale in sorted(boundaries_and_scales.items()):
            indicator = torch.clamp_min(
                torch.sign(threshold - count).float(), 0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v
    return sched


def _exponential(init: float, steps: int, rate: float) -> Schedule:
    if steps <= 0 or rate == 0:
        return _constant(init)

    def sched(count):
        dec = _count_of(count)
        p = dec / steps
        return torch.where(dec <= 0, _f32(init).to(p.device),
                           init * torch.pow(rate, p))
    return sched


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")
    steps = float(decay_steps)

    def sched(count):
        c = torch.clamp_max(_count_of(count).float(), steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init * ((1 - alpha) * cosine ** 1.0 + alpha)
    return sched


def _join(scheds: list, boundaries: list) -> Schedule:
    def sched(count):
        count = _count_of(count)
        out = scheds[0](count)
        for boundary, s in zip(boundaries, scheds[1:]):
            out = torch.where(count < boundary, out, s(count - boundary))
        return out
    return sched


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """The learning rate as a function of the step count: the reference's
    eight schedules (tf.train semantics at ABSOLUTE steps) behind an
    optional linear warmup, with its validation."""
    base = cfg.learning_rate
    w = cfg.warmup_steps
    if cfg.decay_schedule == "piecewise":
        if not cfg.decay_boundaries:
            raise ValueError(
                "decay_schedule='piecewise' needs decay_boundaries")
        if any(int(b) <= w for b in cfg.decay_boundaries):
            raise ValueError(
                f"decay_boundaries {cfg.decay_boundaries} must all lie "
                f"after warmup_steps={w}")
        sched = _piecewise(base, {int(b) - w: cfg.decay_factor
                                  for b in cfg.decay_boundaries})
    elif cfg.decay_schedule == "exponential":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='exponential' needs decay_steps > 0")
        sched = _exponential(base * cfg.decay_factor ** (w / cfg.decay_steps),
                             cfg.decay_steps, cfg.decay_factor)
    elif cfg.decay_schedule == "polynomial":
        horizon = cfg.decay_steps if cfg.decay_steps > 0 else cfg.total_steps
        if horizon <= w:
            raise ValueError(
                "decay_schedule='polynomial' needs decay_steps (or "
                f"total_steps) > warmup_steps; got horizon={horizon}, "
                f"warmup_steps={w}")
        poly = _polynomial(base, cfg.end_learning_rate, cfg.decay_power,
                           horizon)
        sched = ((lambda count: poly(_count_of(count) + w)) if w > 0
                 else poly)
    elif cfg.decay_schedule == "natural_exp":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='natural_exp' needs decay_steps > 0")
        k = cfg.decay_factor / cfg.decay_steps
        sched = _exponential(base * math.exp(-k * w), cfg.decay_steps,
                             math.exp(-cfg.decay_factor))
    elif cfg.decay_schedule == "inverse_time":
        if cfg.decay_steps <= 0:
            raise ValueError(
                "decay_schedule='inverse_time' needs decay_steps > 0")
        k = cfg.decay_factor / cfg.decay_steps

        def sched(count):
            return base / (1.0 + k * (_count_of(count) + w))
    elif cfg.decay_schedule == "constant" or cfg.total_steps <= 0:
        sched = _constant(base)
    elif cfg.decay_schedule == "cosine":
        sched = _cosine(base, max(1, cfg.total_steps - w),
                        (cfg.end_learning_rate / base) if base else 0.0)
    elif cfg.decay_schedule == "linear":
        sched = _polynomial(base, 0.0, 1, max(1, cfg.total_steps - w))
    else:
        raise ValueError(f"unknown decay_schedule {cfg.decay_schedule!r}")
    if w > 0:
        sched = _join([_polynomial(0.0, base, 1, w), sched], [w])
    return sched


def _wd_mask(cfg: OptimizerConfig):
    """Decay mask per ``wd_mask``: ``exclude_1d`` decays only leaves with
    ndim >= 2 (matrices, embeddings), not biases or LayerNorm params."""
    if cfg.wd_mask == "all":
        return None
    if cfg.wd_mask == "exclude_1d":
        return lambda params: [p.ndim >= 2 for p in params]
    raise ValueError(f"unknown wd_mask {cfg.wd_mask!r}")


#: ``moment_dtype`` -> the first moment's storage dtype
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(cfg: OptimizerConfig) -> Transform:
    """clip-by-global-norm -> clip-by-value -> the optimizer (+ decayed
    weights) -> the parameter EMA, as the reference chains them. On a
    sharded step every reduction over a whole leaf takes the whole
    leaf's number from the pieces (:func:`shard_reduction`)."""
    name = cfg.name.lower()
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"unknown moment_dtype {cfg.moment_dtype!r}")
    if cfg.moment_dtype == "bfloat16" and name in ("lars", "lamb"):
        what = "accumulator dtype" if name == "lars" else "mu_dtype"
        raise ValueError(
            f"moment_dtype=bfloat16 is not supported for {name} (optax."
            f"{name} exposes no {what}); the flag would be a silent no-op")
    mdt = _MOMENT_DTYPES[cfg.moment_dtype]
    sched = make_schedule(cfg)
    parts: list[Transform] = []
    if cfg.grad_clip_norm > 0:
        parts.append(clip_by_global_norm(cfg.grad_clip_norm))
    if cfg.grad_clip_value > 0:
        parts.append(clip(cfg.grad_clip_value))
    mask = _wd_mask(cfg)
    if name == "sgd":
        parts.append(sgd(sched))
    elif name == "momentum":
        parts.append(sgd(sched, momentum=cfg.momentum,
                         accumulator_dtype=mdt))
    elif name == "adam":
        parts.append(adam(sched, mu_dtype=mdt))
    elif name == "adamw":
        parts.append(adamw(sched, cfg.weight_decay, mask, mu_dtype=mdt))
    elif name == "lars":
        # the biases and norm scales stay out of the decay AND the trust
        # ratio under the default wd_mask; "all" applies both everywhere
        parts.append(lars(sched, cfg.weight_decay, mask, cfg.momentum))
    elif name == "lamb":
        parts.append(lamb(sched, cfg.weight_decay, mask))
    elif name == "adafactor":
        # the weight decay here is adafactor's constant per-step rate,
        # not scaled by the schedule as adamw's is
        parts.append(adafactor(
            sched, momentum=cfg.momentum if cfg.momentum > 0 else None,
            weight_decay_rate=cfg.weight_decay or None, mask=mask,
            dtype_momentum=mdt))
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    if cfg.weight_decay > 0 and name not in ("adamw", "lars", "lamb",
                                             "adafactor"):
        parts.insert(-1, add_decayed_weights(cfg.weight_decay, mask))
    if cfg.ema_decay > 0:
        # the last link: it sees the final updates, so the shadows track
        # the post-step params
        parts.append(params_ema(cfg.ema_decay, debias=cfg.ema_debias))
    return chain(*parts)
